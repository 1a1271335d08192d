"""The port's paged serving path against the JAX package, on the CPU.

The page pool and prefix cache (``paddle_tpu_torch.serving.paged_kv``),
the paged helpers of ``ops/decode_attention.py``, the plain version of the
paged decode kernel and the paged engine and scheduler are held against
``paddle_tpu`` with the same inputs (numpy, from a seed; the JAX
parameters carried across through numpy). The JAX Pallas paged decode
kernel cannot run on the CPU under jax 0.9.0 (its interpret mode calls
``pl.store``, which that release removed; ROADMAP.md, C), so the oracle is
its plain reference, the jitted unfused tick of
tests/test_pallas_fused.py:565-573, and the JAX paged engine with its
unfused (XLA) decode tick. The port's kernels take their plain versions
here (CPU tensors); the CUDA kernel is held against the plain version on
the card (tests/test_torch_cuda.py, chip_smoke.py).

Page 0 is the scratch page: dead lanes and unmapped bucket pages write it
and several writes may collide there, so pool comparisons cover pages
1..P-1 only.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import serving as JS
from paddle_tpu.models import gpt as JG
from paddle_tpu.ops import decode_attention as DA
from paddle_tpu.serving import paged_kv as JPK
from paddle_tpu_torch import serving as TS
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.ops import cuda_kernels as CK
from paddle_tpu_torch.ops import decode_attention as TDA
from paddle_tpu_torch.serving import metrics as sm
from paddle_tpu_torch.serving import paged_kv as TPK

EKW = dict(max_batch=4, max_seq=32, prefill_buckets=(8, 16))
PAGED = dict(kv_layout="paged", page_size=8)
_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def tiny():
    cfg_j = JG.GPT_TINY.scaled(num_layers=2, max_seq_len=64)
    cfg_t = TG.GPT_TINY.scaled(num_layers=2, max_seq_len=64)
    jp = JG.init_params(jax.random.PRNGKey(7), cfg_j)
    tp = TG.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return cfg_j, jp, cfg_t, tp


def _port_engine(tiny, **kw):
    _, _, cfg_t, tp = tiny
    return TS.DecodeEngine(tp, cfg_t, TS.EngineConfig(**{**EKW, **kw}),
                           device="cpu")


@pytest.fixture(scope="module")
def slab_eng(tiny):
    return _port_engine(tiny)


@pytest.fixture(scope="module")
def paged_eng(tiny):
    eng = _port_engine(tiny, **PAGED)
    eng.warmup()
    return eng


def _greedy(engine, prompt, n):
    slot, logits = engine.start_sequence(prompt)
    toks = [int(np.argmax(logits))]
    for _ in range(n - 1):
        out = engine.decode_step({slot: toks[-1]})
        toks.append(int(np.argmax(out[slot])))
    engine.free_sequence(slot)
    return toks


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# (a) the allocator and the prefix cache
# ---------------------------------------------------------------------------


def _drive_pool(mod, seed, steps=160):
    """A seeded run of alloc / alloc(prefix_pages) / ensure_capacity /
    set_length / free / insert / lookup / reclaim over a small pool,
    logging every result and the pool's state after each step. The
    reclaimer is wired as each engine wires it (JAX: the bound method
    ``reclaim``; the port: the PrefixCache)."""
    kw = dict(num_layers=1, max_slots=3, max_seq=32, num_heads=1,
              head_dim=2, page_size=4, num_pages=12)
    if mod is TPK:
        kw["device"] = "cpu"
    pool = mod.PagedKVCache(**kw)
    cache = mod.PrefixCache(pool, capacity_pages=9)
    pool.reclaimer = cache.reclaim if mod is JPK else cache
    rng = np.random.default_rng(seed)
    bases = [rng.integers(0, 7, size=12).tolist() for _ in range(3)]
    live = {}
    log = []
    for step in range(steps):
        op = int(rng.integers(0, 6))
        base = bases[int(rng.integers(0, 3))]
        tokens = base[:int(rng.integers(1, 13))] + rng.integers(
            0, 7, size=int(rng.integers(0, 9))).tolist()
        try:
            if op in (0, 1) or not live:
                plen, pages = (cache.lookup(tokens) if op == 1
                               else (0, ()))
                slot = pool.alloc(length=len(tokens), prefix_pages=pages)
                live[slot] = len(tokens)
                res = ("alloc", slot, plen,
                       cache.insert(tokens, pool.table_row(slot)))
            elif op == 2:
                slot = sorted(live)[int(rng.integers(0, len(live)))]
                upto = live[slot] + int(rng.integers(1, 7))
                ok = pool.ensure_capacity(slot, upto)
                if ok:
                    pool.set_length(slot, upto)
                    live[slot] = upto
                res = ("grow", slot, ok)
            elif op == 3:
                slot = sorted(live)[int(rng.integers(0, len(live)))]
                pool.free(slot)
                del live[slot]
                res = ("free", slot)
            elif op == 4:
                res = ("reclaim", cache.reclaim(int(rng.integers(1, 4))))
            else:
                res = ("lookup", cache.lookup(tokens))
        except (JPK.PagePoolFullError, TPK.PagePoolFullError) as e:
            res = ("raised", type(e).__name__)
        except RuntimeError as e:                # either CacheFullError
            res = ("raised", type(e).__name__)
        log.append((step, res, pool.tables().tolist(),
                    pool.free_page_count(), pool._ref.tolist(), len(cache),
                    cache.held_page_count(), cache.hits, cache.misses))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_and_prefix_cache_track_jax(seed):
    """Tables, free counts, refcounts, cache entries and hits, and the
    steps that raise, step for step."""
    want = _drive_pool(JPK, seed)
    got = _drive_pool(TPK, seed)
    raised = [e for e in want if e[1][0] == "raised"]
    assert any(e[1][1] == "PagePoolFullError" for e in raised), \
        "the run never ran the pool dry"
    for w, g in zip(want, got):
        assert g == w, (w[0], w[1], g[1])


def test_paged_pool_alloc_free_refcount():
    """test_paged_serving.py:71-108 on the port: page 0 pinned, growth at
    the page boundary, shared prefix pages refcounted."""
    c = TPK.PagedKVCache(num_layers=1, max_slots=3, max_seq=16, num_heads=1,
                         head_dim=2, page_size=4, num_pages=8, device="cpu")
    assert c.free_page_count() == 7 and tuple(c.k.shape) == (1, 8, 4, 1, 2)
    s0 = c.alloc(length=6)
    assert c.free_page_count() == 5
    row = c.table_row(s0)
    assert (row[:2] > 0).all() and (row[2:] == 0).all()
    assert c.ensure_capacity(s0, 9) and c.table_row(s0)[2] > 0
    shared = [int(p) for p in c.table_row(s0)[:2]]
    s1 = c.alloc(length=10, prefix_pages=shared)
    assert [int(p) for p in c.table_row(s1)[:2]] == shared
    assert c._slots[s1].prefix_len == 8
    with pytest.raises(ValueError):
        c.set_length(s1, 13)                     # beyond mapped pages
    c.free(s0)
    assert all(c._ref[p] == 1 for p in shared)
    c.free(s1)
    assert c.free_page_count() == 7 and c.pool_occupancy() == 0.0
    with pytest.raises(TPK.PagePoolFullError):
        TPK.PagedKVCache(num_layers=1, max_slots=3, max_seq=16, num_heads=1,
                         head_dim=2, page_size=4, num_pages=2,
                         device="cpu").alloc(length=8)


# ---------------------------------------------------------------------------
# (b) the paged helpers
# ---------------------------------------------------------------------------


def test_paged_helpers_match_jax():
    """paged_gather and the two writers bitwise, paged_prefill_attention
    within 1e-6, against ops/decode_attention.py:97-173."""
    rng = np.random.default_rng(11)
    P, page, nh, hd, M = 9, 4, 2, 16, 4
    pool = rng.standard_normal((P, page, nh, hd)).astype(np.float32)
    tables = np.array([[3, 1, 7, 0], [2, 5, 0, 0]], np.int32)
    want = np.asarray(DA.paged_gather(jnp.asarray(pool),
                                      jnp.asarray(tables)))
    got = TDA.paged_gather(torch.from_numpy(pool), torch.from_numpy(tables))
    np.testing.assert_array_equal(got.numpy(), want)

    new = rng.standard_normal((3, nh, hd)).astype(np.float32)
    phys, rows = np.array([4, 8, 2], np.int32), np.array([1, 3, 0], np.int32)
    want = np.asarray(DA.paged_cache_update(jnp.asarray(pool),
                                            jnp.asarray(new),
                                            jnp.asarray(phys),
                                            jnp.asarray(rows)))
    tp = torch.from_numpy(pool.copy())
    assert TDA.paged_cache_update(tp, torch.from_numpy(new),
                                  torch.from_numpy(phys),
                                  torch.from_numpy(rows)) is tp
    np.testing.assert_array_equal(tp.numpy(), want)

    data = rng.standard_normal((2, page, nh, hd)).astype(np.float32)
    dst = np.array([6, 1], np.int32)
    want = np.asarray(DA.paged_page_write(jnp.asarray(pool),
                                          jnp.asarray(data),
                                          jnp.asarray(dst)))
    tp = torch.from_numpy(pool.copy())
    TDA.paged_page_write(tp, torch.from_numpy(data), torch.from_numpy(dst))
    np.testing.assert_array_equal(tp.numpy(), want)

    S, T = M * page, 8
    q = rng.standard_normal((1, T, nh, hd)).astype(np.float32)
    kv = rng.standard_normal((2, 1, S, nh, hd)).astype(np.float32)
    for prefix_len in (0, 4, 8):
        want = np.asarray(DA.paged_prefill_attention(
            jnp.asarray(q), jnp.asarray(kv[0]), jnp.asarray(kv[1]),
            prefix_len))
        got = TDA.paged_prefill_attention(
            torch.from_numpy(q), torch.from_numpy(kv[0]),
            torch.from_numpy(kv[1]), prefix_len).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# (c) the plain version of the paged decode kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_fused_paged_decode_plain_matches_jax(name):
    """Against the JAX kernel's jitted plain reference
    (test_pallas_fused.py:565-573) at the kernel's bar (:578-583): out
    within 2e-6, pools 1..P-1 bitwise; lane 2 is dead (zeroed table row,
    position 0, its write lands on page 0), lanes 0 and 1 share their
    first two pages, which stay untouched."""
    jdt, tdt = _DT[name]
    rng = np.random.default_rng(2)
    B, M, page, nh, hd = 4, 4, 8, 2, 64
    P = 1 + B * M
    kp = rng.standard_normal((P, page, nh, hd)).astype(np.float32)
    vp = rng.standard_normal((P, page, nh, hd)).astype(np.float32)
    q, nk, nv = (rng.standard_normal((B, nh, hd)).astype(np.float32)
                 for _ in range(3))
    tables = np.array([[1 + b * M + m for m in range(M)]
                       for b in range(B)], np.int32)
    tables[1, :2] = tables[0, :2]                # shared prefix pages
    tables[2] = 0                                # dead lane
    positions = np.array([21, 30, 0, 9], np.int32)

    @jax.jit
    def ref(q, kp, vp, nk, nv):
        phys = tables[np.arange(B), positions // page]
        rows = positions % page
        kp2 = DA.paged_cache_update(kp, nk, phys, rows)
        vp2 = DA.paged_cache_update(vp, nv, phys, rows)
        gk = DA.paged_gather(kp2, tables)
        gv = DA.paged_gather(vp2, tables)
        return DA.decode_attention(q, gk, gv, positions + 1), kp2, vp2

    j_out, j_kp, j_vp = ref(jnp.asarray(q), jnp.asarray(kp, jdt),
                            jnp.asarray(vp, jdt), jnp.asarray(nk),
                            jnp.asarray(nv))
    tkp = torch.from_numpy(kp).to(tdt)
    tvp = torch.from_numpy(vp).to(tdt)
    kp0, vp0 = tkp.clone(), tvp.clone()
    t_out, t_kp, t_vp = CK.fused_paged_decode_attention(
        torch.from_numpy(q), tkp, tvp, torch.from_numpy(nk),
        torch.from_numpy(nv), torch.from_numpy(tables),
        torch.from_numpy(positions))
    assert t_kp is tkp and t_vp is tvp           # updated in place
    np.testing.assert_array_equal(_np(t_kp)[1:], _np(j_kp)[1:])
    np.testing.assert_array_equal(_np(t_vp)[1:], _np(j_vp)[1:])
    np.testing.assert_allclose(_np(t_out), _np(j_out), atol=2e-6, rtol=2e-6)
    shared = tables[0, :2]
    assert torch.equal(tkp[shared], kp0[shared])
    assert torch.equal(tvp[shared], vp0[shared])
    # each live lane's row landed in its own page, rounded to the pool
    for b in (0, 1, 3):
        pg, r = tables[b, positions[b] // page], positions[b] % page
        assert torch.equal(tkp[pg, r], torch.from_numpy(nk[b]).to(tdt))


# ---------------------------------------------------------------------------
# (d)-(i) the paged engine and scheduler
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_paged_tokens(tiny):
    """Greedy tokens of the JAX paged engine (unfused decode tick: the
    Pallas tick does not run under jax 0.9.0 on the CPU) for prompts of
    length 3, 9 and 15."""
    cfg_j, jp, _, _ = tiny
    eng = JS.DecodeEngine(jp, cfg_j, JS.EngineConfig(**PAGED, **EKW))
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, cfg_j.vocab_size, size=n).tolist()
               for n in (3, 9, 15)]
    return [(p, _greedy(eng, p, 10)) for p in prompts]


@pytest.mark.parametrize("fused", [True, False], ids=["kernels", "plain"])
def test_paged_greedy_matches_jax_and_slab(tiny, jax_paged_tokens,
                                           slab_eng, fused):
    eng = _port_engine(tiny, fused_decode=fused, **PAGED)
    for prompt, want in jax_paged_tokens:
        assert _greedy(eng, prompt, 10) == want, prompt
        assert _greedy(slab_eng, prompt, 10) == want, prompt
    assert eng.cache.free_slot_count() == EKW["max_batch"]


def test_paged_interleaved_slots_isolated(tiny, slab_eng, paged_eng):
    cfg = tiny[2]
    rng = np.random.RandomState(8)
    p_a = rng.randint(0, cfg.vocab_size, size=5).tolist()
    p_b = rng.randint(0, cfg.vocab_size, size=11).tolist()
    sa, la = paged_eng.start_sequence(p_a)
    sb, lb = paged_eng.start_sequence(p_b)
    ta, tb = [int(np.argmax(la))], [int(np.argmax(lb))]
    for _ in range(5):
        out = paged_eng.decode_step({sa: ta[-1], sb: tb[-1]})
        ta.append(int(np.argmax(out[sa])))
        tb.append(int(np.argmax(out[sb])))
    paged_eng.free_sequence(sa)
    paged_eng.free_sequence(sb)
    assert ta == _greedy(slab_eng, p_a, 6)
    assert tb == _greedy(slab_eng, p_b, 6)


def test_partial_feed_does_not_clobber_live_slots(tiny, slab_eng,
                                                  paged_eng):
    """A live slot absent from a decode step rides with a zeroed table row
    (its write lands on scratch page 0): its pages stay bit for bit and its
    continuation equals an engine that never parked it
    (test_paged_serving.py:283-303, paged)."""
    cfg = tiny[2]
    rng = np.random.RandomState(23)
    pa = rng.randint(0, cfg.vocab_size, size=4).tolist()
    pb = rng.randint(0, cfg.vocab_size, size=6).tolist()
    sa, la = paged_eng.start_sequence(pa)
    sb, lb = paged_eng.start_sequence(pb)
    pages_b = paged_eng.cache.table_row(sb)[:1]
    kb0 = paged_eng.cache.k[:, pages_b].clone()
    ta = [int(np.argmax(la))]
    for _ in range(4):                      # b sits live but unfed
        ta.append(int(np.argmax(paged_eng.decode_step({sa: ta[-1]})[sa])))
    assert torch.equal(paged_eng.cache.k[:, pages_b], kb0)
    tb = [int(np.argmax(lb))]
    for _ in range(4):
        tb.append(int(np.argmax(paged_eng.decode_step({sb: tb[-1]})[sb])))
    paged_eng.free_sequence(sa)
    paged_eng.free_sequence(sb)
    assert ta == _greedy(slab_eng, pa, 5)
    assert tb == _greedy(slab_eng, pb, 5)


def test_prefix_cache_prefills_once(tiny, slab_eng, paged_eng):
    """A repeated prompt attaches its cached page and prefills only the
    suffix, with the same logits; decode continues off the shared page,
    which no tick writes; every page unwinds (test_paged_serving.py:
    163-189)."""
    eng = paged_eng
    prompt = list(range(40, 52))              # 12 tokens -> 1 full page
    hits0 = eng.prefix.hits
    tok0 = sm.m_prefill_tokens._unlabeled().value
    s1, l1 = eng.start_sequence(prompt)
    d1 = sm.m_prefill_tokens._unlabeled().value - tok0
    s2, l2 = eng.start_sequence(prompt)
    d2 = sm.m_prefill_tokens._unlabeled().value - tok0 - d1
    assert (d1, d2) == (12, 4)
    assert eng.prefix.hits == hits0 + 1
    np.testing.assert_allclose(l1, l2, rtol=1e-5, atol=1e-5)
    shared = eng.cache.table_row(s1)[:1]
    assert eng.cache.table_row(s2)[0] == shared[0]
    k0, v0 = eng.cache.k[:, shared].clone(), eng.cache.v[:, shared].clone()
    t1, t2 = int(np.argmax(l1)), int(np.argmax(l2))
    seq = [t1]
    for _ in range(3):
        o = eng.decode_step({s1: t1, s2: t2})
        t1, t2 = int(np.argmax(o[s1])), int(np.argmax(o[s2]))
        assert t1 == t2
        seq.append(t1)
    assert torch.equal(eng.cache.k[:, shared], k0)
    assert torch.equal(eng.cache.v[:, shared], v0)
    assert seq == _greedy(slab_eng, prompt, 4)
    eng.free_sequence(s1)
    eng.free_sequence(s2)
    eng.prefix.clear()
    assert eng.cache.free_page_count() == eng.cache.num_pages - 1


def test_scheduler_hol_bypass_and_starvation_bound(tiny):
    """One long prompt at the head does not stall fitting short prompts
    behind it, and the bypass is bounded (test_paged_serving.py:
    208-256)."""
    eng = _port_engine(tiny, max_batch=2, num_pages=6, prefix_cache=False,
                       **PAGED)
    sched = TS.Scheduler(eng, TS.SchedulerConfig(hol_starvation_limit=100),
                         device="cpu")
    a = sched.submit([1, 2, 3], max_new_tokens=24)
    b = sched.submit([4, 5, 6], max_new_tokens=24)
    sched.step()
    assert a.state == "active" and b.state == "active"
    long_req = sched.submit(list(range(1, 16)), max_new_tokens=2)
    shorts = [sched.submit([9, 9], max_new_tokens=2) for _ in range(3)]
    hol0 = sm.m_hol_admits._unlabeled().value
    for _ in range(400):
        if not sched.pending():
            break
        sched.step()
    everyone = [a, b, long_req] + shorts
    assert all(r.state == "done" for r in everyone)
    assert sm.m_hol_admits._unlabeled().value > hol0
    assert max(r.hol_skips for r in everyone) >= 1

    sched = TS.Scheduler(eng, TS.SchedulerConfig(hol_starvation_limit=1),
                         device="cpu")
    blocker = sched.submit([1, 1, 1], max_new_tokens=60, timeout_s=60)
    blocker2 = sched.submit([2, 2, 2], max_new_tokens=60, timeout_s=60)
    sched.step()
    long_req = sched.submit(list(range(1, 16)), max_new_tokens=1)
    s1 = sched.submit([5, 5], max_new_tokens=1)
    s2 = sched.submit([6, 6], max_new_tokens=1)
    sched.step()
    sched.step()
    assert long_req.hol_skips <= 1
    assert sum(r.state in ("active", "done") for r in (s1, s2)) <= 1
    assert blocker.state == "active" and blocker2.state == "active"
    sched.abort_all("test over")
    assert eng.cache.free_page_count() == eng.cache.num_pages - 1


def test_scheduler_page_pool_preemption_recompute(tiny, slab_eng):
    """Pool dry mid-generation: the youngest request is requeued and
    resumed by recompute, and both token streams equal the slab engine's
    (test_paged_serving.py:259-280)."""
    eng = _port_engine(tiny, max_batch=2, prefill_buckets=(8,),
                       kv_layout="paged", page_size=4, num_pages=7,
                       prefix_cache=False)
    sched = TS.Scheduler(eng, TS.SchedulerConfig(default_timeout_s=120.0),
                         device="cpu")
    pa, pb = [11, 12, 13], [21, 22, 23]
    ra = sched.submit(pa, max_new_tokens=12)
    rb = sched.submit(pb, max_new_tokens=12)
    for _ in range(400):
        if not sched.pending():
            break
        sched.step()
    assert ra.state == "done" and rb.state == "done"
    assert sched.preemptions >= 1
    assert ra.tokens == _greedy(slab_eng, pa, 12)
    assert rb.tokens == _greedy(slab_eng, pb, 12)
    assert eng.cache.free_page_count() == eng.cache.num_pages - 1


def test_resume_past_the_ladder(tiny, slab_eng):
    """A resume longer than the largest bucket prefills the head and
    replays the tail through the decode tick: the next token and logits
    equal a slab run of the same stream (engine.py:958-983); the replay
    ticks count. A pool that runs dry during the replay frees the slot
    and raises PagePoolFullError."""
    prompt = [3, 1, 4, 1, 5]
    stream = _greedy(slab_eng, prompt, 15)
    tokens = prompt + stream[:14]                # 19 > the 8-token ladder
    eng = _port_engine(tiny, prefill_buckets=(8,), **PAGED)
    ticks0 = eng.decode_ticks
    slot, logits, tok = eng.resume_sequence_sampled(tokens, TS.GREEDY)
    assert tok == stream[14] and eng.cache.length(slot) == len(tokens)
    assert eng.decode_ticks - ticks0 == len(tokens) - 8
    s2, l2 = slab_eng.start_sequence(prompt)
    t = int(np.argmax(l2))
    for _ in range(14):
        out = slab_eng.decode_step({s2: t})[s2]
        t = int(np.argmax(out))
    slab_eng.free_sequence(s2)
    np.testing.assert_allclose(logits, out, atol=1e-5, rtol=1e-5)
    eng.free_sequence(slot)

    dry = _port_engine(tiny, prefill_buckets=(8,), num_pages=3, **PAGED)
    with pytest.raises(TS.PagePoolFullError):
        dry.resume_sequence_sampled(tokens, TS.GREEDY)
    assert dry.cache.free_slot_count() == EKW["max_batch"]
    assert dry.cache.free_page_count() == 2


def test_bf16_paged_engine_tracks_jax(tiny):
    """bf16 compute and weights, paged: teacher-forced with JAX's greedy
    tokens, per-step logits within 1e-2 (about one bf16 ulp) and a 95%
    argmax agreement share, as test_torch_serving.py's slab test holds
    the slab engine."""
    _, jp, _, tp = tiny
    cfg_j = JG.GPT_TINY.scaled(num_layers=2, max_seq_len=64,
                               dtype=jnp.bfloat16)
    cfg_t = TG.GPT_TINY.scaled(num_layers=2, max_seq_len=64,
                               dtype=torch.bfloat16)
    jeng = JS.DecodeEngine(jp, cfg_j, JS.EngineConfig(
        weight_dtype="bf16", **PAGED, **EKW))
    teng = TS.DecodeEngine(tp, cfg_t, TS.EngineConfig(
        weight_dtype="bf16", **PAGED, **EKW), device="cpu")
    rng = np.random.RandomState(0)
    agree, steps = 0, 0
    for n in (3, 6, 11, 5, 9):
        prompt = rng.randint(0, cfg_j.vocab_size, size=n).tolist()
        sj, lj = jeng.start_sequence(prompt)
        st, lt = teng.start_sequence(prompt)
        for _ in range(10):
            np.testing.assert_allclose(lt, lj, atol=1e-2, rtol=1e-2)
            agree += int(np.argmax(lt) == np.argmax(lj))
            steps += 1
            tok = int(np.argmax(lj))
            lj = jeng.decode_step({sj: tok})[sj]
            lt = teng.decode_step({st: tok})[st]
        jeng.free_sequence(sj)
        teng.free_sequence(st)
    assert agree / steps >= 0.95, (agree, steps)


# ---------------------------------------------------------------------------
# (j) can_admit counts reclaimable prefix-cache pages
# ---------------------------------------------------------------------------


def test_can_admit_counts_reclaimable_prefix_pages(tiny):
    """Pool of 5 usable pages of 8 rows. Prompt A (24 tokens) finishes and
    leaves its 3 full pages in the prefix cache, so 2 are free; prompt B
    (30 unique tokens) needs 4. A reclaim fits it: the port admits and
    finishes B. The JAX pool, wired as its engine wires it
    (engine.py:187: ``reclaimer = prefix.reclaim``), answers False for the
    same state, because a bound method has no ``reclaimable``
    (paged_kv.py:183-193) — a fault of the reference (ROADMAP.md, C)."""
    kw = dict(max_batch=2, max_seq=32, prefill_buckets=(8, 16, 32),
              kv_layout="paged", page_size=8, num_pages=6)
    eng = _port_engine(tiny, **kw)
    sched = TS.Scheduler(eng, device="cpu")
    rng = np.random.default_rng(5)
    a_toks = rng.integers(0, 256, size=24).tolist()
    b_toks = rng.integers(0, 256, size=30).tolist()
    ra = sched.submit(a_toks, max_new_tokens=1)
    sched.step()
    assert ra.state == "done"
    assert eng.cache.free_page_count() == 2
    assert eng.prefix.held_page_count() == 3
    assert eng.prefix.reclaimable() == 3
    assert eng.can_admit(len(b_toks))
    rb = sched.submit(b_toks, max_new_tokens=2, timeout_s=30.0)
    for _ in range(10):
        if rb.finished.is_set():
            break
        sched.step()
    assert rb.state == "done" and len(rb.tokens) == 2

    jpool = JPK.PagedKVCache(num_layers=1, max_slots=2, max_seq=32,
                             num_heads=1, head_dim=2, page_size=8,
                             num_pages=6)
    jprefix = JPK.PrefixCache(jpool)
    jpool.reclaimer = jprefix.reclaim
    slot = jpool.alloc(length=24)
    jprefix.insert(a_toks, jpool.table_row(slot))
    jpool.free(slot)
    assert jpool.free_page_count() == 2 and jprefix.reclaimable() == 3
    assert not jpool.can_admit(len(b_toks))
    tpool = TPK.PagedKVCache(num_layers=1, max_slots=2, max_seq=32,
                             num_heads=1, head_dim=2, page_size=8,
                             num_pages=6, device="cpu")
    tprefix = TPK.PrefixCache(tpool)
    tpool.reclaimer = tprefix
    slot = tpool.alloc(length=24)
    tprefix.insert(a_toks, tpool.table_row(slot))
    tpool.free(slot)
    assert tpool.can_admit(len(b_toks))


@pytest.mark.parametrize("prefix_len", [0, 7, 8, 16, 23])
def test_can_admit_takes_a_cached_prefix(prefix_len):
    """``can_admit(prompt_len, prefix_len)``: a prompt whose first
    ``prefix_len`` tokens sit on cached pages needs only its own pages,
    pages_for(prompt_len) - prefix_len // page, as the reference computes
    it (paged_kv.py:183-193). Pool of 5 usable pages of 8 rows with 3
    taken by a live slot: a 30-token prompt needs 4 pages and fits only
    behind a prefix of two whole pages or more. No reclaimer on either
    pool, so the counts agree."""
    pools = []
    for make in (lambda: JPK.PagedKVCache(
            num_layers=1, max_slots=2, max_seq=32, num_heads=1, head_dim=2,
            page_size=8, num_pages=6),
                 lambda: TPK.PagedKVCache(
            num_layers=1, max_slots=2, max_seq=32, num_heads=1, head_dim=2,
            page_size=8, num_pages=6, device="cpu")):
        pool = make()
        pool.alloc(length=24)
        assert pool.free_page_count() == 2
        pools.append(pool)
    jpool, tpool = pools
    want = jpool.can_admit(30, prefix_len=prefix_len)
    assert tpool.can_admit(30, prefix_len=prefix_len) == want
    assert want == (4 - prefix_len // 8 <= 2)
    assert tpool.can_admit(30, prefix_len) == want


def test_paged_engine_refuses_buckets_off_the_page_grid(tiny):
    with pytest.raises(ValueError, match="page_size"):
        _port_engine(tiny, kv_layout="paged", page_size=16)
