"""Speculative decoding in the port (``serving/spec_decode.py``, the verify
window of ``serving/engine.py``) against the JAX package, on the CPU.

Both packages start from the same JAX parameters carried across through
numpy (target GPT_TINY at 2 layers, draft at 1 layer from another key);
each case runs on the slab and on the paged layout.

- ``window_cache_update`` / ``window_attention`` (and the paged window's
  scatter and gathered view) against JAX at float32 within 2e-6;
- ``verify_step`` logits against the JAX engine's within 1e-4 (a full
  forward, the port's prefill bar), the greedy target tokens equal;
- speculative greedy streams equal the JAX slab engine's greedy stream;
- a self-draft accepts every proposal, k + 1 tokens a window;
- ``_accept_sampled`` emits the reference's tokens on the same inputs;
- the spec engine behind ``Scheduler``, the spec metrics moving, and
  behind ``FrontDoor`` (``/generate``, ``/health`` reading ``poisoned``);
- eviction at ``min_headroom`` near max_seq; a verify failure after the
  caches were written poisons the engine.
"""
import json
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import serving as JS
from paddle_tpu.models import gpt as JG
from paddle_tpu.ops import decode_attention as JDA
from paddle_tpu_torch import serving as TS
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.ops import decode_attention as TDA
from paddle_tpu_torch.serving import metrics as TSM

LAYOUTS = ["slab", "paged"]
K = 2                                 # proposals a window (W = 3)
EKW = dict(max_batch=4, max_seq=32, prefill_buckets=(8, 16), page_size=8)


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, JAX params, port cfg, port params) for the target and the
    1-layer draft."""
    cfg_j = JG.GPT_TINY.scaled(num_layers=2, max_seq_len=64)
    cfg_t = TG.GPT_TINY.scaled(num_layers=2, max_seq_len=64)
    jp = JG.init_params(jax.random.PRNGKey(7), cfg_j)
    dcfg_j, dcfg_t = cfg_j.scaled(num_layers=1), cfg_t.scaled(num_layers=1)
    djp = JG.init_params(jax.random.PRNGKey(42), dcfg_j)

    def port(tree):
        return TG.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                    device="cpu")

    return {"target": (cfg_j, jp, cfg_t, port(jp)),
            "draft": (dcfg_j, djp, dcfg_t, port(djp))}


def _port(models, which="target", **kw):
    _, _, cfg, params = models[which]
    return TS.DecodeEngine(params, cfg, TS.EngineConfig(**{**EKW, **kw}),
                           device="cpu")


def _spec(models, layout, self_draft=False, **kw):
    target = _port(models, verify_window=K + 1, kv_layout=layout, **kw)
    draft = _port(models, "target" if self_draft else "draft",
                  kv_layout=layout, **kw)
    return TS.SpecDecodeEngine(target, draft)


def _greedy(engine, prompt, n):
    slot, logits = engine.start_sequence(prompt)
    toks = [int(np.argmax(logits))]
    while len(toks) < n:
        toks.append(int(np.argmax(engine.decode_step({slot: toks[-1]})[slot])))
    engine.free_sequence(slot)
    return toks


def _spec_stream(spec, prompt, n):
    slot, _l, tok = spec.start_sequence_sampled(prompt, TS.GREEDY)
    got = [tok]
    while len(got) < n:
        got.extend(spec.generate_step({slot: got[-1]},
                                      {slot: TS.GREEDY})[slot])
    spec.free_sequence(slot)
    return got


PROMPTS = [[3, 17, 200], [9, 4, 2, 6, 11, 250, 1, 7], list(range(40, 53))]


@pytest.fixture(scope="module")
def jax_engines(models):
    """The JAX slab and paged engines with a verify window (k = 2)."""
    cfg_j, jp, _, _ = models["target"]
    return {layout: JS.DecodeEngine(jp, cfg_j, JS.EngineConfig(
        verify_window=K + 1, kv_layout=layout, **EKW))
        for layout in LAYOUTS}


@pytest.fixture(scope="module")
def jax_streams(jax_engines):
    """The JAX slab engine's greedy streams of :data:`PROMPTS`, 12 tokens."""
    return [_greedy(jax_engines["slab"], p, 12) for p in PROMPTS]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_window_ops_match_jax(layout):
    rng = np.random.default_rng(5)
    B, S, nh, hd, W, page = 3, 24, 2, 8, 3, 8
    q, new = (rng.standard_normal((B, W, nh, hd)).astype(np.float32)
              for _ in range(2))
    starts = np.array([0, 9, S - W], np.int32)
    active = np.array([1, 0, 1], np.int32)
    if layout == "slab":
        cache = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
        want = JDA.window_cache_update(jnp.asarray(cache), jnp.asarray(new),
                                       jnp.asarray(starts),
                                       active=jnp.asarray(active))
        got = TDA.window_cache_update(torch.from_numpy(cache.copy()),
                                      torch.from_numpy(new),
                                      torch.from_numpy(starts),
                                      torch.from_numpy(active))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        views = (got, got)
        jviews = (want, want)
    else:
        M = S // page
        pool = rng.standard_normal((B * M + 1, page, nh, hd)).astype(
            np.float32)
        tables = (1 + rng.permutation(B * M)).astype(np.int32).reshape(B, M)
        pos = starts[:, None] + np.arange(W)
        phys = np.take_along_axis(tables, pos // page, axis=1).reshape(-1)
        rows = (pos % page).reshape(-1)
        flat = new.reshape(B * W, nh, hd)
        want = JDA.paged_cache_update(jnp.asarray(pool), jnp.asarray(flat),
                                      jnp.asarray(phys), jnp.asarray(rows))
        got = TDA.paged_cache_update(torch.from_numpy(pool.copy()),
                                     torch.from_numpy(flat),
                                     torch.from_numpy(phys),
                                     torch.from_numpy(rows))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        views = (TDA.paged_gather(got, torch.from_numpy(tables)),) * 2
        jviews = (JDA.paged_gather(want, jnp.asarray(tables)),) * 2
    out = TDA.window_attention(torch.from_numpy(q), *views,
                               torch.from_numpy(starts))
    jout = JDA.window_attention(jnp.asarray(q), *jviews,
                                jnp.asarray(starts))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-6,
                               rtol=2e-6)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_verify_step_logits_match_jax(models, jax_engines, layout):
    jeng = jax_engines[layout]
    teng = _port(models, verify_window=K + 1, kv_layout=layout)
    windows_t, windows_j, slots = {}, {}, []
    for i, p in enumerate(PROMPTS[:2]):
        sj, lj = jeng.start_sequence(p)
        st, lt = teng.start_sequence(p)
        np.testing.assert_allclose(lt, lj, atol=1e-4, rtol=1e-4)
        win = [int(np.argmax(lj)), 5 + i, 77]
        windows_j[sj], windows_t[st] = win, win
        slots.append((sj, st))
    jout = jeng.verify_step(windows_j)
    tout = teng.verify_step(windows_t)
    for sj, st in slots:
        np.testing.assert_allclose(tout[st][0], jout[sj][0], atol=1e-4,
                                   rtol=1e-4)
        assert tout[st][0].shape == (K + 1, 256)
        assert tout[st][1].tolist() == np.asarray(jout[sj][1]).tolist()
        # the lengths did not move; committing advances them
        assert teng.cache.length(st) == jeng.cache.length(sj)
        teng.commit_window(st, 2)
        assert teng.cache.length(st) == jeng.cache.length(sj) + 2
        jeng.free_sequence(sj)
        teng.free_sequence(st)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_spec_greedy_streams_match_jax(models, jax_streams, layout):
    spec = _spec(models, layout)
    for prompt, want in zip(PROMPTS, jax_streams):
        assert _spec_stream(spec, prompt, 12)[:12] == want, prompt
    assert spec.stats.windows > 0 and spec.stats.proposed > 0


@pytest.mark.parametrize("layout", LAYOUTS)
def test_spec_self_draft_accepts_everything(models, layout):
    spec = _spec(models, layout, self_draft=True)
    slot, _l, tok = spec.start_sequence_sampled([5, 3, 1], TS.GREEDY)
    got = [tok]
    for _ in range(4):
        out = spec.generate_step({slot: got[-1]}, {slot: TS.GREEDY})
        assert len(out[slot]) == K + 1
        got.extend(out[slot])
    spec.free_sequence(slot)
    assert spec.stats.acceptance_rate == 1.0
    assert spec.stats.tokens_per_window == K + 1
    assert got == _greedy(spec.target, [5, 3, 1], len(got))


@pytest.mark.parametrize("sp", [dict(temperature=0.9, top_k=8, seed=31),
                                dict(temperature=1.3, top_p=0.9, seed=7),
                                dict(temperature=0.6, seed=123456)],
                         ids=["topk", "topp", "plain"])
def test_accept_sampled_matches_reference(sp):
    """The same draft and target logits and proposals through the port's
    and the reference's ``_accept_sampled``: identical emitted tokens
    (rejections, residual draws and bonus tokens included) over 40
    windows."""
    rng = np.random.default_rng(11)
    V = 64
    tsp, jsp = TS.SamplingParams(**sp), JS.SamplingParams(**sp)
    seen_reject = seen_full = False
    for w in range(40):
        dl = [rng.standard_normal(V) * 2 for _ in range(K)]
        tl = rng.standard_normal((K + 1, V)) * 2
        if w % 2:                 # close to the draft: full acceptances
            tl[:K] = np.stack(dl) + 0.2 * rng.standard_normal((K, V))
        props = [int(np.argmax(d)) for d in dl]
        ttoks = rng.integers(0, V, size=K + 1)
        args = (w % 4, 10 + w, props, dl, tl, ttoks)
        got = TS.SpecDecodeEngine._accept_sampled(None, *args, tsp)
        want = JS.SpecDecodeEngine._accept_sampled(None, *args, jsp)
        assert got == want
        seen_reject |= got[0] < K
        seen_full |= got[0] == K
    assert seen_reject and seen_full


def _spec_counts():
    """(windows, proposed, accepted-histogram count) of the registry."""
    return (TSM.m_spec_windows.value, TSM.m_spec_proposed.value,
            TSM.m_spec_accepted._unlabeled().count)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_spec_behind_scheduler(models, jax_streams, layout):
    spec = _spec(models, layout)
    sched = TS.Scheduler(spec, device="cpu")
    before = _spec_counts()
    reqs = [sched.submit(p, max_new_tokens=9) for p in PROMPTS]
    for _ in range(200):
        if not sched.pending():
            break
        sched.step()
    assert [r.state for r in reqs] == ["done"] * len(reqs)
    for r, want in zip(reqs, jax_streams):
        assert r.tokens == want[:9]
    n = spec.stats.windows
    assert n > 0
    after = _spec_counts()
    assert [a - b for a, b in zip(after, before)] == [n, K * n, n]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_spec_evicts_at_min_headroom(models, layout):
    """A prompt that leaves fewer than W rows ends at admission with its
    one prefill token; a long generation stops once fewer than W rows are
    left, so no verify window ever runs past max_seq."""
    spec = _spec(models, layout, prefill_buckets=(8, 16, 32))
    assert spec.min_headroom == K + 1
    sched = TS.Scheduler(spec, device="cpu")
    full = sched.submit(list(range(1, 31)), max_new_tokens=8)   # 30 of 32
    long = sched.submit(list(range(100, 116)), max_new_tokens=30)
    for _ in range(200):
        if not sched.pending():
            break
        sched.step()
    assert full.state == long.state == "done"
    assert len(full.tokens) == 1
    # the cache holds 16 prompt rows + every token but the last; the last
    # window starts at <= 29 (W rows free) and leaves >= 30 rows: 15..17
    assert 15 <= len(long.tokens) <= 17
    assert spec.target.cache.live_slots() == []


def test_spec_engine_behind_the_front_door(models, jax_streams):
    """``FrontDoor`` and ``EngineLoop`` run a SpecDecodeEngine unchanged:
    /generate answers the target's greedy tokens, /health reads the
    engine's facade and turns "poisoned" when the draft is."""
    spec = _spec(models, "slab")
    front = TS.FrontDoor(TS.Scheduler(spec, device="cpu")).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{front.port}/generate",
            data=json.dumps({"prompt": PROMPTS[0],
                             "max_new_tokens": 6}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        assert body["tokens"] == jax_streams[0][:6]
        h = front.health()
        assert h["status"] == "ok" and h["max_batch"] == EKW["max_batch"]
        spec.draft.poisoned = "draft decode failed"
        deadline = time.time() + 5
        while time.time() < deadline and front.loop.alive:
            time.sleep(0.01)
        h = front.health()
        assert h["status"] == "poisoned"
        assert h["engine_poisoned"] == "draft decode failed"
    finally:
        front.stop()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_verify_failure_poisons_the_engine(models, layout):
    """A verify forward that fails after the caches went in (in place, as
    on the card) poisons the target, and so the spec engine; a window
    the page pool cannot map raises PagePoolFullError before any launch
    and poisons nothing."""
    spec = _spec(models, layout)
    target = spec.target
    # 6 prompt rows: a 3-token window at rows 6..8 needs a second page
    slot, _l, tok = spec.start_sequence_sampled([4, 5, 6, 7, 8, 9],
                                                TS.GREEDY)
    if layout == "paged":
        free = target.cache.free_page_count()
        held = target.cache._take_pages(free)      # dry the pool
        with pytest.raises(TS.PagePoolFullError):
            target.verify_step({slot: [tok, 1, 2]})
        assert spec.poisoned is None
        target.cache.deref_pages(held)
    target._in_place = True
    target._verify = lambda *a: (_ for _ in ()).throw(
        RuntimeError("device fault"))
    with pytest.raises(RuntimeError, match="device fault"):
        spec.generate_step({slot: tok})
    assert "verify_w3" in spec.poisoned
    with pytest.raises(RuntimeError, match="poisoned"):
        target.verify_step({slot: [tok, 1, 2]})
