"""paddle_tpu_torch.serving against paddle_tpu.serving on the CPU.

The port's engine runs the plain versions of its kernels here (CPU
tensors); the JAX engine runs its Pallas decode kernels in interpret mode
(``EngineConfig(fused_decode=True)``), as tests/test_pallas_fused.py does.
Both start from the same JAX parameters carried across through numpy.
"""
import json
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from paddle_tpu import serving as JS
from paddle_tpu.models import gpt as JG
from paddle_tpu.serving import sampling as JSamp
from paddle_tpu_torch import serving as TS
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.serving import sampling as TSamp

EKW = dict(max_batch=4, max_seq=32, prefill_buckets=(8, 16))
REPO = Path(__file__).resolve().parents[1]


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


def _greedy(engine, prompt, n):
    slot, logits = engine.start_sequence(prompt)
    tok = int(np.argmax(logits))
    toks = [tok]
    for _ in range(n - 1):
        out = engine.decode_step({slot: tok})
        tok = int(np.argmax(out[slot]))
        toks.append(tok)
    engine.free_sequence(slot)
    return toks


@pytest.fixture(scope="module")
def jax_tokens(tiny):
    """Greedy tokens of the JAX fused-decode engine for prompts of length
    3, 6 and 11 (test_pallas_fused.py:620-641)."""
    cfg_j, jp, _, _ = tiny
    eng = JS.DecodeEngine(jp, cfg_j, JS.EngineConfig(fused_decode=True,
                                                     **EKW))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg_j.vocab_size, size=n).tolist()
               for n in (3, 6, 11)]
    return [(p, _greedy(eng, p, 12)) for p in prompts]


@pytest.mark.parametrize("fused", [True, False], ids=["kernels", "plain"])
def test_greedy_tokens_match_jax_fused_engine(tiny, jax_tokens, fused):
    eng = _port_engine(tiny, fused_decode=fused)
    for prompt, want in jax_tokens:
        assert _greedy(eng, prompt, 12) == want, prompt


def test_bf16_engine_tracks_jax(tiny):
    """bf16 compute and weights: tokens are compared exactly only in f32
    (rounding order differs between the frameworks), so at bf16 the port
    is teacher-forced with JAX's greedy tokens and held to per-step logits
    within 1e-2 (about one bf16 ulp) and a 95% argmax agreement share."""
    _, jp, _, tp = tiny
    cfg_j = JG.GPT_TINY.scaled(num_layers=2, max_seq_len=64,
                               dtype=jax.numpy.bfloat16)
    cfg_t = TG.GPT_TINY.scaled(num_layers=2, max_seq_len=64,
                               dtype=torch.bfloat16)
    jeng = JS.DecodeEngine(jp, cfg_j, JS.EngineConfig(
        fused_decode=True, weight_dtype="bf16", **EKW))
    teng = TS.DecodeEngine(tp, cfg_t, TS.EngineConfig(
        weight_dtype="bf16", **EKW), device="cpu")
    rng = np.random.RandomState(0)
    agree, steps = 0, 0
    for n in (3, 6, 11, 5, 9):
        prompt = rng.randint(0, cfg_j.vocab_size, size=n).tolist()
        sj, lj = jeng.start_sequence(prompt)
        st, lt = teng.start_sequence(prompt)
        for _ in range(12):
            np.testing.assert_allclose(lt, lj, atol=1e-2, rtol=1e-2)
            agree += int(np.argmax(lt) == np.argmax(lj))
            steps += 1
            tok = int(np.argmax(lj))
            lj = jeng.decode_step({sj: tok})[sj]
            lt = teng.decode_step({st: tok})[st]
        jeng.free_sequence(sj)
        teng.free_sequence(st)
    assert agree / steps >= 0.95, (agree, steps)


def test_prefill_logits_match_reference(tiny):
    cfg_j, jp, _, _ = tiny
    eng = _port_engine(tiny)
    eng.warmup()
    jeng = JS.DecodeEngine(jp, cfg_j, JS.EngineConfig(**EKW))
    prompt = np.random.RandomState(0).randint(0, 256, size=6).tolist()
    slot, logits = eng.start_sequence(prompt)
    np.testing.assert_allclose(logits, jeng.reference_logits(prompt)[-1],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits, eng.reference_logits(prompt)[-1],
                               rtol=1e-4, atol=1e-4)
    eng.free_sequence(slot)


def test_partial_batch_isolation(tiny):
    """A parked slot riding as a masked lane keeps its cache: park one
    sequence, decode another, resume — the continuation equals an engine
    that never interleaved (test_pallas_fused.py:644-678)."""
    eng, ref = _port_engine(tiny), _port_engine(tiny)
    pa, pb = [5, 9, 2], [7, 7, 7, 1]
    want = _greedy(ref, pa, 8)
    slot_a, la = eng.start_sequence(pa)
    ta = int(np.argmax(la))
    got = [ta]
    for _ in range(3):
        ta = int(np.argmax(eng.decode_step({slot_a: ta})[slot_a]))
        got.append(ta)
    slot_b, lb = eng.start_sequence(pb)
    tb = int(np.argmax(lb))
    for _ in range(4):
        out = eng.decode_step({slot_a: ta, slot_b: tb})
        ta, tb = int(np.argmax(out[slot_a])), int(np.argmax(out[slot_b]))
        got.append(ta)
    assert got == want


def _run(sched, reqs, max_steps=500):
    for _ in range(max_steps):
        if all(r.finished.is_set() for r in reqs):
            return
        sched.step()
    raise AssertionError("scheduler did not finish")


def test_scheduler_fifo_turnover(tiny):
    """Five requests through two slots: FIFO admission, every request
    done, tokens as if each ran alone, every slot free at the end."""
    eng = _port_engine(tiny, max_batch=2)
    ref = _port_engine(tiny)
    sched = TS.Scheduler(eng, device="cpu")
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 256, size=n).tolist() for n in (4, 7, 2, 9, 5)]
    reqs = [sched.submit(p, max_new_tokens=3 + i)
            for i, p in enumerate(prompts)]
    admitted = []
    for _ in range(200):
        if all(r.finished.is_set() for r in reqs):
            break
        sched.step()
        for r in reqs:
            if r.slot is not None and r.id not in admitted:
                admitted.append(r.id)
    assert admitted == [r.id for r in reqs]
    for i, (r, p) in enumerate(zip(reqs, prompts)):
        assert r.state == "done"
        assert r.tokens == _greedy(ref, p, 3 + i)
        assert r.ttft_ms is not None
    assert eng.cache.free_slot_count() == 2
    assert sched.completed == 5


def test_kv_cache_slot_allocator():
    """The slab allocator of serving/kv_cache.py:71-157 — lowest slot
    first, generation bumped on reuse, bounds checked."""
    c = TS.KVCache(2, 3, 16, 2, 8, dtype=torch.bfloat16, device="cpu")
    assert tuple(c.k.shape) == (2, 3, 16, 2, 8) and c.k.dtype == \
        torch.bfloat16
    assert c.nbytes == 2 * 2 * 3 * 16 * 2 * 8 * 2
    assert [c.alloc(length=4), c.alloc(), c.alloc()] == [0, 1, 2]
    with pytest.raises(TS.CacheFullError):
        c.alloc()
    gen = c.generation(1)
    c.free(1)
    assert c.free_slot_count() == 1 and c.live_slots() == [0, 2]
    assert c.alloc(length=5) == 1 and c.generation(1) == gen + 1
    np.testing.assert_array_equal(c.lengths_vector(), [4, 5, 0])
    assert c.headroom(0) == 12 and c.occupancy == 1.0
    with pytest.raises(ValueError):
        c.set_length(0, 17)
    c.free(0)
    with pytest.raises(ValueError):
        c.free(0)                                 # double free
    with pytest.raises(ValueError):
        c.alloc(length=17)


def test_scheduler_cancel_drain_abort(tiny):
    eng = _port_engine(tiny, max_batch=1)
    sched = TS.Scheduler(eng, device="cpu")
    a = sched.submit([1, 2], max_new_tokens=3)
    b = sched.submit([3, 4], max_new_tokens=3)
    c = sched.submit([5, 6], max_new_tokens=3)
    assert sched.cancel(c) and c.state == "cancelled"
    sched.step()                       # a admitted; b waits for the slot
    assert a.state == "active" and b.state == "queued"
    assert not sched.cancel(a)         # only queued requests cancel
    assert sched.drain(timeout_s=60.0)
    assert (a.state, b.state) == ("done", "done")
    with pytest.raises(RuntimeError, match="draining"):
        sched.submit([1], max_new_tokens=1)
    sched2 = TS.Scheduler(eng, device="cpu")
    x = sched2.submit([1, 2], max_new_tokens=9)
    y = sched2.submit([3, 4], max_new_tokens=9)
    sched2.step()
    assert sched2.abort_all("stop", refuse_new=True) == 2
    assert (x.state, y.state) == ("failed", "failed") and x.error == "stop"
    assert eng.cache.free_slot_count() == 1
    with pytest.raises(RuntimeError, match="stop"):
        sched2.submit([1], max_new_tokens=1)


def test_scheduler_deadlines(tiny):
    eng = _port_engine(tiny)
    sched = TS.Scheduler(eng, device="cpu")
    queued = sched.submit([1, 2, 3], max_new_tokens=4, timeout_s=0.0)
    sched.step()
    assert queued.state == "expired" and queued.tokens == []
    active = sched.submit([1, 2, 3], max_new_tokens=20, timeout_s=60.0)
    sched.step()                                # prefill + one decode
    assert active.state == "active" and len(active.tokens) == 2
    active.deadline = time.monotonic() - 1.0
    sched.step()
    assert active.state == "expired" and len(active.tokens) == 2
    assert "deadline" in active.error
    assert eng.cache.free_slot_count() == EKW["max_batch"]


def test_scheduler_eos_and_max_seq(tiny):
    prompt = [3, 1, 4, 1, 5]
    first_two = _greedy(_port_engine(tiny), prompt, 2)
    eng = _port_engine(tiny, eos_id=first_two[1])
    sched = TS.Scheduler(eng, device="cpu")
    r = sched.submit(prompt, max_new_tokens=10)
    _run(sched, [r])
    assert r.state == "done" and r.tokens == first_two
    # a slot that reaches max_seq finishes with the tokens that fit
    eng = _port_engine(tiny)
    sched = TS.Scheduler(eng, device="cpu")
    r = sched.submit(list(range(1, 17)), max_new_tokens=100)
    _run(sched, [r])
    assert r.state == "done" and len(r.tokens) == EKW["max_seq"] - 16 + 1


@pytest.mark.parametrize("temp,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.8), (0.9, 20, 0.6)])
def test_masked_logits_match_jax(temp, top_k, top_p):
    logits = np.random.default_rng(6).standard_normal(100).astype(
        np.float32) * 3
    want = np.asarray(JSamp._masked_logits(
        jax.numpy.asarray(logits), np.float32(temp), np.int32(top_k),
        np.float32(top_p)))
    got = TSamp._masked_logits(torch.from_numpy(logits), temp, top_k,
                               top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    keep = np.isfinite(want)
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6)


def test_sampled_tokens_follow_adjusted_probs():
    """The sampled lane draws from exactly the distribution
    adjusted_probs_np describes (the bits differ from JAX's threefry, so
    the lane is held to JAX by its distribution), and a draw is a pure
    function of (seed, position)."""
    logits = np.array([2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -3.0],
                      np.float32)
    sp = TSamp.SamplingParams(temperature=0.8, top_k=6, top_p=0.9, seed=11)
    probs = TSamp.adjusted_probs_np(logits, sp)
    np.testing.assert_allclose(probs, JSamp.adjusted_probs_np(
        logits, JSamp.SamplingParams(temperature=0.8, top_k=6, top_p=0.9,
                                     seed=11)), rtol=1e-12)
    t = torch.from_numpy(logits)
    n = 4000
    draws = np.array([TSamp.sample_token(t, sp.temperature, sp.top_k,
                                         sp.top_p, sp.seed, pos)
                      for pos in range(n)])
    freq = np.bincount(draws, minlength=len(logits)) / n
    assert np.all(freq[probs == 0] == 0)
    # 4 sigma of a binomial share at n=4000 is below 0.032
    np.testing.assert_allclose(freq, probs, atol=0.032)
    assert TSamp.sample_token(t, 0.8, 6, 0.9, 11, 17) == draws[17]
    assert TSamp.sample_token(t, 0.0, 6, 0.9, 11, 17) == 0    # greedy


def _post(port, body, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=body if isinstance(body, bytes) else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_front_door_generate_codes(tiny):
    """/generate answers 200, 400, 429 and 503 over loopback."""
    eng = _port_engine(tiny)
    door = TS.FrontDoor(TS.Scheduler(eng, device="cpu")).start()
    full = TS.FrontDoor(TS.Scheduler(
        eng, TS.SchedulerConfig(max_queue=0), device="cpu")).start()
    try:
        prompt = [9, 8, 7, 6]
        code, body = _post(door.port, {"prompt": prompt,
                                       "max_new_tokens": 5})
        assert code == 200, body
        assert body["tokens"] == _greedy(_port_engine(tiny), prompt, 5)
        assert _post(door.port, b"{not json")[0] == 400
        assert _post(door.port, {"prompt": []})[0] == 400
        assert _post(door.port, {"prompt": list(range(17))})[0] == 400
        code, body = _post(full.port, {"prompt": prompt})
        assert code == 429 and "capacity" in body["error"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{door.port}/health", timeout=10) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["loop_alive"]
        door.scheduler.begin_drain()
        assert _post(door.port, {"prompt": prompt})[0] == 503
    finally:
        full.stop()
        assert door.drain(timeout_s=10.0)


def test_entry_points_need_a_card_unless_cpu_is_asked(tiny, monkeypatch):
    _, jp, cfg_t, tp = tiny
    cpu_engine = _port_engine(tiny)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TG.init_params(cfg_t, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TG.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.DecodeEngine(tp, cfg_t, TS.EngineConfig(**EKW))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.Scheduler(cpu_engine)


@pytest.mark.parametrize("kw", [dict(kv_layout="paged"),
                                dict(sharding="tp", tp=2),
                                dict(weight_dtype="int8"),
                                dict(verify_window=3)],
                         ids=["paged", "tp", "int8", "spec"])
def test_unported_engine_options_refused(tiny, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _port_engine(tiny, **kw)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import paddle_tpu_torch, paddle_tpu_torch.serving, chip_smoke\n"
        "import paddle_tpu_torch.ops.cuda_kernels, "
        "paddle_tpu_torch.ops._build, paddle_tpu_torch.observability.hw, "
        "paddle_tpu_torch.tools.profile_decode\n"
        "import paddle_tpu_torch.ops.flash_attention, "
        "paddle_tpu_torch.parallel.parallelize, "
        "paddle_tpu_torch.parallel.remat, paddle_tpu_torch.parallel.health, "
        "paddle_tpu_torch.tools.train_bench\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
