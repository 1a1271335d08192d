"""The port's repairs of faults against the reference, on the CPU.

- A failed call that wrote the KV caches in place poisons the engine, and
  the loop and the front door fail fast on it, as the reference's do
  after a donation failure (``tests/test_serving_resilience.py::
  test_poisoned_engine_fails_fast``, ``tests/test_serving_engine.py::
  test_engine_poisoned_after_donation_failure``). On the card the
  caches are written in place; the tests stand that in with the engine's
  ``_in_place`` flag, as the reference's test sets ``_donate``.
- ``Executor.run`` takes the reference's signature, positionally and by
  keyword, with the same results as the JAX executor.
"""
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

import paddle_tpu as fluid
from paddle_tpu.framework import unique_name as JUN
from paddle_tpu.models import gpt as JG
import paddle_tpu_torch as T
from paddle_tpu_torch import serving as TS
from paddle_tpu_torch.framework import unique_name as TUN
from paddle_tpu_torch.models import gpt as TG

from test_torch_fluid_program import FACTORIES, build_mlp

EKW = dict(max_batch=4, max_seq=32, prefill_buckets=(8, 16))


@pytest.fixture(scope="module")
def tiny():
    cfg_j = JG.GPT_TINY.scaled(num_layers=2, max_seq_len=64)
    cfg_t = TG.GPT_TINY.scaled(num_layers=2, max_seq_len=64)
    jp = JG.init_params(jax.random.PRNGKey(7), cfg_j)
    tp = TG.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return cfg_t, tp


def _engine(tiny):
    cfg_t, tp = tiny
    return TS.DecodeEngine(tp, cfg_t, TS.EngineConfig(**EKW), device="cpu")


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), r.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def _raiser(*_a, **_k):
    raise RuntimeError("device OOM")


def test_poisoned_engine_fails_fast(tiny):
    """The twin of the reference's test over the port's front door: a
    poisoned engine fires ``on_poison`` once, /health answers
    ``poisoned`` with the reason, and a later submit gets a clean 503
    with ``Retry-After``, not a hang or a 500."""
    engine = _engine(tiny)
    sched = TS.Scheduler(engine, device="cpu")
    fired = []
    front = TS.FrontDoor(sched, on_poison=fired.append).start()
    try:
        code, body, _h = _post(front.port, {"prompt": [1, 2, 3],
                                            "max_new_tokens": 2})
        assert code == 200 and len(body["tokens"]) == 2
        assert front.health()["status"] == "ok"
        # the state a failed in-place call leaves behind
        engine.poisoned = "decode failed after writing the caches in place"
        deadline = time.time() + 5
        while time.time() < deadline and not fired:
            time.sleep(0.01)
        assert fired == ["decode failed after writing the caches in place"]
        h = front.health()
        assert h["status"] == "poisoned"
        assert "in place" in h["engine_poisoned"]
        assert not front.loop.alive          # the loop stopped ticking
        code, body, headers = _post(front.port, {"prompt": [1, 2],
                                                 "max_new_tokens": 2})
        assert code == 503
        assert "poisoned" in body["error"]
        assert "Retry-After" in headers and body["retry_after_s"] >= 1
        assert sched.refusing is not None
    finally:
        front.stop()


def test_engine_poisoned_after_donation_failure(tiny):
    """The twin of the reference's test: a prefill that fails after the
    caches were handed over in place poisons the engine, and every entry
    point then refuses; without in-place caches (the CPU) the engine
    stays usable after the same failure."""
    eng = _engine(tiny)
    eng._in_place = True            # stand-in for the caches on the card
    orig = eng._prefill
    eng._prefill = _raiser
    with pytest.raises(RuntimeError, match="device OOM"):
        eng.start_sequence([1, 2, 3])
    assert eng.poisoned is not None
    assert eng.cache.free_slot_count() == EKW["max_batch"]
    eng._prefill = orig
    with pytest.raises(RuntimeError, match="poisoned"):
        eng.start_sequence([1, 2, 3])
    with pytest.raises(RuntimeError, match="poisoned"):
        eng.decode_step({0: 1})

    eng2 = _engine(tiny)            # the CPU: no in-place caches, no poison
    assert eng2._in_place is False
    orig2 = eng2._prefill
    eng2._prefill = _raiser
    with pytest.raises(RuntimeError, match="device OOM"):
        eng2.start_sequence([1, 2, 3])
    assert eng2.poisoned is None
    eng2._prefill = orig2
    slot, logits = eng2.start_sequence([1, 2, 3])
    assert logits.shape[-1] == eng2.cfg.vocab_size
    eng2.free_sequence(slot)


def test_decode_failure_poisons_and_pool_full_does_not(tiny):
    """A decode tick that fails on the card poisons the engine; a paged
    pool that is dry raises before any launch and leaves it usable, as
    the reference re-raises ``PagePoolFullError`` without poisoning."""
    eng = _engine(tiny)
    eng._in_place = True
    slot, _ = eng.start_sequence([1, 2, 3])
    eng._decode = _raiser
    with pytest.raises(RuntimeError, match="device OOM"):
        eng.decode_step({slot: 4})
    assert "decode" in eng.poisoned
    with pytest.raises(RuntimeError, match="poisoned"):
        eng.generate_step({slot: 4})

    cfg_t, tp = tiny
    paged = TS.DecodeEngine(tp, cfg_t, TS.EngineConfig(
        kv_layout="paged", page_size=8, num_pages=3, prefix_cache=False,
        **EKW), device="cpu")
    paged._in_place = True
    slot, _ = paged.start_sequence(list(range(1, 17)))   # 2 of 2 pages
    with pytest.raises(TS.PagePoolFullError):
        paged.decode_step({slot: 4})
    assert paged.poisoned is None


def _run_both_forms(main, loss, exe_of, scope_of, feed):
    """Losses of 3 MLP steps from the scope ``scope_of()`` makes, run
    through ``Executor.run`` positionally in the reference's order and by
    keyword with every argument named."""
    out = []
    for form in ("positional", "keyword"):
        exe, scope = exe_of(), scope_of()
        losses = []
        for _ in range(3):
            if form == "positional":
                r = exe.run(main, feed, [loss], "feed", "fetch", scope, True,
                            True)
            else:
                r = exe.run(program=main, feed=feed, fetch_list=[loss],
                            feed_var_name="feed", fetch_var_name="fetch",
                            scope=scope, return_numpy=True,
                            use_program_cache=True)
            losses.append(float(np.asarray(r[0])))
        out.append(losses)
    return out


def test_executor_run_takes_the_reference_signature():
    """Both call forms of ``Executor.run`` (the reference's positional
    order program, feed, fetch_list, feed_var_name, fetch_var_name, scope,
    return_numpy, use_program_cache; and every argument by keyword) train
    the same MLP from the same start to the same losses on the port and on
    JAX: the scope passed sixth is the scope used."""
    rng = np.random.default_rng(0)
    feed = {"x": rng.standard_normal((4, 8)).astype(np.float32),
            "y": rng.standard_normal((4, 1)).astype(np.float32)}
    jm, js, jl = build_mlp(fluid, JUN, FACTORIES["sgd"])
    tm, _ts, tl = build_mlp(T, TUN, FACTORIES["sgd"])
    start = fluid.Scope()
    fluid.Executor(fluid.XLAPlace(0)).run(js, scope=start)
    state = {n: np.asarray(start.find_var(n))
             for n, v in jm.global_block().vars.items() if v.persistable}

    def jscope():
        scope = fluid.Scope()
        for n, value in state.items():
            scope.set_var(n, value)
        return scope

    jpos, jkw = _run_both_forms(
        jm, jl, lambda: fluid.Executor(fluid.XLAPlace(0)), jscope, feed)
    tpos, tkw = _run_both_forms(
        tm, tl, lambda: T.Executor(T.CPUPlace()),
        lambda: T.scope_from_numpy(state, T.CPUPlace()), feed)
    assert tpos == tkw and jpos == jkw
    assert tpos[-1] < tpos[0]
    np.testing.assert_allclose(tpos, jpos, rtol=0, atol=1e-6)
