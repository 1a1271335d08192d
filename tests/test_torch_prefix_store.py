"""The port's persistent prefix store (``paddle_tpu_torch/serving/
prefix_store.py``) beside the JAX package's ``PrefixStore``: a warm
restart in one process (the restarted engine prefills the suffix alone), a
record of another cache geometry refused with the same
``CacheConfigMismatch`` JAX raises, a legacy record skipped, and records
crossing the packages both ways — a JAX engine's record restored into the
port's pool bitwise, with the same prefix hits, and the reverse. Mirrors
``tests/test_serving_resilience.py``'s prefix-store tests. Both packages'
engines serve the port's seed weights (``init_params``), carried to JAX as
numpy, in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu import serving as JS
from paddle_tpu.models import gpt as JGPT
from paddle_tpu.serving import metrics as JM
from paddle_tpu.serving import prefix_store as JPS
from paddle_tpu_torch import serving as TS
from paddle_tpu_torch.models import gpt as TGPT
from paddle_tpu_torch.serving import metrics as TM
from paddle_tpu_torch.serving import prefix_store as TPS

SYSTEM = [7] * 8 + [3, 5, 2, 9]          # 12 tokens: one full page of 8
EKW = dict(max_batch=2, max_seq=32, prefill_buckets=(8, 16),
           kv_layout="paged", page_size=8)


@pytest.fixture(scope="module")
def tiny():
    cfg_t = TGPT.GPT_TINY.scaled(num_layers=1, max_seq_len=64)
    cfg_j = JGPT.GPT_TINY.scaled(num_layers=1, max_seq_len=64)
    tp = TGPT.init_params(cfg_t, seed=3, device="cpu")
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tp)
    return cfg_t, tp, cfg_j, jp


def _port(tiny, **kw):
    cfg_t, tp = tiny[0], tiny[1]
    return TS.DecodeEngine(tp, cfg_t, TS.EngineConfig(**{**EKW, **kw}),
                           device="cpu")


def _jax(tiny, **kw):
    cfg_j, jp = tiny[2], tiny[3]
    return JS.DecodeEngine(jp, cfg_j, JS.EngineConfig(**{**EKW, **kw}))


def _serve(sched, prompt, n=3):
    r = sched.submit(prompt, max_new_tokens=n)
    while sched.pending():
        sched.step()
    assert r.state == "done"
    return list(r.tokens)


def _pages(eng, tokens):
    """The K/V contents of ``tokens``' cached prefix pages, as numpy."""
    n, pages = eng.prefix.lookup(tokens)
    k, v = eng.cache.read_pages(list(pages))
    return n, np.asarray(k), np.asarray(v)


def test_prefix_store_warm_restart_in_process(tmp_path, tiny):
    """Engine A publishes the system prompt's page; engine B (a fresh pool
    over the same store directory) restores it and prefills only the
    suffix, with A's tokens."""
    store_a = TPS.PrefixStore(str(tmp_path / "store"))
    eng_a = _port(tiny)
    assert eng_a.attach_prefix_store(store_a) == 0
    eng_a.warmup()
    sched_a = TS.Scheduler(eng_a, device="cpu")
    t0 = TM.m_prefill_tokens.value
    ta = _serve(sched_a, SYSTEM)
    assert TM.m_prefill_tokens.value - t0 == 12
    store_a.wait()
    assert store_a.saved == 1 and store_a.record_count() == 1
    assert len(store_a.publish_ms) == 1 and store_a.publish_ms[0] > 0
    # a repeated prompt adds nothing to the store (hash-deduped)
    assert _serve(sched_a, SYSTEM) == ta
    store_a.wait()
    assert store_a.saved == 1

    store_b = TPS.PrefixStore(str(tmp_path / "store"))
    eng_b = _port(tiny)
    assert eng_b.attach_prefix_store(store_b) == 1
    assert store_b.restored == 1
    eng_b.warmup()
    t0 = TM.m_prefill_tokens.value
    assert _serve(TS.Scheduler(eng_b, device="cpu"), SYSTEM) == ta
    assert TM.m_prefill_tokens.value - t0 == 4
    store_a.close()
    store_b.close()


def test_mismatched_geometry_refused_as_jax_refuses(tmp_path, tiny):
    """A record written for page 8 offered to a page-16 pool: both packages
    raise ``CacheConfigMismatch`` with the same message, naming every
    differing field; the engine serves cold once the store is detached."""
    d = str(tmp_path / "store")
    store = JPS.PrefixStore(d)
    eng = _jax(tiny)
    eng.attach_prefix_store(store)
    eng.warmup()
    _serve(JS.Scheduler(eng), SYSTEM)
    store.wait()
    assert store.saved == 1
    msgs = []
    for mk, pkg in ((_jax, JS), (_port, TS)):
        other = mk(tiny, page_size=16, prefill_buckets=(16, 32),
                   cache_dtype=(jnp.bfloat16 if pkg is JS else
                                __import__("torch").bfloat16))
        mod = JPS if pkg is JS else TPS
        with pytest.raises(pkg.CacheConfigMismatch) as ei:
            other.attach_prefix_store(mod.PrefixStore(d))
        msgs.append(str(ei.value))
    assert msgs[1] == msgs[0]
    assert "page_size: expected 16, got 8" in msgs[1]
    assert "dtype: expected 'bfloat16', got 'float32'" in msgs[1]
    # serving cold after the refusal
    cold = _port(tiny, page_size=16, prefill_buckets=(16, 32))
    with pytest.raises(TS.CacheConfigMismatch):
        cold.attach_prefix_store(TPS.PrefixStore(d))
    cold.prefix_store = None
    cold.warmup()
    assert len(_serve(TS.Scheduler(cold, device="cpu"), SYSTEM)) == 3


def test_legacy_record_shape_drift_skipped(tmp_path, tiny, monkeypatch):
    """A record without a fingerprint (an older writer) whose shape does
    not fit the pool is skipped and counted, never half-applied."""
    store = TPS.PrefixStore(str(tmp_path / "store"))
    monkeypatch.setattr(TPS, "cache_fingerprint", lambda cache: None)
    eng = _port(tiny)
    eng.attach_prefix_store(store)
    eng.warmup()
    _serve(TS.Scheduler(eng, device="cpu"), SYSTEM)
    store.wait()
    assert store.saved == 1
    monkeypatch.undo()
    skipped0 = TM.m_prefix_store.labels("restore_skipped").value
    store2 = TPS.PrefixStore(str(tmp_path / "store"))
    eng2 = _port(tiny, page_size=16, prefill_buckets=(16, 32))
    assert eng2.attach_prefix_store(store2) == 0
    assert store2.restore_skipped == 1
    assert TM.m_prefix_store.labels("restore_skipped").value - skipped0 == 1
    assert eng2.cache.free_page_count() == eng2.cache.num_pages - 1
    eng2.warmup()
    assert len(_serve(TS.Scheduler(eng2, device="cpu"), SYSTEM, 2)) == 2


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_records_cross_the_packages_bitwise(tmp_path, tiny, writer):
    """A record written by one package's engine restores into the other's
    pool with the writer's page contents bit for bit; a repeated prompt
    then hits the prefix cache on both alike (one hit, 4 suffix tokens
    prefilled) and both emit the same tokens."""
    d = str(tmp_path / "store")
    w_eng = _jax(tiny) if writer == "jax" else _port(tiny)
    w_mod = JPS if writer == "jax" else TPS
    store = w_mod.PrefixStore(d)
    w_eng.attach_prefix_store(store)
    w_eng.warmup()
    sched = (JS.Scheduler(w_eng) if writer == "jax"
             else TS.Scheduler(w_eng, device="cpu"))
    want = _serve(sched, SYSTEM + [1, 2])
    store.wait()
    store.close()
    n_w, k_w, v_w = _pages(w_eng, SYSTEM)

    restored = {}
    for name, mk, mod in (("jax", _jax, JPS), ("port", _port, TPS)):
        eng = mk(tiny)
        assert eng.attach_prefix_store(mod.PrefixStore(d)) == 1
        n, k, v = _pages(eng, SYSTEM)
        assert n == n_w == 8
        assert k.tobytes() == k_w.tobytes() and v.tobytes() == v_w.tobytes()
        eng.warmup()
        sched = (JS.Scheduler(eng) if name == "jax"
                 else TS.Scheduler(eng, device="cpu"))
        m = JM if name == "jax" else TM
        hits0, tok0 = eng.prefix.hits, m.m_prefill_tokens.value
        toks = _serve(sched, SYSTEM + [1, 2])
        restored[name] = (toks, eng.prefix.hits - hits0,
                          m.m_prefill_tokens.value - tok0)
    assert restored["port"] == restored["jax"] == (want, 1, 6)
