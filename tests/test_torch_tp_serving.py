"""The port's tensor-parallel engine (``EngineConfig(sharding="tp",
tp=2)``, ``paddle_tpu_torch/serving/tp.py``) against the JAX package's tp
engine and the port's tp=1 engine, on the CPU: two gloo ranks a port
engine (``device="cpu"``), the JAX engine on the conftest's 8-device CPU
mesh.

Twins of the reference's tp tests (tests/test_paged_serving.py:399-500):
prefill logits and 6 greedy ticks at rtol = atol = 1e-4, slab and paged;
the scheduler's traffic; the verify window; the refusals; a rank's death
poisoning the engine. Beyond them: the tp engine as a speculative
target, the driver's death ends its followers, ``close()`` leaves no
child, a prefix record crosses between tp=2 and tp=1 engines, a gang
replica serves at tp=2 and its SIGKILL leaves no follower. GPT_TINY at
2 layers, float32, parameters from ``jax.random.PRNGKey(7)`` carried
across through numpy. One module-scoped tp=2 engine a layout, so the
file spawns followers a handful of times.
Every wait of a spawning test is bounded: the tp ranks' rendezvous,
collectives and answers by ``tp.DEFAULT_TIMEOUT_S``, the driver
subprocess's start-up (150 s) and the gang replica's (180 s).
"""
import multiprocessing
import os
import select
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from paddle_tpu import serving as JS
from paddle_tpu.models import gpt as JG
from paddle_tpu_torch import serving as TS
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.serving import tp as TP
from paddle_tpu_torch.serving.prefix_store import PrefixStore

EKW = dict(max_batch=4, max_seq=32, prefill_buckets=(8, 16))
PAGED = {"kv_layout": "paged", "page_size": 8}
LAYOUTS = {"slab": {}, "paged": PAGED}
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tiny():
    cfg_j = JG.GPT_TINY.scaled(num_layers=2, max_seq_len=64)
    cfg_t = TG.GPT_TINY.scaled(num_layers=2, max_seq_len=64)
    jp = JG.init_params(jax.random.PRNGKey(7), cfg_j)
    tp = TG.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return cfg_j, jp, cfg_t, tp


def port_engine(tiny, **kw):
    _, _, cfg_t, tp = tiny
    return TS.DecodeEngine(tp, cfg_t, TS.EngineConfig(**{**EKW, **kw}),
                           device="cpu")


@pytest.fixture(scope="module")
def engines(tiny):
    """{layout: (port tp=2, port tp=1, JAX tp=2)}; the port engines carry
    a 3-token verify window."""
    cfg_j, jp, _, _ = tiny
    out = {}
    for name, kw in LAYOUTS.items():
        tp2 = port_engine(tiny, sharding="tp", tp=2, verify_window=3, **kw)
        tp2.warmup()
        out[name] = (tp2, port_engine(tiny, verify_window=3, **kw),
                     JS.DecodeEngine(jp, cfg_j, JS.EngineConfig(
                         sharding="tp", tp=2, **EKW, **kw)))
    yield out
    for tp2, _, _ in out.values():
        tp2.close()


def _prompt(seed, n, V):
    return np.random.RandomState(seed).randint(0, V, size=n).tolist()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tp2_logits_match_jax_tp2_and_port_tp1(tiny, engines, layout):
    """Prefill logits and 6 greedy ticks within 1e-4 of the JAX tp=2
    engine's and the port tp=1 engine's, argmax equal at every tick."""
    tp2, tp1, jx = engines[layout]
    prompt = _prompt(9, 7, tiny[2].vocab_size)
    slots = [e.start_sequence(prompt) for e in (tp2, tp1, jx)]
    (s2, l2), (s1, l1), (sj, lj) = slots
    for tick in range(7):                      # the prefill, 6 ticks
        np.testing.assert_allclose(l2, lj, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(l2, l1, rtol=1e-4, atol=1e-4)
        tok = int(np.argmax(l2))
        assert tok == int(np.argmax(l1)) == int(np.argmax(lj)), tick
        if tick < 6:
            l2, l1, lj = (e.decode_step({s: tok})[s]
                          for e, s in ((tp2, s2), (tp1, s1), (jx, sj)))
    for e, (s, _) in zip((tp2, tp1, jx), slots):
        e.free_sequence(s)


def _forced_logits(engine, prompts, feed):
    """Prefill logits of ``prompts`` in one batch, then one tick's logits
    for every token list of ``feed`` (the same tokens for every engine)."""
    slots, rows = [], []
    for p in prompts:
        s, lg = engine.start_sequence(p)
        slots.append(s)
        rows.append(lg)
    for toks in feed:
        out = engine.decode_step(dict(zip(slots, toks)))
        rows.extend(out[s] for s in slots)
    for s in slots:
        engine.free_sequence(s)
    return np.stack(rows)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tp2_bf16_logits_within_one_card_bf16_error(tiny, engines, layout):
    """bf16 weights and compute, the ranks' partial sums all-reduced in
    bf16: prefill logits and 4 ticks of 4 prompts (every engine fed the
    bf16 tp=1 engine's greedy tokens) stray from the float32 tp=1
    engine's at most twice as far as the bf16 tp=1 engine's own do — the
    bf16 sum of two partials costs about one rounding more than one
    card's matmul, where a lost or doubled partial costs the logits'
    whole scale; the prefill's greedy tokens equal the bf16 tp=1
    engine's."""
    _, _, cfg_t, params = tiny
    cfg16 = cfg_t.scaled(dtype=torch.bfloat16)
    ekw = {**EKW, **LAYOUTS[layout], "weight_dtype": "bf16"}
    tp2 = TS.DecodeEngine(params, cfg16, TS.EngineConfig(
        sharding="tp", tp=2, **ekw), device="cpu")
    tp1 = TS.DecodeEngine(params, cfg16, TS.EngineConfig(**ekw),
                          device="cpu")
    f32 = engines[layout][1]
    V = cfg_t.vocab_size
    prompts = [_prompt(40 + i, n, V) for i, n in enumerate((3, 7, 12, 16))]
    try:
        l1 = _forced_logits(tp1, prompts, [])
        feed = [[int(t) for t in l1.argmax(-1)]]
        for _ in range(3):                 # tp=1 bf16's greedy path
            l1 = _forced_logits(tp1, prompts, feed)
            feed.append([int(t) for t in l1[-4:].argmax(-1)])
        l1 = _forced_logits(tp1, prompts, feed)
        l2 = _forced_logits(tp2, prompts, feed)
    finally:
        tp2.close()
    want = _forced_logits(f32, prompts, feed)
    assert l2.shape == want.shape == (4 * 5, V)
    one_card = np.abs(l1 - want).max()
    assert 0 < np.abs(l2 - want).max() <= 2 * one_card, \
        (np.abs(l2 - want).max(), one_card)
    assert (l2[:4].argmax(-1) == l1[:4].argmax(-1)).all()


def _serve(engine, prompts, samplings):
    sched = TS.Scheduler(engine, device="cpu")
    reqs = [sched.submit(p, max_new_tokens=5, sampling=sp)
            for p, sp in zip(prompts, samplings)]
    while sched.pending():
        sched.step()
    return reqs


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tp2_scheduler_traffic(tiny, engines, layout):
    """8 requests of mixed lengths, greedy and sampled lanes, through the
    Scheduler: all done, the greedy streams the tp=1 engine's; paged, the
    second of two requests sharing a page prefix hits the prefix cache."""
    tp2, tp1, _ = engines[layout]
    V = tiny[2].vocab_size
    rng = np.random.RandomState(11)
    shared = _prompt(3, 8, V)
    prompts = [shared + [5], shared + [6, 7]] + [
        _prompt(20 + i, int(rng.randint(1, 16)), V) for i in range(6)]
    samplings = [TS.GREEDY if i % 2 == 0 else
                 TS.SamplingParams(temperature=0.8, top_k=20, seed=i)
                 for i in range(8)]
    hits0 = tp2.prefix.hits if tp2.prefix is not None else 0
    got = _serve(tp2, prompts, samplings)
    want = _serve(tp1, prompts, samplings)
    assert all(r.state == "done" and len(r.tokens) == 5 for r in got)
    for i in range(0, 8, 2):
        assert got[i].tokens == want[i].tokens, i
    if layout == "paged":
        assert tp2.prefix.hits - hits0 >= 1
        assert tp2.cache.free_slot_count() == EKW["max_batch"]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tp2_verify_window_matches_tp1(tiny, engines, layout):
    """``verify_step`` with a 3-token window: logits within 1e-4 of the
    tp=1 engine's, target tokens equal; lengths unmoved."""
    tp2, tp1, _ = engines[layout]
    prompt = _prompt(5, 6, tiny[2].vocab_size)
    s2, l2 = tp2.start_sequence(prompt)
    s1, _ = tp1.start_sequence(prompt)
    win = [int(np.argmax(l2)), 4, 9]
    o2, o1 = tp2.verify_step({s2: win}), tp1.verify_step({s1: win})
    np.testing.assert_allclose(o2[s2][0], o1[s1][0], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(o2[s2][1], o1[s1][1])
    assert tp2.cache.length(s2) == len(prompt)
    tp2.free_sequence(s2)
    tp1.free_sequence(s1)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tp2_target_of_speculative_decoding(tiny, engines, layout):
    """The tp=2 engine as a ``SpecDecodeEngine``'s target (k = 2) under a
    tp=1 draft of the same weights: the greedy stream is the tp=1 engine's
    own, and a self-draft accepts every proposal."""
    tp2, tp1, _ = engines[layout]
    spec = TS.SpecDecodeEngine(tp2, port_engine(tiny, **LAYOUTS[layout]))
    prompt = _prompt(13, 5, tiny[2].vocab_size)
    slot, _l, tok = spec.start_sequence_sampled(prompt, TS.GREEDY)
    got = [tok]
    while len(got) < 9:
        got.extend(spec.generate_step({slot: got[-1]},
                                      {slot: TS.GREEDY})[slot])
    spec.free_sequence(slot)
    slot, logits = tp1.start_sequence(prompt)
    want = [int(np.argmax(logits))]
    while len(want) < len(got):
        want.append(int(np.argmax(tp1.decode_step({slot: want[-1]})[slot])))
    tp1.free_sequence(slot)
    assert got == want
    assert spec.stats.acceptance_rate == 1.0


def test_tp_refusals_match_the_reference(tiny, monkeypatch):
    """The reference's four refusals, in its words
    (``test_tp_rejects_int8_and_bad_sizes``), a rank's group refusing a
    missing card, and a plan that shards a leaf off Megatron's split
    refused naming the leaf."""
    with pytest.raises(ValueError, match="int8"):
        port_engine(tiny, sharding="tp", tp=2, weight_dtype="int8")
    with pytest.raises(ValueError, match="divide"):
        port_engine(tiny, sharding="tp", tp=3)
    with pytest.raises(ValueError, match="tp >= 2"):
        port_engine(tiny, sharding="tp", tp=1)
    _, _, cfg_t, tp = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="needs 2 devices, have 0"):
        TS.DecodeEngine(tp, cfg_t, TS.EngineConfig(sharding="tp", tp=2,
                                                   **EKW))
    # a rank's private group takes the card unless the CPU is asked for
    from paddle_tpu_torch.parallel import env as penv

    with pytest.raises(RuntimeError, match="device='cpu'"):
        penv.init_private_group("127.0.0.1:1", 0, 1, "gloo")
    from paddle_tpu_torch.sharding import plan

    ann = dict(plan.gpt_annotations("tp"), wte=("tp", None))
    monkeypatch.setattr(plan, "gpt_annotations", lambda *a, **k: ann)
    with pytest.raises(NotImplementedError, match="'wte'"):
        TP.shard_specs(tp, cfg_t, 2)


def _gone(pid: int) -> bool:
    """Exited: no such process, or a zombie its reaper has not collected
    yet (it holds nothing)."""
    try:
        os.kill(pid, 0)
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except (ProcessLookupError, FileNotFoundError):
        return True


def test_follower_death_poisons_within_timeout(tiny):
    """A follower SIGKILLed between ticks: the next decode_step raises
    within the group's timeout, ``poisoned`` is set, later calls refuse."""
    eng = port_engine(tiny, sharding="tp", tp=2, prefill_buckets=(8,))
    slot, logits = eng.start_sequence([1, 2, 3])
    tok = int(np.argmax(eng.decode_step({slot: int(np.argmax(logits))})
                        [slot]))
    (pid,) = eng.follower_pids
    os.kill(pid, signal.SIGKILL)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError):
        eng.decode_step({slot: tok})
    assert time.monotonic() - t0 < TP.DEFAULT_TIMEOUT_S
    assert eng.poisoned is not None and "tp rank" in eng.poisoned
    for call in (lambda: eng.decode_step({slot: tok}),
                 lambda: eng.start_sequence([1, 2, 3]),
                 lambda: eng.export_request_kv(slot)):
        with pytest.raises(RuntimeError, match="poisoned"):
            call()
    eng.close()


def test_follower_raise_poisons_and_close_leaves_no_child(tiny):
    """A follower that raises mid-call answers with its error and exits:
    the call raises naming it and the engine is poisoned. ``close()`` on a
    sound engine stops every follower, no child process left."""
    eng = port_engine(tiny, sharding="tp", tp=2, prefill_buckets=(8,))
    with pytest.raises(TP.RankFault, match="_cmd_no_such_command"):
        eng._tp.run("no_such_command")
    assert eng.poisoned is not None
    assert eng.follower_pids == []
    eng = port_engine(tiny, sharding="tp", tp=2, prefill_buckets=(8,))
    pids = eng.follower_pids
    assert len(pids) == 1 and not _gone(pids[0])
    eng.close()
    assert all(_gone(p) for p in pids)
    assert not [c for c in multiprocessing.active_children()
                if c.pid in pids]
    with pytest.raises(RuntimeError, match="closed"):
        eng.start_sequence([1, 2, 3])


DRIVER = """
import sys, time
import numpy as np
from paddle_tpu_torch import serving as TS
from paddle_tpu_torch.models import gpt as TG
cfg = TG.GPT_TINY.scaled(num_layers=1, max_seq_len=64)
p = TG.init_params(cfg, seed=0, device="cpu")
eng = TS.DecodeEngine(p, cfg, TS.EngineConfig(max_batch=2, max_seq=32,
                      prefill_buckets=(8,), sharding="tp", tp=2),
                      device="cpu")
print(eng.follower_pids[0], flush=True)
time.sleep(600)
"""


def test_driver_death_ends_its_followers():
    """SIGKILL the driver's process: its follower is gone within a few
    seconds (the watch on its parent), holding nothing."""
    proc = subprocess.Popen([sys.executable, "-c", DRIVER], cwd=str(REPO),
                            stdout=subprocess.PIPE, text=True)
    try:
        # the driver's start-up, bounded
        assert select.select([proc.stdout], [], [], 150.0)[0], \
            "the driver did not start its follower within 150 s"
        pid = int(proc.stdout.readline())
        assert not _gone(pid)
        proc.kill()
        proc.wait(timeout=10)
        deadline = time.monotonic() + 10.0
        while not _gone(pid) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert _gone(pid), "the follower outlived its driver"
    finally:
        proc.kill()


def test_prefix_record_crosses_tp2_and_tp1(tiny, engines, tmp_path):
    """A prefix record a tp=2 paged engine publishes restores into a tp=1
    engine, and one a tp=1 engine publishes into the tp=2 engine: the
    restored suffix-only prefill gives the publisher's logits."""
    tp2, _, _ = engines["paged"]
    V = tiny[2].vocab_size
    for k, (src, dst_of) in enumerate((
            (tp2, lambda: port_engine(tiny, **PAGED)),
            (port_engine(tiny, **PAGED), lambda: tp2))):
        prompt = _prompt(40 + k, 11, V)           # one full page of 8
        store = PrefixStore(str(tmp_path / f"s{k}"), use_async=False)
        src.prefix_store = store
        slot, want = src.start_sequence(prompt)
        src.free_sequence(slot)
        src.prefix_store = None
        assert store.saved == 1
        dst = dst_of()
        assert dst.attach_prefix_store(PrefixStore(
            str(tmp_path / f"s{k}"), use_async=False)) == 1
        dst.prefix_store = None
        hits = dst.prefix.hits
        slot, got = dst.start_sequence(prompt)
        assert dst.prefix.hits == hits + 1
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        dst.free_sequence(slot)
        store.close()


def _children(pid: int):
    """The pids whose parent is ``pid`` (from /proc)."""
    out = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    stat = f.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            if int(stat[1]) == pid:
                out.append(int(d))
    return out


def test_gang_tp_replica_serves_and_leaves_no_orphan(tmp_path):
    """A gang replica whose engine config says ``"sharding": "tp"`` builds
    a tp engine (its follower a child of the replica process) and serves
    the greedy tokens of a tp=1 engine from the same seed; SIGKILLing the
    replica leaves none of its children alive."""
    from paddle_tpu_torch.serving import GangConfig, ReplicaGang
    from paddle_tpu_torch.tools import serve_fault_bench as SFB

    # max_seq_len 128, not the gang tests' 64: at 64 (d_ff) wpe [64, 32]
    # matches w_out's suffix, the tp plan shards it off Megatron's split,
    # and the engine refuses it
    m = dict(SFB.TINY_MODEL, max_seq_len=128)
    cfg_t = TG.GPTConfig(vocab_size=m["vocab_size"],
                         max_seq_len=m["max_seq_len"],
                         num_layers=m["num_layers"],
                         num_heads=m["num_heads"], d_model=m["d_model"],
                         d_ff=m["d_ff"], dtype=torch.float32, remat=False)
    one = TS.DecodeEngine(TG.init_params(cfg_t, seed=m["seed"], device="cpu"),
                          cfg_t, TS.EngineConfig(**{
                              **SFB.TINY_ENGINE, "prefill_buckets": (8, 16)}),
                          device="cpu")
    prompt = [3, 9, 27, 81, 115]
    slot, logits = one.start_sequence(prompt)
    want = [int(np.argmax(logits))]
    for _ in range(5):
        want.append(int(np.argmax(one.decode_step({slot: want[-1]})[slot])))
    gang = ReplicaGang(
        {"model": dict(m), "device": "cpu", "request_timeout_s": 60.0,
         "engine": dict(SFB.TINY_ENGINE, sharding="tp", tp=2)},
        str(tmp_path / "gang"), GangConfig(
            n_replicas=1, probe_interval_s=0.1, hang_deadline_s=60.0,
            ready_timeout_s=180.0, default_timeout_s=60.0))
    try:
        gang.start()
        code, body = gang.dispatch({"prompt": prompt, "max_new_tokens": 6,
                                    "request_id": "tp-0"})
        assert code == 200 and body["tokens"] == want, body
        rep = gang.replicas[0]
        kids = _children(rep.proc.pid)
        assert kids, "the tp replica has no follower"
        rep.kill(signal.SIGKILL)
        deadline = time.monotonic() + 10.0
        while not all(_gone(k) for k in kids) and \
                time.monotonic() < deadline:
            time.sleep(0.1)
        assert all(_gone(k) for k in kids), "a follower outlived its replica"
    finally:
        gang.stop()
