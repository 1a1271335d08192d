"""One real-engine gang on the CPU: two replica processes of the port's
tiny paged GPT behind ``ReplicaGang``, one SIGKILLed mid-decode. Every
request is answered once, by failover where its replica died, and every
greedy token equals the JAX ``DecodeEngine``'s, where that engine serves
the port's seed weights (``init_params``) carried over as numpy, in
float32. The test holds itself to 120 s."""
import contextlib
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu import serving as JS
from paddle_tpu.models import gpt as JGPT
from paddle_tpu_torch.models import gpt as TGPT
from paddle_tpu_torch.serving.gang import GangConfig, ReplicaGang
from paddle_tpu_torch.tools import serve_fault_bench as SFB

LIMIT_S = 120
MAX_NEW = 16


@contextlib.contextmanager
def _time_limit(seconds):
    def _expired(signum, frame):
        raise TimeoutError(f"the test outlived its {seconds} s limit")

    old = signal.signal(signal.SIGALRM, _expired)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def _jax_tokens(prompts):
    m, e = SFB.TINY_MODEL, SFB.TINY_ENGINE
    kw = {k: m[k] for k in ("vocab_size", "max_seq_len", "num_layers",
                            "num_heads", "d_model", "d_ff")}
    tp = TGPT.init_params(TGPT.GPTConfig(**kw, dtype=torch.float32,
                                         remat=False),
                          seed=m["seed"], device="cpu")
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tp)
    eng = JS.DecodeEngine(jp, JGPT.GPTConfig(**kw, dtype=jnp.float32,
                                             remat=False),
                          JS.EngineConfig(**{
                              k: tuple(v) if isinstance(v, list) else v
                              for k, v in e.items()
                              if k != "weight_dtype"}))
    out = []
    for p in prompts:
        slot, logits = eng.start_sequence(p)
        toks = [int(np.argmax(logits))]
        for _ in range(MAX_NEW - 1):
            out_ = eng.decode_step({slot: toks[-1]})
            toks.append(int(np.argmax(out_[slot])))
        eng.free_sequence(slot)
        out.append(toks)
    return out


def test_engine_gang_sigkill_mid_decode_tokens_match_jax(tmp_path):
    t0 = time.time()
    with _time_limit(LIMIT_S):
        rng = np.random.RandomState(11)
        prompts = [rng.randint(0, SFB.TINY_MODEL["vocab_size"],
                               size=int(rng.randint(3, 12))).tolist()
                   for _ in range(8)]
        want = _jax_tokens(prompts)
        cfg = {"model": dict(SFB.TINY_MODEL), "engine": dict(SFB.TINY_ENGINE),
               "device": "cpu", "request_timeout_s": 60.0,
               "inject": {"step_delay_s": 0.01}}
        gang = ReplicaGang(cfg, str(tmp_path / "gang"), GangConfig(
            n_replicas=2, probe_interval_s=0.1, hang_deadline_s=30.0,
            ready_timeout_s=60.0, default_timeout_s=60.0))
        try:
            gang.start()
            killed = {}

            def killer():
                end = time.time() + 30
                while time.time() < end and not killed:
                    busy = max(gang.replicas, key=lambda r: r.inflight)
                    if busy.inflight >= 1:
                        time.sleep(0.05)     # a few decode ticks in
                        if busy.inflight >= 1:
                            killed["pid"] = busy.proc.pid
                            busy.kill(signal.SIGKILL)
                    time.sleep(0.002)

            kt = threading.Thread(target=killer)
            kt.start()
            results = [None] * len(prompts)

            def one(i):
                results[i] = gang.dispatch({
                    "prompt": prompts[i], "max_new_tokens": MAX_NEW,
                    "request_id": f"e-{i}"})

            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            kt.join(timeout=60)
            assert killed and not kt.is_alive()
            assert all(not t.is_alive() for t in threads)
            assert [r[0] for r in results] == [200] * len(prompts), results
            assert [r[1]["tokens"] for r in results] == want
            assert gang.failovers >= 1
            assert sum(bool(r[1].get("failovers")) for r in results) >= 1
            end = time.time() + 60
            while time.time() < end and not (
                    gang.health()["restarts"].get("crash", 0) >= 1
                    and gang.health()["ready"] == 2):
                time.sleep(0.1)
            h = gang.health()
            assert h["restarts"] == {"crash": 1} and h["ready"] == 2, h
            # the recycled replica serves the same tokens
            code, p = gang.replicas[0].post_generate(
                {"prompt": prompts[0], "max_new_tokens": MAX_NEW}, 60.0)
            assert code == 200 and p["tokens"] == want[0]
        finally:
            gang.stop()
    assert time.time() - t0 < LIMIT_S
