"""The serving hooks a gang replica relies on, in the port's front door
beside the JAX package's: the engine loop stamps the hang watchdog's
progress (``serve/tick``) on every pass, so a watchdog armed at a short
deadline stays quiet while the loop ticks and fires when it wedges; and
``FrontDoor.install_signal_handlers`` turns SIGTERM into a drain — the
in-flight request finishes, new work gets 503, and the process exits 0.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from paddle_tpu import serving as JS
from paddle_tpu.models import gpt as JGPT
from paddle_tpu.parallel import health as JH
from paddle_tpu_torch import serving as TS
from paddle_tpu_torch.models import gpt as TGPT
from paddle_tpu_torch.parallel import health as TH

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EKW = dict(max_batch=2, max_seq=32, prefill_buckets=(8, 16))


def _post(port, body, timeout=30.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return json.loads(r.read().decode())


@pytest.fixture(scope="module")
def engines():
    """A JAX and a port engine over the same tiny f32 weights."""
    cfg_t = TGPT.GPT_TINY.scaled(num_layers=1, max_seq_len=64)
    cfg_j = JGPT.GPT_TINY.scaled(num_layers=1, max_seq_len=64)
    jp = JGPT.init_params(jax.random.PRNGKey(3), cfg_j)
    tp = TGPT.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                device="cpu")
    return {"jax": JS.DecodeEngine(jp, cfg_j, JS.EngineConfig(**EKW)),
            "port": TS.DecodeEngine(tp, cfg_t, TS.EngineConfig(**EKW),
                                    device="cpu")}


def _front(engines, pkg):
    """A front door over ``pkg``'s engine; its loop stamps the process's
    watchdog, so each test stops its own."""
    if pkg == "jax":
        return JS.FrontDoor(JS.Scheduler(engines["jax"])).start()
    return TS.FrontDoor(TS.Scheduler(engines["port"], device="cpu")).start()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_watchdog_stays_quiet_while_the_loop_ticks(engines, pkg):
    """A watchdog at a 1 s deadline over 2 s of an idle loop and four
    requests: never fires, and the loop's stamp is ``serve/tick``, as the
    reference's loop stamps it."""
    health = JH if pkg == "jax" else TH
    fired = []
    front = _front(engines, pkg)
    w = health.install_watchdog(1.0, check_interval_s=0.05,
                                exit_on_hang=False, on_hang=fired.append)
    try:
        for i in range(4):
            code, p = _post(front.port, {"prompt": [1, 2, 3 + i],
                                         "max_new_tokens": 4})
            assert code == 200, p
        time.sleep(2.0)
        assert not fired and not w.fired
        site, age = w.last_progress()
        assert site == "serve/tick" and age < 1.0
    finally:
        health.uninstall_watchdog()
        front.stop()


def test_watchdog_fires_when_the_loop_wedges():
    """The stamp is what keeps it quiet: a scheduler whose step wedges
    stops the stamps, and the watchdog fires naming ``serve/tick``."""
    release = threading.Event()

    class _Sched:
        engine = types.SimpleNamespace(poisoned=None)

        def pending(self):
            return 1

        def step(self):
            release.wait(10)
            return True

    fired = []
    TH.install_watchdog(0.3, check_interval_s=0.05, exit_on_hang=False,
                        on_hang=fired.append)
    loop = TS.EngineLoop(_Sched()).start()
    try:
        end = time.time() + 10
        while not fired and time.time() < end:
            time.sleep(0.05)
        assert fired and fired[0]["site"] == "serve/tick"
    finally:
        release.set()
        loop.stop()
        TH.uninstall_watchdog()


_SERVER = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
from paddle_tpu_torch import serving as TS
from paddle_tpu_torch.models import gpt as TGPT
cfg = TGPT.GPT_TINY.scaled(num_layers=1, max_seq_len=64)
eng = TS.DecodeEngine(TGPT.init_params(cfg, seed=1, device="cpu"), cfg,
                      TS.EngineConfig(max_batch=2, max_seq=64,
                                      prefill_buckets=(8, 16)), device="cpu")
sched = TS.Scheduler(eng, device="cpu")
step = sched.step
def slow_step():
    time.sleep(0.05)            # a decode tick of 50 ms: 40 tokens take 2 s
    return step()
sched.step = slow_step
front = TS.FrontDoor(sched).start()
front.install_signal_handlers(drain_timeout_s=30.0)
print(json.dumps({"port": front.port}), flush=True)
while front._thread.is_alive():
    time.sleep(0.05)
print(json.dumps({"drained": True}), flush=True)
"""


def test_sigterm_drains_the_front_door(tmp_path):
    """SIGTERM to a process serving through ``FrontDoor``: the request in
    flight finishes with all its tokens, a new request gets 503 while the
    drain runs, and the process exits 0."""
    script = tmp_path / "serve.py"
    script.write_text(_SERVER)
    proc = subprocess.Popen([sys.executable, str(script), REPO],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        port = json.loads(proc.stdout.readline())["port"]
        result = {}

        def long_request():
            result["r"] = _post(port, {"prompt": [5, 6, 7],
                                       "max_new_tokens": 40}, timeout=60)

        t = threading.Thread(target=long_request)
        t.start()
        end = time.time() + 30
        while _get(port, "/health")["active"] < 1 and time.time() < end:
            time.sleep(0.02)
        assert _get(port, "/health")["active"] == 1
        proc.send_signal(signal.SIGTERM)
        while _get(port, "/health")["status"] != "draining" and \
                time.time() < end:
            time.sleep(0.01)
        code, body = _post(port, {"prompt": [1], "max_new_tokens": 2})
        assert code == 503 and "draining" in body["error"]
        t.join(timeout=60)
        assert not t.is_alive()
        code, body = result["r"]
        assert code == 200 and len(body["tokens"]) == 40
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    assert json.loads(out.strip().splitlines()[-1]) == {"drained": True}


def test_restore_signal_handlers_puts_back_the_old_ones(engines):
    old = signal.getsignal(signal.SIGTERM)
    front = _front(engines, "port")
    try:
        front.install_signal_handlers(drain_timeout_s=1.0)
        assert signal.getsignal(signal.SIGTERM) is not old
        front.restore_signal_handlers()
        assert signal.getsignal(signal.SIGTERM) is old
        assert front._old_handlers == {}
    finally:
        front.stop()
