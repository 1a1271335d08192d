"""The port's subprocess serving gang (``paddle_tpu_torch/serving/gang.py``,
``replica.py``) over STUB replicas — stdlib-only workers that start in a
fraction of a second — beside the JAX package's: the exit-cause mapping,
failover with the trace id kept, dedup of a retried id, recycling on a
crash, on a poisoned ``/health`` and on a stale heartbeat, a decode
replica killed with a migrated request in its hands, and the stub's
import closure (no ``torch``). Mirrors ``tests/test_serving_resilience.py``
(the gang tests) and ``tests/test_disagg.py`` (the mid-transfer kill).
"""
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from paddle_tpu.parallel import health as JH
from paddle_tpu.serving import gang as JG
from paddle_tpu.serving import replica as JR
from paddle_tpu_torch.parallel import health as TH
from paddle_tpu_torch.serving import gang as TG
from paddle_tpu_torch.serving import metrics as TM
from paddle_tpu_torch.serving import replica as TR
from paddle_tpu_torch.tools import trace_assemble

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _post(port, body, timeout=30.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _stub_gang(tmp_path, name, n=2, per_replica=None, **cfg_over):
    kw = dict(n_replicas=n, probe_interval_s=0.1, hang_deadline_s=2.0,
              ready_timeout_s=60.0, restart_backoff_s=0.1,
              default_timeout_s=30.0)
    kw.update(cfg_over)
    return TG.ReplicaGang({"stub": {}}, str(tmp_path / name),
                          TG.GangConfig(**kw), per_replica=per_replica)


def _wait(cond, timeout_s=30.0):
    end = time.time() + timeout_s
    while time.time() < end:
        if cond():
            return True
        time.sleep(0.05)
    return cond()


def test_exit_codes_and_causes_match_jax():
    assert (TR.POISONED_EXIT_CODE, TR.READY_NAME, TR.HEARTBEAT_NAME) == \
        (JR.POISONED_EXIT_CODE, JR.READY_NAME, JR.HEARTBEAT_NAME) == \
        (44, "ready.json", "heartbeat.json")
    assert TR.ReplicaRole.ALL == JR.ReplicaRole.ALL
    assert TH.HANG_EXIT_CODE == JH.HANG_EXIT_CODE == 43
    codes = (43, 44, 0, 1, 2, -signal.SIGKILL, -signal.SIGTERM, None)
    assert [TG._exit_cause(c) for c in codes] == \
        [JG._exit_cause(c) for c in codes] == \
        ["hang", "poisoned"] + ["crash"] * 6
    assert TG.GangConfig() == TG.GangConfig(**dataclass_fields(
        JG.GangConfig()))


def dataclass_fields(obj):
    import dataclasses

    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def test_stub_replica_imports_no_torch(tmp_path):
    """The stub's whole import closure is the standard library: it starts
    without ``torch`` (or ``numpy``, or the package)."""
    cfg = {"stub": {}, "run_dir": str(tmp_path / "r")}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    proc = subprocess.Popen(
        [sys.executable, "-X", "importtime",
         os.path.join(REPO, "paddle_tpu_torch", "serving", "replica.py"),
         "--config", str(path)],
        stderr=subprocess.PIPE, text=True, env=dict(os.environ,
                                                    PYTHONPATH=""))
    try:
        assert _wait(lambda: (tmp_path / "r" / "ready.json").exists(), 30)
        ready = json.loads((tmp_path / "r" / "ready.json").read_text())
        assert ready["pid"] == proc.pid and ready["stub"] is True
    finally:
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=30)
    assert proc.returncode == 0
    mods = {ln.split("|")[-1].strip() for ln in err.splitlines()
            if ln.startswith("import time:")}
    assert "json" in mods and "http.server" in mods
    assert not {m for m in mods if m.split(".")[0] in (
        "torch", "numpy", "paddle_tpu_torch", "paddle_tpu", "jax")}


def test_port_sources_import_neither_jax_nor_the_jax_package():
    """No module of the port names ``jax`` or ``paddle_tpu`` in an import
    (the gang's modules among them), and the gang's modules import in a
    process that then holds neither."""
    rx = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|paddle_tpu)\b(?!_)",
                    re.M)
    bad = []
    for root, _dirs, files in os.walk(os.path.join(REPO,
                                                   "paddle_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                p = os.path.join(root, name)
                with open(p) as f:
                    if rx.search(f.read()):
                        bad.append(os.path.relpath(p, REPO))
    assert bad == []
    code = ("import sys\n"
            "import paddle_tpu_torch.serving.gang, "
            "paddle_tpu_torch.serving.replica, "
            "paddle_tpu_torch.serving.prefix_store, "
            "paddle_tpu_torch.tools.serve_fault_bench\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu'))\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_gang_failover_dedup_and_crash_recycle(tmp_path):
    """SIGKILL a stub replica mid-request: the request fails over to the
    sibling (one answer, the stub's tokens — the JAX stub's too), the
    retried id is deduplicated under the original trace id, the trace
    stitches across the gang's and the stub's files with no orphan, and
    the dead replica is recycled with cause crash."""
    gang = _stub_gang(tmp_path, "failover")
    front = None
    crash0 = TM.m_replica_restarts.labels("crash").value
    fail0 = TM.m_failover.value
    try:
        gang.start()
        front = TG.GangFrontDoor(gang).start()
        code, p1 = _post(front.port, {"prompt": [1, 2, 3],
                                      "max_new_tokens": 4,
                                      "request_id": "t1"})
        assert code == 200 and p1["tokens"] == JR._stub_tokens([1, 2, 3], 4)
        results = {}

        def bg():
            results["slow"] = _post(front.port, {
                "prompt": [9, 9], "max_new_tokens": 3,
                "request_id": "slow", "stub_delay_s": 5.0,
                "timeout_s": 30.0}, timeout=60.0)

        t = threading.Thread(target=bg)
        t.start()
        assert _wait(lambda: max(r.inflight for r in gang.replicas) >= 1,
                     20)
        busy = max(gang.replicas, key=lambda r: r.inflight)
        busy.kill(signal.SIGKILL)
        t.join(timeout=60)
        assert not t.is_alive()
        code, p = results["slow"]
        assert code == 200, p
        assert p["tokens"] == JR._stub_tokens([9, 9], 3)
        assert p["failovers"] == 1 and gang.failovers >= 1
        assert p.get("trace_id") is not None
        code, p2 = _post(front.port, {"prompt": [9, 9], "max_new_tokens": 3,
                                      "request_id": "slow"})
        assert code == 200 and p2.get("deduplicated") is True
        assert p2["tokens"] == p["tokens"]
        assert p2["trace_id"] == p["trace_id"]
        report = trace_assemble.assemble_dir(gang.trace_dir)
        assert report["n_orphans"] == 0, report["orphans"]
        assert report["n_duplicates"] == 0, report["duplicates"]
        slow = [t for t in report["traces"]
                if t["trace"] == f"{p['trace_id']:x}"]
        assert slow and len(slow[0]["files"]) >= 2, slow
        assert "gang" in slow[0]["roles"], slow[0]
        assert _wait(lambda: gang.health()["restarts"].get("crash", 0) >= 1
                     and gang.health()["ready"] == 2)
        assert busy.incarnation == 2 and busy.last_cause == "crash"
        assert TM.m_replica_restarts.labels("crash").value - crash0 == 1
        assert TM.m_failover.value - fail0 == gang.failovers
        # the supervisor's registry and the fleet view behind the door
        with urllib.request.urlopen(
                f"http://127.0.0.1:{front.port}/metrics", timeout=10) as r:
            text = r.read().decode()
        assert 'paddle_serve_replica_restarts_total{cause="crash"}' in text
        with urllib.request.urlopen(
                f"http://127.0.0.1:{front.port}/fleet", timeout=10) as r:
            fleet = json.loads(r.read().decode())
        assert fleet["n_replicas"] == 2 and fleet["n_alive"] == 2
    finally:
        if front is not None:
            front.stop()
        gang.stop()
    # every incarnation is gone after stop()
    assert all(r.proc.poll() is not None for r in gang.replicas)


def test_gang_recycles_poisoned_replica_from_health_probe(tmp_path):
    """A replica whose /health says ``poisoned`` is recycled with cause
    poisoned while the sibling serves."""
    gang = _stub_gang(tmp_path, "poison",
                      per_replica={0: {"stub": {"poison_after": 1}}})
    try:
        gang.start()
        code, _p = gang.replicas[0].post_generate(
            {"prompt": [1], "max_new_tokens": 2}, timeout_s=10.0)
        assert code == 200
        assert _wait(lambda: gang.health()["restarts"].get("poisoned", 0)
                     >= 1 and gang.health()["ready"] == 2), gang.health()
        code, payload = gang.dispatch({"prompt": [4, 5],
                                       "max_new_tokens": 2})
        assert code == 200, payload
    finally:
        gang.stop()


def test_gang_recycles_hung_replica_from_stale_heartbeat(tmp_path):
    """A wedged replica (handler and heartbeat frozen, process alive) is
    found by the supervisor's liveness probe and recycled with cause
    hang."""
    gang = _stub_gang(tmp_path, "hang", hang_deadline_s=1.5,
                      per_replica={0: {"stub": {"hang_after": 0}}})
    try:
        gang.start()
        r0 = gang.replicas[0]

        def poke():
            try:
                r0.post_generate({"prompt": [1], "max_new_tokens": 1},
                                 timeout_s=30.0)
            except OSError:
                pass

        threading.Thread(target=poke, daemon=True).start()
        assert _wait(lambda: gang.health()["restarts"].get("hang", 0) >= 1
                     and gang.health()["ready"] == 2), gang.health()
    finally:
        gang.stop()


def test_gang_mid_transfer_kill_zero_loss_zero_duplication(tmp_path):
    """The decode replica dies with the migrated request in its hands
    (/resume): one transfer_fault fallback, the request re-run colocated
    (the stub's exact tokens), the id idempotent, the dead replica
    recycled with cause crash."""
    gang = _stub_gang(tmp_path, "midkill", roles=("prefill", "decode"),
                      per_replica={1: {"stub": {"die_on_resume": True}}})
    try:
        gang.start()
        assert gang.disaggregated
        prompt = [9, 9, 4]
        code, payload = gang.dispatch({"prompt": prompt,
                                       "max_new_tokens": 3,
                                       "request_id": "midkill-1"})
        assert code == 200, payload
        assert payload["tokens"] == JR._stub_tokens(prompt, 3)
        assert payload.get("disagg") is not True
        assert gang.disagg_fallbacks == 1 and gang.disagg_requests == 0
        code2, replay = gang.dispatch({"prompt": prompt,
                                       "max_new_tokens": 3,
                                       "request_id": "midkill-1"})
        assert code2 == 200 and replay.get("deduplicated") is True
        assert replay["tokens"] == payload["tokens"]
        assert _wait(lambda: gang.health()["restarts"].get("crash", 0)
                     >= 1), gang.health()
    finally:
        gang.stop()


def test_phased_stub_gang_migrates(tmp_path):
    """Both phase fleets up: the request runs phased (prefill replica ->
    inline handoff -> decode replica) with the stub's tokens."""
    gang = _stub_gang(tmp_path, "phased", roles=("prefill", "decode"))
    try:
        gang.start()
        code, payload = gang.dispatch({"prompt": [3, 1, 4, 1, 5],
                                       "max_new_tokens": 5})
        assert code == 200 and payload["disagg"] is True
        assert payload["tokens"] == JR._stub_tokens([3, 1, 4, 1, 5], 5)
        assert gang.disagg_requests == 1 and gang.disagg_fallbacks == 0
        with pytest.raises(ValueError, match="roles"):
            _stub_gang(tmp_path, "bad", roles=("prefill",))
    finally:
        gang.stop()


def test_per_replica_env_reaches_the_replica(tmp_path):
    """``per_replica`` ``env`` is set in the replica's environment before
    it imports anything: how a host with several cards pins each replica
    with ``CUDA_VISIBLE_DEVICES``."""
    gang = _stub_gang(tmp_path, "env", per_replica={
        i: {"env": {"CUDA_VISIBLE_DEVICES": str(i)}} for i in range(2)})
    try:
        gang.start()
        assert [r.ready_record["env"] for r in gang.replicas] == \
            [{"CUDA_VISIBLE_DEVICES": "0"}, {"CUDA_VISIBLE_DEVICES": "1"}]
    finally:
        gang.stop()


def test_duplicate_in_flight_waits_for_the_original(tmp_path):
    """A second request under an id still in flight does not generate
    again: it waits for the original and returns its answer, marked
    deduplicated; the stub served one request."""
    gang = _stub_gang(tmp_path, "dedup")
    try:
        gang.start()
        out = {}

        def send(key):
            out[key] = gang.dispatch({"prompt": [4, 2], "max_new_tokens": 3,
                                      "request_id": "dup",
                                      "stub_delay_s": 1.0})

        first = threading.Thread(target=send, args=("first",))
        first.start()
        assert _wait(lambda: "dup" in gang._inflight, 10)
        send("second")
        first.join(timeout=30)
        assert not first.is_alive()
        (c1, p1), (c2, p2) = out["first"], out["second"]
        assert c1 == c2 == 200 and p2["deduplicated"] is True
        assert p2["tokens"] == p1["tokens"] == JR._stub_tokens([4, 2], 3)
        served = sum(r.get_json("/health", 5)["served"]
                     for r in gang.replicas)
        assert served == 1
    finally:
        gang.stop()
