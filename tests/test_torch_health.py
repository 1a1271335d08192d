"""The port's in-run health layer (``paddle_tpu_torch/parallel/health.py``)
beside the JAX package's: twins of ``tests/test_health.py`` — the hang
watchdog (its deadline, its forensics bundle, progress and ``suspend``
postponing it, the module-level no-op, the env contract), heartbeats and
straggler detection (findings equal to JAX's on the same records, the
monitor's counts and rate limit), the divergence guard (verdict
sequences equal to JAX's guard on the same losses, the rollback budget,
the spike history), the supervisor's restart-cause labels through the
port's launcher, the metric families — and the port's own rules: the
first kernel use (``ops/_build.load``, which may run nvcc for a minute)
comes in a train step's first call, which runs under ``suspend()``, and a
watchdog deadline at or past the process group's timeout is refused."""
import json
import os
import time

import numpy as np
import pytest

from paddle_tpu.parallel import health as JH

from paddle_tpu_torch.parallel import health
from paddle_tpu_torch.parallel import launch as L


@pytest.fixture(autouse=True)
def _no_leaked_watchdog():
    yield
    health.uninstall_watchdog()


def _counts(name):
    from paddle_tpu_torch.observability import default_registry

    snap = default_registry().snapshot()
    return {tuple(s["labels"]): s["value"]
            for s in snap.get(name, {}).get("series", [])}


# ---------------------------------------------------------------------------
# Hang watchdog
# ---------------------------------------------------------------------------

def test_watchdog_fires_after_deadline(tmp_path):
    fired = {}
    w = health.HangWatchdog(0.25, check_interval_s=0.05,
                            dump_dir=str(tmp_path), exit_on_hang=False,
                            on_hang=fired.update)
    before = _counts("paddle_hangs_total")
    w.start()
    w.note("train_step")
    time.sleep(0.8)
    w.stop()
    assert w.fired
    assert fired["site"] == "train_step"
    assert fired["last_progress_age_s"] > 0.25
    assert fired["exit_code"] == health.HANG_EXIT_CODE == JH.HANG_EXIT_CODE
    d = w.dump_path
    assert d and os.path.isdir(d)
    stacks = open(os.path.join(d, "stacks.txt")).read()
    assert "MainThread" in stacks and "File " in stacks
    info = json.load(open(os.path.join(d, "hang_info.json")))
    assert info["site"] == "train_step" and info["deadline_s"] == 0.25
    assert os.path.exists(os.path.join(d, "flags.json"))
    assert "paddle_hangs_total" in json.load(
        open(os.path.join(d, "metrics.json")))
    after = _counts("paddle_hangs_total")
    assert after.get(("train_step",), 0) == \
        before.get(("train_step",), 0) + 1


def test_watchdog_progress_and_suspend_postpone():
    w = health.HangWatchdog(0.3, check_interval_s=0.05, exit_on_hang=False)
    w.start()
    for _ in range(10):
        w.note("step")
        time.sleep(0.06)
    assert not w.fired
    with w.suspend():
        time.sleep(0.6)
    assert not w.fired
    assert w.last_progress()[0] == "resume"
    w.stop()


def test_module_level_progress_is_noop_without_watchdog():
    health.uninstall_watchdog()
    health.progress("anywhere")
    with health.suspend():
        pass
    assert health.current_watchdog() is None


def test_maybe_install_from_env(tmp_path, monkeypatch):
    monkeypatch.delenv(health.ENV_DEADLINE, raising=False)
    assert health.maybe_install_from_env() is None
    assert (health.ENV_DEADLINE, health.ENV_DIR, health.ENV_INTERVAL) == \
        (JH.ENV_DEADLINE, JH.ENV_DIR, JH.ENV_INTERVAL)
    monkeypatch.setenv(health.ENV_DEADLINE, "120")
    monkeypatch.setenv(health.ENV_DIR, str(tmp_path))
    monkeypatch.setenv(health.ENV_INTERVAL, "0.5")
    w = health.maybe_install_from_env()
    assert w is not None and w.deadline_s == 120.0
    assert w.dump_dir == str(tmp_path) and w.check_interval_s == 0.5
    assert health.maybe_install_from_env() is w
    assert health.current_watchdog() is w


def test_kernel_build_runs_under_suspend(monkeypatch):
    """The first kernel use (``ops/_build.load``, an nvcc build of up to a
    minute) comes in a train step's first call, which pauses the
    watchdog: a build longer than the deadline does not fire it."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.parallel import parallelize as PZ

    w = health.install_watchdog(0.2, check_interval_s=0.05,
                                exit_on_hang=False)
    seen = {}

    def slow_build(force=False):
        seen["suspended"] = w._suspended
        time.sleep(0.6)
        return _build.BuildInfo(_build.BUILD_DIR / "x.so", 0.6, False, {})

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(_build, "_bind", lambda lib: "bound")
    step = PZ._watched(lambda *args: _build.load())
    assert step(None, None, None, None) == "bound"
    assert seen["suspended"] == 1 and not w.fired
    time.sleep(0.5)          # no stamps now: the clock runs again
    assert w.fired


def test_deadline_must_sit_below_the_process_group_timeout(monkeypatch):
    from paddle_tpu_torch.parallel import env

    monkeypatch.setenv(health.ENV_DEADLINE, "300")
    with pytest.raises(ValueError, match="shorter than the process group"):
        env.init_distributed_env(backend="gloo", device="cpu",
                                 timeout_s=300.0)


def test_train_step_stamps_progress_and_suspends_its_first_call():
    """Every call of a train step stamps ``train_step`` (the reference's
    site name); the first (the process's one-time host work, the port's
    first-call compile) runs with the clock paused."""
    import torch

    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.parallel import parallelize as PZ

    cfg = G.GPT_TINY.scaled(num_layers=1)
    params, opt = PZ.init_sharded(cfg, device="cpu")
    step = PZ.make_train_step(cfg, device="cpu")
    w = health.install_watchdog(60.0, exit_on_hang=False)
    toks = torch.randint(0, cfg.vocab_size, (1, 2, 8))
    step(params, opt, toks, toks)
    assert w.last_progress()[0] == "resume"       # the suspend's exit
    step(params, opt, toks, toks)
    assert w.last_progress()[0] == "train_step"
    seen = []

    def slow(*args):
        seen.append(w._suspended)
        time.sleep(0.5 if len(seen) == 1 else 0)

    w = health.install_watchdog(0.2, check_interval_s=0.05,
                                exit_on_hang=False)
    watched = PZ._watched(slow)
    watched(None, None, None, None)
    watched(None, None, None, None)
    assert seen == [1, 0] and not w.fired


# ---------------------------------------------------------------------------
# Straggler detection
# ---------------------------------------------------------------------------

def test_heartbeat_and_straggler_detection(tmp_path):
    for rank, ms in ((0, 10.0), (1, 11.0), (2, 12.0), (3, 55.0)):
        hb = health.RankHeartbeat(tmp_path, rank, min_write_interval_s=0)
        for step in range(1, 6):
            hb.beat(step, step_time_ms=ms)
    recs = health.read_heartbeats(tmp_path)
    assert sorted(recs) == [0, 1, 2, 3] and recs[3]["step"] == 5
    findings = health.detect_stragglers(tmp_path, ratio=2.0)
    assert [f["rank"] for f in findings] == [3]
    assert findings[0]["ratio"] > 2.0
    # the JAX reader and detector see the same files alike
    assert JH.detect_stragglers(str(tmp_path), ratio=2.0) == findings
    assert health.detect_stragglers(tmp_path, ratio=10.0) == []
    solo = tmp_path / "solo"
    health.RankHeartbeat(solo, 0, min_write_interval_s=0).beat(
        1, step_time_ms=100.0)
    assert health.detect_stragglers(solo) == []
    assert health.read_heartbeats(tmp_path, max_age_s=-1.0) == {}


def test_straggler_monitor_counts_and_rate_limits(tmp_path):
    for rank, ms in ((0, 10.0), (1, 80.0)):
        hb = health.RankHeartbeat(tmp_path, rank, min_write_interval_s=0)
        hb.beat(1, step_time_ms=ms)
    warnings = []
    mon = health.StragglerMonitor(tmp_path, ratio=2.0, warn_cooldown_s=60.0,
                                  log=warnings.append)
    before = _counts("paddle_straggler_detected_total")
    for _ in range(4):
        assert [f["rank"] for f in mon.poll()] == [1]
    after = _counts("paddle_straggler_detected_total")
    assert after.get(("1",), 0) == before.get(("1",), 0) + 4
    assert len(warnings) == 1 and "rank 1" in warnings[0]
    assert mon.detections == 4
    ewma = _counts("paddle_rank_step_time_ewma_ms")
    assert ewma.get(("1",)) == pytest.approx(80.0)


def test_heartbeat_ewma_matches_jax(tmp_path):
    times = [12.0, 30.0, 9.5, 14.25, 40.0, 11.0]
    for mod, sub in ((health, "port"), (JH, "jax")):
        hb = mod.RankHeartbeat(tmp_path / sub, 0, alpha=0.3,
                               min_write_interval_s=0)
        for i, ms in enumerate(times):
            hb.beat(i + 1, step_time_ms=ms)
    port = health.read_heartbeats(tmp_path / "port")[0]
    ref = JH.read_heartbeats(str(tmp_path / "jax"))[0]
    assert port["ewma_ms"] == ref["ewma_ms"] and port["step"] == ref["step"]


# ---------------------------------------------------------------------------
# Divergence guard
# ---------------------------------------------------------------------------

def test_guard_nonfinite_and_spike_verdicts():
    g = health.DivergenceGuard(health.GuardrailConfig(
        spike_mult=3.0, min_history=3, max_consecutive_bad=2))
    assert [g.judge(v) for v in (1.0, 1.1, 0.9)] == ["ok"] * 3
    assert g.judge(float("nan")) == "skip"
    assert g.last_reason == "nonfinite"
    assert g.judge(50.0) == "rollback"
    assert g.last_reason == "spike"
    g.rolled_back()
    assert g.consecutive_bad == 0 and g.rollbacks == 1
    assert g.judge(1.0) == "ok"
    assert g.skipped_steps == 2


def test_guard_rollback_budget_exhausted():
    before = _counts("paddle_guardrail_rollbacks_total")
    g = health.DivergenceGuard(health.GuardrailConfig(max_rollbacks=1))
    g.rolled_back()
    with pytest.raises(health.DivergenceError):
        g.rolled_back()
    after = _counts("paddle_guardrail_rollbacks_total")
    assert after.get((), 0) == before.get((), 0) + 2


def test_guard_spike_needs_history():
    g = health.DivergenceGuard(health.GuardrailConfig(
        spike_mult=2.0, min_history=5))
    assert g.judge(1.0) == "ok"
    assert g.judge(100.0) == "ok"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_guard_verdicts_match_jax(seed):
    """The same loss stream (spikes, NaNs, recoveries; floats, numpy
    scalars and tensors) through both guards: the same verdicts, reasons,
    counters and skip-reason counts, rolling back alike."""
    import torch

    rng = np.random.default_rng(seed)
    losses = []
    for i in range(60):
        r = rng.random()
        losses.append(float("nan") if r < 0.08 else
                      float(rng.uniform(8, 30)) if r < 0.2 else
                      float(rng.uniform(0.9, 1.2)))
    kw = dict(spike_mult=2.5, window=8, min_history=4,
              max_consecutive_bad=2, max_rollbacks=100)
    gp = health.DivergenceGuard(health.GuardrailConfig(**kw))
    gj = JH.DivergenceGuard(JH.GuardrailConfig(**kw))
    before = _counts("paddle_guardrail_skipped_steps_total")
    for i, loss in enumerate(losses):
        arg = torch.tensor(loss) if i % 3 == 0 else np.float32(loss) \
            if i % 3 == 1 else loss
        v = gp.judge(arg)
        assert v == gj.judge(np.float32(loss) if i % 3 == 1 else loss)
        assert gp.last_reason == gj.last_reason
        if v == "rollback":
            gp.rolled_back()
            gj.rolled_back()
    assert (gp.skipped_steps, gp.rollbacks, gp.consecutive_bad) == \
        (gj.skipped_steps, gj.rollbacks, gj.consecutive_bad)
    after = _counts("paddle_guardrail_skipped_steps_total")
    assert sum(after.values()) - sum(before.values()) == gp.skipped_steps


# ---------------------------------------------------------------------------
# Supervisor restart-cause accounting
# ---------------------------------------------------------------------------

def _once_script(tmp_path, name, first_body):
    marker = tmp_path / f"{name}.marker"
    path = tmp_path / f"{name}.py"
    path.write_text(f"""
import os, signal, sys
m = {str(marker)!r}
if not os.path.exists(m):
    open(m, "w").write("x")
{first_body}
sys.exit(0)
""")
    return str(path)


@pytest.mark.parametrize("name,body,cause", [
    ("plain_exit", "    sys.exit(3)", "crash"),
    ("sigkill", "    os.kill(os.getpid(), signal.SIGKILL)", "crash"),
    ("hang_code", f"    sys.exit({health.HANG_EXIT_CODE})", "hang"),
    ("sigterm", "    signal.signal(signal.SIGTERM, signal.SIG_DFL)\n"
                "    os.kill(os.getpid(), signal.SIGTERM)\n"
                "    import time; time.sleep(30)", "preempt"),
])
def test_restart_cause_labels(tmp_path, name, body, cause):
    """A worker exiting with the watchdog's code restarts as ``hang``, an
    untrapped SIGTERM death as ``preempt``, the rest as ``crash`` — the
    labels the JAX launcher gives the same returncodes."""
    script = _once_script(tmp_path, name, body)
    before = _counts("paddle_restarts_total")
    rc = L.launch(script, max_restarts=1, restart_backoff_s=0.1,
                  grace_period_s=2.0)
    after = _counts("paddle_restarts_total")
    assert rc == 0, f"{name}: the second incarnation should succeed"
    deltas = {k[0]: after.get(k, 0) - before.get(k, 0)
              for k in set(after) | set(before)}
    assert deltas.get(cause, 0) == 1, (name, deltas)
    assert sum(deltas.values()) == 1, (name, deltas)
    import importlib

    JL = importlib.import_module("paddle_tpu.parallel.launch")
    assert L.restart_history()[-1]["cause"] == cause == JL._restart_cause(
        L.restart_history()[-1]["returncode"])


def test_health_and_launch_metric_families_registered():
    from paddle_tpu_torch.observability import default_registry
    from paddle_tpu_torch.parallel import checkpoint  # noqa: F401

    reg = default_registry()
    for fam in ("paddle_hangs_total", "paddle_straggler_detected_total",
                "paddle_guardrail_skipped_steps_total",
                "paddle_guardrail_rollbacks_total",
                "paddle_rank_step_time_ewma_ms", "paddle_restarts_total",
                "paddle_input_stall_reports_total",
                "paddle_checkpoint_save_ms",
                "paddle_checkpoint_bytes_total"):
        assert reg.get(fam) is not None, fam


def test_input_stall_reports_surface_once(tmp_path):
    rep = {"rank": 3, "waited_s": 12.5, "shard": "shard-7"}
    (tmp_path / "input_stall.rank3.json").write_text(json.dumps(rep))
    before = _counts("paddle_input_stall_reports_total")
    seen = {}
    assert L._poll_input_stall_reports(str(tmp_path), seen) == [rep]
    assert L._poll_input_stall_reports(str(tmp_path), seen) == []
    after = _counts("paddle_input_stall_reports_total")
    assert after.get(("3",), 0) == before.get(("3",), 0) + 1
