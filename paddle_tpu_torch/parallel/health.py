"""In-run health: the hang watchdog, straggler detection and the
divergence guardrails — the port of ``paddle_tpu/parallel/health.py``.

- **Hang watchdog** (:class:`HangWatchdog`): a monitor thread fed by
  progress stamps at dispatch boundaries (the train step). No stamp for
  its deadline -> every thread's stack and a forensics bundle are dumped,
  ``paddle_hangs_total{site}`` counts it, and the process ``os._exit``\\ s
  with :data:`HANG_EXIT_CODE`, which ``parallel/launch.py`` restarts as
  ``cause=hang`` from the last committed checkpoint. Known-long host
  phases run under :func:`suspend`: in the port that is a train step's
  first call (``parallelize._watched``), which carries the first use of
  the CUDA kernels, whose ``nvcc`` build (``ops/_build.py``) can take a
  minute. A rank blocked in a gloo or NCCL collective stamps nothing, so
  the deadline must sit below the process group's timeout
  (``env.init_distributed_env`` refuses it otherwise) or the hang ends as
  a crash.
- **Straggler detection**: each rank's :class:`RankHeartbeat` writes its
  step-time EWMA to a shared directory; the supervisor's
  :class:`StragglerMonitor` flags ranks beyond ``ratio`` x the gang
  median (``paddle_straggler_detected_total{rank}`` and a rate-limited
  warning naming the rank).
- **Divergence guardrails** (:class:`DivergenceGuard`): skip a bounded
  number of NaN/Inf or loss-spike steps, then ask for a rollback to the
  latest valid checkpoint with an LR cooldown. The verdict depends only
  on the loss, which is the same on every rank after its all-reduce, so
  every rank takes the same branch. The train step's own skip is
  :func:`nonfinite_guard`.

The reference's flight-recorder dump and the goodput charge of
``suspend`` wait for the observability port (ROADMAP A4).
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..observability import metrics as _obs_metrics

__all__ = [
    "HANG_EXIT_CODE", "HangWatchdog", "progress", "suspend",
    "install_watchdog", "uninstall_watchdog", "current_watchdog",
    "maybe_install_from_env",
    "RankHeartbeat", "read_heartbeats", "detect_stragglers",
    "StragglerMonitor",
    "GuardrailConfig", "DivergenceGuard", "DivergenceError",
    "nonfinite_guard",
]

#: The exit code of a worker whose own watchdog declared it hung;
#: ``parallel.launch`` restarts it as ``cause=hang`` (another nonzero exit
#: is ``crash``, an untrapped SIGTERM death ``preempt``).
HANG_EXIT_CODE = 43

# the env contract (exported by launch(hang_deadline_s=, health_dir=))
ENV_DEADLINE = "PADDLE_HEALTH_DEADLINE_S"
ENV_DIR = "PADDLE_HEALTH_DIR"
ENV_INTERVAL = "PADDLE_HEALTH_CHECK_INTERVAL_S"

_REG = _obs_metrics.default_registry()
_m_hangs = _REG.counter(
    "paddle_hangs_total",
    "Hang-watchdog firings by last-progress site", ("site",))
_m_straggler = _REG.counter(
    "paddle_straggler_detected_total",
    "Straggler detections by rank (EWMA step time beyond ratio x median)",
    ("rank",))
_g_ewma = _REG.gauge(
    "paddle_rank_step_time_ewma_ms",
    "Per-rank heartbeat step-time EWMA (ms)", ("rank",))
_m_skipped = _REG.counter(
    "paddle_guardrail_skipped_steps_total",
    "Training steps skipped by the divergence guardrail", ("reason",))
_m_rollbacks = _REG.counter(
    "paddle_guardrail_rollbacks_total",
    "Automatic rollbacks to the latest valid checkpoint")


# ---------------------------------------------------------------------------
# Hang watchdog
# ---------------------------------------------------------------------------

def _dump_all_stacks() -> str:
    """Every live thread's Python stack as text."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sorted(sys._current_frames().items()):
        out.append(f"--- thread {tid} ({names.get(tid, '?')}) ---")
        out.extend(ln.rstrip() for ln in traceback.format_stack(frame))
        out.append("")
    return "\n".join(out)


class HangWatchdog:
    """A monitor thread that declares the process hung when no progress
    stamp lands for ``deadline_s`` seconds.

    :meth:`note` is one tuple store, for dispatch boundaries;
    :meth:`suspend` brackets known-long host phases. On firing it writes a
    forensics bundle under ``dump_dir`` (stacks, last progress, the
    framework flags, a metrics snapshot), counts
    ``paddle_hangs_total{site}``, calls ``on_hang`` and, with
    ``exit_on_hang``, ``os._exit``\\ s with :data:`HANG_EXIT_CODE`."""

    def __init__(self, deadline_s: float,
                 check_interval_s: Optional[float] = None,
                 dump_dir: Optional[str] = None, exit_on_hang: bool = True,
                 on_hang: Optional[Callable[[dict], None]] = None):
        self.deadline_s = float(deadline_s)
        if self.deadline_s <= 0:
            raise ValueError("hang deadline must be > 0 seconds")
        self.check_interval_s = float(
            check_interval_s if check_interval_s is not None
            else max(0.05, min(1.0, self.deadline_s / 4)))
        self.dump_dir = dump_dir
        self.exit_on_hang = exit_on_hang
        self.on_hang = on_hang
        self.fired = False
        self.dump_path: Optional[str] = None
        self._stamp: Tuple[str, int] = ("start", time.monotonic_ns())
        self._suspended = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def note(self, site: str) -> None:
        """Progress stamp: one tuple store (atomic under the GIL)."""
        self._stamp = (site, time.monotonic_ns())

    @contextlib.contextmanager
    def suspend(self):
        """Pause the deadline clock for a known-long host phase; re-stamps
        on exit so the suspended span never counts."""
        self._suspended += 1
        try:
            yield
        finally:
            self._suspended -= 1
            self.note("resume")

    def last_progress(self) -> Tuple[str, float]:
        """(site, age in seconds) of the latest stamp."""
        site, ts = self._stamp
        return site, (time.monotonic_ns() - ts) / 1e9

    def start(self) -> "HangWatchdog":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self.note("start")
            self._thread = threading.Thread(
                target=self._run, name="hang-watchdog", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2 * self.check_interval_s + 1)

    def _run(self) -> None:
        while not self._stop.wait(self.check_interval_s):
            if self._suspended > 0:
                self.note(self._stamp[0])
                continue
            site, age = self.last_progress()
            if age > self.deadline_s:
                self._fire(site, age)
                return

    def _fire(self, site: str, age: float) -> None:
        self.fired = True
        info = {
            "reason": "hang",
            "site": site,
            "last_progress_age_s": round(age, 3),
            "deadline_s": self.deadline_s,
            "pid": os.getpid(),
            "rank": os.environ.get("PADDLE_TRAINER_ID"),
            "ts": time.time(),
            "exit_code": HANG_EXIT_CODE,
        }
        stacks = _dump_all_stacks()
        sys.stderr.write(
            f"[hang-watchdog] no progress for {age:.1f}s "
            f"(deadline {self.deadline_s}s, last site {site!r}) — "
            f"dumping stacks and exiting {HANG_EXIT_CODE}\n")
        try:
            self.dump_path = self._write_bundle(info, stacks)
            info["dump"] = self.dump_path
        except Exception as e:  # forensics must never mask the exit
            sys.stderr.write(f"[hang-watchdog] bundle write failed: {e}\n")
            sys.stderr.write(stacks + "\n")
        _m_hangs.labels(site).inc()
        if self.on_hang is not None:
            try:
                self.on_hang(info)
            except Exception:
                pass
        if self.exit_on_hang:
            sys.stderr.flush()
            os._exit(HANG_EXIT_CODE)

    def _write_bundle(self, info: dict, stacks: str) -> Optional[str]:
        """``<dump_dir>/hang_rank<R>_pid<P>/``: ``hang_info.json``,
        ``stacks.txt``, ``flags.json`` (the framework flags) and
        ``metrics.json`` (a registry snapshot)."""
        if not self.dump_dir:
            sys.stderr.write(stacks + "\n")
            return None
        rank = info.get("rank") or "0"
        d = os.path.join(str(self.dump_dir),
                         f"hang_rank{rank}_pid{info['pid']}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "hang_info.json"), "w") as f:
            json.dump(info, f, indent=1)
        with open(os.path.join(d, "stacks.txt"), "w") as f:
            f.write(stacks)
        try:
            from ..framework.core import _GLOBAL_FLAGS

            with open(os.path.join(d, "flags.json"), "w") as f:
                json.dump({k: v if isinstance(
                    v, (str, int, float, bool, type(None))) else repr(v)
                    for k, v in _GLOBAL_FLAGS.items()}, f, indent=1)
        except Exception:
            pass
        try:
            with open(os.path.join(d, "metrics.json"), "w") as f:
                json.dump(_REG.snapshot(), f, indent=1, default=str)
        except Exception:
            pass
        return d


_watchdog: Optional[HangWatchdog] = None


def progress(site: str) -> None:
    """Module-level progress stamp: one global read until a watchdog is
    installed, so hot paths call it unconditionally."""
    w = _watchdog
    if w is not None:
        w.note(site)


@contextlib.contextmanager
def suspend():
    """Module-level :meth:`HangWatchdog.suspend` (a no-op without a
    watchdog)."""
    w = _watchdog
    if w is None:
        yield
        return
    with w.suspend():
        yield


def install_watchdog(deadline_s: float, **kw) -> HangWatchdog:
    """Install and start the process-wide watchdog (replacing any)."""
    global _watchdog
    if _watchdog is not None:
        _watchdog.stop()
    w = HangWatchdog(deadline_s, **kw)
    _watchdog = w
    w.start()
    return w


def uninstall_watchdog() -> None:
    global _watchdog
    if _watchdog is not None:
        _watchdog.stop()
        _watchdog = None


def current_watchdog() -> Optional[HangWatchdog]:
    return _watchdog


def maybe_install_from_env() -> Optional[HangWatchdog]:
    """Install the watchdog from the launcher's env contract
    (``PADDLE_HEALTH_DEADLINE_S`` + ``PADDLE_HEALTH_DIR``); idempotent,
    a no-op when the env is unset."""
    deadline = os.environ.get(ENV_DEADLINE)
    if not deadline:
        return _watchdog
    if _watchdog is not None:
        return _watchdog
    interval = os.environ.get(ENV_INTERVAL)
    return install_watchdog(
        float(deadline),
        check_interval_s=float(interval) if interval else None,
        dump_dir=os.environ.get(ENV_DIR))


# ---------------------------------------------------------------------------
# Straggler detection: per-rank heartbeats on a shared run dir
# ---------------------------------------------------------------------------

_HB_PREFIX = "heartbeat.rank"


class RankHeartbeat:
    """Worker-side heartbeat: a per-step EWMA of the step time written
    atomically to ``<dir>/heartbeat.rank<N>.json``, at most once every
    ``min_write_interval_s``."""

    def __init__(self, dirname: str, rank: int, alpha: float = 0.2,
                 min_write_interval_s: float = 0.5):
        self.dirname = str(dirname)
        os.makedirs(self.dirname, exist_ok=True)
        self.rank = int(rank)
        self.alpha = float(alpha)
        self.min_write_interval_s = float(min_write_interval_s)
        self.ewma_ms: Optional[float] = None
        self.step = 0
        self._last_beat_ns: Optional[int] = None
        self._last_write = 0.0
        self.path = os.path.join(self.dirname,
                                 f"{_HB_PREFIX}{self.rank}.json")

    def beat(self, step: Optional[int] = None,
             step_time_ms: Optional[float] = None) -> None:
        """Record one step; ``step_time_ms`` defaults to the wall time
        since the previous beat."""
        now = time.monotonic_ns()
        if step_time_ms is None:
            if self._last_beat_ns is None:
                self._last_beat_ns = now
                self.step = int(step) if step is not None else self.step + 1
                return
            step_time_ms = (now - self._last_beat_ns) / 1e6
        self._last_beat_ns = now
        self.step = int(step) if step is not None else self.step + 1
        if self.ewma_ms is None:
            self.ewma_ms = float(step_time_ms)
        else:
            self.ewma_ms += self.alpha * (float(step_time_ms) - self.ewma_ms)
        wall = time.time()
        if wall - self._last_write >= self.min_write_interval_s:
            self._write(wall)

    def flush(self) -> None:
        if self.ewma_ms is not None:
            self._write(time.time())

    def _write(self, wall: float) -> None:
        rec = {"rank": self.rank, "step": self.step,
               "ewma_ms": round(self.ewma_ms, 4), "ts": wall,
               "pid": os.getpid()}
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(rec, f)
            os.replace(tmp, self.path)
            self._last_write = wall
        except OSError:  # advisory, never fatal
            pass


def read_heartbeats(dirname: str, max_age_s: Optional[float] = None
                    ) -> Dict[int, dict]:
    """Every rank's heartbeat record under ``dirname`` (those older than
    ``max_age_s`` dropped)."""
    out: Dict[int, dict] = {}
    try:
        names = os.listdir(str(dirname))
    except OSError:
        return out
    now = time.time()
    for name in names:
        if not (name.startswith(_HB_PREFIX) and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(str(dirname), name)) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue  # a torn read of an in-flight replace
        if max_age_s is not None and now - rec.get("ts", 0) > max_age_s:
            continue
        out[int(rec["rank"])] = rec
    return out


def detect_stragglers(heartbeats, ratio: float = 2.0,
                      min_ranks: int = 2) -> List[dict]:
    """Ranks whose step-time EWMA exceeds ``ratio`` x the gang's lower
    median (a dir or a :func:`read_heartbeats` dict; at least
    ``min_ranks`` reporting): one ``{rank, ewma_ms, median_ms, ratio}``
    each."""
    if not isinstance(heartbeats, dict):
        heartbeats = read_heartbeats(heartbeats)
    ewmas = {r: rec["ewma_ms"] for r, rec in heartbeats.items()
             if rec.get("ewma_ms") is not None}
    if len(ewmas) < max(2, int(min_ranks)):
        return []
    vals = sorted(ewmas.values())
    # the lower median: in an even gang the upper middle may itself be
    # the straggler
    median = vals[(len(vals) - 1) // 2]
    if median <= 0:
        return []
    out = []
    for rank, ewma in sorted(ewmas.items()):
        if ewma > ratio * median:
            out.append({"rank": rank, "ewma_ms": round(ewma, 3),
                        "median_ms": round(median, 3),
                        "ratio": round(ewma / median, 3)})
    return out


class StragglerMonitor:
    """Supervisor-side poller: counts ``paddle_straggler_detected_total
    {rank}``, mirrors each rank's EWMA into
    ``paddle_rank_step_time_ewma_ms{rank}``, and warns at most once every
    ``warn_cooldown_s`` a rank."""

    def __init__(self, dirname: str, ratio: float = 2.0,
                 min_ranks: int = 2, warn_cooldown_s: float = 30.0,
                 log: Optional[Callable[[str], None]] = None):
        self.dirname = str(dirname)
        self.ratio = float(ratio)
        self.min_ranks = int(min_ranks)
        self.warn_cooldown_s = float(warn_cooldown_s)
        self.log = log or (lambda m: sys.stderr.write(m + "\n"))
        self.detections = 0
        self._last_warn: Dict[int, float] = {}

    def poll(self) -> List[dict]:
        hb = read_heartbeats(self.dirname)
        for rank, rec in hb.items():
            if rec.get("ewma_ms") is not None:
                _g_ewma.labels(str(rank)).set(rec["ewma_ms"])
        findings = detect_stragglers(hb, ratio=self.ratio,
                                     min_ranks=self.min_ranks)
        now = time.monotonic()
        for f in findings:
            self.detections += 1
            _m_straggler.labels(str(f["rank"])).inc()
            if now - self._last_warn.get(f["rank"], -1e18) \
                    >= self.warn_cooldown_s:
                self._last_warn[f["rank"]] = now
                self.log(
                    f"[health] straggler: rank {f['rank']} step-time EWMA "
                    f"{f['ewma_ms']:.1f}ms is {f['ratio']:.1f}x the gang "
                    f"median {f['median_ms']:.1f}ms "
                    f"(threshold {self.ratio}x)")
        return findings


# ---------------------------------------------------------------------------
# Divergence guardrails
# ---------------------------------------------------------------------------

class DivergenceError(RuntimeError):
    """The guardrail spent its rollback budget: the run cannot heal
    itself."""


class GuardrailConfig:
    """The divergence-guardrail policy: ``skip_nonfinite`` (a NaN/Inf loss
    is bad), ``spike_mult`` (a loss above that multiple of the median of
    the last ``window`` good losses, given ``min_history`` of them, is
    bad; None disables), ``max_consecutive_bad`` (K bad steps in a row ask
    for a rollback), ``lr_cooldown`` (the LR multiplier at each rollback)
    and ``max_rollbacks`` (then :class:`DivergenceError`)."""

    def __init__(self, skip_nonfinite: bool = True,
                 spike_mult: Optional[float] = None, window: int = 32,
                 min_history: int = 5, max_consecutive_bad: int = 3,
                 lr_cooldown: float = 0.5, max_rollbacks: int = 2):
        self.skip_nonfinite = bool(skip_nonfinite)
        self.spike_mult = None if spike_mult is None else float(spike_mult)
        self.window = int(window)
        self.min_history = int(min_history)
        self.max_consecutive_bad = int(max_consecutive_bad)
        self.lr_cooldown = float(lr_cooldown)
        self.max_rollbacks = int(max_rollbacks)


class DivergenceGuard:
    """The per-step judge: :meth:`judge` a step's loss into ``"ok"``,
    ``"skip"`` (discard the update) or ``"rollback"`` (restore the latest
    valid checkpoint, then :meth:`rolled_back`). The verdict depends only
    on the loss, the same on every rank after its all-reduce."""

    def __init__(self, config: Optional[GuardrailConfig] = None):
        self.config = config or GuardrailConfig()
        self.consecutive_bad = 0
        self.skipped_steps = 0
        self.rollbacks = 0
        self.last_reason: Optional[str] = None
        self._history: List[float] = []

    def _median(self) -> Optional[float]:
        if len(self._history) < self.config.min_history:
            return None
        vals = sorted(self._history)
        n = len(vals)
        return (vals[n // 2] if n % 2 else
                0.5 * (vals[n // 2 - 1] + vals[n // 2]))

    def _is_bad(self, loss: float) -> Optional[str]:
        if not math.isfinite(loss):
            return "nonfinite" if self.config.skip_nonfinite else None
        if self.config.spike_mult is not None:
            med = self._median()
            if med is not None and med > 0 \
                    and loss > self.config.spike_mult * med:
                return "spike"
        return None

    def judge(self, loss) -> str:
        """Classify one step by its loss (a float, an array or a tensor):
        "ok" | "skip" | "rollback"."""
        if isinstance(loss, torch.Tensor):
            loss = loss.detach().float().cpu().numpy()
        arr = np.asarray(loss)
        val = float(arr.ravel()[0]) if arr.size else float("nan")
        reason = self._is_bad(val)
        if reason is None:
            self.consecutive_bad = 0
            self.last_reason = None
            self._history.append(val)
            del self._history[:-self.config.window]
            return "ok"
        self.consecutive_bad += 1
        self.skipped_steps += 1
        self.last_reason = reason
        _m_skipped.labels(reason).inc()
        if self.consecutive_bad >= self.config.max_consecutive_bad:
            return "rollback"
        return "skip"

    def rolled_back(self) -> None:
        """Record a performed rollback; raises :class:`DivergenceError`
        once the budget is spent."""
        self.rollbacks += 1
        self.consecutive_bad = 0
        _m_rollbacks.inc()
        if self.rollbacks > self.config.max_rollbacks:
            raise DivergenceError(
                f"divergence guardrail exhausted: {self.rollbacks} rollbacks "
                f"(budget {self.config.max_rollbacks}) and the loss is still "
                f"bad (last reason: {self.last_reason})")


def nonfinite_guard(*scalars) -> bool:
    """True when any of ``scalars`` (loss, grad norm) is NaN or Inf.

    JAX selects the old or the new state on the device after the update
    (``jnp.where``). The port updates params and moments in place, so the
    step must decide BEFORE the sweep: this reads one flag back to the
    host — the step's only host sync, taken only when ``skip_nonfinite``
    is on."""
    bad = torch.zeros((), dtype=torch.bool, device=scalars[0].device)
    for s in scalars:
        bad = bad | ~torch.isfinite(torch.as_tensor(s, dtype=torch.float32))
    return bool(bad.item())
