"""Per-step training monitor: one structured JSONL record per step — the
port of ``paddle_tpu/observability/monitor.py``, with its row keys
(:data:`STEP_RECORD_KEYS` and the rest) unchanged.

``TrainMonitor`` is the callback object ``tools/train_bench.py --monitor``
uses (as ``bench.py --monitor`` does in the JAX package). Each step it
emits a record with:

    step, step_time_ms, host_dispatch_ms, device_wait_ms,
    examples_per_s, tokens_per_s, mfu, loss, grad_norm, nan_inf,
    p50/p90/p99 rolling step-time percentiles

The host-dispatch vs device-wait split follows the port's eager model:
dispatch is the time the train step's call takes to return (the kernels
are enqueued on the card's stream, not finished); device wait is the time
spent materializing the fetched loss on the host (``observe``'s copy,
``.item()`` in effect: the step's one sync point).

Usage pattern::

    mon = TrainMonitor(path="steps.jsonl", examples_per_step=batch,
                       flops_per_step=flops, peak_flops=peak)
    for batch in data:
        with mon.step() as s:
            params, opt, loss, gnorm = step(params, opt, *batch)
            s.dispatched()                        # host dispatch
            s.observe(loss=loss, grad_norm=gnorm)  # device wait (sync)
    mon.close()

MFU is over the card's bf16 dense peak from :mod:`.hw` (the same table as
``train_bench``); NaN/Inf detection is the scan of the reference's
``utils/nan_inf.py`` (:func:`summarize_value` is the port's copy).

Every record also carries ``live_buffer_bytes`` / ``peak_hbm_bytes`` from
``torch.cuda.memory_allocated`` / ``max_memory_allocated`` while a card is
in use (``sample_hbm=False`` opts out; on the CPU they are left out, as
the reference leaves them out when its sampler has nothing), and
``dump_on_anomaly=DIR`` writes a self-contained forensics directory
(monitor tail, per-fetch summaries, flag state, the flight recorder's
ring) when a step's loss goes NaN/Inf or its grad norm blows past
``anomaly_grad_mult`` x the rolling p50. The reference's dump also holds
``program_reports.json``; the port writes it once ``program_report``
is ported (ROADMAP A, item 4).
"""
from __future__ import annotations

import collections
import json
import time
from typing import Any, Dict, IO, Optional, Union

import numpy as np

from . import goodput as _goodput
from . import metrics as _metrics

__all__ = ["MonitorWriter", "TrainMonitor"]

# keys every monitored step record carries, with finite values
STEP_RECORD_KEYS = (
    "step", "step_time_ms", "host_dispatch_ms", "device_wait_ms",
    "examples_per_s", "mfu", "loss", "nan_inf",
)


def _is_float_like(arr: np.ndarray) -> bool:
    # ml_dtypes kinds (bfloat16/float8) report 'V'; they are float-like
    return arr.dtype.kind == "f" or "float" in str(arr.dtype)


def _host(value):
    """A fetched value as a numpy array: a torch tensor is copied to the
    host (bf16 and f16 through float32; the copy is the sync on the card),
    anything else goes through ``np.asarray``."""
    if hasattr(value, "detach"):
        t = value.detach()
        if t.is_floating_point() and t.element_size() < 4:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(value)


def summarize_value(name, value):
    """Forensics summary of one fetched value: shape/dtype/element counts
    plus finite/nan/inf tallies and min/max/mean over the finite elements
    — the port's copy of the reference's ``utils/nan_inf.summarize_value``
    (the dtype is the host copy's: a bf16 tensor reports float32). Never
    raises; a value that cannot even be converted reports its error."""
    try:
        arr = _host(value)
    except Exception as e:
        return {"name": str(name), "error": f"{type(e).__name__}: {e}"}
    out = {"name": str(name), "shape": list(arr.shape),
           "dtype": str(arr.dtype), "size": int(arr.size)}
    if arr.size == 0:
        return out
    farr = arr
    if arr.dtype.kind != "f":
        if "float" in str(arr.dtype):
            farr = arr.astype(np.float32)
        else:
            if arr.dtype.kind in "iub":
                out.update(min=int(arr.min()), max=int(arr.max()))
            return out
    finite = np.isfinite(farr)
    n_finite = int(finite.sum())
    out.update(
        finite_count=n_finite,
        nan_count=int(np.isnan(farr).sum()),
        inf_count=int(np.isinf(farr).sum()),
    )
    if n_finite:
        fin = farr[finite].astype(np.float64)
        out.update(min=float(fin.min()), max=float(fin.max()),
                   mean=float(fin.mean()))
    return out


def _scan_nan_inf(value) -> bool:
    """True when any element of a float-like value is NaN/Inf (the
    reference's utils/nan_inf.py scan rule, non-raising)."""
    if value is None:
        return False
    arr = _host(value)
    if not _is_float_like(arr):
        return False
    if arr.dtype.kind != "f":
        arr = arr.astype(np.float32)
    return bool(np.isnan(arr).any() or np.isinf(arr).any())


def _sample_device_memory():
    """(bytes allocated, peak bytes allocated) on the current card, or
    (None, None) while no card is in use."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None, None
    return torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()


class MonitorWriter:
    """Line-buffered JSONL sink: one json object per line, flushed per
    write so a crashed run keeps every completed step's record."""

    def __init__(self, path_or_file: Union[str, IO]):
        if hasattr(path_or_file, "write"):
            self._f = path_or_file
            self._own = False
            self.path = getattr(path_or_file, "name", None)
        else:
            self._f = open(path_or_file, "a")
            self._own = True
            self.path = str(path_or_file)
        self.records_written = 0

    def write(self, record: Dict[str, Any]) -> None:
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()
        self.records_written += 1

    def close(self) -> None:
        if self._own and self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _StepHandle:
    """Context for one step: times the dispatch / wait / total phases."""

    __slots__ = ("mon", "t0", "t_dispatch", "t_wait", "fields",
                 "fetch_refs", "fetch_names")

    def __init__(self, mon: "TrainMonitor"):
        self.mon = mon
        self.t_dispatch = None
        self.t_wait = 0.0
        self.fields: Dict[str, Any] = {}
        self.fetch_refs = None
        self.fetch_names = None

    def __enter__(self):
        # anchor the ledger for the first row's delta: later rows delta
        # against the previous row's finish, so inter-step stalls
        # (input_stall, checkpoint_save) land on the row that follows them
        if self.mon._goodput_snap is None:
            self.mon._goodput_snap = _goodput.ledger().totals(
                include_open=True)
        self.t0 = time.perf_counter_ns()
        return self

    def dispatched(self) -> None:
        """Mark the end of the host-dispatch phase (the async launch
        returned; everything after is device wait / host bookkeeping)."""
        if self.t_dispatch is None:
            self.t_dispatch = time.perf_counter_ns()

    def observe(self, loss=None, grad_norm=None, fetches=None,
                fetch_names=None, **extra) -> None:
        """Record the step's fetched values. Materializing ``loss`` /
        ``grad_norm`` here is the step's sync point — the time it takes IS
        the device wait, so it is measured. ``fetches``/``fetch_names``
        are held by reference only (no sync): an anomaly dump summarizes
        them if this step trips."""
        if fetches is not None:
            self.fetch_refs = list(fetches)
            self.fetch_names = list(fetch_names or [])
        t0 = time.perf_counter_ns()
        with _goodput.ledger().timer("device_wait"):
            if loss is not None:
                arr = _host(loss)
                self.fields["nan_inf"] = _scan_nan_inf(arr)
                self.fields["loss"] = float(arr.ravel()[0]) \
                    if arr.size else None
            if grad_norm is not None:
                arr = _host(grad_norm)
                self.fields["grad_norm"] = float(arr.ravel()[0])
                if self.fields.get("nan_inf") is not True:
                    self.fields["nan_inf"] = _scan_nan_inf(arr)
        self.t_wait += (time.perf_counter_ns() - t0)
        self.fields.update(extra)

    def __exit__(self, exc_type, exc, tb):
        self.dispatched()  # a step that never synced: all time is dispatch
        t_end = time.perf_counter_ns()
        # row assembly + JSONL write is per-step bookkeeping: charge it to
        # the step so the ledger's `other` stays honest
        with _goodput.ledger().timer("productive_step"):
            self.mon._finish_step(self, t_end)
        return False


class TrainMonitor:
    """Per-step train monitor with JSONL + metrics-registry sinks.

    Throughput denominators: pass ``examples_per_step`` (and optionally
    ``tokens_per_step``); MFU needs ``flops_per_step`` and optionally
    ``peak_flops`` (defaults to the bf16 dense peak of the current card
    from :func:`hw.peaks_for`; without a card it must be given).
    """

    def __init__(self, path: Optional[str] = None,
                 writer: Optional[MonitorWriter] = None,
                 examples_per_step: Optional[float] = None,
                 tokens_per_step: Optional[float] = None,
                 flops_per_step: Optional[float] = None,
                 peak_flops: Optional[float] = None,
                 window: int = 100,
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 extra_static: Optional[Dict[str, Any]] = None,
                 sample_hbm: bool = True,
                 dump_on_anomaly: Optional[str] = None,
                 anomaly_grad_mult: float = 10.0,
                 dump_last_n: int = 32,
                 max_dumps: int = 5):
        if writer is None and path is not None:
            writer = MonitorWriter(path)
        self.writer = writer
        self.examples_per_step = examples_per_step
        self.tokens_per_step = tokens_per_step
        self.flops_per_step = flops_per_step
        self._peak_flops = peak_flops
        self.extra_static = dict(extra_static or {})
        self.step_count = 0
        self.last_record: Optional[Dict[str, Any]] = None
        self._step_times = collections.deque(maxlen=window)
        # live/peak device memory stamped into every record while a card
        # is in use (sample_hbm=False opts out)
        self.sample_hbm = bool(sample_hbm)
        # anomaly forensics: NaN/Inf loss, or grad_norm blowing past
        # anomaly_grad_mult x the rolling p50, writes a self-contained
        # dump directory under dump_on_anomaly (None = disabled)
        self.dump_on_anomaly = dump_on_anomaly
        self.anomaly_grad_mult = float(anomaly_grad_mult)
        self.max_dumps = int(max_dumps)
        self.dumps_written = 0
        self.dump_paths: list = []
        self._recent_records = collections.deque(maxlen=int(dump_last_n))
        self._grad_norms = collections.deque(maxlen=window)
        # goodput breakdown: every row carries the ledger's per-category
        # delta since the previous row, so one JSONL stream answers "slow
        # step: compile, input stall, or device?"
        self._goodput_snap: Optional[Dict[str, float]] = None
        reg = registry or _metrics.default_registry()
        self._m_steps = reg.counter(
            "paddle_train_steps_total", "Monitored train steps")
        self._m_step_ms = reg.histogram(
            "paddle_train_step_ms", "Monitored step wall time (ms)")
        self._m_examples = reg.counter(
            "paddle_train_examples_total", "Examples consumed")
        self._m_nan = reg.counter(
            "paddle_train_nan_inf_total", "Steps with NaN/Inf fetches")
        self._m_loss = reg.gauge(
            "paddle_train_loss", "Last observed loss")
        self._m_mfu = reg.gauge(
            "paddle_train_mfu", "Last step model-FLOPs-utilization (bf16 peak)")
        self._m_dumps = reg.counter(
            "paddle_anomaly_dumps_total", "Anomaly forensics dumps written")

    def peak_flops(self) -> float:
        if self._peak_flops is None:
            import torch

            from .hw import peaks_for

            if not torch.cuda.is_available():
                raise ValueError("TrainMonitor: no card to take the peak "
                                 "rate from; pass peak_flops")
            self._peak_flops = peaks_for(torch.cuda.get_device_name())[
                "bf16_flops_per_s"]
        return self._peak_flops

    def step(self) -> _StepHandle:
        return _StepHandle(self)

    # -- one-shot convenience (loops that already timed) -----------------
    def record_step(self, step_time_ms: float, host_dispatch_ms: float = 0.0,
                    device_wait_ms: float = 0.0, loss=None, grad_norm=None,
                    **extra) -> Dict[str, Any]:
        h = _StepHandle(self)
        h.t0 = 0
        h.t_dispatch = int(host_dispatch_ms * 1e6)
        if loss is not None or grad_norm is not None:
            h.observe(loss=loss, grad_norm=grad_norm)
        # the caller already timed the wait; observe()'s own materialization
        # timing is noise here, so the stated value wins
        h.t_wait = int(device_wait_ms * 1e6)
        h.fields.update(extra)
        self._finish_step(h, int(step_time_ms * 1e6))
        return self.last_record

    # -- internals -------------------------------------------------------
    def _finish_step(self, h: _StepHandle, t_end_ns: int) -> None:
        self.step_count += 1
        step_ms = (t_end_ns - h.t0) / 1e6
        dispatch_ms = (h.t_dispatch - h.t0) / 1e6
        wait_ms = h.t_wait / 1e6
        self._step_times.append(step_ms)
        rec: Dict[str, Any] = dict(self.extra_static)
        rec.update(
            step=self.step_count,
            step_time_ms=round(step_ms, 4),
            host_dispatch_ms=round(dispatch_ms, 4),
            device_wait_ms=round(wait_ms, 4),
        )
        sec = max(step_ms, 1e-9) / 1e3
        if self.examples_per_step is not None:
            rec["examples_per_s"] = round(self.examples_per_step / sec, 3)
        if self.tokens_per_step is not None:
            rec["tokens_per_s"] = round(self.tokens_per_step / sec, 3)
        if self.flops_per_step is not None:
            rec["mfu"] = round(
                self.flops_per_step / sec / self.peak_flops(), 6)
        rec.setdefault("loss", h.fields.get("loss"))
        rec.setdefault("nan_inf", bool(h.fields.get("nan_inf", False)))
        for k, v in h.fields.items():
            if k not in ("loss", "nan_inf"):
                rec[k] = v
        # comm/compute overlap fraction: callers that measure it stamp the
        # real value through record_step/observe extras; 0.0 otherwise so
        # the row schema is stable
        rec.setdefault("overlap_fraction", 0.0)
        # input-side context: time this step waited on its input and the
        # cumulative quarantined-record count — callers that have them
        # stamp the real values, defaults keep the row schema stable
        rec.setdefault("input_wait_ms", 0.0)
        rec.setdefault("quarantined_records", 0)
        # per-row goodput category breakdown (ms since the previous row;
        # include_open folds in the enclosing step timer's in-flight share)
        cur = _goodput.ledger().totals(include_open=True)
        # record_step callers never enter a step handle: their first row
        # baselines here (empty breakdown) instead of reporting the
        # process-cumulative totals as a "delta"
        prev = self._goodput_snap if self._goodput_snap is not None else cur
        rec["goodput_ms"] = {
            c: round(dv * 1e3, 3)
            for c, v in cur.items()
            if (dv := v - prev.get(c, 0.0)) > 5e-7}
        self._goodput_snap = cur
        for q in (50, 90, 99):
            rec[f"p{q}_step_time_ms"] = round(self._percentile(q), 4)
        if self.sample_hbm:
            live, peak = _sample_device_memory()
            if live is not None:
                rec["live_buffer_bytes"] = int(live)
                rec["peak_hbm_bytes"] = int(peak)
        reason = self._anomaly_reason(rec)
        if reason:
            rec["anomaly"] = reason
            if (self.dump_on_anomaly
                    and self.dumps_written < self.max_dumps):
                path = self._dump_anomaly(rec, h, reason)
                if path:
                    rec["anomaly_dump"] = path
        self.last_record = rec
        self._recent_records.append(rec)
        if self.writer is not None:
            self.writer.write(rec)
        # registry mirror: scrape-able without reading the JSONL
        self._m_steps.inc()
        self._m_step_ms.observe(step_ms)
        if self.examples_per_step is not None:
            self._m_examples.inc(self.examples_per_step)
        if rec.get("nan_inf"):
            self._m_nan.inc()
        if rec.get("loss") is not None:
            self._m_loss.set(rec["loss"])
        if rec.get("mfu") is not None:
            self._m_mfu.set(rec["mfu"])
        # grad-norm window grows AFTER the anomaly check: the rolling p50
        # an outlier is judged against never includes the outlier itself
        gn = rec.get("grad_norm")
        if gn is not None and np.isfinite(gn):
            self._grad_norms.append(float(gn))

    # -- anomaly forensics ------------------------------------------------
    def _anomaly_reason(self, rec: Dict[str, Any]) -> Optional[str]:
        """nan_inf trip, or grad_norm > anomaly_grad_mult x rolling p50
        (needs >= 5 prior healthy norms before it can judge)."""
        if rec.get("nan_inf"):
            return "nan_inf"
        gn = rec.get("grad_norm")
        if gn is None:
            return None
        if not np.isfinite(gn):
            return "grad_norm"
        if len(self._grad_norms) >= 5:
            vals = sorted(self._grad_norms)
            p50 = vals[len(vals) // 2]
            if p50 > 0 and gn > self.anomaly_grad_mult * p50:
                return "grad_norm"
        return None

    def _dump_anomaly(self, rec: Dict[str, Any], h: _StepHandle,
                      reason: str) -> Optional[str]:
        """Write a self-contained forensics directory:

            <dump_on_anomaly>/step<NNNNNN>_<reason>/
              dump_info.json        what tripped, when, against what p50
              monitor_tail.jsonl    last-N step records + the offender
              fetch_summaries.json  shape/dtype/finite-count/min/max per
                                    fetch (:func:`summarize_value`)
              flags.json            full framework flag state
              flight.dump.anomaly.rank<R>.<pid>.json
                                    the flight recorder's ring
        """
        import os

        d = os.path.join(str(self.dump_on_anomaly),
                         f"step{int(rec.get('step', 0)):06d}_{reason}")
        try:
            from ..framework.core import flags_snapshot

            os.makedirs(d, exist_ok=True)
            vals = sorted(self._grad_norms)
            info = {
                "reason": reason,
                "step": rec.get("step"),
                "ts": time.time(),
                "loss": rec.get("loss"),
                "grad_norm": rec.get("grad_norm"),
                "grad_norm_p50": vals[len(vals) // 2] if vals else None,
                "anomaly_grad_mult": self.anomaly_grad_mult,
            }
            with open(os.path.join(d, "dump_info.json"), "w") as f:
                json.dump(info, f, indent=1)
            with open(os.path.join(d, "monitor_tail.jsonl"), "w") as f:
                for r in list(self._recent_records) + [rec]:
                    f.write(json.dumps(
                        {k: v for k, v in r.items()}) + "\n")
            summaries = []
            names = h.fetch_names or []
            for i, v in enumerate(h.fetch_refs or []):
                name = names[i] if i < len(names) else f"fetch_{i}"
                summaries.append(summarize_value(name, v))
            with open(os.path.join(d, "fetch_summaries.json"), "w") as f:
                json.dump(summaries, f, indent=1)
            with open(os.path.join(d, "flags.json"), "w") as f:
                json.dump({k: repr(v) if not isinstance(
                    v, (str, int, float, bool, type(None))) else v
                    for k, v in flags_snapshot().items()}, f, indent=1)
            # flight-recorder ring snapshot: the step / collective /
            # data-wait event tail around the anomaly
            from . import flight as _flight

            _flight.dump("anomaly", dir_path=d)
        except Exception as e:  # forensics must never kill the train loop
            import logging

            logging.getLogger("paddle_tpu_torch.monitor").warning(
                "anomaly dump to %s failed: %s", d, e)
            return None
        self.dumps_written += 1
        self.dump_paths.append(d)
        self._m_dumps.inc()
        return d

    def _percentile(self, q: float) -> float:
        vals = sorted(self._step_times)
        if not vals:
            return 0.0
        idx = min(len(vals) - 1,
                  max(0, int(round(q / 100.0 * (len(vals) - 1)))))
        return vals[idx]

    def summary(self) -> Dict[str, Any]:
        return {
            "steps": self.step_count,
            "p50_step_time_ms": round(self._percentile(50), 4),
            "p90_step_time_ms": round(self._percentile(90), 4),
            "p99_step_time_ms": round(self._percentile(99), 4),
        }

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
