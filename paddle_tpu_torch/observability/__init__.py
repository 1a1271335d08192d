"""Port of ``paddle_tpu.observability``: the host-side telemetry stack.

- :mod:`.metrics` — the in-process metrics registry (counters, gauges,
  histograms, all with labels), always live;
- :mod:`.prom` — its Prometheus text exposition: a textfile writer, the
  gang merge and a localhost scrape endpoint;
- :mod:`.spans` — the end-to-end span tracer: trace/span/parent identity
  with cross-thread and cross-process context propagation, a bounded ring
  and a JSONL sink;
- :mod:`.goodput` — the wall-clock ledger: every run second classified
  (productive_step, compile, checkpoint_save, ...), per-rank window
  reports and the gang's ``GOODPUT.json``;
- :mod:`.flight` — the training gang's flight recorder: a per-rank event
  ring with collective sequence streams and a crash-surviving sidecar,
  read by the blame engine ``paddle_tpu_torch.tools.flight_assemble``;
- :mod:`.monitor` — ``TrainMonitor``/``MonitorWriter``: one JSONL record
  per training step;
- :mod:`.slo` — the live SLO engine: objectives over rolling windows,
  burn-rate alerts, the error-budget ledger;
- :mod:`.fleet` — the fleet poller: per-replica scrapes folded into
  ``FLEET.json`` and a merged exposition;
- :mod:`.hw` — the card's peak rates for bounds and MFU;
- :mod:`.program_report` — a report of each program's first call
  (counted FLOPs, the allocator's memory, its wall ms), the recompile
  explainer and live device-memory gauges;
- :mod:`.attribution` — every kernel of a ``torch.profiler`` capture
  placed on the roofline (``ATTRIBUTION.json``), with the residue list;
- :mod:`.baseline` — the perf sentinel: a run's artifacts diffed against
  a baseline with tolerance bands and cause attribution;
- :mod:`.trace_merge` — host, device and span-tracer events merged into
  one chrome trace.

Every on-disk format (span JSONL, goodput reports, flight sidecars, blame
reports, ``FLEET.json``, the Prometheus text, program reports,
``ATTRIBUTION.json``, baselines and regression reports) is the
reference's, so the two packages read each other's files.
"""
from __future__ import annotations

from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    metrics_enabled,
    set_metrics_enabled,
)
from .monitor import MonitorWriter, TrainMonitor  # noqa: F401
from . import attribution  # noqa: F401
from . import baseline  # noqa: F401
from . import fleet  # noqa: F401
from . import flight  # noqa: F401
from . import goodput  # noqa: F401
from . import hw  # noqa: F401
from . import program_report  # noqa: F401
from . import prom  # noqa: F401
from . import slo  # noqa: F401
from . import spans  # noqa: F401
from . import trace_merge  # noqa: F401

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "default_registry",
    "metrics_enabled", "set_metrics_enabled",
    "MonitorWriter", "TrainMonitor", "attribution", "baseline", "fleet",
    "flight", "goodput", "hw", "program_report", "prom", "slo", "spans",
    "trace_merge",
]
