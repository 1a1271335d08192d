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
- :mod:`.hw` — the card's peak rates for bounds and MFU.

Every on-disk format (span JSONL, goodput reports, flight sidecars, blame
reports, ``FLEET.json``, the Prometheus text) is the reference's, so the
two packages read each other's files. The reference's device-side half —
``attribution``, ``baseline``, ``program_report`` and ``trace_merge`` —
waits for ``torch.profiler`` counterparts (ROADMAP A, item 4).
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
from . import fleet  # noqa: F401
from . import flight  # noqa: F401
from . import goodput  # noqa: F401
from . import hw  # noqa: F401
from . import prom  # noqa: F401
from . import slo  # noqa: F401
from . import spans  # noqa: F401

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "default_registry",
    "metrics_enabled", "set_metrics_enabled",
    "MonitorWriter", "TrainMonitor", "fleet", "flight", "goodput", "hw",
    "prom", "slo", "spans",
]
