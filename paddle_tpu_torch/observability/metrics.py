"""In-process metrics registry: counters, gauges, histograms with labels.

A copy of ``paddle_tpu/observability/metrics.py`` (pure Python); the port
keeps its own so it never imports the JAX package. The hot paths
increment these metrics on every step, whether or not a profiler runs.

Hot-path cost model: call sites resolve their labeled child ONCE (at
module import) and keep the child object; steady state is then
``child.inc()`` — a float add under the GIL — or ``child.observe(v)`` — a
bisect into ~14 bucket bounds plus a bounded deque append. Both are O(1)
and lock-free (CPython container ops are atomic enough for monotonically
increasing telemetry; registration and snapshot take the registry lock).
"""
from __future__ import annotations

import bisect
import collections
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_registry", "metrics_enabled", "set_metrics_enabled",
]

# process-wide kill switch: `set_metrics_enabled(False)` turns every
# child op into a no-op check (for overhead A/B runs)
_ENABLED = True


def metrics_enabled() -> bool:
    return _ENABLED


def set_metrics_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = bool(on)


def _validate_name(name: str) -> None:
    if not name or not (name[0].isalpha() or name[0] == "_"):
        raise ValueError(f"invalid metric name {name!r}")
    for ch in name:
        if not (ch.isalnum() or ch in "_:"):
            raise ValueError(f"invalid metric name {name!r}")


class _Child:
    """One (metric, labelvalue-tuple) time series."""

    __slots__ = ("labels",)

    def __init__(self, labels: Tuple[str, ...]):
        self.labels = labels


class _CounterChild(_Child):
    __slots__ = ("value",)

    def __init__(self, labels):
        super().__init__(labels)
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if _ENABLED:
            self.value += amount


class _GaugeChild(_Child):
    __slots__ = ("value",)

    def __init__(self, labels):
        super().__init__(labels)
        self.value = 0.0

    def set(self, value: float) -> None:
        if _ENABLED:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if _ENABLED:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        if _ENABLED:
            self.value -= amount


# default bounds in milliseconds — spans us-scale dispatch overhead up to
# multi-second compiles
DEFAULT_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                   25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 5000.0, 30000.0)


class _HistogramChild(_Child):
    __slots__ = ("bounds", "counts", "sum", "count", "_recent")

    def __init__(self, labels, bounds, window: int):
        super().__init__(labels)
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # +inf bucket last
        self.sum = 0.0
        self.count = 0
        self._recent = collections.deque(maxlen=window)

    def observe(self, value: float) -> None:
        if not _ENABLED:
            return
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.sum += value
        self.count += 1
        self._recent.append(value)

    def percentile(self, q: float) -> Optional[float]:
        """Rolling percentile over the recent-observation window (exact, not
        bucket-interpolated — the window is bounded so the sort is cheap)."""
        if not self._recent:
            return None
        vals = sorted(self._recent)
        idx = min(len(vals) - 1, max(0, int(round(q / 100.0 * (len(vals) - 1)))))
        return vals[idx]

    class _Timer:
        __slots__ = ("child", "t0")

        def __init__(self, child):
            self.child = child

        def __enter__(self):
            self.t0 = time.perf_counter_ns()
            return self

        def __exit__(self, *exc):
            self.child.observe((time.perf_counter_ns() - self.t0) / 1e6)

    def time(self) -> "_HistogramChild._Timer":
        """Context manager observing the block's wall time in ms."""
        return self._Timer(self)


OVERFLOW_LABEL = "<other>"


class _Metric:
    """A named metric family; ``labels(*values)`` resolves a child series.

    ``max_series`` bounds label cardinality: once that many children exist,
    NEW label combinations resolve to one shared ``<other>`` overflow
    series instead of growing the exposition without bound (per-shard
    gauges on runs with thousands of shards stay scrape-able)."""

    child_cls = _CounterChild
    type_name = "counter"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 max_series: Optional[int] = None, **child_kw):
        _validate_name(name)
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.max_series = max_series
        self._child_kw = child_kw
        self._children: Dict[Tuple[str, ...], _Child] = {}
        self._lock = threading.Lock()
        if not self.labelnames:
            self._default = self._make_child(())
            self._children[()] = self._default
        else:
            self._default = None

    def _make_child(self, values: Tuple[str, ...]):
        return self.child_cls(values, **self._child_kw)

    def labels(self, *values: str):
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected {len(self.labelnames)} label values "
                f"{self.labelnames}, got {values}")
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.get(values)
                if child is None:
                    if self.max_series is not None and \
                            len(self._children) >= self.max_series:
                        values = (OVERFLOW_LABEL,) * len(self.labelnames)
                    child = self._children.setdefault(
                        values, self._make_child(values))
        return child

    def children(self) -> List[_Child]:
        with self._lock:
            return list(self._children.values())

    # unlabeled convenience forwarding
    def _unlabeled(self):
        if self._default is None:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; "
                "call .labels(...) first")
        return self._default


class Counter(_Metric):
    child_cls = _CounterChild
    type_name = "counter"

    def inc(self, amount: float = 1.0):
        self._unlabeled().inc(amount)

    @property
    def value(self) -> float:
        return self._unlabeled().value


class Gauge(_Metric):
    child_cls = _GaugeChild
    type_name = "gauge"

    def set(self, value: float):
        self._unlabeled().set(value)

    def inc(self, amount: float = 1.0):
        self._unlabeled().inc(amount)

    def dec(self, amount: float = 1.0):
        self._unlabeled().dec(amount)

    @property
    def value(self) -> float:
        return self._unlabeled().value


class Histogram(_Metric):
    child_cls = _HistogramChild
    type_name = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 window: int = 512):
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        super().__init__(name, help, labelnames, bounds=bounds, window=window)

    def observe(self, value: float):
        self._unlabeled().observe(value)

    def time(self):
        return self._unlabeled().time()

    def percentile(self, q: float):
        return self._unlabeled().percentile(q)


class MetricsRegistry:
    """Name -> metric family map with idempotent get-or-create accessors."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} re-registered as {cls.__name__}"
                        f"{tuple(labelnames)} but exists as "
                        f"{type(m).__name__}{m.labelnames}")
                return m
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = (),
                max_series: Optional[int] = None) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames,
                                   max_series=max_series)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = (),
              max_series: Optional[int] = None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames,
                                   max_series=max_series)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  window: int = 512) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets, window=window)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return sorted(self._metrics.values(), key=lambda m: m.name)

    def snapshot(self) -> Dict[str, dict]:
        """Plain-dict view of every series (used by tests and JSON sinks)."""
        out: Dict[str, dict] = {}
        for m in self.metrics():
            fam = {"type": m.type_name, "help": m.help,
                   "labelnames": m.labelnames, "series": []}
            for c in m.children():
                row = {"labels": c.labels}
                if isinstance(c, _HistogramChild):
                    row.update(sum=c.sum, count=c.count,
                               buckets=list(zip(c.bounds, c.counts)))
                else:
                    row["value"] = c.value
                fam["series"].append(row)
            out[m.name] = fam
        return out

    def reset(self) -> None:
        """Drop every registered metric (tests)."""
        with self._lock:
            self._metrics.clear()


_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _default
