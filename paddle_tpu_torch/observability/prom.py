"""Prometheus text exposition for the metrics registry — the port of
``paddle_tpu/observability/prom.py``; its output is the reference's byte
for byte over registries filled alike.

Two sinks:
- ``render(registry)`` / ``write_textfile(path)`` — the text exposition
  format (version 0.0.4), suitable for the node-exporter textfile
  collector or for test validation;
- ``MetricsHTTPServer`` — an optional localhost scrape endpoint serving
  ``/metrics`` from a daemon thread (stdlib http.server; no dependencies).

Histogram series follow the Prometheus convention: cumulative
``_bucket{le="..."}`` samples ending in ``le="+Inf"``, plus ``_sum`` and
``_count``.
"""
from __future__ import annotations

import math
import threading
from typing import Optional

from .metrics import MetricsRegistry, default_registry
from .metrics import _CounterChild, _GaugeChild, _HistogramChild  # noqa: F401

__all__ = ["render", "write_textfile", "merge_expositions",
           "GAUGE_MERGE_SUM", "GAUGE_MERGE_POLICY", "MetricsHTTPServer"]


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace("\n", "\\n")
             .replace('"', '\\"'))


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _label_str(names, values, extra=()) -> str:
    pairs = [f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape_label(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def render(registry: Optional[MetricsRegistry] = None) -> str:
    registry = registry or default_registry()
    lines = []
    for m in registry.metrics():
        lines.append(f"# HELP {m.name} {_escape_help(m.help or m.name)}")
        lines.append(f"# TYPE {m.name} {m.type_name}")
        for c in m.children():
            base = _label_str(m.labelnames, c.labels)
            if isinstance(c, _HistogramChild):
                cum = 0
                for bound, count in zip(c.bounds, c.counts):
                    cum += count
                    lab = _label_str(m.labelnames, c.labels,
                                     extra=[("le", _fmt_value(bound))])
                    lines.append(f"{m.name}_bucket{lab} {cum}")
                cum += c.counts[-1]
                lab = _label_str(m.labelnames, c.labels,
                                 extra=[("le", "+Inf")])
                lines.append(f"{m.name}_bucket{lab} {cum}")
                lines.append(f"{m.name}_sum{base} {_fmt_value(c.sum)}")
                lines.append(f"{m.name}_count{base} {c.count}")
            else:
                lines.append(f"{m.name}{base} {_fmt_value(c.value)}")
    return "\n".join(lines) + "\n" if lines else ""


def write_textfile(path: str,
                   registry: Optional[MetricsRegistry] = None) -> str:
    """Atomic-ish textfile write (tmp + rename, the textfile-collector
    contract: scrapers never see a half-written exposition)."""
    import os

    text = render(registry)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
    return path


# gauges that are per-rank COUNTS of live things, not levels: the gang
# total is their sum (2 replicas each holding 3 active requests = 6
# in-flight fleet-wide).  Every other gauge stays MAX — occupancy and
# ratio-style gauges would be nonsense above 1.0 if summed.
GAUGE_MERGE_SUM = frozenset({
    "paddle_serve_queue_depth",
    "paddle_serve_active_requests",
})

# explicit fleet merge policy for the flight-recorder families whose
# semantics are not guessable from the metric type alone:
#
#   paddle_step_skew_ms        gauge    MAX  — the fleet's worst cross-
#                                             rank step skew is the
#                                             signal; a sum of skews is
#                                             meaningless
#   paddle_blamed_rank         gauge    MAX  — a rank IDENTITY (-1 = no
#                                             blame); MAX surfaces the
#                                             blamed rank over the -1
#                                             sentinels, never adds them
#   paddle_flight_dump_total   counter  SUM  — dump occurrences per
#                                             cause (hang/anomaly/exit)
#                                             total across the gang, by
#                                             the counter type rule
#
# Counters need no entry (TYPE counter always sums); gauge families
# listed here are pinned so a future GAUGE_MERGE_SUM edit can't silently
# flip them.  ``merge_expositions(gauge_merge=...)`` still overrides.
GAUGE_MERGE_POLICY = {
    "paddle_step_skew_ms": "max",
    "paddle_blamed_rank": "max",
}


def merge_expositions(texts, gauge_merge=None, extra_labels=None) -> str:
    """Merge several text expositions (one per gang rank) into ONE gang
    exposition (the supervisor's aggregation).

    Merge rules by declared TYPE: ``counter`` and ``histogram`` samples
    (including ``_bucket``/``_sum``/``_count``) SUM across ranks — restart
    downtime, goodput seconds and request counts are gang totals;
    ``gauge`` samples merge per family: additive gauges (queue depth,
    active slots — :data:`GAUGE_MERGE_SUM`, overridable via
    ``gauge_merge={family: "sum"|"max"}``) SUM across ranks, level
    gauges (occupancy) take the MAX — the worst rank is the
    operationally interesting one and a summed ratio is meaningless.
    HELP/TYPE rows come from the first exposition that declared the
    family.  Output stays valid against the 0.0.4 grammar.

    ``extra_labels`` — a sequence parallel to ``texts`` of label-pair
    lists (e.g. ``[("replica", "0"), ("role", "prefill")]``) injected
    into every sample of that source BEFORE merging, so per-replica
    series survive in a fleet exposition instead of collapsing
    (observability/fleet.py's merged view).
    """
    types: dict = {}            # family -> type
    helps: dict = {}            # family -> help line
    order: list = []            # family order of first appearance
    samples: dict = {}          # family -> {(suffix_name, labels): value}

    def family_of(name: str):
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in types \
                    and types[name[: -len(suffix)]] == "histogram":
                return name[: -len(suffix)]
        return name

    def gauge_policy(fam: str) -> str:
        if gauge_merge and fam in gauge_merge:
            return gauge_merge[fam]
        if fam in GAUGE_MERGE_POLICY:
            return GAUGE_MERGE_POLICY[fam]
        return "sum" if fam in GAUGE_MERGE_SUM else "max"

    def inject(labels: str, extra) -> str:
        pairs = ",".join(f'{k}="{_escape_label(str(v))}"'
                         for k, v in extra)
        if not labels:
            return "{" + pairs + "}"
        return labels[:-1] + "," + pairs + "}"

    for i, text in enumerate(texts):
        extra = (list(extra_labels[i])
                 if extra_labels and extra_labels[i] else None)
        for line in text.splitlines():
            if not line:
                continue
            if line.startswith("# "):
                parts = line.split(None, 3)
                if len(parts) >= 4 and parts[1] in ("HELP", "TYPE"):
                    fam = parts[2]
                    if parts[1] == "TYPE":
                        types.setdefault(fam, parts[3].strip())
                        if fam not in order:
                            order.append(fam)
                    else:
                        helps.setdefault(fam, line)
                continue
            brace = line.find("{")
            space = line.rfind(" ")
            if space <= 0:
                continue
            if 0 <= brace < space:
                name = line[:brace]
                labels = line[brace:line.rfind("}") + 1]
            else:
                name = line[:space]
                labels = ""
            try:
                value = float(line[space + 1:])
            except ValueError:
                continue
            if extra:
                labels = inject(labels, extra)
            fam = family_of(name)
            if fam not in order:
                order.append(fam)
            fam_samples = samples.setdefault(fam, {})
            key = (name, labels)
            if key in fam_samples and types.get(fam) == "gauge" \
                    and gauge_policy(fam) == "max":
                fam_samples[key] = max(fam_samples[key], value)
            else:
                fam_samples[key] = fam_samples.get(key, 0.0) + value

    lines = []
    for fam in order:
        if fam in helps:
            lines.append(helps[fam])
        if fam in types:
            lines.append(f"# TYPE {fam} {types[fam]}")
        for (name, labels), value in sorted(samples.get(fam, {}).items()):
            lines.append(f"{name}{labels} {_fmt_value(value)}")
    return "\n".join(lines) + "\n" if lines else ""


class MetricsHTTPServer:
    """Localhost /metrics scrape endpoint on a daemon thread.

    >>> srv = MetricsHTTPServer(port=0)   # port=0: OS-assigned
    >>> srv.start(); srv.port             # actual bound port
    >>> srv.stop()
    """

    def __init__(self, port: int = 9464, host: str = "127.0.0.1",
                 registry: Optional[MetricsRegistry] = None):
        self._registry = registry or default_registry()
        self._host = host
        self._port = int(port)
        self._httpd = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._port

    def start(self) -> "MetricsHTTPServer":
        if self._httpd is not None:
            return self
        import http.server

        registry = self._registry

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib naming)
                if self.path.split("?")[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                body = render(registry).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-scrape stderr spam
                pass

        self._httpd = http.server.ThreadingHTTPServer(
            (self._host, self._port), Handler)
        self._port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="metrics_http")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._thread = None
