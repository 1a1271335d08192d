"""Serving metric families — the port of the request, latency, token,
prefill and decode families of ``paddle_tpu/serving/metrics.py:29-71`` and
the paged-pool, prefix-cache, speculative-decoding, preemption and
head-of-line families of ``:74-110``, the shed family of ``:116-118`` and
the disaggregation families of ``:142-160``. Same names as the JAX
package, registered in the port's own registry."""
from __future__ import annotations

from ..observability import metrics as _obs

__all__ = ["m_requests", "m_queue_depth", "m_active", "m_occupancy",
           "m_ttft_ms", "m_tpot_ms", "m_tokens", "m_tokens_per_s",
           "m_prefill_ms", "m_prefill_tokens", "m_decode_ms",
           "m_evictions", "m_queue_wait_ms", "m_prefix_cache",
           "m_page_occupancy", "m_page_fragmentation", "m_spec_accepted",
           "m_spec_proposed", "m_spec_windows", "m_preemptions",
           "m_hol_admits", "m_shed", "m_kv_transfer_bytes",
           "m_kv_transfer_ms", "m_pool_prefix", "m_disagg_fallback",
           "request_code"]

_REG = _obs.default_registry()

# request outcomes by HTTP-style code ("200", "400", "429", "500", "503",
# "504") — the front door stamps every response
m_requests = _REG.counter(
    "paddle_serve_requests_total",
    "Serving requests by response code", ("code",))
m_queue_depth = _REG.gauge(
    "paddle_serve_queue_depth",
    "Requests waiting for a decode slot (admission queue)")
m_active = _REG.gauge(
    "paddle_serve_active_requests",
    "Requests currently holding a decode slot")
m_occupancy = _REG.gauge(
    "paddle_serve_batch_occupancy",
    "Live decode slots / max_batch at the last scheduler tick")
# TTFT spans queueing + prefill; TPOT is the per-token decode cadence.
# Labelled by phase and replica role as in the JAX package.
m_ttft_ms = _REG.histogram(
    "paddle_serve_ttft_ms",
    "Time to first token (submit -> first generated token), ms",
    ("phase", "role"))
m_tpot_ms = _REG.histogram(
    "paddle_serve_tpot_ms",
    "Per-output-token latency after the first token, ms",
    ("phase", "role"))
m_tokens = _REG.counter(
    "paddle_serve_tokens_total", "Generated tokens")
m_tokens_per_s = _REG.gauge(
    "paddle_serve_tokens_per_s",
    "Generated tokens per second over the last scheduler window")
m_prefill_ms = _REG.histogram(
    "paddle_serve_prefill_ms",
    "Prefill wall time (bucket-padded prompt), ms")
m_prefill_tokens = _REG.counter(
    "paddle_serve_prefill_tokens_total",
    "Prompt tokens actually prefilled (bucket padding and prefix-cache "
    "hits excluded)")
m_decode_ms = _REG.histogram(
    "paddle_serve_decode_step_ms",
    "Decode step wall time (one token across the batch), ms")
m_evictions = _REG.counter(
    "paddle_serve_slot_evictions_total",
    "Decode-slot evictions by reason", ("reason",))
m_queue_wait_ms = _REG.histogram(
    "paddle_serve_queue_wait_ms",
    "Admission-queue wait (submit -> prefill start), ms")
# prefix cache (serving/paged_kv.py): a hit attaches a cached prompt
# prefix's pages by refcount instead of prefilling them again
m_prefix_cache = _REG.counter(
    "paddle_serve_prefix_cache_total",
    "Prefix-cache lookups by outcome", ("event",))
m_page_occupancy = _REG.gauge(
    "paddle_serve_page_pool_occupancy",
    "Allocated KV pages / allocatable pages (scratch page excluded)")
m_page_fragmentation = _REG.gauge(
    "paddle_serve_page_pool_fragmentation",
    "Internal page waste: 1 - used rows / allocated rows")
# speculative decoding (serving/spec_decode.py): the acceptance histogram
# is the speedup meter — mean accepted a window against the draft + verify
# cost
m_spec_accepted = _REG.histogram(
    "paddle_serve_spec_accepted_tokens",
    "Draft tokens accepted per verify window")
m_spec_proposed = _REG.counter(
    "paddle_serve_spec_proposed_tokens_total",
    "Draft tokens proposed to the verifier")
m_spec_windows = _REG.counter(
    "paddle_serve_spec_windows_total", "Speculative verify windows run")
# scheduler preemptions (page pool dry mid-generation -> recompute
# requeue) and head-of-line bypass admissions
m_preemptions = _REG.counter(
    "paddle_serve_preemptions_total",
    "Active requests preempted (recompute-requeued) by reason",
    ("reason",))
m_hol_admits = _REG.counter(
    "paddle_serve_hol_bypass_admits_total",
    "Requests admitted past a head-of-line prompt that did not fit")
# the front door's overload control: "queue_full" (429 at capacity) and
# "deadline" (the measured queue ETA exceeds the request's deadline)
m_shed = _REG.counter(
    "paddle_serve_shed_total",
    "Requests shed by the overload control, by reason", ("reason",))

# disaggregated serving (serving/kv_transfer.py, serving/disagg.py): the KV
# handoff's volume and latency between prefill and decode replicas (they
# move only on disaggregated runs), the gang-shared prefix index by phase,
# and the router's degradations to colocated dispatch
m_kv_transfer_bytes = _REG.counter(
    "paddle_kv_transfer_bytes_total",
    "KV page bytes shipped between replicas, by direction",
    ("direction",))
m_kv_transfer_ms = _REG.histogram(
    "paddle_kv_transfer_ms",
    "Wall time of one request's KV handoff (export+ship+adopt), ms")
m_pool_prefix = _REG.counter(
    "paddle_serve_pool_prefix_cache_total",
    "Pool-level (gang-shared) prefix index events, by phase",
    ("event", "phase"))
m_disagg_fallback = _REG.counter(
    "paddle_serve_disagg_fallback_total",
    "Disagg requests degraded to colocated dispatch, by reason",
    ("reason",))


def request_code(code: int) -> None:
    """Count one request outcome."""
    m_requests.labels(str(int(code))).inc()
