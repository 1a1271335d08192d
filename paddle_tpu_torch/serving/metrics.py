"""Serving metric families — the port of the request, latency, token,
prefill and decode families of ``paddle_tpu/serving/metrics.py:29-71``.
Same names as the JAX package, registered in the port's own registry."""
from __future__ import annotations

from ..observability import metrics as _obs

__all__ = ["m_requests", "m_queue_depth", "m_active", "m_occupancy",
           "m_ttft_ms", "m_tpot_ms", "m_tokens", "m_tokens_per_s",
           "m_prefill_ms", "m_prefill_tokens", "m_decode_ms",
           "m_evictions", "m_queue_wait_ms", "request_code"]

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
    "Prompt tokens prefilled (bucket padding excluded)")
m_decode_ms = _REG.histogram(
    "paddle_serve_decode_step_ms",
    "Decode step wall time (one token across the batch), ms")
m_evictions = _REG.counter(
    "paddle_serve_slot_evictions_total",
    "Decode-slot evictions by reason", ("reason",))
m_queue_wait_ms = _REG.histogram(
    "paddle_serve_queue_wait_ms",
    "Admission-queue wait (submit -> prefill start), ms")


def request_code(code: int) -> None:
    """Count one request outcome."""
    m_requests.labels(str(int(code))).inc()
