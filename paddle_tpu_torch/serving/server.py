"""HTTP front door for the serving engine — the port of the engine
backend of ``paddle_tpu/serving/server.py``.

``POST /generate`` with ``{"prompt": [token ids], "max_new_tokens": N,
"timeout_s": T}`` (plus optional ``temperature``/``top_k``/``top_p``/
``seed``) queues into the continuous-batching scheduler; a loop thread
(:class:`EngineLoop`) ticks it, the handler thread waits on the request.

- bounded admission: queue full -> **429** with a JSON error body;
- deadline-aware shedding (``shed_deadline_aware=True``, the default):
  when the queue's measured drain ETA already exceeds the request's
  deadline, **429** at once instead of a 504 after the whole timeout;
- every 429 and 503 carries a ``Retry-After`` header and a
  ``retry_after_s`` body field, from the measured drain rate (1 while no
  rate is measurable; capped at ``retry_after_cap_s``); sheds count in
  ``paddle_serve_shed_total{reason}`` (``queue_full``, ``deadline``);
- malformed input or a prompt above the bucket ladder -> **400**;
- deadline blown -> **504** with the partial tokens;
- draining (:meth:`FrontDoor.drain`) -> **503**; in-flight work finishes;
- internal failure -> **500**, always with a JSON body.

``GET /health`` reports the phase, queue depth, active slots, the loop's
fault count and the span tracer's per-name rollups of the ``serve/*``
spans (``span_rollups_ms``), and status ``poisoned`` once the engine is.
``GET /metrics`` is the Prometheus text of the process's registry
(``observability/prom.py``). A ``trace`` object in a POST body
(``spans.inject``) joins the request to the caller's trace.

The disaggregated phases (``server.py:255-380`` of the reference):

- ``POST /prefill`` runs a request to its first token and answers with
  the KV handoff inline (``"kv"``, ``kv_transfer.handoff_to_jsonable``), or
  pushes it to the ``kv_target`` the caller names (``{"host", "port",
  "transfer_id"}``, a decode replica's :class:`~.kv_transfer.
  KVTransferServer`) and answers ``"transferred": true``; a failed push
  answers **502** with the first token, the caller's cue to degrade to
  colocated dispatch;
- ``POST /resume`` decodes a migrated request from ``"first_token"``,
  adopting its handoff inline (``"kv"``) or popping ``"transfer_id"`` from
  this front door's ``kv_server``.

The predictor route is still to be ported (ROADMAP.md, queue A5).
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from ..observability import goodput as _goodput
from ..observability import prom as _prom
from ..observability import spans as _spans
from . import kv_transfer
from . import metrics as smetrics
from .engine import PromptTooLongError
from .sampling import SamplingParams
from .scheduler import QueueFullError, Scheduler

__all__ = ["FrontDoor", "EngineLoop", "shed_decision"]


def shed_decision(scheduler: Scheduler, timeout_s: float,
                  retry_after_cap_s: float = 60.0):
    """Deadline-aware admission: when the measured queue-drain ETA already
    exceeds the request's deadline, admitting it only buys a 504 after
    the whole timeout, so shed it now. Returns None (admit) or
    ``("deadline", retry_after_s)`` and counts
    ``paddle_serve_shed_total{reason="deadline"}``."""
    eta = scheduler.queue_eta_s()
    if eta is None or eta <= timeout_s:
        return None
    smetrics.m_shed.labels("deadline").inc()
    return "deadline", scheduler.retry_after_s(retry_after_cap_s)


class EngineLoop:
    """Background thread ticking ``scheduler.step()``; parks on an event
    when idle. A ``step()`` exception fails every queued and active
    request (their waiters wake with an error), is recorded in
    ``faults``/``last_fault`` (surfaced by ``/health``), and the loop
    keeps ticking — unless the engine is ``poisoned`` (a call failed on
    the card after writing its caches in place): then the loop fails
    every request, refuses new ones, records ``poison_reason``, calls
    ``on_poison(reason)`` and stops ticking, and ``/health`` reports
    status ``poisoned``."""

    def __init__(self, scheduler: Scheduler, idle_sleep_s: float = 0.002,
                 on_poison=None):
        self.scheduler = scheduler
        self.idle_sleep_s = idle_sleep_s
        self.faults = 0
        self.last_fault: Optional[str] = None
        self.on_poison = on_poison
        self.poison_reason: Optional[str] = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "EngineLoop":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-engine-loop")
        self._thread.start()
        return self

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def wake(self) -> None:
        self._wake.set()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread:
            self._thread.join(timeout=timeout)

    def _run(self) -> None:
        while not self._stop.is_set():
            if self._check_poisoned():
                return
            worked = False
            if self.scheduler.pending():
                try:
                    worked = self.scheduler.step()
                except Exception as e:
                    self.faults += 1
                    self.last_fault = f"{type(e).__name__}: {e}"
                    try:
                        self.scheduler.abort_all(
                            f"engine loop fault: {self.last_fault}")
                    except Exception:
                        pass  # never let cleanup kill the loop either
                    if self._check_poisoned():
                        return
            if not worked:
                self._wake.wait(timeout=self.idle_sleep_s)
                self._wake.clear()

    def _check_poisoned(self) -> bool:
        """Fail fast on a poisoned engine: abort and refuse, fire
        ``on_poison``, stop the loop. Returns True when poisoned."""
        reason = getattr(self.scheduler.engine, "poisoned", None)
        if reason is None:
            return False
        if self.poison_reason is None:
            self.poison_reason = str(reason)
            try:
                self.scheduler.abort_all(f"engine poisoned: {reason}",
                                         refuse_new=True)
            except Exception:
                pass
            if self.on_poison is not None:
                try:
                    self.on_poison(self.poison_reason)
                except Exception:
                    pass
        self._stop.set()
        return True


class _Server(ThreadingHTTPServer):
    # the stdlib default listen backlog (5) resets connections under a
    # burst of connects; answer them with 429s instead
    request_queue_size = 128


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        if self.server.front.verbose:
            super().log_message(fmt, *args)

    def _json(self, code: int, obj: Dict[str, Any],
              retry_after: Optional[int] = None) -> None:
        if retry_after is not None:
            # the header for standard clients, the field for those that
            # read the body only
            obj = dict(obj, retry_after_s=int(retry_after))
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        if retry_after is not None:
            self.send_header("Retry-After", str(int(retry_after)))
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away; the count below still records it
        smetrics.request_code(code)

    def _read_json(self) -> Optional[Dict[str, Any]]:
        n = int(self.headers.get("Content-Length", 0))
        if n > self.server.front.max_body_bytes:
            self._json(413, {"error": "body too large"})
            return None
        try:
            obj = json.loads(self.rfile.read(n).decode())
        except (ValueError, UnicodeDecodeError) as e:
            self._json(400, {"error": f"malformed JSON body: {e}"})
            return None
        if not isinstance(obj, dict):
            self._json(400, {"error": "body must be a JSON object"})
            return None
        return obj

    def do_GET(self):
        if self.path == "/health":
            return self._json(200, self.server.front.health())
        if self.path == "/metrics":
            text = _prom.render().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(text)))
            self.end_headers()
            self.wfile.write(text)
            smetrics.request_code(200)
            return
        self._json(404, {"error": f"unknown path {self.path!r}"})

    def do_POST(self):
        route = {"/generate": self._generate, "/prefill": self._prefill,
                 "/resume": self._resume}.get(self.path)
        if route is not None:
            return route(self.server.front)
        self._json(404, {"error": f"unknown path {self.path!r}"})

    @staticmethod
    def _parse_sampling(req_obj) -> Optional[SamplingParams]:
        if not any(k in req_obj for k in ("temperature", "top_k", "top_p",
                                          "seed")):
            return None
        return SamplingParams(
            temperature=float(req_obj.get("temperature", 0.0)),
            top_k=int(req_obj.get("top_k", 0)),
            top_p=float(req_obj.get("top_p", 1.0)),
            seed=int(req_obj.get("seed", 0)))

    def _generate(self, front: "FrontDoor"):
        if front.draining:
            return self._json(503, {"error": "server is draining"},
                              retry_after=front._retry_after())
        req_obj = self._read_json()
        if req_obj is None:
            return
        prompt = req_obj.get("prompt") or req_obj.get("tokens")
        if not isinstance(prompt, list) or not prompt:
            return self._json(
                400, {"error": "body must carry a non-empty token list "
                               "under 'prompt'"})
        try:
            timeout_s = req_obj.get("timeout_s")
            timeout_s = (front.request_timeout_s if timeout_s is None
                         else float(timeout_s))
        except (TypeError, ValueError) as e:
            return self._json(400, {"error": f"{type(e).__name__}: {e}"})
        if front.shed_deadline_aware:
            shed = shed_decision(front.scheduler, timeout_s,
                                 front.retry_after_cap_s)
            if shed is not None:
                reason, after = shed
                return self._json(429, {
                    "error": f"queue drain ETA exceeds the request "
                             f"deadline ({timeout_s:.1f}s) — shed "
                             f"({reason})"}, retry_after=after)
        request = self._submitted(front, lambda: front.scheduler.submit(
            prompt, max_new_tokens=int(req_obj.get("max_new_tokens", 16)),
            timeout_s=timeout_s, sampling=self._parse_sampling(req_obj),
            trace_ctx=_spans.extract(req_obj)))
        if request is None:
            return
        front.loop.wake()
        # the scheduler owns the deadline; +1 s covers the loop's wakeup
        request.wait(timeout=timeout_s + 1.0)
        if request.state == "done":
            return self._json(200, {
                "tokens": request.tokens,
                "num_tokens": len(request.tokens),
                "ttft_ms": round(request.ttft_ms, 3),
                "tpot_ms": (round(request.tpot_ms, 3)
                            if request.tpot_ms is not None else None),
            })
        if request.state in ("expired", "queued", "active"):
            return self._json(504, {
                "error": request.error or "deadline exceeded",
                "partial_tokens": request.tokens})
        return self._json(500, {"error": request.error
                                or f"request {request.state}"})

    # -- disaggregated phases ------------------------------------------
    def _timeout(self, front: "FrontDoor", req_obj) -> float:
        timeout_s = req_obj.get("timeout_s")
        return (front.request_timeout_s if timeout_s is None
                else float(timeout_s))

    def _submitted(self, front: "FrontDoor", submit):
        """``submit()`` -> the request, or None after answering its
        refusal: 429 queue full, 400 bad input, 503 when draining raced
        the route's check or the scheduler refuses."""
        try:
            return submit()
        except QueueFullError as e:
            smetrics.m_shed.labels("queue_full").inc()
            self._json(429, {"error": str(e)},
                       retry_after=front._retry_after())
        except PromptTooLongError as e:
            self._json(400, {"error": str(e)})
        except (TypeError, ValueError) as e:
            self._json(400, {"error": f"{type(e).__name__}: {e}"})
        except RuntimeError as e:
            self._json(503, {"error": str(e)},
                       retry_after=front._retry_after())
        return None

    def _prefill(self, front: "FrontDoor"):
        """Prefill only: run to the first token, then push the KV handoff
        to the caller's ``kv_target`` or return it inline (base64)."""
        if front.draining:
            return self._json(503, {"error": "server is draining"},
                              retry_after=front._retry_after())
        req_obj = self._read_json()
        if req_obj is None:
            return
        prompt = req_obj.get("prompt") or req_obj.get("tokens")
        if not isinstance(prompt, list) or not prompt:
            return self._json(
                400, {"error": "body must carry a non-empty token list "
                               "under 'prompt'"})
        timeout_s = self._timeout(front, req_obj)
        request = self._submitted(front, lambda: front.scheduler.submit(
            prompt, max_new_tokens=int(req_obj.get("max_new_tokens", 16)),
            timeout_s=timeout_s, sampling=self._parse_sampling(req_obj),
            prefill_only=True, trace_ctx=_spans.extract(req_obj)))
        if request is None:
            return
        front.loop.wake()
        request.wait(timeout=timeout_s + 1.0)
        if request.state != "done" or request.handoff is None:
            if request.state in ("expired", "queued", "active"):
                return self._json(504, {
                    "error": request.error or "deadline exceeded"})
            return self._json(500, {"error": request.error
                                    or f"request {request.state}"})
        handoff = request.handoff
        resp = {"first_token": int(request.tokens[0]),
                "ttft_ms": round(request.ttft_ms, 3),
                "transfer_id": handoff["transfer_id"]}
        kv_target = req_obj.get("kv_target")
        if kv_target:
            handoff = dict(handoff, transfer_id=str(
                kv_target.get("transfer_id") or handoff["transfer_id"]))
            try:
                kv_transfer.send_handoff(kv_target["host"],
                                         int(kv_target["port"]), handoff,
                                         timeout_s=timeout_s)
            except Exception as e:
                # the prefill succeeded, the channel did not: 502 tells
                # the router to degrade to colocated dispatch
                return self._json(502, {
                    "error": f"KV push failed: {type(e).__name__}: {e}",
                    "first_token": int(request.tokens[0])})
            resp["transfer_id"] = handoff["transfer_id"]
            resp["transferred"] = True
        else:
            resp["kv"] = kv_transfer.handoff_to_jsonable(handoff)
        return self._json(200, resp)

    def _resume(self, front: "FrontDoor"):
        """Decode a migrated request: adopt its KV handoff (by transfer id
        from the socket channel, or inline) and generate from its first
        token."""
        if front.draining:
            return self._json(503, {"error": "server is draining"},
                              retry_after=front._retry_after())
        req_obj = self._read_json()
        if req_obj is None:
            return
        if "first_token" not in req_obj:
            return self._json(400, {"error": "body must carry "
                                             "'first_token'"})
        prompt = req_obj.get("prompt") or []
        timeout_s = self._timeout(front, req_obj)
        if req_obj.get("transfer_id"):
            if front.kv_server is None:
                return self._json(400, {
                    "error": "no KV transfer server on this replica"})
            try:
                handoff = front.kv_server.pop(
                    str(req_obj["transfer_id"]),
                    timeout_s=min(timeout_s, 10.0))
            except TimeoutError as e:
                return self._json(504, {"error": str(e)})
        elif req_obj.get("kv"):
            try:
                handoff = kv_transfer.handoff_from_jsonable(req_obj["kv"])
            except Exception as e:
                return self._json(400, {
                    "error": f"malformed inline handoff: {e}"})
        else:
            return self._json(400, {"error": "body must carry "
                                             "'transfer_id' or 'kv'"})
        request = self._submitted(
            front, lambda: front.scheduler.submit_handoff(
                handoff, int(req_obj["first_token"]),
                max_new_tokens=int(req_obj.get("max_new_tokens", 16)),
                timeout_s=timeout_s,
                sampling=self._parse_sampling(req_obj),
                prompt=prompt or None, trace_ctx=_spans.extract(req_obj)))
        if request is None:
            return
        front.loop.wake()
        request.wait(timeout=timeout_s + 1.0)
        if request.state == "done":
            return self._json(200, {
                "tokens": request.tokens,
                "num_tokens": len(request.tokens),
                "tpot_ms": (round(request.tpot_ms, 3)
                            if request.tpot_ms is not None else None),
            })
        if request.state in ("expired", "queued", "active"):
            return self._json(504, {
                "error": request.error or "deadline exceeded",
                "partial_tokens": request.tokens})
        return self._json(500, {"error": request.error
                                or f"request {request.state}"})


class FrontDoor:
    """The serving HTTP server over one scheduler (and its engine).
    ``shed_deadline_aware`` sheds requests whose deadline the queue's
    measured drain ETA already exceeds; ``retry_after_cap_s`` caps the
    ``Retry-After`` of every 429 and 503; ``on_poison(reason)`` is called
    once when the engine is found poisoned (:class:`EngineLoop`);
    ``kv_server`` is the :class:`~.kv_transfer.KVTransferServer` that
    ``/resume`` pops socket handoffs from (None: inline handoffs only)."""

    def __init__(self, scheduler: Scheduler, host: str = "127.0.0.1",
                 port: int = 0, request_timeout_s: float = 30.0,
                 max_body_bytes: int = 256 << 20, verbose: bool = False,
                 shed_deadline_aware: bool = True,
                 retry_after_cap_s: float = 60.0, on_poison=None,
                 kv_server=None):
        self.scheduler = scheduler
        self.kv_server = kv_server
        self.request_timeout_s = float(request_timeout_s)
        self.max_body_bytes = int(max_body_bytes)
        self.verbose = verbose
        self.shed_deadline_aware = bool(shed_deadline_aware)
        self.retry_after_cap_s = float(retry_after_cap_s)
        self._draining = False
        self.loop = EngineLoop(scheduler, on_poison=on_poison).start()
        self.httpd = _Server((host, port), _Handler)
        self.httpd.daemon_threads = True
        self.httpd.front = self
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    @property
    def draining(self) -> bool:
        return self._draining

    def _retry_after(self) -> int:
        """Retry-After seconds for a 429 or 503, from the scheduler's
        measured drain rate."""
        return self.scheduler.retry_after_s(self.retry_after_cap_s)

    def start(self) -> "FrontDoor":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="serve-http")
        self._thread.start()
        return self

    def stop(self) -> None:
        self.loop.stop()
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    def health(self) -> Dict[str, Any]:
        eng = self.scheduler.engine
        status = "draining" if self._draining else "ok"
        if not self.loop.alive and not self._draining:
            status = "degraded"
        out: Dict[str, Any] = {
            "status": status,
            "role": eng.role,
            "device": str(eng.device),
            "queue_depth": self.scheduler.queue_depth(),
            "active": self.scheduler.active_count(),
            "max_batch": eng.ecfg.max_batch,
            "buckets": list(eng.buckets),
            "weight_dtype": eng.ecfg.weight_dtype,
            "fused_decode": eng.ecfg.fused_decode,
            "loop_alive": self.loop.alive,
            "loop_faults": self.loop.faults,
        }
        if self.loop.last_fault is not None:
            out["loop_last_fault"] = self.loop.last_fault
        # per-span-name percentile rollups (queue wait, prefill, decode
        # ticks, evictions, whole requests) off the tracer's ring
        out["span_rollups_ms"] = {
            k: v for k, v in _spans.default_tracer().summary().items()
            if k.startswith("serve/")}
        # a poisoned engine outranks everything: no request will succeed
        # again, so a supervisor recycles the replica on this status
        poisoned = getattr(eng, "poisoned", None) or self.loop.poison_reason
        if poisoned:
            out["status"] = "poisoned"
            out["engine_poisoned"] = str(poisoned)
        return out

    def drain(self, timeout_s: float = 60.0) -> bool:
        """Refuse new work (503), let in-flight requests finish, then
        stop. Returns True when everything finished inside the timeout.
        Its wall time is the goodput ledger's ``drain``."""
        with _goodput.timer("drain"):
            return self._drain(timeout_s)

    def _drain(self, timeout_s: float) -> bool:
        self._draining = True
        self.scheduler.begin_drain()
        self.loop.wake()
        end = time.monotonic() + timeout_s
        while time.monotonic() < end and self.scheduler.pending():
            time.sleep(0.01)
        ok = self.scheduler.pending() == 0
        self.stop()
        return ok
