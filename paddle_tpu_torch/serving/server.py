"""HTTP front door for the serving engine — the port of the engine
backend of ``paddle_tpu/serving/server.py``.

``POST /generate`` with ``{"prompt": [token ids], "max_new_tokens": N,
"timeout_s": T}`` (plus optional ``temperature``/``top_k``/``top_p``/
``seed``) queues into the continuous-batching scheduler; a loop thread
(:class:`EngineLoop`) ticks it, the handler thread waits on the request.

- bounded admission: queue full -> **429** with a JSON error body;
- malformed input or a prompt above the bucket ladder -> **400**;
- deadline blown -> **504** with the partial tokens;
- draining (:meth:`FrontDoor.drain`) -> **503**; in-flight work finishes;
- internal failure -> **500**, always with a JSON body.

``GET /health`` reports the phase, queue depth, active slots and the
loop's fault count. The predictor route, ``/prefill``/``/resume``,
``/metrics`` and deadline-aware shedding are still to be ported
(ROADMAP.md, queue A).
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from . import metrics as smetrics
from .engine import PromptTooLongError
from .sampling import SamplingParams
from .scheduler import QueueFullError, Scheduler

__all__ = ["FrontDoor", "EngineLoop"]


class EngineLoop:
    """Background thread ticking ``scheduler.step()``; parks on an event
    when idle. A ``step()`` exception fails every queued and active
    request (their waiters wake with an error), is recorded in
    ``faults``/``last_fault`` (surfaced by ``/health``), and the loop
    keeps ticking."""

    def __init__(self, scheduler: Scheduler, idle_sleep_s: float = 0.002):
        self.scheduler = scheduler
        self.idle_sleep_s = idle_sleep_s
        self.faults = 0
        self.last_fault: Optional[str] = None
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
            worked = False
            if self.scheduler.pending():
                try:
                    worked = self.scheduler.step()
                except Exception as e:
                    self.faults += 1
                    self.last_fault = f"{type(e).__name__}: {e}"
                    self.scheduler.abort_all(
                        f"engine loop fault: {self.last_fault}")
            if not worked:
                self._wake.wait(timeout=self.idle_sleep_s)
                self._wake.clear()


class _Server(ThreadingHTTPServer):
    # the stdlib default listen backlog (5) resets connections under a
    # burst of connects; answer them with 429s instead
    request_queue_size = 128


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        if self.server.front.verbose:
            super().log_message(fmt, *args)

    def _json(self, code: int, obj: Dict[str, Any]) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
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
        self._json(404, {"error": f"unknown path {self.path!r}"})

    def do_POST(self):
        if self.path == "/generate":
            return self._generate(self.server.front)
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
            return self._json(503, {"error": "server is draining"})
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
            request = front.scheduler.submit(
                prompt, max_new_tokens=int(req_obj.get("max_new_tokens",
                                                       16)),
                timeout_s=timeout_s, sampling=self._parse_sampling(req_obj))
        except QueueFullError as e:
            return self._json(429, {"error": str(e)})
        except PromptTooLongError as e:
            return self._json(400, {"error": str(e)})
        except (TypeError, ValueError) as e:
            return self._json(400, {"error": f"{type(e).__name__}: {e}"})
        except RuntimeError as e:
            # draining raced the check above, or the scheduler refuses
            return self._json(503, {"error": str(e)})
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


class FrontDoor:
    """The serving HTTP server over one scheduler (and its engine)."""

    def __init__(self, scheduler: Scheduler, host: str = "127.0.0.1",
                 port: int = 0, request_timeout_s: float = 30.0,
                 max_body_bytes: int = 16 << 20, verbose: bool = False):
        self.scheduler = scheduler
        self.request_timeout_s = float(request_timeout_s)
        self.max_body_bytes = int(max_body_bytes)
        self.verbose = verbose
        self._draining = False
        self.loop = EngineLoop(scheduler).start()
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
        return out

    def drain(self, timeout_s: float = 60.0) -> bool:
        """Refuse new work (503), let in-flight requests finish, then
        stop. Returns True when everything finished inside the timeout."""
        self._draining = True
        self.scheduler.begin_drain()
        self.loop.wake()
        end = time.monotonic() + timeout_s
        while time.monotonic() < end and self.scheduler.pending():
            time.sleep(0.01)
        ok = self.scheduler.pending() == 0
        self.stop()
        return ok
