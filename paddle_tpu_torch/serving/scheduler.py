"""Continuous (in-flight) batching scheduler over the decode engine — the
port of ``paddle_tpu/serving/scheduler.py`` for the slab layout.

Requests join and leave the static ``[max_batch]`` decode batch at TOKEN
boundaries: each :meth:`Scheduler.step` expires queued requests whose
deadline passed, admits queued requests FIFO into free slots (prefill
through the bucket ladder — the prefill's logits give the first token),
then runs one decode step for every live slot. A request finishes on
EOS, on ``max_new_tokens``, when its slot reaches ``max_seq``, or when its
deadline passes (partial tokens kept).

Threading contract: ``submit``/``cancel`` may be called from any thread
(the HTTP front door's handler pool); ``step``/``drain`` run on exactly
one loop thread. Completion is signaled through a per-request
``threading.Event``. ``abort_all(refuse_new=True)`` sets its refusal flag
under the queue lock before draining the queue, so a racing submit is
either failed with the rest or refused — never parked.

The KV handoff, prefix blobs, preemption, head-of-line bypass (paged
engines only), spans, goodput and trace context of the JAX scheduler are
still to be ported (ROADMAP.md, queue A).
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np

from ..device import resolve_device
from . import metrics as smetrics
from .engine import DecodeEngine
from .kv_cache import CacheFullError
from .sampling import GREEDY, SamplingParams

__all__ = ["Request", "Scheduler", "SchedulerConfig", "QueueFullError"]


class QueueFullError(RuntimeError):
    """Admission queue at capacity — the front door maps this to 429."""


# request lifecycle
QUEUED, ACTIVE, DONE, EXPIRED, FAILED, CANCELLED = (
    "queued", "active", "done", "expired", "failed", "cancelled")

_ids = itertools.count(1)


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int
    deadline: float                       # absolute time.monotonic()
    sampling: SamplingParams = GREEDY
    id: int = dataclasses.field(default_factory=lambda: next(_ids))
    submitted: float = dataclasses.field(default_factory=time.monotonic)
    state: str = QUEUED
    slot: Optional[int] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    token_times: List[float] = dataclasses.field(default_factory=list)
    ttft_ms: Optional[float] = None
    error: Optional[str] = None
    finished: threading.Event = dataclasses.field(
        default_factory=threading.Event)

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.finished.wait(timeout)

    @property
    def tpot_ms(self) -> Optional[float]:
        """Mean per-token latency after the first token."""
        if len(self.token_times) < 2:
            return None
        return float(np.mean(np.diff(self.token_times)) * 1e3)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    max_queue: int = 64               # queued (not yet admitted) requests
    default_timeout_s: float = 30.0   # per-request deadline when unset
    max_new_tokens_cap: int = 1024    # server-side clamp


class Scheduler:
    def __init__(self, engine: DecodeEngine,
                 cfg: Optional[SchedulerConfig] = None, device="cuda"):
        dev = resolve_device(device)
        if dev.type != engine.device.type:
            raise ValueError(f"scheduler device {dev} does not match the "
                             f"engine's {engine.device}")
        self.engine = engine
        self.cfg = cfg or SchedulerConfig()
        self._queue: Deque[Request] = deque()
        self._active: Dict[int, Request] = {}     # slot -> request
        self._next_token: Dict[int, int] = {}     # slot -> token to feed
        self._lock = threading.Lock()
        self._draining = False
        self._refusing: Optional[str] = None
        self.completed = 0
        role = getattr(engine, "role", "colocated")
        self._ttft_hist = smetrics.m_ttft_ms.labels("prefill", role)
        self._tpot_hist = smetrics.m_tpot_ms.labels("decode", role)

    # ------------------------------------------------------------------
    # producer side (any thread)
    # ------------------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               timeout_s: Optional[float] = None,
               sampling: Optional[SamplingParams] = None) -> Request:
        """Enqueue a request; raises QueueFullError on backpressure,
        PromptTooLongError for prompts above the bucket ladder, and
        RuntimeError once draining or refusing."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        self.engine.bucket_for(len(prompt))    # 400 now, not at admission
        max_new = max(1, min(int(max_new_tokens),
                             self.cfg.max_new_tokens_cap))
        timeout = (self.cfg.default_timeout_s if timeout_s is None
                   else float(timeout_s))
        req = Request(prompt=prompt, max_new_tokens=max_new,
                      deadline=time.monotonic() + timeout,
                      sampling=sampling or GREEDY)
        with self._lock:
            if self._refusing is not None:
                raise RuntimeError(self._refusing)
            if self._draining:
                raise RuntimeError("scheduler is draining")
            if len(self._queue) >= self.cfg.max_queue:
                raise QueueFullError(
                    f"admission queue at capacity ({self.cfg.max_queue})")
            self._queue.append(req)
            smetrics.m_queue_depth.set(len(self._queue))
        return req

    def cancel(self, req: Request) -> bool:
        """Cancel a QUEUED request (active ones finish their current
        token and are evicted by deadline instead)."""
        with self._lock:
            if req.state == QUEUED and req in self._queue:
                self._queue.remove(req)
                smetrics.m_queue_depth.set(len(self._queue))
                self._finish(req, CANCELLED)
                return True
        return False

    # ------------------------------------------------------------------
    # loop side (one thread)
    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One serving tick: expire -> admit -> decode. Returns True when
        any work happened (False = idle, the loop may sleep)."""
        now = time.monotonic()
        self._expire_queued(now)
        admitted = self._admit()
        decoded = self._decode(now)
        smetrics.m_occupancy.set(self.engine.cache.occupancy)
        smetrics.m_active.set(len(self._active))
        return bool(admitted or decoded)

    def begin_drain(self) -> None:
        """Refuse every later submit; queued and active requests stay."""
        with self._lock:
            self._draining = True

    def drain(self, timeout_s: float = 60.0) -> bool:
        """Stop admitting new requests and tick until every queued and
        active request finished (or the timeout hits)."""
        self.begin_drain()
        end = time.monotonic() + timeout_s
        while time.monotonic() < end:
            if self.pending() == 0:
                return True
            self.step()
        return False

    def abort_all(self, reason: str, refuse_new: bool = False) -> int:
        """Fail every queued and active request (the loop's fault path);
        returns how many were failed. ``refuse_new`` also refuses every
        later submit with ``reason``."""
        with self._lock:
            if refuse_new:
                self._refusing = reason
            queued = list(self._queue)
            self._queue.clear()
            smetrics.m_queue_depth.set(0)
        n = 0
        for slot in list(self._active):
            self._evict(slot, FAILED, reason)
            n += 1
        for req in queued:
            self._finish(req, FAILED, reason)
            n += 1
        smetrics.m_active.set(0)
        return n

    @property
    def draining(self) -> bool:
        return self._draining

    def pending(self) -> int:
        with self._lock:
            return len(self._queue) + len(self._active)

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def active_count(self) -> int:
        return len(self._active)

    # ------------------------------------------------------------------
    def _expire_queued(self, now: float) -> None:
        with self._lock:
            keep: Deque[Request] = deque()
            for req in self._queue:
                if req.deadline <= now:
                    self._finish(req, EXPIRED,
                                 "deadline exceeded while queued")
                else:
                    keep.append(req)
            self._queue = keep
            smetrics.m_queue_depth.set(len(self._queue))

    def _pop_admissible(self) -> Optional[Request]:
        """FIFO pop of the head, when the engine can admit it now."""
        with self._lock:
            if not self._queue or not self.engine.can_admit(
                    len(self._queue[0].prompt)):
                return None
            req = self._queue.popleft()
            smetrics.m_queue_depth.set(len(self._queue))
            return req

    def _admit(self) -> int:
        """Prefill queued requests into free slots, FIFO."""
        admitted = 0
        while True:
            req = self._pop_admissible()
            if req is None:
                break
            t_admit = time.monotonic()
            try:
                slot, _logits, first = self.engine.start_sequence_sampled(
                    req.prompt, req.sampling)
            except CacheFullError:
                with self._lock:
                    self._queue.appendleft(req)
                break
            except Exception as e:
                self._finish(req, FAILED, f"{type(e).__name__}: {e}")
                continue
            smetrics.m_queue_wait_ms.observe(
                (t_admit - req.submitted) * 1e3)
            t = time.monotonic()
            req.state = ACTIVE
            req.slot = slot
            req.tokens.append(int(first))
            req.token_times.append(t)
            req.ttft_ms = (t - req.submitted) * 1e3
            self._ttft_hist.observe(req.ttft_ms)
            self.engine.note_tokens(1)
            self._active[slot] = req
            self._next_token[slot] = int(first)
            admitted += 1
            if self._should_finish(req, int(first)):
                self._evict(slot, DONE)
            elif self.engine.cache.headroom(slot) < 1:
                # the prompt filled the slot: the prefill already produced
                # the one token that fits
                self._evict(slot, DONE, "max_seq reached", reason="max_seq")
        return admitted

    def _decode(self, now: float) -> bool:
        for slot in list(self._active):
            if self._active[slot].deadline <= now:
                self._evict(slot, EXPIRED,
                            "deadline exceeded mid-generation")
        if not self._active:
            return False
        feed = {slot: self._next_token[slot] for slot in self._active}
        params = {slot: req.sampling for slot, req in self._active.items()}
        out = self.engine.generate_step(feed, params)
        t = time.monotonic()
        for slot, emitted in out.items():
            req = self._active.get(slot)
            if req is None:
                continue
            finished = False
            for tok in emitted:
                tok = int(tok)
                req.tokens.append(tok)
                self._tpot_hist.observe((t - req.token_times[-1]) * 1e3)
                req.token_times.append(t)
                self._next_token[slot] = tok
                if self._should_finish(req, tok):
                    self._evict(slot, DONE)
                    finished = True
                    break
            if not finished and self.engine.cache.headroom(slot) < 1:
                self._evict(slot, DONE, "max_seq reached", reason="max_seq")
        return True

    def _should_finish(self, req: Request, last_token: int) -> bool:
        eos = self.engine.ecfg.eos_id
        if eos is not None and last_token == eos:
            return True
        return len(req.tokens) >= req.max_new_tokens

    _EVICT_REASONS = {DONE: "done", EXPIRED: "deadline", FAILED: "failed"}

    def _evict(self, slot: int, state: str, detail: Optional[str] = None,
               reason: Optional[str] = None) -> None:
        req = self._active.pop(slot)
        self._next_token.pop(slot, None)
        self.engine.free_sequence(slot)
        smetrics.m_evictions.labels(
            reason or self._EVICT_REASONS.get(state, state)).inc()
        self._finish(req, state, detail)

    def _finish(self, req: Request, state: str,
                detail: Optional[str] = None) -> None:
        req.state = state
        if detail and state in (EXPIRED, FAILED):
            req.error = detail
        if state == DONE:
            self.completed += 1
        req.finished.set()
