"""Continuous (in-flight) batching scheduler over the decode engine — the
port of ``paddle_tpu/serving/scheduler.py``.

Requests join and leave the static ``[max_batch]`` decode batch at TOKEN
boundaries: each :meth:`Scheduler.step` expires queued requests whose
deadline passed, admits queued requests into free slots (prefill through
the bucket ladder — the prefill's logits give the first token), then runs
one decode step for every live slot. A request finishes on EOS, on
``max_new_tokens``, when its slot reaches ``max_seq``, or when its
deadline passes (partial tokens kept).

Admission is FIFO with a bounded head-of-line bypass: when the head does
not fit the engine's slot/page budget, the first later request that fits
goes first, until the head has been bypassed ``hol_starvation_limit``
times and pins the queue. On a paged engine the pages each tick writes
are mapped before the tick; when the pool cannot cover a slot, the
youngest request is preempted — its pages freed, itself requeued at the
head — and later resumes by re-prefilling its prompt and the tokens it
already generated (the engine replays past the ladder through the decode
tick).

Every terminal request stamps the time it finished; the measured drain
rate over a trailing window gives the queue's ETA, which the front door's
deadline-aware shedding and ``Retry-After`` answers are computed from
(:meth:`Scheduler.drain_rate`, :meth:`~Scheduler.queue_eta_s`,
:meth:`~Scheduler.retry_after_s`).

Threading contract: ``submit``/``cancel`` may be called from any thread
(the HTTP front door's handler pool); ``step``/``drain`` run on exactly
one loop thread. Completion is signaled through a per-request
``threading.Event``. ``abort_all(refuse_new=True)`` sets its refusal flag
under the queue lock before draining the queue, so a racing submit is
either failed with the rest or refused — never parked.

Disaggregated serving (``scheduler.py:94-102``, ``:187-362``, ``:514-590``
of the reference): a ``prefill_only`` request finishes at its first token
with its KV state exported into ``req.handoff`` and its slot freed; the
router hands that payload to a decode replica's
:meth:`Scheduler.submit_handoff`, whose loop adopts it at the START of
its next tick (the only context that may write the cache), retrying
while no slot or page is free and expiring it when its deadline passes
first. A migrated request carries its prompt, so a preemption on the
decode replica re-prefills ``gen_prompt()`` like any other. A
``prefix_blob`` (a gang-shared prefix record) is adopted into the local
pool just before the request prefills.

Spans (``observability/spans.py``), as the reference records them: each
request is one trace — a ``serve/request`` root (a dur-0 ``open`` sentinel
at submit, the full record at its end), and under it ``serve/queue_wait``
(submit -> admission), the engine's ``serve/prefill``, one
``serve/decode_tick`` per tick it rides (the tick's wall time: the tick
syncs on its sampled tokens, so it covers the device) and ``serve/evict``.
``submit(trace_ctx=)`` joins a trace from the wire instead of rooting a
new one; a prefill-only request's handoff carries its context under
``spans.WIRE_KEY``, which ``submit_handoff`` adopts. ``drain`` runs under
the goodput ledger's ``drain`` timer.
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
from ..observability import goodput as _goodput
from ..observability import spans as _spans
from . import metrics as smetrics
from .engine import DecodeEngine
from .kv_cache import CacheFullError
from .kv_transfer import adopt_prefix
from .paged_kv import PagePoolFullError
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
    # head-of-line bookkeeping: how many times a fitting request was
    # admitted past this one while it sat at the queue head
    hol_skips: int = 0
    # preempted (page pool dry): resumes by re-prefilling gen_prompt()
    preempted: bool = False
    # disaggregated serving: a prefill_only request finishes at the first
    # token with its KV serialized into ``handoff``; on the decode side the
    # same field carries the payload awaiting adoption. ``prefix_blob`` is
    # a gang-shared prefix record adopted before this request prefills.
    prefill_only: bool = False
    handoff: Optional[dict] = None
    prefix_blob: Optional[dict] = None
    finished: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    # span identity: every lifecycle span of this request carries trace_id
    # and parents under root_span ("serve/request"); a request that came
    # with a wire context keeps the sender's trace and parents its root
    # under parent_span
    trace_id: int = dataclasses.field(default_factory=_spans.gen_id)
    root_span: int = dataclasses.field(default_factory=_spans.gen_id)
    parent_span: Optional[int] = None
    submit_ns: int = dataclasses.field(
        default_factory=time.perf_counter_ns)

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.finished.wait(timeout)

    def gen_prompt(self) -> List[int]:
        """The token stream a (re-)prefill must cover: the prompt plus
        everything generated before a preemption."""
        return self.prompt + self.tokens

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
    # how many times the FIFO head may be bypassed by later, fitting
    # requests before it pins the queue (the starvation bound)
    hol_starvation_limit: int = 32


def _trace_kw(ctx: Optional[_spans.Context]) -> dict:
    """Request fields for a wire trace context (none for a fresh trace)."""
    if ctx is None:
        return {}
    return {"trace_id": int(ctx[0]), "parent_span": int(ctx[1])}


def _open_root(req: Request) -> None:
    """The dur-0 ``open`` sentinel of the request's root span, superseded
    by the full record at its end: a process killed mid-request has
    already flushed its children's parent, so the trace still stitches."""
    _spans.record("serve/request", req.submit_ns, 0, trace=req.trace_id,
                  parent=req.parent_span, span_id=req.root_span,
                  attrs={"open": True})


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
        self._admit_order: List[int] = []         # slots, oldest first
        self._lock = threading.Lock()
        self._draining = False
        self._refusing: Optional[str] = None
        self.completed = 0
        self.preemptions = 0
        # terminal-event times feeding the measured drain rate (own lock:
        # _finish runs under self._lock on some paths)
        self._rate_lock = threading.Lock()
        self._done_times: Deque[float] = deque(maxlen=256)
        # migrated requests awaiting KV adoption, taken at the START of a
        # tick on the loop thread (adoption writes the cache)
        self._pending_handoffs: Deque[Request] = deque()
        role = getattr(engine, "role", "colocated")
        self._ttft_hist = smetrics.m_ttft_ms.labels("prefill", role)
        self._tpot_hist = smetrics.m_tpot_ms.labels("decode", role)

    # ------------------------------------------------------------------
    # producer side (any thread)
    # ------------------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               timeout_s: Optional[float] = None,
               sampling: Optional[SamplingParams] = None,
               prefill_only: bool = False,
               prefix_blob: Optional[dict] = None,
               trace_ctx: Optional[_spans.Context] = None) -> Request:
        """Enqueue a request; raises QueueFullError on backpressure,
        PromptTooLongError for prompts above the bucket ladder, and
        RuntimeError once draining or refusing.

        ``prefill_only=True`` stops the request at its first token: its KV
        state is exported into ``req.handoff`` and the slot released, for
        the caller to migrate to a decode replica (:meth:`submit_handoff`).
        ``prefix_blob`` is a gang-shared prefix record adopted into the
        local pool right before the prefill (best effort). ``trace_ctx``
        ((trace_id, parent_span), from ``spans.extract``) joins an
        existing trace instead of rooting a fresh one."""
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
                      sampling=sampling or GREEDY,
                      prefill_only=bool(prefill_only),
                      prefix_blob=prefix_blob, **_trace_kw(trace_ctx))
        with self._lock:
            self._check_open()
            if len(self._queue) >= self.cfg.max_queue:
                raise QueueFullError(
                    f"admission queue at capacity ({self.cfg.max_queue})")
            self._queue.append(req)
            smetrics.m_queue_depth.set(len(self._queue))
        _open_root(req)
        return req

    def submit_handoff(self, handoff: dict, first_token: int,
                       max_new_tokens: int = 16,
                       timeout_s: Optional[float] = None,
                       sampling: Optional[SamplingParams] = None,
                       prompt: Optional[Sequence[int]] = None,
                       trace_ctx: Optional[_spans.Context] = None
                       ) -> Request:
        """Enqueue a MIGRATED request: the prefill replica produced
        ``first_token`` and exported its KV into ``handoff``; this
        scheduler adopts the payload at the start of its next tick and
        decodes from there. The request is seeded with the first token, so
        its finish counting and greedy stream are the colocated path's. Its
        prompt (``prompt``, else the handoff's ``tokens``) is required: a
        preemption here re-prefills it. The pending handoffs are capped at
        ``max_queue`` (QueueFullError). Without ``trace_ctx`` the request
        joins the trace the handoff carries (stamped at export), so both
        halves of a migrated request are one trace."""
        prompt = [int(t) for t in (prompt if prompt is not None
                                   else (handoff.get("tokens") or []))]
        if not prompt:
            raise ValueError("handoff carries no prompt tokens — "
                             "preemption resume would be impossible")
        max_new = max(1, min(int(max_new_tokens),
                             self.cfg.max_new_tokens_cap))
        timeout = (self.cfg.default_timeout_s if timeout_s is None
                   else float(timeout_s))
        if trace_ctx is None:
            trace_ctx = _spans.extract(handoff)
        req = Request(prompt=prompt, max_new_tokens=max_new,
                      deadline=time.monotonic() + timeout,
                      sampling=sampling or GREEDY, handoff=handoff,
                      **_trace_kw(trace_ctx))
        req.tokens.append(int(first_token))
        req.token_times.append(time.monotonic())
        with self._lock:
            self._check_open()
            if len(self._pending_handoffs) >= self.cfg.max_queue:
                raise QueueFullError(
                    f"handoff queue at capacity ({self.cfg.max_queue})")
            self._pending_handoffs.append(req)
        _open_root(req)
        return req

    def _check_open(self) -> None:
        """Under ``self._lock``: refuse while refusing or draining."""
        if self._refusing is not None:
            raise RuntimeError(self._refusing)
        if self._draining:
            raise RuntimeError("scheduler is draining")

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
        """One serving tick: expire -> adopt handoffs -> admit -> decode.
        Returns True when any work happened (False = idle, the loop may
        sleep)."""
        now = time.monotonic()
        self._expire_queued(now)
        ingested = self._ingest_handoffs(now)
        admitted = self._admit()
        decoded = self._decode(now)
        smetrics.m_occupancy.set(self.engine.cache.occupancy)
        smetrics.m_active.set(len(self._active))
        return bool(ingested or admitted or decoded)

    def _ingest_handoffs(self, now: float) -> int:
        """Adopt migrated requests' KV into the cache, oldest first, at the
        tick's start on the loop thread. One past its deadline expires; no
        free slot or page leaves it (and those behind it) for the next
        tick; any other failure fails it."""
        n = 0
        while True:
            with self._lock:
                if not self._pending_handoffs:
                    break
                req = self._pending_handoffs[0]
            if req.deadline <= now:
                with self._lock:
                    self._pending_handoffs.popleft()
                self._finish(req, EXPIRED,
                             "deadline exceeded before KV adoption")
                continue
            try:
                # adoption records serve/kv_adopt under the request's root
                with _spans.default_tracer().context(
                        (req.trace_id, req.root_span)):
                    slot = self.engine.adopt_request_kv(req.handoff)
            except (CacheFullError, PagePoolFullError):
                break              # slot or pool pressure: retry next tick
            except Exception as e:
                with self._lock:
                    self._pending_handoffs.popleft()
                self._finish(req, FAILED, f"{type(e).__name__}: {e}")
                continue
            with self._lock:
                self._pending_handoffs.popleft()
            req.handoff = None
            req.state = ACTIVE
            req.slot = slot
            self._active[slot] = req
            self._next_token[slot] = req.tokens[-1]
            self._admit_order.append(slot)
            n += 1
        return n

    def begin_drain(self) -> None:
        """Refuse every later submit; queued and active requests stay."""
        with self._lock:
            self._draining = True

    def drain(self, timeout_s: float = 60.0) -> bool:
        """Stop admitting new requests and tick until every queued and
        active request finished (or the timeout hits)."""
        self.begin_drain()
        end = time.monotonic() + timeout_s
        # drain wall time is its own goodput category: the engine finishes
        # old work and admits nothing
        with _goodput.timer("drain"):
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
            queued = list(self._queue) + list(self._pending_handoffs)
            self._queue.clear()
            self._pending_handoffs.clear()
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

    @property
    def refusing(self) -> Optional[str]:
        """The reason every submit is refused (``abort_all(refuse_new=
        True)``), else None."""
        return self._refusing

    def pending(self) -> int:
        """Queued, pending-handoff and active requests."""
        with self._lock:
            return (len(self._queue) + len(self._pending_handoffs)
                    + len(self._active))

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def active_count(self) -> int:
        return len(self._active)

    # ------------------------------------------------------------------
    # measured drain rate -> deadline-aware shedding / Retry-After
    # ------------------------------------------------------------------
    def drain_rate(self, window_s: float = 10.0) -> Optional[float]:
        """Terminal requests per second over the trailing window — the
        rate the admission queue actually drains at. None until two
        requests have finished (no measurable rate yet)."""
        now = time.monotonic()
        with self._rate_lock:
            recent = [t for t in self._done_times if t >= now - window_s]
        if len(recent) < 2:
            return None
        return len(recent) / max(now - recent[0], 1e-6)

    def queue_eta_s(self) -> Optional[float]:
        """Estimated seconds until a request submitted now reaches a
        decode slot: queue depth over the measured drain rate. 0.0 for an
        empty queue; None while the rate is not measurable."""
        with self._lock:
            depth = len(self._queue)
        if depth == 0:
            return 0.0
        rate = self.drain_rate()
        if rate is None or rate <= 0:
            return None
        return depth / rate

    def retry_after_s(self, cap_s: float = 60.0) -> int:
        """Whole seconds a shed client should wait before retrying, from
        the measured drain rate (at least 1, at most ``cap_s``)."""
        eta = self.queue_eta_s()
        if eta is None:
            return 1
        return int(min(max(1.0, np.ceil(eta)), cap_s))

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
        """FIFO pop with a bounded head-of-line bypass: the first request
        whose stream fits the current slot/page budget. A head bypassed
        up to the starvation limit pins the queue until it fits."""
        with self._lock:
            if not self._queue:
                return None
            head = self._queue[0]
            for i, req in enumerate(self._queue):
                if i > 0 and head.hol_skips >= self.cfg.hol_starvation_limit:
                    return None       # head pinned: wait for its budget
                if self.engine.can_admit(len(req.gen_prompt())):
                    del self._queue[i]
                    smetrics.m_queue_depth.set(len(self._queue))
                    if i > 0:
                        head.hol_skips += 1
                        smetrics.m_hol_admits.inc()
                    return req
            return None

    def _admit(self) -> int:
        """Prefill queued requests into free slots (FIFO with the bypass
        above); a preempted request resumes by recompute."""
        admitted = 0
        while self.engine.cache.free_slot_count() > 0:
            req = self._pop_admissible()
            if req is None:
                break
            t_admit = time.monotonic()
            t_admit_ns = time.perf_counter_ns()
            if req.prefix_blob is not None:
                # a gang-shared prefix record: adopt it into the local pool
                # so the prefill below hits it. Best effort — a failure
                # means a cold prefill, nothing worse.
                blob, req.prefix_blob = req.prefix_blob, None
                try:
                    adopt_prefix(self.engine, blob)
                except Exception:
                    pass
            try:
                # inside the request's context, so the engine's
                # serve/prefill span parents under its root
                with _spans.default_tracer().context(
                        (req.trace_id, req.root_span)):
                    if req.preempted:
                        # may exceed the ladder: the engine replays the
                        # known stream's tail through the decode tick
                        slot, _logits, first = \
                            self.engine.resume_sequence_sampled(
                                req.gen_prompt(), req.sampling)
                    else:
                        slot, _logits, first = \
                            self.engine.start_sequence_sampled(
                                req.prompt, req.sampling)
            except (CacheFullError, PagePoolFullError):
                # raced slot or page budget: requeue at the head
                with self._lock:
                    self._queue.appendleft(req)
                    smetrics.m_queue_depth.set(len(self._queue))
                break
            except Exception as e:
                self._finish(req, FAILED, f"{type(e).__name__}: {e}")
                continue
            _spans.record("serve/queue_wait", req.submit_ns,
                          t_admit_ns - req.submit_ns,
                          trace=req.trace_id, parent=req.root_span)
            t = time.monotonic()
            req.state = ACTIVE
            req.slot = slot
            req.tokens.append(int(first))
            req.token_times.append(t)
            if req.preempted:
                # the resumed prefill covered prompt + generated tokens;
                # its sampled token is the next output token
                req.preempted = False
            else:
                smetrics.m_queue_wait_ms.observe(
                    (t_admit - req.submitted) * 1e3)
                req.ttft_ms = (t - req.submitted) * 1e3
                self._ttft_hist.observe(req.ttft_ms)
                self.engine.note_tokens(1)
            self._active[slot] = req
            if req.prefill_only:
                # the first-token boundary of a disaggregated request:
                # export the prompt's KV here on the loop thread, free the
                # slot and finish — the router migrates req.handoff
                admitted += 1
                try:
                    req.handoff = self.engine.export_request_kv(
                        slot, tokens=req.prompt)
                    # the frame carries the trace: the decode replica's
                    # half of the request lands in the same one
                    req.handoff[_spans.WIRE_KEY] = _spans.inject(
                        (req.trace_id, req.root_span))
                except Exception as e:
                    self._evict(slot, FAILED, f"{type(e).__name__}: {e}")
                    continue
                self._evict(slot, DONE, reason="handoff")
                continue
            self._next_token[slot] = int(first)
            self._admit_order.append(slot)
            admitted += 1
            if self._should_finish(req, int(first)):
                self._evict(slot, DONE)
            elif self.engine.cache.headroom(slot) < self._min_headroom():
                # the prompt filled the slot (to within a speculative
                # window): the prefill produced the one token that fits
                self._evict(slot, DONE, "max_seq reached", reason="max_seq")
        return admitted

    def _preempt_youngest(self, exclude_slot: Optional[int] = None) -> bool:
        """Free the most recently admitted active request's pages and
        requeue it at the queue head for a recompute resume. Returns False
        when there is nothing (else) to preempt."""
        for slot in reversed(self._admit_order):
            if slot == exclude_slot or slot not in self._active:
                continue
            req = self._active.pop(slot)
            self._next_token.pop(slot, None)
            self._admit_order.remove(slot)
            self.engine.free_sequence(slot)
            req.state = QUEUED
            req.slot = None
            req.preempted = True
            smetrics.m_preemptions.labels("page_pool").inc()
            self.preemptions += 1
            with self._lock:
                self._queue.appendleft(req)
                smetrics.m_queue_depth.set(len(self._queue))
            return True
        return False

    def _ensure_step_capacity(self) -> None:
        """Map the pages this tick writes BEFORE the batched call, oldest
        request first; preempt the youngest while the pool cannot cover a
        slot. A request that alone exceeds the pool fails instead of
        livelocking."""
        for slot in sorted(self._active, key=self._admit_order.index):
            if slot not in self._active:      # preempted by an earlier
                continue                      # iteration's squeeze
            while not self.engine.ensure_decode_capacity(slot):
                if not self._preempt_youngest(exclude_slot=slot):
                    self._evict(slot, FAILED, "KV page pool exhausted",
                                reason="failed")
                    break

    def _decode(self, now: float) -> bool:
        for slot in list(self._active):
            if self._active[slot].deadline <= now:
                self._evict(slot, EXPIRED,
                            "deadline exceeded mid-generation")
        if not self._active:
            return False
        self._ensure_step_capacity()
        if not self._active:
            return False
        feed = {slot: self._next_token[slot] for slot in self._active}
        params = {slot: req.sampling for slot, req in self._active.items()}
        t_tick0 = time.perf_counter_ns()
        out = self.engine.generate_step(feed, params)
        tick_ns = time.perf_counter_ns() - t_tick0
        t = time.monotonic()
        trace_on = _spans.tracing_enabled()
        for slot, emitted in out.items():
            req = self._active.get(slot)
            if req is None:
                continue
            if trace_on:
                # every rider of the batched call gets the tick's wall
                # time (a speculative tick emits several tokens)
                _spans.record("serve/decode_tick", t_tick0, tick_ns,
                              trace=req.trace_id, parent=req.root_span,
                              attrs={"batch": len(out),
                                     "emitted": len(emitted),
                                     "token_index": len(req.tokens)})
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
            if (not finished and self.engine.cache.headroom(slot)
                    < self._min_headroom()):
                self._evict(slot, DONE, "max_seq reached", reason="max_seq")
        return True

    def _min_headroom(self) -> int:
        """The slot headroom a generation step needs: 1, or a speculative
        engine's verify window (``scheduler.py:600-606``, ``:693-696``)."""
        return getattr(self.engine, "min_headroom", 1)

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
        if slot in self._admit_order:
            self._admit_order.remove(slot)
        t0 = time.perf_counter_ns()
        self.engine.free_sequence(slot)
        reason = reason or self._EVICT_REASONS.get(state, state)
        smetrics.m_evictions.labels(reason).inc()
        _spans.record("serve/evict", t0, time.perf_counter_ns() - t0,
                      trace=req.trace_id, parent=req.root_span,
                      attrs={"reason": reason, "slot": slot})
        self._finish(req, state, detail)

    def _finish(self, req: Request, state: str,
                detail: Optional[str] = None) -> None:
        req.state = state
        if detail and state in (EXPIRED, FAILED):
            req.error = detail
        if state == DONE:
            self.completed += 1
        with self._rate_lock:
            self._done_times.append(time.monotonic())
        # close the root span (submit -> terminal state) under the id the
        # lifecycle spans parented to
        _spans.record("serve/request", req.submit_ns,
                      time.perf_counter_ns() - req.submit_ns,
                      trace=req.trace_id, parent=req.parent_span,
                      span_id=req.root_span,
                      attrs={"state": state, "tokens": len(req.tokens),
                             "request_id": req.id})
        req.finished.set()
