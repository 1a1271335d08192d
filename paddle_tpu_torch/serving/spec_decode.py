"""Draft-model speculative decoding over the serving engine — the port of
``paddle_tpu/serving/spec_decode.py``.

Decode reads the whole weight set and cache to emit one token a slot. A
small draft model proposes ``k`` tokens (its own decode ticks, on the
port's decode kernels), then the target scores the whole window
``[t_last, d_1..d_k]`` in one ``DecodeEngine.verify_step`` and accepts the
longest prefix consistent with its own distribution: up to ``k + 1``
tokens for one target forward.

The contract the tests hold it to, as the reference's:

- **Greedy** (temperature 0): the emitted tokens are exactly what the
  target alone emits — a proposal is accepted iff it equals the target's
  argmax there, the first mismatch is replaced by the target's own
  choice, and a fully accepted window earns the bonus token of the last
  window position.
- **Sampled**: rejection sampling (Leviathan et al., arXiv:2211.17192)
  against both adjusted distributions (``sampling.adjusted_probs_np``),
  drawn from a host ``np.random.RandomState`` seeded from (seed, start,
  slot) by the reference's formula, so the same logits and proposals
  give the reference's tokens bit for bit.

Caches: the verify window writes W rows and only the accepted prefix is
committed (``commit_window``); the draft is rolled back to the accepted
length through ``cache.set_length``, with a one-token catch-up feed
(``_pending``) when a fully accepted window leaves it one row behind.
Telemetry: ``paddle_serve_spec_accepted_tokens`` (accepted draft tokens a
window) and ``paddle_serve_spec_{proposed_tokens,windows}_total``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import metrics as smetrics
from .engine import DecodeEngine
from .sampling import GREEDY, SamplingParams, adjusted_probs_np

__all__ = ["SpecDecodeEngine", "SpecStats"]


@dataclasses.dataclass
class SpecStats:
    windows: int = 0
    proposed: int = 0
    accepted: int = 0
    emitted: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    @property
    def tokens_per_window(self) -> float:
        return self.emitted / self.windows if self.windows else 0.0


class SpecDecodeEngine:
    """A target and a draft engine behind the scheduler's engine surface
    (``start_sequence_sampled`` / ``generate_step`` / ``free_sequence`` /
    admission and capacity hooks), emitting up to ``k + 1`` tokens a step.

    The target is built with ``EngineConfig(verify_window=k+1)``; the
    draft is any engine with the same vocabulary, slot count, max_seq and
    bucket ladder, so slot ids stay aligned across the two allocators."""

    def __init__(self, target: DecodeEngine, draft: DecodeEngine):
        W = target.ecfg.verify_window
        if W < 2:
            raise ValueError(
                "target engine needs EngineConfig(verify_window=k+1>=2)")
        if draft.cfg.vocab_size != target.cfg.vocab_size:
            raise ValueError("draft/target vocab mismatch")
        for attr in ("max_batch", "max_seq"):
            if getattr(draft.ecfg, attr) != getattr(target.ecfg, attr):
                raise ValueError(f"draft/target {attr} mismatch")
        if draft.buckets != target.buckets:
            raise ValueError("draft/target bucket ladders differ "
                             "(slot alignment needs identical admission)")
        if draft.device != target.device:
            raise ValueError("draft/target devices differ")
        self.target = target
        self.draft = draft
        self.draft.meter_tokens = False      # draft tokens aren't served
        self.k = W - 1
        self.window = W
        # a verify window writes W rows: the scheduler evicts below this
        self.min_headroom = W
        self.stats = SpecStats()
        # tokens the target cached that the draft has not ingested (at
        # most one: a fully accepted window's last proposal)
        self._pending: Dict[int, List[int]] = {}

    # -- facade ------------------------------------------------------------
    @property
    def cfg(self):
        return self.target.cfg

    @property
    def ecfg(self):
        return self.target.ecfg

    @property
    def cache(self):
        return self.target.cache

    @property
    def prefix(self):
        return self.target.prefix

    @property
    def buckets(self):
        return self.target.buckets

    @property
    def paged(self):
        return self.target.paged

    @property
    def device(self):
        return self.target.device

    @property
    def role(self):
        return self.target.role

    @property
    def poisoned(self) -> Optional[str]:
        return self.target.poisoned or self.draft.poisoned

    def close(self) -> None:
        self.target.close()
        self.draft.close()

    def warmup(self) -> Dict[str, float]:
        out = {f"target/{k}": v for k, v in self.target.warmup().items()}
        out.update({f"draft/{k}": v
                    for k, v in self.draft.warmup().items()})
        return out

    def bucket_for(self, n: int) -> int:
        return self.target.bucket_for(n)

    def can_admit(self, prompt_len: int) -> bool:
        return (self.target.can_admit(prompt_len)
                and self.draft.can_admit(prompt_len))

    def note_tokens(self, n: int) -> None:
        self.target.note_tokens(n)

    def reference_logits(self, tokens):
        return self.target.reference_logits(tokens)

    # -- lifecycle ---------------------------------------------------------
    def start_sequence(self, tokens: Sequence[int]):
        slot, logits, _tok = self.start_sequence_sampled(tokens, GREEDY)
        return slot, logits

    def _pair(self, slot: int, start_draft, what: str):
        """Run the draft's half of an admission after the target's;
        free both on a failure or when the slots differ."""
        try:
            d_slot = start_draft()
        except Exception:
            self.target.free_sequence(slot)
            raise
        if d_slot != slot:       # identical admission order -> same slot
            self.draft.free_sequence(d_slot)
            self.target.free_sequence(slot)
            raise RuntimeError(
                f"draft slot {d_slot} != target slot {slot} on {what} — "
                "the two allocators fell out of lockstep")
        self._pending[slot] = []

    def start_sequence_sampled(self, tokens: Sequence[int],
                               params: SamplingParams):
        slot, logits, tok = self.target.start_sequence_sampled(tokens,
                                                               params)
        self._pair(slot, lambda: self.draft.start_sequence_sampled(
            tokens, GREEDY)[0], "admission")
        return slot, logits, tok

    def resume_sequence_sampled(self, tokens: Sequence[int],
                                params: SamplingParams):
        """A preempted request's resume: both engines replay the stream,
        keeping their slots in lockstep."""
        slot, logits, tok = self.target.resume_sequence_sampled(tokens,
                                                                params)
        self._pair(slot, lambda: self.draft.resume_sequence_sampled(
            tokens, GREEDY)[0], "resume")
        return slot, logits, tok

    def free_sequence(self, slot: int) -> None:
        self.target.free_sequence(slot)
        self.draft.free_sequence(slot)
        self._pending.pop(slot, None)

    def ensure_decode_capacity(self, slot: int, extra: int = 0) -> bool:
        extra = extra or self.window
        return (self.target.ensure_decode_capacity(slot, extra=extra)
                and self.draft.ensure_decode_capacity(slot, extra=extra))

    # -- the speculative step ---------------------------------------------
    def _accept_greedy(self, proposals: List[int],
                       target_toks: np.ndarray) -> Tuple[int, List[int]]:
        """Longest matching prefix; emitted = accepted + the target's fix-
        up (the bonus token when everything matched)."""
        m = 0
        while m < len(proposals) and proposals[m] == int(target_toks[m]):
            m += 1
        return m, proposals[:m] + [int(target_toks[m])]

    def _accept_sampled(self, slot: int, start: int,
                        proposals: List[int],
                        draft_logits: List[np.ndarray],
                        target_logits: np.ndarray,
                        target_toks: np.ndarray,
                        sp: SamplingParams) -> Tuple[int, List[int]]:
        """Leviathan rejection sampling against the adjusted
        distributions; ``target_logits`` [W, V], row i conditioned on the
        window up to proposal i-1. The host generator's seed is the
        reference's (``spec_decode.py:243-245``)."""
        rng = np.random.RandomState(
            (int(np.uint32(sp.seed)) * 2654435761
             + int(start) * 40503 + int(slot)) % 0x7FFFFFFF)
        emitted: List[int] = []
        m = 0
        for i, d in enumerate(proposals):
            pt = adjusted_probs_np(target_logits[i], sp)
            pd = adjusted_probs_np(draft_logits[i], sp)
            ratio = 0.0 if pd[d] <= 0 else min(1.0, float(pt[d] / pd[d]))
            if rng.uniform() < ratio:
                emitted.append(int(d))
                m += 1
                continue
            residual = np.maximum(pt - pd, 0.0)
            tot = residual.sum()
            if tot <= 0:             # pt == pd exactly: keep pt's mode
                emitted.append(int(np.argmax(pt)))
            else:
                emitted.append(int(rng.choice(len(residual),
                                              p=residual / tot)))
            return m, emitted
        # fully accepted: the bonus token is the verify step's own sample
        # at the last window position
        emitted.append(int(target_toks[len(proposals)]))
        return m, emitted

    def generate_step(
            self, slot_tokens: Dict[int, int],
            params_by_slot: Optional[Dict[int, SamplingParams]] = None
    ) -> Dict[int, List[int]]:
        """One speculative step: {slot: last emitted token} -> {slot:
        emitted tokens} (1..k+1 a slot)."""
        if not slot_tokens:
            return {}
        params_by_slot = params_by_slot or {}
        k = self.k
        # 1. draft catch-up: the tokens the target cached last round
        pending = {s: list(self._pending.get(s, ())) for s in slot_tokens}
        while any(pending.values()):
            self.draft.decode_step_sampled(
                {s: toks.pop(0) for s, toks in pending.items() if toks},
                None)
        for s in slot_tokens:
            self._pending[s] = []
        # 2. the draft proposes k tokens, sampled from its adjusted
        #    distribution under the request's knobs
        proposals: Dict[int, List[int]] = {s: [] for s in slot_tokens}
        draft_logits: Dict[int, List[np.ndarray]] = {
            s: [] for s in slot_tokens}
        feed = dict(slot_tokens)
        for _ in range(k):
            out = self.draft.decode_step_sampled(feed, params_by_slot)
            feed = {}
            for s, (tok, logits) in out.items():
                proposals[s].append(int(tok))
                draft_logits[s].append(logits)
                feed[s] = int(tok)
        # 3. one target verify over [t_last, d_1..d_k]
        windows = {s: [slot_tokens[s]] + proposals[s] for s in slot_tokens}
        starts = {s: self.target.cache.length(s) for s in slot_tokens}
        vout = self.target.verify_step(windows, params_by_slot)
        # 4. acceptance on the host
        result: Dict[int, List[int]] = {}
        total = 0
        for s, (t_logits, t_toks) in vout.items():
            sp = params_by_slot.get(s, GREEDY)
            if sp.greedy:
                m, emitted = self._accept_greedy(proposals[s], t_toks)
            else:
                m, emitted = self._accept_sampled(
                    s, starts[s], proposals[s], draft_logits[s], t_logits,
                    t_toks, sp)
            # target rows start..start+m hold [t_last, d_1..d_m]
            self.target.commit_window(s, m + 1)
            # the draft stepped to start+k: roll back to the accepted
            # length; a fully accepted window leaves d_k pending
            if m < k:
                self.draft.cache.set_length(s, starts[s] + m + 1)
            else:
                self.draft.cache.set_length(s, starts[s] + k)
                self._pending[s] = [proposals[s][-1]]
            smetrics.m_spec_windows.inc()
            smetrics.m_spec_proposed.inc(k)
            smetrics.m_spec_accepted.observe(m)
            self.stats.windows += 1
            self.stats.proposed += k
            self.stats.accepted += m
            self.stats.emitted += len(emitted)
            total += len(emitted)
            result[s] = emitted
        self.note_tokens(total)
        return result
