"""Decode engine over a preallocated KV cache — the port of
``paddle_tpu/serving/engine.py`` for the slab layout.

- **Prefill** runs the full causal forward over the prompt padded to its
  bucket, writes every layer's K/V rows (padding included — the length
  mask keeps decode from reading them) into the slot, and returns the
  logits of the last valid position (``engine.py:315-356``).
- **Decode** is one token per slot over the static ``[max_batch]`` slot
  layout (``engine.py:408-460``). With ``fused_decode`` (the default
  here) each layer's layernorms run the ``fused_ln`` kernel, the KV row
  write and the one-query attention run as one ``decode_slab`` launch,
  and the final layernorm + LM head as one ``logits_head`` launch
  (``ops/cuda_kernels.py``). ``fused_decode=False`` is the unfused
  plain-PyTorch tick (``cache_update`` + ``decode_attention``). The JAX
  engine made the fused tick opt-in because interpret-mode Pallas is
  slow off the TPU; on the card that reason does not hold.
- **Weights** are cast once, at construction: matmul weights to the
  compute dtype, layernorm parameters to float32, embeddings kept in the
  storage dtype and summed in float32 — numerically what the JAX engine
  computes with its per-call ``.astype``.
- **The cache** is updated in place (JAX donated the slabs to the same
  end); nothing is allocated per request beyond activations.

PyTorch runs eagerly, so there is nothing to compile: ``warmup`` runs
each path once so the first request pays no first-call costs (library
handles, the kernel build). The engine is single-threaded by contract:
one scheduler loop calls it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models import gpt as gpt_mod
from ..models.gpt import GPTConfig
from ..ops import cuda_kernels as CK
from ..ops.decode_attention import (cache_update, decode_attention,
                                    prefill_attention)
from . import metrics as smetrics
from .kv_cache import KVCache
from .sampling import (GREEDY, SamplingParams, batch_arrays, sample_batch,
                       sample_token)

__all__ = ["EngineConfig", "DecodeEngine", "PromptTooLongError",
           "default_bucket_ladder"]

_STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16}


class PromptTooLongError(ValueError):
    """Prompt exceeds the largest prefill bucket."""


def default_bucket_ladder(max_seq: int, smallest: int = 16) -> Tuple[int, ...]:
    """Powers of two from ``smallest`` up to ``max_seq`` (inclusive as the
    last rung)."""
    out: List[int] = []
    b = smallest
    while b < max_seq:
        out.append(b)
        b *= 2
    out.append(max_seq)
    return tuple(sorted(set(out)))


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving geometry, field for field the JAX ``EngineConfig``.

    Refused in this slice (``NotImplementedError`` naming the ROADMAP
    item): ``kv_layout="paged"`` (and with it ``page_size``, ``num_pages``,
    ``prefix_cache*``), ``sharding="tp"`` (``tp``), ``weight_dtype="int8"``
    (``quant_chunk``) and ``verify_window > 0``."""
    max_batch: int = 8               # decode slots (the static batch)
    max_seq: int = 256               # per-slot prompt+generation bound
    prefill_buckets: Tuple[int, ...] = ()   # () -> default_bucket_ladder
    weight_dtype: str = "f32"        # "f32" | "bf16"
    quant_chunk: int = 256
    cache_dtype: Any = None          # None -> the model's compute dtype
    eos_id: Optional[int] = None     # decode stops on this token
    kv_layout: str = "slab"
    page_size: int = 16
    num_pages: int = 0
    prefix_cache: bool = True
    prefix_cache_pages: int = 0
    sharding: Optional[str] = None
    tp: int = 1
    role: str = "colocated"          # stamps the TTFT/TPOT metric labels
    verify_window: int = 0
    # the hand-written kernels of the decode tick; False = plain PyTorch
    fused_decode: bool = True

    def resolved_buckets(self) -> Tuple[int, ...]:
        buckets = tuple(sorted(set(
            int(b) for b in (self.prefill_buckets
                             or default_bucket_ladder(self.max_seq)))))
        if not buckets:
            raise ValueError("prefill_buckets must not be empty")
        if buckets[-1] > self.max_seq:
            raise ValueError(
                f"largest prefill bucket {buckets[-1]} exceeds max_seq "
                f"{self.max_seq}")
        return buckets


def _refuse_unported(ecfg: EngineConfig) -> None:
    if ecfg.kv_layout == "paged":
        raise NotImplementedError(
            "kv_layout='paged' is the next serving slice of the port "
            "(ROADMAP.md, queue A: paged serving, kernel #9)")
    if ecfg.kv_layout != "slab":
        raise ValueError(f"kv_layout {ecfg.kv_layout!r}: expected 'slab' "
                         "or 'paged'")
    if ecfg.sharding == "tp":
        raise NotImplementedError(
            "sharding='tp' waits for the multi-GPU slice of the port "
            "(ROADMAP.md, queue A: tensor parallelism)")
    if ecfg.sharding is not None:
        raise ValueError(f"sharding {ecfg.sharding!r}: expected None or "
                         "'tp'")
    if ecfg.weight_dtype == "int8":
        raise NotImplementedError(
            "weight_dtype='int8' waits for the port of serving/quant.py "
            "(ROADMAP.md, queue A: serving fleet)")
    if ecfg.weight_dtype not in _STORAGE:
        raise ValueError(f"weight_dtype {ecfg.weight_dtype!r}: expected "
                         "'f32', 'bf16' or 'int8'")
    if ecfg.verify_window > 0:
        raise NotImplementedError(
            "verify_window > 0 (speculative decoding) waits for the port "
            "of serving/spec_decode.py (ROADMAP.md, queue A: serving fleet)")
    if ecfg.role not in ("prefill", "decode", "colocated"):
        raise ValueError(f"role {ecfg.role!r}: expected 'prefill', "
                         "'decode' or 'colocated'")


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


class DecodeEngine:
    def __init__(self, params, cfg: GPTConfig, ecfg: EngineConfig,
                 device="cuda"):
        self.device = resolve_device(device)
        if ecfg.max_seq > cfg.max_seq_len:
            raise ValueError(
                f"EngineConfig.max_seq {ecfg.max_seq} exceeds the model's "
                f"positional table {cfg.max_seq_len}")
        _refuse_unported(ecfg)
        self.cfg = cfg
        self.ecfg = ecfg
        self.buckets = ecfg.resolved_buckets()
        self.role = ecfg.role
        self._ref_params = _to_device(params, self.device)  # f32 truth
        self._cast_weights(self._ref_params)
        self.cache = KVCache(cfg.num_layers, ecfg.max_batch, ecfg.max_seq,
                             cfg.num_heads, cfg.head_dim,
                             dtype=ecfg.cache_dtype or cfg.dtype,
                             device=self.device)
        self.decode_ticks = 0
        self._tokens_window: List[Tuple[float, int]] = []

    def _cast_weights(self, p) -> None:
        """Serving weights, cast once: storage rounding (bf16 weights
        round here), then the compute dtype for matmul operands and
        float32 for layernorm parameters. The matmul weights are laid out
        as 2-D ``[in, out]`` matrices of the same contraction."""
        store = _STORAGE[self.ecfg.weight_dtype]
        dt = self.cfg.dtype
        D = self.cfg.d_model

        def mm(t):
            return t.to(store).to(dt).contiguous()

        def f32(t):
            return t.to(store).float().contiguous()

        self.wte = p["wte"].to(store)
        self.wpe = p["wpe"].to(store)
        self.ln_f = (f32(p["ln_f_scale"]), f32(p["ln_f_bias"]))
        self.lm_head = mm(p["lm_head"])
        blocks = p["blocks"]
        self.layers = []
        for i in range(self.cfg.num_layers):
            b = {k: v[i] for k, v in blocks.items()}
            self.layers.append({
                "ln1": (f32(b["ln1_scale"]), f32(b["ln1_bias"])),
                "w_qkv": mm(b["w_qkv"]).reshape(D, -1),
                "b_qkv": mm(b["b_qkv"]).reshape(-1),
                "w_proj": mm(b["w_proj"]).reshape(-1, D),
                "b_proj": mm(b["b_proj"]),
                "ln2": (f32(b["ln2_scale"]), f32(b["ln2_bias"])),
                "w_fc": mm(b["w_fc"]),
                "b_fc": mm(b["b_fc"]),
                "w_out": mm(b["w_out"]),
                "b_out": mm(b["b_out"]),
            })

    # ------------------------------------------------------------------
    # forward passes
    # ------------------------------------------------------------------
    def _ln(self, fused: bool):
        if fused:
            return lambda x, sb: CK.fused_ln(x, sb[0], sb[1], eps=1e-5)
        return lambda x, sb: gpt_mod._layer_norm(x, sb[0], sb[1])

    def _block_tail(self, h, a, lw, ln):
        """Post-attention half of a block: projection, residual, MLP —
        ``(h + o) + b`` associated as the JAX engine adds."""
        o = a.reshape(*a.shape[:-2], -1) @ lw["w_proj"]
        h = h + o + lw["b_proj"]
        h2 = ln(h, lw["ln2"])
        f = F.gelu(h2 @ lw["w_fc"] + lw["b_fc"], approximate="tanh")
        return h + f @ lw["w_out"] + lw["b_out"]

    def _qkv(self, h1, lw):
        qkv = h1 @ lw["w_qkv"] + lw["b_qkv"]
        return qkv.view(*h1.shape[:-1], 3, self.cfg.num_heads,
                        self.cfg.head_dim)

    @torch.no_grad()
    def _prefill(self, tokens: torch.Tensor, length: int,
                 slot: int) -> torch.Tensor:
        """tokens [1, T] -> float32 logits [V] of position ``length-1``;
        writes the bucket's K/V rows of every layer into ``slot``."""
        T = tokens.shape[1]
        ln = self._ln(False)
        pos = torch.arange(T, device=self.device)
        x = (self.wte[tokens].float() + self.wpe[pos].float()).to(
            self.cfg.dtype)
        for i, lw in enumerate(self.layers):
            qkv = self._qkv(ln(x, lw["ln1"]), lw)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            a = prefill_attention(q, k, v)
            x = self._block_tail(x, a, lw, ln)
            self.cache.k[i, slot, :T] = k[0]
            self.cache.v[i, slot, :T] = v[0]
        h_last = ln(x[0, length - 1], self.ln_f)
        return (h_last @ self.lm_head).float()

    @torch.no_grad()
    def _decode(self, tokens: torch.Tensor, positions: torch.Tensor,
                actives: torch.Tensor) -> torch.Tensor:
        """tokens (int64), positions, actives (int32): [max_batch] ->
        float32 logits [max_batch, V]. Writes this step's K/V at
        ``positions`` for the active lanes only — a live slot riding as a
        masked lane keeps every cached row."""
        fused = self.ecfg.fused_decode
        ln = self._ln(fused)
        x = (self.wte[tokens].float()
             + self.wpe[positions.long()].float()).to(self.cfg.dtype)
        for i, lw in enumerate(self.layers):
            qkv = self._qkv(ln(x, lw["ln1"]), lw)
            q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
            ck, cv = self.cache.k[i], self.cache.v[i]
            if fused:
                a, _, _ = CK.fused_decode_attention(q, ck, cv, k, v,
                                                    positions, actives)
            else:
                cache_update(ck, k, positions, actives)
                cache_update(cv, v, positions, actives)
                a = decode_attention(q, ck, cv, positions + 1)
            x = self._block_tail(x, a, lw, ln)
        if fused:
            logits = CK.fused_logits_head(x, *self.ln_f, self.lm_head)
        else:
            logits = ln(x, self.ln_f) @ self.lm_head
        return logits.float()

    # ------------------------------------------------------------------
    def warmup(self) -> Dict[str, float]:
        """Run the decode tick (every lane masked — nothing is written)
        and one prefill per bucket once, so the first request pays no
        first-call costs: the kernel build and load, library handles.
        Returns {path: wall ms}."""
        timings: Dict[str, float] = {}
        B = self.ecfg.max_batch
        zeros = torch.zeros((B,), dtype=torch.int32, device=self.device)

        def timed(label, fn):
            t0 = time.perf_counter()
            fn()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            timings[label] = (time.perf_counter() - t0) * 1e3

        timed("decode", lambda: self._decode(zeros.long(), zeros, zeros))
        for bucket in self.buckets:
            toks = torch.zeros((1, bucket), dtype=torch.long,
                               device=self.device)
            timed(f"prefill_b{bucket}", lambda: self._prefill(toks, 1, 0))
        return timings

    # ------------------------------------------------------------------
    # host-side serving API (one scheduler thread)
    # ------------------------------------------------------------------
    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        raise PromptTooLongError(
            f"prompt length {n} exceeds the largest prefill bucket "
            f"{self.buckets[-1]}")

    def can_admit(self, prompt_len: int) -> bool:
        """Would a prompt admit right now? (slab: a free slot)"""
        return self.cache.free_slot_count() > 0

    def start_sequence(self, tokens: Sequence[int]) -> Tuple[int, np.ndarray]:
        """Claim a slot, prefill the prompt, return (slot, logits[V]) of
        the last prompt position."""
        slot, logits, _tok = self.start_sequence_sampled(tokens, GREEDY)
        return slot, logits

    def start_sequence_sampled(
            self, tokens: Sequence[int], params: SamplingParams
    ) -> Tuple[int, np.ndarray, int]:
        """:meth:`start_sequence` plus sampling: returns (slot,
        last-position logits[V], first generated token). Raises
        CacheFullError when no slot is free and PromptTooLongError above
        the ladder."""
        n = len(tokens)
        if n < 1:
            raise ValueError("empty prompt")
        bucket = self.bucket_for(n)
        slot = self.cache.alloc(length=n)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :n] = np.asarray(tokens, np.int64)
        t0 = time.perf_counter_ns()
        try:
            logits = self._prefill(
                torch.from_numpy(padded).to(self.device), n, slot).cpu()
            tok = sample_token(logits, params.temperature, params.top_k,
                               params.top_p, params.seed, n - 1)
        except Exception:
            self.cache.free(slot)
            raise
        smetrics.m_prefill_ms.observe((time.perf_counter_ns() - t0) / 1e6)
        smetrics.m_prefill_tokens.inc(n)
        return slot, logits.numpy(), tok

    def _decode_feed(self, slot_tokens: Dict[int, int]) -> np.ndarray:
        """[3, max_batch] int32: tokens, positions, actives."""
        feed = np.zeros((3, self.ecfg.max_batch), np.int32)
        for slot, tok in slot_tokens.items():
            if not self.cache.is_live(slot):
                raise ValueError(f"slot {slot} is not live")
            if self.cache.headroom(slot) < 1:
                raise ValueError(
                    f"slot {slot} is at max_seq {self.ecfg.max_seq}")
            feed[:, slot] = (tok, self.cache.length(slot), 1)
        return feed

    def decode_step(self, slot_tokens: Dict[int, int]) -> Dict[int, np.ndarray]:
        """One greedy-compatible decode step: {slot: input_token} ->
        {slot: logits[V]}."""
        out = self.decode_step_sampled(slot_tokens, None)
        return {slot: logits for slot, (_tok, logits) in out.items()}

    def decode_step_sampled(
            self, slot_tokens: Dict[int, int],
            params_by_slot: Optional[Dict[int, SamplingParams]]
    ) -> Dict[int, Tuple[int, np.ndarray]]:
        """One decode step with per-slot sampling: {slot: input_token} ->
        {slot: (next_token, logits[V])}. Slots not in the map ride as
        masked lanes."""
        if not slot_tokens:
            return {}
        feed_np = self._decode_feed(slot_tokens)
        sp = batch_arrays(params_by_slot or {}, self.ecfg.max_batch)
        t0 = time.perf_counter_ns()
        feed = torch.from_numpy(feed_np).to(self.device)
        logits = self._decode(feed[0].long(), feed[1], feed[2]).cpu()
        toks = sample_batch(logits, *sp, feed_np[1])
        smetrics.m_decode_ms.observe((time.perf_counter_ns() - t0) / 1e6)
        self.decode_ticks += 1
        logits_np = logits.numpy()
        out: Dict[int, Tuple[int, np.ndarray]] = {}
        for slot in slot_tokens:
            self.cache.set_length(slot, self.cache.length(slot) + 1)
            out[slot] = (int(toks[slot]), logits_np[slot])
        self.note_tokens(len(slot_tokens))
        return out

    def generate_step(
            self, slot_tokens: Dict[int, int],
            params_by_slot: Optional[Dict[int, SamplingParams]] = None
    ) -> Dict[int, List[int]]:
        """Scheduler surface: one generation step -> {slot: [token]}."""
        return {slot: [tok] for slot, (tok, _logits) in
                self.decode_step_sampled(slot_tokens,
                                         params_by_slot).items()}

    def free_sequence(self, slot: int) -> None:
        self.cache.free(slot)

    def note_tokens(self, n: int, window_s: float = 5.0) -> None:
        """Count generated tokens and refresh the tokens/s gauge over the
        trailing window."""
        now = time.monotonic()
        smetrics.m_tokens.inc(n)
        w = self._tokens_window
        w.append((now, n))
        while w and w[0][0] < now - window_s:
            w.pop(0)
        span = now - w[0][0] if len(w) > 1 else 0.0
        if span > 0:
            smetrics.m_tokens_per_s.set(sum(x[1] for x in w) / span)

    # ------------------------------------------------------------------
    def reference_logits(self, tokens: Sequence[int]) -> np.ndarray:
        """Full-forward float32-weight logits [T, V] for a prompt — the
        truth the cached decode path is held to."""
        with torch.no_grad():
            out = gpt_mod.forward(self._ref_params,
                                  np.asarray(tokens, np.int64)[None],
                                  self.cfg)
        return out[0].float().cpu().numpy()
