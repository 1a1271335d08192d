"""Decode engine over a preallocated KV cache — the port of
``paddle_tpu/serving/engine.py`` for the slab and the paged layouts.

- **Prefill** runs the full causal forward over the prompt padded to its
  bucket, writes every layer's K/V rows (padding included — the length
  mask keeps decode from reading them) into the slot, and returns the
  logits of the last valid position (``engine.py:315-356``). The paged
  prefill (``:358-406``) covers only the suffix behind a prefix-cache hit:
  it writes the suffix's pages, gathers the slot's whole view and runs
  the continuation attention over it.
- **Decode** is one token per slot over the static ``[max_batch]`` slot
  layout (``engine.py:408-516``). With ``fused_decode`` (the default
  here) each layer's layernorms run the ``fused_ln`` kernel, the KV row
  write and the one-query attention run as one ``decode_slab`` launch
  (slab) or one ``decode_paged`` launch (paged: the page-table walk in
  the kernel), and the final layernorm + LM head as one ``logits_head``
  launch (``ops/cuda_kernels.py``). ``fused_decode=False`` is the unfused
  plain-PyTorch tick (``cache_update`` + ``decode_attention``; paged:
  ``paged_cache_update`` + ``paged_gather`` + ``decode_attention``). The
  JAX engine made the fused tick opt-in because interpret-mode Pallas is
  slow off the TPU; on the card that reason does not hold.
- **Paged layout** (``kv_layout="paged"``): a page pool with a token-hash
  prefix cache (``serving/paged_kv.py``), pages bound as sequences grow,
  dead decode lanes riding with zeroed page tables (their writes land on
  scratch page 0), and a recompute resume for preempted requests that
  replays past the bucket ladder through the decode tick.
- **Weights** (``weight_dtype`` "f32" or "bf16") are cast once, at
  construction: matmul weights to the compute dtype, layernorm parameters
  to float32, embeddings kept in the storage dtype and summed in float32 —
  numerically what the JAX engine computes with its per-call ``.astype``.
  With ``weight_dtype="int8"`` (``serving/quant.py``) the card holds only
  the chunk-scaled payloads and scales, and every forward dequantizes one
  layer's leaves at a time into the compute dtype, for the time that
  layer runs (the embeddings only the gathered rows), as the reference
  dequantizes inside its jitted functions. The reference computes the
  dequantization without a Pallas kernel, so it stays plain PyTorch.
- **Speculative verify** (``verify_window`` W >= 2, driven by
  ``serving/spec_decode.py``): :meth:`DecodeEngine.verify_step` writes a
  W-token window a slot and returns the logits and sampled target tokens
  of every window position in one forward (``engine.py:518-600``,
  ``:1088-1147``); it runs the plain layernorm, window attention and LM
  head, as the reference's verify calls no Pallas kernel.
- **The cache** is updated in place (JAX donated the slabs to the same
  end); nothing is allocated per request beyond activations.
- **KV handoff** (disaggregated serving, ``engine.py:211-250``):
  :meth:`DecodeEngine.export_request_kv` serializes a live slot's pages or
  rows (``serving/kv_transfer.py``), :meth:`~DecodeEngine.adopt_request_kv`
  writes a migrated request's into a fresh slot on the loop thread, and a
  ``prefix_store`` (duck-typed: ``maybe_publish``, ``restore_into``) sees
  every prefix the paged prefill publishes — the gang-shared prefix index
  of ``serving/disagg.py`` plugs in there.
- **Tensor parallelism** (``sharding="tp"``, ``tp=N``; ``serving/tp.py``):
  this object is the driver, rank 0, and spawns N - 1 follower ranks; the
  weights are cut as Megatron's split (``engine.tp_derived``), each rank
  holds ``num_heads / N`` heads of the slab or the pool, each block
  all-reduces its attention projection's and its MLP's partial sums, and
  the driver alone runs the LM head and sampling. Every entry point sends
  the followers one command; a rank's fault poisons the engine;
  :meth:`DecodeEngine.close` stops the followers. ``weight_nbytes`` is
  the driver rank's; :meth:`DecodeEngine.rank_stats` gives every rank's.

PyTorch runs eagerly, so there is nothing to compile: ``warmup`` runs
each path once so the first request pays no first-call costs (library
handles, the kernel build). The engine is single-threaded by contract:
one scheduler loop calls it.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models import gpt as gpt_mod
from ..models.gpt import GPTConfig
from ..observability import spans as _spans
from ..ops import cuda_kernels as CK
from ..parallel import comm_opt
from ..parallel import mesh as mesh_mod
from ..sharding.plan import _flatten
from ..ops.decode_attention import (cache_update, decode_attention,
                                    paged_cache_update, paged_gather,
                                    paged_page_write,
                                    paged_prefill_attention,
                                    prefill_attention, window_attention,
                                    window_cache_update)
from . import kv_transfer
from . import metrics as smetrics
from . import tp as tp_mod
from .kv_cache import CacheFullError, KVCache
from .paged_kv import PagedKVCache, PagePoolFullError, PrefixCache
from .quant import WEIGHT_DTYPES, quantize_params, quantized_nbytes
from .sampling import (GREEDY, SamplingParams, batch_arrays, sample_batch,
                       sample_token, sample_window)

__all__ = ["EngineConfig", "DecodeEngine", "PromptTooLongError",
           "default_bucket_ladder"]

_STORAGE = {"f32": torch.float32, "bf16": torch.bfloat16}
# a block's leaves the forward takes in float32 (the rest are matmul
# operands, in the compute dtype)
_F32_LEAVES = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")


class PromptTooLongError(ValueError):
    """Prompt exceeds the largest prefill bucket."""


# what a refused adoption raises: it wrote no live slot's rows (at most
# pages it had claimed, which it gives back)
_ADOPT_REFUSALS = (kv_transfer.CacheConfigMismatch, CacheFullError,
                   PagePoolFullError, ValueError, KeyError, TypeError,
                   AssertionError)


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
    """Serving geometry, field for field the JAX ``EngineConfig``. With
    ``kv_layout="paged"``, ``page_size`` must divide every prefill bucket;
    ``sharding="tp"`` takes ``tp >= 2`` dividing ``num_heads`` and
    ``d_ff``, and f32 or bf16 weights."""
    max_batch: int = 8               # decode slots (the static batch)
    max_seq: int = 256               # per-slot prompt+generation bound
    prefill_buckets: Tuple[int, ...] = ()   # () -> default_bucket_ladder
    weight_dtype: str = "f32"        # "f32" | "bf16" | "int8"
    quant_chunk: int = 256           # int8 scale granularity
    cache_dtype: Any = None          # None -> the model's compute dtype
    eos_id: Optional[int] = None     # decode stops on this token
    kv_layout: str = "slab"          # "slab" | "paged"
    page_size: int = 16              # tokens per page (divides buckets)
    num_pages: int = 0               # 0 -> slab-parity pool (+1 scratch)
    prefix_cache: bool = True        # token-hash prefix cache (paged only)
    prefix_cache_pages: int = 0      # 0 -> bounded by the pool itself
    sharding: Optional[str] = None
    tp: int = 1
    role: str = "colocated"          # stamps the TTFT/TPOT metric labels
    verify_window: int = 0           # W >= 2: verify_step takes W tokens
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
    if ecfg.kv_layout not in ("slab", "paged"):
        raise ValueError(f"kv_layout {ecfg.kv_layout!r}: expected 'slab' "
                         "or 'paged'")
    if ecfg.sharding not in (None, "tp"):
        raise ValueError(f"sharding {ecfg.sharding!r}: expected None or "
                         "'tp'")
    if ecfg.weight_dtype not in WEIGHT_DTYPES:
        raise ValueError(f"weight_dtype {ecfg.weight_dtype!r}: expected "
                         "'f32', 'bf16' or 'int8'")
    if ecfg.verify_window < 0:
        raise ValueError(f"verify_window {ecfg.verify_window} < 0")
    if ecfg.role not in ("prefill", "decode", "colocated"):
        raise ValueError(f"role {ecfg.role!r}: expected 'prefill', "
                         "'decode' or 'colocated'")


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _numel(tree) -> int:
    return sum(t.numel() for _, t in _flatten(tree))


class DecodeEngine:
    def __init__(self, params, cfg: GPTConfig, ecfg: EngineConfig,
                 device="cuda", tp_devices=None):
        """``tp_devices`` (``sharding="tp"`` only): each rank's device, one
        a rank — by default ``cuda:0 .. cuda:N-1`` (raising when fewer
        cards are visible), every rank on the CPU for ``device="cpu"``; two
        ranks share a card only where it is named twice."""
        _refuse_unported(ecfg)
        tp_devs = None
        if ecfg.sharding == "tp":
            tp_devs = tp_mod.check_tp(cfg, ecfg, device, tp_devices)
            device = tp_devs[0]
        self.device = resolve_device(device)
        if ecfg.max_seq > cfg.max_seq_len:
            raise ValueError(
                f"EngineConfig.max_seq {ecfg.max_seq} exceeds the model's "
                f"positional table {cfg.max_seq_len}")
        self._init_host(cfg, ecfg, int(ecfg.tp) if tp_devs else 1)
        self._ref_params = _to_device(params, self.device)  # f32 truth
        # int8: the payloads and scales are all the card holds of the
        # weights (once drop_reference_params() lets the f32 truth go)
        if ecfg.weight_dtype == "int8":
            self.qparams = quantize_params(self._ref_params, "int8",
                                           ecfg.quant_chunk)
            self.weight_nbytes = quantized_nbytes(self.qparams)
        elif tp_devs:
            self._init_tp(tp_devs)
        else:
            self._cast_weights(self._ref_params)
            self.weight_nbytes = (_numel(self._ref_params)
                                  * _STORAGE[ecfg.weight_dtype].itemsize)
        self._init_cache()
        if self._tp is not None:
            self.cache.shard_io = self._tp
            self._tp.cache = self.cache
            self._tp.wait_ready()

    def _init_host(self, cfg: GPTConfig, ecfg: EngineConfig,
                   tp: int) -> None:
        self.cfg = cfg
        self.ecfg = ecfg
        self.buckets = ecfg.resolved_buckets()
        self.paged = ecfg.kv_layout == "paged"
        if self.paged:
            bad = [b for b in self.buckets if b % ecfg.page_size]
            if bad:
                raise ValueError(
                    f"paged engine: prefill buckets {bad} are not "
                    f"multiples of page_size {ecfg.page_size}")
        self.role = ecfg.role
        self.tp = tp
        self._nh = cfg.num_heads // tp      # this rank's heads
        self.qparams = None
        self.tp_derived: Optional[Dict[str, str]] = None
        self._tp: Optional[tp_mod.TpRanks] = None   # the driver's followers
        self._group: Optional[mesh_mod.AxisGroup] = None    # the tp line
        self._driver = True
        self._closed = False
        self.decode_ticks = 0
        self.verify_steps = 0
        self._tokens_window: List[Tuple[float, int]] = []
        # the slot headroom a generation step needs (SpecDecodeEngine
        # raises its own to the verify window)
        self.min_headroom = 1
        # a speculative draft's tokens are proposals, not served output
        self.meter_tokens = True
        # The reference donates its cache slabs to every executable; here
        # the caches are CUDA tensors that prefill and the decode kernels
        # write in place, and a CUDA fault is sticky for the context. So a
        # failure mid-call on the card leaves caches that no later call
        # can trust: the engine marks itself poisoned and every serving
        # entry point refuses from then on. On the CPU a failure leaves
        # the caches usable, as the reference's are without donation —
        # unless the engine is tensor-parallel, where a failed call leaves
        # its ranks out of step.
        self._in_place = self.device.type == "cuda" or tp > 1
        self.poisoned: Optional[str] = None
        # a prefix store sees every prefix publish (attach_prefix_store)
        self.prefix_store = None

    def _init_cache(self) -> None:
        cfg, ecfg = self.cfg, self.ecfg
        cache_dtype = ecfg.cache_dtype or cfg.dtype
        self.prefix: Optional[PrefixCache] = None
        if self.paged:
            self.cache = PagedKVCache(
                cfg.num_layers, ecfg.max_batch, ecfg.max_seq,
                cfg.num_heads, cfg.head_dim, dtype=cache_dtype,
                page_size=ecfg.page_size, num_pages=ecfg.num_pages,
                device=self.device, shards=self.tp)
            if ecfg.prefix_cache and self._driver:
                self.prefix = PrefixCache(self.cache,
                                          ecfg.prefix_cache_pages)
                self.cache.reclaimer = self.prefix
        else:
            self.cache = KVCache(cfg.num_layers, ecfg.max_batch,
                                 ecfg.max_seq, cfg.num_heads, cfg.head_dim,
                                 dtype=cache_dtype, device=self.device,
                                 shards=self.tp)

    def _init_tp(self, devices) -> None:
        """Spawn the followers and hand them the tree (storage dtype, no
        head), join the group, and cut this rank's block."""
        cut, self.tp_derived = tp_mod.shard_specs(self._ref_params,
                                                  self.cfg, self.tp)
        store = _STORAGE[self.ecfg.weight_dtype]
        flat = dict(_flatten(self._ref_params))
        self._tp = tp_mod.TpRanks(self.tp, devices,
                                  on_fault=self._on_rank_fault)
        self._tp.start({"cfg": self.cfg, "ecfg": self.ecfg, "cut": cut},
                       {p: t.to(store) for p, t in flat.items()
                        if p not in tp_mod.HEAD_LEAVES})
        self._group = self._tp.mesh.group("tp")
        local = tp_mod.local_tree(flat, cut, self._tp.mesh)
        self._cast_weights(local)
        self.weight_nbytes = _numel(local) * store.itemsize

    @classmethod
    def _follower(cls, init: Dict[str, Any], mesh) -> "DecodeEngine":
        """A follower rank's engine: its weight block and its KV shard on
        ``mesh.device``, no host state the driver keeps, no head."""
        self = cls.__new__(cls)
        self.device = mesh.device
        self._init_host(init["cfg"], init["ecfg"], mesh.size)
        self._driver = False
        self._ref_params = None
        self._group = mesh.group("tp")
        local = tp_mod.local_tree(init["tree"], init["cut"], mesh)
        self._cast_weights(_to_device(local, self.device))
        self.weight_nbytes = (_numel(local)
                              * _STORAGE[self.ecfg.weight_dtype].itemsize)
        self._init_cache()
        return self

    def _on_rank_fault(self, reason: str) -> None:
        if self.poisoned is None:
            self.poisoned = (f"tp rank fault ({reason}); KV caches "
                             "invalidated — rebuild the engine")

    def close(self) -> None:
        """Stop the tensor-parallel followers (a tp=1 engine holds none:
        a no-op); every later serving call of a tp engine refuses."""
        if self._tp is not None:
            self._tp.close()
            self._closed = True

    @property
    def follower_pids(self) -> List[int]:
        return self._tp.pids if self._tp is not None else []

    @property
    def tp_startup(self) -> List[Dict[str, float]]:
        """Each rank's start-up stamps (host clock, ``time.time()``):
        the driver's spawn, each follower's hello, the tree sent, the
        group joined, its shard cut, every follower ready; a follower's
        entry (its imports done), the tree received, the group joined,
        its engine built."""
        return self._tp.startup if self._tp is not None else []

    def rank_stats(self, reset_launches: bool = False) -> List[Dict]:
        """Every rank's resident weight and cache bytes, its kernels'
        launch counts and its tp wire bytes and staged seconds (its
        process's counters), rank 0 first; ``reset_launches`` zeroes each
        rank's launch counts after the read."""
        if self._tp is None:
            return [self._cmd_stats(reset_launches)]
        mine, theirs = self._tp.run(
            "stats", (reset_launches,),
            lambda: self._cmd_stats(reset_launches))
        return [mine] + list(theirs)

    def _cmd_stats(self, reset_launches: bool) -> Dict:
        out = {"rank": self._group.index if self._group else 0,
               "pid": os.getpid(), "device": str(self.device),
               "weight_nbytes": int(self.weight_nbytes),
               "resident_weight_bytes": self._resident_weight_bytes(),
               "cache_nbytes": int(self.cache.nbytes),
               "memory_allocated": (torch.cuda.memory_allocated(self.device)
                                    if self.device.type == "cuda" else 0),
               "launches": dict(CK.LAUNCHES),
               "wire_bytes": int(sum(
                   c.value for c in comm_opt._m_wire_bytes.children()
                   if c.labels[0] == "psum")),
               "staged_s": float(mesh_mod._m_staged_seconds.labels(
                   "all_reduce").value)}
        if reset_launches:
            CK.reset_launches()
        return out

    def _resident_weight_bytes(self) -> int:
        """The bytes of the serving weight tensors this rank holds, as the
        forward takes them (layernorm parameters in float32)."""
        if self.qparams is not None:
            return quantized_nbytes(self.qparams)
        ts = [self.wte, self.wpe]
        for d in self.layers + ([self._head_w] if self._head_w else []):
            for v in d.values():
                ts.extend(v if isinstance(v, tuple) else (v,))
        return sum(t.numel() * t.element_size() for t in ts)

    def _cmd(self, op: str, *args):
        """Run ``_cmd_<op>(*args)`` here — on a tp engine after sending
        the followers the same command, whose answers are read after."""
        fn = getattr(self, "_cmd_" + op)
        if self._tp is None:
            return fn(*args)
        return self._tp.run(op, args, lambda: fn(*args))[0]

    def _feed(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def attach_prefix_store(self, store) -> int:
        """Restore the store's committed prefix records into the pool and
        prefix cache now (call before :meth:`warmup`), and hand every later
        publish to it (``store.maybe_publish(tokens, table_row, cache)``).
        Returns how many records were restored."""
        if not self.paged or self.prefix is None:
            raise ValueError("prefix store needs kv_layout='paged' with "
                             "prefix_cache enabled")
        self.prefix_store = store
        return store.restore_into(self)

    # -- KV handoff surface (serving/kv_transfer.py) ---------------------
    def cache_fingerprint(self) -> Dict[str, Any]:
        """Geometry fingerprint of this engine's KV cache — the
        compatibility check of every handoff."""
        return kv_transfer.cache_fingerprint(self.cache)

    def export_request_kv(self, slot: int, tokens=None) -> dict:
        """Serialize a live slot's KV state for migration to a decode
        replica (chunked, CRC-stamped, fingerprinted). The slot stays live
        until the caller frees it."""
        self._check_poisoned()
        return kv_transfer.export_slot(self, slot, tokens=tokens)

    def adopt_request_kv(self, handoff: dict) -> int:
        """Write a migrated request's KV state into a fresh slot (the decode
        half of a handoff) and return the slot. Runs on the serving loop
        thread, between ticks. A refusal — a fingerprint mismatch, a bad
        CRC, an uncommitted handoff, no free slot or page — writes nothing
        and leaves the engine as it was; a failure while writing the cache
        on the card poisons it, as a failed prefill does."""
        self._check_poisoned()
        try:
            return kv_transfer.adopt_into_engine(self, handoff)
        except _ADOPT_REFUSALS:
            raise
        except Exception as e:
            self._poison_on_donation_failure("kv_adopt", e)
            raise

    def _cast_weights(self, p) -> None:
        """Serving weights, cast once: storage rounding (bf16 weights
        round here), then the compute dtype for matmul operands and
        float32 for layernorm parameters. The matmul weights are laid out
        as 2-D ``[in, out]`` matrices of the same contraction."""
        store = _STORAGE[self.ecfg.weight_dtype]
        self.wte = p["wte"].to(store)
        self.wpe = p["wpe"].to(store)
        self._head_w = (self._head_dict(
            {k: p[k].to(store) for k in tp_mod.HEAD_LEAVES})
            if self._driver else None)
        blocks = p["blocks"]
        self.layers = [
            self._layer_dict({k: v[i].to(store) for k, v in blocks.items()})
            for i in range(self.cfg.num_layers)]

    def _layer_dict(self, b) -> Dict[str, Any]:
        """One layer's weights for the forward, from its leaves in the
        storage dtype (or float32, dequantized): matmul weights in the
        compute dtype as 2-D ``[in, out]`` matrices, layernorm parameters
        in float32."""
        dt, D = self.cfg.dtype, self.cfg.d_model

        def mm(t):
            return t.to(dt).contiguous()

        def f32(t):
            return t.float().contiguous()

        return {
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
        }

    def _head_dict(self, p) -> Dict[str, Any]:
        return {"ln_f": (p["ln_f_scale"].float().contiguous(),
                         p["ln_f_bias"].float().contiguous()),
                "lm_head": p["lm_head"].to(self.cfg.dtype).contiguous()}

    def _layer_weights(self):
        """Each layer's weights in turn. int8: dequantized for the time
        the layer runs, one product a leaf written in the dtype the
        forward takes it in (the caller's loop lets the previous layer's
        go)."""
        if self.qparams is None:
            yield from self.layers
            return
        blocks = self.qparams["blocks"]
        dt = self.cfg.dtype
        for i in range(self.cfg.num_layers):
            yield self._layer_dict({
                k: leaf.layer(i, torch.float32 if k in _F32_LEAVES else dt)
                for k, leaf in blocks.items()})

    def _head(self) -> Dict[str, Any]:
        """The final layernorm and the LM head (int8: dequantized now)."""
        if self.qparams is None:
            return self._head_w
        q = self.qparams
        return self._head_dict({
            "ln_f_scale": q["ln_f_scale"].dequantize(),
            "ln_f_bias": q["ln_f_bias"].dequantize(),
            "lm_head": q["lm_head"].dequantize(self.cfg.dtype)})

    def _embed(self, tokens, positions) -> torch.Tensor:
        """Token + position embeddings summed in float32, in the compute
        dtype (int8: only the gathered rows are dequantized)."""
        if self.qparams is None:
            x = self.wte[tokens].float() + self.wpe[positions].float()
        else:
            x = (self.qparams["wte"].rows(tokens)
                 + self.qparams["wpe"].rows(positions))
        return x.to(self.cfg.dtype)

    # ------------------------------------------------------------------
    # forward passes
    # ------------------------------------------------------------------
    def _ln(self, fused: bool):
        if fused:
            return lambda x, sb: CK.fused_ln(x, sb[0], sb[1], eps=1e-5)
        return lambda x, sb: gpt_mod._layer_norm(x, sb[0], sb[1])

    def _block_tail(self, h, a, lw, ln):
        """Post-attention half of a block: projection, residual, MLP —
        ``(h + o) + b`` associated as the JAX engine adds. Tensor-parallel:
        the projection's and the MLP's partial sums are all-reduced before
        their biases are added."""
        o = self._all_reduce(a.reshape(*a.shape[:-2], -1) @ lw["w_proj"])
        h = h + o + lw["b_proj"]
        h2 = ln(h, lw["ln2"])
        f = F.gelu(h2 @ lw["w_fc"] + lw["b_fc"], approximate="tanh")
        return h + self._all_reduce(f @ lw["w_out"]) + lw["b_out"]

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The tp ranks' partial sums summed, in place, in ``t``'s dtype
        (the identity on one rank)."""
        if self._group is None:
            return t
        comm_opt.record_collective("psum", t.dtype,
                                   t.numel() * t.element_size(), self.tp)
        return self._group.all_reduce(t)

    def _qkv(self, h1, lw):
        qkv = h1 @ lw["w_qkv"] + lw["b_qkv"]
        return qkv.view(*h1.shape[:-1], 3, self._nh, self.cfg.head_dim)

    @torch.no_grad()
    def _prefill(self, tokens: torch.Tensor, length: int,
                 slot: int) -> torch.Tensor:
        """tokens [1, T] -> float32 logits [V] of position ``length-1``;
        writes the bucket's K/V rows of every layer into ``slot``."""
        T = tokens.shape[1]
        ln = self._ln(False)
        x = self._embed(tokens, torch.arange(T, device=self.device))
        for i, lw in enumerate(self._layer_weights()):
            qkv = self._qkv(ln(x, lw["ln1"]), lw)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            a = prefill_attention(q, k, v)
            x = self._block_tail(x, a, lw, ln)
            self.cache.k[i, slot, :T] = k[0]
            self.cache.v[i, slot, :T] = v[0]
        if not self._driver:
            return None
        head = self._head()
        return (ln(x[0, length - 1], head["ln_f"]) @ head["lm_head"]).float()

    @torch.no_grad()
    def _prefill_paged(self, tokens: torch.Tensor, length: int,
                       prefix_len: int,
                       table_row: torch.Tensor) -> torch.Tensor:
        """tokens [1, T]: the SUFFIX after ``prefix_len`` cached tokens,
        ``length`` of them valid; table_row [M] int32 (the slot's pages).
        Writes the suffix's K/V pages of every layer (bucket pages past the
        slot's mapping land on scratch page 0), attends over the gathered
        view (cached prefix + suffix) and returns the float32 logits [V]
        of the last valid suffix position. prefix_len 0 is a plain paged
        prefill."""
        T = tokens.shape[1]
        ps = self.ecfg.page_size
        n_pages = T // ps
        ln = self._ln(False)
        x = self._embed(tokens, prefix_len + torch.arange(T,
                                                          device=self.device))
        suffix_pages = table_row[prefix_len // ps:prefix_len // ps + n_pages]
        nh, hd = self._nh, self.cfg.head_dim
        for i, lw in enumerate(self._layer_weights()):
            qkv = self._qkv(ln(x, lw["ln1"]), lw)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            kp, vp = self.cache.k[i], self.cache.v[i]
            paged_page_write(kp, k[0].reshape(n_pages, ps, nh, hd),
                             suffix_pages)
            paged_page_write(vp, v[0].reshape(n_pages, ps, nh, hd),
                             suffix_pages)
            a = paged_prefill_attention(q, paged_gather(kp, table_row[None]),
                                        paged_gather(vp, table_row[None]),
                                        prefix_len)
            x = self._block_tail(x, a, lw, ln)
        if not self._driver:
            return None
        head = self._head()
        return (ln(x[0, length - 1], head["ln_f"]) @ head["lm_head"]).float()

    def _attend(self, i: int, q, k, v, positions, lanes, phys):
        """Layer ``i``'s KV row write + one-query attention of a decode
        tick. Slab: ``lanes`` is the [B] write mask. Paged: ``lanes`` is
        the [B, M] page-table feed (dead lanes zeroed) and ``phys``/rows
        the unfused path's write addresses."""
        kc, vc = self.cache.k[i], self.cache.v[i]
        if self.ecfg.fused_decode:
            if self.paged:
                return CK.fused_paged_decode_attention(
                    q, kc, vc, k, v, lanes, positions)[0]
            return CK.fused_decode_attention(q, kc, vc, k, v, positions,
                                             lanes)[0]
        if self.paged:
            paged_cache_update(kc, k, *phys)
            paged_cache_update(vc, v, *phys)
            return decode_attention(q, paged_gather(kc, lanes),
                                    paged_gather(vc, lanes), positions + 1)
        cache_update(kc, k, positions, lanes)
        cache_update(vc, v, positions, lanes)
        return decode_attention(q, kc, vc, positions + 1)

    @torch.no_grad()
    def _decode(self, tokens: torch.Tensor, positions: torch.Tensor,
                lanes: torch.Tensor) -> torch.Tensor:
        """tokens (int64), positions (int32): [max_batch]; lanes (int32):
        the [max_batch] write mask (slab) or the [max_batch, M] page
        tables (paged) -> float32 logits [max_batch, V]. Writes this
        step's K/V at ``positions`` for the participating lanes only — a
        live slot riding as a masked lane (slab) or with a zeroed table
        row (paged) keeps every cached row."""
        fused = self.ecfg.fused_decode
        ln = self._ln(fused)
        x = self._embed(tokens, positions.long())
        phys = None
        if self.paged and not fused:
            ps = self.ecfg.page_size
            pos = positions.long()
            phys = (lanes.long().gather(1, (pos // ps)[:, None])[:, 0],
                    pos % ps)
        for i, lw in enumerate(self._layer_weights()):
            qkv = self._qkv(ln(x, lw["ln1"]), lw)
            q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
            a = self._attend(i, q, k, v, positions, lanes, phys)
            x = self._block_tail(x, a, lw, ln)
        if not self._driver:
            return None
        head = self._head()
        if fused:
            logits = CK.fused_logits_head(x, *head["ln_f"], head["lm_head"])
        else:
            logits = ln(x, head["ln_f"]) @ head["lm_head"]
        return logits.float()

    @torch.no_grad()
    def _verify(self, tokens: torch.Tensor, starts: torch.Tensor,
                lanes: torch.Tensor) -> torch.Tensor:
        """The speculative-verify window (``_verify_fn`` /
        ``_verify_fn_paged``, ``engine.py:518-600``): tokens [B, W]
        (int64) written at rows ``starts + w`` (starts int32 [B]), causal
        window attention over each slot's cache, float32 logits [B, W, V]
        of every window position. ``lanes``: the [B] write mask (slab) or
        the [B, M] page tables with dead lanes zeroed (paged: the B*W rows
        scatter through the tables, attention reads the gathered views).
        Plain layernorm, attention and LM head, as the reference's."""
        B, W = tokens.shape
        ln = self._ln(False)
        positions = (starts.long()[:, None]
                     + torch.arange(W, device=self.device))      # [B, W]
        x = self._embed(tokens, positions)
        nh, hd = self._nh, self.cfg.head_dim
        if self.paged:
            ps = self.ecfg.page_size
            phys = lanes.long().gather(1, positions // ps).reshape(-1)
            rows = (positions % ps).reshape(-1)
        for i, lw in enumerate(self._layer_weights()):
            qkv = self._qkv(ln(x, lw["ln1"]), lw)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            kc, vc = self.cache.k[i], self.cache.v[i]
            if self.paged:
                paged_cache_update(kc, k.reshape(B * W, nh, hd), phys, rows)
                paged_cache_update(vc, v.reshape(B * W, nh, hd), phys, rows)
                a = window_attention(q, paged_gather(kc, lanes),
                                     paged_gather(vc, lanes), starts)
            else:
                window_cache_update(kc, k, starts, lanes)
                window_cache_update(vc, v, starts, lanes)
                a = window_attention(q, kc, vc, starts)
            x = self._block_tail(x, a, lw, ln)
        if not self._driver:
            return None
        head = self._head()
        return (ln(x, head["ln_f"]) @ head["lm_head"]).float()

    # -- the commands: the same call on every rank (serving/tp.py) --------
    def _cmd_prefill(self, padded: np.ndarray, length: int, slot: int):
        return self._prefill(self._feed(padded), length, slot)

    def _cmd_prefill_paged(self, padded: np.ndarray, length: int,
                           prefix_len: int, table_row: np.ndarray):
        return self._prefill_paged(self._feed(padded), length, prefix_len,
                                   self._feed(table_row))

    def _cmd_decode(self, feed: np.ndarray, lanes_shape):
        """feed: int32 [tokens (B), positions (B), lanes]."""
        B = self.ecfg.max_batch
        f = self._feed(feed)
        return self._decode(f[:B].long(), f[B:2 * B],
                            f[2 * B:].view(lanes_shape))

    def _cmd_verify(self, feed: np.ndarray, W: int, lanes_shape):
        """feed: int32 [tokens (B x W), starts (B), lanes]."""
        B = self.ecfg.max_batch
        n = B * W
        f = self._feed(feed)
        return self._verify(f[:n].view(B, W).long(), f[n:n + B],
                            f[n + B:].view(lanes_shape))

    # ------------------------------------------------------------------
    def warmup(self) -> Dict[str, float]:
        """Run the decode tick (slab: every lane masked, nothing written;
        paged: every table row zeroed, the writes land on scratch page 0),
        one prefill per bucket (paged: into page 0), the verify window
        when ``verify_window >= 2`` (masked the same way) and the KV
        handoff's copies once (paged: page 0 read and written back; slab: a
        chunk of a free slot's rows), so the first request pays no
        first-call costs: the kernel build and load, library handles. Live
        slots' rows are never changed. Every tp rank warms up. Returns
        {path: wall ms} (the driver's)."""
        free = None
        if not self.paged and self.cache.free_slot_count():
            free = next(i for i in range(self.ecfg.max_batch)
                        if not self.cache.is_live(i))
        return self._cmd("warmup", free)

    def _cmd_warmup(self, free: Optional[int]) -> Dict[str, float]:
        timings: Dict[str, float] = {}
        B = self.ecfg.max_batch
        zeros = torch.zeros((B,), dtype=torch.int32, device=self.device)

        def timed(label, fn):
            t0 = time.perf_counter()
            fn()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            timings[label] = (time.perf_counter() - t0) * 1e3

        if self.paged:
            M = self.cache.max_pages_per_slot
            table0 = torch.zeros((B, M), dtype=torch.int32,
                                 device=self.device)
            timed("decode", lambda: self._decode(zeros.long(), zeros,
                                                 table0))
        else:
            timed("decode", lambda: self._decode(zeros.long(), zeros, zeros))
        for bucket in self.buckets:
            toks = torch.zeros((1, bucket), dtype=torch.long,
                               device=self.device)
            if self.paged:
                timed(f"prefill_b{bucket}",
                      lambda: self._prefill_paged(toks, 1, 0, table0[0]))
            else:
                timed(f"prefill_b{bucket}",
                      lambda: self._prefill(toks, 1, 0))
        W = self.ecfg.verify_window
        if W >= 2:
            toks = torch.zeros((B, W), dtype=torch.long, device=self.device)
            timed(f"verify_w{W}", lambda: self._verify(
                toks, zeros, table0 if self.paged else zeros))
        # the KV handoff's copies (this rank's heads): paged, page 0 out
        # and back; slab, a chunk of a free slot's rows (never a live
        # slot's)
        cache = self.cache
        if self.paged:
            timed("page_io", lambda: cache._write_pages_local(
                [0], *cache._read_pages_local([0])))
        elif free is not None:
            n = min(kv_transfer.DEFAULT_CHUNK_ROWS, self.ecfg.max_seq)
            timed("kv_transfer", lambda: cache._write_rows_local(
                free, 0, *cache._read_rows_local(free, 0, n)))
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
        """Would a prompt admit right now? The scheduler's head-of-line
        check; never raises. Slab: a free slot. Paged:
        ``PagedKVCache.can_admit``."""
        if self.paged:
            return self.cache.can_admit(prompt_len)
        return self.cache.free_slot_count() > 0

    def _trim_prefix(self, n: int, prefix_len: int,
                     prefix_pages: Tuple[int, ...]):
        """Shrink a prefix hit until the suffix's bucket fits behind it
        (prefix_len + bucket(suffix) <= max_seq keeps the page writes and
        the positional table in range)."""
        while prefix_len > 0:
            try:
                bucket = self.bucket_for(n - prefix_len)
            except PromptTooLongError:
                bucket = None
            if (bucket is not None
                    and prefix_len + bucket <= self.ecfg.max_seq):
                return prefix_len, prefix_pages
            prefix_len -= self.cache.page_size
            prefix_pages = prefix_pages[:-1]
        return 0, ()

    def _check_poisoned(self) -> None:
        if self.poisoned is not None:
            raise RuntimeError(f"engine poisoned: {self.poisoned}")
        if self._closed:
            raise RuntimeError("engine closed: its tp ranks were stopped")

    def _poison_on_donation_failure(self, name: str, exc: Exception) -> None:
        """A call that writes the caches in place died on the card: mark
        the engine poisoned (the caches, and the CUDA context, can no
        longer be trusted) rather than serve from them. On the CPU the
        engine stays usable."""
        if self._in_place and self.poisoned is None:
            self.poisoned = (
                f"{name} failed after writing the caches in place "
                f"({type(exc).__name__}: {exc}); KV caches invalidated — "
                f"rebuild the engine")

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
        CacheFullError when no slot is free, PagePoolFullError when the
        paged pool is dry, and PromptTooLongError above the ladder."""
        self._check_poisoned()
        n = len(tokens)
        if n < 1:
            raise ValueError("empty prompt")
        if self.paged:
            return self._start_paged(tokens, n, params)
        bucket = self.bucket_for(n)
        slot = self.cache.alloc(length=n)
        logits, tok = self._prefill_sampled(
            slot, tokens, bucket, params, n,
            lambda toks: self._cmd("prefill", toks, n, slot),
            {"bucket": bucket, "prompt_len": n, "slot": slot})
        smetrics.m_prefill_tokens.inc(n)
        return slot, logits, tok

    def _prefill_sampled(self, slot: int, tokens: Sequence[int],
                         bucket: int, params: SamplingParams, n: int, run,
                         attrs: dict) -> Tuple[np.ndarray, int]:
        """Pad ``tokens`` to ``bucket``, run the prefill ``run(padded)``
        (the [1, bucket] int64 host array) and sample the token after position ``n - 1``; frees ``slot`` when
        either raises; a failure of the prefill itself poisons the engine
        on the card. Records ``serve/prefill`` (``attrs``) in the calling
        thread's span context: it ends once the logits are on the host,
        which waits for the device. Returns (logits[V], token)."""
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :len(tokens)] = np.asarray(tokens, np.int64)
        t0 = time.perf_counter_ns()
        try:
            logits = run(padded).cpu()
        except Exception as e:
            self._poison_on_donation_failure(f"prefill_b{bucket}", e)
            self.cache.free(slot)
            raise
        try:
            tok = sample_token(logits, params.temperature, params.top_k,
                               params.top_p, params.seed, n - 1)
        except Exception:
            self.cache.free(slot)
            raise
        t1 = time.perf_counter_ns()
        smetrics.m_prefill_ms.observe((t1 - t0) / 1e6)
        _spans.record("serve/prefill", t0, t1 - t0, attrs=attrs)
        return logits.numpy(), tok

    def _start_paged(self, tokens: Sequence[int], n: int,
                     params: SamplingParams) -> Tuple[int, np.ndarray, int]:
        """Paged admission: attach the longest cached prefix, prefill only
        the suffix, then publish the prompt's full pages."""
        prefix_len, prefix_pages = 0, ()
        if self.prefix is not None:
            prefix_len, prefix_pages = self.prefix.lookup(tokens)
            prefix_len, prefix_pages = self._trim_prefix(
                n, prefix_len, tuple(prefix_pages))
        suffix = list(tokens[prefix_len:])
        bucket = self.bucket_for(len(suffix))
        slot = self.cache.alloc(length=n, prefix_pages=prefix_pages)
        table_row = self.cache.table_row(slot)
        logits, tok = self._prefill_sampled(
            slot, suffix, bucket, params, n,
            lambda toks: self._cmd("prefill_paged", toks, len(suffix),
                                   prefix_len, table_row),
            {"bucket": bucket, "prompt_len": n, "prefix_len": prefix_len,
             "slot": slot})
        smetrics.m_prefill_tokens.inc(len(suffix))
        if self.prefix is not None:
            added = self.prefix.insert(tokens, table_row)
            if added and self.prefix_store is not None:
                self.prefix_store.maybe_publish(tokens, table_row,
                                                self.cache)
        return slot, logits, tok

    def resume_sequence_sampled(
            self, tokens: Sequence[int], params: SamplingParams
    ) -> Tuple[int, np.ndarray, int]:
        """Re-prefill a preempted request's prompt + generated stream,
        which may exceed the bucket ladder: the head prefills through the
        largest bucket and the tail replays through the decode tick (its
        sampled outputs are discarded; the stream is known). Returns
        (slot, last logits[V], next token) as
        :meth:`start_sequence_sampled`. A failure during the replay (a
        PagePoolFullError) frees the slot and re-raises."""
        n = len(tokens)
        if n <= self.buckets[-1]:
            return self.start_sequence_sampled(tokens, params)
        head = list(tokens[:self.buckets[-1]])
        slot, _logits, _tok = self.start_sequence_sampled(head, params)
        try:
            for i in range(len(head), n - 1):
                self.decode_step_sampled({slot: int(tokens[i])}, None)
            out = self.decode_step_sampled({slot: int(tokens[n - 1])},
                                           {slot: params})
        except Exception:
            if self.poisoned is None and self.cache.is_live(slot):
                self.cache.free(slot)
            raise
        tok, logits = out[slot]
        return slot, logits, tok

    def ensure_decode_capacity(self, slot: int, extra: int = 1) -> bool:
        """Make the next ``extra`` positions of ``slot`` writable. Paged:
        maps pages on demand (False = the pool is dry even after a
        prefix-cache reclaim — the scheduler preempts). Slab: always True
        (the slab is the capacity; headroom is checked apart)."""
        if not self.paged:
            return True
        return self.cache.ensure_capacity(slot,
                                          self.cache.length(slot) + extra)

    def _decode_feed(self, slot_tokens: Dict[int, int]) -> np.ndarray:
        """[2, max_batch] int32: tokens, positions (0 for absent lanes)."""
        feed = np.zeros((2, self.ecfg.max_batch), np.int32)
        for slot, tok in slot_tokens.items():
            if not self.cache.is_live(slot):
                raise ValueError(f"slot {slot} is not live")
            if self.cache.headroom(slot) < 1:
                raise ValueError(
                    f"slot {slot} is at max_seq {self.ecfg.max_seq}")
            feed[:, slot] = (tok, self.cache.length(slot))
        return feed

    def _masked_tables(self, active_slots) -> np.ndarray:
        """Page-table feed with every lane absent from this call zeroed,
        so its writes land on scratch page 0 — a live slot riding along
        keeps its pages untouched."""
        tables = self.cache.tables()
        active = set(active_slots)
        for s in range(self.ecfg.max_batch):
            if s not in active:
                tables[s, :] = 0
        return tables

    def _decode_lanes(self, slot_tokens: Dict[int, int]) -> np.ndarray:
        """The tick's lane feed, int32. Slab: the [B] write mask. Paged:
        the page each fed slot writes is mapped first (PagePoolFullError,
        before any launch, when the pool cannot), then the masked [B, M]
        page tables."""
        if not self.paged:
            active = np.zeros((self.ecfg.max_batch,), np.int32)
            active[list(slot_tokens)] = 1
            return active
        for slot in slot_tokens:
            if not self.ensure_decode_capacity(slot):
                raise PagePoolFullError(
                    f"slot {slot}: no free page for position "
                    f"{self.cache.length(slot)}")
        return self._masked_tables(slot_tokens)

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
        masked lanes (paged: with zeroed page tables)."""
        if not slot_tokens:
            return {}
        self._check_poisoned()
        head = self._decode_feed(slot_tokens)
        # host-side: a PagePoolFullError here comes before any launch
        lanes = self._decode_lanes(slot_tokens)
        sp = batch_arrays(params_by_slot or {}, self.ecfg.max_batch)
        t0 = time.perf_counter_ns()
        try:
            logits = self._cmd("decode", np.concatenate(
                [head.ravel(), lanes.ravel()]), lanes.shape).cpu()
        except Exception as e:
            self._poison_on_donation_failure("decode", e)
            raise
        toks = sample_batch(logits, *sp, head[1])
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

    def verify_step(
            self, windows: Dict[int, Sequence[int]],
            params_by_slot: Optional[Dict[int, SamplingParams]] = None
    ) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
        """Speculative verification (``engine.py:1088-1147``): {slot: [W
        window tokens]} -> {slot: (logits [W, V], target tokens [W])} in
        one forward. The window's rows land at ``length + w``; lengths do
        not move — the caller commits the accepted rows with
        :meth:`commit_window`. Paged: the pages of the W rows are mapped
        first (PagePoolFullError before any launch). A failure after the
        caches were written poisons the engine on the card."""
        if not windows:
            return {}
        self._check_poisoned()
        W = self.ecfg.verify_window
        if W < 2:
            raise RuntimeError("engine built without a verify window "
                               "(EngineConfig.verify_window >= 2)")
        B = self.ecfg.max_batch
        tokens = np.zeros((B, W), np.int32)
        starts = np.zeros((B,), np.int32)
        for slot, win in windows.items():
            if len(win) != W:
                raise ValueError(f"slot {slot}: window {len(win)} != {W}")
            if not self.cache.is_live(slot):
                raise ValueError(f"slot {slot} is not live")
            if self.cache.headroom(slot) < W:
                raise ValueError(f"slot {slot}: headroom < window {W}")
            tokens[slot] = np.asarray(win, np.int32)
            starts[slot] = self.cache.length(slot)
        if self.paged:
            for slot in windows:
                if not self.ensure_decode_capacity(slot, extra=W):
                    raise PagePoolFullError(
                        f"slot {slot}: no free pages for a {W}-token "
                        "verify window")
            lanes = self._masked_tables(windows)
        else:
            lanes = np.zeros((B,), np.int32)
            lanes[list(windows)] = 1
        sp = batch_arrays(params_by_slot or {}, B)
        t0 = time.perf_counter_ns()
        try:
            logits = self._cmd("verify", np.concatenate(
                [tokens.ravel(), starts, lanes.ravel()]), W,
                lanes.shape).cpu()
        except Exception as e:
            self._poison_on_donation_failure(f"verify_w{W}", e)
            raise
        toks = sample_window(logits, *sp,
                             starts[:, None] + np.arange(W, dtype=np.int32))
        smetrics.m_decode_ms.observe((time.perf_counter_ns() - t0) / 1e6)
        self.verify_steps += 1
        logits_np = logits.numpy()
        return {slot: (logits_np[slot], toks[slot]) for slot in windows}

    def commit_window(self, slot: int, n_accepted_rows: int) -> None:
        """Advance ``slot`` past ``n_accepted_rows`` verified window rows
        (their K/V are in the cache already; rejected rows are overwritten
        by later writes)."""
        self.cache.set_length(slot, self.cache.length(slot)
                              + int(n_accepted_rows))

    def free_sequence(self, slot: int) -> None:
        self.cache.free(slot)

    def note_tokens(self, n: int, window_s: float = 5.0) -> None:
        """Count generated tokens and refresh the tokens/s gauge over the
        trailing window (a speculative draft meters nothing)."""
        if not self.meter_tokens:
            return
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
        truth the cached decode path and the quantized weights are held
        to."""
        if self._ref_params is None:
            raise RuntimeError("reference params were dropped")
        with torch.no_grad():
            out = gpt_mod.forward(self._ref_params,
                                  np.asarray(tokens, np.int64)[None],
                                  self.cfg)
        return out[0].float().cpu().numpy()

    def drop_reference_params(self) -> None:
        """Let the float32 truth go (it stays on the card otherwise), so
        that only the serving weight set is resident."""
        self._ref_params = None
