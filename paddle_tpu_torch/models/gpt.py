"""GPT decoder in PyTorch — the port of ``paddle_tpu/models/gpt.py``.

Same parameter layout as the JAX model (``gpt.py:96-132``), so a JAX
parameter tree carries across leaf for leaf (:func:`params_from_numpy`):
per-layer leaves are stacked on a leading ``num_layers`` axis, QKV is
``[L, D, 3, nh, hd]`` and the output projection ``[L, nh, hd, D]``.
Master weights stay float32; ``GPTConfig.dtype`` is the compute dtype.

The layer loop is a Python loop where JAX used ``lax.scan``, each block
wrapped by its remat policy (``parallel/remat.py``). The training losses
(``token_ce``, ``ce_from_hidden``, ``loss_fn``) and the kernel hooks are
here: flash attention (``use_flash``), the fused-layernorm block
(``fused_ln``: every block LN and the final LN through
``ops/fused_ln.py``, ln2 taking the ``(x + o) + b_proj`` residual in the
same launch) and the vocab-chunked CE (``ce_vocab_chunk > 0``, through
``ops/chunked_ce.py``).

Tensor parallelism (``param_specs``, ``block_fn(tp_group=)``) is the
reference's Megatron split with sequence parallelism (``gpt.py:135-271``):
QKV and ``fc`` column-split, ``proj`` and ``out`` row-split, and between
blocks the activation stays sharded on the sequence axis, all-gathered
before each column-parallel product and sum-scattered after each
row-parallel one (two autograd Functions, each the other's transpose).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..observability import hw
from ..ops.chunked_ce import chunked_lm_loss
from ..ops.fused_ln import fused_ln
from ..parallel import comm_opt
from ..parallel import remat as remat_mod

__all__ = ["GPTConfig", "GPT_SMALL", "GPT_TINY", "init_params",
           "params_from_numpy", "param_shapes", "param_specs", "embed", "block_fn", "run_blocks",
           "logits_fn", "forward", "token_ce", "ce_from_hidden", "loss_fn",
           "num_params", "train_flops_per_token"]


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """Field for field the JAX ``GPTConfig``; ``dtype`` is a torch dtype.
    ``scan_layers`` is accepted and ignored (the layer loop is always a
    Python loop)."""
    vocab_size: int = 32000
    max_seq_len: int = 2048
    num_layers: int = 24
    num_heads: int = 16
    d_model: int = 2048
    d_ff: int = 8192
    dropout: float = 0.0
    dtype: Any = torch.bfloat16   # compute dtype (params stay f32)
    remat: bool = True
    remat_policy: str = "full"
    use_flash: bool = False
    scan_layers: bool = True
    ce_direct_bytes_limit: int = 4 << 30
    ce_chunk: int = 2048
    ce_vocab_chunk: int = 0
    fused_ln: bool = False

    def __post_init__(self):
        remat_mod.resolve(self.remat_policy)   # validates the name

    @property
    def head_dim(self) -> int:
        if self.d_model % self.num_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of "
                             f"num_heads {self.num_heads}")
        return self.d_model // self.num_heads

    def scaled(self, **kw) -> "GPTConfig":
        return dataclasses.replace(self, **kw)


# 124M-ish config for single-card runs; tiny config for tests.
GPT_SMALL = GPTConfig(vocab_size=50304, max_seq_len=1024, num_layers=12,
                      num_heads=12, d_model=768, d_ff=3072)
GPT_TINY = GPTConfig(vocab_size=256, max_seq_len=64, num_layers=4,
                     num_heads=4, d_model=64, d_ff=128, dtype=torch.float32,
                     remat=False)


def init_params(cfg: GPTConfig, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """GPT-2-style init from ``seed`` (a ``torch.Generator`` on the target
    device — the bits differ from JAX's threefry; tests carry JAX params
    across with :func:`params_from_numpy` instead)."""
    dev = resolve_device(device)
    L, D, Fd = cfg.num_layers, cfg.d_model, cfg.d_ff
    nh, hd, V = cfg.num_heads, cfg.head_dim, cfg.vocab_size
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    std = 0.02
    resid_std = std / math.sqrt(2 * L)

    def norm(shape, s=std):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * s

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=torch.float32)

    def zeros(shape):
        return torch.zeros(shape, device=dev, dtype=torch.float32)

    return {
        "wte": norm((V, D)),
        "wpe": norm((cfg.max_seq_len, D), s=0.01),
        "lm_head": norm((D, V)),
        "ln_f_scale": ones((D,)),
        "ln_f_bias": zeros((D,)),
        "blocks": {
            "ln1_scale": ones((L, D)),
            "ln1_bias": zeros((L, D)),
            "w_qkv": norm((L, D, 3, nh, hd)),
            "b_qkv": zeros((L, 3, nh, hd)),
            "w_proj": norm((L, nh, hd, D), s=resid_std),
            "b_proj": zeros((L, D)),
            "ln2_scale": ones((L, D)),
            "ln2_bias": zeros((L, D)),
            "w_fc": norm((L, D, Fd)),
            "b_fc": zeros((L, Fd)),
            "w_out": norm((L, Fd, D), s=resid_std),
            "b_out": zeros((L, D)),
        },
    }


def param_shapes(cfg: GPTConfig) -> Dict[str, Any]:
    """The shape of every leaf of :func:`init_params`, without making it."""
    L, D, Fd = cfg.num_layers, cfg.d_model, cfg.d_ff
    nh, hd, V = cfg.num_heads, cfg.head_dim, cfg.vocab_size
    return {
        "wte": (V, D), "wpe": (cfg.max_seq_len, D), "lm_head": (D, V),
        "ln_f_scale": (D,), "ln_f_bias": (D,),
        "blocks": {
            "ln1_scale": (L, D), "ln1_bias": (L, D),
            "w_qkv": (L, D, 3, nh, hd), "b_qkv": (L, 3, nh, hd),
            "w_proj": (L, nh, hd, D), "b_proj": (L, D),
            "ln2_scale": (L, D), "ln2_bias": (L, D),
            "w_fc": (L, D, Fd), "b_fc": (L, Fd),
            "w_out": (L, Fd, D), "b_out": (L, D),
        },
    }


def params_from_numpy(tree, device="cuda") -> Dict[str, Any]:
    """Nested dict of array-likes (e.g. a JAX parameter tree passed
    through ``np.asarray``) -> the same nesting of float32 tensors."""
    dev = resolve_device(device)

    def conv(leaf):
        if isinstance(leaf, dict):
            return {k: conv(v) for k, v in leaf.items()}
        return torch.from_numpy(np.array(leaf, dtype=np.float32)).to(dev)

    return conv(tree)


def param_specs(cfg: GPTConfig, pp: str = "pp", tp: str = "tp"
                ) -> Dict[str, Any]:
    """The spec of every leaf over the mesh axes (pp, tp); dp never shards
    params. Block leaves are stage-sharded on the stacked layer axis (pp)
    and head/ffn-sharded (tp) where Megatron splits them; embeddings, the
    final LN and the head are replicated (their grads on the stages that
    do not use them are exact zeros)."""
    del cfg
    return {
        "wte": (),
        "wpe": (),
        "lm_head": (),
        "ln_f_scale": (),
        "ln_f_bias": (),
        "blocks": {
            "ln1_scale": (pp, None),
            "ln1_bias": (pp, None),
            "w_qkv": (pp, None, None, tp, None),
            "b_qkv": (pp, None, tp, None),
            "w_proj": (pp, tp, None, None),
            "b_proj": (pp, None),
            "ln2_scale": (pp, None),
            "ln2_bias": (pp, None),
            "w_fc": (pp, None, tp),
            "b_fc": (pp, tp),
            "w_out": (pp, tp, None),
            "b_out": (pp, None),
        },
    }


def _gather_seq(y, axis):
    """[B, T/tp, ...] on each rank of ``axis`` -> [B, T, ...]. Counted
    into the wire-byte counter at the gathered tensor's bytes."""
    full = axis.all_gather(y.transpose(0, 1).contiguous())
    comm_opt.record_collective("all_gather", full.dtype,
                               full.numel() * full.element_size(), axis.size)
    return full.transpose(0, 1).contiguous()


def _scatter_seq(y, axis):
    """[B, T, ...] -> this rank's [B, T/tp, ...] block of the sum over
    ``axis``. Counted at the summed tensor's bytes."""
    comm_opt.record_collective("psum_scatter", y.dtype,
                               y.numel() * y.element_size(), axis.size)
    part = axis.reduce_scatter(y.transpose(0, 1).contiguous())
    return part.transpose(0, 1).contiguous()


class _SeqAllGather(torch.autograd.Function):
    """all_gather on the sequence axis; its transpose, the backward, is
    the sum-scatter."""

    @staticmethod
    def forward(ctx, y, axis):
        ctx.axis = axis
        return _gather_seq(y, axis)

    @staticmethod
    def backward(ctx, g):
        return _scatter_seq(g, ctx.axis), None


class _SeqReduceScatter(torch.autograd.Function):
    """Sum-scatter on the sequence axis; its transpose, the backward, is
    the all_gather."""

    @staticmethod
    def forward(ctx, y, axis):
        ctx.axis = axis
        return _scatter_seq(y, axis)

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.axis), None


def _layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the last axis with float32 statistics (population
    variance, as ``jnp.var``), result in ``x.dtype``."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _causal_attention(q, k, v, cfg: GPTConfig):
    """q, k, v: [B, T, nh, hd] -> [B, T, nh, hd]; scores in the compute
    dtype, masked and soft-maxed in float32 (the JAX plain path), or the
    flash-attention kernels when ``cfg.use_flash``."""
    if cfg.use_flash:
        from ..ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=True)
    T = q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = (torch.einsum("bqhd,bkhd->bhqk", q, k) * scale).float()
    mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    # tagged so the save_only_flash remat policy keeps it (gpt.py:196)
    return remat_mod.checkpoint_name(torch.einsum("bhqk,bkhd->bqhd", probs,
                                                  v))


def block_fn(p, x, cfg: GPTConfig, tp_group=None):
    """One transformer block on one layer's leaves (no L axis; tp-local
    shards under tensor parallelism).

    With ``tp_group`` (the tp line, ``parallel.mesh.AxisGroup``) ``x``
    arrives sequence-sharded, [B, T/tp, D]: all-gathered on the sequence
    before QKV and ``fc``, sum-scattered after ``proj`` and ``out``. The
    biases are added on the sequence-sharded side, so every replicated
    leaf's grad is a partial sum over tp."""
    dt = cfg.dtype
    if tp_group is None or tp_group.size == 1:
        def gather(y):
            return y

        scatter_sum = gather
    else:
        def gather(y):
            return _SeqAllGather.apply(y, tp_group)

        def scatter_sum(y):
            return _SeqReduceScatter.apply(y, tp_group)

    if cfg.fused_ln:
        h = fused_ln(x, p["ln1_scale"], p["ln1_bias"], eps=1e-5)
    else:
        h = _layer_norm(x, p["ln1_scale"], p["ln1_bias"])
    h = gather(h)
    qkv = torch.einsum("btd,dcnh->btcnh", h, p["w_qkv"].to(dt))
    qkv = qkv + p["b_qkv"].to(dt)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    a = _causal_attention(q, k, v, cfg)
    o = scatter_sum(torch.einsum("btnh,nhd->btd", a, p["w_proj"].to(dt)))
    if cfg.fused_ln:
        # one launch for the (x + o) + b_proj residual and ln2; the summed
        # stream comes back as the next residual input
        h, x = fused_ln(o, p["ln2_scale"], p["ln2_bias"], residual=x,
                        bias_add=p["b_proj"].to(dt), eps=1e-5,
                        return_residual=True)
    else:
        x = x + o + p["b_proj"].to(dt)
        h = _layer_norm(x, p["ln2_scale"], p["ln2_bias"])
    h = gather(h)
    h = torch.einsum("btd,df->btf", h, p["w_fc"].to(dt)) + p["b_fc"].to(dt)
    h = F.gelu(h, approximate="tanh")
    o = scatter_sum(torch.einsum("btf,fd->btd", h, p["w_out"].to(dt)))
    return x + o + p["b_out"].to(dt)


def run_blocks(blocks, x, cfg: GPTConfig, tp_group=None):
    """The stacked layers of ``blocks`` over ``x``, each block under the
    config's remat policy (``tp_group`` as :func:`block_fn`). The [L, ...]
    leaves are unbound once, so the backward stacks each leaf's gradient
    in one piece."""
    f = remat_mod.resolve(cfg.remat_policy, remat=cfg.remat).wrap(block_fn)
    layers = {k: v.unbind(0) for k, v in blocks.items()}
    for i in range(len(next(iter(layers.values())))):
        x = f({k: v[i] for k, v in layers.items()}, x, cfg, tp_group)
    return x


def embed(p, tokens, cfg: GPTConfig, pos_offset: int = 0):
    """tokens [B, T] -> [B, T, D] in the compute dtype; the two tables are
    summed in float32 before the cast."""
    T = tokens.shape[1]
    pos = pos_offset + torch.arange(T, device=tokens.device)
    x = p["wte"][tokens].float() + p["wpe"][pos].float()
    return x.to(cfg.dtype)


def _final_ln(p, x, cfg: GPTConfig):
    if cfg.fused_ln:
        return fused_ln(x, p["ln_f_scale"], p["ln_f_bias"], eps=1e-5)
    return _layer_norm(x, p["ln_f_scale"], p["ln_f_bias"])


def logits_fn(p, x, cfg: GPTConfig):
    x = _final_ln(p, x, cfg)
    return torch.einsum("btd,dv->btv", x, p["lm_head"].to(cfg.dtype))


def forward(params, tokens, cfg: GPTConfig):
    """tokens [B, T] -> logits [B, T, V] in the compute dtype."""
    dev = params["wte"].device
    tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long).to(dev)
    x = embed(params, tokens, cfg)
    x = run_blocks(params["blocks"], x, cfg)
    return logits_fn(params, x, cfg)


def token_ce(logits, labels, valid=None):
    """Summed (not mean) token cross-entropy in float32: lse - gold, with
    ``valid`` masking padding rows."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.unsqueeze(-1)).squeeze(-1)
    ce = lse - gold
    if valid is not None:
        ce = torch.where(valid, ce, torch.zeros_like(ce))
    return ce.sum()


def ce_from_hidden(params, x, labels, cfg: GPTConfig, chunk=None,
                   direct_bytes_limit=None):
    """Summed token CE from hidden states ``x`` [B, T, D]: with
    ``cfg.ce_vocab_chunk`` the vocab-chunked CE (``chunked_lm_loss``, row
    chunks of ``chunk`` rows); else the full logits when their float32
    size fits ``direct_bytes_limit``, else row chunks of ``chunk`` rows,
    each recomputing its logits in the backward (checkpointed) and
    accumulated in order as JAX's scan does."""
    if chunk is None:
        chunk = cfg.ce_chunk
    if direct_bytes_limit is None:
        direct_bytes_limit = cfg.ce_direct_bytes_limit
    head = params["lm_head"]
    B, T, D = x.shape
    V = head.shape[-1]
    x = _final_ln(params, x, cfg)
    n = B * T
    if cfg.ce_vocab_chunk:
        return chunked_lm_loss(x.reshape(n, D), head.to(cfg.dtype),
                               labels.reshape(n),
                               vocab_chunk=cfg.ce_vocab_chunk,
                               row_chunk=chunk)
    if n * V * 4 <= direct_bytes_limit:
        logits = torch.einsum("btd,dv->btv", x, head.to(cfg.dtype))
        return token_ce(logits, labels)
    rows, labs = x.reshape(n, D), labels.reshape(n)
    pad = (-n) % chunk
    if pad:   # remainder rows are masked out of the sum
        rows = torch.cat([rows, rows.new_zeros((pad, D))])
        labs = torch.cat([labs, labs.new_zeros((pad,))])
    valid = (torch.arange(n + pad, device=x.device) < n).reshape(-1, chunk)

    def chunk_ce(xc, lc, vc, head):
        logits = torch.einsum("rd,dv->rv", xc, head.to(cfg.dtype))
        return token_ce(logits, lc, valid=vc)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for xc, lc, vc in zip(rows.split(chunk), labs.split(chunk), valid):
        total = total + checkpoint(chunk_ce, xc, lc, vc, head,
                                   use_reentrant=False)
    return total


def loss_fn(params, tokens, labels, cfg: GPTConfig):
    """Mean next-token loss, single-device semantics; tokens and labels
    are int64 [B, T] on the params' device."""
    x = embed(params, tokens, cfg)
    x = run_blocks(params["blocks"], x, cfg)
    return ce_from_hidden(params, x, labels, cfg) / labels.numel()


def num_params(params) -> int:
    if isinstance(params, dict):
        return sum(num_params(v) for v in params.values())
    return int(params.numel())


def train_flops_per_token(cfg: GPTConfig, n_params: int, T: int) -> float:
    """Forward + backward FLOPs per trained token: 6N plus the attention
    term (per layer QK^T + AV = 4·T·d a token forward, x3 with the
    backward) — the numerator of every MFU figure."""
    return hw.transformer_train_flops_per_token(n_params, cfg.num_layers,
                                                cfg.d_model, T)
