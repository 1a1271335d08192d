"""ERNIE/BERT encoder in PyTorch: the port of ``paddle_tpu/models/ernie.py``.

The same parameter tree as the JAX model (``ernie.py:67-106``), so a JAX
tree carries across leaf for leaf (:func:`params_from_numpy`): per-layer
leaves stacked on a leading ``num_layers`` axis, QKV ``[L, D, 3, nh, hd]``,
the output projection ``[L, nh, hd, D]``. Master weights stay float32;
``ErnieConfig.dtype`` is the compute dtype.

A post-LN encoder with exact GELU, bidirectional attention under a padding
mask — the flash kernels with the ``[B, 1, 1, T]`` bias form when
``use_flash`` (0 at real keys, -0.5·f32 max at padded ones), else plain
attention — and the pretraining losses: masked LM over gathered positions
(direct tied-decoder CE, or the vocab-chunked CE over the ``"vd"`` table
when ``ce_vocab_chunk``) plus next-sentence prediction. ``fused_ln`` sends
each post-LN residual add through ``ops/fused_ln.py``. The layer loop is a
Python loop where JAX used ``lax.scan``, each block under its remat
policy (``parallel/remat.py``). :func:`make_pretrain_step` is the
momentum-0.9 step, updated in place: on one device, or on a (dp, tp)
mesh of ranks (``mesh=``): the batch split over dp, the blocks Megatron-
split over tp (:func:`param_specs`: QKV and ``fc`` by columns over heads
and ffn, ``proj`` and ``out`` by rows, summed after) with sequence
parallelism between them (``models/gpt``'s autograd pair), the
embeddings, heads and pooler replicated, and every gradient summed over
the mesh axes its spec does not name.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..observability import hw
from ..ops.chunked_ce import chunked_lm_loss
from ..ops.flash_attention import flash_attention
from ..ops.fused_ln import fused_ln
from ..parallel import remat as remat_mod
from ..parallel.parallelize import _unflatten, flat_leaves
from .gpt import (_SeqAllGather, _SeqReduceScatter, _layer_norm, num_params,
                  params_from_numpy)

__all__ = ["ErnieConfig", "ERNIE_BASE", "ERNIE_TINY", "init_params",
           "params_from_numpy", "param_shapes", "param_specs",
           "batch_to_device", "encode",
           "pretrain_loss", "make_pretrain_step", "init_opt", "num_params",
           "pretrain_flops_per_token"]

# the padding bias of the flash path (ernie.py:154-157)
_PAD_BIAS = -0.5 * float(np.finfo(np.float32).max)


@dataclasses.dataclass(frozen=True)
class ErnieConfig:
    """Field for field the JAX ``ErnieConfig``; ``dtype`` is a torch
    dtype."""
    vocab_size: int = 30522
    type_vocab_size: int = 2
    max_seq_len: int = 512
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    dtype: Any = torch.bfloat16   # compute dtype (params stay f32)
    remat: bool = True
    remat_policy: str = "full"
    use_flash: bool = False
    max_masked: int = 20          # MLM positions per sample
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

    def scaled(self, **kw) -> "ErnieConfig":
        return dataclasses.replace(self, **kw)


ERNIE_BASE = ErnieConfig()
ERNIE_TINY = ErnieConfig(vocab_size=256, type_vocab_size=2, max_seq_len=64,
                         num_layers=2, num_heads=4, d_model=32, d_ff=64,
                         dtype=torch.float32, remat=False, max_masked=4)


def init_params(cfg: ErnieConfig, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """BERT-style init from ``seed`` (a ``torch.Generator`` on the target
    device — the bits differ from JAX's; tests carry JAX params across
    with :func:`params_from_numpy` instead)."""
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
        "wpe": norm((cfg.max_seq_len, D)),
        "wse": norm((cfg.type_vocab_size, D)),
        "ln_emb_scale": ones((D,)),
        "ln_emb_bias": zeros((D,)),
        "blocks": {
            "w_qkv": norm((L, D, 3, nh, hd)),
            "b_qkv": zeros((L, 3, nh, hd)),
            "w_proj": norm((L, nh, hd, D), s=resid_std),
            "b_proj": zeros((L, D)),
            "ln1_scale": ones((L, D)),
            "ln1_bias": zeros((L, D)),
            "w_fc": norm((L, D, Fd)),
            "b_fc": zeros((L, Fd)),
            "w_out": norm((L, Fd, D), s=resid_std),
            "b_out": zeros((L, D)),
            "ln2_scale": ones((L, D)),
            "ln2_bias": zeros((L, D)),
        },
        "mlm_w": norm((D, D)),
        "mlm_b": zeros((D,)),
        "mlm_ln_scale": ones((D,)),
        "mlm_ln_bias": zeros((D,)),
        "mlm_dec_bias": zeros((V,)),
        "pool_w": norm((D, D)),
        "pool_b": zeros((D,)),
        "nsp_w": norm((D, 2)),
        "nsp_b": zeros((2,)),
    }


def param_shapes(cfg: ErnieConfig) -> Dict[str, Any]:
    """The shape of every leaf of :func:`init_params`, without making it."""
    L, D, Fd = cfg.num_layers, cfg.d_model, cfg.d_ff
    nh, hd, V = cfg.num_heads, cfg.head_dim, cfg.vocab_size
    return {
        "wte": (V, D), "wpe": (cfg.max_seq_len, D),
        "wse": (cfg.type_vocab_size, D), "ln_emb_scale": (D,),
        "ln_emb_bias": (D,),
        "blocks": {
            "w_qkv": (L, D, 3, nh, hd), "b_qkv": (L, 3, nh, hd),
            "w_proj": (L, nh, hd, D), "b_proj": (L, D),
            "ln1_scale": (L, D), "ln1_bias": (L, D),
            "w_fc": (L, D, Fd), "b_fc": (L, Fd),
            "w_out": (L, Fd, D), "b_out": (L, D),
            "ln2_scale": (L, D), "ln2_bias": (L, D),
        },
        "mlm_w": (D, D), "mlm_b": (D,), "mlm_ln_scale": (D,),
        "mlm_ln_bias": (D,), "mlm_dec_bias": (V,), "pool_w": (D, D),
        "pool_b": (D,), "nsp_w": (D, 2), "nsp_b": (2,),
    }


def param_specs(cfg: ErnieConfig, tp: str = "tp") -> Dict[str, Any]:
    """The spec of every leaf on a (dp, tp) mesh (``ernie.py:109-130``):
    the embeddings and heads replicated, the blocks Megatron-split on
    heads / ffn; the layer axis is not sharded."""
    del cfg
    rep = ()
    return {
        "wte": rep, "wpe": rep, "wse": rep,
        "ln_emb_scale": rep, "ln_emb_bias": rep,
        "blocks": {
            "w_qkv": (None, None, None, tp, None),
            "b_qkv": (None, None, tp, None),
            "w_proj": (None, tp, None, None),
            "b_proj": (None, None),
            "ln1_scale": (None, None), "ln1_bias": (None, None),
            "w_fc": (None, None, tp), "b_fc": (None, tp),
            "w_out": (None, tp, None), "b_out": (None, None),
            "ln2_scale": (None, None), "ln2_bias": (None, None),
        },
        "mlm_w": rep, "mlm_b": rep, "mlm_ln_scale": rep, "mlm_ln_bias": rep,
        "mlm_dec_bias": rep, "pool_w": rep, "pool_b": rep,
        "nsp_w": rep, "nsp_b": rep,
    }


def batch_to_device(batch, device="cuda") -> Dict[str, torch.Tensor]:
    """A pretraining batch of arrays or tensors (tokens, seg_ids, pad_mask,
    mlm_pos, mlm_ids, mlm_valid, nsp_label) -> tensors on ``device``:
    int64 indices, bool masks."""
    dev = resolve_device(device)
    out = {}
    for k, x in batch.items():
        t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
        out[k] = (t if t.dtype == torch.bool else t.long()).to(dev)
    return out


def _ln(x, scale, bias):
    """LayerNorm with float32 statistics and BERT's eps 1e-12."""
    return _layer_norm(x, scale, bias, eps=1e-12)


def _key_mask(pad_mask, cfg: ErnieConfig):
    """The attention's form of the padding mask, made once a step: on the
    flash path the O(B·T) bias [B, 1, 1, Tk] (0 at real keys, no
    gradient), broadcast inside the kernel tiles; else the bool mask."""
    if cfg.use_flash and pad_mask is not None:
        return torch.where(pad_mask, 0.0, _PAD_BIAS).to(
            torch.float32)[:, None, None, :]
    return pad_mask


def _attention(q, k, v, mask, cfg: ErnieConfig):
    """Bidirectional attention under the padding mask; q, k, v
    [B, T, nh, hd], ``mask`` as :func:`_key_mask` gives it."""
    if cfg.use_flash:
        return flash_attention(q, k, v, causal=False, bias=mask)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = (torch.einsum("bqhd,bkhd->bhqk", q, k) * scale).float()
    if mask is not None:
        logits = torch.where(mask[:, None, None, :], logits,
                             torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _post_ln(res, o, scale, bias, cfg: ErnieConfig):
    """LN(res + o): one fused-LN launch (forward and backward) when
    ``cfg.fused_ln``."""
    if cfg.fused_ln:
        return fused_ln(o, scale, bias, residual=res, eps=1e-12)
    return _ln(res + o, scale, bias)


def _block(p, x, mask, cfg: ErnieConfig, tp_group=None):
    """One post-LN encoder block on one layer's leaves (no L axis);
    ``mask`` as :func:`_key_mask` gives it. With ``tp_group`` the leaves
    are the rank's Megatron shards and ``x`` arrives sequence-sharded
    [B, T/tp, D]: all-gathered before QKV and ``fc``, sum-scattered after
    ``proj`` and ``out``, the biases and LNs on the sequence shard."""
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

    qkv = torch.einsum("btd,dcnh->btcnh", gather(x), p["w_qkv"].to(dt)) \
        + p["b_qkv"].to(dt)
    a = _attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], mask, cfg)
    o = scatter_sum(torch.einsum("btnh,nhd->btd", a, p["w_proj"].to(dt))) \
        + p["b_proj"].to(dt)
    x = _post_ln(x, o, p["ln1_scale"], p["ln1_bias"], cfg)
    h = torch.einsum("btd,df->btf", gather(x), p["w_fc"].to(dt)) \
        + p["b_fc"].to(dt)
    h = F.gelu(h, approximate="none")
    o = scatter_sum(torch.einsum("btf,fd->btd", h, p["w_out"].to(dt))) \
        + p["b_out"].to(dt)
    return _post_ln(x, o, p["ln2_scale"], p["ln2_bias"], cfg)


def encode(params, tokens, seg_ids, pad_mask, cfg: ErnieConfig,
           tp_group=None):
    """tokens / seg_ids int [B, T], pad_mask bool [B, T] (or None) ->
    hidden [B, T, D] in the compute dtype. With ``tp_group`` (the tp line
    of a mesh; the block leaves its Megatron shards) each rank embeds its
    sequence chunk, the blocks run sequence-parallel and the hidden
    states are all-gathered on the sequence at the end (the gather's
    backward sum-scatters)."""
    T = tokens.shape[1]
    pos = torch.arange(T, device=tokens.device)
    sp = tp_group is not None and tp_group.size > 1
    if sp:
        n = T // tp_group.size
        seq = slice(tp_group.index * n, (tp_group.index + 1) * n)
        tokens, seg_ids, pos = tokens[:, seq], seg_ids[:, seq], pos[seq]
    x = params["wte"][tokens] + params["wpe"][pos] + params["wse"][seg_ids]
    x = _ln(x.to(cfg.dtype), params["ln_emb_scale"], params["ln_emb_bias"])
    f = remat_mod.resolve(cfg.remat_policy, remat=cfg.remat).wrap(_block)
    layers = {k: v.unbind(0) for k, v in params["blocks"].items()}
    mask = _key_mask(pad_mask, cfg)
    for i in range(cfg.num_layers):
        x = f({k: v[i] for k, v in layers.items()}, x, mask, cfg, tp_group)
    return _SeqAllGather.apply(x, tp_group) if sp else x


def _ce(logits, gold_ids):
    """lse - gold in float32 over the last axis."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, gold_ids.unsqueeze(-1)).squeeze(-1)
    return lse - gold


def pretrain_loss(params, batch, cfg: ErnieConfig, tp_group=None,
                  n_masked=None, n_rows=None):
    """ERNIE/BERT pretraining loss: masked LM over the ``max_masked``
    gathered positions plus next-sentence prediction on the pooled [CLS].
    ``batch`` as :func:`batch_to_device` gives it. Returns (loss,
    {"mlm": ..., "nsp": ...}), float32 scalars.

    On a rank of a mesh (``tp_group`` as :func:`encode`), ``n_masked`` and
    ``n_rows`` are the GLOBAL batch's valid MLM positions and rows, so the
    ranks' losses over their dp rows add up to the global loss."""
    dt = cfg.dtype
    h = encode(params, batch["tokens"], batch["seg_ids"], batch["pad_mask"],
               cfg, tp_group)
    B = h.shape[0]
    valid = batch["mlm_valid"]
    b_idx = torch.arange(B, device=h.device)[:, None]
    hm = h[b_idx, batch["mlm_pos"]]                     # [B, M, D]
    hm = F.gelu(torch.einsum("bmd,de->bme", hm, params["mlm_w"].to(dt))
                + params["mlm_b"].to(dt), approximate="none")
    hm = _ln(hm, params["mlm_ln_scale"], params["mlm_ln_bias"])
    if n_masked is None:
        n_masked = valid.sum().clamp(min=1)
    if cfg.ce_vocab_chunk:
        # the tied decoder's CE, vocab-chunked over the "vd" table: the
        # [B, M, V] float32 logits never materialise
        mlm_loss = chunked_lm_loss(
            hm, params["wte"].to(dt), batch["mlm_ids"],
            bias=params["mlm_dec_bias"], valid=valid,
            vocab_chunk=cfg.ce_vocab_chunk, head_layout="vd") / n_masked
    else:
        logits = torch.einsum("bmd,vd->bmv", hm, params["wte"].to(dt)) \
            + params["mlm_dec_bias"].to(dt)
        ce = _ce(logits, batch["mlm_ids"])
        mlm_loss = torch.where(valid, ce, torch.zeros_like(ce)).sum() \
            / n_masked
    pooled = torch.tanh(h[:, 0] @ params["pool_w"].to(dt)
                        + params["pool_b"].to(dt))
    nsp_logits = pooled @ params["nsp_w"].to(dt) + params["nsp_b"].to(dt)
    nsp_ce = _ce(nsp_logits, batch["nsp_label"])
    nsp_loss = nsp_ce.mean() if n_rows is None else nsp_ce.sum() / n_rows
    return mlm_loss + nsp_loss, {"mlm": mlm_loss, "nsp": nsp_loss}


def make_pretrain_step(cfg: ErnieConfig, mesh=None, dp: str = "dp",
                       tp: str = "tp", lr: float = 1e-4, device=None):
    """The pretrain step: ``step(params, opt, batch) -> (params, opt,
    loss)`` with momentum 0.9 on every leaf, ``m = 0.9·m + g`` then
    ``p -= lr·m`` (``ernie.py:276-283``), params and opt updated IN PLACE
    (JAX donates them). Without a mesh: one device (``device``, default
    the card).

    ``mesh`` (a ``parallel.mesh.Mesh`` with axes ``dp`` and ``tp``; others
    of size 1 may be there) is the reference's (dp, tp) step
    (``ernie.py:264-298``): params and moments are this rank's shards by
    :func:`param_specs` (``parallel.parallelize.shard_params``), ``batch``
    is the GLOBAL batch, of which the rank takes its dp rows; the loss is
    the global one on every rank. Each rank's loss is its rows' share
    (divided by the global valid-position and row counts), and over tp a
    tp-th of it (the heads run on the gathered hidden states on every tp
    rank), so the sum over the world is the global loss and every
    gradient, summed over the axes its spec does not name, the global
    gradient."""
    if mesh is None:
        return _single_device_step(cfg, lr, resolve_device(
            "cuda" if device is None else device))
    from ..parallel import mesh as mesh_mod
    from ..parallel import parallelize as PZ

    if not isinstance(mesh, mesh_mod.Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {str(device)!r} disagrees with the "
                         f"mesh's device {mesh.device}")
    ndp, ntp = mesh.axis_size(dp), mesh.axis_size(tp)
    for what, n in (("num_heads", cfg.num_heads), ("d_ff", cfg.d_ff)):
        if n % ntp:
            raise ValueError(f"{what} {n} is not a multiple of tp {ntp}")
    specs = flat_leaves(param_specs(cfg, tp=tp))
    tp_group = mesh.group(tp) if ntp > 1 else None
    d = mesh.axis_index(dp)

    def step(params, opt, batch):
        batch = batch_to_device(batch, mesh.device)
        rows, T = batch["tokens"].shape
        if rows % ndp or T % ntp:
            raise ValueError(f"batch {rows} / seq {T} not divisible by dp "
                             f"{ndp} / tp {ntp}")
        n_masked = batch["mlm_valid"].sum().clamp(min=1)
        b = rows // ndp
        local = {k: v[d * b:(d + 1) * b] for k, v in batch.items()}
        live = [p.detach().requires_grad_() for p in flat_leaves(params)]
        loss = pretrain_loss(_unflatten(params, live), local, cfg, tp_group,
                             n_masked=n_masked, n_rows=rows)[0] / ntp
        grads = torch.autograd.grad(loss, live)
        with torch.no_grad():
            loss = PZ._psum_loss(loss.detach(), mesh)
            grads = PZ.psum_grads_by_spec(list(grads), specs, mesh)
            _momentum(params, opt, grads, lr)
        return params, opt, loss

    return step


def _momentum(params, opt, grads, lr) -> None:
    for p, m, g in zip(flat_leaves(params), flat_leaves(opt["m"]), grads):
        m.mul_(0.9).add_(g.to(m.dtype))
        p.sub_(lr * m.to(p.dtype))


def _single_device_step(cfg: ErnieConfig, lr: float, dev):
    def step(params, opt, batch):
        batch = batch_to_device(batch, dev)
        live = [p.detach().requires_grad_() for p in flat_leaves(params)]
        loss = pretrain_loss(_unflatten(params, live), batch, cfg)[0]
        grads = torch.autograd.grad(loss, live)
        with torch.no_grad():
            _momentum(params, opt, grads, lr)
        return params, opt, loss.detach()

    return step


def init_opt(params) -> Dict[str, Any]:
    """Momentum buffers: zeros shaped like every leaf."""
    return {"m": _unflatten(params, [torch.zeros_like(p)
                                     for p in flat_leaves(params)])}


def pretrain_flops_per_token(cfg: ErnieConfig, n_params: int,
                             T: int) -> float:
    """Forward + backward FLOPs per pretraining token, the JAX numerator
    (``ernie.py:309-319``): 6 N over the non-embedding parameters (the
    tables are gathers), the attention term, and the tied MLM decoder at
    ``max_masked`` of T positions."""
    D, V, M = cfg.d_model, cfg.vocab_size, cfg.max_masked
    n_emb = V * D + cfg.max_seq_len * D + cfg.type_vocab_size * D
    return (hw.transformer_train_flops_per_token(
        n_params - n_emb, cfg.num_layers, D, T) + 6 * M * D * V // T)
