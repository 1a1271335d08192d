"""The GPT train step on one device — the port of the single-device path of
``paddle_tpu/parallel/parallelize.py`` (``ParallelConfig`` :83-95, the
AdamW state and updates :258-374, ``make_train_step`` :706-897 and
``init_sharded`` :1003).

With dp = pp = tp = microbatches = 1 the JAX step is
``value_and_grad(loss_fn)`` followed by the AdamW update: ``_pipeline_loss``
divides the CE sum by ``M·mb·T·dp`` = ``labels.size``, which is
``loss_fn``'s mean. Multi-GPU parallelism (``dp``/``pp``/``tp`` > 1,
microbatches) is still to be ported and raises.

Where JAX donated the params and the optimizer state, the port updates
them IN PLACE: ``step`` returns the same tensors it was given.
Parameter trees flatten in JAX's ``tree_flatten`` order (dict keys
sorted at every level), so a flat moment buffer lines up element for
element with the JAX one (:func:`opt_state_from_numpy`).
"""
import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import gpt as G
from ..ops import cuda_kernels as CK
from . import health

__all__ = ["ParallelConfig", "init_adamw_state", "opt_state_from_numpy",
           "init_sharded", "make_train_step", "flat_leaves"]


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """The JAX ``ParallelConfig``; the port runs dp = pp = tp =
    microbatches = 1 only and raises for anything else."""
    dp: int = 1
    pp: int = 1
    tp: int = 1
    microbatches: int = 1
    axis_names: Tuple[str, str, str] = ("dp", "pp", "tp")

    def __post_init__(self):
        if (self.dp, self.pp, self.tp, self.microbatches) != (1, 1, 1, 1):
            raise NotImplementedError(
                f"dp={self.dp} pp={self.pp} tp={self.tp} microbatches="
                f"{self.microbatches}: multi-GPU parallelism is still to be "
                "ported (ROADMAP.md, queue A item 7); the port trains on one "
                "device")


def flat_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a nested dict in JAX ``tree_flatten`` order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(flat_leaves(v) if isinstance(v, dict) else [v])
    return out


def _unflatten(like, leaves):
    it = iter(leaves)

    def build(t):
        return {k: build(t[k]) if isinstance(t[k], dict) else next(it)
                for k in sorted(t)}

    return build(like)


def init_adamw_state(params, moment_dtype=None, fused: bool = False):
    """Zero AdamW state: per-leaf m/v (``fused=False``) or ONE flat
    [total_numel] m and v (``fused=True``, the layout of
    :func:`_adamw_update_fused`); ``moment_dtype`` (e.g. bfloat16) is the
    moments' storage type, float32 by default. ``step`` is an int32
    scalar on the params' device."""
    leaves = flat_leaves(params)
    dev = leaves[0].device
    dt = moment_dtype or torch.float32
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if fused:
        total = sum(p.numel() for p in leaves)
        return {"m": torch.zeros(total, dtype=dt, device=dev),
                "v": torch.zeros(total, dtype=dt, device=dev), "step": step}

    def zeros(tree):
        return {k: zeros(v) if isinstance(v, dict)
                else torch.zeros_like(v, dtype=moment_dtype or v.dtype)
                for k, v in tree.items()}

    return {"m": zeros(params), "v": zeros(params), "step": step}


def opt_state_from_numpy(opt, device="cuda"):
    """A fused JAX AdamW state (``init_adamw_state(fused=True)`` passed
    through ``np.asarray``) -> the port's: m/v keep their storage type
    (bfloat16 stays bfloat16, exactly), step is int32."""
    dev = resolve_device(device)

    def moment(a):
        dt = torch.bfloat16 if str(np.asarray(a).dtype) == "bfloat16" \
            else torch.float32
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(
            device=dev, dtype=dt)

    return {"m": moment(opt["m"]), "v": moment(opt["v"]),
            "step": torch.tensor(int(np.asarray(opt["step"])),
                                 dtype=torch.int32, device=dev)}


def _clip_scale(gnorm, grad_clip):
    """min(1, grad_clip / (gnorm + 1e-6)); ``grad_clip=None`` gives an exact
    1.0."""
    if grad_clip is None:
        return torch.ones((), dtype=torch.float32, device=gnorm.device)
    return torch.clamp(grad_clip / (gnorm + 1e-6), max=1.0)


def _bias_corrections(opt, b1, b2):
    step = opt["step"] + 1
    sf = step.float()
    return step, 1 - b1 ** sf, 1 - b2 ** sf


def _adamw_update(params, grads, opt, lr, b1=0.9, b2=0.95, eps=1e-8,
                  weight_decay=0.1, grad_clip=1.0):
    """Per-leaf AdamW, IN PLACE on params and opt (JAX returns new ones).
    No decay on 1-D leaves (biases, layernorm scales). Returns (params,
    opt, gnorm)."""
    flat_g = flat_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in flat_g))
    scale = _clip_scale(gnorm, grad_clip)
    step, c1, c2 = _bias_corrections(opt, b1, b2)
    for p, g, m, v in zip(flat_leaves(params), flat_g,
                          flat_leaves(opt["m"]), flat_leaves(opt["v"])):
        g = g.float() * scale
        mf = b1 * m.float() + (1 - b1) * g
        vf = b2 * v.float() + (1 - b2) * g * g
        u = (mf / c1) / (torch.sqrt(vf / c2) + eps)
        wd = weight_decay if p.dim() >= 2 else 0.0
        p.copy_(p - lr * (u + wd * p))
        m.copy_(mf)
        v.copy_(vf)
    opt["step"].copy_(step)
    return params, opt, gnorm


def _flat_base(leaves) -> Optional[torch.Tensor]:
    """The float32 1-D buffer ``leaves`` are consecutive views of (as
    :func:`init_sharded` lays them out), or None."""
    base = leaves[0]._base
    if base is None or base.dtype != torch.float32 or base.dim() != 1:
        return None
    off = base.storage_offset()
    for leaf in leaves:
        if (leaf._base is not base or not leaf.is_contiguous()
                or leaf.storage_offset() != off):
            return None
        off += leaf.numel()
    return base if off == base.storage_offset() + base.numel() else None


def _wd_mask(leaves) -> torch.Tensor:
    """1.0 over the elements of leaves with ndim >= 2, else 0.0."""
    return torch.cat([torch.full((p.numel(),), 1.0 if p.dim() >= 2 else 0.0,
                                 dtype=torch.float32, device=p.device)
                      for p in leaves])


def _adamw_update_fused(params, grads, opt, lr, b1=0.9, b2=0.95, eps=1e-8,
                        weight_decay=0.1, grad_clip=1.0, use_kernel=None,
                        wd_mask=None):
    """Flat-buffer AdamW: every grad is concatenated into one float32
    buffer and the moments live flat (``init_adamw_state(fused=True)``);
    the elementwise sweep is ONE pass — the AdamW kernel
    (``megakernel_adamw_flat``, the plain version on CPU tensors) unless
    ``use_kernel`` is False, which runs the plain PyTorch sweep on any
    device, as JAX's explicit ``fused_opt_pallas=False``.

    Params and moments are updated IN PLACE. When the param leaves are
    consecutive views of one flat buffer (:func:`init_sharded` with
    ``fused_opt=True``) the sweep runs on that buffer directly; otherwise
    the params are concatenated and copied back. The grad norm and clip
    scale are torch ops outside the sweep. ``wd_mask`` may pass a cached
    :func:`_wd_mask`. Returns (params, opt, gnorm)."""
    flat_p = flat_leaves(params)
    gf = torch.cat([g.float().reshape(-1) for g in flat_leaves(grads)])
    pf = _flat_base(flat_p)
    copy_back = pf is None
    if copy_back:
        pf = torch.cat([p.float().reshape(-1) for p in flat_p])
    if wd_mask is None:
        wd_mask = _wd_mask(flat_p)
    gnorm = torch.sqrt(torch.sum(torch.square(gf)))
    scale = _clip_scale(gnorm, grad_clip)
    step, c1, c2 = _bias_corrections(opt, b1, b2)
    sweep = (CK.megakernel_adamw_flat_plain if use_kernel is False
             else CK.megakernel_adamw_flat)
    sweep(pf, gf, opt["m"], opt["v"], wd_mask, lr, scale, c1, c2, b1=b1,
          b2=b2, eps=eps, weight_decay=weight_decay)
    if copy_back:
        off = 0
        for p in flat_p:
            p.copy_(pf[off:off + p.numel()].view(p.shape))
            off += p.numel()
    opt["step"].copy_(step)
    return params, opt, gnorm


def _flatten_into_views(params):
    """The same tree with every leaf a view into ONE float32 buffer, in
    ``tree_flatten`` order."""
    leaves = flat_leaves(params)
    flat = torch.empty(sum(p.numel() for p in leaves), dtype=torch.float32,
                       device=leaves[0].device)
    views, off = [], 0
    for p in leaves:
        view = flat[off:off + p.numel()].view(p.shape)
        view.copy_(p)
        views.append(view)
        off += p.numel()
    return _unflatten(params, views)


def init_sharded(cfg: G.GPTConfig, pcfg: Optional[ParallelConfig] = None,
                 seed: int = 0, moment_dtype=None, fused_opt: bool = False,
                 device="cuda"):
    """(params, AdamW state) on one device. With ``fused_opt`` the params
    are views into one flat float32 buffer, which the fused sweep updates
    in place without a concatenation, and the moments are flat."""
    pcfg = pcfg or ParallelConfig()
    params = G.init_params(cfg, seed=seed, device=device)
    if fused_opt:
        params = _flatten_into_views(params)
    return params, init_adamw_state(params, moment_dtype, fused=fused_opt)


def _batch(x, dev) -> torch.Tensor:
    """tokens/labels [microbatches=1, B, T] -> int64 [B, T] on ``dev``."""
    x = torch.as_tensor(x)
    if x.dim() != 3 or x.shape[0] != 1:
        raise ValueError(f"expected [1, B, T] (microbatches=1), got "
                         f"{tuple(x.shape)}")
    return x[0].to(device=dev, dtype=torch.long)


def make_train_step(cfg: G.GPTConfig, pcfg: Optional[ParallelConfig] = None,
                    lr: float = 3e-4, weight_decay: float = 0.1,
                    fused_opt: bool = False, fused_opt_kernel=None,
                    grad_clip=1.0, skip_nonfinite: bool = False,
                    device="cuda"):
    """The training step: ``step(params, opt, tokens, labels) -> (params,
    opt, loss, gnorm)`` with tokens/labels [1, B, T] and loss/gnorm 0-d
    float32 tensors on the device. params and opt are updated IN PLACE.

    ``fused_opt`` runs the flat-buffer sweep (opt state from
    ``init_sharded(fused_opt=True)``); ``fused_opt_kernel`` is JAX's
    ``fused_opt_pallas``: None or True = the AdamW kernel on a card (its
    plain version on CPU tensors), False = the plain PyTorch sweep.

    ``skip_nonfinite`` keeps params and opt (step counter included) when
    the loss or the grad norm is NaN/Inf: the grad norm is taken before
    the sweep and one flag is read on the host (the step's only sync)."""
    dev = resolve_device(device)
    pcfg = pcfg or ParallelConfig()
    cache: Dict[str, Any] = {}

    if fused_opt:
        def update(params, grads, opt):
            if "wd_mask" not in cache:
                cache["wd_mask"] = _wd_mask(flat_leaves(params))
            return _adamw_update_fused(
                params, grads, opt, lr, weight_decay=weight_decay,
                grad_clip=grad_clip, use_kernel=fused_opt_kernel,
                wd_mask=cache["wd_mask"])
    else:
        update = functools.partial(_adamw_update, lr=lr,
                                   weight_decay=weight_decay,
                                   grad_clip=grad_clip)

    def step(params, opt, tokens, labels):
        tokens, labels = _batch(tokens, dev), _batch(labels, dev)
        live = [p.detach().requires_grad_() for p in flat_leaves(params)]
        loss = G.loss_fn(_unflatten(params, live), tokens, labels, cfg)
        grads = torch.autograd.grad(loss, live)
        loss = loss.detach()
        with torch.no_grad():
            if skip_nonfinite:
                gnorm = torch.sqrt(sum(torch.sum(torch.square(g))
                                       for g in grads))
                if health.nonfinite_guard(loss, gnorm):
                    return params, opt, loss, gnorm
            params, opt, gnorm = update(params, _unflatten(params, grads),
                                        opt)
        return params, opt, loss, gnorm

    return step
