"""GPT training over dp x pp x tp ranks on ``torch.distributed`` — the port
of ``paddle_tpu/parallel/parallelize.py``.

- **dp**: the batch is split over the ``dp`` ranks; grads are reduced by
  one all-reduce a leaf (``psum_grads_by_spec``) or by the bucketed
  reduce-scatter (``grad_reduce="reduce_scatter"``: each dp rank runs
  AdamW on its flat shard against dp-sharded moments — on the card the
  ``adamw_mask`` sweep, ``opt_adamw_flat`` — and the updated shards are
  all-gathered back), with optional bf16 / int8 wire payloads and error
  feedback (``comm_opt``).
- **pp**: GPipe. Block leaves are stage-sharded on the stacked layer
  axis; the schedule runs M + S - 1 ticks (a stage skips the ticks JAX
  masks), stage 0 embeds, the last stage takes the CE, and activations go
  stage to stage by point-to-point send / recv inside autograd Functions
  whose backward sends the gradient back. Every stage runs its
  microbatches' backward in the same order (last first), so the sends
  match in order on every backend.
- **tp + sp**: Megatron tensor parallelism with sequence parallelism
  (``models/gpt.block_fn(tp_group=)``).
- **sharding plans** (``sharding=``: ``"dp"``, ``"fsdp"``, ``"tp"``,
  ``"dp+tp"``, an annotation dict or a ``sharding.ShardingPlan``; pp 1):
  the counterpart of the reference's GSPMD step. GSPMD is not there to
  insert the collectives a plan implies, so the step writes them: a leaf
  sharded over dp (fsdp) lives as the rank's shard with its moments, is
  all-gathered over dp before use and its gradient reduce-scattered
  back (one autograd Function); tp entries run the Megatron path above.

Gradient rule, as the reference's (``parallelize.py:20-28``): each rank
differentiates its partial loss (normalised by the global token count
M·mb·T·dp) w.r.t. its shards, then every leaf's grad is summed over the
mesh axes its spec does not name. Leaves a stage never uses (the
embeddings off stage 0, the head and ``ln_f`` off the last stage) have
exact zero grads there.

The port's step is eager: one Python function a rank, collectives on the
mesh lines of ``parallel/mesh.py``. Where JAX donated the params and the
optimizer state, the port updates them IN PLACE: ``step`` returns the
same tensors it was given. Parameter trees flatten in JAX's
``tree_flatten`` order (dict keys sorted at every level), so a flat
moment buffer lines up element for element with the JAX one
(:func:`opt_state_from_numpy`). With ``mesh=None`` and one device the
step is the single-device path of earlier slices.
"""
import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import gpt as G
from ..observability import goodput as _goodput
from ..observability import program_report as _prep
from ..ops import cuda_kernels as CK
from . import comm_opt, health
from . import mesh as mesh_mod
from .comm_opt import CommConfig

__all__ = ["ParallelConfig", "build_mesh", "psum_grads_by_spec",
           "shard_params", "init_adamw_state", "opt_state_from_numpy",
           "init_sharded", "make_train_step", "make_forward",
           "rs_param_layout", "flat_leaves", "flat_specs", "plan_layout",
           "resident_bytes"]


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """The rank grid of a train step: dp x pp x tp ranks, GPipe
    microbatches (>= pp for a low bubble), and the axis names."""
    dp: int = 1
    pp: int = 1
    tp: int = 1
    microbatches: int = 1
    axis_names: Tuple[str, str, str] = ("dp", "pp", "tp")

    def __post_init__(self):
        for name in ("dp", "pp", "tp", "microbatches"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{name}={v!r}: expected an int >= 1")
        if len(set(self.axis_names)) != 3:
            raise ValueError(f"axis_names {self.axis_names}: expected three "
                             "distinct names")

    @property
    def n_devices(self) -> int:
        return self.dp * self.pp * self.tp


def build_mesh(pcfg: ParallelConfig, device=None) -> mesh_mod.Mesh:
    """The (dp, pp, tp) mesh over the initialised world, which must hold
    exactly ``pcfg.n_devices`` ranks; ``device`` as ``mesh.build_mesh``
    (the current card unless the caller names another, or ``"cpu"``)."""
    return mesh_mod.build_mesh(
        list(zip(pcfg.axis_names, (pcfg.dp, pcfg.pp, pcfg.tp))), device)


def _step_device(mesh: Optional[mesh_mod.Mesh], device) -> torch.device:
    """The device of an entry point: the mesh's, where a ``device`` passed
    beside it must name the same one; without a mesh ``device`` (default
    the card)."""
    if mesh is None:
        return resolve_device("cuda" if device is None else device)
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {str(device)!r} disagrees with the "
                         f"mesh's device {mesh.device}")
    return mesh.device


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
                  weight_decay=0.1, grad_clip=1.0, gnorm=None):
    """Per-leaf AdamW, IN PLACE on params and opt (JAX returns new ones).
    No decay on 1-D leaves (biases, layernorm scales). ``gnorm`` may pass
    the global grad norm of sharded leaves (else it is taken over
    ``grads``). Returns (params, opt, gnorm)."""
    flat_g = flat_leaves(grads)
    if gnorm is None:
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
                        wd_mask=None, gnorm=None):
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
    scale are torch ops outside the sweep (``gnorm`` may pass it). ``wd_mask``
    may pass a cached :func:`_wd_mask`. Returns (params, opt, gnorm)."""
    flat_p = flat_leaves(params)
    gf = torch.cat([g.float().reshape(-1) for g in flat_leaves(grads)])
    pf = _flat_base(flat_p)
    copy_back = pf is None
    if copy_back:
        pf = torch.cat([p.float().reshape(-1) for p in flat_p])
    if wd_mask is None:
        wd_mask = _wd_mask(flat_p)
    if gnorm is None:
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


def flat_specs(cfg: G.GPTConfig, pcfg: ParallelConfig) -> list:
    """``G.param_specs`` in tree-flatten order, on ``pcfg``'s axis names."""
    _, pp_ax, tp_ax = pcfg.axis_names
    return flat_leaves(G.param_specs(cfg, pp=pp_ax, tp=tp_ax))


def _axes_not_in_spec(spec, axis_names) -> Tuple[str, ...]:
    used = mesh_mod.spec_axes(spec)
    return tuple(a for a in axis_names if a not in used)


def psum_grads_by_spec(grads, specs, mesh: mesh_mod.Mesh, skip_axes=(),
                       comm_dtype=None, quant_chunk: int = 256):
    """Sum each grad leaf over the mesh axes its param is replicated on.
    ``grads`` and ``specs`` are trees of one structure (or flat lists);
    the leaves are reduced IN PLACE on the float32 path.

    ``skip_axes`` leaves named axes un-reduced (the reduce-scatter path
    handles dp itself, bucketed). ``comm_dtype`` routes the reduction
    through :func:`comm_opt.quantized_allreduce`, one axis after another
    (a hierarchical all-reduce)."""
    is_tree = isinstance(grads, dict)
    flat_g = flat_leaves(grads) if is_tree else list(grads)
    flat_s = flat_leaves(specs) if isinstance(specs, dict) else list(specs)
    out = []
    for g, s in zip(flat_g, flat_s):
        axes = tuple(a for a in _axes_not_in_spec(s, mesh.axis_names)
                     if a not in skip_axes and mesh.sizes[a] > 1)
        if axes and comm_dtype is not None:
            for a in axes:
                g = comm_opt.quantized_allreduce(g, mesh.group(a),
                                                 comm_dtype, quant_chunk)
        elif axes:
            group = mesh.group(*axes)
            comm_opt.record_collective(
                "psum", g.dtype, g.numel() * g.element_size(), group.size)
            group.all_reduce(g)
        out.append(g)
    return _unflatten(grads, out) if is_tree else out


def shard_params(params, specs, mesh: mesh_mod.Mesh, device=None):
    """This rank's shards of a full parameter tree (tensors, or numpy
    arrays such as a JAX tree passed through ``np.asarray``) by
    ``specs``: contiguous float32 tensors on ``device`` (the mesh's by
    default)."""
    dev = torch.device(device) if device is not None else mesh.device

    def one(x, spec):
        x = mesh_mod.local_shard(x, spec, mesh)
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, dtype=np.float32))
        return x.to(device=dev, dtype=torch.float32).contiguous()

    return _unflatten(params, [one(x, s) for x, s in
                               zip(flat_leaves(params), flat_leaves(specs))])


# ---------------------------------------------------------------------------
# The per-rank loss: the GPipe / tp / sp forward and its backward.
# ---------------------------------------------------------------------------

class _StageLink:
    """The pp line through this rank and its sends, which are
    asynchronous: the serial schedule waits for each at once,
    ``double_buffer`` at the next send (the activation is in flight while
    this stage computes) or at :meth:`flush`."""

    def __init__(self, group: mesh_mod.AxisGroup, stage: int,
                 double_buffer: bool):
        self.group, self.stage = group, stage
        self.double_buffer = double_buffer
        self.pending: List[Any] = []

    def send(self, t: torch.Tensor, peer: int, tag: int) -> None:
        comm_opt.record_collective("ppermute", t.dtype,
                                   t.numel() * t.element_size(),
                                   self.group.size)
        self.flush()
        self.pending.append(self.group.isend(t, peer, tag))
        if not self.double_buffer:
            self.flush()

    def flush(self) -> None:
        while self.pending:
            self.pending.pop(0).wait()


class _StageRecv(torch.autograd.Function):
    """The previous stage's activation; the backward sends its gradient
    back. ``anchor`` is an empty tensor that requires grad, which puts the
    received activation in the graph."""

    @staticmethod
    def forward(ctx, anchor, link, shape, dtype, tag):
        ctx.link, ctx.tag = link, tag
        return link.group.recv(shape, dtype, anchor.device, link.stage - 1,
                               tag)

    @staticmethod
    def backward(ctx, g):
        ctx.link.send(g, ctx.link.stage - 1, ctx.tag)
        return None, None, None, None, None


class _StageSend(torch.autograd.Function):
    """Sends the activation to the next stage and returns a 0-d zero, the
    root of this microbatch's backward, which receives the activation's
    gradient from the next stage."""

    @staticmethod
    def forward(ctx, x, link, tag):
        ctx.link, ctx.tag = link, tag
        ctx.shape, ctx.dtype = tuple(x.shape), x.dtype
        link.send(x, link.stage + 1, tag)
        return x.new_zeros((), dtype=torch.float32)

    @staticmethod
    def backward(ctx, _g):
        g = ctx.link.group.recv(ctx.shape, ctx.dtype, _g.device,
                                ctx.link.stage + 1, ctx.tag)
        return g, None, None


def _pipeline_loss(params, tokens, labels, cfg: G.GPTConfig,
                   pcfg: ParallelConfig, mesh: mesh_mod.Mesh,
                   double_buffer: bool = False
                   ) -> Tuple[torch.Tensor, Callable[[], None]]:
    """The GPipe forward of this rank on its shards: tokens/labels
    [M, mb, T] (this dp rank's batch), ``params`` the rank's leaves.
    Returns (the rank-local partial loss normalised by the global token
    count M·mb·T·dp, detached; ``backward``, which runs the schedule's
    backward and leaves each leaf's grad in ``.grad``).

    Tick t runs microbatch t - stage on every stage that has one; the
    reference's masked ticks are skipped. Stage 0 embeds its sequence
    chunk (``pos_offset = tp_idx·T/tp``), the last stage takes the CE of
    its sequence chunk of the labels. ``backward`` runs the microbatches
    last first on every stage, so each send meets its receive in order;
    ``double_buffer`` overlaps each send with the next tick (same
    values)."""
    _, pp_ax, tp_ax = pcfg.axis_names
    S, tp = pcfg.pp, pcfg.tp
    stage, tp_idx = mesh.axis_index(pp_ax), mesh.axis_index(tp_ax)
    tp_group = mesh.group(tp_ax) if tp > 1 else None
    M, mb, T = tokens.shape
    Ts = T // tp
    seq = slice(tp_idx * Ts, (tp_idx + 1) * Ts)
    denom = M * mb * T * pcfg.dp
    link = _StageLink(mesh.group(pp_ax), stage, double_buffer)
    dev = params["wte"].device
    roots, ce_sum = [], torch.zeros((), dtype=torch.float32, device=dev)
    for t in range(M + S - 1):
        m = t - stage
        if not 0 <= m < M:
            continue
        if stage == 0:
            x = G.embed(params, tokens[m][:, seq], cfg, pos_offset=tp_idx * Ts)
        else:
            anchor = torch.empty(0, device=dev, requires_grad=True)
            x = _StageRecv.apply(anchor, link, (mb, Ts, cfg.d_model),
                                 cfg.dtype, m)
        out = G.run_blocks(params["blocks"], x, cfg, tp_group)
        if stage == S - 1:
            ce = G.ce_from_hidden(params, out, labels[m][:, seq], cfg)
            ce_sum = ce_sum + ce.detach()
            roots.append(ce / denom)
        else:
            roots.append(_StageSend.apply(out, link, m))
    link.flush()

    def backward():
        for root in reversed(roots):
            torch.autograd.backward(root)
        link.flush()

    return ce_sum / denom, backward


def _value_and_grad(params, tokens, labels, cfg, pcfg, mesh, double_buffer
                    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(rank-local partial loss, the rank's grads in tree-flatten order;
    exact zeros for leaves this rank does not use)."""
    live = [p.detach().requires_grad_() for p in flat_leaves(params)]
    loss, backward = _pipeline_loss(_unflatten(params, live), tokens, labels,
                                    cfg, pcfg, mesh, double_buffer)
    backward()
    return loss, [p.grad if p.grad is not None else torch.zeros_like(p)
                  for p in live]


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def _check_layout(cfg: G.GPTConfig, pcfg: ParallelConfig) -> None:
    for what, n, ways in (("num_layers", cfg.num_layers, pcfg.pp),
                          ("num_heads", cfg.num_heads, pcfg.tp),
                          ("d_ff", cfg.d_ff, pcfg.tp)):
        if n % ways:
            raise ValueError(f"{what} {n} is not a multiple of {ways}")


def _rs_param_layout(cfg: G.GPTConfig, pcfg: ParallelConfig,
                     ccfg: CommConfig):
    """Bucket layout over the rank-LOCAL param shard shapes (tree-flatten
    order) for the reduce-scatter path; deterministic in (cfg, pcfg,
    ccfg), so ``init_sharded`` and ``make_train_step`` agree."""
    _check_layout(cfg, pcfg)
    sizes = dict(zip(pcfg.axis_names, (pcfg.dp, pcfg.pp, pcfg.tp)))
    specs = flat_specs(cfg, pcfg)
    shapes = flat_leaves(G.param_shapes(cfg))
    if any(pcfg.axis_names[0] in mesh_mod.spec_axes(s) for s in specs):
        raise NotImplementedError(
            "reduce_scatter grad path expects dp-replicated params")
    pad_multiple = ccfg.quant_chunk if ccfg.comm_dtype == "int8" else 1
    layout = comm_opt.build_bucket_layout(
        [(mesh_mod.local_shape(sh, s, sizes), np.float32)
         for sh, s in zip(shapes, specs)],
        ranks=pcfg.dp, cap_bytes=int(ccfg.bucket_mb * (1 << 20)),
        pad_multiple=pad_multiple)
    return layout, specs


def rs_param_layout(cfg: G.GPTConfig, pcfg: ParallelConfig,
                    comm: Optional[CommConfig] = None,
                    **comm_kw) -> Tuple[comm_opt.BucketLayout, int]:
    """The reduce-scatter bucket layout and ``repl`` (= pp·tp), how many
    times each dp shard repeats over the mesh."""
    ccfg = comm if comm is not None else CommConfig(
        grad_reduce="reduce_scatter", **comm_kw)
    layout, _ = _rs_param_layout(cfg, pcfg, ccfg)
    return layout, pcfg.pp * pcfg.tp


def _comm_config(comm, grad_reduce, grad_allreduce_dtype, bucket_mb,
                 error_feedback) -> CommConfig:
    return comm if comm is not None else CommConfig(
        grad_reduce=grad_reduce, comm_dtype=grad_allreduce_dtype,
        bucket_mb=bucket_mb, error_feedback=error_feedback)


def _refuse(tuned) -> None:
    if tuned is not None:
        raise NotImplementedError(
            "tuned= (TUNED.json from tools/autotune.py) is still to be "
            "ported (ROADMAP A4)")


def init_sharded(cfg: G.GPTConfig, pcfg: Optional[ParallelConfig] = None,
                 mesh: Optional[mesh_mod.Mesh] = None, seed: int = 0,
                 moment_dtype=None, fused_opt: bool = False,
                 grad_reduce: str = "psum", bucket_mb: float = 32.0,
                 error_feedback: bool = False, grad_allreduce_dtype=None,
                 comm: Optional[CommConfig] = None, sharding=None,
                 tuned=None, device=None):
    """(params, AdamW state) of this rank. Every rank makes the full tree
    from ``seed`` on its device and keeps its shards by ``param_specs``.

    ``grad_reduce="reduce_scatter"`` (pass the same comm kwargs as
    ``make_train_step``) lays the moments out as this dp rank's flat
    shard of the bucket layout (float32 ``shard_len``, plus the error
    feedback residual over the whole layout); ``fused_opt`` on one device
    makes the params views of one flat float32 buffer with flat moments;
    otherwise the moments are per leaf. ``mesh=None`` is one device
    (``device``, default the card); with a mesh the params live on
    ``mesh.device`` and a ``device`` that names another raises.

    ``sharding=`` (a preset, an annotation dict or a ``ShardingPlan``)
    keeps each leaf's shard by the plan's specs, with per-leaf moments of
    the same shape (``fused_opt`` is not used, as in the reference); with
    comm levers the plan must be dp-replicated and the state is laid out
    as without one."""
    _refuse(tuned)
    dev = _step_device(mesh, device)
    pcfg = pcfg or ParallelConfig()
    ccfg = _comm_config(comm, grad_reduce, grad_allreduce_dtype, bucket_mb,
                        error_feedback)
    plan = _sharding_route(sharding, cfg, pcfg, mesh, ccfg)
    if plan is not None:
        plan_layout(cfg, pcfg, plan)          # refuses what it cannot run
        full = G.init_params(cfg, seed=seed, device=dev)
        params = shard_params(full, plan.param_specs, mesh)
        del full
        return params, init_adamw_state(params, moment_dtype)
    if mesh is None:
        if pcfg.n_devices > 1 or ccfg.grad_reduce != "psum":
            raise ValueError(f"{pcfg} with grad_reduce={ccfg.grad_reduce!r} "
                             "needs mesh=build_mesh(pcfg)")
        params = G.init_params(cfg, seed=seed, device=dev)
    else:
        _check_layout(cfg, pcfg)
        full = G.init_params(cfg, seed=seed, device=dev)
        params = shard_params(full, G.param_specs(cfg, *pcfg.axis_names[1:]),
                              mesh)
        del full
    if ccfg.grad_reduce == "reduce_scatter":
        layout, _ = _rs_param_layout(cfg, pcfg, ccfg)
        mdt = moment_dtype or torch.float32
        opt = {"m": torch.zeros(layout.shard_len, dtype=mdt, device=dev),
               "v": torch.zeros(layout.shard_len, dtype=mdt, device=dev),
               "step": torch.zeros((), dtype=torch.int32, device=dev)}
        if ccfg.error_feedback:
            opt["ef"] = torch.zeros(layout.total_len, dtype=torch.float32,
                                    device=dev)
        return params, opt
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


def _rank_batch(x, pcfg: ParallelConfig, mesh: mesh_mod.Mesh, cfg
                ) -> torch.Tensor:
    """The global [M, B, T] tokens or labels -> this dp rank's int64
    [M, B/dp, T] on the mesh's device."""
    x = torch.as_tensor(x)
    if x.dim() != 3 or x.shape[0] != pcfg.microbatches:
        raise ValueError(f"expected [{pcfg.microbatches}, B, T], got "
                         f"{tuple(x.shape)}")
    M, B, T = x.shape
    if B % pcfg.dp or T % pcfg.tp:
        raise ValueError(f"batch {B} / seq {T} not divisible by dp "
                         f"{pcfg.dp} / tp {pcfg.tp}")
    mb = B // pcfg.dp
    d = mesh.axis_index(pcfg.axis_names[0])
    return x[:, d * mb:(d + 1) * mb].to(device=mesh.device, dtype=torch.long)


def _repl_weight(spec, pcfg: ParallelConfig, axes) -> float:
    """1 / how many ranks along ``axes`` hold the same copy of a leaf."""
    sizes = dict(zip(pcfg.axis_names, (pcfg.dp, pcfg.pp, pcfg.tp)))
    used = mesh_mod.spec_axes(spec)
    return 1.0 / int(np.prod([sizes[a] for a in axes if a not in used]))


def _global_norm(sq_sum: torch.Tensor, mesh: mesh_mod.Mesh) -> torch.Tensor:
    """sqrt of a replication-weighted sum of squares summed over the
    world."""
    return torch.sqrt(mesh.group(*mesh.axis_names).all_reduce(sq_sum))


def make_train_step(cfg: G.GPTConfig, pcfg: Optional[ParallelConfig] = None,
                    mesh: Optional[mesh_mod.Mesh] = None,
                    lr: float = 3e-4, weight_decay: float = 0.1,
                    fused_opt: bool = False, fused_opt_kernel=None,
                    grad_reduce: str = "psum", grad_allreduce_dtype=None,
                    bucket_mb: float = 32.0, error_feedback: bool = False,
                    grad_clip=1.0, comm: Optional[CommConfig] = None,
                    skip_nonfinite: bool = False, sharding=None, tuned=None,
                    device=None):
    """The training step: ``step(params, opt, tokens, labels) -> (params,
    opt, loss, gnorm)`` with tokens/labels the GLOBAL batch [M, B, T] (every
    rank is given all of it and takes its dp rows) and loss/gnorm 0-d
    float32 tensors, the same on every rank. params and opt are updated
    IN PLACE. Each call stamps the hang watchdog's progress
    (``health.progress("train_step")``), and the first runs under
    ``health.suspend()`` (:func:`_watched`).

    ``fused_opt`` runs the flat-buffer sweep (opt state from
    ``init_sharded(fused_opt=True)``) — on one device only, or under
    reduce-scatter, as the reference refuses; ``fused_opt_kernel`` is
    JAX's ``fused_opt_pallas``: None or True = the AdamW kernel on a card
    (its plain version on CPU tensors), False = the plain PyTorch sweep.

    Communication levers (or pass a ready :class:`CommConfig` as
    ``comm``): ``grad_reduce="reduce_scatter"`` — size-capped flat buckets
    reduce-scattered over dp, AdamW on the rank's shard (the flat sweep,
    the kernel on a card) against dp-sharded moments, the updated shards
    all-gathered (opt state from ``init_sharded(grad_reduce=
    "reduce_scatter")``); ``grad_allreduce_dtype="bf16"|"int8"`` —
    chunk-scaled quantized wire payload with float32 accumulation;
    ``error_feedback`` (reduce-scatter only) carries each rank's
    quantization residual in ``opt["ef"]``. ``grad_clip=None`` disables
    clipping with an exact scale of 1.0. ``tuned=`` raises (still to be
    ported).

    ``sharding=`` (pp 1; a preset of ``sharding.PRESETS``, an annotation
    dict or a ``ShardingPlan``) runs the plan's step (state from
    ``init_sharded(sharding=)`` with the same plan): see
    :func:`_make_sharded_step`. With comm levers (reduce-scatter or a
    wire dtype) a dp-replicated plan takes the hand-written comm_opt path
    and a plan that shards over dp raises, as in the reference. The
    step's ``report_name`` is the reference's
    (``parallel_train_step/dp{dp}pp1tp{tp}mb{M}_gspmd-{mode}``).

    ``skip_nonfinite`` keeps params and opt (step counter and residual
    included) when the summed loss or the global grad norm is NaN/Inf:
    both are reduced over the world, so every rank decides alike, before
    the sweep, by one flag read on the host.

    ``mesh=None`` is one device (``device``, default the card); with a
    mesh the step runs on ``mesh.device`` and a ``device`` that names
    another raises."""
    _refuse(tuned)
    pcfg = pcfg or ParallelConfig()
    ccfg = _comm_config(comm, grad_reduce, grad_allreduce_dtype, bucket_mb,
                        error_feedback)
    plan = _sharding_route(sharding, cfg, pcfg, mesh, ccfg)
    if plan is not None:
        _step_device(mesh, device)
        _check_layout(cfg, pcfg)
        return _watched(_make_sharded_step(cfg, pcfg, mesh, plan, lr,
                                           weight_decay, grad_clip,
                                           skip_nonfinite),
                        f"parallel_train_step/dp{pcfg.dp}pp{pcfg.pp}"
                        f"tp{pcfg.tp}mb{pcfg.microbatches}"
                        f"_gspmd-{plan.mode}", pcfg, mesh.device,
                        mode="gspmd")
    rs = ccfg.grad_reduce == "reduce_scatter"
    if fused_opt and pcfg.n_devices > 1 and not rs:
        raise NotImplementedError(
            "fused_opt on a multi-device mesh requires "
            "grad_reduce='reduce_scatter' (the bucketed flat sweep) "
            f"(got dp={pcfg.dp} pp={pcfg.pp} tp={pcfg.tp})")
    if ccfg.error_feedback and not rs:
        raise NotImplementedError(
            "error_feedback requires grad_reduce='reduce_scatter' "
            "(the residual rides the sharded train state)")
    dev = _step_device(mesh, device)
    # the reference's report name (parallelize.py:899-904)
    report_name = (f"parallel_train_step/dp{pcfg.dp}pp{pcfg.pp}tp{pcfg.tp}"
                   f"mb{pcfg.microbatches}"
                   + ("_fused" if fused_opt else "")
                   + ("_rs" if rs else "")
                   + (f"_{ccfg.comm_dtype}" if ccfg.comm_dtype else ""))
    if mesh is None:
        if pcfg.n_devices > 1 or pcfg.microbatches > 1 or rs \
                or ccfg.comm_dtype is not None:
            raise ValueError(f"{pcfg} with {ccfg} needs "
                             "mesh=build_mesh(pcfg)")
        return _watched(_single_device_step(
            cfg, lr, weight_decay, fused_opt, fused_opt_kernel, grad_clip,
            skip_nonfinite, dev), report_name, pcfg, dev)
    _check_layout(cfg, pcfg)
    if rs:
        return _watched(_make_rs_step(cfg, pcfg, mesh, ccfg, lr,
                                      weight_decay, fused_opt_kernel,
                                      grad_clip, skip_nonfinite),
                        report_name, pcfg, dev)
    specs = flat_specs(cfg, pcfg)
    weights = [_repl_weight(s, pcfg, pcfg.axis_names) for s in specs]
    cache: Dict[str, Any] = {}

    def step(params, opt, tokens, labels):
        tokens = _rank_batch(tokens, pcfg, mesh, cfg)
        labels = _rank_batch(labels, pcfg, mesh, cfg)
        loss, grads = _value_and_grad(params, tokens, labels, cfg, pcfg,
                                      mesh, ccfg.pipeline_double_buffer)
        with torch.no_grad():
            loss = _psum_loss(loss, mesh)
            grads = psum_grads_by_spec(grads, specs, mesh,
                                       comm_dtype=ccfg.comm_dtype,
                                       quant_chunk=ccfg.quant_chunk)
            gnorm = _global_norm(sum(w * torch.sum(torch.square(g.float()))
                                     for w, g in zip(weights, grads)), mesh)
            if skip_nonfinite and health.nonfinite_guard(loss, gnorm):
                return params, opt, loss, gnorm
            gtree = _unflatten(params, grads)
            if fused_opt:
                if "wd_mask" not in cache:
                    cache["wd_mask"] = _wd_mask(flat_leaves(params))
                params, opt, _ = _adamw_update_fused(
                    params, gtree, opt, lr, weight_decay=weight_decay,
                    grad_clip=grad_clip, use_kernel=fused_opt_kernel,
                    wd_mask=cache["wd_mask"], gnorm=gnorm)
            else:
                params, opt, _ = _adamw_update(
                    params, gtree, opt, lr, weight_decay=weight_decay,
                    grad_clip=grad_clip, gnorm=gnorm)
        return params, opt, loss, gnorm

    return _watched(step, report_name, pcfg, dev)


def _watched(step, report_name: str = "parallel_train_step",
             pcfg: Optional["ParallelConfig"] = None, device=None,
             mode: str = "eager"):
    """``step`` with the hang watchdog's ``train_step`` stamp at every
    call, and its first call under ``health.suspend()``: that call carries
    the process's one-time host work — the kernel library's build or
    load, torch's lazy imports behind the first custom-op dispatch under
    remat, cuBLAS set-up (about 10 s on the H100's machine: ``PERF.md``
    §6) — the port's counterpart of the reference's first-call compile,
    which it suspends the same way (``parallelize.py:929-931``). The first
    call is also the program report's (``observability/program_report``,
    as ``parallelize.py:912-940`` captures the compile): its wall ms, the
    work it counted (``aten`` FLOPs and the hand kernels' costs, a remat
    recompute included) and the allocator's peak, under ``report_name``
    (the step's ``report_name``). Every call runs under the goodput
    ledger's ``productive_step`` timer, as the reference's step does
    (``parallelize.py:946-957``); the step is eager, so the timer covers
    the host's enqueue of its work, not the device's finish."""
    first = [True]

    @functools.wraps(step)
    def run(params, opt, tokens, labels):
        health.progress("train_step")
        with _goodput.timer("productive_step"):
            if first[0]:
                first[0] = False
                # the suspend window charges its time to ``compile``,
                # exclusive of this step's timer
                with health.suspend(), _prep.counted(device) as counts:
                    out = step(params, opt, tokens, labels)
                _prep.capture(
                    report_name, counts, donated=["params", "opt_state"],
                    inputs=(params, opt, tokens, labels), outputs=out,
                    extra={"mode": mode, "mesh": None if pcfg is None else {
                        "dp": pcfg.dp, "pp": pcfg.pp, "tp": pcfg.tp}})
                return out
            return step(params, opt, tokens, labels)

    run.report_name = report_name
    return run


def _psum_loss(loss: torch.Tensor, mesh: mesh_mod.Mesh) -> torch.Tensor:
    """The rank partials summed over the world: the global mean loss."""
    world = mesh.group(*mesh.axis_names)
    comm_opt.record_collective("psum", torch.float32, 4, world.size)
    return world.all_reduce(loss.clone())


def _make_rs_step(cfg, pcfg: ParallelConfig, mesh: mesh_mod.Mesh,
                  ccfg: CommConfig, lr, weight_decay, fused_opt_kernel,
                  grad_clip, skip_nonfinite):
    """The reduce-scatter train step (reference ``_make_rs_step``): grads
    flat-concatenated into the bucket layout over the rank-local leaf
    shards, each bucket reduce-scattered over dp (or the quantized
    ``all_to_all`` exchange), AdamW on this rank's shard against its flat
    moments in ONE sweep (``megakernel_adamw_flat``: the kernel on a card),
    the updated shards all-gathered back into the leaves in place."""
    dp_ax = pcfg.axis_names[0]
    dp_group = mesh.group(dp_ax)
    layout, specs = _rs_param_layout(cfg, pcfg, ccfg)
    buckets = layout.buckets
    d = dp_group.index
    # this rank's slice of each bucket's weight-decay mask and grad-norm
    # weight (1 / replication over pp and tp: the world sum then counts
    # each unique element once)
    wd, repl = [], []
    for b in buckets:
        blen = b.size // pcfg.dp
        parts = [np.full((numel,), _repl_weight(specs[idx], pcfg,
                                                pcfg.axis_names[1:]),
                         np.float32) for idx, _, numel in b.entries]
        parts.append(np.zeros((b.pad,), np.float32))
        repl.append(np.concatenate(parts)[d * blen:(d + 1) * blen])
        wd.append(comm_opt.bucket_wd_mask(b)[d * blen:(d + 1) * blen])
    wd_mask = torch.from_numpy(np.concatenate(wd)).to(mesh.device)
    repl_w = torch.from_numpy(np.concatenate(repl)).to(mesh.device)
    b1, b2, eps = 0.9, 0.95, 1e-8
    sweep = (CK.megakernel_adamw_flat_plain if fused_opt_kernel is False
             else CK.megakernel_adamw_flat)

    def step(params, opt, tokens, labels):
        tokens = _rank_batch(tokens, pcfg, mesh, cfg)
        labels = _rank_batch(labels, pcfg, mesh, cfg)
        loss, grads = _value_and_grad(params, tokens, labels, cfg, pcfg,
                                      mesh, ccfg.pipeline_double_buffer)
        with torch.no_grad():
            loss = _psum_loss(loss, mesh)
            # pp/tp replication is still a per-leaf sum; dp is the
            # bucketed scatter below
            grads = psum_grads_by_spec(
                grads, specs, mesh, skip_axes=(dp_ax,),
                comm_dtype=ccfg.comm_dtype, quant_chunk=ccfg.quant_chunk)
            flat_p = flat_leaves(params)
            g_shards, p_shards, ef_out = [], [], []
            off = 0
            for b in buckets:
                blen = b.size // pcfg.dp
                vec = comm_opt.flatten_bucket(grads, b)
                if ccfg.error_feedback:
                    vec = vec + opt["ef"][off:off + b.size]
                shard, resid = comm_opt.reduce_scatter_flat(vec, dp_group,
                                                            ccfg)
                g_shards.append(shard)
                ef_out.append(resid)
                p_shards.append(comm_opt.flatten_bucket(flat_p, b)[
                    d * blen:(d + 1) * blen])
                off += b.size
            gf, pf = torch.cat(g_shards), torch.cat(p_shards)
            gnorm = _global_norm(torch.sum(torch.square(gf) * repl_w), mesh)
            if skip_nonfinite and health.nonfinite_guard(loss, gnorm):
                return params, opt, loss, gnorm
            step_no, c1, c2 = _bias_corrections(opt, b1, b2)
            sweep(pf, gf, opt["m"], opt["v"], wd_mask, lr,
                  _clip_scale(gnorm, grad_clip), c1, c2, b1=b1, b2=b2,
                  eps=eps, weight_decay=weight_decay)
            opt["step"].copy_(step_no)
            if ccfg.error_feedback:
                opt["ef"].copy_(torch.cat(ef_out))
            off = 0
            for b in buckets:
                blen = b.size // pcfg.dp
                full = comm_opt.all_gather_flat(pf[off:off + blen], dp_group)
                for idx, view in comm_opt.unflatten_bucket(full, b).items():
                    flat_p[idx].copy_(view)
                off += blen
        return params, opt, loss, gnorm

    return step


# ---------------------------------------------------------------------------
# Sharding plans: the step the reference leaves to GSPMD, written out
# ---------------------------------------------------------------------------

def _sharding_route(sharding, cfg, pcfg: ParallelConfig,
                    mesh: Optional[mesh_mod.Mesh], ccfg: CommConfig):
    """The plan that ``sharding=`` selects, or None when there is none or
    when comm levers send a dp-replicated plan down the hand-written
    comm_opt path (the reference's routing, ``parallelize.py:788-815``)."""
    if sharding is None:
        return None
    from ..sharding import resolve_plan

    plan = resolve_plan(sharding, cfg, pcfg)
    if pcfg.pp > 1:
        raise NotImplementedError(
            "sharding= plans do not cover GPipe pipeline stages; use "
            "the hand-written pp path (pp=1 required)")
    if ccfg.grad_reduce == "reduce_scatter" or ccfg.comm_dtype is not None:
        if not plan.params_replicated_over(pcfg.axis_names[0]):
            raise NotImplementedError(
                "comm_opt grad reduction (reduce_scatter / quantized "
                "wire dtypes) needs dp-replicated params; plan "
                f"{plan.mode!r} shards params over "
                f"{pcfg.axis_names[0]!r} — drop the comm levers or use "
                "sharding='dp'")
        return None
    if mesh is None:
        raise ValueError("sharding= needs mesh=build_mesh(pcfg)")
    return plan


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """How one leaf of a plan runs: its spec (full rank), the dim it is
    sharded on over dp (fsdp; None if dp-replicated) and the dim the
    Megatron split needs it cut on over tp where the plan keeps it whole
    (None if the plan shards it there, or it is not split)."""
    path: str
    spec: tuple
    dp_dim: Optional[int]
    tp_cut: Optional[int]


def plan_layout(cfg: G.GPTConfig, pcfg: ParallelConfig, plan
                ) -> List[LeafPlan]:
    """Each leaf's :class:`LeafPlan` in tree-flatten order. Raises
    ``NotImplementedError`` naming the leaf and its spec for a layout the
    port cannot lower: an entry over several axes, an axis named twice or
    not in the mesh, or (tp > 1) a tp entry on a dim the Megatron split
    of ``G.param_specs`` does not shard over tp."""
    from ..sharding.plan import _flatten
    from ..sharding.spec import pad_spec, spec_str

    dp_ax, _, tp_ax = pcfg.axis_names
    megatron = flat_leaves(G.param_specs(cfg, pp=None, tp=tp_ax))
    shapes = flat_leaves(G.param_shapes(cfg))
    out = []
    for (path, spec), shape, meg in zip(_flatten(plan.param_specs), shapes,
                                        megatron):
        spec = pad_spec(spec, len(shape))
        meg = pad_spec(meg, len(shape))

        def refuse(why):
            raise NotImplementedError(
                f"sharding plan {plan.mode!r}: leaf {path!r} spec "
                f"{spec_str(spec)}: {why}")

        named = [e for e in spec if e is not None]
        if any(isinstance(e, tuple) for e in named):
            refuse("an entry over several mesh axes is not lowered")
        if len(set(named)) != len(named):
            refuse("a mesh axis names two dims")
        unknown = set(named) - set(pcfg.axis_names)
        if unknown:
            refuse(f"axes {sorted(unknown)} are not in the mesh "
                   f"{pcfg.axis_names}")
        dp_dim = spec.index(dp_ax) if dp_ax in spec and pcfg.dp > 1 \
            else None
        tp_cut = None
        if pcfg.tp > 1:
            for d, (e, m) in enumerate(zip(spec, meg)):
                if e == tp_ax and m != tp_ax:
                    refuse(f"tp on dim {d}, where the Megatron split "
                           f"{spec_str(meg)} does not shard it; the port "
                           "runs tp only as Megatron's split")
                if m == tp_ax and e != tp_ax:
                    tp_cut = d
        out.append(LeafPlan(path, spec, dp_dim, tp_cut))
    return out


class _DpGather(torch.autograd.Function):
    """An fsdp leaf's shard -> the leaf, all-gathered over the dp line
    along ``dim``; the backward reduce-scatters (sums) the gradient back
    to the shard, so the gradient the step keeps is the shard's. (The
    full-size gradient still builds up inside the backward until this
    Function's backward runs: for a stacked [L, ...] leaf, until the
    first layer's.) Both collectives count into the wire-byte counter at
    the full leaf's bytes."""

    @staticmethod
    def forward(ctx, x, group: mesh_mod.AxisGroup, dim: int):
        ctx.group, ctx.dim = group, dim
        full = group.all_gather(x.movedim(dim, 0).contiguous())
        comm_opt.record_collective("all_gather", full.dtype,
                                   full.numel() * full.element_size(),
                                   group.size)
        return full.movedim(0, dim).contiguous() if dim else full

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.group, ctx.dim
        g = g.movedim(dim, 0).contiguous()
        comm_opt.record_collective("psum_scatter", g.dtype,
                                   g.numel() * g.element_size(), group.size)
        part = group.reduce_scatter(g)
        return (part.movedim(0, dim).contiguous() if dim else part), \
            None, None


def _materialize(leaf: torch.Tensor, lp: LeafPlan, mesh: mesh_mod.Mesh,
                 pcfg: ParallelConfig) -> torch.Tensor:
    """The tensor the rank's forward uses for a leaf stored as its plan's
    shard: gathered over dp where the plan shards it there (fsdp), then
    cut to the rank's Megatron block over tp where the plan keeps it
    whole (the cut's backward puts the gradient in its block of zeros,
    and the leaf's sum over tp completes it)."""
    dp_ax, _, tp_ax = pcfg.axis_names
    if lp.dp_dim is not None:
        leaf = _DpGather.apply(leaf, mesh.group(dp_ax), lp.dp_dim)
    if lp.tp_cut is not None:
        n = leaf.shape[lp.tp_cut] // pcfg.tp
        leaf = leaf.narrow(lp.tp_cut, mesh.axis_index(tp_ax) * n, n)
    return leaf


def resident_bytes(tree) -> int:
    """The bytes of a tree's tensors (a rank's params or moments)."""
    if isinstance(tree, dict):
        return sum(resident_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size() \
        if isinstance(tree, torch.Tensor) else 0


def _make_sharded_step(cfg, pcfg: ParallelConfig, mesh: mesh_mod.Mesh, plan,
                       lr, weight_decay, grad_clip, skip_nonfinite):
    """The plan's train step (reference ``_make_gspmd_step``,
    ``parallelize.py:594-703``) with the collectives its specs imply
    written out: every leaf is materialised for the forward
    (:func:`_materialize`: fsdp leaves all-gathered over dp, all of them
    once a step, up front, and alive until the backward ends — fsdp
    halves the stored params and moments, not the step's working set of
    gathered params and their gradients), the rank
    runs the pp-1 loss of its dp rows (``_pipeline_loss``: CE over the
    rank's rows divided by the global token count, the tp ranks on their
    sequence chunks — the reference groups its loss by dp rank in the
    same order), each grad is summed over the axes its spec does not name
    (an fsdp leaf's reduce-scatter was its dp sum), the global grad norm
    counts each replicated element once, and the per-leaf AdamW updates
    each rank's shards and moments in place (the reference's GSPMD step
    calls ``_adamw_update``, not the fused sweep)."""
    layout = plan_layout(cfg, pcfg, plan)
    specs = [lp.spec for lp in layout]
    weights = [_repl_weight(s, pcfg, pcfg.axis_names) for s in specs]

    def step(params, opt, tokens, labels):
        tokens = _rank_batch(tokens, pcfg, mesh, cfg)
        labels = _rank_batch(labels, pcfg, mesh, cfg)
        live = [p.detach().requires_grad_() for p in flat_leaves(params)]
        used = [_materialize(p, lp, mesh, pcfg)
                for p, lp in zip(live, layout)]
        loss, backward = _pipeline_loss(_unflatten(params, used), tokens,
                                        labels, cfg, pcfg, mesh)
        backward()
        del used
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in live]
        with torch.no_grad():
            loss = _psum_loss(loss, mesh)
            grads = psum_grads_by_spec(grads, specs, mesh)
            gnorm = _global_norm(sum(w * torch.sum(torch.square(g.float()))
                                     for w, g in zip(weights, grads)), mesh)
            if skip_nonfinite and health.nonfinite_guard(loss, gnorm):
                return params, opt, loss, gnorm
            params, opt, _ = _adamw_update(
                params, _unflatten(params, grads), opt, lr,
                weight_decay=weight_decay, grad_clip=grad_clip, gnorm=gnorm)
        return params, opt, loss, gnorm

    return step


def _single_device_step(cfg, lr, weight_decay, fused_opt, fused_opt_kernel,
                        grad_clip, skip_nonfinite, dev):
    """The one-device step without a mesh: tokens/labels [1, B, T]."""
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


def make_forward(cfg: G.GPTConfig, pcfg: ParallelConfig,
                 mesh: mesh_mod.Mesh):
    """Inference forward over the mesh: ``fwd(params, tokens [B, T]) ->
    logits [B, T, V]`` (the compute dtype) on every rank. Each dp rank runs
    its rows, the stages pass the activation on, tp runs sequence-
    parallel; the last stage gathers the logits over tp and dp and sends
    them to the other stages."""
    _check_layout(cfg, pcfg)
    dp_ax, pp_ax, tp_ax = pcfg.axis_names
    S = pcfg.pp
    stage, tp_idx = mesh.axis_index(pp_ax), mesh.axis_index(tp_ax)
    tp_group = mesh.group(tp_ax) if pcfg.tp > 1 else None
    pp_group = mesh.group(pp_ax)

    def fwd(params, tokens):
        tokens = _rank_batch(torch.as_tensor(tokens)[None], ParallelConfig(
            pcfg.dp, pcfg.pp, pcfg.tp, 1, pcfg.axis_names), mesh, cfg)[0]
        mb, T = tokens.shape
        Ts = T // pcfg.tp
        with torch.no_grad():
            if stage == 0:
                x = G.embed(params, tokens[:, tp_idx * Ts:(tp_idx + 1) * Ts],
                            cfg, pos_offset=tp_idx * Ts)
            else:
                x = pp_group.recv((mb, Ts, cfg.d_model), cfg.dtype,
                                  mesh.device, stage - 1, 0)
            x = G.run_blocks(params["blocks"], x, cfg, tp_group)
            out = torch.empty((mb * pcfg.dp, T, cfg.vocab_size),
                              dtype=cfg.dtype, device=mesh.device)
            if stage < S - 1:
                pp_group.isend(x, stage + 1, 0).wait()
            else:
                logits = G.logits_fn(params, x, cfg)
                if tp_group is not None:
                    logits = G._gather_seq(logits, tp_group)
                out.copy_(mesh.group(dp_ax).all_gather(logits))
            return pp_group.broadcast(out, S - 1)

    return fwd
