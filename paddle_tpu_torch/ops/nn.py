"""Neural-net op lowerings — the slice of ``paddle_tpu/ops/nn.py`` the
fluid training path runs: the activation table, ``softmax``,
``softmax_with_cross_entropy`` (with its vocab-chunked form),
``conv2d``, ``pool2d`` (adaptive too), ``batch_norm`` and
``sync_batch_norm`` (statistics over a group of ranks), ``layer_norm``,
``dropout``, ``lookup_table`` / ``lookup_table_v2`` and
``clip_by_norm``, in torch ops (cuDNN behind ``F.conv2d`` and
``torch.batch_norm`` on the card, where the reference leaves them to
XLA). The rest of the reference's lowerings are still to be ported
(ROADMAP A5)."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..framework.registry import register_op

# ---------------------------------------------------------------------------
# Activations (the reference's _ACTS table)
# ---------------------------------------------------------------------------

_ACTS = {
    "relu": torch.relu,
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softplus": F.softplus,
    "silu": F.silu,
    "swish": F.silu,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
    "hard_sigmoid": lambda x: torch.clamp(0.2 * x + 0.5, 0.0, 1.0),
    "hard_swish": lambda x: x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0,
}
for _name, _fn in _ACTS.items():
    register_op(_name)(
        (lambda fn: lambda ctx, op, ins: {"Out": fn(ins["X"][0])})(_fn)
    )


@register_op("softmax")
def softmax(ctx, op, ins):
    return {"Out": torch.softmax(ins["X"][0], dim=op.attr("axis", -1))}


@register_op("softmax_with_cross_entropy", diff_inputs=("Logits",))
def softmax_with_cross_entropy(ctx, op, ins):
    """The reference's fused, stable softmax + CE (hard or soft labels).

    ``vocab_chunk`` > 0 (hard labels, last axis) takes the chunked form:
    the loss and its Logits gradient blockwise over the class axis with an
    online logsumexp (``chunked_ce.chunked_softmax_ce_from_logits``), the
    class axis padded to a multiple of the chunk with -inf columns; it
    produces no ``Softmax`` output."""
    logits = ins["Logits"][0]
    label = ins["Label"][0]
    axis = op.attr("axis", -1)
    ignore_index = op.attr("ignore_index", -100)
    vocab_chunk = int(op.attr("vocab_chunk", 0) or 0)
    if vocab_chunk and not op.attr("soft_label", False) and \
            axis in (-1, logits.dim() - 1):
        from .chunked_ce import chunked_softmax_ce_from_logits

        v = logits.shape[-1]
        vc = min(vocab_chunk, v)
        lbl = label
        if lbl.dim() == logits.dim():
            lbl = lbl.squeeze(-1)
        lbl = lbl.long()
        rows = logits.reshape(-1, v)
        pad = (-v) % vc
        if pad:  # -inf columns drop out of the logsumexp, get zero grad
            rows = torch.cat([rows, rows.new_full((rows.shape[0], pad),
                                                  -math.inf)], dim=1)
        ce = chunked_softmax_ce_from_logits(
            rows, lbl.clamp(0, v - 1).reshape(-1), vc)
        loss = ce.reshape(lbl.shape)[..., None].to(logits.dtype)
        loss = torch.where(lbl[..., None] != ignore_index, loss, 0.0)
        return {"Loss": loss}
    logp = F.log_softmax(logits, dim=axis)
    if op.attr("soft_label", False):
        loss = -torch.sum(label * logp, dim=axis, keepdim=True)
    else:
        lbl = label
        if lbl.dim() == logits.dim():
            lbl = lbl.squeeze(axis)
        lbl = lbl.long()
        picked = torch.take_along_dim(
            logp, lbl.clamp(0, logits.shape[axis] - 1).unsqueeze(axis),
            dim=axis)
        mask = lbl.unsqueeze(axis) != ignore_index
        loss = torch.where(mask, -picked, 0.0)
    return {"Softmax": torch.exp(logp), "Loss": loss}


# ---------------------------------------------------------------------------
# Convolution and pooling
# ---------------------------------------------------------------------------


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v] * n


def _conv_padding(padding, ndim):
    """Per spatial dim (lo, hi): symmetric ints or explicit pairs."""
    p = _pair(padding, ndim)
    if len(p) == ndim:
        return [(int(x), int(x)) for x in p]
    if len(p) == 2 * ndim:
        return [(int(p[2 * i]), int(p[2 * i + 1])) for i in range(ndim)]
    raise ValueError(f"bad padding {padding}")


def _pad_hw(x, pads, value):
    """Pad the last two dims of NCHW ``x`` by ((top, bottom), (left,
    right))."""
    (t, b), (l, r) = pads
    return F.pad(x, (l, r, t, b), value=value)


@register_op("conv2d", diff_inputs=("Input", "Filter"))
def conv2d(ctx, op, ins):
    x = ins["Input"][0]    # NCHW (or NHWC by data_format)
    w = ins["Filter"][0]   # OIHW, I = C / groups
    nhwc = op.attr("data_format", "NCHW") == "NHWC"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    strides = _pair(op.attr("strides", [1, 1]))
    dilations = _pair(op.attr("dilations", [1, 1]))
    pads = _conv_padding(op.attr("paddings", [0, 0]), 2)
    if all(lo == hi for lo, hi in pads):
        padding = [lo for lo, _ in pads]
    else:
        x = _pad_hw(x, pads, 0.0)
        padding = 0
    out = F.conv2d(x, w, None, strides, padding, dilations,
                   op.attr("groups", 1) or 1).to(x.dtype)
    if nhwc:
        out = out.permute(0, 2, 3, 1)
    return {"Output": out}


@register_op("pool2d", diff_inputs=("X",))
def pool2d(ctx, op, ins):
    """max / avg pooling as the reference's reduce_window: symmetric
    padding, ceil mode as extra high padding so the last window fits, and
    avg divided by the window's count of unpadded cells (``exclusive``)
    or by the window size."""
    x = ins["X"][0]  # NCHW
    ptype = op.attr("pooling_type", "max")
    ksize = _pair(op.attr("ksize", [2, 2]))
    strides = _pair(op.attr("strides", [1, 1]))
    paddings = _pair(op.attr("paddings", [0, 0]))
    adaptive = op.attr("adaptive", False)
    if op.attr("global_pooling", False) or (adaptive
                                            and tuple(ksize) == (1, 1)):
        if ptype == "max":
            return {"Out": torch.amax(x, dim=(2, 3), keepdim=True)}
        return {"Out": torch.mean(x, dim=(2, 3), keepdim=True)}
    if adaptive:
        # ksize is the output size; the reference's condition and refusal
        oh, ow = ksize
        h, w = x.shape[2], x.shape[3]
        if not (h % oh == 0 and w % ow == 0):
            raise ValueError("adaptive pool needs divisible sizes")
        x6 = x.reshape(x.shape[0], x.shape[1], oh, h // oh, ow, w // ow)
        if ptype == "max":
            return {"Out": torch.amax(x6, dim=(3, 5))}
        return {"Out": torch.mean(x6, dim=(3, 5))}
    pads = [(p, p) for p in paddings]
    if op.attr("ceil_mode", False):
        for i in range(2):
            lo, hi = pads[i]
            rem = (x.shape[2 + i] + lo + hi - ksize[i]) % strides[i]
            if rem:
                pads[i] = (lo, hi + strides[i] - rem)
    symmetric = all(lo == hi for lo, hi in pads)
    if ptype == "max":
        if symmetric and all(lo <= k // 2 for (lo, _), k in zip(pads, ksize)):
            # torch pads with -inf itself here
            out = F.max_pool2d(x, ksize, strides, [lo for lo, _ in pads])
        else:
            out = F.max_pool2d(_pad_hw(x, pads, -math.inf), ksize, strides)
        return {"Out": out}
    padded = any(p for pp in pads for p in pp)
    summed = F.avg_pool2d(_pad_hw(x, pads, 0.0) if padded else x, ksize,
                          strides, divisor_override=1)
    if op.attr("exclusive", True) and padded:
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        counts = F.avg_pool2d(_pad_hw(ones, pads, 0.0), ksize, strides,
                              divisor_override=1)
        return {"Out": summed / counts}
    return {"Out": summed / float(np.prod(ksize))}


# ---------------------------------------------------------------------------
# batch_norm
# ---------------------------------------------------------------------------


def _batch_norm_impl(ctx, op, ins):
    """The reference's ``_batch_norm_impl`` (without ``sync_axis``).

    Training: y normalizes by the batch's mean and *biased* variance;
    MeanOut / VarianceOut move the running statistics by ``momentum``
    toward them; SavedMean is the batch mean and SavedVariance
    ``rsqrt(var + eps)``. y runs through ``torch.batch_norm`` with no
    running buffers (its backward saves x, the mean and the inverse std
    only); the statistics outputs come from ``torch.var_mean`` and carry
    no gradient (their vars are stop-gradient, so no grad op asks for
    one). Given
    running buffers, ``F.batch_norm(training=True)`` would move the
    variance by the *unbiased* batch variance, which the reference does
    not.
    """
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean_in, var_in = ins["Mean"][0], ins["Variance"][0]
    eps = op.attr("epsilon", 1e-5)
    momentum = op.attr("momentum", 0.9)
    is_test = op.attr("is_test", False) or op.attr("use_global_stats", False)
    nhwc = op.attr("data_layout", "NCHW") != "NCHW"
    xc = x.movedim(-1, 1) if nhwc else x
    xf = xc.float()
    if is_test:
        y = F.batch_norm(xf, mean_in, var_in, scale, bias, False, 0.0, eps)
        mean_out, var_out = mean_in, var_in
        saved_mean, inv = mean_in, torch.rsqrt(var_in + eps)
    else:
        # the aten op: F.batch_norm refuses one value per channel, which
        # the reference normalizes (to bias)
        y = torch.batch_norm(xf, scale, bias, None, None, True, 0.0, eps,
                             torch.backends.cudnn.enabled)
        with torch.no_grad():
            axes = (0,) + tuple(range(2, xf.dim()))
            var, mean = torch.var_mean(xf, dim=axes, correction=0)
            mean_out = mean_in * momentum + mean * (1 - momentum)
            var_out = var_in * momentum + var * (1 - momentum)
            saved_mean, inv = mean, torch.rsqrt(var + eps)
    y = y.to(x.dtype)
    return {
        "Y": y.movedim(1, -1) if nhwc else y,
        "MeanOut": mean_out,
        "VarianceOut": var_out,
        "SavedMean": saved_mean,
        "SavedVariance": inv,
    }


@register_op("batch_norm", diff_inputs=("X", "Scale", "Bias"))
def batch_norm(ctx, op, ins):
    """Local statistics; under the data-parallel plan (``ctx.
    batch_group``) the whole dp group's, as the reference's batch-sharded
    mean is."""
    group = ctx.batch_group
    if group is not None and group.size > 1:
        return _sync_batch_norm_impl(ctx, op, ins, group)
    return _batch_norm_impl(ctx, op, ins)


class _SyncBatchNorm(torch.autograd.Function):
    """Training-mode batch norm of NC... ``x`` by the statistics of every
    rank's rows: one all-reduce of the per-channel [sum, sum of squares]
    forward (mean and biased variance as ``sq / n - mean²``, as the
    reference's ``_batch_norm_impl(sync_axis=)``), one of [Σg, Σg·x̂]
    backward. Scale and shift get this rank's share of their gradients
    (the plan's gradient all-reduce sums the shares). Saves x in its own
    dtype, the mean and 1/sqrt(var + eps)."""

    @staticmethod
    def forward(ctx, x, scale, bias, group, eps):
        from .collective import _sum

        axes = (0,) + tuple(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.float()
        n = xf.numel() // xf.shape[1] * group.size
        stats = _sum(torch.cat([xf.sum(axes), (xf * xf).sum(axes)]), group)
        mean, sq = stats.chunk(2)
        mean = mean / n
        var = sq / n - mean * mean
        inv = torch.rsqrt(var + eps)
        y = (xf - mean.reshape(shape)) * (inv * scale.float()).reshape(shape) \
            + bias.float().reshape(shape)
        ctx.group, ctx.n, ctx.axes, ctx.shape = group, n, axes, shape
        ctx.save_for_backward(x, mean, inv, scale)
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, g, _gm, _gv):
        from .collective import _sum

        x, mean, inv, scale = ctx.saved_tensors
        axes, shape = ctx.axes, ctx.shape
        gf = g.float()
        xhat = (x.float() - mean.reshape(shape)) * inv.reshape(shape)
        local = torch.cat([gf.sum(axes), (gf * xhat).sum(axes)])
        dbias, dscale = local.chunk(2)
        gsum, gxsum = _sum(local, ctx.group).chunk(2)
        dx = (gf - (gsum / ctx.n).reshape(shape)
              - xhat * (gxsum / ctx.n).reshape(shape)) \
            * (inv * scale.float()).reshape(shape)
        return (dx.to(x.dtype), dscale.to(scale.dtype), dbias.to(scale.dtype),
                None, None)


def _sync_batch_norm_impl(ctx, op, ins, group):
    """batch_norm over ``group``'s rows (``_SyncBatchNorm``); the
    inference form is the local one."""
    if op.attr("is_test", False) or op.attr("use_global_stats", False):
        return _batch_norm_impl(ctx, op, ins)
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean_in, var_in = ins["Mean"][0], ins["Variance"][0]
    eps = op.attr("epsilon", 1e-5)
    momentum = op.attr("momentum", 0.9)
    nhwc = op.attr("data_layout", "NCHW") != "NCHW"
    xc = x.movedim(-1, 1) if nhwc else x
    y, mean, var = _SyncBatchNorm.apply(xc, scale, bias, group, eps)
    with torch.no_grad():
        mean_out = mean_in * momentum + mean * (1 - momentum)
        var_out = var_in * momentum + var * (1 - momentum)
    return {
        "Y": y.movedim(1, -1) if nhwc else y,
        "MeanOut": mean_out,
        "VarianceOut": var_out,
        "SavedMean": mean,
        "SavedVariance": torch.rsqrt(var + eps),
    }


@register_op("sync_batch_norm", diff_inputs=("X", "Scale", "Bias"))
def sync_batch_norm(ctx, op, ins):
    """The reference's ``sync_batch_norm_op``: batch norm whose statistics
    (and, in the backward, the cotangents' sums) reduce over the ranks of
    ``ring_id``'s group; local statistics outside any mesh."""
    group = ctx.axis_name(op.attr("ring_id", 0))
    if group is not None and group.size > 1:
        return _sync_batch_norm_impl(ctx, op, ins, group)
    return _batch_norm_impl(ctx, op, ins)


# ---------------------------------------------------------------------------
# layer_norm, dropout, embedding, clip_by_norm
# ---------------------------------------------------------------------------


@register_op("layer_norm", diff_inputs=("X", "Scale", "Bias"))
def layer_norm(ctx, op, ins):
    """The reference's layer_norm_op: normalize over dims >=
    ``begin_norm_axis`` with float32 statistics; Y in X's dtype, Mean and
    Variance (biased) float32 of X's leading dims. One
    ``torch.native_layer_norm`` gives Y with its mean and 1/sqrt(var + eps),
    so Variance is rstd^-2 - eps (one kernel forward and one backward on
    the card); Mean and Variance carry no gradient (their vars are
    stop-gradient)."""
    x = ins["X"][0]
    eps = op.attr("epsilon", 1e-5)
    bna = op.attr("begin_norm_axis", 1)
    norm_shape = tuple(x.shape[bna:])
    scale = ins["Scale"][0].reshape(norm_shape).float() \
        if ins.get("Scale") else None
    bias = ins["Bias"][0].reshape(norm_shape).float() \
        if ins.get("Bias") else None
    y, mean, rstd = torch.native_layer_norm(x.float(), norm_shape, scale,
                                            bias, eps)
    lead = x.shape[:bna]
    with torch.no_grad():
        var = rstd.detach().reshape(lead).pow(-2) - eps
    return {"Y": y.to(x.dtype), "Mean": mean.detach().reshape(lead),
            "Variance": var}


@register_op("dropout", diff_inputs=("X",))
def dropout(ctx, op, ins):
    """The reference's dropout, both implementations: training keeps each
    element with probability 1 - p (a uniform draw from
    ``ctx.generator_for(op)`` below 1 - p, as ``jax.random.bernoulli``
    draws it); ``upscale_in_train`` divides the kept by 1 - p,
    ``downgrade_in_infer`` scales by 1 - p at test time instead. Mask is
    the kept set as uint8."""
    x = ins["X"][0]
    p = op.attr("dropout_prob", 0.5)
    is_test = op.attr("is_test", False)
    impl = op.attr("dropout_implementation", "downgrade_in_infer")
    if is_test or p == 0.0:
        out = x if impl == "upscale_in_train" else x * (1.0 - p)
        if is_test and impl == "upscale_in_train":
            out = x
        return {"Out": out,
                "Mask": torch.ones_like(x, dtype=torch.uint8)}
    keep = torch.rand(x.shape, generator=ctx.generator_for(op),
                      device=x.device) < 1.0 - p
    if impl == "upscale_in_train":
        out = torch.where(keep, x / (1.0 - p), 0.0)
    else:
        out = torch.where(keep, x, 0.0)
    return {"Out": out.to(x.dtype), "Mask": keep.to(torch.uint8)}


def _lookup(w, idx, padding_idx):
    """Rows of ``w`` at ``idx`` (clipped to the table), zero where
    ``idx == padding_idx`` (>= 0); the table's gradient is the dense
    scatter-add of ``F.embedding``'s backward."""
    out = F.embedding(idx.clamp(0, w.shape[0] - 1), w)
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((idx == padding_idx)[..., None], 0.0, out)
    return out


@register_op("lookup_table", diff_inputs=("W",))
def lookup_table(ctx, op, ins):
    ids = ins["Ids"][0]
    idx = ids.squeeze(-1) if ids.shape[-1] == 1 and ids.dim() > 1 else ids
    return {"Out": _lookup(ins["W"][0], idx.long(),
                           op.attr("padding_idx", -1))}


@register_op("lookup_table_v2", diff_inputs=("W",))
def lookup_table_v2(ctx, op, ins):
    return {"Out": _lookup(ins["W"][0], ins["Ids"][0].long(),
                           op.attr("padding_idx", -1))}


@register_op("clip_by_norm", diff_inputs=("X",))
def clip_by_norm(ctx, op, ins):
    x = ins["X"][0]
    xf = x.float()
    norm = torch.sqrt(torch.sum(torch.square(xf)))
    scale = torch.clamp_max(op.attr("max_norm") / torch.clamp_min(
        norm, 1e-12), 1.0)
    return {"Out": (xf * scale).to(x.dtype)}


@register_op("mse_loss", diff_inputs=("X",))
def mse_loss(ctx, op, ins):
    """``square_error_cost``: (X - Y)² element by element."""
    x, y = ins["X"][0], ins["Y"][0]
    return {"Out": torch.square(x - y)}
