"""Gradient clipping — the port of ``paddle_tpu/clip.py`` (the
reference's python/paddle/fluid/clip.py: GradientClipByValue,
GradientClipByNorm, GradientClipByGlobalNorm and the set_gradient_clip
legacy API). Each clip appends ops to the program (``clip``,
``clip_by_norm``, or the global norm's square / reduce_sum / sum / sqrt
and one elementwise_mul a grad), which the optimizer's ``apply_gradients`` runs in
its optimize role, before the regularizers and the update."""
from __future__ import annotations


class GradientClipBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class GradientClipByValue(GradientClipBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, params_grads):
        from .layers.nn import clip as clip_layer

        out = []
        for p, g in params_grads:
            if g is None or not p.trainable:
                out.append((p, g))
                continue
            out.append((p, clip_layer(g, self.min, self.max)))
        return out


class GradientClipByNorm(GradientClipBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        from .layers.nn import clip_by_norm

        out = []
        for p, g in params_grads:
            if g is None or not p.trainable:
                out.append((p, g))
                continue
            out.append((p, clip_by_norm(g, self.clip_norm)))
        return out


class GradientClipByGlobalNorm(GradientClipBase):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def __call__(self, params_grads):
        from .layers import tensor as tl

        grads = [g for _, g in params_grads if g is not None]
        if not grads:
            return params_grads
        sq_sums = []
        for g in grads:
            sq = tl.square(g)
            sq_sums.append(tl.reduce_sum(sq))
        total = tl.sums(sq_sums) if len(sq_sums) > 1 else sq_sums[0]
        global_norm = tl.sqrt(total)
        # scale = clip_norm / max(global_norm, clip_norm)
        max_norm = tl.fill_constant([1], "float32", self.clip_norm)
        denom = tl.elementwise_max(global_norm, max_norm)
        scale_var = tl.elementwise_div(max_norm, denom)
        out = []
        for p, g in params_grads:
            if g is None or not p.trainable:
                out.append((p, g))
                continue
            out.append((p, tl.elementwise_mul(g, scale_var)))
        return out


# legacy fluid.clip.set_gradient_clip support
ClipGradByValue = GradientClipByValue
ClipGradByNorm = GradientClipByNorm
ClipGradByGlobalNorm = GradientClipByGlobalNorm

_clip_attr = {}


def set_gradient_clip(clip, param_list=None, program=None):
    _clip_attr["default"] = clip


def get_gradient_clip():
    return _clip_attr.get("default")
