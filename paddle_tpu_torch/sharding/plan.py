"""Pytree sharding plans for the engine — the port of
``paddle_tpu/sharding/plan.py``.

The engine holds its state as a parameter tree, so the plan is derived
by **suffix inheritance** over the leaves' shapes: the user annotates
only the weight leaves (embedding and attention / mlp matrices), and
every other leaf takes the trailing-dim entries of the annotated leaf
whose shape suffix it matches longest (a bias ``[..., F]`` inherits its
weight's ``F`` entry); a leaf whose best matches disagree, or that
matches nothing, is replicated. The optimizer moments mirror the param
specs leaf for leaf, which is where fsdp's memory saving comes from.

Presets (``resolve_plan("dp" | "fsdp" | "tp" | "dp+tp")``) annotate the
GPT tree; an annotation dict composes the same way. The shapes come from
``models.gpt.param_shapes`` and the specs are the tuples of
``sharding/spec.py``. The reference's ``named_sharding_tree`` (specs ->
``NamedSharding``) has no counterpart: the port's step writes the
collectives its specs imply (``parallel/parallelize.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from .spec import normalize_spec, pad_spec, spec_axes, spec_str

__all__ = ["ShardingPlan", "complete_pytree_specs", "gpt_annotations",
           "make_gpt_plan", "resolve_plan", "PRESETS"]

PRESETS = ("dp", "fsdp", "tp", "dp+tp")


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) of a nested dict in JAX ``tree_flatten`` order (keys
    sorted at every level), paths joined by ``/``; any non-dict is a
    leaf."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        out.extend(_flatten(v, path + "/") if isinstance(v, dict)
                   else [(path, v)])
    return out


def _unflatten(paths: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in paths.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


@dataclasses.dataclass
class ShardingPlan:
    """A complete engine-side sharding: a spec for every param leaf (a
    nested dict of spec tuples), the data spec, and the derivation notes
    (leaf path -> "annotated" | "inherited:<source>" | "replicated" |
    "replicated(ambiguous:<sources>)")."""

    mode: str
    axes: Tuple[Tuple[str, int], ...]
    param_specs: Any
    data_spec: Any
    annotations: Dict[str, Any]
    derived: Dict[str, str]

    @property
    def mesh_sizes(self) -> Dict[str, int]:
        return {a: int(s) for a, s in self.axes}

    def params_replicated_over(self, axis: str) -> bool:
        """True when NO param leaf shards over ``axis`` (the comm_opt grad
        reductions need dp-replicated params)."""
        return not any(axis in spec_axes(s)
                       for _, s in _flatten(self.param_specs))

    def report(self) -> str:
        lines = [f"sharding plan [{self.mode}] over mesh "
                 f"{dict(self.axes)}:"]
        for path in sorted(self.derived):
            lines.append(f"  {path}: {self.derived[path]}")
        return "\n".join(lines)


def complete_pytree_specs(avals, annotations: Dict[str, Any],
                          mesh_sizes: Dict[str, int]):
    """A full spec tree from annotations on a subset of leaves.

    ``avals`` is a nested dict whose leaves give shapes (tensors, arrays
    or shape tuples). Returns ``(specs, derived)``: the nested dict of
    full-rank spec tuples and the derivation note of every leaf path. An
    unannotated leaf takes the trailing-dim entries of the annotated leaf
    whose shape suffix matches it longest; candidates that tie with
    different entries (or whose axes do not divide the dim) leave it
    replicated."""
    shapes = {p: _shape(x) for p, x in _flatten(avals)}
    ann = {k: normalize_spec(v) for k, v in annotations.items()}
    unknown = sorted(set(ann) - set(shapes))
    if unknown:
        raise ValueError(
            f"sharding annotations name unknown leaves {unknown}; known: "
            f"{sorted(shapes)[:12]}...")

    def divides(entry, dim) -> bool:
        if entry is None:
            return True
        n = 1
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            n *= int(mesh_sizes.get(a, 1))
        return dim % n == 0

    specs: Dict[str, Tuple] = {}
    derived: Dict[str, str] = {}
    for path, shape in shapes.items():
        if path in ann:
            s = pad_spec(ann[path], len(shape))
            for d, e in enumerate(s):
                if not divides(e, shape[d]):
                    raise ValueError(
                        f"annotation {spec_str(s)} on {path!r}: dim {d} "
                        f"({shape[d]}) not divisible by mesh axes {e!r}")
            specs[path] = s
            derived[path] = "annotated"
            continue
        best_t, best = 0, []
        for src, sspec in ann.items():
            sshape = shapes[src]
            sspec = pad_spec(sspec, len(sshape))
            t = 0
            while (t < len(shape) and t < len(sshape)
                   and shape[-1 - t] == sshape[-1 - t]):
                t += 1
            if t == 0:
                continue
            inherited = tuple(sspec[len(sshape) - t:])
            if not all(divides(e, d) for e, d in
                       zip(inherited, shape[len(shape) - t:])):
                continue
            if t > best_t:
                best_t, best = t, [(src, inherited)]
            elif t == best_t:
                best.append((src, inherited))
        entries = {inh for _, inh in best}
        if best_t > 0 and len(entries) == 1:
            specs[path] = (None,) * (len(shape) - best_t) + best[0][1]
            derived[path] = f"inherited:{best[0][0]}"
            if all(e is None for e in specs[path]):
                derived[path] = "replicated"
        else:
            specs[path] = (None,) * len(shape)
            derived[path] = ("replicated(ambiguous:"
                             + ",".join(sorted(s for s, _ in best)) + ")"
                             if best_t > 0 else "replicated")
    return _unflatten(specs), derived


def gpt_annotations(mode: str, dp_axis: str = "dp",
                    tp_axis: str = "tp") -> Dict[str, Any]:
    """The preset annotation sets on the GPT tree: the embedding, the head
    and the four block matrices only; everything else derives."""
    if mode == "dp":
        return {"wte": (), "lm_head": (),
                "blocks/w_qkv": (), "blocks/w_proj": (),
                "blocks/w_fc": (), "blocks/w_out": ()}
    if mode == "fsdp":
        # one big dim a leaf over dp: gathered for compute, grads
        # reduce-scattered
        return {
            "wte": (dp_axis, None),
            "lm_head": (None, dp_axis),
            "blocks/w_qkv": (None, dp_axis, None, None, None),
            "blocks/w_proj": (None, None, None, dp_axis),
            "blocks/w_fc": (None, None, dp_axis),
            "blocks/w_out": (None, dp_axis, None),
        }
    if mode in ("tp", "dp+tp"):
        # Megatron: column-parallel QKV / fc over heads / ffn, row-parallel
        # proj / out (models/gpt.param_specs' split)
        return {
            "wte": (), "lm_head": (),
            "blocks/w_qkv": (None, None, None, tp_axis, None),
            "blocks/w_proj": (None, tp_axis, None, None),
            "blocks/w_fc": (None, None, tp_axis),
            "blocks/w_out": (None, tp_axis, None),
        }
    raise ValueError(f"unknown sharding preset {mode!r}; "
                     f"known: {PRESETS}")


def make_gpt_plan(cfg, pcfg, mode: str,
                  annotations: Optional[Dict[str, Any]] = None
                  ) -> ShardingPlan:
    """The plan of the GPT tree of ``cfg`` on ``pcfg``'s mesh axes.
    ``annotations`` replaces the preset's set (same leaf paths). The data
    is batch-sharded over the dp axis in every mode."""
    from ..models import gpt as G

    dp_ax, _pp_ax, tp_ax = pcfg.axis_names
    axes = tuple(zip(pcfg.axis_names, (pcfg.dp, pcfg.pp, pcfg.tp)))
    if annotations is None:
        annotations = gpt_annotations(mode, dp_axis=dp_ax, tp_axis=tp_ax)
    specs, derived = complete_pytree_specs(
        G.param_shapes(cfg), annotations, {a: int(s) for a, s in axes})
    return ShardingPlan(mode=mode, axes=axes, param_specs=specs,
                        data_spec=(None, dp_ax, None),
                        annotations=dict(annotations), derived=derived)


def resolve_plan(sharding, cfg, pcfg) -> ShardingPlan:
    """A preset name, an annotation dict or a ready :class:`ShardingPlan`
    -> the plan."""
    if isinstance(sharding, ShardingPlan):
        return sharding
    if isinstance(sharding, str):
        return make_gpt_plan(cfg, pcfg, sharding)
    if isinstance(sharding, dict):
        return make_gpt_plan(cfg, pcfg, "custom", annotations=sharding)
    raise TypeError(
        f"sharding= expects a preset name {PRESETS}, an annotation dict, "
        f"or a ShardingPlan; got {type(sharding).__name__}")
