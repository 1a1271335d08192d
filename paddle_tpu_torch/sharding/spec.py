"""Sharding specs — the engine-side subset of
``paddle_tpu/sharding/spec.py``.

A spec is a tuple with one entry a tensor dim: ``None`` (the dim is
replicated), an axis name, or a tuple of axis names (the dim split over
several axes, majorest first). It is the tuple ``parallel/mesh.py``
already takes in place of ``jax.sharding.PartitionSpec``. A spec shorter
than the tensor's rank is padded with ``None`` on the right.

The IR annotation half of the reference module (``shard_tensor``,
``annotate_program``, ``annotated_vars``, ``mesh_axes_of``) works on a
fluid ``Program`` and comes with the propagation pass (ROADMAP A5).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

__all__ = ["SpecConflict", "normalize_spec", "spec_to_json",
           "spec_from_json", "spec_axes", "pad_spec", "merge_specs",
           "is_replicated", "spec_str"]


class SpecConflict(ValueError):
    """Two specs demand different named axes on the same dim."""


def _norm_entry(entry):
    if entry is None:
        return None
    if isinstance(entry, str):
        return entry
    if isinstance(entry, (tuple, list)):
        axes = tuple(str(a) for a in entry)
        if not axes:
            return None
        return axes[0] if len(axes) == 1 else axes
    raise TypeError(f"bad spec entry {entry!r}")


def normalize_spec(spec) -> Tuple:
    """The canonical tuple of a spec given as a tuple, a list, one axis
    name, or None (replicated)."""
    if spec is None:
        return ()
    if isinstance(spec, str):
        return (spec,)
    return tuple(_norm_entry(e) for e in spec)


def spec_to_json(spec) -> List:
    """JSON-able form (tuples become lists)."""
    return [list(e) if isinstance(e, tuple) else e
            for e in normalize_spec(spec)]


def spec_from_json(data) -> Tuple:
    return () if data is None else normalize_spec(data)


def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis the spec names, in order of first appearance."""
    out: List[str] = []
    for e in normalize_spec(spec):
        if e is None:
            continue
        for a in (e if isinstance(e, tuple) else (e,)):
            if a not in out:
                out.append(a)
    return tuple(out)


def pad_spec(spec, rank: int) -> Tuple:
    """Right-pad with None to ``rank`` entries."""
    s = normalize_spec(spec)
    if len(s) > rank:
        raise ValueError(f"spec {s} has more entries than tensor rank {rank}")
    return s + (None,) * (rank - len(s))


def is_replicated(spec) -> bool:
    return all(e is None for e in normalize_spec(spec))


def spec_str(spec) -> str:
    """Compact human form: P(dp, None) style."""
    parts = []
    for e in normalize_spec(spec):
        if e is None:
            parts.append("None")
        elif isinstance(e, tuple):
            parts.append("(" + ",".join(e) + ")")
        else:
            parts.append(str(e))
    return "P(" + ", ".join(parts) + ")"


def merge_specs(a, b, rank: Optional[int] = None) -> Tuple:
    """Refinement merge: per dim, ``None`` yields to a named axis; two
    different named entries raise :class:`SpecConflict`. ``rank`` pads
    both sides before merging (needed when they differ in length)."""
    a, b = normalize_spec(a), normalize_spec(b)
    if rank is None:
        rank = max(len(a), len(b))
    a, b = pad_spec(a, rank), pad_spec(b, rank)
    out = []
    for d, (ea, eb) in enumerate(zip(a, b)):
        if ea == eb or eb is None:
            out.append(ea)
        elif ea is None:
            out.append(eb)
        else:
            raise SpecConflict(f"dim {d}: {spec_str(a)} vs {spec_str(b)} "
                               f"({ea!r} != {eb!r})")
    return tuple(out)
