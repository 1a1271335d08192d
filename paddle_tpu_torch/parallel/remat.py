"""Rematerialization (activation checkpointing) policies — the port of
``paddle_tpu/parallel/remat.py`` on ``torch.utils.checkpoint``
(non-reentrant).

==================  ========================================================
``none``            no checkpointing: autograd saves every intermediate
``save_only_flash`` selective checkpoint that saves the flash-attention
                    forward (the ``paddle_tpu_torch::flash_fwd`` op, o and
                    lse) and recomputes the rest. JAX also tags the plain
                    attention output; the port does not, so without
                    ``use_flash`` this policy recomputes everything
``dots``            selective checkpoint that saves exactly the matrix
                    products without batch dimensions (JAX's
                    ``dots_with_no_batch_dims_saveable``) and recomputes
                    the rest — the flash kernel included
``full``            recompute everything inside the block
==================  ========================================================

``torch.einsum`` lowers every contraction to ``aten.bmm``: the
projections (``btd,dcnh->btcnh``, ``btnh,nhd->btd``, ``btd,df->btf``)
with a batch of 1, the plain attention products with a batch of B·nh. So
``dots`` saves ``mm``/``addmm`` and the ``bmm`` calls whose batch is 1.
(An attention product with B·nh == 1 would be saved too; the values are
the same either way, only memory differs.)

Aliases as in JAX: ``remat=False`` == ``"none"``, ``remat=True`` with no
policy == ``"full"``, and the JAX policy names map to theirs.
"""
import dataclasses
import functools
from typing import Callable, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

__all__ = ["POLICY_NAMES", "RematPolicy", "resolve"]

POLICY_NAMES: Tuple[str, ...] = ("none", "full", "dots", "save_only_flash")

_ALIASES = {
    "off": "none",
    "false": "none",
    "true": "full",
    "everything": "full",
    "dots_with_no_batch_dims_saveable": "dots",
    "dots_saveable": "dots",
    "save_only_these_names": "save_only_flash",
    "save_only_flash_attn": "save_only_flash",
}

_aten = torch.ops.aten


def _dots_policy(ctx, op, *args, **kwargs):
    if op in (_aten.mm.default, _aten.addmm.default) or (
            op is _aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _flash_policy(ctx, op, *args, **kwargs):
    from ..ops.flash_attention import FLASH_FWD_OP

    if op is FLASH_FWD_OP:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_SELECTIVE = {"dots": _dots_policy, "save_only_flash": _flash_policy}


@dataclasses.dataclass(frozen=True)
class RematPolicy:
    """One named policy; ``wrap(fn)`` applies it as a checkpoint."""

    name: str

    @property
    def is_none(self) -> bool:
        return self.name == "none"

    def wrap(self, fn: Callable) -> Callable:
        """``fn`` wrapped per this policy (``fn`` itself for ``none``)."""
        if self.is_none:
            return fn
        kw = {}
        if self.name in _SELECTIVE:
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts,
                _SELECTIVE[self.name])

        @functools.wraps(fn)
        def wrapped(*args):
            return checkpoint(fn, *args, use_reentrant=False, **kw)

        return wrapped


def resolve(policy: Union[str, RematPolicy, None] = None,
            remat: Optional[bool] = None) -> RematPolicy:
    """A policy name (or the legacy ``remat=`` bool) -> RematPolicy, with
    the JAX rules: ``remat=False`` always means ``none``; no name with
    ``remat`` True or None means ``full``. Raises ``ValueError`` for an
    unknown name."""
    if isinstance(policy, RematPolicy):
        name = policy.name
    elif policy is None:
        name = "full" if (remat is None or remat) else "none"
    else:
        name = str(policy).strip().lower()
        name = _ALIASES.get(name, name)
    if remat is False:
        name = "none"
    if name not in POLICY_NAMES:
        raise ValueError(
            f"unknown remat policy {policy!r}; valid names: "
            f"{', '.join(POLICY_NAMES)} (aliases: "
            f"{', '.join(sorted(_ALIASES))})")
    return RematPolicy(name)
