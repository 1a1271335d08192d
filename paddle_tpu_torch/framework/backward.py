"""IR-level autodiff: append gradient ops to a Program.

The port of ``paddle_tpu/framework/backward.py`` (the reference's
python/paddle/fluid/backward.py ``append_backward``): walk the ops in
reverse calling each op's grad maker, ``sum`` a var's several gradients,
and seed the loss gradient with ``fill_constant``. Grad ops are
``<type>_grad`` IR ops; the executor runs each through the autograd
graph it recorded for the forward op (``registry.py``).

``checkpoints=`` is recompute (the reference's
``_append_backward_ops_with_checkpoints_``, backward.py:629): each
forward segment ending at a checkpoint is re-emitted into the backward
region behind a ``recompute_barrier``, with its outputs renamed
(``@RC{s}``, ``@BAR{s}`` for its outside inputs, ``@RCdup{s}`` for a
checkpoint a re-emitted op also writes), and the segment's grad ops
carry the re-emitted op's desc. The executor pairs a grad op with the
forward op whose outputs its desc names, so it records the re-emitted
op's graph and the original records nothing: its intermediates die
after their last forward read, which is the saving. The random ops of
a segment replay the forward's draws (``registry.LowerCtx``).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Set

from .program import Block, Operator, Parameter, Program, Variable
from .registry import GRAD_SUFFIX, get_op_spec, has_op


def _fwd_desc(op: Operator, rename: Optional[Dict[str, str]] = None) -> dict:
    r = rename or {}
    desc = {
        "type": op.type,
        "inputs": {k: [r.get(n, n) for n in v] for k, v in op.inputs.items()},
        "outputs": {k: [r.get(n, n) for n in v] for k, v in op.outputs.items()},
        "attrs": {k: v for k, v in op.attrs.items() if not k.startswith("__fwd")},
    }
    if r:
        # the original output names, which key a random op's draw
        desc["attrs"]["__rng_names__"] = sorted(
            n for ns in op.outputs.values() for n in ns)
    return desc


def _compute_requires_grad(block: Block, no_grad_set: Set[str]) -> Set[str]:
    """Forward propagation of 'requires grad' through the op list."""
    requires: Set[str] = set()
    for var in block.vars.values():
        if isinstance(var, Parameter) and var.trainable and var.name not in no_grad_set:
            requires.add(var.name)
        elif var.is_data and not var.stop_gradient and var.name not in no_grad_set:
            requires.add(var.name)
    for op in block.ops:
        if not has_op(op.type):
            continue
        spec = get_op_spec(op.type)
        if spec.grad is None:
            continue
        in_names = [n for names in op.inputs.values() for n in names]
        if any(n in requires for n in in_names):
            for n in op.output_arg_names:
                var = block.vars.get(n)
                if var is None or var.stop_gradient or n in no_grad_set:
                    continue
                requires.add(n)
    return requires


class _RecomputePlan:
    """Segment bookkeeping for checkpoint recompute (the reference's
    ``_RecomputePlan``). Forward ops are split into segments ending at
    each checkpoint-producing op; when the reverse walk reaches a
    segment's first grad op, the segment's forward ops are re-emitted
    with renamed outputs, fed through a ``recompute_barrier`` on the
    segment's outside inputs. The tail after the last checkpoint is not
    recomputed (as in the reference)."""

    def __init__(self, block: Block, fwd_ops: List[Operator],
                 ckpt_names: List[str]):
        self.block = block
        self.fwd_ops = fwd_ops
        self.ckpt_names = set(ckpt_names)
        prod_idx: Dict[str, int] = {}
        for i, op in enumerate(fwd_ops):
            for n in op.output_arg_names:
                if n in self.ckpt_names:
                    prod_idx[n] = i
        self.segments: List = []
        lo = 0
        for c in sorted(set(prod_idx.values())):
            if c >= lo:
                self.segments.append((lo, c))
                lo = c + 1
        self.seg_of: Dict[int, int] = {}
        for s, (a, b) in enumerate(self.segments):
            for i in range(a, b + 1):
                self.seg_of[i] = s
        self.rename: List[Optional[Dict[str, str]]] = [None] * len(self.segments)

    def rename_for(self, op_index: int) -> Optional[Dict[str, str]]:
        """Re-emit (once) the segment holding ``op_index``; its name map
        (original -> recomputed or barriered), or None for the tail."""
        s = self.seg_of.get(op_index)
        if s is None:
            return None
        if self.rename[s] is not None:
            return self.rename[s]
        a, b = self.segments[s]
        seg_ops = self.fwd_ops[a:b + 1]
        produced = {n for op in seg_ops for n in op.output_arg_names}
        rename = {n: f"{n}@RC{s}" for n in produced
                  if n not in self.ckpt_names}
        ext: List[str] = []
        for op in seg_ops:
            for n in op.input_arg_names:
                if n not in produced and n not in ext:
                    ext.append(n)
        bar = {n: f"{n}@BAR{s}" for n in ext}
        block = self.block
        for n, bn in bar.items():
            src = block._var_recursive(n)
            block.create_var(name=bn, shape=src.shape, dtype=src.dtype)
        if bar:
            block.append_op(type="recompute_barrier",
                            inputs={"X": list(bar)},
                            outputs={"Out": list(bar.values())})
        full = {**bar, **rename}
        for op in seg_ops:
            if not has_op(op.type):
                continue
            if not any(n in rename for n in op.output_arg_names):
                continue  # all outputs are stored checkpoints
            # a checkpoint this op also writes goes to a dummy var, so the
            # stored value is not overwritten
            out_name = {n: rename.get(n, f"{n}@RCdup{s}")
                        for n in op.output_arg_names}
            for n, rn in out_name.items():
                src = block._var_recursive(n)
                block.create_var(name=rn, shape=src.shape, dtype=src.dtype)
            new_attrs = dict(op.attrs)
            new_attrs["__rng_names__"] = sorted(op.output_arg_names)
            block.append_op(
                type=op.type,
                inputs={k: [full.get(n, n) for n in v]
                        for k, v in op.inputs.items()},
                outputs={k: [out_name[n] for n in v]
                         for k, v in op.outputs.items()},
                attrs=new_attrs,
            )
        self.rename[s] = full
        return full


def append_backward(
    loss: Variable,
    parameter_list: Optional[List] = None,
    no_grad_set: Optional[Set[str]] = None,
    callbacks=None,
    checkpoints: Optional[List[Variable]] = None,
) -> List:
    """Append grad ops for ``loss``; returns [(param, grad_var), ...].
    ``checkpoints`` (Variables or names) marks recompute boundaries."""
    program: Program = loss.block.program
    block = loss.block
    no_grad = set(no_grad_set or ())
    for var in block.vars.values():
        if var.stop_gradient and not isinstance(var, Parameter):
            no_grad.add(var.name)

    requires = _compute_requires_grad(block, no_grad)
    if loss.name not in requires:
        raise ValueError(
            f"loss {loss.name!r} does not depend on any trainable parameter"
        )

    ckpt_names = [v.name if isinstance(v, Variable) else v
                  for v in (checkpoints or ())]
    if ckpt_names:
        program._annotations["recompute_checkpoints"] = list(ckpt_names)

    # everything appended from here is the backward slice
    with program.op_role_guard(Program.OP_ROLE_BACKWARD):
        return _append_backward_tagged(loss, block, requires, no_grad,
                                       ckpt_names, parameter_list)


def _append_backward_tagged(loss, block, requires, no_grad, ckpt_names,
                            parameter_list):
    # seed: d loss / d loss = 1
    loss_grad_name = loss.name + GRAD_SUFFIX
    block.create_var(
        name=loss_grad_name, shape=loss.shape, dtype=loss.dtype, persistable=False
    )
    block.append_op(
        type="fill_constant",
        outputs={"Out": [loss_grad_name]},
        attrs={"shape": list(loss.shape), "dtype": loss.dtype, "value": 1.0},
    )

    # grad_map: forward var name -> list of grad var names produced so far
    grad_map: Dict[str, List[str]] = defaultdict(list)
    grad_map[loss.name].append(loss_grad_name)

    # snapshot of forward ops (exclude the seed op we just appended)
    fwd_ops = block.ops[:-1]
    recompute = _RecomputePlan(block, fwd_ops, ckpt_names) if ckpt_names else None

    def resolved_grad(name: str) -> Optional[str]:
        """Collapse accumulated grads for `name` into one var (sum if >1)."""
        lst = grad_map.get(name)
        if not lst:
            return None
        if len(lst) == 1:
            return lst[0]
        out_name = name + GRAD_SUFFIX
        if out_name in lst:
            out_name = out_name + "@SUM"
        src = block._var_recursive(name)
        block.create_var(name=out_name, shape=src.shape, dtype=src.dtype)
        block.append_op(
            type="sum", inputs={"X": list(lst)}, outputs={"Out": [out_name]}
        )
        grad_map[name] = [out_name]
        return out_name

    for op_index in range(len(fwd_ops) - 1, -1, -1):
        op = fwd_ops[op_index]
        if not has_op(op.type):
            continue
        spec = get_op_spec(op.type)
        if spec.grad is None:
            continue
        # collect available out-grads
        out_grad_inputs: Dict[str, List[str]] = {}
        any_grad = False
        for slot, names in op.outputs.items():
            gs = []
            for n in names:
                g = resolved_grad(n)
                gs.append(g)
                if g is not None:
                    any_grad = True
            if any(g is not None for g in gs):
                # missing grads in a slot are represented by zero-filled vars
                filled = []
                for n, g in zip(names, gs):
                    if g is None:
                        src = block._var_recursive(n)
                        zname = n + GRAD_SUFFIX + "@ZERO"
                        if not block.has_var(zname):
                            block.create_var(name=zname, shape=src.shape, dtype=src.dtype)
                            block.append_op(
                                type="fill_zeros_like",
                                inputs={"X": [n]},
                                outputs={"Out": [zname]},
                            )
                        g = zname
                    filled.append(g)
                out_grad_inputs[slot + GRAD_SUFFIX] = filled
        if not any_grad:
            continue

        # which inputs need grads?
        if spec.diff_inputs is not None:
            cand_slots = [s for s in spec.diff_inputs if s in op.inputs]
        else:
            cand_slots = list(op.inputs.keys())
        grad_outputs: Dict[str, List[str]] = {}
        for slot in cand_slots:
            outs = []
            needed = False
            for n in op.inputs[slot]:
                if n in requires and n not in no_grad:
                    gname = _fresh_grad_name(block, n, grad_map)
                    src = block._var_recursive(n)
                    block.create_var(name=gname, shape=src.shape, dtype=src.dtype)
                    outs.append(gname)
                    needed = True
                else:
                    outs.append(None)
            if needed:
                grad_outputs[slot + GRAD_SUFFIX] = outs
        if not grad_outputs:
            continue

        # recompute: re-emit the segment's forward (once) and point the
        # grad op's forward values at the recomputed names; grad var names
        # stay the originals, so grads flow across segments as before
        rmap = (recompute.rename_for(op_index) if recompute else None) or {}
        g_inputs: Dict[str, List[str]] = {}
        for slot, names in op.inputs.items():
            g_inputs[slot] = [rmap.get(n, n) for n in names]
        for slot, names in op.outputs.items():
            if slot not in g_inputs:
                g_inputs[slot] = [rmap.get(n, n) for n in names]
        g_inputs.update(out_grad_inputs)
        # keep positional alignment with the forward input list: unneeded
        # grads become the @EMPTY@ placeholder (skipped at bind time)
        g_outputs = {
            slot: [n if n is not None else "@EMPTY@" for n in outs]
            for slot, outs in grad_outputs.items()
        }
        attrs = dict(op.attrs)
        attrs["__fwd__"] = _fwd_desc(op, rmap)
        block.append_op(
            type=op.type + "_grad",
            inputs=g_inputs,
            outputs=g_outputs,
            attrs=attrs,
        )

        # record produced grads
        for slot, outs in grad_outputs.items():
            src_slot = slot[: -len(GRAD_SUFFIX)]
            for n, g in zip(op.inputs[src_slot], outs):
                if g is not None:
                    grad_map[n].append(g)

    # final (param, grad) pairing
    if parameter_list is not None:
        params = [
            p if isinstance(p, Parameter) else block._var_recursive(p)
            for p in parameter_list
        ]
    else:
        params = [p for p in block.all_parameters() if p.trainable]

    result = []
    for p in params:
        if p.name in no_grad:
            continue
        g = resolved_grad(p.name)
        if g is None:
            continue
        gvar = block._var_recursive(g)
        result.append((p, gvar))
    return result


def _fresh_grad_name(block: Block, name: str, grad_map) -> str:
    base = name + GRAD_SUFFIX
    if not grad_map[name] and not block.has_var(base):
        return base
    i = len(grad_map[name])
    while block.has_var(f"{base}@RENAME@{i}"):
        i += 1
    return f"{base}@RENAME@{i}"
