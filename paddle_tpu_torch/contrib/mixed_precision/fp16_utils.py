"""Program rewriting for AMP — cast insertion on the op-desc IR, the
port of ``paddle_tpu/contrib/mixed_precision/fp16_utils.py`` (the
reference's rewrite_program / find_true_prev_op machinery).

One forward walk over block 0 classifies each op against the white,
black and gray lists and splices ``cast`` ops in, so white ops compute in
the low-precision dtype and black ops in float32. Parameters keep their
float32 master copies in the scope; each step casts a white op's weight
(one ``cast`` launch a weight in eager torch). Outputs are relabelled by
metadata only: a lowering may return another dtype than its var's label
(a bf16 ``mul`` plus a float32 bias promotes to float32 in both
packages), and the executor keeps the value it computed.
"""
from __future__ import annotations

from typing import Dict, List, Set

from ...framework.program import Block, Program, Variable

__all__ = ["rewrite_program", "cast_model_to_fp16"]

_FLOAT32 = "float32"


def _is_float(var: Variable) -> bool:
    return str(var.dtype) in ("float32", "float16", "bfloat16", "float64")


def _insert_cast(block: Block, idx: int, src: Variable, dest_dtype: str,
                 cache: Dict[str, str]) -> str:
    """Insert a cast of ``src`` to dest_dtype before op index idx; returns the
    casted var name (cached per (var, dtype))."""
    key = f"{src.name}->{dest_dtype}"
    if key in cache:
        return cache[key]
    out = block.create_var(
        name=f"{src.name}.cast_{dest_dtype}",
        shape=src.shape, dtype=dest_dtype, stop_gradient=src.stop_gradient)
    block._insert_op(
        idx, type="cast",
        inputs={"X": [src.name]}, outputs={"Out": [out.name]},
        attrs={"in_dtype": str(src.dtype), "out_dtype": dest_dtype})
    cache[key] = out.name
    return out.name


def _op_io_names(op) -> List[str]:
    return list(op.input_arg_names), list(op.output_arg_names)


def rewrite_program(main_program: Program, amp_lists, dest_dtype: str = "bfloat16"):
    """In-place AMP rewrite of block 0 (the reference rewrites the same way
    before append_backward; gradients then flow through the inserted casts,
    giving low-precision backward for white ops automatically)."""
    block = main_program.global_block()
    ops = list(block.ops)

    # classify: resolve gray ops by their input producers like the reference's
    # find_true_prev_op walk — here a single forward pass suffices because
    # program order is topological.
    low_vars: Set[str] = set()   # vars known to be dest_dtype
    i = 0
    while i < len(block.ops):
        op = block.ops[i]
        t = op.type
        if t in amp_lists.unsupported_list:
            i += 1
            continue
        in_names, out_names = _op_io_names(op)
        if amp_lists.black_varnames and any(
                n in amp_lists.black_varnames for n in in_names + out_names):
            kind = "black"
        elif t in amp_lists.white_list:
            kind = "white"
        elif t in amp_lists.black_list:
            kind = "black"
        elif t in amp_lists.gray_list:
            kind = "gray"
        else:
            kind = "black"  # unknown ops stay fp32 — safe default

        cache: Dict[str, str] = {}
        if kind == "white":
            for slot, names in list(op.inputs.items()):
                new_names = []
                for n in names:
                    v = block.var(n) if block.has_var(n) else None
                    if v is not None and _is_float(v) and str(v.dtype) == _FLOAT32:
                        new_names.append(_insert_cast(block, i, v, dest_dtype,
                                                      cache))
                    else:
                        new_names.append(n)
                op.inputs[slot] = new_names
            i += len(cache)  # op shifted by the casts actually inserted
            for n in out_names:
                if block.has_var(n):
                    v = block.var(n)
                    if _is_float(v):
                        v.dtype = dest_dtype
                        low_vars.add(n)
        elif kind == "black":
            for slot, names in list(op.inputs.items()):
                new_names = []
                for n in names:
                    v = block.var(n) if block.has_var(n) else None
                    if v is not None and str(v.dtype) == dest_dtype:
                        new_names.append(_insert_cast(block, i, v, _FLOAT32,
                                                      cache))
                    else:
                        new_names.append(n)
                op.inputs[slot] = new_names
            i += len(cache)
        else:  # gray: follow inputs — outputs go low only if any input is low
            if any(n in low_vars for n in in_names):
                for n in out_names:
                    if block.has_var(n):
                        v = block.var(n)
                        if _is_float(v) and str(v.dtype) == _FLOAT32:
                            v.dtype = dest_dtype
                            low_vars.add(n)
        i += 1
    main_program._bump_version()
    return main_program


def cast_model_to_fp16(program: Program, amp_lists=None,
                       dest_dtype: str = "bfloat16"):
    """Pure-fp16/bf16 mode (the reference's cast_model_to_fp16): like
    rewrite_program but unknown ops follow gray semantics, for inference."""
    from .fp16_lists import AutoMixedPrecisionLists
    lists = amp_lists or AutoMixedPrecisionLists()
    lists.gray_list = lists.gray_list | {
        t for t in set(op.type for op in program.global_block().ops)
        if t not in lists.white_list and t not in lists.black_list
        and t not in lists.unsupported_list}
    return rewrite_program(program, lists, dest_dtype)
