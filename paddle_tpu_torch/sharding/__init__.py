"""Sharding plans for the engine — the port of ``paddle_tpu/sharding``'s
engine side:

    from paddle_tpu_torch import sharding
    plan = sharding.make_gpt_plan(cfg, pcfg, "fsdp")
    step = parallelize.make_train_step(cfg, pcfg, mesh, sharding="fsdp")

``spec`` holds the spec tuples and their helpers, ``plan`` the
suffix-inheritance planner and the GPT presets. The IR side — annotating
a fluid ``Program``, propagating specs op by op and lowering them
(``annotate_program``, ``propagate_program``, ``apply_sharding``,
``named_shardings``, ``mesh_from_axes``, the ``Conflict`` / ``Reshard``
records: the reference's ``propagate.py``, ``rules.py`` and ``lower.py``)
goes with ``CompiledProgram`` and raises ``NotImplementedError`` naming
ROADMAP A5.
"""
from .plan import (PRESETS, ShardingPlan, complete_pytree_specs,  # noqa: F401
                   gpt_annotations, make_gpt_plan, resolve_plan)
from .spec import (SpecConflict, is_replicated, merge_specs,  # noqa: F401
                   normalize_spec, pad_spec, spec_axes, spec_from_json,
                   spec_str, spec_to_json)

__all__ = [
    "SpecConflict", "normalize_spec", "pad_spec", "merge_specs",
    "spec_axes", "spec_str", "spec_to_json", "spec_from_json",
    "is_replicated",
    "PRESETS", "ShardingPlan", "complete_pytree_specs", "gpt_annotations",
    "make_gpt_plan", "resolve_plan",
    "annotate_program", "annotated_vars", "shard_tensor",
    "propagate_program", "apply_sharding", "named_shardings",
    "mesh_from_axes", "Conflict", "Reshard", "PropagationResult", "RuleCtx",
]


def _ir_side(name: str):
    def refuse(*args, **kw):
        raise NotImplementedError(
            f"sharding.{name} (the Program-IR propagation of paddle_tpu/"
            "sharding: propagate.py, rules.py, lower.py) is still to be "
            "ported with CompiledProgram (ROADMAP A5)")
    refuse.__name__ = name
    return refuse


for _name in ("annotate_program", "annotated_vars", "shard_tensor",
              "propagate_program", "apply_sharding", "named_shardings",
              "mesh_from_axes", "Conflict", "Reshard", "PropagationResult",
              "RuleCtx"):
    globals()[_name] = _ir_side(_name)
del _name
