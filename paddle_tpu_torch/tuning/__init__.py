"""Measurement-driven autotuner — the port of ``paddle_tpu/tuning/``.

Enumerate a declarative config space (:mod:`.space`), prune it with a
static roofline model anchored on the incumbent's program report
(:mod:`.static_cost`), measure the survivors with short real probes
through one shared harness (:mod:`.probe`), search successive-halving
style with JSONL resume (:mod:`.driver`), and emit a reproducible,
fingerprint-gated ``TUNED.json`` every lane accepts (:mod:`.tuned`).

Entry point: ``python -m paddle_tpu_torch.tools.autotune --smoke``.
"""
from .space import (  # noqa: F401
    Candidate,
    SpaceContext,
    enumerate_space,
    parse_disagg_ratio,
    serve_axes,
    serve_incumbent,
    train_axes,
    train_incumbent,
    validate_serve,
    validate_train,
)
from .static_cost import (  # noqa: F401
    BaseStats,
    HwModel,
    StaticEstimate,
    predict_serve,
    predict_train,
)
from .probe import (  # noqa: F401
    DeviceInfo,
    ProbeTiming,
    ServeProbeGeometry,
    TrainProbeGeometry,
    device_info,
    hw_fingerprint,
    run_serve_probe,
    run_train_probe,
    timed_loop,
)
from .driver import (  # noqa: F401
    DEFAULT_RUNGS,
    ProbeLog,
    TuneResult,
    tune,
)
from . import tuned  # noqa: F401
