from .decorator import decorate, OptimizerWithMixedPrecision  # noqa: F401
from .fp16_lists import AutoMixedPrecisionLists  # noqa: F401
from .fp16_utils import rewrite_program, cast_model_to_fp16  # noqa: F401
