"""Port of ``paddle_tpu.observability``: the metrics registry and the
hardware table. Spans, goodput, Prometheus exposition and the rest of
the JAX package's observability stack are still to be ported
(ROADMAP.md, queue A)."""
from .metrics import default_registry

__all__ = ["default_registry"]
