"""The port's ``contrib``: ``mixed_precision`` (AMP). The reference's
other contrib modules are still to be ported (ROADMAP A5)."""
from . import mixed_precision  # noqa: F401
from ..framework.core import not_ported


def __getattr__(name):
    if name.startswith("_"):
        raise AttributeError(name)
    not_ported("contrib", name)
