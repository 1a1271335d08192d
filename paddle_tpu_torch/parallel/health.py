"""The divergence guard of the train step — the port of
``paddle_tpu/parallel/health.py:611-629`` (``nonfinite_guard`` only; the
watchdog, rollback and flight-recorder machinery is still to be ported).
"""
import torch

__all__ = ["nonfinite_guard"]


def nonfinite_guard(*scalars) -> bool:
    """True when any of ``scalars`` (loss, grad norm) is NaN or Inf.

    JAX selects the old or the new state on the device after the update
    (``jnp.where``). The port updates params and moments in place, so the
    step must decide BEFORE the sweep: this reads one flag back to the
    host — the step's only host sync, taken only when ``skip_nonfinite``
    is on."""
    bad = torch.zeros((), dtype=torch.bool, device=scalars[0].device)
    for s in scalars:
        bad = bad | ~torch.isfinite(torch.as_tensor(s, dtype=torch.float32))
    return bool(bad.item())
