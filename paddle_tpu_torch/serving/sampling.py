"""Token sampling for the serving engine — the port of
``paddle_tpu/serving/sampling.py``.

Semantics per slot, as in the JAX engine:

- ``temperature <= 0`` — greedy argmax (the first index on ties);
- ``temperature > 0`` — logits divided by the temperature, masked by top-k
  (keep the k highest; ``k <= 0`` disables) and nucleus top-p (keep the
  smallest set whose mass reaches ``p``; ``p >= 1`` disables), then drawn
  from a ``torch.Generator`` seeded from ``(seed, position)`` —
  deterministic per (seed, position), independent across slots and steps.

The draws are not JAX's: threefry and PyTorch's generators give different
bits from one seed, so the sampled lane is held to JAX by its
distribution (:func:`adjusted_probs_np`), the greedy lane token for token.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["SamplingParams", "GREEDY", "sample_token", "sample_batch",
           "sample_window", "batch_arrays", "adjusted_probs_np"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs; ``temperature == 0`` is greedy."""
    temperature: float = 0.0
    top_k: int = 0            # 0 disables
    top_p: float = 1.0        # 1.0 disables
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature {self.temperature} < 0")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p {self.top_p} outside (0, 1]")
        if self.top_k < 0:
            raise ValueError(f"top_k {self.top_k} < 0")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams()


def _masked_logits(logits, temp, top_k, top_p):
    """[V] float32 logits -> temperature-scaled, top-k/top-p-masked logits
    (masked entries -inf). Step for step the JAX ``_masked_logits``: one
    descending sort serves both filters."""
    V = logits.shape[-1]
    f32 = dict(dtype=torch.float32, device=logits.device)
    scaled = logits / torch.clamp_min(torch.tensor(temp, **f32), 1e-6)
    desc = torch.sort(scaled, descending=True).values
    kk = V if top_k <= 0 else min(int(top_k), V)
    k_thresh = desc[max(kk - 1, 0)]
    in_k = torch.arange(V, device=logits.device) < kk
    e = torch.where(in_k, torch.exp(desc - desc[0]), torch.zeros_like(desc))
    p_desc = e / e.sum()
    cum = torch.cumsum(p_desc, 0)
    top_p32 = torch.tensor(top_p, **f32)
    idx = torch.argmax((cum >= torch.minimum(top_p32, cum[-1])).to(
        torch.int8))
    thresh = k_thresh if top_p >= 1.0 else torch.maximum(k_thresh, desc[idx])
    return torch.where(scaled >= thresh, scaled,
                       torch.full_like(scaled, -float("inf")))


def _generator(seed: int, position: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(((int(seed) & 0xFFFFFFFF) << 32)
                    | (int(position) & 0xFFFFFFFF))
    return gen


def sample_token(logits, temp, top_k, top_p, seed, position) -> int:
    """One token from one [V] logits row (a tensor on any device)."""
    logits = logits.float()
    if temp <= 0.0:
        return int(torch.argmax(logits))
    probs = torch.softmax(_masked_logits(logits, temp, top_k, top_p), -1)
    gen = _generator(seed, position, logits.device)
    return int(torch.multinomial(probs, 1, generator=gen))


def sample_batch(logits, temps, top_ks, top_ps, seeds,
                 positions) -> np.ndarray:
    """[B, V] logits + [B] per-slot params (numpy) -> [B] int32 tokens."""
    toks = torch.argmax(logits.float(), -1).cpu().numpy().astype(np.int32)
    for b in np.nonzero(np.asarray(temps) > 0.0)[0]:
        toks[b] = sample_token(logits[b], float(temps[b]), int(top_ks[b]),
                               float(top_ps[b]), int(seeds[b]),
                               int(positions[b]))
    return toks


def sample_window(logits, temps, top_ks, top_ps, seeds,
                  positions) -> np.ndarray:
    """[B, W, V] logits + [B] per-slot params + [B, W] positions (numpy)
    -> [B, W] int32 tokens: the speculative-verify window, each position
    drawn from its own generator folded from (seed, position), as
    :func:`sample_token` draws a decode step's."""
    B, W = logits.shape[:2]
    toks = torch.argmax(logits.float(), -1).cpu().numpy().astype(np.int32)
    for b in np.nonzero(np.asarray(temps) > 0.0)[0]:
        for w in range(W):
            toks[b, w] = sample_token(logits[b, w], float(temps[b]),
                                      int(top_ks[b]), float(top_ps[b]),
                                      int(seeds[b]), int(positions[b, w]))
    return toks


def adjusted_probs_np(logits: np.ndarray, sp: SamplingParams
                      ) -> np.ndarray:
    """Numpy twin of the temperature/top-k/top-p masking: the normalized
    distribution a slot samples from. Greedy returns the argmax one-hot."""
    logits = np.asarray(logits, np.float64).reshape(-1)
    V = logits.shape[0]
    if sp.greedy:
        out = np.zeros((V,), np.float64)
        out[int(np.argmax(logits))] = 1.0
        return out
    scaled = logits / max(sp.temperature, 1e-6)
    kk = V if sp.top_k <= 0 else min(sp.top_k, V)
    desc = np.sort(scaled)[::-1]
    masked = np.where(scaled >= desc[kk - 1], scaled, -np.inf)
    m = masked.max()
    probs = np.exp(masked - m)
    probs /= probs.sum()
    if sp.top_p < 1.0:
        p_desc = np.sort(probs)[::-1]
        cum = np.cumsum(p_desc)
        idx = int(np.argmax(cum >= min(sp.top_p, cum[-1])))
        probs = np.where(probs >= p_desc[idx], probs, 0.0)
        probs /= probs.sum()
    return probs


def batch_arrays(params_by_slot: Dict[int, SamplingParams],
                 max_batch: int) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray, np.ndarray]:
    """{slot: SamplingParams} -> the four [max_batch] vectors (temps f32,
    top_ks i32, top_ps f32, seeds i32). Absent slots ride greedy."""
    temps = np.zeros((max_batch,), np.float32)
    top_ks = np.zeros((max_batch,), np.int32)
    top_ps = np.ones((max_batch,), np.float32)
    seeds = np.zeros((max_batch,), np.int32)
    for slot, sp in params_by_slot.items():
        temps[slot] = sp.temperature
        top_ks[slot] = sp.top_k
        top_ps[slot] = sp.top_p
        seeds[slot] = np.int32(np.uint32(sp.seed))
    return temps, top_ks, top_ps, seeds
