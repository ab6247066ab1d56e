"""Dice data-adaptive activation (DIN).

Counterpart of ``deep_recommenders_tpu/ops/dice.py``:
p = sigmoid((x - mean) * inv) over ``axis`` (per example across the units
of a (B, U) input, not over the batch as in the DIN paper), blended with a
PReLU: out = where(prelu > 0, p * prelu, (1 - p) * prelu).

Two normalizations:
- ``"paper"`` (default): inv = rsqrt(var + eps), the DIN paper's;
- ``"reference"``: inv = rsqrt(sqrt(var) + eps), the square root of the
  standard deviation, as the reference Keras layer computes it.

The variance is the population variance (``jnp.var``), so ``correction=0``.
"""

from __future__ import annotations

import torch


def dice(
    x: torch.Tensor,
    alpha: torch.Tensor,
    epsilon: float = 1e-8,
    axis: int = 1,
    normalization: str = "paper",
) -> torch.Tensor:
    """Dice activation. ``alpha`` is the learnable PReLU slope
    (broadcastable); ``normalization`` is "paper" or "reference"."""
    mean = x.mean(dim=axis, keepdim=True)
    var = x.var(dim=axis, correction=0, keepdim=True)
    if normalization == "paper":
        inv = torch.rsqrt(var + epsilon)
    elif normalization == "reference":
        inv = torch.rsqrt(torch.sqrt(var) + epsilon)
    else:
        raise ValueError(
            f"normalization must be 'paper' or 'reference', "
            f"got {normalization!r}"
        )
    p = torch.sigmoid((x - mean) * inv)
    prelu = torch.where(x > 0, x, alpha * x)
    return torch.where(prelu > 0, p * prelu, (1.0 - p) * prelu)
