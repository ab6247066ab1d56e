"""Loss functions in logit space (counterpart of training/losses.py)."""

from __future__ import annotations

import torch


def binary_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, reduction: str = "mean"
) -> torch.Tensor:
    """Sigmoid BCE from logits: max(x,0) - x*y + log(1 + exp(-|x|))."""
    logits = logits.reshape(-1)
    labels = labels.reshape(-1).to(logits.dtype)
    per = (
        logits.clamp_min(0.0)
        - logits * labels
        + torch.log1p(torch.exp(-logits.abs()))
    )
    if reduction == "mean":
        return per.mean()
    if reduction == "sum":
        return per.sum()
    return per
