"""Loss functions in logit space (counterpart of training/losses.py)."""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint


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
    return _reduce(per, reduction)


def mean_squared_error(predictions: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    return (predictions - labels).square().mean()


def _reduce(per: torch.Tensor, reduction: str,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if mask is not None:
        per = per * mask
        if reduction == "mean":
            return per.sum() / mask.sum().clamp_min(1e-12)
    if reduction == "mean":
        return per.mean()
    if reduction == "sum":
        return per.sum()
    return per


def softmax_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    reduction: str = "mean",
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """CE from logits against dense (possibly soft) label distributions."""
    per = -(labels * torch.log_softmax(logits, dim=-1)).sum(-1)
    return _reduce(per, reduction, mask)


def label_smoothing(labels: torch.Tensor, epsilon: float = 0.1) -> torch.Tensor:
    """(1 - eps) * y + eps / K."""
    return (1.0 - epsilon) * labels + epsilon / labels.shape[-1]


def _smoothed_per_token(logits, targets, epsilon):
    # -((1 - eps) log p[t] + (eps / K) sum_j log p[j]) written on the logits,
    # lse - (1 - eps) logits[t] - (eps / K) sum(logits): no one-hot and no
    # second (..., K) tensor.
    lse = torch.logsumexp(logits, dim=-1)
    target = logits.gather(-1, targets.long()[..., None])[..., 0]
    per = lse - (1.0 - epsilon) * target
    if epsilon:
        per = per - (epsilon / logits.shape[-1]) * logits.sum(-1)
    return per


def smoothed_sparse_softmax_cross_entropy(
    logits: torch.Tensor,
    targets: torch.Tensor,
    epsilon: float = 0.0,
    reduction: str = "mean",
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Label-smoothed CE from integer targets, equal to
    ``softmax_cross_entropy(logits, label_smoothing(one_hot(t, K), eps))``."""
    return _reduce(_smoothed_per_token(logits, targets, epsilon), reduction,
                   mask)


def tied_smoothed_sparse_softmax_cross_entropy(
    features: torch.Tensor,
    table: torch.Tensor,
    targets: torch.Tensor,
    epsilon: float = 0.0,
    reduction: str = "mean",
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`smoothed_sparse_softmax_cross_entropy` of the tied projection
    ``features @ table.T``, keeping no (..., V) logits for backward.

    The projection and its reductions run inside
    ``torch.utils.checkpoint.checkpoint``, whose only output is the
    per-token loss: the backward computes the logits again. Only this part
    is recomputed; whatever produced ``features`` (the attention kernels
    among it) runs once.

    bf16 ``features`` and ``table`` give the JAX loss's bf16 logits stream
    (``training/losses.py:131-153``): the logits are the bf16 product with
    fp32 accumulation, rounded once to bf16; the target logit is gathered
    from them, and the log-sum-exp and the smoothing sum read them upcast
    to fp32. The loss is fp32.
    """

    def per_token(feats, tbl):
        logits = feats @ tbl.T
        if logits.dtype != torch.bfloat16:
            return _smoothed_per_token(logits, targets, epsilon)
        wide = logits.float()
        target = logits.gather(-1, targets.long()[..., None])[..., 0]
        per = torch.logsumexp(wide, dim=-1) - (1.0 - epsilon) * target.float()
        if epsilon:
            per = per - (epsilon / logits.shape[-1]) * wide.sum(-1)
        return per

    per = checkpoint(per_token, features, table, use_reentrant=False)
    return _reduce(per, reduction, mask)
