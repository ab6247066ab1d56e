"""Retrieval-loss ops: hard negatives, accidental negatives, log-Q correction,
and the two-tower in-batch softmax loss.

Counterpart of ``deep_recommenders_tpu/ops/retrieval.py``. The JAX package
computes all of it with plain ops (no Pallas kernel): the score product
``Q C^T`` is a dense matrix product, here ``torch.matmul``, and the top-k of
hard-negative mining is ``torch.topk`` where JAX uses ``lax.top_k``.

Pod-wide negatives (``axis_name=``, :func:`pod_retrieval_loss`) gather the
candidates of every process along the mesh's "data" axis
(``parallel.all_gather``), so each process scores its own queries against
the global batch's candidates.

The huge constants are JAX's: ``labels * MAX_FLOAT`` pins the positive into
the hard-negative top-k, and ``duplicate * MIN_FLOAT`` pushes an accidental
negative to about -3.4e36 (-3.4e37 after a temperature of 0.1): finite in
fp32, so the log-sum-exp stays finite and its softmax there is 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from deep_recommenders_torch.device import check_compute_dtype
from deep_recommenders_torch.parallel.mesh import check_mesh, get_default_mesh
from deep_recommenders_torch.parallel.sharding import (
    DATA_AXIS,
    all_gather,
    all_reduce,
    axis_index,
    axis_size,
)

MAX_FLOAT = float(np.finfo(np.float32).max / 100.0)
MIN_FLOAT = float(np.finfo(np.float32).min / 100.0)


def hard_negative_mining(
    logits: torch.Tensor, labels: torch.Tensor, num_hard_negatives: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the positive and the ``num_hard_negatives`` highest negatives of
    each row: (logits, labels) gathered at the top min(N + 1, columns) of
    ``logits + labels * MAX_FLOAT``. The order among equal scores is
    ``torch.topk``'s, which promises none (``lax.top_k`` puts the lower
    index first); the kept values are the same either way."""
    k = min(num_hard_negatives + 1, logits.shape[1])
    _, indices = torch.topk(logits + labels * MAX_FLOAT, k, dim=1)
    return logits.gather(1, indices), labels.gather(1, indices)


def remove_accidental_negatives(
    logits: torch.Tensor, labels: torch.Tensor, identifiers: torch.Tensor
) -> torch.Tensor:
    """Add MIN_FLOAT to every in-batch negative whose identifier equals the
    row's positive's: (duplicate mask - labels) * MIN_FLOAT."""
    positive_ids = identifiers[labels.argmax(dim=1)]  # first maximum
    duplicate = (positive_ids[:, None] == identifiers[None, :]).to(
        labels.dtype)
    return logits + (duplicate - labels) * MIN_FLOAT


def _remove_diagonal_duplicates(logits: torch.Tensor,
                                identifiers: torch.Tensor,
                                offset: int = 0) -> torch.Tensor:
    """:func:`remove_accidental_negatives` with the positive of row i at
    column i + ``offset``, without the label matrix: MIN_FLOAT on every
    other column whose identifier equals the positive's."""
    b = logits.shape[0]
    positive = identifiers[offset:offset + b]
    duplicate = positive[:, None] == identifiers[None, :]
    duplicate[torch.arange(b), torch.arange(b) + offset] = False
    return logits + duplicate.to(logits.dtype) * MIN_FLOAT


def sampling_probability_correction(
    logits: torch.Tensor, candidate_sampling_probability: torch.Tensor
) -> torch.Tensor:
    """log-Q correction: logits - log(p), with p clamped to at least
    1e-12."""
    return logits - torch.log(candidate_sampling_probability.clamp_min(1e-12))


def _scores(query: torch.Tensor, candidates: torch.Tensor,
            compute_dtype) -> torch.Tensor:
    """``einsum("bd,nd->bn", q, c, preferred_element_type=float32)`` on
    operands cast to ``compute_dtype``: with bf16, the operands rounded to
    bf16 and multiplied in fp32 (each product of two bf16 values is exact in
    fp32, and the sums stay fp32, unrounded). Autograd then rounds each
    operand's gradient to bf16 where it leaves the cast, as JAX's transpose
    rounds it to the operand's dtype."""
    if compute_dtype is not None:
        query = query.to(compute_dtype).float()
        candidates = candidates.to(compute_dtype).float()
    return query @ candidates.T


def in_batch_retrieval_loss(
    query_embeddings: torch.Tensor,
    candidate_embeddings: torch.Tensor,
    sample_weight: Optional[torch.Tensor] = None,
    candidate_sampling_probability: Optional[torch.Tensor] = None,
    candidate_ids: Optional[torch.Tensor] = None,
    num_hard_negatives: Optional[int] = None,
    temperature: Optional[float] = None,
    axis_name: Optional[str] = None,
    compute_dtype: Optional[torch.dtype] = None,
    mesh=None,
) -> torch.Tensor:
    """The two-tower in-batch sampled-softmax loss, SUM-reduced.

    scores = Q C^T over the batch's candidates with labels = eye (built only
    for hard-negative mining; the other steps read the diagonal); then, in
    order, the log-Q correction, accidental-negative removal, hard-negative
    mining and the temperature; then softmax cross-entropy. Without hard
    negatives the labels are one-hot at the diagonal, so a row's loss is
    logsumexp - the diagonal score (JAX's sparse form, the same math); with
    them, -sum(labels * log_softmax). ``sample_weight`` scales each row's
    loss. ``compute_dtype`` (None or ``torch.bfloat16``) is the score
    product's operand dtype; the softmax and the loss stay fp32.

    ``axis_name`` (pod-wide negatives): the candidates, their ids and
    sampling probabilities are gathered over that axis of ``mesh`` (or,
    without one, of ``parallel.get_default_mesh()``), this process's
    queries are scored against all of them, and row i's positive is column
    ``axis_index * B + i``. Returns this process's SUM over its own rows;
    the candidates' gradient flows back to the process that holds them.
    """
    compute_dtype = check_compute_dtype(compute_dtype)
    offset = 0
    if axis_name is not None:
        mesh = check_mesh(mesh if mesh is not None else get_default_mesh())
        offset = axis_index(mesh, axis_name) * candidate_embeddings.shape[0]
        candidate_embeddings = all_gather(candidate_embeddings, mesh,
                                          axis_name)
        if candidate_ids is not None:
            candidate_ids = all_gather(candidate_ids, mesh, axis_name)
        if candidate_sampling_probability is not None:
            candidate_sampling_probability = all_gather(
                candidate_sampling_probability, mesh, axis_name)
    scores = _scores(query_embeddings, candidate_embeddings, compute_dtype)
    b, n = scores.shape
    rows = torch.arange(b, device=scores.device)
    positive = rows + offset

    if candidate_sampling_probability is not None:
        scores = sampling_probability_correction(
            scores, candidate_sampling_probability)
    if candidate_ids is not None:
        scores = _remove_diagonal_duplicates(scores, candidate_ids, offset)
    if num_hard_negatives is not None:
        labels = (torch.arange(n, device=scores.device)[None, :]
                  == positive[:, None]).to(scores.dtype)
        scores, labels = hard_negative_mining(scores, labels,
                                              num_hard_negatives)
    if temperature is not None:
        scores = scores / temperature

    if num_hard_negatives is None:
        per_row = (torch.logsumexp(scores, dim=-1)
                   - scores[rows, positive])
    else:
        per_row = -(labels * torch.log_softmax(scores, dim=-1)).sum(-1)
    if sample_weight is not None:
        per_row = per_row * sample_weight.reshape(-1)
    return per_row.sum()


class _SumOverData(torch.autograd.Function):
    """The sum of every data shard's loss, on each of them. The backward
    hands each process the cotangent times the data size: under the port's
    data-parallel rule (``Trainer(mesh=)`` averages the gradients over the
    data group) the mean of those gradients is the gradient of the summed
    loss, which JAX differentiates."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.scale = axis_size(mesh, axis)
        return all_reduce(x.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None, None


def pod_retrieval_loss(
    query_embeddings: torch.Tensor,
    candidate_embeddings: torch.Tensor,
    mesh,
    sample_weight: Optional[torch.Tensor] = None,
    candidate_sampling_probability: Optional[torch.Tensor] = None,
    candidate_ids: Optional[torch.Tensor] = None,
    num_hard_negatives: Optional[int] = None,
    temperature: Optional[float] = None,
    data_axis: str = DATA_AXIS,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Pod-wide in-batch negatives: the loss of the global batch.

    Each process passes its data coordinate's rows (queries, candidates and
    the optional per-row tensors). It scores its queries against the
    candidates gathered over ``data_axis``
    (:func:`in_batch_retrieval_loss` with ``axis_name``), and the local SUM
    losses are summed over the axis: every process returns the global
    batch's loss, equal to the unmeshed loss of the whole batch.

    Gradients follow the port's data-parallel rule: averaged over the data
    group (as ``Trainer(mesh=)`` does), they are the gradients of that
    global loss. Each process's share is scaled by the data size for it,
    since the rule was made for losses that are means over local rows.
    """
    mesh = check_mesh(mesh)
    loss = in_batch_retrieval_loss(
        query_embeddings, candidate_embeddings,
        sample_weight=sample_weight,
        candidate_sampling_probability=candidate_sampling_probability,
        candidate_ids=candidate_ids,
        num_hard_negatives=num_hard_negatives,
        temperature=temperature,
        axis_name=data_axis,
        compute_dtype=compute_dtype,
        mesh=mesh,
    )
    return _SumOverData.apply(loss, mesh, data_axis)
