"""Two-tower retrieval: the towers, and the Retrieval task (its loss).

Counterpart of ``deep_recommenders_tpu/models/retrieval/two_tower.py``:

- ``Tower``: categorical features through an :class:`EmbeddingCollection`
  (one fused table; its big-vocab gather's backward is kernel K1 on the
  card), flattened, an :class:`MLP` projection, optionally L2-normalised;
- ``TwoTower``: a query tower and a candidate tower into one space;
- ``Retrieval``: the loss's options (``ops/retrieval.in_batch_retrieval_loss``)
  and an optional FactorizedTopK metric.

``mesh=`` (sharded tables) and ``axis_name=`` (pod-wide negatives) raise
NotImplementedError until the port has its parallelism.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from deep_recommenders_torch.embedding.engine import (
    EmbeddingCollection,
    check_compute_dtype,
)
from deep_recommenders_torch.features.columns import Feature
from deep_recommenders_torch.models.common import MLP, records_config
from deep_recommenders_torch.models.retrieval.factorized_top_k import (
    FactorizedTopK,
)
from deep_recommenders_torch.ops.retrieval import (
    _NOT_PORTED,
    in_batch_retrieval_loss,
)


class Tower(nn.Module):
    """One tower: embed the ``specs`` features -> (B, F * D) -> MLP
    (``hidden``, then ``output_dim``) -> divided by max(||x||, 1e-12) when
    ``l2_normalize``. Submodules ``embeddings`` and ``projection``, as
    flax's."""

    def __init__(
        self,
        specs: Sequence[Feature],
        embedding_dim: int = 32,
        hidden: Tuple[int, ...] = (64,),
        output_dim: int = 32,
        l2_normalize: bool = True,
        mesh=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.embeddings = EmbeddingCollection(specs, embedding_dim, mesh=mesh,
                                              generator=generator)
        self.projection = MLP(len(self.embeddings.specs) * embedding_dim,
                              hidden, output_dim=output_dim,
                              generator=generator)
        self.l2_normalize = l2_normalize

    def forward(self, batch) -> torch.Tensor:
        stacked = self.embeddings(batch)
        out = self.projection(stacked.reshape(stacked.shape[0], -1))
        if self.l2_normalize:
            out = out / torch.linalg.norm(out, dim=-1,
                                          keepdim=True).clamp_min(1e-12)
        return out


@records_config
class TwoTower(nn.Module):
    """Query and candidate towers into a shared embedding space:
    ``model(query_batch, candidate_batch)`` -> (queries, candidates), each
    (B, output_dim)."""

    def __init__(
        self,
        query_specs: Sequence[Feature],
        candidate_specs: Sequence[Feature],
        embedding_dim: int = 32,
        hidden: Tuple[int, ...] = (64,),
        output_dim: int = 32,
        l2_normalize: bool = True,
        mesh=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.query_tower = Tower(query_specs, embedding_dim, hidden,
                                 output_dim, l2_normalize, mesh, generator)
        self.candidate_tower = Tower(candidate_specs, embedding_dim, hidden,
                                     output_dim, l2_normalize, mesh,
                                     generator)

    def forward(self, query_batch, candidate_batch):
        return (self.query_tower(query_batch),
                self.candidate_tower(candidate_batch))


@dataclasses.dataclass
class Retrieval:
    """The retrieval task: the loss's options and an optional
    :class:`FactorizedTopK`. ``compute_dtype`` (None or ``torch.bfloat16``)
    is the score product's operand dtype. ``axis_name`` and ``mesh``
    (pod-wide negatives) raise NotImplementedError."""

    temperature: Optional[float] = None
    num_hard_negatives: Optional[int] = None
    remove_accidental_negatives: bool = False
    metrics: Optional[FactorizedTopK] = None
    axis_name: Optional[str] = None
    mesh: Optional[object] = None
    compute_dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        if self.axis_name is not None or self.mesh is not None:
            raise NotImplementedError(_NOT_PORTED)
        check_compute_dtype(self.compute_dtype)

    def __call__(
        self,
        query_embeddings: torch.Tensor,
        candidate_embeddings: torch.Tensor,
        sample_weight: Optional[torch.Tensor] = None,
        candidate_sampling_probability: Optional[torch.Tensor] = None,
        candidate_ids: Optional[torch.Tensor] = None,
        metric_state=None,
    ):
        """The SUM-reduced loss, or (loss, updated metric state) when the
        task has metrics and a state is given. ``candidate_ids`` are used
        only with ``remove_accidental_negatives``, which requires them."""
        if self.remove_accidental_negatives and candidate_ids is None:
            raise ValueError(
                "remove_accidental_negatives requires candidate_ids")
        loss = in_batch_retrieval_loss(
            query_embeddings,
            candidate_embeddings,
            sample_weight=sample_weight,
            candidate_sampling_probability=candidate_sampling_probability,
            candidate_ids=(candidate_ids if self.remove_accidental_negatives
                           else None),
            num_hard_negatives=self.num_hard_negatives,
            temperature=self.temperature,
            compute_dtype=self.compute_dtype,
        )
        if self.metrics is None or metric_state is None:
            return loss
        with torch.no_grad():
            metric_state = self.metrics.update(
                metric_state, query_embeddings, candidate_embeddings)
        return loss, metric_state
