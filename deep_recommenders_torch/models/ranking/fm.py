"""Factorization Machine: layer + end-to-end model.

Counterpart of ``deep_recommenders_tpu/models/ranking/fm.py``:

- :class:`FMLayer`: a zero-initialised linear head over (B, S) sparse
  inputs plus the sum-square pairwise term over (B, F, D) embeddings; with
  no embeddings it is the linear head alone.
- :class:`FactorizationMachine`: first-order terms plus the pairwise term
  over shared embeddings, both from one fused (V, D+1) table pass, so a
  train step launches the embedding-gradient kernel K1 once. The pairwise
  term is the plain ``fm_interaction``, as in the JAX model (K2 is an op no
  model calls).

Both return logits (B, 1).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from deep_recommenders_torch.embedding.engine import (
    EmbeddingCollection,
    LinearTerms,
    fused_embedding_linear,
)
from deep_recommenders_torch.features.columns import Feature
from deep_recommenders_torch.models.common import records_config
from deep_recommenders_torch.ops.fm import fm_interaction


class FMLayer(nn.Module):
    """The FM kernel as a layer over pre-computed inputs: ``linear`` (a
    zero-initialised Dense of ``sparse_dim`` -> 1, flax's ``Dense(1,
    kernel_init=zeros)``) over ``sparse_inputs`` (B, S), plus
    ``fm_interaction(embedding_inputs)`` when embeddings are given."""

    def __init__(self, sparse_dim: int):
        super().__init__()
        self.linear = nn.Linear(sparse_dim, 1)
        nn.init.zeros_(self.linear.weight)
        nn.init.zeros_(self.linear.bias)

    def forward(self, sparse_inputs: torch.Tensor,
                embedding_inputs: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        linear = self.linear(sparse_inputs)
        if embedding_inputs is None:
            return linear
        return linear + fm_interaction(embedding_inputs)


@records_config
class FactorizationMachine(nn.Module):
    """End-to-end FM over categorical features -> (B, 1) logits.

    ``mesh`` raises NotImplementedError until the port has sharding;
    ``compute_dtype`` is None (fp32) or ``torch.bfloat16`` (the lookup in
    bf16; the first-order terms, the pairwise term's sums, the parameters
    and the logits fp32). Parameters: linear terms zero, table normal(0,
    1/sqrt(D)) from ``generator``.
    """

    def __init__(
        self,
        specs: Sequence[Feature],
        embedding_dim: int = 16,
        mesh=None,
        compute_dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.linear = LinearTerms(specs)
        self.embeddings = EmbeddingCollection(
            specs, embedding_dim, compute_dtype=compute_dtype, mesh=mesh,
            generator=generator,
        )

    def forward(self, batch) -> torch.Tensor:
        stacked, lin = fused_embedding_linear(
            self.embeddings, self.linear, batch
        )
        first_order = lin.sum(dim=1, keepdim=True) + self.linear.bias
        return first_order + fm_interaction(stacked)
