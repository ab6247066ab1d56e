"""FNN: a factorization-machine-supported neural network.

Counterpart of ``deep_recommenders_tpu/models/ranking/fnn.py``: the
per-feature first-order weights (B, F), cast to the embeddings' dtype,
concatenated with the flattened embeddings (B, F * D), feed an MLP. Both
come from one fused (V, D+1) table pass (one K1 launch a train step). The
submodules ``linear`` and ``embeddings`` are named as
:class:`FactorizationMachine`'s, so an FM's weights warm-start an FNN
(``training/warmstart.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from deep_recommenders_torch.embedding.engine import (
    EmbeddingCollection,
    LinearTerms,
    fused_embedding_linear,
)
from deep_recommenders_torch.features.columns import Feature
from deep_recommenders_torch.models.common import MLP, records_config


@records_config
class FNN(nn.Module):
    """``mesh`` (a ("data", "model") ``DeviceMesh``) row-shards the fused
    table over "model" (``embedding/engine.py``); ``compute_dtype`` is None
    (fp32) or ``torch.bfloat16`` (the lookup and the MLP in bf16;
    parameters and logits fp32)."""

    def __init__(
        self,
        specs: Sequence[Feature],
        embedding_dim: int = 16,
        hidden: Tuple[int, ...] = (256, 128, 64),
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
        f = len(self.embeddings.specs)
        self.deep = MLP(f * (embedding_dim + 1), hidden, output_dim=1,
                        generator=generator, dtype=compute_dtype)

    def forward(self, batch) -> torch.Tensor:
        stacked, first_order = fused_embedding_linear(
            self.embeddings, self.linear, batch
        )
        x = torch.cat([first_order.to(stacked.dtype),
                       stacked.reshape(stacked.shape[0], -1)], dim=1)
        return self.deep(x).float()
