"""DeepFM: FM + deep tower over SHARED embeddings -> (B, 1) logits.

Counterpart of ``deep_recommenders_tpu/models/ranking/deepfm.py``:
logits = first_order + fm(emb) + mlp(flatten(emb)), where one fused
(V, D+1) table pass feeds the embeddings and the first-order weights, so the
table gradient of a train step is one K1 launch.

With ``compute_dtype=torch.bfloat16`` (mixed precision, as the JAX model's)
the lookup and the deep tower run in bf16 and the table gradient is K1 on
bf16 gradients; the parameters, the first-order terms, the FM term's sums
and the returned logits stay fp32.
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
from deep_recommenders_torch.ops.fm import fm_interaction


@records_config
class DeepFM(nn.Module):
    """``mesh`` (a ("data", "model") ``DeviceMesh``) row-shards the fused
    table over "model" (``embedding/engine.py``); ``compute_dtype`` is None
    (fp32) or ``torch.bfloat16``. Parameters are initialised from
    ``generator`` (linear terms zero, table normal, dense lecun-normal)."""

    def __init__(
        self,
        specs: Sequence[Feature],
        embedding_dim: int = 16,
        hidden: Tuple[int, ...] = (256, 32),
        dropout: float = 0.0,
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
        self.deep = MLP(
            len(self.embeddings.specs) * embedding_dim, hidden, output_dim=1,
            dropout=dropout if dropout else None, generator=generator,
            dtype=compute_dtype,
        )

    def forward(self, batch) -> torch.Tensor:
        stacked, lin = fused_embedding_linear(
            self.embeddings, self.linear, batch
        )
        first_order = lin.sum(dim=1, keepdim=True) + self.linear.bias
        fm_logit = fm_interaction(stacked)
        deep_logit = self.deep(stacked.reshape(stacked.shape[0], -1))
        return first_order + fm_logit + deep_logit.float()
