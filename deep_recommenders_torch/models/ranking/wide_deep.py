"""Wide & Deep: a wide linear model (with crossed features) and a deep MLP.

Counterpart of ``deep_recommenders_tpu/models/ranking/wide_deep.py``:
logits = wide(batch) + mlp(flatten(embeddings)). Two branches, as in JAX:

- ``wide_specs`` covers every deep feature (the usual shape: the deep
  features plus crosses): the deep features' first-order weights ride along
  the embedding table as column D of one (V, D+1) pass (``wide_linear``, no
  bias), and only the other wide features get their own pass
  (``wide_extra``, with the bias). Two K1 launches a train step with
  extras, one without.
- otherwise a separate ``wide`` :class:`LinearTerms` and ``embeddings``.

Every wide parameter's name starts with ``wide``, so
``training.optimizers.scoped_optimizer({"wide": Ftrl(...)}, ...)`` sends
them to FTRL, as the JAX example's optimizer split does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from deep_recommenders_torch.embedding.engine import (
    EmbeddingCollection,
    LinearTerms,
    fused_embedding_linear,
)
from deep_recommenders_torch.features.columns import CrossedFeature, Feature
from deep_recommenders_torch.models.common import MLP, records_config

Spec = Union[Feature, CrossedFeature]


@records_config
class WideDeep(nn.Module):
    """``mesh`` raises NotImplementedError until the port has sharding;
    ``compute_dtype`` is None (fp32) or ``torch.bfloat16`` (the lookup and
    the MLP in bf16; the wide terms, parameters and logits fp32)."""

    def __init__(
        self,
        deep_specs: Sequence[Feature],
        wide_specs: Sequence[Spec],
        embedding_dim: int = 16,
        hidden: Tuple[int, ...] = (256, 128, 64),
        mesh=None,
        compute_dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        deep_specs, wide_specs = tuple(deep_specs), tuple(wide_specs)
        deep_set = set(deep_specs)
        extras = tuple(s for s in wide_specs if s not in deep_set)
        self.fused_wide = deep_set <= set(wide_specs)
        if self.fused_wide:
            self.wide_linear = LinearTerms(deep_specs, use_bias=False)
            self.wide_extra = (LinearTerms(extras, use_bias=True)
                               if extras else None)
        else:
            self.wide = LinearTerms(wide_specs)
        self.embeddings = EmbeddingCollection(
            deep_specs, embedding_dim, compute_dtype=compute_dtype,
            mesh=mesh, generator=generator,
        )
        self.deep = MLP(len(deep_specs) * embedding_dim, hidden,
                        output_dim=1, generator=generator,
                        dtype=compute_dtype)

    def forward(self, batch) -> torch.Tensor:
        if self.fused_wide:
            stacked, lin = fused_embedding_linear(
                self.embeddings, self.wide_linear, batch
            )
            wide_logit = lin.sum(dim=1, keepdim=True)
            if self.wide_extra is not None:
                wide_logit = wide_logit + self.wide_extra(batch)
        else:
            wide_logit = self.wide(batch)
            stacked = self.embeddings(batch)
        deep_logit = self.deep(stacked.reshape(stacked.shape[0], -1))
        return wide_logit + deep_logit.float()
