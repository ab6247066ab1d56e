"""Deep & Cross Network: the Cross layer (DCN-v2) and a full DCN model.

Counterpart of ``deep_recommenders_tpu/models/ranking/dcn.py``:
x_{l+1} = x0 * W(x_l) + x_l, W full rank (``dense``) or factored as
V(U(x)) of rank ``projection_dim`` (``dense_u``, ``dense_v``), with an
optional ``diag_scale * x`` added to the projection.

A Cross layer's Dense takes no compute dtype, as the JAX layer's: flax
then promotes a bf16 input and fp32 parameters to fp32. So under a model's
bf16 compute the cross stack computes in fp32 (``diag_scale * x`` is
rounded to x's dtype first, as JAX rounds a weak-typed scalar product), and
the MLP casts its input back to bf16.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from deep_recommenders_torch.embedding.engine import EmbeddingCollection
from deep_recommenders_torch.features.columns import Feature
from deep_recommenders_torch.models.common import (
    MLP,
    Dense,
    records_config,
    truncated_normal_,
)


def _cross_dense(in_features: int, out_features: int, use_bias: bool,
                 generator: Optional[torch.Generator]) -> nn.Linear:
    layer = nn.Linear(in_features, out_features, bias=use_bias)
    truncated_normal_(layer.weight, 0.05, generator)
    if use_bias:
        nn.init.zeros_(layer.bias)
    return layer


def _promoted(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.Dense`` with no dtype: input and parameters promoted to
    their common dtype."""
    dt = torch.promote_types(x.dtype, layer.weight.dtype)
    return nn.functional.linear(
        x.to(dt), layer.weight.to(dt),
        None if layer.bias is None else layer.bias.to(dt))


class Cross(nn.Module):
    """One cross layer over (B, ``dim``) inputs: x0 * proj(x) + x.

    ``dim`` is explicit (flax infers it at the first call), so the checks
    of ``projection_dim`` (at most dim / 2, not negative) and of
    ``diag_scale`` (not negative) raise ValueError at construction.
    """

    def __init__(
        self,
        dim: int,
        projection_dim: Optional[int] = None,
        diag_scale: float = 0.0,
        use_bias: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if diag_scale < 0:
            raise ValueError(
                f"diag_scale must be non-negative, got {diag_scale}")
        self.dim = dim
        self.projection_dim = projection_dim
        self.diag_scale = diag_scale
        if projection_dim is None:
            self.dense = _cross_dense(dim, dim, use_bias, generator)
        else:
            if projection_dim < 0 or projection_dim > dim // 2:
                raise ValueError(
                    "`projection_dim` should be positive and at most "
                    f"last_dim/2; got {projection_dim} for dim {dim}")
            self.dense_u = _cross_dense(dim, projection_dim, False,
                                        generator)
            self.dense_v = _cross_dense(projection_dim, dim, use_bias,
                                        generator)

    def forward(self, x0: torch.Tensor,
                x: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x is None:
            x = x0
        if x0.shape[-1] != x.shape[-1]:
            raise ValueError(f"`x0` and `x` dim mismatch: {x0.shape[-1]} "
                             f"vs {x.shape[-1]}")
        if self.projection_dim is None:
            prod = _promoted(self.dense, x)
        else:
            prod = _promoted(self.dense_v, _promoted(self.dense_u, x))
        if self.diag_scale:
            prod = prod + self.diag_scale * x
        return x0 * prod + x


@records_config
class DCN(nn.Module):
    """Full DCN: embeddings -> stacked cross layers -> MLP -> logit, or,
    with ``structure="parallel"``, the crosses and the MLP both over the
    embeddings, concatenated before the head.

    ``mesh`` raises NotImplementedError until the port has sharding;
    ``compute_dtype`` is None (fp32) or ``torch.bfloat16`` (the lookup and
    the MLP in bf16, the crosses in fp32 as above, the ``head`` Dense in
    fp32 always). Parameters: table normal(0, 1/sqrt(D)), cross kernels
    truncated normal(0.05), MLP and head lecun-normal, from ``generator``.
    """

    def __init__(
        self,
        specs: Sequence[Feature],
        embedding_dim: int = 16,
        num_cross_layers: int = 3,
        projection_dim: Optional[int] = None,
        hidden: Tuple[int, ...] = (256, 128),
        structure: str = "stacked",
        mesh=None,
        compute_dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if structure not in ("stacked", "parallel"):
            raise ValueError(f"unknown structure {structure!r}")
        self.structure = structure
        self.embeddings = EmbeddingCollection(
            specs, embedding_dim, compute_dtype=compute_dtype, mesh=mesh,
            generator=generator,
        )
        width = len(self.embeddings.specs) * embedding_dim
        self.crosses = nn.ModuleList(
            Cross(width, projection_dim, generator=generator)
            for _ in range(num_cross_layers))
        self.deep = MLP(width, hidden, output_dim=None, generator=generator,
                        dtype=compute_dtype)
        head_in = hidden[-1] if hidden else width
        if structure == "parallel":
            head_in += width
        self.head = Dense(head_in, 1, generator)

    def forward(self, batch) -> torch.Tensor:
        stacked = self.embeddings(batch)
        x0 = stacked.reshape(stacked.shape[0], -1)
        x = x0
        for cross in self.crosses:
            x = cross(x0, x)
        if self.structure == "parallel":
            x = torch.cat([x, self.deep(x0).to(x.dtype)], dim=-1)
        else:
            x = self.deep(x)
        return self.head(x.float())
