"""Embedding engine: one fused table per collection, routed lookups, combiners.

Counterpart of ``deep_recommenders_tpu/embedding/engine.py`` without its mesh
branch. All features of a collection share one fused (total_vocab, D) table
with per-feature row offsets; ``fused_rows`` routes each feature by
cardinality:

- small vocab (<= SMALL_VOCAB_MAX): every such feature folds into ONE
  block-diagonal one-hot matmul (bags (B, sum_V) @ block_diag(slices));
- big vocab, single-valued: ONE ``lookup`` of (B, n_big) ids, whose backward
  is kernel K1 on the card;
- big vocab, multi-valued: a ``lookup`` per feature plus a weighted sum.

Host-side encoding (features/columns.py) produced dense int32 ids, so the
device never sees strings or ragged shapes.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from deep_recommenders_torch.features.columns import WEIGHT_SUFFIX, Feature
from deep_recommenders_torch.ops.embedding_kernels import lookup

Batch = Dict[str, torch.Tensor]


def _offsets(specs: Sequence[Feature]) -> Tuple[Tuple[int, ...], int]:
    offs, total = [], 0
    for s in specs:
        offs.append(total)
        total += s.cardinality
    return tuple(offs), total


# Features with at most this many buckets are looked up as one-hot matmuls
# instead of gathers: their backward is then a dense matmul and not a
# scatter-add whose ids collide heavily (8192 x 6 genre ids into 19 rows).
SMALL_VOCAB_MAX = 256


def _one_hot(ids: torch.Tensor, num_classes: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: ids outside [0, num_classes) give a zero row."""
    classes = torch.arange(num_classes, device=ids.device, dtype=ids.dtype)
    return (ids.unsqueeze(-1) == classes).to(dtype)


def _sum_bag(spec: Feature, batch: Batch, dtype) -> torch.Tensor:
    """(B, cardinality) bag vector with SUM-combiner semantics: a one-hot row,
    or the weighted sum of the bag's one-hots for a multi-valued feature."""
    ids = batch[spec.name]
    oh = _one_hot(ids, spec.cardinality, dtype)
    if spec.is_multi:
        wt = batch[spec.name + WEIGHT_SUFFIX].to(dtype)
        return torch.einsum("blv,bl->bv", oh, wt)
    return oh


def _mean_denom(spec: Feature, batch: Batch, b: int) -> torch.Tensor:
    """(B,) divisor turning a SUM-combined bag into the spec's combiner."""
    if spec.is_multi and spec.combiner == "mean":
        wt = batch[spec.name + WEIGHT_SUFFIX]
        return wt.sum(-1).clamp_min(1.0)
    return torch.ones((b,), dtype=torch.float32,
                      device=batch[spec.name].device)


def fused_rows(
    table: torch.Tensor,
    specs: Sequence[Feature],
    offsets: Sequence[int],
    batch: Batch,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-feature table-row bundles with the combiner fused in.

    Returns ``(rows, denom)``: rows (B, F, C) holding each feature's
    SUM-combined table rows in spec order, and denom (B, F, 1), the
    mean-combiner divisor (1.0 where the combiner is sum or the feature is
    single-valued). Embeddings divide; first-order terms do not.
    """
    b = batch[specs[0].name].shape[0]
    c = table.shape[1]
    parts: Dict[int, torch.Tensor] = {}
    indexed = list(enumerate(zip(specs, offsets)))
    small = [(i, s, o) for i, (s, o) in indexed
             if s.cardinality <= SMALL_VOCAB_MAX]
    big_single = [(i, s, o) for i, (s, o) in indexed
                  if s.cardinality > SMALL_VOCAB_MAX and not s.is_multi]
    big_multi = [(i, s, o) for i, (s, o) in indexed
                 if s.cardinality > SMALL_VOCAB_MAX and s.is_multi]

    if small:
        bags = torch.cat(
            [_sum_bag(s, batch, table.dtype) for _, s, _ in small], dim=-1
        )  # (B, sum_V)
        block = torch.block_diag(
            *[table[o : o + s.cardinality] for _, s, o in small]
        )  # (sum_V, n_small * C)
        out = (bags @ block).reshape(b, len(small), c)
        for slot, (i, _, _) in enumerate(small):
            parts[i] = out[:, slot]

    if big_single:
        ids = torch.stack(
            [batch[s.name] + o for _, s, o in big_single], dim=1
        )  # (B, n_big)
        rows = lookup(table, ids)  # (B, n_big, C); K1 backward
        for slot, (i, _, _) in enumerate(big_single):
            parts[i] = rows[:, slot]

    for i, s, o in big_multi:
        vecs = lookup(table, batch[s.name] + o)  # (B, L, C)
        wt = batch[s.name + WEIGHT_SUFFIX].to(vecs.dtype)
        parts[i] = torch.einsum("blc,bl->bc", vecs, wt)

    rows = torch.stack([parts[i] for i in range(len(specs))], dim=1)
    denom = torch.stack(
        [_mean_denom(s, batch, b) for s in specs], dim=1
    )[..., None]  # (B, F, 1)
    return rows, denom


class EmbeddingCollection(nn.Module):
    """Embeds a set of categorical features into a stacked (B, F, D) tensor.

    All features share one fused ``table`` of shape (sum_of_cardinalities,
    dim), initialised normal(0, 1/sqrt(dim)) as in the JAX package.
    Multi-hot features are combined (mean/sum) with their padding weights, so
    every feature contributes exactly one D-vector per example.
    """

    def __init__(
        self,
        specs: Sequence[Feature],
        dim: int,
        compute_dtype=None,
        mesh=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if mesh is not None:
            raise NotImplementedError("mesh sharding is not ported yet")
        if compute_dtype is not None:
            raise NotImplementedError(
                "compute_dtype is not ported yet: the port computes in fp32"
            )
        self.specs = tuple(specs)
        self.dim = dim
        self.feature_offsets, total = _offsets(self.specs)
        self.table = nn.Parameter(torch.empty(total, dim))
        nn.init.normal_(self.table, 0.0, 1.0 / math.sqrt(dim),
                        generator=generator)

    def forward(self, batch: Batch) -> torch.Tensor:
        """batch: {name: (B,) or (B, L) int32 ids, name__wt: (B, L) f32}."""
        rows, denom = fused_rows(
            self.table, self.specs, self.feature_offsets, batch
        )
        return rows / denom


class LinearTerms(nn.Module):
    """First-order (wide/linear) model over categorical features -> (B, 1).

    A learned scalar per bucket, summed across features (SUM combiner
    throughout, as tf.feature_column.linear_model), plus a bias: a fused
    dim-1 table that shares the engine's routing. Zero-initialised.
    """

    def __init__(self, specs: Sequence[Feature]):
        super().__init__()
        self.specs = tuple(specs)
        self.feature_offsets, total = _offsets(self.specs)
        self.weights = nn.Parameter(torch.zeros(total, 1))
        self.bias = nn.Parameter(torch.zeros(1))

    def per_feature(self, batch: Batch) -> torch.Tensor:
        """Un-summed per-feature first-order weights (B, F)."""
        rows, _ = fused_rows(
            self.weights, self.specs, self.feature_offsets, batch
        )
        return rows[..., 0]

    def forward(self, batch: Batch) -> torch.Tensor:
        return self.per_feature(batch).sum(dim=1, keepdim=True) + self.bias


def fused_embedding_linear(
    embeddings: EmbeddingCollection,
    linear: LinearTerms,
    batch: Batch,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Joint lookup of embeddings AND first-order weights in ONE table pass.

    The linear weights ride along as column D of a concatenated (V, D+1)
    operand, so the whole FM input is one ``fused_rows`` pass and both
    gradients come out of a single K1 launch (the concat's backward is a
    slice). Returns ``(stacked, first_order)``: (B, F, D) combined
    embeddings and (B, F) per-feature SUM-combined linear terms.
    """
    if embeddings.specs != linear.specs:
        raise ValueError("fused_embedding_linear requires identical specs")
    fused = torch.cat([embeddings.table, linear.weights], dim=1)
    rows, denom = fused_rows(
        fused, embeddings.specs, embeddings.feature_offsets, batch
    )
    d = embeddings.dim
    stacked = rows[..., :d] / denom
    first_order = rows[..., d].float()
    return stacked, first_order
