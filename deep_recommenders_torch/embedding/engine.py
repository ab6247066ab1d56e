"""Embedding engine: one fused table per collection, routed lookups, combiners.

Counterpart of ``deep_recommenders_tpu/embedding/engine.py``. All features of
a collection share one fused (total_vocab, D) table with per-feature row
offsets; ``fused_rows`` routes each feature by cardinality:

- small vocab (<= SMALL_VOCAB_MAX): every such feature folds into ONE
  block-diagonal one-hot matmul (bags (B, sum_V) @ block_diag(slices));
- big vocab, single-valued: ONE ``lookup`` of (B, n_big) ids, whose backward
  is kernel K1 on the card;
- big vocab, multi-valued: a ``lookup`` per feature plus a weighted sum.

Host-side encoding (features/columns.py) produced dense int32 ids, so the
device never sees strings or ragged shapes.

Under a mesh (``mesh=``, a ("data", "model") ``DeviceMesh``) the fused table
is padded to a multiple of the model axis's size and each process keeps its
model coordinate's rows as its own parameter, a plain local tensor; the
lookup runs ``fused_rows`` on that shard and one all-reduce over "model"
completes it (``embedding/sharded.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from deep_recommenders_torch.device import (
    check_compute_dtype,
    check_param_dtype,
)
from deep_recommenders_torch.embedding.sharded import (
    shard_rows,
    sharded_fused_rows,
)
from deep_recommenders_torch.features.columns import WEIGHT_SUFFIX, Feature
from deep_recommenders_torch.ops.embedding_kernels import lookup
from deep_recommenders_torch.parallel.mesh import check_mesh
from deep_recommenders_torch.parallel.sharding import (
    padded_rows,
    row_range,
    row_shard,
)

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
    *,
    gather=None,
    slice_rows=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-feature table-row bundles with the combiner fused in.

    Returns ``(rows, denom)``: rows (B, F, C) holding each feature's
    SUM-combined table rows in spec order, and denom (B, F, 1), the
    mean-combiner divisor (1.0 where the combiner is sum or the feature is
    single-valued). Embeddings divide; first-order terms do not.

    ``gather(ids) -> rows`` and ``slice_rows(offset, card) -> (card, C)``
    give the row access: by default the whole table (``lookup`` and a
    slice); under a mesh, one shard's masked access
    (``embedding/sharded.local_access_fns``), so the same routing runs per
    shard and one all-reduce completes every feature.
    """
    if gather is None:
        gather = lambda ids: lookup(table, ids)  # noqa: E731
    if slice_rows is None:
        slice_rows = lambda off, card: table[off:off + card]  # noqa: E731
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
            *[slice_rows(o, s.cardinality) for _, s, o in small]
        )  # (sum_V, n_small * C)
        out = (bags @ block).reshape(b, len(small), c)
        for slot, (i, _, _) in enumerate(small):
            parts[i] = out[:, slot]

    if big_single:
        ids = torch.stack(
            [batch[s.name] + o for _, s, o in big_single], dim=1
        )  # (B, n_big)
        rows = gather(ids)  # (B, n_big, C); K1 backward
        for slot, (i, _, _) in enumerate(big_single):
            parts[i] = rows[:, slot]

    for i, s, o in big_multi:
        vecs = gather(batch[s.name] + o)  # (B, L, C)
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

    ``param_dtype`` is the dtype the table is stored in, fp32 or bf16; the
    draw is fp32 from ``generator``, then cast. A bf16 table is looked up
    in bf16 (the one-hot matmul, the gather and the bag sums), its rows
    come out bf16, and its gradient is bf16: K1 on bf16 gradients, written
    straight into the parameter's gradient. With
    ``compute_dtype=torch.bfloat16`` an fp32 table is cast to bf16 before
    the same lookup, and the cast's backward upcasts the bf16 gradient.

    With ``mesh`` the fused vocab is padded to a multiple of the model
    axis's size (``total_vocab``) and ``table`` holds this process's rows
    ``[shard_lo, shard_lo + total_vocab / n_model)`` of the table the
    unmeshed module would draw from the same ``generator`` (the padding
    rows drawn after it).
    """

    def __init__(
        self,
        specs: Sequence[Feature],
        dim: int,
        compute_dtype=None,
        mesh=None,
        generator: Optional[torch.Generator] = None,
        param_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.compute_dtype = check_compute_dtype(compute_dtype)
        self.param_dtype = check_param_dtype(param_dtype)
        self.specs = tuple(specs)
        self.dim = dim
        self.mesh = mesh
        self.feature_offsets, vocab = _offsets(self.specs)
        self.shard_lo, total = 0, vocab
        if mesh is not None:
            check_mesh(mesh)
            self.shard_lo, hi = row_range(vocab, mesh)
            total = padded_rows(vocab, mesh)
        self.total_vocab = total
        table = torch.empty(total, dim)
        nn.init.normal_(table, 0.0, 1.0 / math.sqrt(dim), generator=generator)
        table = table.to(param_dtype)
        if mesh is None:
            self.table = nn.Parameter(table)
        else:
            self.table = row_shard(table[self.shard_lo:hi].clone(), vocab)

    def compute_table(self) -> torch.Tensor:
        """The table in the compute dtype: the parameter itself when the
        two dtypes agree (or no compute dtype is set), else a cast of it."""
        if self.compute_dtype in (None, self.table.dtype):
            return self.table
        return self.table.to(self.compute_dtype)

    def rows(self, table: torch.Tensor, batch: Batch
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``fused_rows`` of ``table`` (this collection's table, or it with
        columns appended) over the batch: on the whole table, or under a
        mesh on this process's shard, completed by one all-reduce."""
        if self.mesh is None:
            return fused_rows(table, self.specs, self.feature_offsets, batch)
        rows = sharded_fused_rows(table, self.specs, self.feature_offsets,
                                  batch, self.mesh)
        b = rows.shape[0]
        denom = torch.stack(
            [_mean_denom(s, batch, b) for s in self.specs], dim=1
        )[..., None]
        return rows, denom

    def forward(self, batch: Batch) -> torch.Tensor:
        """batch: {name: (B,) or (B, L) int32 ids, name__wt: (B, L) f32}."""
        rows, denom = self.rows(self.compute_table(), batch)
        return rows / denom.to(rows.dtype)


class LinearTerms(nn.Module):
    """First-order (wide/linear) model over categorical features -> (B, 1).

    A learned scalar per bucket, summed across features (SUM combiner
    throughout, as tf.feature_column.linear_model), plus a bias unless
    ``use_bias`` is False: a fused dim-1 table that shares the engine's
    routing. Zero-initialised, fp32 always.
    """

    def __init__(self, specs: Sequence[Feature], use_bias: bool = True):
        super().__init__()
        self.specs = tuple(specs)
        self.feature_offsets, total = _offsets(self.specs)
        self.weights = nn.Parameter(torch.zeros(total, 1))
        self.bias = nn.Parameter(torch.zeros(1)) if use_bias else None

    def per_feature(self, batch: Batch) -> torch.Tensor:
        """Un-summed per-feature first-order weights (B, F)."""
        rows, _ = fused_rows(
            self.weights, self.specs, self.feature_offsets, batch
        )
        return rows[..., 0]

    def forward(self, batch: Batch) -> torch.Tensor:
        total = self.per_feature(batch).sum(dim=1, keepdim=True)
        return total if self.bias is None else total + self.bias


def fused_embedding_linear(
    embeddings: EmbeddingCollection,
    linear: LinearTerms,
    batch: Batch,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Joint lookup of embeddings AND first-order weights in ONE table pass.

    The linear weights ride along as column D of a concatenated (V, D+1)
    operand, so the whole FM input is one ``fused_rows`` pass and both
    gradients come out of a single K1 launch (the concat's backward is a
    slice). Under a mesh the operand is this process's shard of the fused
    (V, D+1) table, and the linear weights' rows of it are cut from the
    replicated weights. The operand is in the dtype of
    ``embeddings.compute_table()`` (the compute dtype, or the table's own
    when none is set): fp32 linear weights beside a bf16 table are cast to
    bf16, as JAX casts them. Returns ``(stacked, first_order)``: (B, F, D)
    combined embeddings in that dtype and (B, F) per-feature SUM-combined
    linear terms, upcast to fp32 so that the wide sum over features does
    not round in bf16.
    """
    if embeddings.specs != linear.specs:
        raise ValueError("fused_embedding_linear requires identical specs")
    table = embeddings.compute_table()
    w = linear.weights
    if embeddings.mesh is not None:
        # The linear weights stay replicated (as in JAX): pad them as the
        # table is padded and take this shard's rows; their gradient is
        # made whole again by one all-reduce over "model".
        lo = embeddings.shard_lo
        w = nn.functional.pad(w, (0, 0, 0, embeddings.total_vocab
                                  - w.shape[0]))
        w = shard_rows(w, lo, lo + table.shape[0], embeddings.mesh)
    fused = torch.cat([table, w.to(table.dtype)], dim=1)
    rows, denom = embeddings.rows(fused, batch)
    d = embeddings.dim
    stacked = rows[..., :d] / denom.to(rows.dtype)
    first_order = rows[..., d].float()
    return stacked, first_order
