"""Row-sharded embedding exchange over the mesh's "model" axis.

Counterpart of ``deep_recommenders_tpu/embedding/sharded.py``. Each process
holds one row shard of a table (its model coordinate's rows,
``parallel.row_range``) and the whole batch of its data coordinate. A lookup
runs in two steps:

    each shard gathers only its resident rows (off-shard rows -> 0)
    one all-reduce over "model" sums the partial vectors

so every process of a model group ends with the same complete rows. The
all-reduce's backward is the identity: every process of the group computes
the same loss on the same rows, so each holds the same cotangent, and its
shard's gradient is that cotangent scattered into its own rows (the
transpose of JAX's ``psum`` in a ``shard_map`` whose output is replicated
over "model"). A backward that summed the cotangents over the group, as
``torch.distributed.nn.functional.all_reduce``'s does, would make every
table gradient n_model times too large.

The masked gather goes through the port's ``lookup``, so its backward on the
card is kernel K1 on the shard. Ids that are not resident point at local
row 0 with a zero gradient, so the scatter stays exact; at n_model = 2 about
half of all ids land there, which makes row 0 the shard's hottest row.

``sharded_fused_rows`` is the path the models take: ONE all-reduce for a
whole collection, running the engine's ``fused_rows`` routing per shard.
``sharded_lookup`` and ``sharded_embedding_bag`` are the single-feature
primitives.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh

from deep_recommenders_torch.ops.embedding_kernels import lookup
from deep_recommenders_torch.parallel.sharding import (
    MODEL_AXIS,
    all_reduce,
    axis_index,
)


class _SumOverModel(torch.autograd.Function):
    """All-reduce (sum) over the model group; the backward is the identity
    (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x.clone(), mesh, MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over_model(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The sum of every model shard's partial ``x``, replicated over the
    model group; the gradient passes through unchanged."""
    return _SumOverModel.apply(x, mesh)


class _ShardRows(torch.autograd.Function):
    """Rows [lo, hi) of a replicated tensor; the backward sums the shards'
    disjoint row gradients over the model group, so every process gets the
    replicated tensor's whole gradient."""

    @staticmethod
    def forward(ctx, x, lo, hi, mesh):
        ctx.shape, ctx.lo, ctx.hi, ctx.mesh = x.shape, lo, hi, mesh
        return x[lo:hi]

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full[ctx.lo:ctx.hi] = g
        return all_reduce(full, ctx.mesh, MODEL_AXIS), None, None, None


def shard_rows(x: torch.Tensor, lo: int, hi: int,
               mesh: DeviceMesh) -> torch.Tensor:
    """This shard's rows of a tensor replicated over the model group (the
    linear terms beside the fused table), with the gradient made whole
    again by one all-reduce over "model"."""
    return _ShardRows.apply(x, lo, hi, mesh)


def _base(table_shard: torch.Tensor, mesh: DeviceMesh) -> int:
    return axis_index(mesh, MODEL_AXIS) * table_shard.shape[0]


def local_access_fns(table_shard: torch.Tensor, mesh: DeviceMesh):
    """``(gather, slice_rows)`` against ONE row shard of a table.

    Both give zeros for rows that are not resident, so the sum of every
    shard's partials is the dense result. ``gather`` keeps ``lookup``'s
    backward (K1 on the card): masked ids point at local row 0 with a zero
    gradient. ``slice_rows`` is a feature's ``[off, off + card)`` window
    intersected with the shard; its indices are distinct, so its backward
    adds into distinct rows.
    """
    size = table_shard.shape[0]
    base = _base(table_shard, mesh)

    def gather(ids: torch.Tensor) -> torch.Tensor:
        local = ids - base
        ok = (local >= 0) & (local < size)
        vecs = lookup(table_shard, torch.where(ok, local, 0))
        return torch.where(ok[..., None], vecs, 0.0)

    def slice_rows(off: int, card: int) -> torch.Tensor:
        idx = torch.arange(off - base, off - base + card,
                           device=table_shard.device)
        ok = (idx >= 0) & (idx < size)
        rows = table_shard[torch.where(ok, idx, 0)]
        return torch.where(ok[:, None], rows, 0.0)

    return gather, slice_rows


def sharded_fused_rows(
    table_shard: torch.Tensor,
    specs: Sequence,
    offsets: Sequence[int],
    batch: Dict[str, torch.Tensor],
    mesh: DeviceMesh,
) -> torch.Tensor:
    """ONE exchange for ALL features of a collection.

    Each shard runs the engine's ``fused_rows`` routing (small-vocab
    block-diagonal matmul, one batched big gather, bag sums) against its
    resident rows; ONE all-reduce over "model" completes every feature.
    Returns SUM-combined rows (B, F, C); the mean combiner's division
    (which needs no table) happens after, as in JAX.
    """
    from deep_recommenders_torch.embedding.engine import fused_rows

    gather, slice_rows = local_access_fns(table_shard, mesh)
    rows, _ = fused_rows(table_shard, specs, offsets, batch,
                         gather=gather, slice_rows=slice_rows)
    return sum_over_model(rows, mesh)


def sharded_lookup(table_shard: torch.Tensor, ids: torch.Tensor,
                   mesh: DeviceMesh) -> torch.Tensor:
    """Rows of a row-sharded (V, D) table: (B,) or (B, L) ids -> (B[, L],
    D), with ``table_shard`` this process's rows."""
    gather, _ = local_access_fns(table_shard, mesh)
    return sum_over_model(gather(ids), mesh)


def sharded_embedding_bag(
    table_shard: torch.Tensor,
    ids: torch.Tensor,
    weights: torch.Tensor,
    mesh: DeviceMesh,
    *,
    combiner: str = "mean",
) -> torch.Tensor:
    """Multi-hot bag lookup and combine: (B, L) ids and weights -> (B, D).

    Each shard reduces its bags before the all-reduce, so (B, D) crosses
    the group and not (B, L, D); the mean's division follows it.
    """
    gather, _ = local_access_fns(table_shard, mesh)
    vecs = gather(ids)  # (B, L, D)
    summed = torch.einsum("bld,bl->bd", vecs, weights.to(vecs.dtype))
    out = sum_over_model(summed, mesh)
    if combiner == "mean":
        out = out / weights.sum(-1, keepdim=True).clamp_min(1.0).to(out.dtype)
    return out
