"""Placement helpers on a ("data", "model") mesh (counterpart of
``deep_recommenders_tpu/parallel/sharding.py``).

Conventions, as in the JAX package:

- activations: the batch dim split over "data" (each process holds its
  data coordinate's slice);
- embedding tables: rows split over "model" (each process holds its model
  coordinate's rows, :func:`row_range`);
- dense parameters: replicated.

JAX states these as ``NamedSharding`` constraints and lets GSPMD insert the
collectives. torch has no such compiler pass, so the port issues them
itself: :func:`all_reduce` over an axis's process group, counted in
``all_reduce.calls``, and :func:`all_gather` built on it. JAX's
``replicated``, ``batch_sharding``, ``table_sharding`` and
``with_sharding`` build or apply those constraints and have no counterpart
here.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"
MODEL_AXIS = "model"


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This process's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str) -> dist.ProcessGroup:
    """The process group of the processes that share this process's other
    coordinate (its peers along ``axis``)."""
    return mesh.get_group(axis)


def all_reduce(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Sum ``x`` in place over ``axis``'s group and return it. Every call is
    one collective, counted in ``all_reduce.calls``."""
    all_reduce.calls += 1
    dist.all_reduce(x, group=axis_group(mesh, axis))
    return x


all_reduce.calls = 0


class _AllGather(torch.autograd.Function):
    """The blocks of every process along an axis, stacked in axis order;
    the backward is the transpose of JAX's ``lax.all_gather``, a
    reduce-scatter: the cotangent summed over the axis, this process's
    block kept."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.index, ctx.rows = axis_index(mesh, axis), x.shape[0]
        return _gather(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.contiguous().clone(), ctx.mesh, ctx.axis)
        lo = ctx.index * ctx.rows
        return g[lo:lo + ctx.rows], None, None


def _gather(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    # Each process writes its block into zeros and one all-reduce sums
    # them: x + 0 is exact, and gloo takes an all-reduce of CUDA tensors
    # where it takes no all-gather of them.
    n = axis_size(mesh, axis)
    out = x.new_zeros((n,) + tuple(x.shape))
    out[axis_index(mesh, axis)] = x
    all_reduce(out, mesh, axis)
    return out.reshape((n * x.shape[0],) + tuple(x.shape[1:]))


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """``lax.all_gather(x, axis).reshape(-1, ...)``: the (B, ...) blocks of
    the processes along ``axis`` concatenated in axis order, (n B, ...),
    on every one of them. Differentiable: the gradient of this process's
    block is the sum over the axis of the cotangents of its rows. One
    all-reduce forward (and one backward), counted in
    ``all_reduce.calls``."""
    if x.requires_grad:
        return _AllGather.apply(x, mesh, axis)
    return _gather(x, mesh, axis)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this process computes on: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def padded_rows(num_rows: int, mesh: DeviceMesh) -> int:
    """``num_rows`` rounded up to a multiple of the model axis's size, so
    every shard holds the same number of rows (padding rows are never
    addressed)."""
    n_model = axis_size(mesh, MODEL_AXIS)
    return -(-num_rows // n_model) * n_model


def row_range(num_rows: int, mesh: DeviceMesh) -> Tuple[int, int]:
    """``[lo, hi)``: the rows of a table of ``num_rows`` rows (padded as
    :func:`padded_rows`) that this process's model coordinate holds."""
    size = padded_rows(num_rows, mesh) // axis_size(mesh, MODEL_AXIS)
    lo = axis_index(mesh, MODEL_AXIS) * size
    return lo, lo + size


def row_shard(table: torch.Tensor, rows: int) -> torch.nn.Parameter:
    """``table`` (this process's rows) as a parameter marked as a row shard:
    it holds different rows on each process of a data group's peers along
    "model", and the same rows across its data group. ``rows`` is the
    whole tensor's leading size before any padding (``full_rows``), which
    a checkpoint records to cut the joined state again."""
    p = torch.nn.Parameter(table)
    p.row_shard = True
    p.full_rows = rows
    return p


def is_row_shard(p: torch.Tensor) -> bool:
    return getattr(p, "row_shard", False)


def host_array(x: Any, mesh: DeviceMesh) -> torch.Tensor:
    """This process's local data ``x`` (its slice of the batch, or a copy
    of a replicated value) as a tensor on its device. The port has no
    global array: each process keeps its own part."""
    t = torch.as_tensor(np.ascontiguousarray(x) if isinstance(x, np.ndarray)
                        else x)
    return t.to(mesh_device(mesh), copy=True)


def shard_batch(batch: Any, mesh) -> Any:
    """Each array of a (nested) batch on this process's device: the batch a
    process passes is its data coordinate's slice of the global batch
    (global rows = local rows x data size). Without a mesh the arrays
    become tensors where they are."""
    from deep_recommenders_torch.training.data import map_features

    if mesh is None:
        return map_features(torch.as_tensor, batch)
    return map_features(lambda x: host_array(x, mesh), batch)


def replicate_on_mesh(x: Any, mesh: DeviceMesh) -> torch.Tensor:
    """``x`` on this process's device, equal on every process: rank 0's
    value, broadcast over the whole group."""
    t = host_array(x, mesh)
    dist.broadcast(t, src=0)
    return t
