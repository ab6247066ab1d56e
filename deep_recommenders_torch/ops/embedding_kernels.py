"""Embedding-table gradient kernel (K1) and the lookup that uses it.

Counterpart of ``deep_recommenders_tpu/ops/embedding_kernels.py``. The hot
op of every ranking model is the fused-table lookup (embedding/engine.py
``fused_rows``): a (B, n) row gather from a (V, C) table. Its forward is a
plain gather; its backward is ``zeros((V, C)).at[ids].add(g)``.

- :func:`lookup` is ``table[ids]`` as a ``torch.autograd.Function`` whose
  backward calls :func:`scatter_add_rows`.
- :func:`scatter_add_rows` launches the CUDA kernel
  ``csrc/scatter_add_rows.cu`` for a CUDA tensor (the source says what bounds
  it and how it is built) and takes the plain version for a CPU tensor.
- :func:`scatter_add_rows_reference` is that plain version (``index_add_``).
"""

from __future__ import annotations

import ctypes

import torch

from deep_recommenders_torch.ops import _build

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
]


def scatter_add_rows_reference(
    g: torch.Tensor, ids: torch.Tensor, num_rows: int
) -> torch.Tensor:
    """Plain ``zeros((num_rows, C)).index_add_(0, ids, g)``."""
    out = torch.zeros((num_rows, g.shape[1]), dtype=g.dtype, device=g.device)
    return out.index_add_(0, ids, g)


def scatter_add_rows(
    g: torch.Tensor, ids: torch.Tensor, num_rows: int
) -> torch.Tensor:
    """``zeros((num_rows, C)).at[ids].add(g)``: (N, C) f32, (N,) i32 -> (V, C).

    On a CUDA tensor this launches kernel K1 (fp32 atomics, so the order of
    the additions into a row changes from run to run) and counts the launch
    in ``scatter_add_rows.launches``; on a CPU tensor it is the plain version.
    """
    if g.device.type == "cpu":
        return scatter_add_rows_reference(g, ids, num_rows)
    if g.device.type != "cuda":
        raise ValueError(f"scatter_add_rows: unsupported device {g.device}")
    if g.dtype != torch.float32 or g.dim() != 2:
        raise TypeError(
            f"scatter_add_rows: g must be (N, C) float32, got {g.dtype} "
            f"{tuple(g.shape)}"
        )
    if ids.dtype != torch.int32 or tuple(ids.shape) != (g.shape[0],):
        raise TypeError(
            f"scatter_add_rows: ids must be ({g.shape[0]},) int32, got "
            f"{ids.dtype} {tuple(ids.shape)}"
        )
    if ids.device != g.device:
        raise ValueError("scatter_add_rows: g and ids on different devices")
    n, c = g.shape
    if not 0 < num_rows < 2**31 or c >= 2**31:
        raise ValueError(f"scatter_add_rows: bad shape ({num_rows}, {c})")
    out = torch.zeros((num_rows, c), dtype=torch.float32, device=g.device)
    if n == 0:
        return out
    g = g.contiguous()
    ids = ids.contiguous()
    fn = _build.function("scatter_add_rows", "scatter_add_rows_f32", _ARGTYPES)
    code = fn(
        out.data_ptr(), g.data_ptr(), ids.data_ptr(), n, c, num_rows,
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    _build.check(code, "scatter_add_rows")
    scatter_add_rows.launches += 1
    return out


scatter_add_rows.launches = 0


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(ids)
        ctx.num_rows = table.shape[0]
        rows = table.index_select(0, ids.reshape(-1))
        return rows.reshape(*ids.shape, table.shape[1])

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (ids,) = ctx.saved_tensors
        # g is the gradient of the whole (..., C) gather, e.g. (B, 2, 17) on
        # DeepFM's path: flatten it to (N, C) rows beside (N,) ids.
        flat_g = g.reshape(-1, g.shape[-1]).contiguous()
        dt = scatter_add_rows(flat_g, ids.reshape(-1), ctx.num_rows)
        return dt, None


def lookup(
    table: torch.Tensor, ids: torch.Tensor, precision: str = "bf16"
) -> torch.Tensor:
    """``table[ids]`` (ids.shape + (C,)) with the K1 backward.

    ``precision`` is accepted as in the JAX package, where "bf16" rounds g
    on the TPU's matrix unit. Both values compute in fp32 here: that rounding
    was an artifact of the MXU, not part of the function.
    """
    if precision not in ("bf16", "f32"):
        raise ValueError(f"unknown precision {precision!r}")
    if ids.dtype != torch.int32:
        raise TypeError(f"lookup: ids must be int32, got {ids.dtype}")
    return _Lookup.apply(table, ids)
