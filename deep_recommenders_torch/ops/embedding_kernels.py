"""Embedding-table gradient kernel (K1) and the lookup that uses it.

Counterpart of ``deep_recommenders_tpu/ops/embedding_kernels.py``. The hot
op of every ranking model is the fused-table lookup (embedding/engine.py
``fused_rows``): a (B, n) row gather from a (V, C) table. Its forward is a
plain gather; its backward is ``zeros((V, C)).at[ids].add(g)``.

- :func:`lookup` is ``table[ids]`` as a ``torch.autograd.Function`` whose
  backward calls :func:`scatter_add_rows`.
- :func:`scatter_add_rows` launches the CUDA kernel
  ``csrc/scatter_add_rows.cu`` for a CUDA tensor, on fp32 or bf16 g (the
  source says what bounds it and how it is built; on bf16 g into a large
  table, :func:`large_table_plan`, its second plan), and takes the plain
  version for a CPU tensor.
- :func:`scatter_add_rows_reference` is that plain version (``index_add_``).
- :func:`scatter_add_rows_in_segments` is the kernel's summation order, run
  with plain ops: on the CPU it gives the kernel's result bit for bit.

All follow JAX's ``zeros((V, C)).at[ids].add(g)``: an id in [-V, 0) adds
into row V + id and any other id outside [0, V) is dropped. The plain
version adds each row's updates in index order from +0.0 (``index_add_`` on
the CPU is that sequential sum). The kernel cuts the ids into segments of
:func:`segment_length` positions, adds a row's updates within a segment in
index order from +0.0, then the row's segment sums in segment order from
+0.0: a fixed order, so its result is the same on every run, and the plain
version's for every row whose updates lie in one segment.
"""

from __future__ import annotations

import ctypes

import torch

from deep_recommenders_torch.ops import _build

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ctypes.c_void_p,
]
# The kernel's limits (csrc/scatter_add_rows.cu: kMaxSegment, kStageFloats,
# kMaxCols): a segment's rows of g are staged in shared memory. A round of
# the kernel takes CLUSTER (kCluster) segments.
MAX_SEGMENT = 2048
STAGE_FLOATS = 2048 * 17
MAX_COLS = 8192
CLUSTER = 8
# The bf16 K1 takes its large-table plan (csrc/scatter_add_rows.cu:
# segment_runs, then row_ranges), whose work grows with the ids and not
# with the table, once the table's rows times the cluster plan's rounds
# (CLUSTER segments of ids a round) reach this: the cluster plan launches
# a cluster for every 2048 rows and runs each round over all of them.
# Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/k1_crossover.py):
# with one round (16384 ids at C = 17) the cluster plan is faster at
# 131072 rows, slower at 262144; with eight (131072 ids) equal at 16384,
# slower at 32768.
LARGE_TABLE_ROW_ROUNDS = 2**18


def segment_length(c: int) -> int:
    """Ids per segment of K1's summation order at row width ``c``: the
    largest power of two up to ``MAX_SEGMENT`` whose rows of g fit the
    kernel's stage (2048 at DeepFM's C = 17)."""
    if not 0 < c <= MAX_COLS:
        raise ValueError(f"scatter_add_rows: row width {c} not in "
                         f"[1, {MAX_COLS}]")
    segment = MAX_SEGMENT
    while segment * c > STAGE_FLOATS:
        segment //= 2
    return segment


def _rows(ids: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Each id's row: [-num_rows, 0) wraps to ``num_rows + id``; every other
    id outside [0, num_rows) goes to the spare row ``num_rows``."""
    rows = ids.long()
    rows = torch.where(rows < 0, rows + num_rows, rows)
    return torch.where((rows >= 0) & (rows < num_rows), rows, num_rows)


def scatter_add_rows_reference(
    g: torch.Tensor, ids: torch.Tensor, num_rows: int
) -> torch.Tensor:
    """Plain ``zeros((num_rows, C)).at[ids].add(g)`` as JAX computes it:
    ids in [-num_rows, 0) wrap to ``num_rows + id``, and ``index_add_`` adds
    the rows in index order. Every other id outside [0, num_rows) adds into
    one spare row past the end, which is cut off: dropped, with no
    data-dependent shape (so no host sync). bf16 g is summed in fp32 and
    each row rounded once to bf16, as the TPU kernel does (JAX's off-TPU
    scatter in bf16 rounds after every add instead)."""
    acc = torch.float64 if g.dtype == torch.float64 else torch.float32
    out = torch.zeros((num_rows + 1, g.shape[1]), dtype=acc, device=g.device)
    out.index_add_(0, _rows(ids, num_rows), g.to(acc))
    return out[:num_rows].to(g.dtype)


def scatter_add_rows_in_segments(
    g: torch.Tensor, ids: torch.Tensor, num_rows: int,
    segment: int | None = None,
) -> torch.Tensor:
    """``zeros((num_rows, C)).at[ids].add(g)`` in the order of kernel K1:
    the ids in segments of ``segment`` positions (default
    ``segment_length(C)``), each row's updates within a segment added in
    index order from +0.0, then its segment sums in segment order from
    +0.0. Run on the CPU (where ``index_add_`` adds in index order) it is
    the kernel's result bit for bit."""
    n, c = g.shape
    segment = segment or segment_length(c)
    nseg = max(1, -(-n // segment))
    rows = _rows(ids, num_rows)
    key = rows * nseg + torch.arange(n, device=g.device) // segment
    keys, slot = torch.unique(key, return_inverse=True)  # sorted
    parts = torch.zeros((keys.shape[0], c), dtype=g.dtype, device=g.device)
    parts.index_add_(0, slot, g)
    out = torch.zeros((num_rows + 1, c), dtype=g.dtype, device=g.device)
    return out.index_add_(0, keys // nseg, parts)[:num_rows]


def large_table_plan(n: int, c: int, num_rows: int) -> bool:
    """Whether the bf16 K1 on (n, c) g into ``num_rows`` rows takes its
    large-table plan: when ``num_rows`` times the cluster plan's rounds of
    ``CLUSTER * segment_length(c)`` ids is ``LARGE_TABLE_ROW_ROUNDS`` or
    more (never for no ids)."""
    rounds = -(-n // (CLUSTER * segment_length(c)))
    return num_rows * rounds >= LARGE_TABLE_ROW_ROUNDS


# The kernel's C function by g's dtype.
_SYMBOLS = {torch.float32: "scatter_add_rows_f32",
            torch.bfloat16: "scatter_add_rows_bf16"}


def scatter_add_rows(
    g: torch.Tensor, ids: torch.Tensor, num_rows: int
) -> torch.Tensor:
    """``zeros((num_rows, C)).at[ids].add(g)``: (N, C), (N,) i32 -> (V, C)
    in g's dtype, fp32 or bf16.

    On a CUDA tensor this launches kernel K1, which writes every row in one
    launch in the fixed order of :func:`scatter_add_rows_in_segments` (no
    atomics: the same bits on every run), and counts the launch in
    ``scatter_add_rows.launches`` (fp32 g) or
    ``scatter_add_rows.launches_bf16`` (bf16 g; on a large table,
    :func:`large_table_plan`, its large-table plan, counted in
    ``scatter_add_rows.launches_bf16_large`` too). On bf16 g, as the TPU
    kernel on bf16 g, every sum is fp32 and each row is rounded once to
    bf16: ``scatter_add_rows_in_segments(g.float(), ids, V).bfloat16()``
    bit for bit. Any other dtype raises. On a CPU tensor it is the plain
    version, in g's dtype.
    """
    if g.device.type == "cpu":
        return scatter_add_rows_reference(g, ids, num_rows)
    if g.device.type != "cuda":
        raise ValueError(f"scatter_add_rows: unsupported device {g.device}")
    if g.dtype not in _SYMBOLS or g.dim() != 2:
        raise TypeError(
            f"scatter_add_rows: g must be (N, C) float32 or bfloat16, got "
            f"{g.dtype} {tuple(g.shape)}"
        )
    if ids.dtype != torch.int32 or tuple(ids.shape) != (g.shape[0],):
        raise TypeError(
            f"scatter_add_rows: ids must be ({g.shape[0]},) int32, got "
            f"{ids.dtype} {tuple(ids.shape)}"
        )
    if ids.device != g.device:
        raise ValueError("scatter_add_rows: g and ids on different devices")
    n, c = g.shape
    if not 0 < num_rows < 2**31 or n >= 2**31 - 2**15:
        raise ValueError(f"scatter_add_rows: bad shape g {(n, c)} into "
                         f"{num_rows} rows")
    out = torch.empty((num_rows, c), dtype=g.dtype, device=g.device)
    if c == 0:
        return out
    segment = segment_length(c)
    g = g.contiguous()
    ids = ids.contiguous()
    stream = torch.cuda.current_stream(g.device).cuda_stream
    if g.dtype == torch.float32:
        fn = _build.function("scatter_add_rows", _SYMBOLS[g.dtype],
                             _ARGTYPES)
        code = fn(out.data_ptr(), g.data_ptr(), ids.data_ptr(), n, c,
                  num_rows, segment, stream)
        _build.check(code, "scatter_add_rows")
        scatter_add_rows.launches += 1
        return out
    if large_table_plan(n, c, num_rows):
        # The large-table plan: a workspace of n runs (fp32 sums, int32
        # rows) and each segment's first run of every range of rows.
        size = _build.function(
            "scatter_add_rows", "scatter_add_rows_bf16_large_workspace",
            [ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32],
            restype=ctypes.c_int64)(n, c, num_rows, segment)
        work = torch.empty((max(size, 1),), dtype=torch.uint8,
                           device=g.device)
        fn = _build.function(
            "scatter_add_rows", "scatter_add_rows_bf16_large",
            _ARGTYPES[:-1] + [ctypes.c_void_p] * 2)
        code = fn(out.data_ptr(), g.data_ptr(), ids.data_ptr(), n, c,
                  num_rows, segment, work.data_ptr(), stream)
        _build.check(code, "scatter_add_rows_bf16_large")
        scatter_add_rows.launches_bf16 += 1
        scatter_add_rows.launches_bf16_large += 1
        return out
    # bf16: an fp32 workspace only when the ids take more than one round
    # of the kernel's segments; else each row is rounded straight out.
    workspace = (torch.empty((num_rows, c), dtype=torch.float32,
                             device=g.device)
                 if n > CLUSTER * segment else None)
    fn = _build.function("scatter_add_rows", _SYMBOLS[g.dtype],
                         _ARGTYPES[:-1] + [ctypes.c_void_p,
                                           ctypes.c_void_p])
    code = fn(out.data_ptr(), g.data_ptr(), ids.data_ptr(), n, c, num_rows,
              segment, None if workspace is None else workspace.data_ptr(),
              stream)
    _build.check(code, "scatter_add_rows_bf16")
    scatter_add_rows.launches_bf16 += 1
    return out


scatter_add_rows.launches = 0
scatter_add_rows.launches_bf16 = 0
scatter_add_rows.launches_bf16_large = 0


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
        # DeepFM's path: flatten it to (N, C) rows beside (N,) ids. It is in
        # the table's dtype, and so is the table gradient returned: for a
        # bf16 table (a model's compute dtype) K1 reads bf16 g and writes
        # bf16 rows, and the cast of the fp32 parameter to bf16 upcasts them
        # in its backward, the one pass over (V, C) the TPU path's cast
        # makes too. An fp32 result would cost a second: autograd would
        # round it to the bf16 input's dtype first.
        flat_g = g.reshape(-1, g.shape[-1]).contiguous()
        dt = scatter_add_rows(flat_g, ids.reshape(-1), ctx.num_rows)
        return dt, None


def lookup(
    table: torch.Tensor, ids: torch.Tensor, precision: str = "bf16"
) -> torch.Tensor:
    """``table[ids]`` (ids.shape + (C,)) with the K1 backward.

    ``precision`` is accepted as in the JAX package, where "bf16" rounds g
    on the TPU's matrix unit. Both values give the same result here: that
    rounding was an artifact of the MXU, not part of the function. The
    gradient is in the table's dtype (fp32 or bf16; the kernel's sums are
    fp32 in both).
    """
    if precision not in ("bf16", "f32"):
        raise ValueError(f"unknown precision {precision!r}")
    if ids.dtype != torch.int32:
        raise TypeError(f"lookup: ids must be int32, got {ids.dtype}")
    return _Lookup.apply(table, ids)
