"""CIN kernels over flattened rows: the CIN layer (K4) and the fused 2-layer
stack (K3), forward and backward.

Counterpart of ``deep_recommenders_tpu/ops/cin_kernels.py``. A CIN layer
over (B, F, D) tensors is computed over rows r = b * D + d, so every tensor
is 2-D:

    out[r, m] = sum_{f,g} x0v[r, f] * xv[r, g] * W[f, g, m].

- :func:`cin2d` (K4) is one such layer, a ``torch.autograd.Function`` whose
  forward and backward launch ``csrc/cin2d.cu`` on a CUDA tensor.
- :func:`cin_stack_pooled` (K3) is xDeepFM's flagship stack: two relu layers
  and the sum of each layer over an example's D rows, with
  ``csrc/cin_stack.cu`` as its forward and backward. Its input x0v is
  bf16, as XDeepFM casts it.
- Every kernel has its plain PyTorch version here (``*_reference``). A CPU
  tensor takes the plain version; a CUDA tensor launches the kernel or
  raises. Launches are counted per direction in ``cin2d.launches`` and
  ``cin_stack_pooled.launches``.
- The forwards are ops that ``torch.export`` records
  (``ops/custom_ops.py``): ``cin2d_fwd`` (K4), ``cin_stack_fwd`` (K3 with
  its residuals, for training) and ``cin_stack_fwd_pooled`` (K3 without
  them, for inference). The backwards stay plain calls inside the
  autograd Functions.

K3 and K4, forward and backward, run on the card's tensor cores at the TPU
kernels' bf16 contract: bf16 operands, each pair product x0v[r, f] * xv[r, g]
rounded to bf16, fp32 accumulation, and bf16 intermediates where the TPU
kernels round (:func:`cin2d_reference_bf16`,
:func:`cin2d_backward_reference_bf16`, :func:`stack_forward_reference_bf16`
and :func:`stack_backward_reference_bf16` are those functions in plain
PyTorch). K3 keeps its residuals z1 and z2 in bf16 on the card, as the TPU
kernel saves them. On a CPU tensor every wrapper takes its fp32 plain
version (K3 with fp32 residuals), as the JAX package's off-TPU path takes
its fp32 reference. The bf16 cast of K3's x0v is part of the model.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from deep_recommenders_torch.ops import _build, custom_ops

_P = ctypes.c_void_p
_I64, _I32 = ctypes.c_int64, ctypes.c_int32


def weight_pass_plan(pair_columns: int) -> Tuple[int, int]:
    """(tile rows, chunk rows) of a backward kernel's weight pass over
    ``pair_columns`` = F0 x (H padded to a multiple of 8) pair columns: 64 x
    128 tiles of dW in 512-row chunks for at most 64 pair columns, 128 x 128
    tiles in 2048-row chunks for more, so that each pass has some 200-400
    blocks at R = 131072. Each chunk is summed apart, then the chunks in a
    fixed order. The launcher (``csrc/cin_tile.cuh``) takes both as
    given."""
    return (64, 512) if pair_columns <= 64 else (128, 2048)


# Dynamic shared memory an sm_90 block may hold (227 KB; cin_tile.cuh's
# kMaxSmem). The backwards' data kernels hold whole bf16 rows of the output
# gradient, so their shapes are bounded by it.
MAX_SMEM_BYTES = 232448


def _check_smem(name: str, need: int, shape: str) -> None:
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"{name}: {shape} needs {need} bytes of shared memory for one "
            f"block of 128 rows, above the {MAX_SMEM_BYTES} an H100 block "
            f"may hold")


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


# -- K4: one CIN layer over rows ---------------------------------------------

def cin2d_reference(
    x0v: torch.Tensor, xv: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """Plain ``out[r, m] = sum_{f,g} x0v[r,f] xv[r,g] w[f,g,m]``."""
    t = torch.einsum("rg,fgm->rfm", xv, w)
    return torch.einsum("rf,rfm->rm", x0v, t)


def cin2d_reference_bf16(
    x0v: torch.Tensor, xv: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """The function K4's forward computes on the card, as the TPU kernel
    computes it (``deep_recommenders_tpu/ops/cin_kernels.py:94-105``):

        out[r, m] = sum_{f,g} bf16(bf16(x0v[r,f]) bf16(xv[r,g])) bf16(w[f,g,m])

    Every rounding is to nearest even; each product with w is exact in fp32
    and the sums are in fp32. On the card its fp32 products must run
    without TF32 (``torch.backends.cuda.matmul.allow_tf32`` False, the
    default, which ``device.resolve_device`` sets).
    """
    xb = xv.bfloat16()
    out = torch.zeros(xv.shape[0], w.shape[2], dtype=torch.float32,
                      device=xv.device)
    for f in range(w.shape[0]):
        pair = (x0v[:, f:f + 1].bfloat16() * xb).float()
        out += pair @ w[f].bfloat16().float()
    return out


def cin2d_backward_reference(
    x0v: torch.Tensor, xv: torch.Tensor, w: torch.Tensor, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain gradients (dx0, dx, dW) of :func:`cin2d_reference` for the
    output gradient ``g`` (R, M)."""
    r = x0v.shape[0]
    t = torch.einsum("rg,fgm->rfm", xv, w)
    dx0 = torch.einsum("rm,rfm->rf", g, t)
    dx = torch.einsum("rfm,fgm->rg", x0v[:, :, None] * g[:, None, :], w)
    pair = (x0v[:, :, None] * xv[:, None, :]).reshape(r, -1)
    dw = (pair.T @ g).reshape(w.shape)
    return dx0, dx, dw


def cin2d_backward_reference_bf16(
    x0v: torch.Tensor, xv: torch.Tensor, w: torch.Tensor, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients K4's backward computes on the card, as the TPU kernel
    computes them (``deep_recommenders_tpu/ops/cin_kernels.py:145-177``):

        t_f   = bf16(g) bf16(W[f])^T                  (exact products)
        dx    = sum_f x0v[:, f] t_f
        dx0[:, f] = sum_h xv[:, h] t_f[:, h]          (fp32 x0v and xv)
        dW[f] = sum_r bf16(bf16(x0v[r, f]) bf16(xv[r, :]))^T bf16(g[r, :])

    Every sum is in fp32; on the card the fp32 products must run without
    TF32, as for :func:`cin2d_reference_bf16`.
    """
    gb = g.bfloat16().float()
    xb = xv.bfloat16()
    dx = torch.zeros_like(xv)
    dx0 = torch.empty_like(x0v)
    dw = torch.empty_like(w)
    for f in range(w.shape[0]):
        t = gb @ w[f].bfloat16().float().T
        dx += x0v[:, f:f + 1] * t
        dx0[:, f] = (xv * t).sum(dim=1)
        dw[f] = (x0v[:, f:f + 1].bfloat16() * xb).float().T @ gb
    return dx0, dx, dw


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: inputs on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _check_tensor(name: str, what: str, t: torch.Tensor, dtype,
                  shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise TypeError(
            f"{name}: {what} must be {tuple(shape)} {dtype}, got "
            f"{tuple(t.shape)} {t.dtype}"
        )


def _cin2d_shapes(name, x0v, xv, w):
    if x0v.dim() != 2 or xv.dim() != 2 or w.dim() != 3:
        raise TypeError(
            f"{name}: expected x0v (R, F0), xv (R, H), w (F0, H, M), got "
            f"{tuple(x0v.shape)}, {tuple(xv.shape)}, {tuple(w.shape)}"
        )
    r, f0 = x0v.shape
    h, m = xv.shape[1], w.shape[2]
    _check_tensor(name, "x0v", x0v, torch.float32, (r, f0))
    _check_tensor(name, "xv", xv, torch.float32, (r, h))
    _check_tensor(name, "w", w, torch.float32, (f0, h, m))
    if r >= 2**36 or f0 * h * m >= 2**31 or min(f0, h, m) == 0:
        raise ValueError(
            f"{name}: unsupported shape R={r} F0={f0} H={h} M={m}")
    return r, f0, h, m


def _cin2d_fwd_cuda(x0v: torch.Tensor, xv: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    # The CUDA implementation of the op cin2d_fwd: the checks, the padded
    # bf16 W and the launch.
    _check_cuda("cin2d", x0v, xv, w)
    r, f0, h, m = _cin2d_shapes("cin2d", x0v, xv, w)
    out = torch.empty((r, m), dtype=torch.float32, device=x0v.device)
    if r == 0:
        return out
    hp, mp = _round_up(h, 16), _round_up(m, 128)
    wt = torch.zeros((f0, mp, hp), dtype=torch.bfloat16, device=w.device)
    wt[:, :m, :h] = w.transpose(1, 2)
    fn = _build.function("cin2d", "cin2d_fwd_bf16",
                         [_P, _P, _P, _P, _I64, _I32, _I32, _I32, _P])
    code = fn(x0v.data_ptr(), xv.data_ptr(), wt.data_ptr(), out.data_ptr(),
              r, f0, h, m, torch.cuda.current_stream(x0v.device).cuda_stream)
    _build.check(code, "cin2d forward")
    cin2d.launches["fwd"] += 1
    return out


def _cin2d_fwd_fake(x0v, xv, w):
    return x0v.new_empty((x0v.shape[0], w.shape[2]), dtype=torch.float32)


_cin2d_fwd_op = custom_ops.kernel_op(
    "cin2d_fwd", "(Tensor x0v, Tensor xv, Tensor w) -> Tensor",
    _cin2d_fwd_cuda, cin2d_reference, _cin2d_fwd_fake)


def cin2d_forward(
    x0v: torch.Tensor, xv: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """K4 forward: x0v (R, F0), xv (R, H), w (F0, H, M) f32 -> (R, M) f32,
    through the op ``deep_recommenders_torch::cin2d_fwd``
    (``ops/custom_ops.py``), which ``torch.export`` records.

    On the card it computes :func:`cin2d_reference_bf16` on the tensor
    cores; W goes to the kernel as bf16 (F0, Mp, Hp), transposed and
    zero-padded to the kernel's tiles (Hp a multiple of 16, Mp of 128). On
    a CPU tensor it is :func:`cin2d_reference`.
    """
    return _cin2d_fwd_op(x0v, xv, w)


def cin2d_backward(
    x0v: torch.Tensor, xv: torch.Tensor, w: torch.Tensor, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 backward: (dx0, dx, dW) for the output gradient g (R, M) f32.

    On the card it computes :func:`cin2d_backward_reference_bf16` on the
    tensor cores; W goes to the kernel as bf16 (F0, Hp, Mp), zero-padded to
    its tiles (Hp 16 for H <= 16, else a multiple of 128; Mp = M rounded up
    to 16). dW is summed over row chunks (:func:`weight_pass_plan`), added
    in a fixed order. A block of the data kernel holds 128 rows of bf16 g,
    so the card takes 256 Mp + 1024 F0 <= 89088 for H > 16 (F0 <= 55 at
    M = 128, M <= 320 at F0 = 6) and <= 208384 for H <= 16; it raises
    ValueError on larger shapes.
    """
    if x0v.device.type == "cpu":
        return cin2d_backward_reference(x0v, xv, w, g)
    _check_cuda("cin2d backward", x0v, xv, w, g)
    r, f0, h, m = _cin2d_shapes("cin2d backward", x0v, xv, w)
    _check_tensor("cin2d backward", "g", g, torch.float32, (r, m))
    dev = x0v.device
    dx0 = torch.empty((r, f0), dtype=torch.float32, device=dev)
    dx = torch.empty((r, h), dtype=torch.float32, device=dev)
    if r == 0:
        return dx0, dx, torch.zeros_like(w)
    hp = 16 if h <= 16 else _round_up(h, 128)
    mp = _round_up(m, 16)
    smem = _build.function("cin2d", "cin2d_bwd_bf16_smem", [_I32] * 3,
                           restype=_I64)
    _check_smem("cin2d backward", smem(f0, h, mp), f"F0={f0} H={h} M={m}")
    dw = torch.empty_like(w)
    wb = torch.zeros((f0, hp, mp), dtype=torch.bfloat16, device=dev)
    wb[:, :h, :m] = w
    # Scratch: bf16 copies of x and g (the weight pass's operands, x's
    # columns padded to a multiple of 8) and the weight chunks' sums.
    xs = _round_up(h, 8)
    xb = torch.empty((r, xs), dtype=torch.bfloat16, device=dev)
    gb = torch.empty((r, mp), dtype=torch.bfloat16, device=dev)
    tile, chunk = weight_pass_plan(f0 * xs)
    part = torch.empty(-(-r // chunk) * f0 * xs * m, dtype=torch.float32,
                       device=dev)
    fn = _build.function("cin2d", "cin2d_bwd_bf16",
                         [_P] * 10 + [_I64] + [_I32] * 8 + [_P])
    code = fn(x0v.data_ptr(), xv.data_ptr(), wb.data_ptr(), g.data_ptr(),
              dx0.data_ptr(), dx.data_ptr(), dw.data_ptr(), part.data_ptr(),
              xb.data_ptr(), gb.data_ptr(), r, f0, h, m, hp, mp, xs, tile,
              chunk, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "cin2d backward")
    cin2d.launches["bwd"] += 1
    return dx0, dx, dw


class _Cin2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0v, xv, w):
        ctx.save_for_backward(x0v, xv, w)
        return cin2d_forward(x0v, xv, w)

    @staticmethod
    def backward(ctx, g):
        x0v, xv, w = ctx.saved_tensors
        return cin2d_backward(x0v, xv, w, g.contiguous())


def cin2d(
    x0v: torch.Tensor, xv: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """Fused CIN layer over flattened rows (K4), differentiable.

    x0v: (R, F0) f32; xv: (R, H) f32; w: (F0, H, M) f32 -> (R, M) f32.
    """
    return _Cin2d.apply(x0v, xv, w)


cin2d.launches = {"fwd": 0, "bwd": 0}


def cin_interaction_fused(
    x0: torch.Tensor, x: torch.Tensor, kernel: torch.Tensor
) -> torch.Tensor:
    """Drop-in for ``ops.cin.cin_interaction`` over :func:`cin2d`.

    x0: (B, F0, D); x: (B, F, D); kernel: (F0, F, M) -> (B, M, D).
    """
    b, f0, d = x0.shape
    h = x.shape[1]
    x0v = x0.transpose(1, 2).reshape(b * d, f0).contiguous()
    xv = x.transpose(1, 2).reshape(b * d, h).contiguous()
    out = cin2d(x0v, xv, kernel)  # (B*D, M)
    return out.reshape(b, d, -1).transpose(1, 2)


# -- K3: the fused 2-layer relu stack with per-example pooling ---------------

def _layer(x0: torch.Tensor, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # One fp32 CIN layer as a single matmul over the (R, F0 * H) pair tensor.
    pair = (x0[:, :, None] * x[:, None, :]).reshape(x0.shape[0], -1)
    return pair @ w.reshape(-1, w.shape[2])


def stack_forward_reference(
    x0v: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, d: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain forward of the stack with its residuals: (p1, p2, z1, z2)."""
    x0 = x0v.float()  # accept the bf16 input stream
    z1 = torch.relu(_layer(x0, x0, w1))
    z2 = torch.relu(_layer(x0, z1, w2))
    p1 = z1.reshape(-1, d, z1.shape[1]).sum(dim=1)
    p2 = z2.reshape(-1, d, z2.shape[1]).sum(dim=1)
    return p1, p2, z1, z2


def _stack_forward_bf16(x0v, w1, w2, d, round_z1=True):
    # stack_forward_reference_bf16; without round_z1, layer 2 reads the
    # fp32 z1 (a planted fault of ops/cin_tolerances.py).
    x0b = x0v.bfloat16()
    x0 = x0b.float()
    r, f0 = x0.shape
    m1 = w1.shape[2]
    pair = (x0b[:, :, None] * x0b[:, None, :]).float().reshape(r, -1)
    z1 = torch.relu(pair @ w1.bfloat16().float().reshape(f0 * f0, m1))
    z1b = z1.bfloat16()
    z1x = z1b.float() if round_z1 else z1
    z2 = torch.zeros((r, w2.shape[2]), dtype=torch.float32, device=x0.device)
    for f in range(f0):
        z2 += (x0[:, f:f + 1] * z1x).bfloat16().float() @ (
            w2[f].bfloat16().float())
    z2 = torch.relu(z2)
    p1 = z1.reshape(-1, d, m1).sum(dim=1)
    p2 = z2.reshape(-1, d, z2.shape[1]).sum(dim=1)
    return p1, p2, z1b, z2.bfloat16()


def stack_forward_reference_bf16(
    x0v: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, d: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward K3 computes on the card, as the TPU kernel computes it
    (``deep_recommenders_tpu/ops/cin_kernels.py:349-380``): (p1, p2, z1b,
    z2b), with x0b = bf16(x0v):

        z1  = relu(sum_{f,g} bf16(x0b[:, f] x0b[:, g]) bf16(W1[f, g]))
        p1  = sum of z1 over each example's d rows,  z1b = bf16(z1)
        z2  = relu(sum_f bf16(x0b[:, f] z1b) bf16(W2[f]))
        p2  = sum of z2 over each example's d rows,  z2b = bf16(z2)

    Every product of rounded operands is exact in fp32 and every sum is in
    fp32; p1 and p2 pool the fp32 z1 and z2. On the card the fp32 products
    must run without TF32.
    """
    return _stack_forward_bf16(x0v, w1, w2, d)


def stack_reference(
    x0v: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, d: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain semantics of :func:`cin_stack_pooled`: (p1, p2)."""
    p1, p2, _, _ = stack_forward_reference(x0v, w1, w2, d)
    return p1, p2


def stack_backward_reference(
    x0v: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    z1: torch.Tensor,
    z2: torch.Tensor,
    gp1: torch.Tensor,
    gp2: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward of the stack from its saved residuals.

    z1 (R, M1) and z2 (R, M2) are the relu'd layer outputs of the forward;
    gp1 (B, M1) and gp2 (B, M2) the gradients of the pooled outputs.
    Computes in the weights' dtype (fp32; fp64 for an exact reference),
    from residuals of any float dtype, and returns dx0 in x0v's dtype. The
    relu gradient at exactly 0 is 0.
    """
    x0 = x0v.to(w1.dtype)
    z1, z2 = z1.to(w1.dtype), z2.to(w1.dtype)
    r, f0 = x0.shape
    d = r // gp1.shape[0]
    m1 = w1.shape[2]
    g2 = torch.where(z2 > 0, gp2.repeat_interleave(d, dim=0), 0.0)
    # Layer 2: t[r, f, g] = sum_m g2[r, m] W2[f, g, m].
    t = torch.einsum("rm,fgm->rfg", g2, w2)
    dz1 = torch.einsum("rf,rfg->rg", x0, t)
    dx0 = torch.einsum("rg,rfg->rf", z1, t)
    dw2 = ((x0[:, :, None] * z1[:, None, :]).reshape(r, -1).T @ g2).reshape(
        w2.shape
    )
    # Layer 1 over the symmetric pair tensor x0[f] * x0[g].
    g1 = torch.where(z1 > 0, dz1 + gp1.repeat_interleave(d, dim=0), 0.0)
    dy = (g1 @ w1.reshape(f0 * f0, m1).T).reshape(r, f0, f0)
    dx0 = dx0 + torch.einsum("rag,rg->ra", dy + dy.transpose(1, 2), x0)
    dw1 = ((x0[:, :, None] * x0[:, None, :]).reshape(r, -1).T @ g1).reshape(
        w1.shape
    )
    return dx0.to(x0v.dtype), dw1, dw2


def stack_backward_reference_bf16(
    x0v: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    z1: torch.Tensor,
    z2: torch.Tensor,
    gp1: torch.Tensor,
    gp2: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward K3 computes on the card, as the TPU kernel computes it
    (``deep_recommenders_tpu/ops/cin_kernels.py:470-560``), from the same
    arguments as :func:`stack_backward_reference`; x0b = bf16(x0v):

        z1b = bf16(z1),  g2b = bf16(gp2 broadcast, masked by z2 > 0)
        t_f = g2b bf16(W2[f])^T,  dz1 = sum_f x0b[:, f] t_f
        dx0_2[:, f] = sum_m bf16(z1b bf16(t_f))
        dW2[f] = sum_r bf16(x0b[r, f] z1b[r, :])^T g2b[r, :]
        g1b = bf16((dz1 + gp1 broadcast), masked by z1b != 0)
        dW1[f, g] = sum_r bf16(x0b[r, f] x0b[r, g]) g1b[r, :]
        dy = g1b bf16(W1)^T,  a (F0, F0) block per row
        dx0_1[:, a] = sum_g bf16(bf16(dy[a, g] + bf16(dy[g, a])) x0b[g])
        dx0 = bf16(dx0_1 + dx0_2)

    Every sum is in fp32. The swapped term of dy is rounded and the other
    is not, as the TPU kernel's permutation matmul does. On the card the
    fp32 products must run without TF32.
    """
    x0b = x0v.bfloat16()
    x0 = x0b.float()
    r, f0 = x0.shape
    d = r // gp1.shape[0]
    m1 = w1.shape[2]
    z1b = z1.bfloat16()
    g2 = torch.where(z2 > 0, gp2.repeat_interleave(d, dim=0), 0.0)
    g2 = g2.bfloat16().float()
    dz1 = torch.zeros((r, m1), dtype=torch.float32, device=x0.device)
    dx0_2 = torch.empty_like(x0)
    dw2 = torch.empty_like(w2)
    for f in range(f0):
        t = g2 @ w2[f].bfloat16().float().T
        dz1 += x0[:, f:f + 1] * t
        dx0_2[:, f] = (z1b * t.bfloat16()).float().sum(dim=1)
        dw2[f] = (x0b[:, f:f + 1] * z1b).float().T @ g2
    g1 = torch.where(z1b != 0, dz1 + gp1.repeat_interleave(d, dim=0), 0.0)
    g1 = g1.bfloat16().float()
    pair = (x0b[:, :, None] * x0b[:, None, :]).float().reshape(r, -1)
    dw1 = (pair.T @ g1).reshape(w1.shape)
    dy = (g1 @ w1.bfloat16().float().reshape(f0 * f0, m1).T).reshape(
        r, f0, f0)
    sym = (dy + dy.transpose(1, 2).bfloat16().float()).bfloat16()
    dx0_1 = (sym * x0b[:, None, :]).float().sum(dim=2)
    return (dx0_1 + dx0_2).bfloat16(), dw1, dw2


def _stack_shapes(name, x0v, w1, w2):
    if x0v.dim() != 2 or w1.dim() != 3 or w2.dim() != 3:
        raise TypeError(
            f"{name}: expected x0v (R, F0), w1 (F0, F0, M1), w2 (F0, M1, M2), "
            f"got {tuple(x0v.shape)}, {tuple(w1.shape)}, {tuple(w2.shape)}"
        )
    r, f0 = x0v.shape
    m1, m2 = w1.shape[2], w2.shape[2]
    _check_tensor(name, "x0v", x0v, torch.bfloat16, (r, f0))
    _check_tensor(name, "w1", w1, torch.float32, (f0, f0, m1))
    _check_tensor(name, "w2", w2, torch.float32, (f0, m1, m2))
    if r >= 2**36 or f0 * m1 * m2 >= 2**31 or min(f0, m1, m2) == 0:
        raise ValueError(f"{name}: unsupported shape R={r} F0={f0} "
                         f"M1={m1} M2={m2}")
    return r, f0, m1, m2


def _stack_fwd_cuda(x0v, w1, w2, d, residuals):
    # The CUDA implementation of the ops cin_stack_fwd (with residuals) and
    # cin_stack_fwd_pooled (without): the checks, the padded bf16 W tiles
    # and the launch.
    name = "cin_stack_pooled"
    _check_cuda(name, x0v, w1, w2)
    r, f0, m1, m2 = _stack_shapes(name, x0v, w1, w2)
    if r % d:
        raise ValueError(f"{name}: R={r} is not a multiple of d={d}")
    smem = _build.function("cin_stack", "cin_stack_fwd_smem", [_I32] * 3,
                           restype=_I64)
    _check_smem(name, smem(f0, m1, 1), f"F0={f0} M1={m1}")
    dev = x0v.device
    p1 = torch.zeros((r // d, m1), dtype=torch.float32, device=dev)
    p2 = torch.zeros((r // d, m2), dtype=torch.float32, device=dev)
    z1 = z2 = None
    if residuals:
        z1 = torch.empty((r, m1), dtype=torch.bfloat16, device=dev)
        z2 = torch.empty((r, m2), dtype=torch.bfloat16, device=dev)
    if r == 0:
        return p1, p2, z1, z2
    k1p, k2p = _round_up(f0 * f0, 16), _round_up(m1, 16)
    w1t = torch.zeros((_round_up(m1, 128), k1p), dtype=torch.bfloat16,
                      device=dev)
    w1t[:m1, :f0 * f0] = w1.reshape(f0 * f0, m1).T
    w2t = torch.zeros((f0, _round_up(m2, 128), k2p), dtype=torch.bfloat16,
                      device=dev)
    w2t[:, :m2, :m1] = w2.transpose(1, 2)
    fn = _build.function("cin_stack", "cin_stack_fwd",
                         [_P] * 7 + [_I64, _I32, _I32, _I32, _I32, _P])
    code = fn(x0v.data_ptr(), w1t.data_ptr(), w2t.data_ptr(), p1.data_ptr(),
              p2.data_ptr(), z1.data_ptr() if residuals else None,
              z2.data_ptr() if residuals else None, r, f0, m1, m2, d,
              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "cin_stack_pooled forward")
    cin_stack_pooled.launches["fwd"] += 1
    return p1, p2, z1, z2


def _stack_fwd_fake(x0v, w1, w2, d, residuals):
    b = x0v.shape[0] // d
    p1 = x0v.new_empty((b, w1.shape[2]), dtype=torch.float32)
    p2 = x0v.new_empty((b, w2.shape[2]), dtype=torch.float32)
    if not residuals:
        return p1, p2
    # bf16 residuals on the card, fp32 from the plain version on the CPU.
    z = torch.bfloat16 if x0v.device.type == "cuda" else torch.float32
    return (p1, p2, x0v.new_empty((x0v.shape[0], w1.shape[2]), dtype=z),
            x0v.new_empty((x0v.shape[0], w2.shape[2]), dtype=z))


_STACK_ARGS = "(Tensor x0v, Tensor w1, Tensor w2, int d)"
_stack_fwd_op = custom_ops.kernel_op(
    "cin_stack_fwd", _STACK_ARGS + " -> (Tensor, Tensor, Tensor, Tensor)",
    lambda x0v, w1, w2, d: _stack_fwd_cuda(x0v, w1, w2, d, True),
    stack_forward_reference,
    lambda x0v, w1, w2, d: _stack_fwd_fake(x0v, w1, w2, d, True))
_stack_fwd_pooled_op = custom_ops.kernel_op(
    "cin_stack_fwd_pooled", _STACK_ARGS + " -> (Tensor, Tensor)",
    lambda x0v, w1, w2, d: _stack_fwd_cuda(x0v, w1, w2, d, False)[:2],
    lambda x0v, w1, w2, d: stack_forward_reference(x0v, w1, w2, d)[:2],
    lambda x0v, w1, w2, d: _stack_fwd_fake(x0v, w1, w2, d, False))


def stack_forward(
    x0v: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    d: int,
    residuals: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor,
           Optional[torch.Tensor], Optional[torch.Tensor]]:
    """K3 forward: (p1, p2, z1, z2); z1 and z2 are None without residuals.

    It calls the op ``deep_recommenders_torch::cin_stack_fwd``, or without
    residuals ``cin_stack_fwd_pooled``, which writes none
    (``ops/custom_ops.py``); ``torch.export`` records either.
    x0v: (R, F0) bf16 rows r = b * d + j; w1 (F0, F0, M1), w2 (F0, M1, M2)
    f32. R must be a multiple of d. On the card it computes
    :func:`stack_forward_reference_bf16` on the tensor cores and returns
    z1 and z2 in bf16; W1 goes to the kernel as bf16 (N1p, K1p), W1[f, g, c]
    at [c, f * F0 + g], and W2 as bf16 (F0, M2p, K2p), W2[f, g, c] at
    [f, c, g], zero-padded (K1p = F0^2 and K2p = M1 rounded up to 16, N1p
    and M2p = M1 and M2 rounded up to 128). A block holds 128 rows of x0,
    their pair tensor and bf16 z1, so the card takes
    512 F0 + 256 (K1p + K2p + 16) + max(36864, 256 (K1p + 8), 12288)
    <= 232448 bytes (F0 <= 18 at M1 = 128, M1 <= 688 at F0 = 6); it raises
    ValueError on larger shapes. On a CPU tensor it takes the fp32
    :func:`stack_forward_reference`, with fp32 residuals.
    """
    if x0v.shape[0] % d:
        raise ValueError(f"cin_stack_pooled: R={x0v.shape[0]} is not a "
                         f"multiple of d={d}")
    if residuals:
        return tuple(_stack_fwd_op(x0v, w1, w2, d))
    p1, p2 = _stack_fwd_pooled_op(x0v, w1, w2, d)
    return p1, p2, None, None


def stack_backward(
    x0v: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    z1: torch.Tensor,
    z2: torch.Tensor,
    gp1: torch.Tensor,
    gp2: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 backward from the saved residuals: (dx0 bf16, dW1, dW2).

    On the card it computes :func:`stack_backward_reference_bf16` on the
    tensor cores from the forward's bf16 residuals z1, z2; W1 and W2 go to the kernel as bf16, zero-padded to its
    tiles. dW1 and dW2 are summed over row chunks
    (:func:`weight_pass_plan`), added in a fixed order. A block of the data
    kernel holds 128 rows of bf16 g2, z1 and g1, so the card takes
    256 (K2p + 2 K1p) + 1024 F0 <= 154624, with K1p, K2p = M1, M2 rounded
    up to 16 (F0 <= 55 at M1 = M2 = 128); it raises ValueError on larger
    shapes.
    """
    if x0v.device.type == "cpu":
        return stack_backward_reference(x0v, w1, w2, z1, z2, gp1, gp2)
    name = "cin_stack_pooled backward"
    _check_cuda(name, x0v, w1, w2, z1, z2, gp1, gp2)
    r, f0, m1, m2 = _stack_shapes(name, x0v, w1, w2)
    b = gp1.shape[0] if gp1.dim() == 2 else -1
    if b <= 0 or r % b:
        raise TypeError(f"{name}: gp1 {tuple(gp1.shape)} does not pool "
                        f"{r} rows")
    _check_tensor(name, "z1", z1, torch.bfloat16, (r, m1))
    _check_tensor(name, "z2", z2, torch.bfloat16, (r, m2))
    _check_tensor(name, "gp1", gp1, torch.float32, (b, m1))
    _check_tensor(name, "gp2", gp2, torch.float32, (b, m2))
    dev = x0v.device
    dx0 = torch.empty((r, f0), dtype=torch.bfloat16, device=dev)
    if r == 0:
        return dx0, torch.zeros_like(w1), torch.zeros_like(w2)
    nyp, n1p = _round_up(f0 * f0, 64), _round_up(m1, 128)
    k1p, k2p = _round_up(m1, 16), _round_up(m2, 16)
    smem = _build.function("cin_stack", "cin_stack_bwd_smem", [_I32] * 3,
                           restype=_I64)
    _check_smem(name, smem(f0, k1p, k2p), f"F0={f0} M1={m1} M2={m2}")
    dw1, dw2 = torch.empty_like(w1), torch.empty_like(w2)
    w1b = torch.zeros((nyp, k1p), dtype=torch.bfloat16, device=dev)
    w1b[:f0 * f0, :m1] = w1.reshape(f0 * f0, m1)
    w2b = torch.zeros((f0, n1p, k2p), dtype=torch.bfloat16, device=dev)
    w2b[:, :m1, :m2] = w2
    # Scratch: the weight products' bf16 operands (the rounded row
    # gradients of both layers, z1b and x0, columns padded to multiples of
    # 8), layer 1's dy, and the weight chunks' sums.
    x0w = _round_up(f0, 8)
    g1 = torch.empty((r, k1p), dtype=torch.bfloat16, device=dev)
    z1b = torch.empty((r, k1p), dtype=torch.bfloat16, device=dev)
    g2 = torch.empty((r, k2p), dtype=torch.bfloat16, device=dev)
    x0p = torch.empty((r, x0w), dtype=torch.bfloat16, device=dev)
    dy = torch.empty((r, f0 * f0), dtype=torch.float32, device=dev)
    tile1, chunk1 = weight_pass_plan(f0 * x0w)
    tile2, chunk2 = weight_pass_plan(f0 * k1p)
    part = torch.empty(max(-(-r // chunk1) * f0 * x0w * m1,
                           -(-r // chunk2) * f0 * k1p * m2),
                       dtype=torch.float32, device=dev)
    fn = _build.function("cin_stack", "cin_stack_bwd",
                         [_P] * 16 + [_I64] + [_I32] * 13 + [_P])
    code = fn(x0v.data_ptr(), w1b.data_ptr(), w2b.data_ptr(), z1.data_ptr(),
              z2.data_ptr(), gp1.data_ptr(), gp2.data_ptr(), dx0.data_ptr(),
              dw1.data_ptr(), dw2.data_ptr(), g1.data_ptr(), g2.data_ptr(),
              z1b.data_ptr(), x0p.data_ptr(), dy.data_ptr(), part.data_ptr(),
              r, f0, m1, m2, r // b, nyp, n1p, k1p, k2p, x0w, tile1, chunk1,
              tile2, chunk2, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, name)
    cin_stack_pooled.launches["bwd"] += 1
    return dx0, dw1, dw2


class _CinStack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0v, w1, w2, d):
        p1, p2, z1, z2 = stack_forward(x0v, w1, w2, d, residuals=True)
        ctx.save_for_backward(x0v, w1, w2, z1, z2)
        return p1, p2

    @staticmethod
    def backward(ctx, gp1, gp2):
        x0v, w1, w2, z1, z2 = ctx.saved_tensors
        dx0, dw1, dw2 = stack_backward(
            x0v, w1, w2, z1, z2, gp1.contiguous(), gp2.contiguous()
        )
        return dx0, dw1, dw2, None


def cin_stack_pooled(
    x0v: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, d: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused relu CIN stack with per-example sum pooling (K3).

    x0v: (R, F0) flattened (example, dim) rows with R = B * d, row
    r = b * d + (embedding dim index), bf16 on the card; w1: (F0, F0, M1);
    w2: (F0, M1, M2). Returns (p1, p2): each relu'd layer output summed over
    the embedding dim, (B, M1) and (B, M2) f32. Without a gradient to take
    (``torch.no_grad()``, or no input that requires one) the forward keeps
    no residuals.
    """
    if torch.is_grad_enabled() and (
        x0v.requires_grad or w1.requires_grad or w2.requires_grad
    ):
        return _CinStack.apply(x0v, w1, w2, d)
    p1, p2, _, _ = stack_forward(x0v, w1, w2, d, residuals=False)
    return p1, p2


cin_stack_pooled.launches = {"fwd": 0, "bwd": 0}
