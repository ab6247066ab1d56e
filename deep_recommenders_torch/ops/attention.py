"""Attention ops: dense SDPA, and blockwise (flash) attention forward (K5)
and backward (K6).

Counterpart of ``deep_recommenders_tpu/ops/attention.py``. Layout is the
JAX package's: heads folded into the batch, q (BH, Sq, D), k and v
(BH, Sk, D), key_mask (BH, Sk) with a value > 0 marking a valid key.

- :func:`scaled_dot_product_attention` is the dense path: fp32 scores,
  masked lanes set to ``NEG_INF``, causal by absolute indices (col <= row),
  rows with no valid key giving weights 0, and inverted dropout on the
  softmax weights drawn from an explicit ``torch.Generator``. As JAX's, it
  rounds the weights to v's dtype before the product with v and returns
  q's dtype.
- :func:`flash_attention` (K5) and :func:`flash_attention_backward` (K6)
  take fp32 or bf16 q, k, v (and g), all of one dtype; the mask and lse are
  fp32. On a CUDA tensor they launch ``csrc/flash_attention.cu`` (fp32) or
  ``csrc/flash_attention_bf16.cu`` (bf16) or raise; on a CPU tensor they
  take their plain versions, :func:`flash_attention_reference` and
  :func:`flash_attention_backward_reference` in fp32, the ``_bf16`` ones in
  bf16. Launches are counted in ``flash_attention.launches``: "fwd" and
  "bwd" for the fp32 kernels, "fwd_bf16" and "bwd_bf16" for the bf16 ones
  (one count per forward call; one per backward call, which runs both of
  K6's kernels). K5 is an op that ``torch.export`` records
  (``ops/custom_ops.py``): ``flash_attention_fwd`` (fp32) and
  ``flash_attention_fwd_bf16``.
- :class:`FlashAttention` is the autograd Function over K5 and K6 (the
  counterpart of ``flash_attention_diff``). JAX's kernels take any head
  width D; the card's are built for ``KERNEL_HEAD_DIMS``. On the card,
  FlashAttention pads q, k, v (and g) with zero columns up to the next
  kernel width (:func:`kernel_head_dim`), passes the true D's scale, and
  slices out, dq, dk and dv back to D: zero columns leave every score, the
  lse and delta = rowsum(g * out) unchanged, and give out's padded columns
  exactly 0.
- :func:`attention` dispatches between the two paths by the JAX package's
  rule, with "the tensor is on the card" in place of "the backend is TPU";
  above the widest kernel width a call over the budget goes dense with a
  warning.

The fp32 path is the JAX kernels' fp32-accurate products
(``attention.py:107-115``): on the card every product runs on the tensor
cores in three TF32 passes over the split operands (3xTF32), within a few
units of fp32 roundoff of the exact product. The bf16 path is the JAX
kernels' bf16 contract (``attention.py:107-149``, ``:312-371``): fp32
scores of bf16 operands, softmax statistics in fp32, p and ds rounded to
bf16 before the products that consume them, fp32 accumulation, and out,
dq, dk, dv returned in bf16.
"""

from __future__ import annotations

import ctypes
import math
import warnings
from typing import Optional, Tuple

import torch

from deep_recommenders_torch.ops import _build, custom_ops

NEG_INF = -1e30

# The dispatch constants of the JAX package (ops/attention.py:528-535): the
# dense path keeps about three score-sized fp32 tensors alive in training
# (the weights saved for backward, their gradient, one live score buffer);
# above this many bytes of them, attention goes blockwise.
FLASH_SCORE_BYTES = 2_000_000_000
DENSE_RESIDENT_SCORE_TENSORS = 3

# Head widths the kernels are built for (template instances in the source).
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
# Operand dtypes of q, k, v and g; the mask and lse are always fp32.
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_F64 = ctypes.c_double


def _valid_lanes(shape, key_mask, causal, device):
    """Boolean (..., Sq, Sk) of lanes that are neither masked keys nor in
    the causal future, or None when every lane is valid."""
    valid = None
    if key_mask is not None:
        valid = key_mask[..., None, :] > 0
    if causal:
        sq, sk = shape[-2], shape[-1]
        rows = torch.arange(sq, device=device)[:, None]
        cols = torch.arange(sk, device=device)[None, :]
        future = cols <= rows
        valid = future if valid is None else valid & future
    return valid


def _softmax_weights(q, k, key_mask, causal, scale=None):
    """Softmax weights of the scaled scores q k^T / sqrt(D) (or q k^T
    ``scale``) over valid lanes (masked lanes set to NEG_INF) and each
    row's log-sum-exp, in the inputs' dtype. A row with no valid key gets
    weights 0, not a uniform average over masked keys, and lse 0."""
    scores = torch.einsum("...qd,...kd->...qk", q, k)
    scores = (scores / math.sqrt(q.shape[-1]) if scale is None
              else scores * scale)
    valid = _valid_lanes(scores.shape, key_mask, causal, scores.device)
    if valid is not None:
        scores = torch.where(valid, scores, NEG_INF)
    any_valid = scores.amax(dim=-1) > NEG_INF / 2
    weights = torch.where(any_valid[..., None], torch.softmax(scores, -1), 0.0)
    lse = torch.where(any_valid, torch.logsumexp(scores, dim=-1), 0.0)
    return weights, lse


def scaled_dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Dense SDPA. q/k/v: (..., S, D); key_mask: (..., Sk) with 1 = valid.

    Dropout (inverted, on the softmax weights) is active only when
    ``dropout_rate > 0`` and a ``generator`` is given, as JAX's is only with
    a ``dropout_rng``.
    """
    weights, _ = _softmax_weights(q.float(), k.float(), key_mask, causal)
    if dropout_rate > 0.0 and generator is not None:
        keep = torch.rand(weights.shape, generator=generator,
                          device=weights.device) < 1.0 - dropout_rate
        weights = torch.where(keep, weights / (1.0 - dropout_rate), 0.0)
    # JAX rounds the weights to v's dtype and accumulates in fp32; the
    # product of two bf16 values is exact in fp32, so the upcast operands
    # give the same function.
    weights = weights.to(v.dtype).float()
    out = torch.einsum("...qk,...kd->...qd", weights, v.float())
    return out.to(q.dtype)


# -- plain versions of K5 and K6 ---------------------------------------------

def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain (out, lse) of K5: dense SDPA and the per-row log-sum-exp of the
    scaled scores over valid keys; a row with no valid key gives out 0 and
    lse 0. The scores are q k^T / sqrt(D), or q k^T ``scale``. Computes in
    the inputs' dtype (fp32, or fp64 for a check)."""
    weights, lse = _softmax_weights(q, k, key_mask, causal, scale)
    return torch.einsum("...qk,...kd->...qd", weights, v), lse


def backward_terms(q, k, v, key_mask, out, lse, g, causal, scale=None):
    """The dense intermediates of K6's plain version: p = exp(s - lse) with
    masked and causal-future lanes set to 0, dp = g v^T,
    delta = rowsum(g * out) and ds = p (dp - delta) scale, where
    s = q k^T scale and ``scale`` defaults to 1 / sqrt(D)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("...qd,...kd->...qk", q, k) * scale
    p = torch.exp(s - lse[..., None])
    valid = _valid_lanes(s.shape, key_mask, causal, s.device)
    if valid is not None:
        p = torch.where(valid, p, 0.0)
    delta = (g * out).sum(-1)
    dp = torch.einsum("...qd,...kd->...qk", g, v)
    ds = p * (dp - delta[..., None]) * scale
    return p, dp, delta, ds


def flash_attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    out: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain (dq, dk, dv) of K6, from the forward's out and lse, over the
    dense :func:`backward_terms` (``scale`` as there)."""
    p, _, _, ds = backward_terms(q, k, v, key_mask, out, lse, g, causal,
                                 scale)
    dq = torch.einsum("...qk,...kd->...qd", ds, k)
    dk = torch.einsum("...qk,...qd->...kd", ds, q)
    dv = torch.einsum("...qk,...qd->...kd", p, g)
    return dq, dk, dv


def flash_attention_reference_bf16(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain (out, lse) of K5 on bf16 q, k, v, as the JAX kernel computes
    them: fp32 scores of the bf16 operands (each product exact in fp32)
    times ``scale`` (default 1 / sqrt(D)), p = exp(s - m) in fp32 and its
    row sum l from the unrounded p, p rounded to bf16 before P V with fp32
    accumulation, out = acc / l rounded to bf16, lse = m + log l in fp32.
    One tile of keys: m is the row's max, where the kernels use the running
    max of the key tiles seen so far (``ops/attention_tolerances.py`` bounds
    the difference)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("...qd,...kd->...qk", qf, kf) * scale
    valid = _valid_lanes(s.shape, key_mask, causal, s.device)
    if valid is not None:
        s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1)
    any_valid = m > NEG_INF / 2
    p = torch.exp(s - m[..., None])
    p = torch.where(s <= NEG_INF / 2, 0.0, p)
    l = p.sum(-1)
    acc = torch.einsum("...qk,...kd->...qd", p.to(torch.bfloat16).float(), vf)
    out = acc / l.clamp_min(1e-30)[..., None]
    lse = torch.where(any_valid, m + torch.log(l.clamp_min(1e-30)), 0.0)
    return out.to(torch.bfloat16), lse


def flash_attention_backward_reference_bf16(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    out: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain (dq, dk, dv) of K6 on bf16 q, k, v, out and g with fp32 lse,
    as the JAX kernels compute them: p rebuilt in fp32, dp = g v^T and
    delta = rowsum(g * out) in fp32 from the upcast bf16 tensors,
    ds = p (dp - delta) scale in fp32 (``scale`` default 1 / sqrt(D)); p
    and ds rounded to bf16 before dv = p^T g, dk = ds^T q and dq = ds k
    (fp32 accumulation); the gradients returned in bf16."""
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, out, g))
    p, _, _, ds = backward_terms(qf, kf, vf, key_mask, of, lse.float(), gf,
                                 causal, scale)
    pb = p.to(torch.bfloat16).float()
    dsb = ds.to(torch.bfloat16).float()
    dq = torch.einsum("...qk,...kd->...qd", dsb, kf)
    dk = torch.einsum("...qk,...qd->...kd", dsb, qf)
    dv = torch.einsum("...qk,...qd->...kd", pb, gf)
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


# -- K5 and K6 ---------------------------------------------------------------

def _operand_dtype(name, q, k, v, *rest):
    """The one dtype of q, k, v and the rest of the operands (out, g):
    fp32 or bf16."""
    dtype = q.dtype
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: q, k, v must be float32 or bfloat16, got "
                        f"{dtype}")
    for t in (k, v, *rest):
        if t.dtype != dtype:
            raise TypeError(f"{name}: operands must share q's dtype {dtype}, "
                            f"got {t.dtype}")
    return dtype


def _check_inputs(name, q, k, v, key_mask, operands=(), stats=()):
    """Device, dtype, layout and shape checks of a kernel launch. q, k, v
    and ``operands`` (out, g) share one dtype of ``KERNEL_DTYPES``; the mask
    and ``stats`` (lse) are fp32; the operands are 16-byte aligned (the
    kernels copy them in 16-byte pieces)."""
    dtype = _operand_dtype(name, q, k, v, *operands)
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    for t in (q, k, v, key_mask, *operands, *stats):
        if t.device != device:
            raise ValueError(f"{name}: inputs on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v, *operands)):
        raise ValueError(f"{name}: operands must be 16-byte aligned")
    for t in (key_mask, *stats):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the mask and lse must be float32, got "
                            f"{t.dtype}")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise TypeError(
            f"{name}: expected q (BH, Sq, D), k and v (BH, Sk, D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if k.shape[0] != bh or k.shape[2] != d:
        raise TypeError(f"{name}: q {tuple(q.shape)} and k {tuple(k.shape)} "
                        f"disagree")
    if tuple(key_mask.shape) != (bh, sk):
        raise TypeError(f"{name}: key_mask must be {(bh, sk)}, got "
                        f"{tuple(key_mask.shape)}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head width D={d} is not one of "
                         f"{KERNEL_HEAD_DIMS}")
    if bh >= 2**31 or max(sq, sk) * d >= 2**31 or \
            bh * max(sq, sk) * d >= 2**40:
        raise ValueError(f"{name}: unsupported shape BH={bh} Sq={sq} Sk={sk}")
    return bh, sq, sk, d


def _mask_or_ones(key_mask, k):
    if key_mask is None:
        return torch.ones(k.shape[:2], dtype=torch.float32, device=k.device)
    return key_mask.to(torch.float32)


# (source, forward symbol, backward symbol, launch-count suffix) by dtype.
_KERNELS = {
    torch.float32: ("flash_attention", "flash_attention_fwd_f32",
                    "flash_attention_bwd_f32", ""),
    torch.bfloat16: ("flash_attention_bf16", "flash_attention_fwd_bf16",
                     "flash_attention_bwd_bf16", "_bf16"),
}


def _scale_arg(scale: Optional[float], d: int) -> float:
    """The softmax scale a kernel is given: ``scale``, or 1 / sqrt(D)."""
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def _flash_fwd_cuda(q, k, v, key_mask, causal, scale):
    # The CUDA implementation of the ops flash_attention_fwd and
    # flash_attention_fwd_bf16: the checks (the alignment check reads the
    # data pointers) and the launch.
    bh, sq, sk, d = _check_inputs("flash_attention", q, k, v, key_mask)
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    if bh and sq:
        source, symbol, _, suffix = _KERNELS[q.dtype]
        fn = _build.function(source, symbol,
                             [_P] * 6 + [_I32] * 5 + [_F64, _P])
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  key_mask.data_ptr(), out.data_ptr(), lse.data_ptr(),
                  bh, sq, sk, d, int(causal), _scale_arg(scale, d),
                  torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(code, "flash_attention forward")
        flash_attention.launches["fwd" + suffix] += 1
    return out, lse


def _flash_fwd_fake(q, k, v, key_mask, causal, scale):
    return (torch.empty_like(q),
            q.new_empty(q.shape[:2], dtype=torch.float32))


# The op of each operand dtype, registered in ops/custom_ops.py's namespace.
_FLASH_FWD_OPS = {
    dtype: custom_ops.kernel_op(
        "flash_attention_fwd" + _KERNELS[dtype][3],
        "(Tensor q, Tensor k, Tensor v, Tensor key_mask, bool causal, "
        "float? scale) -> (Tensor, Tensor)",
        _flash_fwd_cuda, plain, _flash_fwd_fake)
    for dtype, plain in ((torch.float32, flash_attention_reference),
                         (torch.bfloat16, flash_attention_reference_bf16))
}


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    return_lse: bool = False,
    scale: Optional[float] = None,
):
    """K5, blockwise attention forward. q (BH, Sq, D), k and v (BH, Sk, D),
    all fp32 or all bf16; key_mask (BH, Sk), > 0 = valid (None = all
    valid); the scores are q k^T ``scale``, by default D ** -0.5. Returns
    out (BH, Sq, D) in q's dtype, and with ``return_lse`` also lse (BH, Sq)
    fp32. It calls the op ``deep_recommenders_torch::flash_attention_fwd``
    (fp32) or ``flash_attention_fwd_bf16`` (``ops/custom_ops.py``), which
    ``torch.export`` records: on the card the kernel, where D must be one
    of ``KERNEL_HEAD_DIMS``; on the CPU the plain version."""
    dtype = _operand_dtype("flash_attention", q, k, v)
    key_mask = _mask_or_ones(key_mask, k)
    out, lse = _FLASH_FWD_OPS[dtype](q, k, v, key_mask, causal, scale)
    return (out, lse) if return_lse else out


flash_attention.launches = {"fwd": 0, "bwd": 0, "fwd_bf16": 0, "bwd_bf16": 0}


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor],
    out: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6, blockwise attention backward: (dq, dk, dv) in q's dtype for the
    output gradient g, from the forward's out and lse (computed with the
    same ``scale``, by default D ** -0.5). q, k, v, out and g share one
    dtype (fp32 or bf16); lse is fp32. delta = rowsum(g * out) in fp32 is
    a plain torch reduction in fp32, as JAX leaves it to XLA; the bf16 dq
    kernel forms it from its own rows."""
    name = "flash_attention backward"
    dtype = _operand_dtype(name, q, k, v, out, g)
    key_mask = _mask_or_ones(key_mask, k)
    if q.device.type == "cpu":
        plain = (flash_attention_backward_reference_bf16
                 if dtype == torch.bfloat16
                 else flash_attention_backward_reference)
        return plain(q, k, v, key_mask, out, lse, g, causal, scale)
    bh, sq, sk, d = _check_inputs(name, q, k, v, key_mask, (out, g), (lse,))
    if out.shape != q.shape or g.shape != q.shape or \
            tuple(lse.shape) != (bh, sq):
        raise TypeError(f"{name}: out, g must be {tuple(q.shape)} and lse "
                        f"{(bh, sq)}")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if bh and sk and sq:
        source, _, symbol, suffix = _KERNELS[dtype]
        stream = torch.cuda.current_stream(q.device).cuda_stream
        scale = _scale_arg(scale, d)
        if dtype == torch.bfloat16:
            # The dq kernel forms delta itself, into this scratch.
            delta = torch.empty((bh, sq), dtype=torch.float32,
                                device=q.device)
            fn = _build.function(source, symbol,
                                 [_P] * 11 + [_I32] * 5 + [_F64, _P])
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      key_mask.data_ptr(), lse.data_ptr(), out.data_ptr(),
                      g.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                      dk.data_ptr(), dv.data_ptr(), bh, sq, sk, d,
                      int(causal), scale, stream)
        else:
            delta = (g * out).sum(-1)
            fn = _build.function(source, symbol,
                                 [_P] * 10 + [_I32] * 5 + [_F64, _P])
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      key_mask.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                      g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                      dv.data_ptr(), bh, sq, sk, d, int(causal), scale,
                      stream)
        _build.check(code, name)
        flash_attention.launches["bwd" + suffix] += 1
    else:  # no scores: every gradient is 0
        dq.zero_()
        dk.zero_()
        dv.zero_()
    return dq, dk, dv


def kernel_head_dim(d: int) -> Optional[int]:
    """The narrowest of ``KERNEL_HEAD_DIMS`` that holds head width ``d``,
    or None above the widest."""
    return next((w for w in KERNEL_HEAD_DIMS if d <= w), None)


def pad_head_dim(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` (..., D) with zero columns appended up to ``width``."""
    d = t.shape[-1]
    return t if d == width else torch.nn.functional.pad(t, (0, width - d))


def _operand_width(q: torch.Tensor) -> int:
    """The head width FlashAttention hands the kernels: on the card the
    next kernel width (D itself above the widest, which the kernels
    refuse); on the CPU, where the plain versions take any D, D."""
    d = q.shape[-1]
    if q.device.type == "cpu":
        return d
    return kernel_head_dim(d) or d


class FlashAttention(torch.autograd.Function):
    """Differentiable blockwise attention over K5 and K6: ``apply(q, k, v,
    key_mask, causal)`` with fp32 or bf16 q, k, v; the gradients come back
    in their dtype. On the card a head width D that no kernel is built for
    is padded with zero columns to :func:`kernel_head_dim` and run at
    scale D ** -0.5; out, dq, dk and dv are sliced back to D. Saves the
    (padded) q, k, v, the mask, out and lse; no gradient flows to the
    mask."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal):
        d, width = q.shape[-1], _operand_width(q)
        scale = None if width == d else 1.0 / math.sqrt(d)
        q, k, v = (pad_head_dim(t, width) for t in (q, k, v))
        out, lse = flash_attention(q, k, v, key_mask, causal,
                                   return_lse=True, scale=scale)
        ctx.causal, ctx.d, ctx.scale = causal, d, scale
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        return out if width == d else out[..., :d].contiguous()

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        g = pad_head_dim(g.to(q.dtype), q.shape[-1]).contiguous()
        grads = flash_attention_backward(q, k, v, key_mask, out, lse, g,
                                         ctx.causal, ctx.scale)
        if q.shape[-1] != ctx.d:
            grads = [t[..., :ctx.d].contiguous() for t in grads]
        return (*grads, None, None)


def use_flash_for(bh: int, sq: int, sk: int, device_type: str,
                  dropout_active: bool) -> bool:
    """The dispatch rule of ``attention(use_flash=None)``: blockwise on the
    card where the dense path's fwd+bwd score tensors would exceed
    ``FLASH_SCORE_BYTES``, dense otherwise and whenever dropout is active.
    The scores are fp32 whatever the operands' dtype, so the byte count is
    BH Sq Sk 4 for bf16 operands too, as JAX's.

    On the card the rule reads the batch size, so a symbolic one (a
    ``torch.export`` trace with a polymorphic batch) cannot be decided: it
    raises ValueError rather than let the program guard on, or specialise
    to, the traced batch size. On the CPU the rule never reads the
    sizes."""
    if device_type != "cuda" or dropout_active:
        return False
    if not all(isinstance(n, int) for n in (bh, sq, sk)):
        raise ValueError(
            f"attention on the card with symbolic sizes (BH, Sq, Sk) = "
            f"({bh}, {sq}, {sk}): whether it goes to K5 or to the dense path "
            "depends on the batch size, so no one exported program serves "
            "every batch; export with polymorphic_batch=False")
    score_bytes = bh * sq * sk * 4
    return score_bytes * DENSE_RESIDENT_SCORE_TENSORS > FLASH_SCORE_BYTES


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    use_flash: Optional[bool] = None,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Dense SDPA where its score tensors fit the memory budget, the
    blockwise kernels beyond (:func:`use_flash_for`). Layout (BH, S, D).

    Attention-weight dropout exists only in the dense path: the blockwise
    kernels never hold the weight matrix. Nor is there a kernel for a head
    width D above the widest of ``KERNEL_HEAD_DIMS``. A call that the
    budget would send blockwise goes dense with a warning in either case;
    ``use_flash=True`` raises instead of changing the semantics or the
    memory it takes."""
    dropout_active = dropout_rate > 0.0 and generator is not None
    too_wide = kernel_head_dim(q.shape[-1]) is None
    if use_flash is None:
        shape = (q.shape[0], q.shape[1], k.shape[1], q.device.type)
        use_flash = use_flash_for(*shape, dropout_active) and not too_wide
        if (dropout_active or too_wide) and use_flash_for(*shape, False):
            why = ("attention-weight dropout" if dropout_active else
                   f"head width D={q.shape[-1]} (no kernel is wider than "
                   f"{KERNEL_HEAD_DIMS[-1]})")
            warnings.warn(
                f"{why} sends this call to the dense path although its "
                f"score tensors (BH, Sq, Sk) = {shape[:3]} exceed the memory "
                "budget for which the flash kernels exist", stacklevel=2)
    if use_flash:
        if dropout_active:
            raise ValueError(
                "attention-weight dropout is not implemented in the flash "
                "kernel (the weight matrix is never materialized); call "
                "with use_flash=False/None for dropout-active steps"
            )
        if too_wide:
            raise ValueError(
                f"no flash kernel for head width D={q.shape[-1]} (the "
                f"widest is {KERNEL_HEAD_DIMS[-1]}); call with "
                "use_flash=False/None")
        key_mask = _mask_or_ones(key_mask, k).contiguous()
        return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                    v.contiguous(), key_mask, causal)
    return scaled_dot_product_attention(
        q, k, v, key_mask=key_mask, causal=causal,
        dropout_rate=dropout_rate, generator=generator,
    )
