"""How far the flash-attention kernels (K5, K6) may lie from their plain
versions.

``chip_smoke.py`` and the card tests hold the outputs of
``flash_attention`` (out, lse) and ``flash_attention_backward`` (dq, dk,
dv) against the plain versions in ``ops/attention.py`` computed in fp64,
on the same inputs and, for the backward, on the same forward residuals
(out, lse) and output gradient g. Each check returns, per output, its
largest error and largest share of the tolerance, and raises
``AssertionError`` where an output is not finite or lies outside it.

fp32 kernels (``csrc/flash_attention.cu``). They form every product on the
tensor cores in three TF32 passes over the split operands (3xTF32):
x = x_hi + x_lo + r_x with x_hi = rna_tf32(x), x_lo = rna_tf32(x - x_hi),
|x_lo| <= 2^-11 |x|, |r_x| <= 2^-22 |x|, and
x y ~ x_lo y_hi + x_hi y_lo + x_hi y_hi, each product of two TF32 values
exact. The dropped x_lo y_lo, x_hi r_y and r_x y_hi (and smaller terms)
are at most 3 2^-22 (1 + 2^-10) |x y|: the split puts each product within
c u |x y|, c = 13 (u = 2^-24), where one TF32 pass is 2^-10 |x y|
(2^14 u) off. The tensor cores' fp32 accumulation may truncate instead of
rounding (as ``ops/cin_tolerances.py`` takes it): each of the 3n terms of
a sum of n products, the small correction terms too, is added with at
most 2 u of the partial sum, in whatever order and grouping the kernels
take (they keep the corrections apart where D <= 32). So a product sum on
the tensor cores lies within (6 n + 13) u sum|terms| of the exact value,
where an fp32 sum of n products in any order lies within (n + 2) u
sum|terms|. The softmax statistics, p, ds and delta are fp32 on the CUDA
cores (delta, a torch reduction); the kernels' exp2 (ex2.approx.ftz) is
within 2 ulp (4 u) of exp2, and flushes results below 2^-126 to 0, far
below every tolerance. Element-wise bounds:

- A score s = (q . k) / sqrt(D), as the kernels' exp2 argument s scale
  log2(e) (a rounded constant, one more product), is off by at most
  e_s = ((6 D + 15) A + 2) u, with A = (|q| . |k|) / sqrt(D).
- Forward. p = exp(s - m) carries the errors of s and of the row max m and
  the exp and the subtraction: 2 e_s + 5 u, relative. The row sum l (fp32)
  adds Sk + 2 nk + 2 roundings, nk = ceil(Sk / 64) tile rescalings; P V on
  the tensor cores 6 Sk + 13 and its rescalings 2 nk; the division one
  more. So |out - exact| <= sum_k w |v| (4 e_s + (7 Sk + 4 nk + 27) u),
  with the largest e_s of the row and the exact weights w.
  lse = m + log l is off by at most e_s (m) plus the relative error of l
  (2 e_s + (Sk + 2 nk + 7) u) plus the roundings of log and the sum:
  3 e_s + (Sk + 2 nk + 10) u + 4 u (|lse| + A).
- Backward, on the forward's own lse and out. p = exp(s scale - lse) is off
  by e_p = ((6 D + 17) A + 2 |lse| + 8) u (relative); dp = g . v by
  (6 D + 13) u |g| . |v|; delta (fp32) by (D + 2) u |g| . |out|. So
  |ds - exact| <= |ds| e_p + p scale ((6 D + 13) u |g|.|v| + (D + 2) u
  |g|.|out| + 2 u |dp - delta|) =: t_ds, and each gradient sums n products
  on the tensor cores: dq within t_ds |k| + (6 Sk + 13) u |ds| |k|, dk
  within t_ds^T |q| + (6 Sq + 13) u |ds|^T |q|, dv within (p e_p)^T |g| +
  (6 Sq + 13) u p^T |g|.
The fp64 reference's own error is far below these.

The element-wise bounds hold for any rounding and are loose by the length
of the sums; one TF32 pass lands inside them. So out and each gradient are
also held, as a whole, to a relative Frobenius error under random rounding
(each rounding independent with mean zero; a sum of n fp32 terms with
random signs then errs by about 2 u sqrt(n + 4) of its value, two standard
deviations, as ``ops/cin_tolerances.py`` argues): on the tensor cores 3 n
additions at 2 u each, 8 u sqrt(3 n + 4), and each chain of products its
split, 2 c u. A gradient's chains are s, dp and its own sum, n = S + 2 D
(S the sequence it sums over): 8 u sqrt(3 n + 4) + 2 c sqrt(3) u. out's are
s and P V, n = Sk + D, with l's fp32 sum beside them:
8 u sqrt(3 n + 4) + 4 u sqrt(Sk + 4) + 2 c sqrt(2) u. Planted faults on
the run's own data (:func:`reject_planted`, :func:`reject_tf32`): a dk
that misses one query tile's contribution, and the same function with
single-pass TF32 products (operands, p and ds rounded by
:func:`round_tf32`, the products exact, fp32 sums), which must land at
least ``TF32_REJECT_FACTOR`` times over its limit.

bf16 kernels (``csrc/flash_attention_bf16.cu``). On bf16 q, k, v (and g,
out) they compute the JAX kernels' bf16 function:
:func:`check_forward_bf16` and :func:`check_backward_bf16` hold them two
ways, against the fp64 plain version on the same (upcast) inputs and
against the bf16 plain version (``flash_attention_reference_bf16``,
``flash_attention_backward_reference_bf16``), with u_b = 2^-8, the unit
roundoff of bf16.

- The fp32 part of the error is the bounds above in their fp32-sum form
  (bf16 products are exact in fp32, so no split): each sum of n products
  within (n + 2) u sum|terms|, out within sum_k w |v| (4 e_s + 2 (Sk +
  2 nk + 6) u), lse within 3 e_s + (Sk + 2 nk + 8) u + 4 u (|lse| + A),
  dq within t_ds |k| + (Sk + 2) u |ds| |k| (dk, dv alike), with the
  scores' bound for the kernels' exp2: s scale log2(e) is formed with a
  rounded constant and one more product, and lse log2(e) once more, so
  e_s = ((D + 4) A + 2) u in the forward and e_p = ((D + 6) A + 2 |lse|
  + 6) u in the backward.
- Each term of a sum that consumes a rounded operand carries one bf16
  rounding: p in out = sum p v / l (the row sum l adds the unrounded p, so
  the rounding is not divided out) and in dv = sum p g, ds in dq = sum ds k
  and dk = sum ds q. That is u_b sum|terms|, on top of the fp32 bound t of
  the terms.
- Each output is rounded to bf16 once: u_b (|exact| + t + u_b sum|terms|).
  So against fp64: tol = t + u_b S + u_b (|exact| + t + u_b S), S the sum of
  |terms|.
- Against the bf16 plain version both sides carry these errors, and the
  kernel rounds p against the running max of the key tiles seen so far
  (64 keys a tile; JAX's kernel 128, the plain version all keys at once),
  so a term may round to the other neighbour: twice the fp64 tolerance.
- lse is fp32 on both sides (l sums the unrounded p): the fp32 bound, with
  the widened e_s.

The element-wise bounds hold for any rounding, and are loose: one u_b per
term. So each output is also held, as a whole, under random rounding (each
rounding independent with mean zero, at most u_b of its value): its error
has a Frobenius norm below u_b ||exact|| from the final rounding plus about
u_b sqrt(sum_i sum_k t_ik^2 / 3) from the terms; the limit is
u_b (||exact|| + 2 sqrt(sum_i sum_k t_ik^2)) plus the fp32 limit
4 u sqrt(n + 4) ||exact||, twice that against the bf16 plain version. The
dk less one query tile fails it, and dq less one key tile (the fault of a
K6 that sums dq over key tiles in shared memory): :func:`reject_planted`
reports the factor. Above ``PARTIAL_WIDTH`` columns, where a cluster of
blocks splits D and adds their partial scores, every check can also
reject the function with one block's partials lost
(:func:`flash_attention_partial_scores`,
:func:`flash_attention_backward_partial_scores`; ``planted_partial``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from deep_recommenders_torch.ops import attention as att
from deep_recommenders_torch.ops.cin_tolerances import (
    U32,
    UBF16,
    check_within,
    within_errors,
    worst,
)

_TINY = torch.finfo(torch.float64).tiny
# The kernels' tile of keys in the forward, which sets its rescalings.
_FWD_TILE = 64
# The 3xTF32 split: each product within SPLIT u of |x y|.
SPLIT = 13
# How far over its limit the single-pass TF32 function must land.
TF32_REJECT_FACTOR = 10.0
# The columns of D whose partial scores a block of a cluster forms, for the
# planted fault of a lost exchange.
PARTIAL_WIDTH = 256


# -- TF32 products ------------------------------------------------------------

def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 explicit mantissa bits), to nearest
    with ties away from zero, as ``cvt.rna.tf32.f32``: half of the 13 low
    bits' range added to the magnitude, then the 13 low bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_product(equation: str, x: torch.Tensor, y: torch.Tensor,
                 passes: int) -> torch.Tensor:
    """``einsum(equation, x, y)`` of fp32 x and y from their TF32 splits:
    ``passes`` 3 as the kernels (x_lo y_hi + x_hi y_lo + x_hi y_hi), 1 a
    single TF32 pass (x_hi y_hi). Each product of two TF32 values is exact
    in fp32; the sums are fp32."""
    xh, yh = round_tf32(x), round_tf32(y)
    out = torch.einsum(equation, xh, yh)
    if passes == 3:
        xl, yl = round_tf32(x - xh), round_tf32(y - yh)
        out = (torch.einsum(equation, xl, yh) + torch.einsum(equation, xh, yl)
               + out)
    elif passes != 1:
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    return out


def flash_attention_tf32(q, k, v, key_mask, causal: bool, passes: int = 3):
    """(out, lse) of K5 in fp32 with TF32 products (:func:`tf32_product`):
    s = q k^T scale, p = exp(s - m) over valid lanes, out = (p v) / l with
    l the row sum of p, lse = m + log l; a row with no valid key gives out
    0 and lse 0. ``passes=3`` emulates the fp32 kernels' products,
    ``passes=1`` is the planted single-pass fault."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = tf32_product("...qd,...kd->...qk", q, k, passes) * scale
    valid = att._valid_lanes(s.shape, key_mask, causal, s.device)
    if valid is not None:
        s = torch.where(valid, s, att.NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(s <= att.NEG_INF / 2, 0.0, torch.exp(s - m[..., None]))
    l = p.sum(-1).clamp_min(1e-30)
    out = tf32_product("...qk,...kd->...qd", p, v, passes) / l[..., None]
    return out, torch.where(m > att.NEG_INF / 2, m + torch.log(l), 0.0)


def flash_attention_backward_tf32(q, k, v, key_mask, out, lse, g,
                                  causal: bool, passes: int = 3):
    """(dq, dk, dv) of K6 in fp32 with TF32 products, on the forward's out
    and lse: p rebuilt from lse, dp = g v^T, delta = rowsum(g * out),
    ds = p (dp - delta) scale, dq = ds k, dk = ds^T q, dv = p^T g."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = tf32_product("...qd,...kd->...qk", q, k, passes) * scale
    p = torch.exp(s - lse[..., None])
    valid = att._valid_lanes(s.shape, key_mask, causal, s.device)
    if valid is not None:
        p = torch.where(valid, p, 0.0)
    dp = tf32_product("...qd,...kd->...qk", g, v, passes)
    ds = p * (dp - (g * out).sum(-1)[..., None]) * scale
    return (tf32_product("...qk,...kd->...qd", ds, k, passes),
            tf32_product("...qk,...qd->...kd", ds, q, passes),
            tf32_product("...qk,...qd->...kd", p, g, passes))


def flash_attention_partial_scores(q, k, v, key_mask, causal: bool,
                                   drop: Optional[int] = None,
                                   width: int = PARTIAL_WIDTH):
    """(out, lse) of K5 with the scores summed in fp32 from partials over
    ``width`` columns of D each, q_r k_r^T, added in rank order, as a
    cluster that splits D adds its blocks' partials; ``drop`` leaves rank
    ``drop``'s partial out (a lost exchange: the planted fault). fp32 q, k,
    v give the fp32 plain version's function; bf16 ones the bf16 plain
    version's (p rounded to bf16 before P V, out rounded once)."""
    d = q.shape[-1]
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.zeros(q.shape[:2] + k.shape[1:2], dtype=torch.float32,
                    device=q.device)
    for rank, c in enumerate(range(0, d, width)):
        if rank != drop:
            s = s + torch.einsum("...qd,...kd->...qk", qf[..., c:c + width],
                                 kf[..., c:c + width])
    s = s / math.sqrt(d)
    valid = att._valid_lanes(s.shape, key_mask, causal, s.device)
    if valid is not None:
        s = torch.where(valid, s, att.NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(s <= att.NEG_INF / 2, 0.0, torch.exp(s - m[..., None]))
    l = p.sum(-1).clamp_min(1e-30)
    if q.dtype == torch.bfloat16:
        p = p.to(torch.bfloat16).float()
    out = torch.einsum("...qk,...kd->...qd", p, vf) / l[..., None]
    lse = torch.where(m > att.NEG_INF / 2, m + torch.log(l), 0.0)
    return out.to(q.dtype), lse


def flash_attention_backward_partial_scores(q, k, v, key_mask, out, lse, g,
                                            causal: bool,
                                            drop: Optional[int] = None,
                                            width: int = PARTIAL_WIDTH):
    """(dq, dk, dv) of K6 with s = q k^T and dp = g v^T summed in fp32 from
    partials over ``width`` columns of D each, added in rank order, as a
    cluster that splits D adds its blocks' partials (each kernel of K6
    exchanges both, or s^T and dp^T); ``drop`` leaves rank ``drop``'s
    partials out (a lost exchange: the planted fault). On the forward's
    out and lse; delta = rowsum(g out) in fp32. fp32 operands give the fp32
    plain version's function; bf16 ones the bf16 plain version's (p and ds
    rounded to bf16 before the products, the gradients rounded once)."""
    d = q.shape[-1]
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, out, g))
    shape = q.shape[:2] + k.shape[1:2]
    s = torch.zeros(shape, dtype=torch.float32, device=q.device)
    dp = torch.zeros_like(s)
    for rank, c in enumerate(range(0, d, width)):
        if rank != drop:
            cols = slice(c, c + width)
            s = s + torch.einsum("...qd,...kd->...qk", qf[..., cols],
                                 kf[..., cols])
            dp = dp + torch.einsum("...qd,...kd->...qk", gf[..., cols],
                                   vf[..., cols])
    scale = 1.0 / math.sqrt(d)
    p = torch.exp(s * scale - lse.float()[..., None])
    valid = att._valid_lanes(s.shape, key_mask, causal, s.device)
    if valid is not None:
        p = torch.where(valid, p, 0.0)
    ds = p * (dp - (gf * of).sum(-1)[..., None]) * scale
    if q.dtype == torch.bfloat16:
        p = p.to(torch.bfloat16).float()
        ds = ds.to(torch.bfloat16).float()
    grads = (torch.einsum("...qk,...kd->...qd", ds, kf),
             torch.einsum("...qk,...qd->...kd", ds, qf),
             torch.einsum("...qk,...qd->...kd", p, gf))
    return tuple(t.to(q.dtype) for t in grads)


def reject_lost_partial(name: str, share: float) -> Dict[str, float]:
    """The forward and backward checks must reject K5 or K6 with one
    block's partial scores left out (:func:`flash_attention_partial_scores`
    or :func:`flash_attention_backward_partial_scores` with ``drop``):
    ``share`` is its largest share of a tolerance. Returns it; raises if
    the check accepts the fault."""
    if not share > 1:
        raise AssertionError(f"{name}: the check accepts a planted fault "
                             f"(a partial score lost): {share:.3g}")
    return {"partial_dropped": share}


# -- fp32 kernels -------------------------------------------------------------

def _mask(key_mask, k):
    if key_mask is None:
        return torch.ones(k.shape[:2], dtype=torch.float64, device=k.device)
    return key_mask.double()


def _abs_scores(q, k, key_mask, causal):
    """A = (|q| . |k|) / sqrt(D) on valid lanes, 0 elsewhere (fp64)."""
    d = q.shape[-1]
    a = torch.einsum("bqd,bkd->bqk", q.abs(), k.abs()) / math.sqrt(d)
    valid = att._valid_lanes(a.shape, key_mask, causal, a.device)
    return a if valid is None else torch.where(valid, a, 0.0)


def _forward_bounds(q, k, v, mask, causal, split: bool):
    """The fp64 plain (out, lse), sum_k w |v| and the tolerances of out and
    lse: ``split``, the fp32 kernels' 3xTF32 products; else the fp32 part
    of the bf16 kernels' (fp32 sums of exact products); exp2 in both."""
    d, sk = q.shape[-1], k.shape[1]
    nk = -(-sk // _FWD_TILE)
    out, lse = att.flash_attention_reference(q, k, v, mask, causal)
    a = _abs_scores(q, k, mask, causal).amax(-1)  # (BH, Sq)
    w = att.flash_attention_reference(q, k, v.abs(), mask, causal)[0]
    if split:
        e_s = ((6 * d + SPLIT + 2) * a + 2) * U32
        sums, lse_sums = 7 * sk + 4 * nk + 27, sk + 2 * nk + 10
    else:
        e_s = ((d + 4) * a + 2) * U32
        sums, lse_sums = 2 * (sk + 2 * nk + 6), sk + 2 * nk + 8
    tol_out = w * (4 * e_s + sums * U32)[..., None]
    tol_lse = 3 * e_s + lse_sums * U32 + 4 * U32 * (lse.abs() + a)
    return out, lse, w, tol_out, tol_lse


def _grad_fro_limit(n: int) -> float:
    """The relative Frobenius limit of a gradient of the fp32 kernels whose
    chains of sums (s, dp and its own) have n terms together."""
    return 8 * U32 * math.sqrt(3 * n + 4) + 2 * SPLIT * math.sqrt(3) * U32


def _out_fro_limit(sk: int, d: int) -> float:
    """out's relative Frobenius limit: s and P V in 3xTF32, l in fp32."""
    return (8 * U32 * math.sqrt(3 * (sk + d) + 4)
            + 4 * U32 * math.sqrt(sk + 4) + 2 * SPLIT * math.sqrt(2) * U32)


def _fro_errors(got, want, tol, rel_fro_tol: float) -> Dict[str, float]:
    """An output's share of its element-wise tolerance ``tol`` and its
    relative Frobenius error against ``rel_fro_tol``."""
    err = (got.double() - want).abs()
    rel_fro = (err.norm() / want.norm().clamp_min(_TINY)).item()
    return {
        "max_abs_err": err.max().item(),
        "tolerance": tol.max().item(),
        "err_over_tol": (err / tol.clamp_min(_TINY)).max().item(),
        "rel_fro_err": rel_fro,
        "rel_fro_tol": rel_fro_tol,
        "fro_over_tol": rel_fro / rel_fro_tol,
        "finite": bool(torch.isfinite(got).all()),
    }


def _held(name: str, got, want, errors) -> Dict[str, float]:
    if tuple(got.shape) != tuple(want.shape) or worst(errors) > 1:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{errors}")
    del errors["finite"]
    return errors


def _lost_partial(q, k, v, mask, causal):
    """:func:`flash_attention_partial_scores` on the check's inputs with
    the last block's partial left out."""
    last = (q.shape[-1] - 1) // PARTIAL_WIDTH
    return flash_attention_partial_scores(q, k, v, mask.float(), causal,
                                          drop=last)


def _lost_partial_backward(q, k, v, mask, out, lse, g, causal):
    """:func:`flash_attention_backward_partial_scores` on the check's
    inputs with the last block's partials left out."""
    last = (q.shape[-1] - 1) // PARTIAL_WIDTH
    return flash_attention_backward_partial_scores(
        q, k, v, mask.float(), out, lse, g, causal, drop=last)


def check_forward(got: Sequence[torch.Tensor], q, k, v,
                  key_mask: Optional[torch.Tensor], causal: bool,
                  planted_tf32: bool = False, planted_partial: bool = False
                  ) -> Dict[str, Dict[str, float]]:
    """K5's (out, lse) against the fp64 plain version: out element-wise
    and by relative Frobenius error, lse element-wise. With
    ``planted_tf32``, also :func:`reject_tf32` on the single-pass TF32
    forward of the same fp32 inputs, under "planted"; with
    ``planted_partial`` (D above PARTIAL_WIDTH), :func:`reject_lost_partial`
    on the forward that loses the last block's partial scores, under
    "planted" too."""
    mask = _mask(key_mask, k)
    args = [t.double() for t in (q, k, v)]
    out, lse, _, tol_out, tol_lse = _forward_bounds(*args, mask, causal,
                                                    split=True)
    fro_tol = _out_fro_limit(k.shape[1], q.shape[-1])
    name = f"flash_attention forward causal={causal}"
    checks = {"out": _held(f"{name} out", got[0], out,
                           _fro_errors(got[0], out, tol_out, fro_tol)),
              "lse": check_within(f"{name} lse", got[1], lse, tol_lse)}
    if planted_tf32:
        fault = flash_attention_tf32(*(t.float() for t in (q, k, v)),
                                     mask.float(), causal, passes=1)
        checks["planted"] = reject_tf32(name, {
            "out": worst(_fro_errors(fault[0], out, tol_out, fro_tol)),
            "lse": within_errors(fault[1], lse, tol_lse)["err_over_tol"]})
    if planted_partial:
        fault = _lost_partial(q.float(), k.float(), v.float(), mask, causal)
        checks.setdefault("planted", {}).update(reject_lost_partial(name, max(
            worst(_fro_errors(fault[0], out, tol_out, fro_tol)),
            within_errors(fault[1], lse, tol_lse)["err_over_tol"])))
    return checks


def _backward_bounds(q, k, v, mask, out, lse, g, causal, split: bool):
    """The fp64 plain (dq, dk, dv), their element-wise tolerances and the
    dense terms (p, ds, t_ds, e_p): ``split``, the fp32 kernels' 3xTF32
    products; else the fp32 part of the bf16 kernels' (fp32 sums of exact
    products); exp2 in both."""
    d = q.shape[-1]
    sq, sk = q.shape[1], k.shape[1]
    scale = 1.0 / math.sqrt(d)
    want = att.flash_attention_backward_reference(q, k, v, mask, out, lse, g,
                                                  causal)
    p, dp, delta, ds = att.backward_terms(q, k, v, mask, out, lse, g, causal)
    a = _abs_scores(q, k, mask, causal)
    if split:
        e_p = ((6 * d + SPLIT + 4) * a + 2 * lse.abs()[..., None] + 8) * U32
        c_dp, c_q, c_k = 6 * d + SPLIT, 6 * sq + SPLIT, 6 * sk + SPLIT
    else:
        e_p = ((d + 6) * a + 2 * lse.abs()[..., None] + 6) * U32
        c_dp, c_q, c_k = d + 2, sq + 2, sk + 2
    gv = torch.einsum("bqd,bkd->bqk", g.abs(), v.abs())
    go = (g.abs() * out.abs()).sum(-1)
    t_ds = (ds.abs() * e_p + p * scale * (
        c_dp * U32 * gv + (d + 2) * U32 * go[..., None]
        + 2 * U32 * (dp - delta[..., None]).abs()))
    ak, aq, ag = k.abs(), q.abs(), g.abs()
    tol_dq = (torch.einsum("bqk,bkd->bqd", t_ds, ak)
              + c_k * U32 * torch.einsum("bqk,bkd->bqd", ds.abs(), ak))
    tol_dk = (torch.einsum("bqk,bqd->bkd", t_ds, aq)
              + c_q * U32 * torch.einsum("bqk,bqd->bkd", ds.abs(), aq))
    tol_dv = (torch.einsum("bqk,bqd->bkd", p * e_p, ag)
              + c_q * U32 * torch.einsum("bqk,bqd->bkd", p, ag))
    return want, (tol_dq, tol_dk, tol_dv), (p, ds, t_ds, e_p)


def check_backward(got: Sequence[torch.Tensor], q, k, v,
                   key_mask: Optional[torch.Tensor], out, lse, g,
                   causal: bool, planted_rows: int = 0,
                   planted_tf32: bool = False, planted_partial: bool = False
                   ) -> Dict[str, Dict[str, float]]:
    """K6's (dq, dk, dv) against the fp64 plain backward on the same out,
    lse and g. With ``planted_rows``, also :func:`reject_planted` on dk
    less the contribution of its first ``planted_rows`` queries; with
    ``planted_tf32``, :func:`reject_tf32` on the single-pass TF32 backward
    of the same fp32 inputs, under "planted"; with ``planted_partial`` (D
    above PARTIAL_WIDTH), :func:`reject_lost_partial` on the backward that
    loses the last block's partial scores, under "planted" too."""
    args = [t.double() for t in (q, k, v)]
    mask = _mask(key_mask, k)
    rest = [t.double() for t in (out, lse, g)]
    want, tols, _ = _backward_bounds(*args, mask, *rest, causal, split=True)
    d, sq, sk = q.shape[-1], q.shape[1], k.shape[1]
    limits = [_grad_fro_limit(n + 2 * d) for n in (sk, sq, sq)]
    name = f"flash_attention backward causal={causal}"
    checks = {}
    for i, grad in enumerate(("dq", "dk", "dv")):
        checks[grad] = _held(f"{name} {grad}", got[i], want[i], _fro_errors(
            got[i], want[i], tols[i], limits[i]))
    if planted_rows:
        r = planted_rows
        chunk = att.flash_attention_backward_reference(
            args[0][:, :r], args[1], args[2], mask, rest[0][:, :r],
            rest[1][:, :r], rest[2][:, :r], causal)[1]
        checks["dk"]["planted"] = reject_planted(
            f"{name} dk", got[1], want[1], tols[1], limits[1], chunk)
    if planted_tf32:
        fault = flash_attention_backward_tf32(
            *(t.float() for t in (q, k, v)), mask.float(),
            *(t.float() for t in (out, lse, g)), causal, passes=1)
        checks["planted"] = reject_tf32(name, {
            grad: worst(_fro_errors(fault[i], want[i], tols[i], limits[i]))
            for i, grad in enumerate(("dq", "dk", "dv"))})
    if planted_partial:
        fault = _lost_partial_backward(
            *(t.float() for t in (q, k, v)), mask,
            *(t.float() for t in (out, lse, g)), causal)
        checks.setdefault("planted", {}).update(reject_lost_partial(
            name, max(worst(_fro_errors(fault[i], want[i], tols[i],
                                        limits[i])) for i in range(3))))
    return checks


def reject_planted(name: str, got, want, tol, rel_fro_tol: float,
                   chunk: torch.Tensor) -> Dict[str, float]:
    """The gradient check must reject ``got`` less ``chunk`` (one query
    tile's contribution). Returns the fault's largest share of a
    tolerance; raises if the check accepts it."""
    share = worst(_fro_errors(got - chunk.to(got.dtype), want, tol,
                              rel_fro_tol))
    if not share > 1:
        raise AssertionError(f"{name}: the check accepts a planted fault "
                             f"(query tile dropped): {share:.3g}")
    return {"query_tile_dropped": share}


def reject_tf32(name: str, shares: Dict[str, float]) -> Dict[str, float]:
    """The checks must reject the single-pass TF32 function by at least
    ``TF32_REJECT_FACTOR``: ``shares`` are its largest share of a
    tolerance in each output. Returns the factor (the largest share) and
    the shares; raises if the factor is below ``TF32_REJECT_FACTOR``."""
    factor = max(shares.values())
    if not factor >= TF32_REJECT_FACTOR:
        raise AssertionError(
            f"{name}: single-pass TF32 lands only {factor:.3g} times over "
            f"its limit (at least {TF32_REJECT_FACTOR} needed): {shares}")
    return {"single_pass_tf32": factor,
            **{f"single_pass_tf32_{k}": v for k, v in shares.items()}}


# -- bf16 kernels -------------------------------------------------------------

def _rounded_errors(got, want, tol, sq_terms, n, factor=1.0
                    ) -> Dict[str, float]:
    """A bf16 output's share of its element-wise tolerance ``tol`` and its
    Frobenius error against factor (u_b (||want|| + 2 sqrt(sum
    ``sq_terms``)) + 4 u sqrt(n + 4) ||want||), with ``sq_terms`` the
    squares of the terms of each element's sum."""
    err = (got.double() - want).abs()
    norm = want.norm().item()
    fro_tol = factor * (UBF16 * (norm + 2 * math.sqrt(sq_terms.sum().item()))
                        + 4 * U32 * math.sqrt(n + 4) * norm)
    fro = err.norm().item()
    denom = max(norm, _TINY)
    return {
        "max_abs_err": err.max().item(),
        "tolerance": tol.max().item(),
        "err_over_tol": (err / tol.clamp_min(_TINY)).max().item(),
        "rel_fro_err": fro / denom,
        "rel_fro_tol": fro_tol / denom,
        "fro_over_tol": fro / max(fro_tol, _TINY),
        "finite": bool(torch.isfinite(got).all()),
    }


def _hold(name, errors, hold: bool = True):
    if hold and worst(errors) > 1:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{errors}")
    del errors["finite"]
    return errors


def _rounded_tol(t, terms, want):
    """t, one u_b per term of ``terms`` (sum|terms|) and the output's own
    bf16 rounding."""
    return t + UBF16 * terms + UBF16 * (want.abs() + t + UBF16 * terms)


def check_forward_bf16(got: Sequence[torch.Tensor], q, k, v,
                       key_mask: Optional[torch.Tensor], causal: bool,
                       planted_partial: bool = False, hold: bool = True
                       ) -> Dict[str, Dict[str, float]]:
    """The bf16 K5's (out, lse) on bf16 q, k, v: out against the fp64 plain
    version ("out") and the bf16 plain version ("out_bf16_plain"), lse
    against fp64. With ``planted_partial``, also
    :func:`reject_lost_partial` on the bf16 forward that loses the last
    block's partial scores, under "planted". ``hold=False`` reports the
    shares without raising where they exceed 1 (inputs outside the
    tolerances' model, to set two kernels side by side)."""
    mask = _mask(key_mask, k)
    qd, kd, vd = q.double(), k.double(), v.double()
    out, lse, w_abs, t_out, tol_lse = _forward_bounds(qd, kd, vd, mask,
                                                      causal, split=False)
    weights, _ = att._softmax_weights(qd, kd, mask, causal)
    sq_terms = torch.einsum("bqk,bkd->bqd", weights.square(), vd.square())
    del weights
    tol = _rounded_tol(t_out, w_abs, out)
    plain, _ = att.flash_attention_reference_bf16(q, k, v, mask.float(),
                                                  causal)
    sk = k.shape[1]
    name = f"flash_attention bf16 forward causal={causal}"
    if got[0].dtype != torch.bfloat16 or got[1].dtype != torch.float32:
        raise AssertionError(f"{name}: dtypes {got[0].dtype}, {got[1].dtype}")
    checks = {
        "out": _hold(f"{name} out", _rounded_errors(
            got[0], out, tol, sq_terms, sk), hold),
        "out_bf16_plain": _hold(f"{name} out (bf16 plain)", _rounded_errors(
            got[0], plain.double(), 2 * tol, sq_terms, sk, factor=2.0),
            hold),
        "lse": (check_within(f"{name} lse", got[1], lse, tol_lse) if hold
                else within_errors(got[1], lse, tol_lse)),
    }
    if planted_partial:
        fault = _lost_partial(q, k, v, mask, causal)
        checks["planted"] = reject_lost_partial(name, max(
            worst(_rounded_errors(fault[0], out, tol, sq_terms, sk)),
            within_errors(fault[1], lse, tol_lse)["err_over_tol"]))
    return checks


def check_backward_bf16(got: Sequence[torch.Tensor], q, k, v,
                        key_mask: Optional[torch.Tensor], out, lse, g,
                        causal: bool, planted_rows: int = 0,
                        planted_keys: int = 0, planted_partial: bool = False,
                        hold: bool = True
                        ) -> Dict[str, Dict[str, float]]:
    """The bf16 K6's (dq, dk, dv) on bf16 q, k, v, out, g and fp32 lse:
    each against the fp64 plain backward on the same inputs ("dq", ...) and
    the bf16 plain backward ("dq_bf16_plain", ...). With
    ``planted_rows``, also :func:`reject_planted_bf16` on dk less the
    contribution of its first ``planted_rows`` queries; with
    ``planted_keys``, on dq less the contribution of its first
    ``planted_keys`` keys (a key tile lost from dq's sum); with
    ``planted_partial``, :func:`reject_lost_partial` on the bf16 backward
    that loses the last block's partial scores, under "planted". ``hold``
    as in :func:`check_forward_bf16`."""
    mask = _mask(key_mask, k)
    args = [t.double() for t in (q, k, v)]
    rest = [t.double() for t in (out, lse, g)]
    want, tols, (p, ds, t_ds, e_p) = _backward_bounds(
        *args, mask, *rest, causal, split=False)
    qd, kd, _ = args
    gd = rest[2]
    ads = ds.abs() + t_ds
    terms = (torch.einsum("bqk,bkd->bqd", ads, kd.abs()),
             torch.einsum("bqk,bqd->bkd", ads, qd.abs()),
             torch.einsum("bqk,bqd->bkd", p * (1 + e_p), gd.abs()))
    sq_terms = (torch.einsum("bqk,bkd->bqd", ds.square(), kd.square()),
                torch.einsum("bqk,bqd->bkd", ds.square(), qd.square()),
                torch.einsum("bqk,bqd->bkd", p.square(), gd.square()))
    del p, ds, t_ds, e_p, ads
    plain = att.flash_attention_backward_reference_bf16(
        q, k, v, mask.float(), out, lse, g, causal)
    d, sq, sk = q.shape[-1], q.shape[1], k.shape[1]
    name = f"flash_attention bf16 backward causal={causal}"
    checks, fault_shares = {}, []
    fault = (_lost_partial_backward(q, k, v, mask, out, lse, g, causal)
             if planted_partial else None)
    for i, (grad, n) in enumerate((("dq", sk + 2 * d), ("dk", sq + 2 * d),
                                   ("dv", sq + 2 * d))):
        if got[i].dtype != torch.bfloat16 or \
                tuple(got[i].shape) != tuple(want[i].shape):
            raise AssertionError(f"{name} {grad}: {got[i].dtype} "
                                 f"{tuple(got[i].shape)}")
        tol = _rounded_tol(tols[i], terms[i], want[i])
        checks[grad] = _hold(f"{name} {grad}", _rounded_errors(
            got[i], want[i], tol, sq_terms[i], n), hold)
        checks[f"{grad}_bf16_plain"] = _hold(
            f"{name} {grad} (bf16 plain)", _rounded_errors(
                got[i], plain[i].double(), 2 * tol, sq_terms[i], n, 2.0),
            hold)
        if grad == "dk" and planted_rows:
            r = planted_rows
            chunk = att.flash_attention_backward_reference(
                qd[:, :r], kd, args[2], mask, rest[0][:, :r], rest[1][:, :r],
                gd[:, :r], causal)[1]
            checks["dk"]["planted"] = reject_planted_bf16(
                f"{name} dk", got[1], want[1], tol, sq_terms[1], n, chunk)
        if grad == "dq" and planted_keys:
            r = planted_keys
            chunk = att.flash_attention_backward_reference(
                qd, kd[:, :r], args[2][:, :r], mask[:, :r], *rest,
                causal)[0]
            checks["dq"]["planted"] = reject_planted_bf16(
                f"{name} dq", got[0], want[0], tol, sq_terms[0], n, chunk,
                fault="key_tile_dropped")
        if fault is not None:
            fault_shares.append(worst(_rounded_errors(
                fault[i], want[i], tol, sq_terms[i], n)))
    if fault is not None:
        checks["planted"] = reject_lost_partial(name, max(fault_shares))
    return checks


def reject_planted_bf16(name: str, got, want, tol, sq_terms, n: int,
                        chunk: torch.Tensor,
                        fault: str = "query_tile_dropped"
                        ) -> Dict[str, float]:
    """:func:`reject_planted` for the bf16 checks: the check must reject
    ``got`` less ``chunk`` (one query tile's contribution to dk, or
    ``fault`` "key_tile_dropped": one key tile's to dq)."""
    share = worst(_rounded_errors(got.double() - chunk, want, tol, sq_terms,
                                  n))
    if not share > 1:
        raise AssertionError(f"{name}: the check accepts a planted fault "
                             f"({fault.replace('_', ' ')}): {share:.3g}")
    return {fault: share}
