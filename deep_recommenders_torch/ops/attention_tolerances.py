"""How far the flash-attention kernels (K5, K6) may lie from their plain
versions.

``chip_smoke.py`` and the card tests hold the outputs of
``flash_attention`` (out, lse) and ``flash_attention_backward`` (dq, dk,
dv) against the plain versions in ``ops/attention.py`` computed in fp64,
on the same inputs and, for the backward, on the same forward residuals
(out, lse) and output gradient g. Each check returns, per output, its
largest error and largest share of the tolerance, and raises
``AssertionError`` where an output is not finite or lies outside it.

Element-wise bounds (u = 2^-24; an fp32 sum of n terms in any order lies
within (n + 2) u sum|terms| of the exact value):

- A score s = (q . k) / sqrt(D) is a sum of D products: its error is at
  most e_s = ((D + 2) A + 1) u, with A = (|q| . |k|) / sqrt(D).
- Forward. p = exp(s - m) carries the errors of s and of the row max m
  and two roundings of exp and the subtraction: 2 e_s + 3u, relative. The
  row sum l and each output sum add at most Sk + 2 nk + 2 roundings, nk =
  ceil(Sk / 64) tile rescalings, and the division one more. So
  |out - exact| <= sum_k w |v| (4 e_s + 2 (Sk + 2 nk + 6) u), with the
  largest e_s of the row and the exact weights w.
  lse = m + log l is off by at most e_s (m) plus the relative error of l
  (2 e_s + (Sk + 2 nk + 5) u) plus the roundings of log and the sum:
  3 e_s + (Sk + 2 nk + 8) u + 4 u (|lse| + A).
- Backward, on the forward's own lse and out. p = exp(s scale - lse) is off
  by e_p = e_s + 3u (relative); dp = g . v by (D + 2) u |g| . |v|; delta
  (fp32, torch) by (D + 2) u |g| . |out|. So
  |ds - exact| <= |ds| e_p + p scale ((D + 2) u (|g|.|v| + |g|.|out|)
  + 2 u |dp - delta|) =: t_ds, and each gradient sums n terms:
  dq within t_ds |k| + (Sk + 2) u |ds| |k|, dk within t_ds^T |q| +
  (Sq + 2) u |ds|^T |q|, dv within (p e_p)^T |g| + (Sq + 2) u p^T |g|.
The fp64 reference's own error is far below these.

Each gradient is also held, as a whole, to a relative Frobenius error of at
most 4 u sqrt(n + 4), n = S + 2 D the longest chain of sums behind it (S
the sequence it sums over), as ``ops/cin_tolerances.py`` argues under
random rounding. A dk that misses one query tile's contribution fails both
checks: :func:`reject_planted` shows it on the run's data.

bf16 kernels (``csrc/flash_attention_bf16.cu``). On bf16 q, k, v (and g,
out) they compute the JAX kernels' bf16 function:
:func:`check_forward_bf16` and :func:`check_backward_bf16` hold them two
ways, against the fp64 plain version on the same (upcast) inputs and
against the bf16 plain version (``flash_attention_reference_bf16``,
``flash_attention_backward_reference_bf16``), with u_b = 2^-8, the unit
roundoff of bf16.

- The fp32 part of the error is the fp32 bound above, with the scores'
  bound widened for the kernels' exp2: s scale log2(e) is formed with a
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
dk less one query tile fails it: :func:`reject_planted` reports the factor.
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
    worst,
)

_TINY = torch.finfo(torch.float64).tiny
# The kernels' tile of keys in the forward, which sets its rescalings.
_FWD_TILE = 64


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


def _forward_bounds(q, k, v, mask, causal, widened=False):
    """The fp64 plain (out, lse), sum_k w |v| and the fp32 tolerances of
    out and lse; ``widened``: the bf16 kernels' e_s."""
    d, sk = q.shape[-1], k.shape[1]
    nk = -(-sk // _FWD_TILE)
    out, lse = att.flash_attention_reference(q, k, v, mask, causal)
    a = _abs_scores(q, k, mask, causal)
    extra = (2, 2) if widened else (0, 1)
    e_s = ((d + 2 + extra[0]) * a.amax(-1) + extra[1]) * U32  # (BH, Sq)
    w = att.flash_attention_reference(q, k, v.abs(), mask, causal)[0]
    tol_out = w * (4 * e_s + 2 * (sk + 2 * nk + 6) * U32)[..., None]
    tol_lse = (3 * e_s + (sk + 2 * nk + 8) * U32
               + 4 * U32 * (lse.abs() + a.amax(-1)))
    return out, lse, w, tol_out, tol_lse


def check_forward(got: Sequence[torch.Tensor], q, k, v,
                  key_mask: Optional[torch.Tensor], causal: bool
                  ) -> Dict[str, Dict[str, float]]:
    """K5's (out, lse) against the fp64 plain version."""
    q, k, v = q.double(), k.double(), v.double()
    mask = _mask(key_mask, k)
    out, lse, _, tol_out, tol_lse = _forward_bounds(q, k, v, mask, causal)
    name = f"flash_attention forward causal={causal}"
    return {"out": check_within(f"{name} out", got[0], out, tol_out),
            "lse": check_within(f"{name} lse", got[1], lse, tol_lse)}


def _backward_bounds(q, k, v, mask, out, lse, g, causal, widened=False):
    """The fp64 plain (dq, dk, dv), their element-wise fp32 tolerances and
    the dense terms (p, ds, t_ds, e_p); ``widened``: the bf16 kernels'
    e_p."""
    d = q.shape[-1]
    sq, sk = q.shape[1], k.shape[1]
    scale = 1.0 / math.sqrt(d)
    want = att.flash_attention_backward_reference(q, k, v, mask, out, lse, g,
                                                  causal)
    p, dp, delta, ds = att.backward_terms(q, k, v, mask, out, lse, g, causal)
    a = _abs_scores(q, k, mask, causal)
    if widened:
        e_p = ((d + 6) * a + 2 * lse.abs()[..., None] + 6) * U32
    else:
        e_p = ((d + 2) * a + 4) * U32
    gv = torch.einsum("bqd,bkd->bqk", g.abs(), v.abs())
    go = (g.abs() * out.abs()).sum(-1)
    t_ds = (ds.abs() * e_p + p * scale * (
        (d + 2) * U32 * (gv + go[..., None])
        + 2 * U32 * (dp - delta[..., None]).abs()))
    ak, aq, ag = k.abs(), q.abs(), g.abs()
    tol_dq = (torch.einsum("bqk,bkd->bqd", t_ds, ak)
              + (sk + 2) * U32 * torch.einsum("bqk,bkd->bqd", ds.abs(), ak))
    tol_dk = (torch.einsum("bqk,bqd->bkd", t_ds, aq)
              + (sq + 2) * U32 * torch.einsum("bqk,bqd->bkd", ds.abs(), aq))
    tol_dv = (torch.einsum("bqk,bqd->bkd", p * e_p, ag)
              + (sq + 2) * U32 * torch.einsum("bqk,bqd->bkd", p, ag))
    return want, (tol_dq, tol_dk, tol_dv), (p, ds, t_ds, e_p)


def _grad_errors(got, want, tol, n) -> Dict[str, float]:
    """A gradient's share of its element-wise tolerance ``tol`` and its
    relative Frobenius error against the limit 4 u sqrt(n + 4)."""
    err = (got.double() - want).abs()
    rel_fro = (err.norm() / want.norm().clamp_min(_TINY)).item()
    rel_fro_tol = 4 * U32 * math.sqrt(n + 4)
    return {
        "max_abs_err": err.max().item(),
        "tolerance": tol.max().item(),
        "err_over_tol": (err / tol.clamp_min(_TINY)).max().item(),
        "rel_fro_err": rel_fro,
        "rel_fro_tol": rel_fro_tol,
        "fro_over_tol": rel_fro / rel_fro_tol,
        "finite": bool(torch.isfinite(got).all()),
    }


def check_backward(got: Sequence[torch.Tensor], q, k, v,
                   key_mask: Optional[torch.Tensor], out, lse, g,
                   causal: bool, planted_rows: int = 0
                   ) -> Dict[str, Dict[str, float]]:
    """K6's (dq, dk, dv) against the fp64 plain backward on the same out,
    lse and g. With ``planted_rows``, also :func:`reject_planted` on dk
    less the contribution of its first ``planted_rows`` queries."""
    args = [t.double() for t in (q, k, v)]
    mask = _mask(key_mask, k)
    rest = [t.double() for t in (out, lse, g)]
    want, tols, _ = _backward_bounds(*args, mask, *rest, causal)
    d, sq, sk = q.shape[-1], q.shape[1], k.shape[1]
    name = f"flash_attention backward causal={causal}"
    checks = {}
    for i, (grad, n) in enumerate((("dq", sk + 2 * d), ("dk", sq + 2 * d),
                                   ("dv", sq + 2 * d))):
        errors = _grad_errors(got[i], want[i], tols[i], n)
        if tuple(got[i].shape) != tuple(want[i].shape) or worst(errors) > 1:
            raise AssertionError(f"{name} {grad} disagrees with its plain "
                                 f"version: {errors}")
        del errors["finite"]
        checks[grad] = errors
    if planted_rows:
        r = planted_rows
        chunk = att.flash_attention_backward_reference(
            args[0][:, :r], args[1], args[2], mask, rest[0][:, :r],
            rest[1][:, :r], rest[2][:, :r], causal)[1]
        checks["dk"]["planted"] = reject_planted(
            f"{name} dk", got[1], want[1], tols[1], sq + 2 * d, chunk)
    return checks


def reject_planted(name: str, got, want, tol, n: int,
                   chunk: torch.Tensor) -> Dict[str, float]:
    """The gradient check must reject ``got`` less ``chunk`` (one query
    tile's contribution). Returns the fault's largest share of a
    tolerance; raises if the check accepts it."""
    share = worst(_grad_errors(got - chunk.to(got.dtype), want, tol, n))
    if not share > 1:
        raise AssertionError(f"{name}: the check accepts a planted fault "
                             f"(query tile dropped): {share:.3g}")
    return {"query_tile_dropped": share}


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


def _hold(name, errors):
    if worst(errors) > 1:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{errors}")
    del errors["finite"]
    return errors


def _rounded_tol(t, terms, want):
    """t, one u_b per term of ``terms`` (sum|terms|) and the output's own
    bf16 rounding."""
    return t + UBF16 * terms + UBF16 * (want.abs() + t + UBF16 * terms)


def check_forward_bf16(got: Sequence[torch.Tensor], q, k, v,
                       key_mask: Optional[torch.Tensor], causal: bool
                       ) -> Dict[str, Dict[str, float]]:
    """The bf16 K5's (out, lse) on bf16 q, k, v: out against the fp64 plain
    version ("out") and the bf16 plain version ("out_bf16_plain"), lse
    against fp64."""
    mask = _mask(key_mask, k)
    qd, kd, vd = q.double(), k.double(), v.double()
    out, lse, w_abs, t_out, tol_lse = _forward_bounds(qd, kd, vd, mask,
                                                      causal, widened=True)
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
    return {
        "out": _hold(f"{name} out", _rounded_errors(
            got[0], out, tol, sq_terms, sk)),
        "out_bf16_plain": _hold(f"{name} out (bf16 plain)", _rounded_errors(
            got[0], plain.double(), 2 * tol, sq_terms, sk, factor=2.0)),
        "lse": check_within(f"{name} lse", got[1], lse, tol_lse),
    }


def check_backward_bf16(got: Sequence[torch.Tensor], q, k, v,
                        key_mask: Optional[torch.Tensor], out, lse, g,
                        causal: bool, planted_rows: int = 0
                        ) -> Dict[str, Dict[str, float]]:
    """The bf16 K6's (dq, dk, dv) on bf16 q, k, v, out, g and fp32 lse:
    each against the fp64 plain backward on the same inputs ("dq", ...) and
    the bf16 plain backward ("dq_bf16_plain", ...). With
    ``planted_rows``, also :func:`reject_planted_bf16` on dk less the
    contribution of its first ``planted_rows`` queries."""
    mask = _mask(key_mask, k)
    args = [t.double() for t in (q, k, v)]
    rest = [t.double() for t in (out, lse, g)]
    want, tols, (p, ds, t_ds, e_p) = _backward_bounds(
        *args, mask, *rest, causal, widened=True)
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
    checks = {}
    for i, (grad, n) in enumerate((("dq", sk + 2 * d), ("dk", sq + 2 * d),
                                   ("dv", sq + 2 * d))):
        if got[i].dtype != torch.bfloat16 or \
                tuple(got[i].shape) != tuple(want[i].shape):
            raise AssertionError(f"{name} {grad}: {got[i].dtype} "
                                 f"{tuple(got[i].shape)}")
        tol = _rounded_tol(tols[i], terms[i], want[i])
        checks[grad] = _hold(f"{name} {grad}", _rounded_errors(
            got[i], want[i], tol, sq_terms[i], n))
        checks[f"{grad}_bf16_plain"] = _hold(
            f"{name} {grad} (bf16 plain)", _rounded_errors(
                got[i], plain[i].double(), 2 * tol, sq_terms[i], n, 2.0))
        if grad == "dk" and planted_rows:
            r = planted_rows
            chunk = att.flash_attention_backward_reference(
                qd[:, :r], kd, args[2], mask, rest[0][:, :r], rest[1][:, :r],
                gd[:, :r], causal)[1]
            checks["dk"]["planted"] = reject_planted_bf16(
                f"{name} dk", got[1], want[1], tol, sq_terms[1], n, chunk)
    return checks


def reject_planted_bf16(name: str, got, want, tol, sq_terms, n: int,
                        chunk: torch.Tensor) -> Dict[str, float]:
    """:func:`reject_planted` for the bf16 checks: the check must reject
    ``got`` less ``chunk`` (one query tile's contribution)."""
    share = worst(_rounded_errors(got.double() - chunk, want, tol, sq_terms,
                                  n))
    if not share > 1:
        raise AssertionError(f"{name}: the check accepts a planted fault "
                             f"(query tile dropped): {share:.3g}")
    return {"query_tile_dropped": share}
