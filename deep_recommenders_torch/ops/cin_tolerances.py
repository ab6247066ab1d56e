"""How far the CIN kernels (K3, K4) may lie from their plain versions.

``chip_smoke.py`` and the card tests hold every output of ``cin2d`` and
``cin_stack_pooled`` against the plain versions in ``ops/cin_kernels.py``
with these checks. Each returns, per output, its largest error and its
largest share of the tolerance, and raises ``AssertionError`` where an
output is not finite or lies outside its tolerance.

Element-wise bounds. Each output element is a sum of products. One fp32
evaluation of a sum of n products, in any order, lies within
(n + 2) u sum|terms| of the exact value (u = 2^-24), so two fp32
evaluations lie within 2 (n + 2) u sum|terms| of each other. sum|terms|
comes from the plain version run on the absolute values of the inputs.
relu moves no value farther than its input moved, so a bound carries
through it, and a layer's bound carries into the next layer through |x0|
and |W|.

- K3's forward is held against its plain version in fp32.
- K4's forward rounds as the TPU kernel does (bf16 operands and pair
  products, fp32 sums) and is held two ways; see
  :func:`check_cin2d_forward`.
- A backward runs on the same saved residuals and incoming gradients as
  its plain backward, so both use the same relu masks. It is held against
  the plain backward in fp64, whose own error is below 2^-29 of these
  bounds: one more u covers it.

Weight gradients. dW sums over every row, n = R = 131,072 at full width.
Its terms have random signs and cancel, so a typical |dW| is near
sum|terms| / sqrt(R), below the element-wise bound (n + 3) u sum|terms|.
That bound holds for any summation order but cannot see a wrong dW. So dW
is also held, as a whole, to a relative Frobenius error against the fp64
plain version of at most

    4 u sqrt(n + 4).

Under the model of random rounding (each addition's error independent,
mean zero, at most u times its result; Higham and Mary, SIAM J. Sci.
Comput. 41(5), 2019), a sum of n terms in any order has an error of
about u sqrt(n / 6) of the sum for terms of random sign, and u sqrt(n) / 3
for terms of one sign. The limit is 8.6e-5 at n = 131,072. A dW off by
one part in 1000, or one that misses a chunk of 256 rows (the smallest
chunk that the kernels' weight passes sum at full width on 132 SMs),
fails it: ``reject_planted`` shows that on the run's own data.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from deep_recommenders_torch.ops import cin_kernels as ck

U32 = 2.0**-24  # unit roundoff of float32
UBF16 = 2.0**-8  # unit roundoff of bfloat16
_TINY = torch.finfo(torch.float64).tiny


def within_errors(got: torch.Tensor, want: torch.Tensor,
                  tol: torch.Tensor) -> Dict[str, float]:
    """The largest error of ``got`` against ``want`` and its largest share
    of ``tol``, element-wise (inf where ``got`` is not finite). Raises
    nothing."""
    err = (got.double() - want.double()).abs()
    tol = tol.double()
    share = (err / tol.clamp_min(_TINY)).max().item()
    return {
        "max_abs_err": err.max().item(),
        "tolerance": tol.max().item(),
        "err_over_tol": share if bool(torch.isfinite(got).all())
        else math.inf,
    }


def check_within(name: str, got: torch.Tensor, want: torch.Tensor,
                 tol: torch.Tensor) -> Dict[str, float]:
    """Every element of ``got`` within ``tol`` of ``want``, all finite."""
    if tuple(got.shape) != tuple(want.shape):
        raise AssertionError(f"{name}: shape {tuple(got.shape)}, expected "
                             f"{tuple(want.shape)}")
    result = within_errors(got, want, tol)
    if not result["err_over_tol"] <= 1:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{result}")
    return result


def weight_grad_errors(got: torch.Tensor, want: torch.Tensor,
                       sum_abs: torch.Tensor, n: int) -> Dict[str, float]:
    """A weight gradient summed over chains of at most n terms, against its
    plain version ``want`` in fp64: the element-wise share of
    (n + 3) u sum|terms| and the relative Frobenius error against its
    limit 4 u sqrt(n + 4). Raises nothing."""
    err = (got.double() - want).abs()
    tol = (n + 3) * U32 * sum_abs.double()
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


def worst(errors: Dict[str, float]) -> float:
    """The largest share of a tolerance in one output's errors."""
    if not errors["finite"]:
        return math.inf
    return max(errors["err_over_tol"], errors["fro_over_tol"])


def check_weight_grad(name: str, got: torch.Tensor, want: torch.Tensor,
                      sum_abs: torch.Tensor, n: int) -> Dict[str, float]:
    """:func:`weight_grad_errors`, raising if either share exceeds 1."""
    errors = weight_grad_errors(got, want, sum_abs, n)
    if tuple(got.shape) != tuple(want.shape) or worst(errors) > 1:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{errors}")
    del errors["finite"]
    return errors


def reject_planted(name: str, got: torch.Tensor, want: torch.Tensor,
                   sum_abs: torch.Tensor, n: int,
                   chunk: torch.Tensor) -> Dict[str, float]:
    """The weight-gradient check must reject two planted faults: ``got``
    scaled by 1 + 1e-3, and ``got`` less ``chunk``, the plain gradient of
    one chunk of rows. Returns each fault's largest share of a tolerance;
    raises if the check accepts either."""
    faults = {"scaled_1e-3": got * (1 + 1e-3),
              "chunk_dropped": got - chunk.to(got.dtype)}
    shares = {}
    for fault, bad in faults.items():
        shares[fault] = worst(weight_grad_errors(bad, want, sum_abs, n))
        if not shares[fault] > 1:
            raise AssertionError(f"{name}: the check accepts a planted "
                                 f"fault ({fault}): {shares[fault]:.3g}")
    return shares


def _pooled(z: torch.Tensor, d: int) -> torch.Tensor:
    return z.reshape(-1, d, z.shape[1]).sum(dim=1)


def _double(*tensors: torch.Tensor):
    return [t.double() for t in tensors]


# -- K4 -----------------------------------------------------------------------

def check_cin2d_forward(got, x0v, xv, w, planted: bool = False
                        ) -> Dict[str, Dict[str, float]]:
    """K4's forward output, held two ways (n = F0 H terms per output, c = 3):

    - ``bf16``: against :func:`cin2d_reference_bf16`, the same rounded
      terms t' summed in fp32 by the plain version, element-wise within
      c (n + 2) u sum|t'|. The plain version rounds each addition (u); the
      tensor cores' fp32 accumulation may truncate instead of rounding, so
      the kernel's side takes 2 u per addition: c = 3.
    - ``fp64``: against :func:`cin2d_reference` in fp64, whose own error is
      negligible here, within ((1 + u_bf16)^4 - 1 + c (n + 2) u) sum|t|:
      four bf16 roundings per term (x0v, xv, their product, w) and the
      kernel's sum (sum|t'| <= (1 + u_bf16)^4 sum|t|, below 3/2 sum|t|).

    With ``planted``, the check must also reject two planted outputs: the
    fp32 function (``cin2d_reference``) and the emulation without its first
    f-slice. Each one's largest share of either tolerance goes into
    ``checks["bf16"]["planted"]``; raises if either share is not above 1.
    On the card the plain versions must run without TF32.
    """
    if x0v.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("check_cin2d_forward needs fp32 products without "
                           "TF32 (torch.backends.cuda.matmul.allow_tf32)")
    f0, h = x0v.shape[1], xv.shape[1]
    c = 3 * (f0 * h + 2) * U32
    name = f"cin2d forward H={h}"
    want = ck.cin2d_reference_bf16(x0v, xv, w)
    tol = c * ck.cin2d_reference_bf16(x0v.abs(), xv.abs(), w.abs())
    args = _double(x0v, xv, w)
    want64 = ck.cin2d_reference(*args)
    tol64 = ((1 + UBF16)**4 - 1 + c) * ck.cin2d_reference(
        *[a.abs() for a in args])
    checks = {"bf16": check_within(f"{name} (bf16 terms)", got, want, tol),
              "fp64": check_within(f"{name} (fp64)", got, want64, tol64)}
    if planted:
        faults = {"fp32": ck.cin2d_reference(x0v, xv, w),
                  "f_slice_dropped": ck.cin2d_reference_bf16(
                      x0v[:, 1:], xv, w[1:])}
        shares = {}
        for fault, bad in faults.items():
            shares[fault] = max(
                within_errors(bad, want, tol)["err_over_tol"],
                within_errors(bad, want64, tol64)["err_over_tol"])
            if not shares[fault] > 1:
                raise AssertionError(f"{name}: the check accepts a planted "
                                     f"fault ({fault}): {shares[fault]:.3g}")
        checks["bf16"]["planted"] = shares
    return checks


def check_cin2d_backward(got: Sequence[torch.Tensor], x0v, xv, w, g,
                         planted_rows: int = 0
                         ) -> Dict[str, Dict[str, float]]:
    """K4's (dx0, dx, dW) against the plain backward in fp64. With
    ``planted_rows``, also :func:`reject_planted` on dW, dropping its
    first ``planted_rows`` rows."""
    r, f0 = x0v.shape
    h, m = xv.shape[1], w.shape[2]
    args = _double(x0v, xv, w, g)
    want = ck.cin2d_backward_reference(*args)
    s_dx0, s_dx, s_dw = ck.cin2d_backward_reference(*[a.abs() for a in args])
    name = f"cin2d backward H={h}"
    checks = {
        "dx0": check_within(f"{name} dx0", got[0], want[0],
                            (h + m + 3) * U32 * s_dx0),
        "dx": check_within(f"{name} dx", got[1], want[1],
                           (f0 * m + 3) * U32 * s_dx),
        "dw": check_weight_grad(f"{name} dW", got[2], want[2], s_dw, r),
    }
    if planted_rows:
        chunk = ck.cin2d_backward_reference(
            *[a[:planted_rows] for a in args[:2]], args[2],
            args[3][:planted_rows])[2]
        checks["dw"]["planted"] = reject_planted(
            f"{name} dW", got[2], want[2], s_dw, r, chunk)
    return checks


# -- K3 -----------------------------------------------------------------------

def check_stack_forward(got: Sequence[Optional[torch.Tensor]], x0v, w1, w2,
                        d: int) -> Dict[str, Dict[str, float]]:
    """K3's (p1, p2, z1, z2) against its fp32 plain version; z1 and z2 are
    skipped where ``got`` holds None (no residuals)."""
    f0, m1 = x0v.shape[1], w1.shape[2]
    want = ck.stack_forward_reference(x0v, w1, w2, d)
    z1 = want[2]
    a0, aw1, aw2 = x0v.float().abs(), w1.abs(), w2.abs()
    t1 = 2 * (f0 * f0 + 2) * U32 * ck.cin2d_reference(a0, a0, aw1)
    t2 = (2 * (f0 * m1 + 2) * U32 * ck.cin2d_reference(a0, z1 + t1, aw2)
          + ck.cin2d_reference(a0, t1, aw2))
    tols = (_pooled(t1, d) + 2 * d * U32 * _pooled(z1, d),
            _pooled(t2, d) + 2 * d * U32 * _pooled(want[3], d), t1, t2)
    return {
        n: check_within(f"cin_stack_pooled forward {n}", a, e, t)
        for n, a, e, t in zip(("p1", "p2", "z1", "z2"), got, want, tols)
        if a is not None
    }


def check_stack_backward(got: Sequence[torch.Tensor], x0v, w1, w2, z1, z2,
                         gp1, gp2, planted_rows: int = 0
                         ) -> Dict[str, Dict[str, float]]:
    """K3's (dx0, dW1, dW2) on the residuals z1, z2 against the plain
    backward in fp64. dx0 comes back in bf16: a value within t of the
    exact one rounds to within t + u_bf16 (|exact| + t) of it. With
    ``planted_rows`` (a multiple of d), also :func:`reject_planted` on dW1
    and dW2, dropping their first ``planted_rows`` rows."""
    r, f0 = x0v.shape
    b = gp1.shape[0]
    m1, m2 = w1.shape[2], w2.shape[2]
    args = _double(x0v, w1, w2, z1, z2, gp1, gp2)
    want = ck.stack_backward_reference(*args)
    s_dx0, s_dw1, s_dw2 = ck.stack_backward_reference(
        *[a.abs() for a in args])
    # The longest chain of sums into each output: a row's dx0 sums layer 2
    # over F0 * M2 and layer 1 over F0 * M1; dW1 sums g1 (which carries
    # layer 2's sums) over every row.
    t_dx0 = (f0 * (m1 + m2) + 2 * f0 + 5) * U32 * s_dx0
    n_w = r + f0 * m2 + 4
    name = "cin_stack_pooled backward"
    checks = {
        "dx0": check_within(f"{name} dx0", got[0], want[0],
                            t_dx0 + UBF16 * (want[0].abs() + t_dx0)),
        "dw1": check_weight_grad(f"{name} dW1", got[1], want[1], s_dw1, n_w),
        "dw2": check_weight_grad(f"{name} dW2", got[2], want[2], s_dw2, n_w),
    }
    if planted_rows:
        e = planted_rows * b // r
        rows = [a[:planted_rows] for a in (args[0], args[3], args[4])]
        chunk = ck.stack_backward_reference(
            rows[0], args[1], args[2], rows[1], rows[2], args[5][:e],
            args[6][:e])
        for i, out in ((1, "dw1"), (2, "dw2")):
            checks[out]["planted"] = reject_planted(
                f"{name} {out}", got[i], want[i], (s_dw1, s_dw2)[i - 1], n_w,
                chunk[i])
    return checks


def worst_share(checks: Dict[str, Dict[str, float]]) -> float:
    """The largest share of a tolerance over every output of ``checks``."""
    return max(max(c["err_over_tol"], c.get("fro_over_tol", 0.0))
               for c in checks.values())


def max_abs_err(checks: Dict[str, Dict[str, float]]) -> float:
    return max(c["max_abs_err"] for c in checks.values())
