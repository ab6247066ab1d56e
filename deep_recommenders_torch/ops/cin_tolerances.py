"""How far the CIN kernels (K3, K4) may lie from their plain versions.

``chip_smoke.py`` and the card tests hold every output of ``cin2d`` and
``cin_stack_pooled`` against the plain versions in ``ops/cin_kernels.py``
with these checks. Each returns, per output, its largest error and its
largest share of the tolerance, and raises ``AssertionError`` where an
output is not finite or lies outside its tolerance.

Element-wise bounds. Each output element is a sum of products. One fp32
evaluation of a sum of n products, in any order, lies within
(n + 2) u sum|terms| of the exact value (u = 2^-24); the tensor cores'
fp32 accumulation may truncate instead of rounding, so a kernel's side
takes 2 u per addition, and a kernel and a plain version lie within
3 (n + 2) u sum|terms| of each other. relu moves no value farther than its
input moved, so a bound carries through it.

- K4's forward rounds as the TPU kernel does (bf16 operands and pair
  products, fp32 sums) and is held two ways; see
  :func:`check_cin2d_forward`.
- K3's forward and K3's and K4's backwards round as the TPU kernels do
  (``stack_forward_reference_bf16``, ``cin2d_backward_reference_bf16``,
  ``stack_backward_reference_bf16``) and are held two ways (the backwards
  on the same saved residuals and incoming gradients as their plain
  versions, so both use the same relu masks): against the bf16 emulation
  ("bf16") and against fp64 of the fp32 function ("fp64").
  :func:`_stack_forward_bounds`, :func:`_cin2d_backward_bounds` and
  :func:`_stack_backward_bounds` follow the contract step by step and
  carry, for every quantity, a bound e on its distance that holds for any
  rounding and a variance v of that distance under random rounding
  (:class:`Bound`):
  - a sum of n terms adds 3 (n + 2) u sum|terms| to e and, under random
    rounding (each rounding independent, mean zero, at most u of its
    result; Higham and Mary, SIAM J. Sci. Comput. 41(5), 2019),
    2 u^2 (n + 4) (sum terms^2 + sum^2) to v;
  - against fp64, each bf16 rounding of an input, a weight or an
    intermediate moves a value by at most u_b = 2^-8 of it (u_b^2 of its
    square in v);
  - against the emulation the same inputs round the same way, but an
    intermediate that the contract rounds (K3's z1b, z2b and
    bf16(x0b z1b) forward; bf16(t_f), g1b, bf16(dy), bf16(dy + bf16(dy^T)),
    the products with x0b and z1b, dx0 backward) may round
    to the other neighbour where its two fp32 values straddle a rounding
    boundary: only where a boundary lies within e of it, and then by at
    most e plus one bf16 spacing s. Under random rounding a value that
    is off by about d = sqrt(v) crosses a boundary with probability d / s,
    so its variance is at most d (s + 4 d).
  K4's terms and K3's dW2 are exact products of rounded operands, so
  their bounds against the emulation are the fp32 ones, sharp.

Gradients as a whole. dW sums over every row, n = R = 131,072 at full
width. Its terms have random signs and cancel, so a typical |dW| is near
sum|terms| / sqrt(R), below the element-wise bound. That bound holds for
any summation order but cannot see a wrong dW. So each output of K3's
forward and of the backwards is also held to a Frobenius error of at most 2 sqrt(sum v), plus one bf16
spacing for an output that is rounded (a lone flip). Without
intermediate roundings this is 4 u sqrt(n + 4) ||exact|| for terms of
random sign, 8.6e-5 of ||dW|| at n = 131,072; against fp64 the bf16
roundings of each term add about 2 u_b sqrt(k sum terms^2) for k
roundings. A dW off by one part in 1000, one that misses a chunk of
:data:`PLANTED_ROWS` rows (the smallest chunk the kernels' weight passes
sum), and the fp32 function fail the checks: ``planted`` shows it on the
run's own data.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import torch

from deep_recommenders_torch.ops import cin_kernels as ck

U32 = 2.0**-24  # unit roundoff of float32
UBF16 = 2.0**-8  # unit roundoff of bfloat16
_TINY = torch.finfo(torch.float64).tiny
# The rows of the smallest chunk of a weight pass: a planted fault drops
# the first PLANTED_ROWS rows.
PLANTED_ROWS = ck.weight_pass_plan(1)[1]


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


def worst(errors: Dict[str, float]) -> float:
    """The largest share of a tolerance in one output's errors."""
    if not errors["finite"]:
        return math.inf
    return max(errors["err_over_tol"], errors["fro_over_tol"])


def _pooled(z: torch.Tensor, d: int) -> torch.Tensor:
    return z.reshape(-1, d, z.shape[1]).sum(dim=1)


def _double(*tensors: torch.Tensor):
    return [t.double() for t in tensors]


# -- bounds that follow a computation step by step -----------------------------

class Bound(NamedTuple):
    """A quantity of a kernel's computation, fp64: its reference value, a
    bound ``e`` on the kernel's distance from it that holds for any
    rounding, and that distance's variance ``v`` under random rounding."""
    val: torch.Tensor
    e: torch.Tensor
    v: torch.Tensor

    def map(self, fn: Callable) -> "Bound":
        return Bound(fn(self.val), fn(self.e), fn(self.v))


def exact(x: torch.Tensor) -> Bound:
    """A value both sides read exactly."""
    x = x.double()
    zero = torch.zeros_like(x)
    return Bound(x, zero, zero)


def _input(x: torch.Tensor, vs_fp64: bool) -> Bound:
    """bf16(x), read by both sides: exact against the emulation, within
    u_b |x| of x against fp64."""
    if not vs_fp64:
        return exact(x.bfloat16())
    x = x.double()
    return Bound(x, UBF16 * x.abs(), UBF16**2 * x.square())


def _coef(w: torch.Tensor, vs_fp64: bool) -> torch.Tensor:
    """The kernel's bf16(w) as a coefficient: w itself against fp64 (its
    rounding counted by :func:`sum_bound`'s ``c_rounds``)."""
    return w.double() if vs_fp64 else w.bfloat16().double()


def sum_bound(fn: Callable, c: torch.Tensor, x: Bound, n: int,
              c_rounds: int = 0) -> Bound:
    """y = fn(c, x): per element an fp32 sum of n terms c x, fn linear in
    each argument. Each coefficient carries ``c_rounds`` bf16 roundings
    (against fp64)."""
    val = fn(c, x.val)
    ca, c2 = c.abs(), c.square()
    terms = fn(ca, x.val.abs() + x.e)
    sq = fn(c2, x.val.square())
    rel = (1 + UBF16)**c_rounds - 1
    e = (fn(ca, x.e) * (1 + rel) + rel * terms
         + 3 * (n + 2) * U32 * (1 + rel) * terms)
    v = (fn(c2, x.v) + c_rounds * UBF16**2 * sq
         + 2 * U32**2 * (n + 4) * (sq + val.square()))
    return Bound(val, e, v)


def _add(parts: Sequence[Bound]) -> Bound:
    """The fp32 sum of a few quantities, element by element."""
    n = len(parts)
    val = sum(p.val for p in parts)
    terms = sum(p.val.abs() + p.e for p in parts)
    sq = sum(p.val.square() for p in parts)
    return Bound(val,
                 sum(p.e for p in parts) + 3 * (n + 2) * U32 * terms,
                 sum(p.v for p in parts)
                 + 2 * U32**2 * (n + 4) * (sq + val.square()))


def _scale(c: torch.Tensor, x: Bound) -> Bound:
    """c x for a coefficient both sides hold exactly."""
    return Bound(c * x.val, c.abs() * x.e, c.square() * x.v)


def _mul(a: Bound, b: Bound) -> Bound:
    """a b, exact before any rounding."""
    return Bound(a.val * b.val,
                 a.val.abs() * b.e + b.val.abs() * a.e + a.e * b.e,
                 a.val.square() * b.v + b.val.square() * a.v)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.float().bfloat16().double()


def spacing(a: torch.Tensor) -> torch.Tensor:
    """The bf16 spacing at |a| (a >= 0, fp64): 2^(floor(log2 a) - 7)."""
    _, ex = torch.frexp(a)
    return torch.where(a > 0, torch.ldexp(torch.ones_like(a), ex - 8), 0.0)


def _round(x: Bound, vs_fp64: bool) -> Bound:
    """bf16(x), rounded to nearest even by both sides (see the module's
    docstring)."""
    if vs_fp64:
        return Bound(x.val, x.e + UBF16 * (x.val.abs() + x.e),
                     x.v + UBF16**2 * x.val.square())
    # fp64 -> fp32 -> bf16 may round twice: widen by one fp32 step.
    reach = x.e + 2 * U32 * x.val.abs()
    flips = _bf16(x.val - reach) != _bf16(x.val + reach)
    s = spacing(x.val.abs() + reach)
    d = x.v.sqrt()
    return Bound(_bf16(x.val), torch.where(flips, x.e + s, 0.0),
                 torch.where(flips, d * (s + 4 * d), 0.0))


def _stack(parts: Sequence[Bound], dim: int) -> Bound:
    return Bound(*(torch.stack([p[i] for p in parts], dim)
                   for i in range(3)))


def bound_errors(got: torch.Tensor, want: torch.Tensor, b: Bound,
                 rounded: bool = False) -> Dict[str, float]:
    """``got`` against ``want``: the element-wise share of ``b.e`` and the
    Frobenius error against 2 sqrt(sum ``b.v``), plus one bf16 spacing of
    the largest |want| for a ``rounded`` output. Raises nothing."""
    if tuple(got.shape) != tuple(want.shape):
        raise AssertionError(f"shape {tuple(got.shape)}, expected "
                             f"{tuple(want.shape)}")
    want = want.double()
    err = (got.double() - want).abs()
    fro = err.norm().item()
    fro_tol = 2 * math.sqrt(b.v.sum().item())
    if rounded:
        fro_tol += spacing(want.abs().max()).item()
    norm = max(want.norm().item(), _TINY)
    return {
        "max_abs_err": err.max().item(),
        "tolerance": b.e.max().item(),
        "err_over_tol": (err / b.e.clamp_min(_TINY)).max().item(),
        "rel_fro_err": fro / norm,
        "rel_fro_tol": fro_tol / norm,
        "fro_over_tol": fro / max(fro_tol, _TINY),
        "finite": bool(torch.isfinite(got).all()),
    }


def hold(name: str, errors: Dict[str, float]) -> Dict[str, float]:
    """Raise if ``errors`` exceed either tolerance; else return them."""
    if worst(errors) > 1:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{errors}")
    return {k: v for k, v in errors.items() if k != "finite"}


def _check_two_ways(name: str, got, sides, rounded, faults
                    ) -> Dict[str, Dict[str, float]]:
    """Holds each output of ``got`` to both ``sides`` ({"bf16": (wants,
    bounds), "fp64": ...}); with ``faults`` ({fault: outputs}), each fault
    must fail one of them. A fault's outputs may be None where it leaves
    that output alone. Returns {output: errors} for the bf16 side,
    {output + "_fp64": errors} for the other, and the faults' largest
    shares under "planted"."""
    checks = {}
    for side, (wants, bounds) in sides.items():
        for (out, g), want, b in zip(got.items(), wants, bounds):
            key = out if side == "bf16" else f"{out}_fp64"
            checks[key] = hold(f"{name} {out} ({side})", bound_errors(
                g, want, b, out in rounded))
    if faults:
        shares = {}
        for fault, outs in faults.items():
            shares[fault] = max(
                worst(bound_errors(bad, want, b, out in rounded))
                for (wants, bounds) in sides.values()
                for out, bad, want, b in zip(got, outs, wants, bounds)
                if bad is not None)
            if not shares[fault] > 1:
                raise AssertionError(f"{name}: the check accepts a planted "
                                     f"fault ({fault}): {shares[fault]:.3g}")
        checks["planted"] = shares
    return checks


def _weight_faults(got, dws, chunks, fp32):
    """The planted faults of a backward: each weight gradient of ``dws``
    ({name: index into ``got``}) scaled by 1 + 1e-3 and less ``chunks``'
    gradient of its first chunk of rows, and the fp32 function's
    outputs."""
    faults = {"fp32": fp32}
    for name, i in dws.items():
        for fault, bad in (("scaled_1e-3", got[i] * (1 + 1e-3)),
                           ("chunk_dropped", got[i].double() - chunks[i])):
            outs = [None] * len(got)
            outs[i] = bad
            faults[f"{name}_{fault}"] = outs
    return faults


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
    _no_tf32("check_cin2d_forward", x0v)
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


def _no_tf32(name: str, t: torch.Tensor) -> None:
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(f"{name} needs fp32 products without TF32 "
                           "(torch.backends.cuda.matmul.allow_tf32)")


def _cin2d_backward_bounds(x0v, xv, w, g, vs_fp64: bool):
    """Bounds of K4's (dx0, dx, dW) following
    :func:`cin2d_backward_reference_bf16`: against the emulation, or with
    ``vs_fp64`` against the fp32 function in fp64."""
    r, f0 = x0v.shape
    h, m = xv.shape[1], w.shape[2]
    x0, x = x0v.double(), xv.double()
    k = int(vs_fp64)
    gb = _input(g, vs_fp64)
    ts = [sum_bound(lambda c, a: a @ c.T, _coef(w[f], vs_fp64), gb, m, k)
          for f in range(f0)]
    dx = _add([_scale(x0[:, f:f + 1], t) for f, t in enumerate(ts)])
    dx0 = _stack([sum_bound(lambda c, a: (c * a).sum(1), x, t, h)
                  for t in ts], 1)
    del ts
    if vs_fp64:  # x0v, xv and their product: three roundings a term
        pair = (x0[:, :, None] * x[:, None, :]).reshape(r, -1)
    else:
        pair = (x0v.bfloat16()[:, :, None] * xv.bfloat16()[:, None, :])
        pair = pair.double().reshape(r, -1)
    dw = sum_bound(lambda c, a: c.T @ a, pair, gb, r, 3 * k)
    return dx0, dx, dw.map(lambda t: t.reshape(f0, h, m))


def check_cin2d_backward(got: Sequence[torch.Tensor], x0v, xv, w, g,
                         planted_rows: int = 0
                         ) -> Dict[str, Dict[str, float]]:
    """K4's (dx0, dx, dW) against :func:`cin2d_backward_reference_bf16` and
    against fp64 of the fp32 function, with the bounds of the module's
    docstring. With ``planted_rows``, the check must also reject dW scaled
    by 1 + 1e-3, dW less the gradient of its first ``planted_rows`` rows,
    and the fp32 function (``cin2d_backward_reference``). On the card the
    plain versions must run without TF32."""
    _no_tf32("check_cin2d_backward", x0v)
    name = f"cin2d backward H={xv.shape[1]}"
    b16 = _cin2d_backward_bounds(x0v, xv, w, g, False)
    b64 = _cin2d_backward_bounds(x0v, xv, w, g, True)
    sides = {"bf16": (ck.cin2d_backward_reference_bf16(x0v, xv, w, g), b16),
             "fp64": ([b.val for b in b64], b64)}
    faults = None
    if planted_rows:
        rows = [t[:planted_rows].double() for t in (x0v, xv, g)]
        chunk = ck.cin2d_backward_reference(rows[0], rows[1], w.double(),
                                            rows[2])
        faults = _weight_faults(got, {"dw": 2}, chunk,
                                ck.cin2d_backward_reference(x0v, xv, w, g))
    return _check_two_ways(name, dict(zip(("dx0", "dx", "dw"), got)),
                           sides, (), faults)


# -- K3 -----------------------------------------------------------------------

def _relu(x: Bound) -> Bound:
    """relu(x): it moves no value farther than its input moved."""
    return Bound(torch.relu(x.val), x.e, x.v)


def _stack_forward_bounds(x0v, w1, w2, d: int, vs_fp64: bool):
    """Bounds of K3's (p1, p2, z1b, z2b) following
    :func:`stack_forward_reference_bf16`: against the emulation, or with
    ``vs_fp64`` against the fp32 function in fp64."""
    r, f0 = x0v.shape
    m1 = w1.shape[2]
    k = int(vs_fp64)
    x0 = x0v.double()  # bf16 on both sides
    one = torch.ones((), dtype=torch.float64, device=x0.device)
    pair = x0[:, :, None] * x0[:, None, :]
    if not vs_fp64:
        pair = _bf16(pair)
    # Against fp64, W1 and the pair product: two roundings a term.
    z1 = _relu(sum_bound(lambda c, a: a @ c, _coef(w1.reshape(-1, m1),
                                                     vs_fp64),
                         exact(pair.reshape(r, -1)), f0 * f0, 2 * k))
    del pair
    p1 = sum_bound(lambda c, a: _pooled(c * a, d), one, z1, d)
    z1b = _round(z1, vs_fp64)
    del z1
    # Layer 2's operand bf16(x0b[:, f] z1b), (R, F0, M1): a flip of z1b
    # carries into it.
    q = _round(_scale(x0[:, :, None], z1b.map(lambda t: t[:, None, :])),
               vs_fp64)
    z2 = _relu(sum_bound(lambda c, a: a.reshape(r, -1) @ c,
                         _coef(w2.reshape(-1, w2.shape[2]), vs_fp64), q,
                         f0 * m1, k))
    del q
    p2 = sum_bound(lambda c, a: _pooled(c * a, d), one, z2, d)
    return p1, p2, z1b, _round(z2, vs_fp64)


def check_stack_forward(got: Sequence[Optional[torch.Tensor]], x0v, w1, w2,
                        d: int, planted: bool = False
                        ) -> Dict[str, Dict[str, float]]:
    """K3's (p1, p2, z1, z2) against :func:`stack_forward_reference_bf16`
    and against fp64 of the fp32 function, with the bounds of the module's
    docstring; z1 and z2 (bf16) are skipped where ``got`` holds None (no
    residuals). A z1 or z2 element may round to the other bf16 neighbour
    than the emulation's only where a rounding boundary lies within the
    fp32 summation bound of it, and a flip of z1 widens layer 2's bound
    only where it reaches. With ``planted``, the check must also reject
    the fp32 function (``stack_forward_reference``), the emulation without
    W2's first f-slice, with z1 left unrounded before layer 2, and with W1
    and W2 scaled by 1 + 1e-3; each one's largest share goes under
    "planted". On the card the plain versions must run without TF32."""
    _no_tf32("check_stack_forward", x0v)
    names = ("p1", "p2", "z1", "z2")
    keep = [i for i, g in enumerate(got) if g is not None]
    b16 = _stack_forward_bounds(x0v, w1, w2, d, False)
    b64 = _stack_forward_bounds(x0v, w1, w2, d, True)
    wants = ck.stack_forward_reference_bf16(x0v, w1, w2, d)
    sides = {"bf16": ([wants[i] for i in keep], [b16[i] for i in keep]),
             "fp64": ([b64[i].val for i in keep], [b64[i] for i in keep])}
    faults = None
    if planted:
        w2_cut = w2.clone()
        w2_cut[0] = 0
        scale = 1 + 1e-3
        faults = {
            fault: [outs[i] for i in keep] for fault, outs in (
                ("fp32", ck.stack_forward_reference(x0v, w1, w2, d)),
                ("w2_f_slice_dropped", ck.stack_forward_reference_bf16(
                    x0v, w1, w2_cut, d)),
                ("z1_unrounded", ck._stack_forward_bf16(
                    x0v, w1, w2, d, round_z1=False)),
                ("w_scaled_1e-3", ck.stack_forward_reference_bf16(
                    x0v, w1 * scale, w2 * scale, d)))}
    return _check_two_ways("cin_stack_pooled forward",
                           {names[i]: got[i] for i in keep}, sides,
                           ("z1", "z2"), faults)


def _stack_backward_bounds(x0v, w1, w2, z1, z2, gp1, gp2, vs_fp64: bool):
    """Bounds of K3's (dx0, dW1, dW2) following
    :func:`stack_backward_reference_bf16`: against the emulation, or with
    ``vs_fp64`` against the fp32 function in fp64."""
    r, f0 = x0v.shape
    d = r // gp1.shape[0]
    m1, m2 = w1.shape[2], w2.shape[2]
    k = int(vs_fp64)
    x0 = x0v.double()  # bf16 on both sides
    one = torch.ones((), dtype=torch.float64, device=x0.device)
    g2 = _input(torch.where(z2 > 0, gp2.repeat_interleave(d, dim=0), 0.0),
                vs_fp64)
    z1b = _input(z1, vs_fp64)
    ts = [sum_bound(lambda c, a: a @ c.T, _coef(w2[f], vs_fp64), g2, m2, k)
          for f in range(f0)]
    dz1 = _add([_scale(x0[:, f:f + 1], t) for f, t in enumerate(ts)])
    dx0_2 = _stack([
        sum_bound(lambda c, a: (c * a).sum(1), one,
                  _round(_mul(z1b, _round(t, vs_fp64)), vs_fp64), m1)
        for t in ts], 1)
    del ts
    if vs_fp64:  # z1b and the product: two roundings a term
        pair2 = x0[:, :, None] * z1.double()[:, None, :]
    else:
        pair2 = (x0v.bfloat16()[:, :, None] * z1.bfloat16()[:, None, :])
        pair2 = pair2.double()
    dw2 = _stack([sum_bound(lambda c, a: c.T @ a, pair2[:, f], g2, r, 2 * k)
                  for f in range(f0)], 0)
    del pair2
    mask1 = (z1.bfloat16() != 0).double()
    g1 = _round(_scale(mask1, _add(
        [dz1, exact(gp1.repeat_interleave(d, dim=0))])), vs_fp64)
    del dz1
    if vs_fp64:
        pair1 = (x0[:, :, None] * x0[:, None, :]).reshape(r, -1)
    else:
        pair1 = _bf16(x0[:, :, None] * x0[:, None, :]).reshape(r, -1)
    dw1 = sum_bound(lambda c, a: c.T @ a, pair1, g1, r, k)
    dy = sum_bound(lambda c, a: a @ c.T,
                   _coef(w1.reshape(f0 * f0, m1), vs_fp64), g1, m1, k)
    dy = dy.map(lambda t: t.reshape(r, f0, f0))
    dyt = _round(dy.map(lambda t: t.transpose(1, 2)), vs_fp64)
    sym = _round(_add([dy, dyt]), vs_fp64)
    q = _round(_scale(x0[:, None, :], sym), vs_fp64)
    dx0_1 = sum_bound(lambda c, a: (c * a).sum(2), one, q, f0)
    dx0 = _round(_add([dx0_1, dx0_2]), vs_fp64)
    return dx0, dw1.map(lambda t: t.reshape(f0, f0, m1)), dw2


def check_stack_backward(got: Sequence[torch.Tensor], x0v, w1, w2, z1, z2,
                         gp1, gp2, planted_rows: int = 0
                         ) -> Dict[str, Dict[str, float]]:
    """K3's (dx0 bf16, dW1, dW2) on the residuals z1, z2 against
    :func:`stack_backward_reference_bf16` and against fp64 of the fp32
    function, with the bounds of the module's docstring. With
    ``planted_rows`` (a multiple of d), the check must also reject each dW
    scaled by 1 + 1e-3 and less the gradient of its first ``planted_rows``
    rows, and the fp32 function (``stack_backward_reference``). On the
    card the plain versions must run without TF32."""
    _no_tf32("check_stack_backward", x0v)
    if got[0].dtype != torch.bfloat16:
        raise AssertionError(f"cin_stack_pooled backward: dx0 is "
                             f"{got[0].dtype}, not bfloat16")
    args = (x0v, w1, w2, z1, z2, gp1, gp2)
    b16 = _stack_backward_bounds(*args, False)
    b64 = _stack_backward_bounds(*args, True)
    sides = {"bf16": (ck.stack_backward_reference_bf16(*args), b16),
             "fp64": ([b.val for b in b64], b64)}
    faults = None
    if planted_rows:
        e = planted_rows * gp1.shape[0] // x0v.shape[0]
        rows = [t[:planted_rows] for t in (x0v, z1, z2)]
        chunk = ck.stack_backward_reference(
            rows[0], w1.double(), w2.double(), rows[1].double(),
            rows[2].double(), gp1[:e].double(), gp2[:e].double())
        faults = _weight_faults(got, {"dw1": 1, "dw2": 2}, chunk,
                                ck.stack_backward_reference(*args))
    return _check_two_ways("cin_stack_pooled backward",
                           dict(zip(("dx0", "dw1", "dw2"), got)), sides,
                           ("dx0",), faults)


def worst_share(checks: Dict[str, Dict[str, float]]) -> float:
    """The largest share of a tolerance over every output of ``checks``."""
    return max(max(c["err_over_tol"], c.get("fro_over_tol", 0.0))
               for k, c in checks.items() if k != "planted")


def max_abs_err(checks: Dict[str, Dict[str, float]]) -> float:
    return max(c["max_abs_err"] for k, c in checks.items()
               if k != "planted")
