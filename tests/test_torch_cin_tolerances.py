"""The checks that hold the CIN kernels against their plain versions
(``ops/cin_tolerances.py``), run on the CPU with a plain version in the
kernel's place: K4's forward and K3's and K4's backwards with their bf16
emulations, K3's forward with its fp32 plain version. They pass them, also
summed in another order; K4's forward check rejects the fp32 function and
an output missing one f-slice, and the backward checks reject the fp32
function, a dW off by one part in 1000 and a dW missing one chunk of
``ct.PLANTED_ROWS`` rows, the smallest chunk of the weight passes."""

import pytest
import torch

from deep_recommenders_torch.ops import cin_kernels as ck
from deep_recommenders_torch.ops import cin_tolerances as ct

torch.set_num_threads(1)


def _normal(gen, *shape, std=1.0):
    return torch.randn(*shape, generator=gen) * std


def _cin2d_inputs(h, r=4096, f0=6, m=16):
    gen = torch.Generator().manual_seed(h)
    x0 = _normal(gen, r, f0, std=0.25)
    x = _normal(gen, r, h, std=0.25)
    w = _normal(gen, f0, h, m, std=0.05)
    return x0, x, w, _normal(gen, r, m)


def _stack_inputs(b=256, f0=6, d=16, m1=16, m2=24):
    gen = torch.Generator().manual_seed(7)
    x0 = _normal(gen, b * d, f0, std=0.25).to(torch.bfloat16)
    w1 = _normal(gen, f0, f0, m1, std=0.05)
    w2 = _normal(gen, f0, m1, m2, std=0.05)
    return x0, w1, w2, _normal(gen, b, m1), _normal(gen, b, m2), d


@pytest.mark.parametrize("h", [6, 32])
def test_cin2d_bf16_forward_and_fp32_backward_pass_and_planted_faults_fail(h):
    """K4's forward and backward checks pass their bf16 emulations and
    reject the planted faults; the fp32 functions, which the CPU path
    computes, fail the bf16 contract both ways."""
    x0, x, w, g = _cin2d_inputs(h)
    fwd = ct.check_cin2d_forward(ck.cin2d_reference_bf16(x0, x, w), x0, x,
                                 w, planted=True)
    assert fwd["bf16"]["err_over_tol"] == 0.0  # the same plain version
    assert 0 < fwd["fp64"]["err_over_tol"] <= 1
    assert min(fwd["bf16"]["planted"].values()) > 1
    with pytest.raises(AssertionError, match="bf16 terms"):
        ct.check_cin2d_forward(ck.cin2d_forward(x0, x, w), x0, x, w)
    checks = ct.check_cin2d_backward(
        ck.cin2d_backward_reference_bf16(x0, x, w, g), x0, x, w, g,
        planted_rows=ct.PLANTED_ROWS)
    assert {"dx0", "dx", "dw", "dx0_fp64", "dx_fp64", "dw_fp64"} <= set(checks)
    assert checks["dw"]["err_over_tol"] == 0.0
    assert 0 < checks["dw_fp64"]["fro_over_tol"] <= 1
    assert min(checks["planted"].values()) > 1
    with pytest.raises(AssertionError, match="disagrees"):
        ct.check_cin2d_backward(ck.cin2d_backward(x0, x, w, g), x0, x, w, g)


def test_stack_plain_fp32_passes_and_planted_faults_fail():
    """K3's forward check passes its fp32 plain version; the backward check
    passes the bf16 emulation, rejects the planted faults, and rejects the
    fp32 backward that the CPU path computes."""
    x0, w1, w2, gp1, gp2, d = _stack_inputs()
    got = ck.stack_forward(x0, w1, w2, d, residuals=True)
    assert set(ct.check_stack_forward(got, x0, w1, w2, d)) == {
        "p1", "p2", "z1", "z2"}
    assert set(ct.check_stack_forward((*got[:2], None, None), x0, w1, w2,
                                      d)) == {"p1", "p2"}
    z1, z2 = got[2], got[3]
    args = (x0, w1, w2, z1, z2, gp1, gp2)
    checks = ct.check_stack_backward(ck.stack_backward_reference_bf16(*args),
                                     *args, planted_rows=ct.PLANTED_ROWS)
    assert ct.worst_share(checks) <= 1
    assert set(checks["planted"]) == {
        "fp32", "dw1_scaled_1e-3", "dw1_chunk_dropped", "dw2_scaled_1e-3",
        "dw2_chunk_dropped"}
    assert min(checks["planted"].values()) > 1
    with pytest.raises(AssertionError, match="disagrees"):
        ct.check_stack_backward(ck.stack_backward(*args), *args)


def _reordered(inv, outputs):
    """Undo the permutations of the axes of each output: ``inv[i]`` maps an
    axis of output i to its inverse permutation."""
    out = []
    for t, axes in zip(outputs, inv):
        for dim, p in axes.items():
            t = t.index_select(dim, p)
        out.append(t)
    return out


@pytest.mark.parametrize("h", [6, 32])
def test_cin2d_backward_check_passes_another_summation_order(h):
    """The emulation with M and the rows permuted sums t_f and dW in other
    orders; its (dx0, dx, dW) pass the check, with dW off the emulation."""
    x0, x, w, g = _cin2d_inputs(h)
    gen = torch.Generator().manual_seed(11)
    pm = torch.randperm(w.shape[2], generator=gen)
    pr = torch.randperm(x0.shape[0], generator=gen)
    got = ck.cin2d_backward_reference_bf16(x0[pr], x[pr], w[:, :, pm],
                                           g[pr][:, pm])
    rows = torch.argsort(pr)
    got = _reordered(({0: rows}, {0: rows}, {2: torch.argsort(pm)}),
                     got)
    checks = ct.check_cin2d_backward(got, x0, x, w, g)
    assert 0 < checks["dw"]["rel_fro_err"]
    assert ct.worst_share(checks) <= 1


def test_stack_backward_check_passes_another_summation_order():
    """The emulation with M1 and M2 permuted sums t_f, dz1, dy and dx0 in
    other orders, so some rounded intermediates round to the other
    neighbour; its outputs pass the check."""
    x0, w1, w2, gp1, gp2, d = _stack_inputs(m1=64, m2=48)
    _, _, z1, z2 = ck.stack_forward_reference(x0, w1, w2, d)
    gen = torch.Generator().manual_seed(12)
    p1 = torch.randperm(w1.shape[2], generator=gen)
    p2 = torch.randperm(w2.shape[2], generator=gen)
    got = ck.stack_backward_reference_bf16(
        x0, w1[:, :, p1], w2[:, p1][:, :, p2], z1[:, p1], z2[:, p2],
        gp1[:, p1], gp2[:, p2])
    i1, i2 = torch.argsort(p1), torch.argsort(p2)
    got = _reordered(({}, {2: i1}, {1: i1, 2: i2}), got)
    args = (x0, w1, w2, z1, z2, gp1, gp2)
    checks = ct.check_stack_backward(got, *args)
    assert ct.worst_share(checks) <= 1
    want = ck.stack_backward_reference_bf16(*args)
    assert not torch.equal(got[1], want[1])  # dW1 from flipped g1b values


def test_weight_grad_check_is_tighter_than_the_worst_case_sum():
    """The element-wise 3 (n + 2) u sum|terms| bound over 131,072 rows
    passes dW * (1 + 1e-3); the Frobenius limit does not."""
    gen = torch.Generator().manual_seed(3)
    r, q, m = 131072, 4, 8
    a, g = _normal(gen, r, q), _normal(gen, r, m)
    bound = ct.sum_bound(lambda c, x: c.T @ x, a.double(), ct.exact(g), r)
    got = (a.T @ g) * (1 + 1e-3)
    errors = ct.bound_errors(got, bound.val, bound)
    assert errors["err_over_tol"] < 1 < errors["fro_over_tol"]
    with pytest.raises(AssertionError, match="disagrees"):
        ct.hold("dW", errors)
    assert ct.worst(ct.bound_errors(a.T @ g, bound.val, bound)) <= 1


def test_check_within_rejects_nonfinite_shape_and_excess():
    want = torch.ones(3, 2)
    tol = torch.full((3, 2), 1e-3)
    # 1 + 5e-4 rounds to fp32: within 2^-24 of it.
    assert ct.check_within("x", want + 5e-4, want, tol)["err_over_tol"] == \
        pytest.approx(0.5, abs=1e-4)
    for bad in (want + 2e-3, want.clone().fill_(float("nan")), want[:2]):
        with pytest.raises(AssertionError):
            ct.check_within("x", bad, want, tol)


def test_rounding_bound_flags_only_values_near_a_boundary():
    """bf16 has 8 significant bits: 1 + 2^-8 lies on a rounding boundary
    between 1 and 1 + 2^-7, 1 + 2^-9 does not."""
    val = torch.tensor([1 + 2**-8, 1 + 2**-9], dtype=torch.float64)
    b = ct._round(ct.Bound(val, torch.full_like(val, 1e-6),
                           torch.full_like(val, 1e-14)), False)
    assert b.e[0] == 1e-6 + 2**-7 and b.e[1] == 0 and b.v[1] == 0
    assert torch.equal(ct.spacing(torch.tensor([1.0, 3.0, 0.0],
                                               dtype=torch.float64)),
                       torch.tensor([2**-7, 2**-6, 0.0],
                                    dtype=torch.float64))
