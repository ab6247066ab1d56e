"""The checks that hold the CIN kernels against their plain versions
(``ops/cin_tolerances.py``), run on the CPU with a plain version in the
kernel's place: K4's forward with its bf16 emulation, every other output
with its fp32 plain version. They pass them; K4's forward check rejects the
fp32 function and an output missing one f-slice, and the weight-gradient
check rejects a dW off by one part in 1000 or missing one chunk of 256
rows."""

import pytest
import torch

from deep_recommenders_torch.ops import cin_kernels as ck
from deep_recommenders_torch.ops import cin_tolerances as ct

torch.set_num_threads(1)


def _normal(gen, *shape, std=1.0):
    return torch.randn(*shape, generator=gen) * std


@pytest.mark.parametrize("h", [6, 32])
def test_cin2d_bf16_forward_and_fp32_backward_pass_and_planted_faults_fail(h):
    gen = torch.Generator().manual_seed(h)
    r, f0, m = 4096, 6, 16
    x0 = _normal(gen, r, f0, std=0.25)
    x = _normal(gen, r, h, std=0.25)
    w = _normal(gen, f0, h, m, std=0.05)
    g = _normal(gen, r, m)
    fwd = ct.check_cin2d_forward(ck.cin2d_reference_bf16(x0, x, w), x0, x,
                                 w, planted=True)
    assert fwd["bf16"]["err_over_tol"] == 0.0  # the same plain version
    assert 0 < fwd["fp64"]["err_over_tol"] <= 1
    assert min(fwd["bf16"]["planted"].values()) > 1
    # The fp32 function is what the CPU path computes; the bf16 contract
    # rejects it.
    with pytest.raises(AssertionError, match="bf16 terms"):
        ct.check_cin2d_forward(ck.cin2d_forward(x0, x, w), x0, x, w)
    checks = ct.check_cin2d_backward(ck.cin2d_backward(x0, x, w, g), x0, x,
                                     w, g, planted_rows=256)
    assert set(checks) == {"dx0", "dx", "dw"}
    assert ct.worst_share(checks) <= 1
    assert checks["dw"]["rel_fro_err"] > 0  # fp32 against fp64
    assert min(checks["dw"]["planted"].values()) > 1


def test_stack_plain_fp32_passes_and_planted_faults_fail():
    gen = torch.Generator().manual_seed(7)
    b, f0, d, m1, m2 = 256, 6, 16, 16, 24
    x0 = _normal(gen, b * d, f0, std=0.25).to(torch.bfloat16)
    w1 = _normal(gen, f0, f0, m1, std=0.05)
    w2 = _normal(gen, f0, m1, m2, std=0.05)
    gp1, gp2 = _normal(gen, b, m1), _normal(gen, b, m2)
    got = ck.stack_forward(x0, w1, w2, d, residuals=True)
    assert set(ct.check_stack_forward(got, x0, w1, w2, d)) == {
        "p1", "p2", "z1", "z2"}
    assert set(ct.check_stack_forward((*got[:2], None, None), x0, w1, w2,
                                      d)) == {"p1", "p2"}
    z1, z2 = got[2], got[3]
    grads = ck.stack_backward(x0, w1, w2, z1, z2, gp1, gp2)
    checks = ct.check_stack_backward(grads, x0, w1, w2, z1, z2, gp1, gp2,
                                     planted_rows=256)
    assert ct.worst_share(checks) <= 1
    for out in ("dw1", "dw2"):
        assert min(checks[out]["planted"].values()) > 1


def test_weight_grad_check_is_tighter_than_the_worst_case_sum():
    """The element-wise (n + 3) u sum|terms| bound over 131,072 rows passes
    dW * (1 + 1e-3); the Frobenius limit does not."""
    gen = torch.Generator().manual_seed(3)
    r, q, m = 131072, 4, 8
    a, g = _normal(gen, r, q), _normal(gen, r, m)
    want = a.double().T @ g.double()
    sum_abs = a.double().abs().T @ g.double().abs()
    got = (a.T @ g) * (1 + 1e-3)
    errors = ct.weight_grad_errors(got, want, sum_abs, r)
    assert errors["err_over_tol"] < 1 < errors["fro_over_tol"]
    with pytest.raises(AssertionError, match="disagrees"):
        ct.check_weight_grad("dW", got, want, sum_abs, r)


def test_check_within_rejects_nonfinite_shape_and_excess():
    want = torch.ones(3, 2)
    tol = torch.full((3, 2), 1e-3)
    # 1 + 5e-4 rounds to fp32: within 2^-24 of it.
    assert ct.check_within("x", want + 5e-4, want, tol)["err_over_tol"] == \
        pytest.approx(0.5, abs=1e-4)
    for bad in (want + 2e-3, want.clone().fill_(float("nan")), want[:2]):
        with pytest.raises(AssertionError):
            ct.check_within("x", bad, want, tol)
