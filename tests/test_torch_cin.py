"""CIN ops of the PyTorch port against the JAX package: the 3-D layer, the
row layer K4 (``cin2d``) and the fused stack K3 (``cin_stack_pooled``),
forward and backward, and the CIN module's contracts.

Off the TPU the JAX package runs its plain references (``_cin2d_reference``
and the einsum backward; ``_stack_reference`` and its autodiff), and the
port's wrappers take their plain versions on a CPU tensor. Both sides sum
in fp32 in orders of their own, so values agree to fp32 rounding: rtol
1e-5 (atol 1e-5 for entries whose terms cancel). Gradients that sum over
every row get rtol 1e-4. The stack's dx0 comes back in bf16 on both sides,
rounded from fp32 values that differ by rounding, so it may differ by one
bf16 ulp: rtol 2**-7.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from deep_recommenders_torch.models.ranking import CIN
from deep_recommenders_torch.ops import cin as t_cin
from deep_recommenders_torch.ops import cin_kernels as tk
from deep_recommenders_torch.ops import cin_tolerances as ct
from deep_recommenders_tpu.models.ranking import CIN as JCIN
from deep_recommenders_tpu.ops import cin as j_cin
from deep_recommenders_tpu.ops import cin_kernels as jk

torch.set_num_threads(1)

BF16_RTOL = 2.0**-7


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, rtol=1e-5, atol=1e-5, name=""):
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(want, np.float32),
        rtol=rtol, atol=atol, err_msg=name,
    )


@pytest.mark.parametrize("b,f0,f,d,m", [(8, 6, 6, 16, 12), (5, 4, 7, 3, 9)])
def test_cin_interaction_and_fused_match_jax(rng, b, f0, f, d, m):
    x0 = rng.normal(size=(b, f0, d)).astype(np.float32)
    x = rng.normal(size=(b, f, d)).astype(np.float32)
    w = rng.normal(0, 0.2, (f0, f, m)).astype(np.float32)
    want = np.asarray(j_cin.cin_interaction(*map(jnp.asarray, (x0, x, w))))
    want_fused = np.asarray(
        jk.cin_interaction_fused(*map(jnp.asarray, (x0, x, w)))
    )
    for fn in (t_cin.cin_interaction, tk.cin_interaction_fused):
        got = fn(_t(x0), _t(x), _t(w))
        assert got.shape == (b, m, d)
        _close(got, want)
        _close(got, want_fused)


def test_cin_interaction_shape_check():
    with pytest.raises(ValueError):
        t_cin.cin_interaction(torch.ones(2, 3, 4), torch.ones(2, 3, 5),
                              torch.ones(3, 3, 2))


@pytest.mark.parametrize("r,f0,h,m", [(64, 6, 6, 12), (37, 6, 20, 9)])
def test_cin2d_forward_and_grads_match_jax_vjp(rng, r, f0, h, m):
    x0 = rng.normal(size=(r, f0)).astype(np.float32)
    x = rng.normal(size=(r, h)).astype(np.float32)
    w = rng.normal(0, 0.2, (f0, h, m)).astype(np.float32)
    g = rng.normal(size=(r, m)).astype(np.float32)
    want, vjp = jax.vjp(jk.cin2d, *map(jnp.asarray, (x0, x, w)))
    wants = vjp(jnp.asarray(g))

    args = [_t(a).requires_grad_() for a in (x0, x, w)]
    got = tk.cin2d(*args)
    _close(got, want)
    grads = torch.autograd.grad(got, args, _t(g))
    for name, gt, wt in zip(("dx0", "dx", "dw"), grads, wants):
        _close(gt, wt, rtol=1e-4, name=name)
    # The plain backward the card's kernel is held against, called directly.
    for name, gt, wt in zip(
        ("dx0", "dx", "dw"),
        tk.cin2d_backward_reference(*map(_t, (x0, x, w, g))), wants,
    ):
        _close(gt, wt, rtol=1e-4, name=name)


@pytest.mark.parametrize("r,f0,h,m", [(64, 6, 6, 12), (37, 6, 20, 9),
                                     (512, 6, 32, 16)])
def test_cin2d_reference_bf16_matches_the_pallas_kernel(monkeypatch, rng, r,
                                                        f0, h, m):
    """K4's forward on the card computes ``cin2d_reference_bf16``: the TPU
    kernel's roundings (bf16 operands and pair products, fp32 sums). Held
    here against JAX's ``_cin2d_fwd_impl`` through its Pallas body in
    interpret mode. Both sum the same rounded terms t' in fp32 in orders of
    their own: each within (n + 2) u sum|t'| of the exact sum (n = F0 H),
    so 2 (n + 2) u sum|t'| of each other."""
    monkeypatch.setattr(jk, "_on_tpu", lambda: True)
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    x0 = rng.normal(size=(r, f0)).astype(np.float32)
    x = rng.normal(size=(r, h)).astype(np.float32)
    w = rng.normal(0, 0.2, (f0, h, m)).astype(np.float32)
    want = np.asarray(jk._cin2d_fwd_impl(*map(jnp.asarray, (x0, x, w))))
    got = tk.cin2d_reference_bf16(_t(x0), _t(x), _t(w))
    sum_abs = tk.cin2d_reference_bf16(*(_t(np.abs(a)) for a in (x0, x, w)))
    tol = 2 * (f0 * h + 2) * 2.0**-24 * sum_abs.numpy()
    assert got.shape == (r, m)
    assert np.all(np.abs(got.numpy() - want) <= tol)
    # The fp32 function lies farther away: the roundings are what is held.
    fp32 = tk.cin2d_reference(_t(x0), _t(x), _t(w)).numpy()
    assert np.any(np.abs(fp32 - want) > tol)


# The JAX side of the bf16 backward tests: JAX's Pallas bodies of K4's and
# K3's backwards in interpret mode, run in a subprocess under
# --xla_allow_excess_precision=false. XLA on the CPU otherwise may drop the
# bf16 rounding of a product that feeds a dot (K4's pair product), which the
# TPU kernel makes.
_JAX_BWD = r"""
import functools, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from deep_recommenders_tpu.ops import cin_kernels as jk

rng = np.random.default_rng(0)
out = {}
jk._on_tpu = lambda: True
pl.pallas_call = functools.partial(pl.pallas_call, interpret=True)
for i, (r, f0, h, m) in enumerate(%(k4)r):
    a = dict(x0=rng.normal(size=(r, f0)), x=rng.normal(size=(r, h)),
             w=rng.normal(0, 0.2, (f0, h, m)), g=rng.normal(size=(r, m)))
    a = {k: v.astype(np.float32) for k, v in a.items()}
    got = jk._cin2d_bwd(tuple(jnp.asarray(a[k]) for k in ("x0", "x", "w")),
                        jnp.asarray(a["g"]))
    a.update(zip(("dx0", "dx", "dw"), got))
    out.update({f"k4_{i}_{k}": np.asarray(v) for k, v in a.items()})
jk._on_tpu = lambda: False
jk.STACK_INTERPRET = True
for i, (b, f0, d, m1, m2) in enumerate(%(k3)r):
    r = b * d
    x0 = jnp.asarray(rng.normal(0, 0.5, (r, f0)), jnp.bfloat16)
    w1 = jnp.asarray(rng.normal(0, 0.2, (f0, f0, m1)), jnp.float32)
    w2 = jnp.asarray(rng.normal(0, 0.2, (f0, m1, m2)), jnp.float32)
    gp1 = jnp.asarray(rng.normal(size=(b, m1)), jnp.float32)
    gp2 = jnp.asarray(rng.normal(size=(b, m2)), jnp.float32)
    _, _, z1, z2 = jk._stack_fwd_impl(x0, w1, w2, d, want_residuals=True)
    dx0, dw1, dw2 = jk._stack_bwd(d, (x0, w1, w2, z1, z2), (gp1, gp2))
    a = dict(x0=x0, w1=w1, w2=w2, gp1=gp1, gp2=gp2, z1=z1[:r], z2=z2[:r],
             dx0=dx0, dw1=dw1, dw2=dw2)
    out.update({f"k3_{i}_{k}": np.asarray(v.astype(jnp.float32))
                for k, v in a.items()})
np.savez(sys.argv[1], **out)
"""
K4_BWD_SHAPES = [(512, 6, 32, 16), (64, 6, 6, 12), (37, 6, 20, 9)]
K3_BWD_SHAPES = [(8, 6, 16, 64, 48), (16, 6, 8, 12, 20)]


@pytest.fixture(scope="module")
def jax_backwards(tmp_path_factory):
    path = tmp_path_factory.mktemp("cin_bwd") / "jax.npz"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=root,
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    code = _JAX_BWD % {"k4": K4_BWD_SHAPES, "k3": K3_BWD_SHAPES}
    subprocess.run([sys.executable, "-c", code, str(path)], check=True,
                   cwd=root, env=env, timeout=600)
    return dict(np.load(path))


@pytest.mark.parametrize("i", range(len(K4_BWD_SHAPES)))
def test_cin2d_backward_reference_bf16_matches_the_pallas_kernel(
        jax_backwards, i):
    """K4's backward on the card computes ``cin2d_backward_reference_bf16``:
    the TPU kernel's roundings (bf16 g and W, the pair product rounded,
    fp32 x0v and xv in dx0 and dx, fp32 sums). JAX's Pallas body lies
    within the tolerance of ``check_cin2d_backward`` (3 (n + 2) u sum|terms|
    element-wise, 4 u sqrt(n + 4) of ||dW|| as a whole, and the bf16
    roundings' share against fp64); the fp32 function does not."""
    a = {k: _t(jax_backwards[f"k4_{i}_{k}"])
         for k in ("x0", "x", "w", "g", "dx0", "dx", "dw")}
    args = (a["x0"], a["x"], a["w"], a["g"])
    checks = ct.check_cin2d_backward((a["dx0"], a["dx"], a["dw"]), *args,
                                     planted_rows=8)
    assert ct.worst_share(checks) <= 1
    assert checks["planted"]["fp32"] > 1
    with pytest.raises(AssertionError, match="disagrees"):
        ct.check_cin2d_backward(tk.cin2d_backward_reference(*args), *args)


@pytest.mark.parametrize("i", range(len(K3_BWD_SHAPES)))
def test_stack_backward_reference_bf16_matches_the_pallas_kernel(
        jax_backwards, i):
    """K3's backward on the card computes ``stack_backward_reference_bf16``
    on the saved residuals. Fed JAX's own bf16 residuals, JAX's Pallas body
    lies within the tolerance of ``check_stack_backward`` (the fp32 bounds,
    one bf16 spacing where a rounded intermediate may flip, the random-
    rounding bound as a whole); the fp32 function does not."""
    a = {k: _t(jax_backwards[f"k3_{i}_{k}"])
         for k in ("x0", "w1", "w2", "gp1", "gp2", "z1", "z2", "dx0",
                   "dw1", "dw2")}
    d = K3_BWD_SHAPES[i][2]
    args = (a["x0"].bfloat16(), a["w1"], a["w2"], a["z1"], a["z2"],
            a["gp1"], a["gp2"])
    checks = ct.check_stack_backward(
        (a["dx0"].bfloat16(), a["dw1"], a["dw2"]), *args, planted_rows=d)
    assert ct.worst_share(checks) <= 1
    assert checks["planted"]["fp32"] > 1
    with pytest.raises(AssertionError, match="disagrees"):
        ct.check_stack_backward(tk.stack_backward_reference(*args), *args)


@pytest.mark.parametrize("b,f0,d,m1,m2", [(16, 6, 8, 12, 20), (5, 6, 3, 7, 5)])
def test_cin_stack_pooled_matches_jax(rng, b, f0, d, m1, m2):
    """Forward and gradients with a bf16 x0v, as XDeepFM feeds it. The
    second shape has R = 15 rows, not a multiple of 8."""
    x0 = jnp.asarray(rng.normal(size=(b * d, f0)).astype(np.float32),
                     jnp.bfloat16)
    w1 = rng.normal(0, 0.2, (f0, f0, m1)).astype(np.float32)
    w2 = rng.normal(0, 0.2, (f0, m1, m2)).astype(np.float32)
    gp1 = rng.normal(size=(b, m1)).astype(np.float32)
    gp2 = rng.normal(size=(b, m2)).astype(np.float32)
    (jp1, jp2), vjp = jax.vjp(
        lambda a, w_1, w_2: jk.cin_stack_pooled(a, w_1, w_2, d),
        x0, jnp.asarray(w1), jnp.asarray(w2),
    )
    jdx0, jdw1, jdw2 = vjp((jnp.asarray(gp1), jnp.asarray(gp2)))
    assert jdx0.dtype == jnp.bfloat16

    x0v = torch.from_numpy(np.array(x0.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_()
    w1t, w2t = _t(w1).requires_grad_(), _t(w2).requires_grad_()
    p1, p2 = tk.cin_stack_pooled(x0v, w1t, w2t, d)
    assert p1.shape == (b, m1) and p2.shape == (b, m2)
    _close(p1, jp1)
    _close(p2, jp2)
    dx0, dw1, dw2 = torch.autograd.grad((p1, p2), (x0v, w1t, w2t),
                                        (_t(gp1), _t(gp2)))
    assert dx0.dtype == torch.bfloat16
    _close(dx0, jdx0.astype(jnp.float32), rtol=BF16_RTOL, name="dx0")
    _close(dw1, jdw1, rtol=1e-4, name="dw1")
    _close(dw2, jdw2, rtol=1e-4, name="dw2")

    # Without a gradient to take, the forward keeps no residuals and gives
    # the same pooled sums.
    with torch.no_grad():
        q1, q2 = tk.cin_stack_pooled(x0v, w1t, w2t, d)
    torch.testing.assert_close(q1, p1.detach(), rtol=0, atol=0)
    torch.testing.assert_close(q2, p2.detach(), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stack_backward_reference_from_residuals_is_autograd(rng, dtype):
    b, f0, d, m1, m2 = 16, 6, 8, 12, 20
    x0v = torch.from_numpy(rng.normal(size=(b * d, f0)).astype(np.float32))
    x0v = x0v.to(dtype).requires_grad_()
    w1 = _t(rng.normal(0, 0.2, (f0, f0, m1))).requires_grad_()
    w2 = _t(rng.normal(0, 0.2, (f0, m1, m2))).requires_grad_()
    gp1 = _t(rng.normal(size=(b, m1)))
    gp2 = _t(rng.normal(size=(b, m2)))
    p1, p2 = tk.stack_reference(x0v, w1, w2, d)
    want = torch.autograd.grad((p1, p2), (x0v, w1, w2), (gp1, gp2))

    with torch.no_grad():
        _, _, z1, z2 = tk.stack_forward(x0v, w1, w2, d, residuals=True)
        got = tk.stack_backward_reference(x0v, w1, w2, z1, z2, gp1, gp2)
    assert got[0].dtype == dtype
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 1e-5
    for name, g, w in zip(("dx0", "dw1", "dw2"), got, want):
        _close(g, w.float().numpy(), rtol=rtol if name == "dx0" else 1e-5,
               name=name)


def test_stack_rejects_rows_not_whole_examples():
    x0v = torch.zeros(10, 6, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of d"):
        tk.cin_stack_pooled(x0v, torch.zeros(6, 6, 4), torch.zeros(6, 4, 4), 4)


def test_cin_error_contracts():
    """As the JAX CIN's (test_ranking_models.py::test_cin_error_contracts)."""
    layer = CIN(3, 3, feature_map=4)
    x0 = torch.ones(2, 3, 5)
    with pytest.raises(ValueError):
        layer(x0)  # not a tuple
    with pytest.raises(ValueError):
        layer((x0, x0, x0))  # wrong arity
    with pytest.raises(ValueError):
        layer((x0, torch.ones(2, 5)))  # not 3-D
    assert layer((x0, x0)).shape == (2, 4, 5)
    assert layer((torch.ones(10, 3), torch.ones(10, 3))).shape == (10, 4)


@pytest.mark.parametrize("rows_mode", [False, True])
@pytest.mark.parametrize("fused", [True, False])
def test_cin_module_matches_flax(rng, rows_mode, fused):
    """use_bias and a sigmoid activation, in both input modes, with the
    flax kernel and bias copied in."""
    b, f0, f, d, m = 4, 5, 7, 3, 6
    shape0, shape = ((b * d, f0), (b * d, f)) if rows_mode else (
        (b, f0, d), (b, f, d))
    x0 = rng.normal(size=shape0).astype(np.float32)
    x = rng.normal(size=shape).astype(np.float32)
    j_layer = JCIN(feature_map=m, use_bias=True, activation="sigmoid",
                   fused=fused)
    params = j_layer.init(jax.random.PRNGKey(0),
                          (jnp.asarray(x0), jnp.asarray(x)))
    params = jax.tree.map(np.asarray, params)
    params["params"]["bias"] = rng.normal(size=(m,)).astype(np.float32)
    want = j_layer.apply(params, (jnp.asarray(x0), jnp.asarray(x)))

    layer = CIN(f0, f, m, use_bias=True, activation="sigmoid", fused=fused)
    layer.load_state_dict({"kernel": _t(params["params"]["kernel"]),
                           "bias": _t(params["params"]["bias"])})
    _close(layer((_t(x0), _t(x))), want)


def test_cin_initialisation_is_flax_truncated_normal():
    layer = CIN(40, 50, 64, generator=torch.Generator().manual_seed(0))
    w = layer.kernel.detach()
    assert layer.bias is None
    assert w.abs().max().item() <= 0.1
    # A normal of std 0.05 cut at +-2 std, not rescaled: std 0.05 * 0.8796.
    assert abs(w.std().item() - 0.05 * 0.87962566) < 0.002
