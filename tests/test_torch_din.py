"""DIN of the PyTorch port against the JAX package: ``dice`` in both
normalizations, ``Dice``, ``ActivationUnit`` (the concat path and the
weight-split sequence path, against JAX's and against each other), ``DIN``
in the vector and the ids modes with a fully masked row (logits, loss,
every gradient through ``din_from_flax``, one Adam step against optax),
``DIN(compute_dtype=torch.bfloat16)`` against JAX's bf16 path, and the DIN
example at a tiny size on the CPU.

fp32 tolerances: rtol 1e-5 on outputs, logits and loss (both sides sum in
other orders); gradients as ``test_torch_ranking.assert_grads_close``
(rtol 1e-4 and 1e-6 of the largest gradient of their tensor); the Adam
step as ``test_torch_ranking``'s. The bf16 tolerances are stated at each
test: JAX's side runs in a subprocess with ``--xla_allow_excess_precision=
false``, as ``test_torch_ranking_bf16.py`` does.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_recommenders_torch import convert
from deep_recommenders_torch.examples import train_din_on_synthetic
from deep_recommenders_torch.models.ranking import din as tdin
from deep_recommenders_torch.ops.dice import dice as t_dice
from deep_recommenders_torch.training import binary_cross_entropy as t_bce
from deep_recommenders_tpu.models.ranking import din as jdin
from deep_recommenders_tpu.ops.dice import dice as j_dice
from deep_recommenders_tpu.training.losses import (
    binary_cross_entropy as j_bce,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_ranking as base  # noqa: E402
from test_torch_ranking_bf16 import _flat, _nest  # noqa: E402

torch.set_num_threads(1)

B, T, D, U, HIDDEN, CONTEXT, NUM_ITEMS = 16, 6, 8, 10, (12, 6), 5, 40
BF16 = torch.bfloat16

# name -> (use_dice, num_items, context_dim)
CONFIGS = {
    "vector": (True, None, 0),
    "vector_context": (True, None, CONTEXT),
    "ids": (True, NUM_ITEMS, 0),
    "relu_tower": (False, None, 0),
}


def din_inputs(rng, num_items=None, context_dim=0):
    """behaviors, mask, candidate (vectors, or ids when ``num_items``),
    context, labels; row 0 of the mask fully masked."""
    if num_items is None:
        behaviors = rng.normal(size=(B, T, D)).astype(np.float32)
        candidate = rng.normal(size=(B, D)).astype(np.float32)
    else:
        behaviors = rng.integers(0, num_items, (B, T)).astype(np.int32)
        candidate = rng.integers(0, num_items, B).astype(np.int32)
    mask = (rng.random((B, T)) < 0.7).astype(np.float32)
    mask[0] = 0.0
    context = (rng.normal(size=(B, context_dim)).astype(np.float32)
               if context_dim else None)
    labels = (rng.random((B, 1)) < 0.5).astype(np.float32)
    return (behaviors, mask, candidate, context), labels


def fill_params(params, rng):
    """flax zero-initialises every bias and Dice's alpha: draw them normal
    so that they count."""
    for key, value in params.items():
        if isinstance(value, dict):
            fill_params(value, rng)
        elif key in ("alpha", "bias", "dense_kernel_bias",
                     "dense_output_bias"):
            params[key] = rng.normal(0, 0.3, value.shape).astype(np.float32)
    return params


def j_args(inputs):
    return tuple(None if a is None else jnp.asarray(a) for a in inputs)


def t_args(inputs):
    return tuple(None if a is None else torch.from_numpy(a) for a in inputs)


def flax_din(rng, inputs, compute_dtype=None, use_dice=True, num_items=None):
    model = jdin.DIN(attention_units=U, hidden=HIDDEN, use_dice=use_dice,
                     num_items=num_items, embedding_dim=D,
                     compute_dtype=compute_dtype)
    params = model.init(jax.random.PRNGKey(0), *j_args(inputs))
    return model, fill_params(jax.tree.map(np.array, params), rng)


# -- dice, Dice, ActivationUnit ---------------------------------------------

@pytest.mark.parametrize("normalization", ["paper", "reference"])
@pytest.mark.parametrize("shape", [(8, 12), (4, 5, 6)])
def test_dice_matches_jax(rng, normalization, shape):
    """Both normalizations, statistics over axis 1, on inputs with negative
    values and two constant rows (variance 0: rsqrt of eps alone; the
    constants sum exactly, so x - mean is 0 on both sides)."""
    x = rng.normal(size=shape).astype(np.float32)
    x[0] = 0.5
    x[1] = -1.5
    alpha = rng.normal(size=shape[-1]).astype(np.float32)
    want = np.asarray(j_dice(jnp.asarray(x), jnp.asarray(alpha),
                             normalization=normalization))
    got = t_dice(torch.from_numpy(x), torch.from_numpy(alpha),
                 normalization=normalization).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        t_dice(torch.from_numpy(x), torch.from_numpy(alpha),
               normalization="batch")


def test_dice_layer_matches_flax(rng):
    """``Dice``: alpha zero-initialised, as flax's; on a drawn alpha,
    against flax's layer."""
    x = rng.normal(size=(16, 4)).astype(np.float32)
    layer = tdin.Dice(4)
    assert not layer.alpha.any()
    j_layer = jdin.Dice()
    params = jax.tree.map(np.array, j_layer.init(jax.random.PRNGKey(0),
                                                 jnp.asarray(x)))
    params["params"]["alpha"] = rng.normal(size=4).astype(np.float32)
    layer.load_state_dict({"alpha": torch.from_numpy(
        params["params"]["alpha"])})
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(j_layer.apply(params, jnp.asarray(x))),
        rtol=1e-5, atol=1e-6)


def _unit_pair(rng, interacter, x, y, use_bias=True):
    j_inter = jdin.subtract_interacter if interacter else None
    t_inter = tdin.subtract_interacter if interacter else None
    j_unit = jdin.ActivationUnit(U, interacter=j_inter, use_bias=use_bias)
    params = fill_params(jax.tree.map(np.array, j_unit.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y))), rng)
    t_unit = tdin.ActivationUnit(D, U, interacter=t_inter,
                                 use_bias=use_bias)
    t_unit.load_state_dict({k: torch.from_numpy(v)
                            for k, v in params["params"].items()})
    return j_unit, params, t_unit


@pytest.mark.parametrize("interacter,use_bias", [(True, True), (False, True),
                                                 (True, False)])
def test_activation_unit_concat_path_matches_flax(rng, interacter,
                                                  use_bias):
    """The concat path on (B, D) pairs: with and without the subtract
    interacter (n = 3 or 2 blocks of ``dense_kernel``), with and without
    biases."""
    x = rng.normal(size=(6, D)).astype(np.float32)
    y = rng.normal(size=(6, D)).astype(np.float32)
    j_unit, params, t_unit = _unit_pair(rng, interacter, x, y, use_bias)
    assert sorted(dict(t_unit.named_parameters())) == sorted(
        params["params"])
    want = np.asarray(j_unit.apply(params, jnp.asarray(x), jnp.asarray(y)))
    with torch.no_grad():
        got = t_unit(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.shape == (6, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_activation_unit_sequence_path_matches_flax_and_concat(rng):
    """The weight-split path on (B, T, D) against (B, D), which DIN uses,
    against JAX's same path, and against the port's concat path on the
    tiled pairs (JAX's tests/test_ranking_models.py:172-197)."""
    xs = rng.normal(size=(4, 5, D)).astype(np.float32)
    y = rng.normal(size=(4, D)).astype(np.float32)
    j_unit, params, t_unit = _unit_pair(rng, True, xs, y)
    want = np.asarray(j_unit.apply(params, jnp.asarray(xs), jnp.asarray(y)))
    with torch.no_grad():
        fused = t_unit(torch.from_numpy(xs), torch.from_numpy(y))
        tiled = torch.from_numpy(y)[:, None, :].expand(4, 5, D)
        pairwise = t_unit(torch.from_numpy(xs).reshape(20, D),
                          tiled.reshape(20, D)).reshape(4, 5, 1)
    assert fused.shape == (4, 5, 1)
    np.testing.assert_allclose(fused.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(fused.numpy(), pairwise.numpy(), rtol=1e-5,
                               atol=1e-6)


# -- DIN in fp32 ------------------------------------------------------------

def _din_case(rng, name):
    use_dice, num_items, context_dim = CONFIGS[name]
    inputs, labels = din_inputs(rng, num_items, context_dim)
    j_model, params = flax_din(rng, inputs, use_dice=use_dice,
                               num_items=num_items)
    t_model = tdin.DIN(U, HIDDEN, use_dice, num_items, D,
                       context_dim=context_dim)
    t_model.load_state_dict(convert.din_from_flax(params))
    return inputs, labels, j_model, params, t_model


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_din_matches_flax(rng, name):
    """Logits, loss and every gradient against flax on converted weights.
    Row 0 is fully masked: uniform weights (-1e9, not -inf), finite."""
    inputs, labels, j_model, params, t_model = _din_case(rng, name)
    ja = j_args(inputs)

    def j_loss(p):
        return j_bce(j_model.apply(p, *ja), jnp.asarray(labels))

    want_logits = np.asarray(j_model.apply(params, *ja))
    want_loss, want_grads = jax.value_and_grad(j_loss)(params)
    logits = t_model(*t_args(inputs))
    loss = t_bce(logits, torch.from_numpy(labels))
    loss.backward()
    assert logits.shape == (B, 1) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())
    np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert_din_grads_close(base.torch_grads(t_model), convert.din_from_flax(
        jax.tree.map(np.asarray, want_grads)))


def assert_din_grads_close(got, want):
    """``base.assert_grads_close``, but for ``unit.dense_output_bias``: a
    constant added to every score leaves the softmax as it is, so its
    gradient is exactly 0 and both sides hold only the rounding of the
    cancelling per-position terms. Each side within 1e-6 of the largest
    gradient of the model (where there is a bias)."""
    got, want = dict(got), dict(want)
    key = "unit.dense_output_bias"
    if key in want:
        scale = max(np.abs(v.numpy()).max() for v in want.values())
        assert np.abs(got.pop(key)).max() <= 1e-6 * scale
        assert np.abs(want.pop(key).numpy()).max() <= 1e-6 * scale
    base.assert_grads_close(got, want)


def test_din_fully_masked_row_pools_uniformly(rng):
    """On a fully masked row the interest is the plain mean of the
    behaviors: the same logit as the same row with every position valid
    and all scores equal (a zero attention kernel)."""
    inputs, _, _, params, t_model = _din_case(rng, "vector")
    behaviors, mask, candidate, _ = t_args(inputs)
    with torch.no_grad():
        t_model.unit.dense_output.zero_()
        masked = t_model(behaviors[:1], mask[:1], candidate[:1])
        full = t_model(behaviors[:1], torch.ones_like(mask[:1]),
                       candidate[:1])
    assert not mask[0].any()
    torch.testing.assert_close(masked, full)


@pytest.mark.parametrize("name", ["vector", "ids"])
def test_din_adam_step_matches_optax(rng, name):
    """One Adam step of lr 1e-3 against optax's, within
    ``test_torch_ranking``'s bound: 1e-6 plus what the gradient tolerance
    moves a first Adam step (for ``unit.dense_output_bias``, whose gradient
    is 0 up to rounding, the tolerance of :func:`assert_din_grads_close`:
    the two sides' gradients may differ by 2e-6 of the model's largest)."""
    lr, eps = 1e-3, 1e-8
    inputs, labels, j_model, params, t_model = _din_case(rng, name)
    ja = j_args(inputs)
    opt = optax.adam(lr)
    grads = jax.grad(lambda p: j_bce(j_model.apply(p, *ja),
                                     jnp.asarray(labels)))(params)
    updates, _ = opt.update(grads, opt.init(params), params)
    want = convert.din_from_flax(
        jax.tree.map(np.asarray, optax.apply_updates(params, updates)))
    grads = convert.din_from_flax(jax.tree.map(np.asarray, grads))
    t_opt = torch.optim.Adam(t_model.parameters(), lr=lr)
    t_bce(t_model(*t_args(inputs)), torch.from_numpy(labels)).backward()
    t_opt.step()
    scale = max(np.abs(v.numpy()).max() for v in grads.values())
    base.assert_adam_step_close(t_model.state_dict(), want, grads, lr, eps,
                                dg={"unit.dense_output_bias": 2e-6 * scale})


def test_din_initialisation_and_errors():
    """Kernels of the unit truncated normal(0.05) cut at 2 sigma, zero
    biases and alphas, the item table normal(1/sqrt(D)); ``mesh=`` and an
    unknown compute dtype raise."""
    model = tdin.DIN(36, (200, 80), num_items=5000, embedding_dim=32,
                     generator=torch.Generator().manual_seed(0))
    k = model.unit.dense_kernel
    assert tuple(k.shape) == (96, 36) and k.abs().max().item() <= 0.1
    assert not model.unit.dense_kernel_bias.any()
    assert not any(d.alpha.any() for d in model.dice)
    assert abs(model.item_table.std().item() - 32 ** -0.5) < 2e-3
    assert tuple(model.dense[-1].weight.shape) == (1, 80)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tdin.DIN(mesh=object(), num_items=10)
    with pytest.raises(ValueError):
        tdin.DIN(compute_dtype=torch.float16)


# -- DIN in bf16 against JAX's bf16 path --------------------------------------

BF16_MODES = {"vector": None, "ids": NUM_ITEMS}


def jax_side(path):
    """Everything the bf16 tests read of JAX, run in the subprocess: for
    each mode DIN's weights, bf16 and fp32 logits, bf16 loss and gradients;
    the bf16 ActivationUnit's weights, inputs and outputs on both paths."""
    out = {}
    for i, (mode, num_items) in enumerate(sorted(BF16_MODES.items())):
        rng = np.random.default_rng(200 + i)
        inputs, labels = din_inputs(rng, num_items)
        model, params = flax_din(rng, inputs, jnp.bfloat16,
                                 num_items=num_items)
        ja = j_args(inputs)

        def loss(p):
            return j_bce(model.apply(p, *ja), jnp.asarray(labels))

        value, grads = jax.value_and_grad(loss)(params)
        logits = model.apply(params, *ja)
        assert logits.dtype == jnp.float32
        fp32, _ = flax_din(rng, inputs, num_items=num_items)
        fields = {"logits": logits, "logits_fp32": fp32.apply(params, *ja),
                  "loss": value}
        fields.update({"params/" + k: v
                       for k, v in _flat(params["params"]).items()})
        fields.update({"grads/" + k: v
                       for k, v in _flat(grads["params"]).items()})
        out.update({f"{mode}|{k}": np.asarray(v, np.float32)
                    for k, v in fields.items()})
    rng = np.random.default_rng(300)
    xs = rng.normal(size=(32, 12, D)).astype(np.float32)
    y = rng.normal(size=(32, D)).astype(np.float32)
    unit = jdin.ActivationUnit(U, interacter=jdin.subtract_interacter,
                               dtype=jnp.bfloat16)
    params = fill_params(jax.tree.map(np.array, unit.init(
        jax.random.PRNGKey(0), jnp.asarray(xs), jnp.asarray(y))), rng)
    fields = {"xs": xs, "y": y,
              "sequence": unit.apply(params, jnp.asarray(xs), jnp.asarray(y)),
              "concat": unit.apply(params, jnp.asarray(xs[:, 0]),
                                   jnp.asarray(y))}
    fields.update({"params/" + k: v for k, v in params["params"].items()})
    out.update({f"unit|{k}": np.asarray(v, np.float32)
                for k, v in fields.items()})
    np.savez(path, **out)


_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, "tests")
import test_torch_din
test_torch_din.jax_side(sys.argv[1])
"""


@pytest.fixture(scope="module")
def jax_bf16(tmp_path_factory):
    path = tmp_path_factory.mktemp("din_bf16") / "jax.npz"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=root,
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    subprocess.run([sys.executable, "-c", _SCRIPT, str(path)], check=True,
                   cwd=root, env=env, timeout=600)
    results = {}
    for key, value in np.load(path).items():
        name, field = key.split("|")
        results.setdefault(name, {})[field] = value
    return results


def _bf16_port(mode, fields):
    rng = np.random.default_rng(200 + sorted(BF16_MODES).index(mode))
    inputs, labels = din_inputs(rng, BF16_MODES[mode])
    params = {"params": _nest({k[len("params/"):]: v
                               for k, v in fields.items()
                               if k.startswith("params/")})}
    model = tdin.DIN(U, HIDDEN, num_items=BF16_MODES[mode], embedding_dim=D,
                     compute_dtype=BF16)
    model.load_state_dict(convert.din_from_flax(params))
    return model, t_args(inputs), torch.from_numpy(labels)


@pytest.mark.parametrize("mode", sorted(BF16_MODES))
def test_din_bf16_logits_loss_and_grads_match_jax(jax_bf16, mode):
    """Parameters, logits and gradients stay fp32. The logits within a
    hundredth of the largest distance between JAX's bf16 and fp32 logits
    (both sides round the same values to bf16 at the same places and sum in
    fp32 in other orders, so now and then a value rounds to the other bf16
    neighbour); the loss to rtol 1e-5; every gradient to a relative
    Frobenius error of 2e-2 against JAX's bf16 gradients, as
    ``test_torch_ranking_bf16.py`` holds the CTR models."""
    fields = jax_bf16[mode]
    model, args, labels = _bf16_port(mode, fields)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    logits = model(*args)
    assert logits.dtype == torch.float32 and logits.shape == (B, 1)
    loss = t_bce(logits, labels)
    loss.backward()
    gap = np.abs(fields["logits"] - fields["logits_fp32"]).max()
    err = np.abs(logits.detach().numpy() - fields["logits"]).max()
    assert gap > 0 and err <= 0.01 * gap, (err, gap)
    np.testing.assert_allclose(loss.item(), float(fields["loss"]), rtol=1e-5)
    want = convert.din_from_flax({"params": _nest(
        {k[len("grads/"):]: v for k, v in fields.items()
         if k.startswith("grads/")})})
    got = base.torch_grads(model)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == np.float32
        value = value.numpy()
        norm = np.linalg.norm(value)
        err = np.linalg.norm(got[key] - value)
        assert err <= 2e-2 * norm or err <= 1e-6, (key, err, norm)


def _round_out(fn):
    return lambda a, b, dtype: fn(a, b, dtype).to(dtype).float()


@pytest.mark.parametrize("variant", [None, "dot_rounded", "y_term_unrounded"])
def test_activation_unit_bf16_rounds_where_jax_rounds(jax_bf16, monkeypatch,
                                                      variant):
    """The bf16 ActivationUnit on both paths against JAX's bf16 outputs,
    within 1e-5 of the output's scale (fp32 sums of exact bf16 products in
    other orders), and each rounding site pinned: rounding the
    ``preferred_element_type=float32`` sums (``_dot_f32``) to bf16, or
    leaving the sequence path's ``y @ (wy - wi)`` unrounded, misses JAX's
    outputs by more than 10 times that bound."""
    fields = jax_bf16["unit"]
    unit = tdin.ActivationUnit(D, U, interacter=tdin.subtract_interacter,
                               dtype=BF16)
    unit.load_state_dict({k[len("params/"):]: torch.from_numpy(v)
                          for k, v in fields.items()
                          if k.startswith("params/")})
    if variant == "dot_rounded":
        monkeypatch.setattr(tdin, "_dot_f32", _round_out(tdin._dot_f32))
    elif variant == "y_term_unrounded":
        monkeypatch.setattr(tdin, "_dot_rounded",
                            lambda a, b, dtype: tdin._dot_f32(a, b, dtype))
    xs, y = torch.from_numpy(fields["xs"]), torch.from_numpy(fields["y"])
    with torch.no_grad():
        outputs = {"sequence": unit(xs, y), "concat": unit(xs[:, 0], y)}
    errs = {}
    for path, got in outputs.items():
        assert got.dtype == torch.float32
        want = fields[path]
        bound = 1e-5 * np.abs(want).max()
        errs[path] = np.abs(got.numpy() - want).max() / bound
    if variant is None:
        assert max(errs.values()) <= 1.0, errs
    elif variant == "dot_rounded":
        assert min(errs.values()) > 10.0, errs
    else:  # only the sequence path has the y term
        assert errs["sequence"] > 10.0 and errs["concat"] <= 1.0, errs


# -- the example ----------------------------------------------------------------

def test_din_example_on_the_cpu(capsys):
    """The ported example at a tiny size: its own loop, the loss finite,
    the test AUC in [0, 1] after each epoch."""
    result = train_din_on_synthetic.main([
        "--num-examples", "2000", "--num-items", "50", "--dim", "8",
        "--seq-len", "6", "--epochs", "2", "--batch-size", "128",
        "--device", "cpu"])
    assert len(result["history"]) == 2
    assert all(0.0 <= h["auc"] <= 1.0 for h in result["history"])
    assert np.isfinite(result["step_losses"]).all()
    assert len(result["step_losses"]) == 2 * (1600 // 128)
    assert "test auc" in capsys.readouterr().out


def test_din_example_matches_jax_data():
    """``make_data`` is a copy of the JAX example's: the same arrays."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "train_din_on_synthetic.py")
    spec = importlib.util.spec_from_file_location("j_din_example", path)
    j_example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(j_example)

    want = j_example.make_data(300, 20, 4, 5, 7)
    got = train_din_on_synthetic.make_data(300, 20, 4, 5, 7)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
