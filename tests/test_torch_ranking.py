"""FM, FNN, Wide & Deep and DCN of the PyTorch port against the JAX package,
in fp32, on weights converted from flax: the logits, the BCE loss, every
gradient and one Adam step; FMLayer's linear-only mode; Cross's error
contracts and golden value.

fp32 on both sides; sums run in other orders (matmuls, reductions, the
table-gradient scatter), so values agree to fp32 rounding: rtol 1e-5 on
logits and loss; gradients within rtol 1e-4 and 1e-6 of the largest
gradient of their tensor (a sum of cancelling terms keeps the rounding of
its largest term); weights after an Adam step of lr 1e-3 within 1e-6 plus
what the gradient tolerance moves a first Adam step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_recommenders_torch import convert
from deep_recommenders_torch.datasets.movielens import (
    default_movielens_features as t_features,
)
from deep_recommenders_torch.features import CrossedFeature as TCrossed
from deep_recommenders_torch.models import ranking as tr
from deep_recommenders_torch.training import binary_cross_entropy as t_bce
from deep_recommenders_tpu.datasets.movielens import (
    default_movielens_features as j_features,
)
from deep_recommenders_tpu.features import CrossedFeature as JCrossed
from deep_recommenders_tpu.models import ranking as jr
from deep_recommenders_tpu.training.losses import (
    binary_cross_entropy as j_bce,
)

torch.set_num_threads(1)

B, D, HIDDEN = 64, 8, (16, 8)
# The Wide & Deep example's three crosses (examples/train_wdl_on_movielens.py).
CROSSES = (("gender_x_age", ("user_gender", "user_age"), 14),
           ("gender_x_occupation", ("user_gender", "user_occupation"), 42),
           ("age_x_occupation", ("user_age", "user_occupation"), 147))


def crosses(cls):
    return tuple(cls(name, keys=keys, hash_buckets=n)
                 for name, keys, n in CROSSES)


def make_batch(rng, b=B):
    """The six MovieLens features, the three crosses encoded from their ids
    (as the example encodes them), and labels."""
    feats = {
        "user_id": rng.integers(0, 6040, b),
        "user_gender": rng.integers(0, 3, b),
        "user_age": rng.integers(0, 8, b),
        "user_occupation": rng.integers(0, 22, b),
        "movie_id": rng.integers(0, 3952, b),
        "movie_genres": rng.integers(0, 19, (b, 6)),
    }
    feats = {k: v.astype(np.int32) for k, v in feats.items()}
    feats["movie_genres__wt"] = (rng.random((b, 6)) < 0.5).astype(np.float32)
    for cross in crosses(TCrossed):
        feats.update(cross.encode_cross(feats))
    labels = (rng.random((b, 1)) < 0.5).astype(np.float32)
    return feats, labels


def _wide(features, cross_cls, fused):
    """Wide specs: every feature and the crosses (the fused branch), or the
    three small features and the crosses (the separate branch)."""
    specs = features()
    base = specs if fused else specs[1:4]
    return specs, base + crosses(cross_cls)


def _j(dt):
    """JAX's compute dtype for the port's (None or torch.bfloat16)."""
    return None if dt is None else jnp.bfloat16


# name -> (JAX model, port model), both built for a compute dtype.
MODELS = {
    "fm": lambda dt: (
        jr.FactorizationMachine(j_features(), D, compute_dtype=_j(dt)),
        tr.FactorizationMachine(t_features(), D, compute_dtype=dt)),
    "fnn": lambda dt: (
        jr.FNN(j_features(), D, HIDDEN, compute_dtype=_j(dt)),
        tr.FNN(t_features(), D, HIDDEN, compute_dtype=dt)),
    "wdl": lambda dt: (
        jr.WideDeep(*_wide(j_features, JCrossed, True), D, HIDDEN,
                    compute_dtype=_j(dt)),
        tr.WideDeep(*_wide(t_features, TCrossed, True), D, HIDDEN,
                    compute_dtype=dt)),
    "wdl_separate": lambda dt: (
        jr.WideDeep(*_wide(j_features, JCrossed, False), D, HIDDEN,
                    compute_dtype=_j(dt)),
        tr.WideDeep(*_wide(t_features, TCrossed, False), D, HIDDEN,
                    compute_dtype=dt)),
    "dcn": lambda dt: (
        jr.DCN(j_features(), D, 3, None, HIDDEN,
               compute_dtype=_j(dt)),
        tr.DCN(t_features(), D, 3, None, HIDDEN, compute_dtype=dt)),
    "dcn_parallel": lambda dt: (
        jr.DCN(j_features(), D, 2, None, HIDDEN, "parallel",
               compute_dtype=_j(dt)),
        tr.DCN(t_features(), D, 2, None, HIDDEN, "parallel",
               compute_dtype=dt)),
    "dcn_low_rank": lambda dt: (
        jr.DCN(j_features(), D, 2, 6, HIDDEN,
               compute_dtype=_j(dt)),
        tr.DCN(t_features(), D, 2, 6, HIDDEN, compute_dtype=dt)),
}


def flax_params(j_model, batch, rng):
    """flax's initial weights, with every first-order table and bias drawn
    normal (flax zero-initialises them) so that they count."""
    params = j_model.init(jax.random.PRNGKey(0),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    params = jax.tree.map(np.array, params)

    def fill(tree):
        for key, value in tree.items():
            if isinstance(value, dict):
                fill(value)
            elif key in ("weights", "bias"):
                tree[key] = rng.normal(0, 0.1, value.shape).astype(np.float32)

    fill(params["params"])
    return params


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def assert_grads_close(got, want, rtol=1e-4, atol_share=1e-6):
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        value = value.numpy()
        atol = atol_share * max(np.abs(value).max(), 1e-30)
        np.testing.assert_allclose(got[name], value, rtol=rtol, atol=atol,
                                   err_msg=name)


def torch_grads(model):
    """Each parameter's gradient by name (zeros where autograd left none:
    FNN's unused linear bias)."""
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            .numpy() for n, p in model.named_parameters()}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_ranking_model_matches_flax(rng, name):
    """Logits, loss and every gradient against flax on converted weights."""
    batch, labels = make_batch(rng)
    j_model, t_model = MODELS[name](None)
    params = flax_params(j_model, batch, rng)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def j_loss(p):
        return j_bce(j_model.apply(p, jb), jnp.asarray(labels))

    want_logits = np.asarray(j_model.apply(params, jb))
    want_loss, want_grads = jax.value_and_grad(j_loss)(params)
    t_model.load_state_dict(convert.ranking_from_flax(params))
    logits = t_model(torch_batch(batch))
    loss = t_bce(logits, torch.from_numpy(labels))
    loss.backward()
    assert logits.shape == (B, 1)
    np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert_grads_close(torch_grads(t_model), convert.ranking_from_flax(
        jax.tree.map(np.asarray, want_grads)))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_ranking_adam_step_matches_optax(rng, name):
    """One Adam step of lr 1e-3 against optax's. A first step moves a weight
    by lr * g / (|g| + eps), so a gradient that differs by dg (within the
    gradient tolerance above: 1e-4 |g| + 1e-6 max|g|) moves it by at most
    lr * dg / (|g| + eps): each weight within 1e-6 (fp32 rounding of the
    weights) plus that."""
    lr, eps = 1e-3, 1e-8
    batch, labels = make_batch(rng)
    j_model, t_model = MODELS[name](None)
    params = flax_params(j_model, batch, rng)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    opt = optax.adam(lr)
    grads = jax.grad(lambda p: j_bce(j_model.apply(p, jb),
                                     jnp.asarray(labels)))(params)
    updates, _ = opt.update(grads, opt.init(params), params)
    want = convert.ranking_from_flax(
        jax.tree.map(np.asarray, optax.apply_updates(params, updates)))
    grads = convert.ranking_from_flax(jax.tree.map(np.asarray, grads))

    t_model.load_state_dict(convert.ranking_from_flax(params))
    t_opt = torch.optim.Adam(t_model.parameters(), lr=lr)
    t_bce(t_model(torch_batch(batch)), torch.from_numpy(labels)).backward()
    t_opt.step()
    assert_adam_step_close(t_model.state_dict(), want, grads, lr, eps)


def assert_adam_step_close(got, want, grads, lr, eps, dg=None):
    """Weights after a first Adam step within 1e-6 plus lr * dg / (|g| +
    eps), dg the gradient tolerance of :func:`assert_grads_close` (or, for
    a tensor named in ``dg``, the bound given there)."""
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        g = np.abs(grads[key].numpy())
        tol_g = (dg or {}).get(key, 1e-4 * g + 1e-6 * g.max())
        tol = 1e-6 + lr * tol_g / (g + eps)
        err = np.abs(got[key].numpy() - value.numpy())
        assert (err <= tol).all(), (key, err.max())


def test_fm_layer_matches_flax_and_degrades_to_linear(rng):
    """FMLayer: zero-initialised, so linear-only gives 0 (as JAX's test);
    on drawn weights, linear-only and with embeddings against flax."""
    sparse = rng.random((4, 10)).astype(np.float32)
    emb = rng.normal(size=(4, 3, 5)).astype(np.float32)
    layer = tr.FMLayer(10)
    with torch.no_grad():
        np.testing.assert_array_equal(
            layer(torch.from_numpy(sparse)).numpy(), 0.0)
    j_layer = jr.FMLayer()
    params = jax.tree.map(np.array, j_layer.init(jax.random.PRNGKey(0),
                                                 jnp.asarray(sparse)))
    params["params"]["linear"]["kernel"] = rng.normal(
        size=(10, 1)).astype(np.float32)
    params["params"]["linear"]["bias"] = np.asarray([0.5], np.float32)
    layer.load_state_dict(convert.fm_from_flax(params))
    with torch.no_grad():
        for args in ((sparse,), (sparse, emb)):
            want = np.asarray(j_layer.apply(params,
                                            *map(jnp.asarray, args)))
            got = layer(*map(torch.from_numpy, args)).numpy()
            assert got.shape == (4, 1)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_cross_golden_with_ones():
    """As JAX's golden test: ones kernel and bias give x0 * 2.6."""
    layer = tr.Cross(3)
    with torch.no_grad():
        for p in layer.parameters():
            p.fill_(1.0)
        x0 = torch.tensor([[0.1, 0.2, 0.3]])
        torch.testing.assert_close(layer(x0), x0 * 2.6)


def test_cross_error_contracts():
    """JAX's tests/test_ranking_models.py:106-117: low rank at most dim / 2,
    diag_scale not negative, x0 and x of one width."""
    layer = tr.Cross(8, projection_dim=2)
    assert layer(torch.ones(2, 8)).shape == (2, 8)
    with pytest.raises(ValueError):
        tr.Cross(8, projection_dim=5)
    with pytest.raises(ValueError):
        tr.Cross(8, diag_scale=-1.0)
    with pytest.raises(ValueError):
        layer(torch.ones(2, 8), torch.ones(2, 4))
    with pytest.raises(ValueError):
        tr.DCN(t_features(), D, structure="sideways")


@pytest.mark.parametrize("projection_dim,diag_scale", [(None, 0.5), (3, 0.0),
                                                       (3, 1.0)])
def test_cross_matches_flax(rng, projection_dim, diag_scale):
    """One Cross layer (full or low rank, with diag_scale) against flax on
    the same weights: x0 and x differ, bias drawn normal."""
    x0 = rng.normal(size=(5, 8)).astype(np.float32)
    x = rng.normal(size=(5, 8)).astype(np.float32)
    j_layer = jr.Cross(projection_dim=projection_dim, diag_scale=diag_scale)
    params = jax.tree.map(np.array, j_layer.init(jax.random.PRNGKey(1),
                                                 jnp.asarray(x0),
                                                 jnp.asarray(x)))
    dense = params["params"]["dense" if projection_dim is None
                             else "dense_v"]
    dense["bias"] = rng.normal(size=dense["bias"].shape).astype(np.float32)
    want = np.asarray(j_layer.apply(params, jnp.asarray(x0), jnp.asarray(x)))
    layer = tr.Cross(8, projection_dim, diag_scale)
    layer.load_state_dict(convert.dcn_from_flax(params))
    with torch.no_grad():
        got = layer(torch.from_numpy(x0), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_cross_and_dcn_initialisation():
    """Cross kernels flax's truncated normal(0.05), cut at 2 sigma; zero
    biases; DCN's parameter names those the converter writes."""
    layer = tr.Cross(400, generator=torch.Generator().manual_seed(0))
    w = layer.dense.weight
    assert w.abs().max().item() <= 0.1 and not layer.dense.bias.any()
    assert abs(w.std().item() - 0.05 * 0.87962566103423978) < 1e-3
    names = set(dict(tr.DCN(t_features(), D, 2, 6, (4,)).named_parameters()))
    assert {"crosses.1.dense_u.weight", "crosses.1.dense_v.bias",
            "head.weight", "deep.dense.0.weight"} <= names
    assert "crosses.0.dense_u.bias" not in names


def test_wide_deep_branches_and_names():
    """The fused branch when the wide specs cover the deep ones (no bias on
    wide_linear; wide_extra only with extras), else wide + embeddings;
    every wide parameter's name starts with "wide"."""
    specs = t_features()
    fused = tr.WideDeep(specs, specs + crosses(TCrossed), D, (4,))
    assert fused.fused_wide and fused.wide_linear.bias is None
    assert fused.wide_extra.bias is not None
    plain = tr.WideDeep(specs, specs, D, (4,))
    assert plain.wide_extra is None
    separate = tr.WideDeep(specs, specs[1:4], D, (4,))
    assert not separate.fused_wide
    for model in (fused, plain, separate):
        wide = [n for n, _ in model.named_parameters() if "wide" in n]
        assert wide and all(n.startswith("wide") for n in wide)


def test_encode_cross_matches_jax_bitwise(rng):
    """CrossedFeature.encode_cross (CRC32 of the "_X_"-joined values) and a
    FeatureEncoder holding crosses, against JAX's, on raw strings and on
    encoded ids, bit for bit."""
    from deep_recommenders_torch.features import Feature, FeatureEncoder
    from deep_recommenders_tpu.features import Feature as JFeature
    from deep_recommenders_tpu.features import FeatureEncoder as JEncoder

    raw = {"gender": list(rng.choice(["F", "M"], 50)),
           "age": list(rng.integers(1, 60, 50)),
           "zip": [f"{z:05d}" for z in rng.integers(0, 99999, 50)]}
    t_cross = TCrossed("g_x_a_x_z", ("gender", "age", "zip"), 1000)
    j_cross = JCrossed("g_x_a_x_z", ("gender", "age", "zip"), 1000)
    got = t_cross.encode_cross(raw)["g_x_a_x_z"]
    np.testing.assert_array_equal(got, j_cross.encode_cross(raw)["g_x_a_x_z"])
    assert got.dtype == np.int32 and got.max() < 1000
    assert t_cross.cardinality == 1000 and not t_cross.is_multi

    ids, _ = make_batch(rng)
    for t, j in zip(crosses(TCrossed), crosses(JCrossed)):
        np.testing.assert_array_equal(t.encode_cross(ids)[t.name],
                                      j.encode_cross(ids)[j.name])

    t_enc = FeatureEncoder([Feature("gender", vocab=("F", "M")), t_cross])
    j_enc = JEncoder([JFeature("gender", vocab=("F", "M")), j_cross])
    want = j_enc.encode(raw)
    got = t_enc.encode(raw)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
