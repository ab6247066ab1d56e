"""DeepFM of the PyTorch port against the JAX package, on weights converted
from flax: the logits, and one Adam train step's loss and updated weights.

fp32 on both sides; sums run in other orders (matmuls, reductions, the
table-gradient scatter), so values agree to fp32 rounding: rtol 1e-5 on
logits and loss, atol 1e-6 on weights after a step of lr 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_recommenders_torch.convert import deepfm_from_flax
from deep_recommenders_torch.datasets.movielens import (
    default_movielens_features as t_features,
)
from deep_recommenders_torch.models.common import MLP, resolve_activation
from deep_recommenders_torch.models.ranking import DeepFM as TDeepFM
from deep_recommenders_torch.training import Trainer as TTrainer
from deep_recommenders_tpu.datasets.movielens import (
    default_movielens_features as j_features,
)
from deep_recommenders_tpu.models.common import (
    resolve_activation as j_resolve_activation,
)
from deep_recommenders_tpu.models.ranking import DeepFM as JDeepFM
from deep_recommenders_tpu.training import Trainer as JTrainer

torch.set_num_threads(1)

B, D, HIDDEN = 64, 8, (16, 8)


def _batch(rng):
    feats = {
        "user_id": rng.integers(0, 6040, B),
        "user_gender": rng.integers(0, 3, B),
        "user_age": rng.integers(0, 8, B),
        "user_occupation": rng.integers(0, 22, B),
        "movie_id": rng.integers(0, 3952, B),
        "movie_genres": rng.integers(0, 19, (B, 6)),
    }
    feats = {k: v.astype(np.int32) for k, v in feats.items()}
    feats["movie_genres__wt"] = (rng.random((B, 6)) < 0.5).astype(np.float32)
    labels = (rng.random((B, 1)) < 0.5).astype(np.float32)
    return feats, labels


def _flax_params(rng, batch):
    params = JDeepFM(j_features(), embedding_dim=D, hidden=HIDDEN).init(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()}
    )
    params = jax.tree.map(np.asarray, params)
    # flax zero-initialises the linear terms; make them count.
    lin = params["params"]["linear"]
    lin["weights"] = rng.normal(0, 0.1, lin["weights"].shape).astype(
        np.float32
    )
    lin["bias"] = np.asarray([0.3], np.float32)
    return params


def _torch_model(params):
    model = TDeepFM(t_features(), embedding_dim=D, hidden=HIDDEN)
    model.load_state_dict(deepfm_from_flax(params))
    return model


def test_deepfm_logits_match_flax(rng):
    batch, _ = _batch(rng)
    params = _flax_params(rng, batch)
    want = JDeepFM(j_features(), embedding_dim=D, hidden=HIDDEN).apply(
        params, {k: jnp.asarray(v) for k, v in batch.items()}
    )
    model = _torch_model(params).eval()
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (B, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_train_step_matches_optax_adam(rng):
    batch, labels = _batch(rng)
    params = _flax_params(rng, batch)
    j_model = JDeepFM(j_features(), embedding_dim=D, hidden=HIDDEN)
    j_trainer = JTrainer(j_model, optax.adam(1e-3), seed=0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = j_trainer.init(jb)
    state.params = jax.tree.map(jnp.asarray, params)
    state.opt_state = j_trainer.optimizer.init(state.params)
    state, j_loss = j_trainer.train_step(state, jb, jnp.asarray(labels))
    want = deepfm_from_flax(jax.tree.map(np.asarray, state.params))

    model = _torch_model(params)
    trainer = TTrainer(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                       device="cpu")
    loss = trainer.train_step(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.from_numpy(labels),
    )
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_mlp_initialisation_is_flax_lecun_normal():
    mlp = MLP(400, (300,), output_dim=None,
              generator=torch.Generator().manual_seed(0))
    w = mlp.dense[0].weight
    std = (1 / 400) ** 0.5
    assert w.shape == (300, 400) and not mlp.dense[0].bias.any()
    assert abs(w.std().item() - std) < 0.02 * std
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978


@pytest.mark.parametrize("name", ["relu", "sigmoid", "tanh", "gelu",
                                  "softmax"])
def test_activations_match_jax(rng, name):
    x = rng.normal(0, 2, (4, 9)).astype(np.float32)
    got = resolve_activation(name)(torch.from_numpy(x)).numpy()
    want = np.asarray(j_resolve_activation(name)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_deepfm_mesh_and_bf16_not_ported():
    with pytest.raises(NotImplementedError):
        TDeepFM(t_features(), mesh=object())
    with pytest.raises(NotImplementedError):
        TDeepFM(t_features(), compute_dtype=torch.bfloat16)
