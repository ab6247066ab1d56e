"""XDeepFM of the PyTorch port against the JAX package, on weights converted
from flax: the logits and one Adam train step, for the fused two-layer relu
stack (K3) and for the layered CIN (K4).

Both sides cast the stack's input rows to bf16 at the same place, so they
read the same values; the rest is fp32 in sums of other orders. Logits and
loss agree to rtol 1e-5 (atol 1e-6). After one Adam step of lr 1e-3 the
weights agree to atol 1e-6: a step moves each weight by about lr, and the
gradients agree to fp32 rounding except where the stack's bf16 dx0 rounds
to neighbouring values, which moves the embedding rows' gradients by
about one part in 256 and their Adam steps by far less than 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_recommenders_torch.convert import xdeepfm_from_flax
from deep_recommenders_torch.datasets.movielens import (
    default_movielens_features as t_features,
)
from deep_recommenders_torch.models.ranking import XDeepFM as TXDeepFM
from deep_recommenders_torch.ops import cin_kernels
from deep_recommenders_torch.training import Trainer as TTrainer
from deep_recommenders_tpu.datasets.movielens import (
    default_movielens_features as j_features,
)
from deep_recommenders_tpu.models.ranking import XDeepFM as JXDeepFM
from deep_recommenders_tpu.training import Trainer as JTrainer

torch.set_num_threads(1)

B, D, HIDDEN = 64, 8, (16, 8)

# (feature maps, activation): the fused stack, then two layered stacks.
CONFIGS = {
    "fused": ((12, 20), "relu"),
    "layered": ((12, 20, 8), "relu"),
    "layered_sigmoid": ((10,), "sigmoid"),
}


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


def _models(config):
    maps, act = CONFIGS[config]
    kw = dict(cin_feature_maps=maps, cin_activation=act, hidden=HIDDEN)
    return (JXDeepFM(j_features(), embedding_dim=D, **kw),
            TXDeepFM(t_features(), embedding_dim=D, **kw))


def _flax_params(rng, j_model, batch):
    params = j_model.init(jax.random.PRNGKey(0),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    params = jax.tree.map(np.asarray, params)
    # flax zero-initialises the linear terms; make them count.
    lin = params["params"]["linear"]
    lin["weights"] = rng.normal(0, 0.1, lin["weights"].shape).astype(
        np.float32)
    lin["bias"] = np.asarray([0.3], np.float32)
    return params


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_xdeepfm_logits_match_flax(rng, config):
    batch, _ = _batch(rng)
    j_model, model = _models(config)
    params = _flax_params(rng, j_model, batch)
    want = j_model.apply(params, {k: jnp.asarray(v) for k, v in batch.items()})
    model.load_state_dict(xdeepfm_from_flax(params))
    before = dict(cin_kernels.cin_stack_pooled.launches)
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (B, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # On the CPU the wrappers take their plain versions: no launch counted.
    assert cin_kernels.cin_stack_pooled.launches == before


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_xdeepfm_train_step_matches_optax_adam(rng, config):
    batch, labels = _batch(rng)
    j_model, model = _models(config)
    params = _flax_params(rng, j_model, batch)
    j_trainer = JTrainer(j_model, optax.adam(1e-3), seed=0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = j_trainer.init(jb)
    state.params = jax.tree.map(jnp.asarray, params)
    state.opt_state = j_trainer.optimizer.init(state.params)
    state, j_loss = j_trainer.train_step(state, jb, jnp.asarray(labels))
    want = xdeepfm_from_flax(jax.tree.map(np.asarray, state.params))

    model.load_state_dict(xdeepfm_from_flax(params))
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


def test_xdeepfm_routes_like_jax():
    """Two relu layers take the fused stack's parameters; any other depth
    or activation the layered CIN's, with F_prev = F0 at layer 0."""
    fused = TXDeepFM(t_features(), 4, (8, 8), "relu", (4,))
    assert fused.cin_w1.shape == (6, 6, 8) and fused.cin_w2.shape == (6, 8, 8)
    assert not hasattr(fused, "cins")
    for maps, act in (((8, 8), "sigmoid"), ((8,), "relu"),
                      ((8, 4, 2), "relu")):
        layered = TXDeepFM(t_features(), 4, maps, act, (4,))
        assert not hasattr(layered, "cin_w1")
        assert [tuple(c.kernel.shape) for c in layered.cins] == [
            (6, f, m) for f, m in zip((6,) + maps, maps)]
        assert layered.cin_head.weight.shape == (1, sum(maps))


def test_xdeepfm_mesh_and_bf16_not_ported():
    """``mesh`` takes a ("data", "model") DeviceMesh
    (tests/test_torch_parallel.py) and refuses anything else with
    TypeError; bf16 is ported (tests/test_torch_ranking_bf16.py), and any
    compute dtype but fp32 and bf16 raises."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        TXDeepFM(t_features(), mesh=object())
    with pytest.raises(ValueError):
        TXDeepFM(t_features(), compute_dtype=torch.float16)
