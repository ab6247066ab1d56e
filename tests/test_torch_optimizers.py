"""Ftrl and scoped_optimizer of the PyTorch port against the JAX package's
``ftrl`` and ``scoped_optimizer`` (optax), on the same gradients.

Both compute the same fp32 expressions in the same order, so several steps
agree to rtol 1e-6 (atol 1e-7 for weights near 0); the L1 term zeroes the
same weights exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_recommenders_torch.datasets.movielens import (
    default_movielens_features as t_features,
)
from deep_recommenders_torch.features import CrossedFeature
from deep_recommenders_torch.models.ranking import WideDeep
from deep_recommenders_torch.training import Trainer
from deep_recommenders_torch.training.optimizers import (
    Ftrl,
    ScopedOptimizer,
    scoped_optimizer,
)
from deep_recommenders_tpu.training.optimizers import ftrl as j_ftrl
from deep_recommenders_tpu.training.optimizers import (
    scoped_optimizer as j_scoped_optimizer,
)

STEPS = 5


def _grads(rng, shape):
    return [rng.normal(0, 1, shape).astype(np.float32) for _ in range(STEPS)]


@pytest.mark.parametrize("l1,l2,beta", [(0.0, 0.0, 1.0), (0.5, 0.0, 1.0),
                                        (0.3, 0.2, 0.5)])
def test_ftrl_matches_jax(rng, l1, l2, beta):
    w0 = rng.normal(0, 0.5, (40, 3)).astype(np.float32)
    grads = _grads(rng, w0.shape)
    kwargs = dict(learning_rate=0.1, l1_regularization_strength=l1,
                  l2_regularization_strength=l2, beta=beta)
    opt = j_ftrl(**kwargs)
    params = jnp.asarray(w0)
    state = opt.init(params)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    t_opt = Ftrl([w], **kwargs)
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        w.grad = torch.from_numpy(g)
        t_opt.step()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(params),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t_opt.state[w]["z"].numpy(),
                               np.asarray(state.z), rtol=1e-6, atol=1e-7)
    zeros = np.asarray(params) == 0
    np.testing.assert_array_equal(w.detach().numpy() == 0, zeros)
    if l1 >= 0.5:  # the L1 term zeroes weights, the same ones in both
        assert zeros.any()


def test_ftrl_rejects_other_powers():
    with pytest.raises(NotImplementedError):
        Ftrl([torch.nn.Parameter(torch.zeros(2))], learning_rate_power=-1.0)


def _wide_deep():
    specs = t_features()
    crosses = (CrossedFeature("gender_x_age", ("user_gender", "user_age"),
                              14),)
    return WideDeep(specs, specs + crosses, 4, (8,),
                    generator=torch.Generator().manual_seed(0))


def test_scoped_optimizer_routes_wide_deep_parameters():
    """FTRL on every parameter whose name holds "wide" (the fused branch's
    wide_linear and wide_extra), Adam on the rest, as the JAX example
    splits them."""
    model = _wide_deep()
    opt = scoped_optimizer(
        {"wide": lambda p: Ftrl(p, 0.1, l1_regularization_strength=0.5)},
        lambda p: torch.optim.Adam(p, lr=1e-3), model.named_parameters())
    assert opt.routes == {
        "wide_linear.weights": "wide", "wide_extra.weights": "wide",
        "wide_extra.bias": "wide", "embeddings.table": "__default__",
        "deep.dense.0.weight": "__default__",
        "deep.dense.0.bias": "__default__",
        "deep.dense.1.weight": "__default__",
        "deep.dense.1.bias": "__default__"}
    assert isinstance(opt.optimizers["wide"], Ftrl)
    assert isinstance(opt.optimizers["__default__"], torch.optim.Adam)
    routed = {id(p) for o in opt.optimizers.values()
              for g in o.param_groups for p in g["params"]}
    assert routed == {id(p) for p in model.parameters()}


def test_scoped_optimizer_matches_jax(rng):
    """Several steps of FTRL (L1 0.5) on the "wide" scope and Adam elsewhere,
    on the same gradients, against optax.multi_transform; then the state
    dict round trip."""
    shapes = {"wide_linear": (30, 1), "wide_extra": (12, 1), "deep": (6, 4)}
    w0 = {k: rng.normal(0, 0.2, s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(STEPS)]
    j_params = {"params": {k: {"w": jnp.asarray(v)} for k, v in w0.items()}}
    j_opt = j_scoped_optimizer(
        {"wide": j_ftrl(0.1, l1_regularization_strength=0.5)},
        optax.adam(1e-3), j_params)
    j_state = j_opt.init(j_params)

    t_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                for k, v in w0.items()}
    t_opt = scoped_optimizer(
        {"wide": lambda p: Ftrl(p, 0.1, l1_regularization_strength=0.5)},
        lambda p: torch.optim.Adam(p, lr=1e-3),
        ((f"{k}.w", p) for k, p in t_params.items()))
    for g in grads:
        jg = {"params": {k: {"w": jnp.asarray(v)} for k, v in g.items()}}
        updates, j_state = j_opt.update(jg, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for k, p in t_params.items():
            p.grad = torch.from_numpy(g[k])
        t_opt.step()
        for k, p in t_params.items():
            np.testing.assert_allclose(
                p.detach().numpy(), np.asarray(j_params["params"][k]["w"]),
                rtol=1e-6, atol=1e-7, err_msg=k)
    assert (t_params["wide_linear"] == 0).any()
    assert not (t_params["deep"] == 0).any()

    state = t_opt.state_dict()
    again = scoped_optimizer(
        {"wide": lambda p: Ftrl(p, 0.1, l1_regularization_strength=0.5)},
        lambda p: torch.optim.Adam(p, lr=1e-3),
        ((f"{k}.w", p) for k, p in t_params.items()))
    again.load_state_dict(state)
    assert torch.equal(again.optimizers["wide"].state_dict()["state"][0]["z"],
                       state["wide"]["state"][0]["z"])
    with pytest.raises(KeyError):
        again.load_state_dict({"wide": state["wide"]})


def test_trainer_takes_a_scoped_optimizer(rng):
    """Trainer.train_step through ScopedOptimizer: every parameter moves and
    the gradients are cleared."""
    model = _wide_deep()
    with torch.no_grad():  # nonzero wide weights, so FTRL moves them
        model.wide_linear.weights.normal_(0, 0.1)
    opt = scoped_optimizer(
        {"wide": lambda p: Ftrl(p, 0.1)},
        lambda p: torch.optim.Adam(p, lr=1e-3), model.named_parameters())
    assert isinstance(opt, ScopedOptimizer)
    trainer = Trainer(model, opt, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    feats = {
        "user_id": rng.integers(0, 6040, 32), "user_gender":
        rng.integers(0, 3, 32), "user_age": rng.integers(0, 8, 32),
        "user_occupation": rng.integers(0, 22, 32),
        "movie_id": rng.integers(0, 3952, 32),
        "movie_genres": rng.integers(0, 19, (32, 6)),
        "gender_x_age": rng.integers(0, 14, 32)}
    batch = {k: torch.from_numpy(v.astype(np.int32)) for k, v in feats.items()}
    batch["movie_genres__wt"] = torch.ones(32, 6)
    labels = torch.from_numpy((rng.random((32, 1)) < 0.5).astype(np.float32))
    loss = trainer.train_step(batch, labels)
    assert torch.isfinite(loss)
    after = model.state_dict()
    assert all(not torch.equal(after[k], v) for k, v in before.items())
    trainer.optimizer.zero_grad()
    assert all(p.grad is None for p in model.parameters())
