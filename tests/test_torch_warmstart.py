"""warm_start_from and the checkpoint round trip of the PyTorch port, the
two halves of the two-phase FM -> FNN flow (``examples/
train_fnn_on_movielens.py``), against the JAX package's ``warm_start_from``
on the same weights. Grafts copy tensors: equal bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_recommenders_torch.convert import ranking_from_flax
from deep_recommenders_torch.datasets.movielens import (
    default_movielens_features as t_features,
)
from deep_recommenders_torch.models.ranking import (
    FNN,
    DeepFM,
    FactorizationMachine,
)
from deep_recommenders_torch.training import (
    latest_step_dir,
    list_step_dirs,
    restore_checkpoint,
    save_checkpoint,
    warm_start_from,
)
from deep_recommenders_tpu.datasets.movielens import (
    default_movielens_features as j_features,
)
from deep_recommenders_tpu.models import ranking as jr
from deep_recommenders_tpu.training.warmstart import (
    warm_start_from as j_warm_start_from,
)

D = 4


def _flax(model, rng):
    batch = {"user_id": np.zeros(2, np.int32),
             "user_gender": np.zeros(2, np.int32),
             "user_age": np.zeros(2, np.int32),
             "user_occupation": np.zeros(2, np.int32),
             "movie_id": np.zeros(2, np.int32),
             "movie_genres": np.zeros((2, 6), np.int32),
             "movie_genres__wt": np.ones((2, 6), np.float32)}
    params = jax.tree.map(np.array, model.init(
        jax.random.PRNGKey(int(rng.integers(1 << 30))),
        {k: jnp.asarray(v) for k, v in batch.items()}))
    for leaf in ("weights", "bias"):
        lin = params["params"]["linear"]
        lin[leaf] = rng.normal(size=lin[leaf].shape).astype(np.float32)
    return params


def test_warm_start_grafts_fm_into_fnn_as_jax(rng):
    """FM's linear and embeddings scopes into an FNN: the same state as
    JAX's graft, converted; the FNN's deep tower untouched."""
    fm = _flax(jr.FactorizationMachine(j_features(), D), rng)
    fnn = _flax(jr.FNN(j_features(), D, (8,)), rng)
    want = ranking_from_flax(j_warm_start_from(fnn, fm))
    target = FNN(t_features(), D, (8,))
    target.load_state_dict(ranking_from_flax(fnn))
    got = warm_start_from(target.state_dict(), ranking_from_flax(fm))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    target.load_state_dict(got)
    assert torch.equal(target.embeddings.table,
                       ranking_from_flax(fm)["embeddings.table"])


def test_warm_start_copies_and_raises():
    fm = FactorizationMachine(t_features(), D,
                              generator=torch.Generator().manual_seed(1))
    fnn = FNN(t_features(), D, (8,))
    target = fnn.state_dict()
    got = warm_start_from(target, fm.state_dict(), scopes=("embeddings",))
    assert torch.equal(got["embeddings.table"], fm.embeddings.table)
    assert got["embeddings.table"].data_ptr() != \
        fm.embeddings.table.data_ptr()
    assert torch.equal(got["linear.weights"], target["linear.weights"])
    with pytest.raises(KeyError):
        warm_start_from(target, fm.state_dict(), scopes=("deep",))
    wider = FactorizationMachine(t_features(), D + 1).state_dict()
    with pytest.raises(ValueError):
        warm_start_from(target, wider)
    # A source scope with another structure (DeepFM's deep tower into an
    # FNN's of other widths).
    deepfm = DeepFM(t_features(), D, (3,)).state_dict()
    with pytest.raises(ValueError):
        warm_start_from(target, deepfm, scopes=("deep",))


def test_checkpoint_round_trip(tmp_path):
    """A model's and an optimizer's state through save and restore: equal
    bit for bit; with a template, its dtypes and checks; list_step_dirs in
    step order."""
    model = FNN(t_features(), D, (8,),
                generator=torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    state = {"model": model.state_dict(), "optimizer": opt.state_dict(),
             "step": 7}
    path = save_checkpoint(str(tmp_path / "step_7"), state)
    raw = restore_checkpoint(path)
    assert raw["step"] == 7
    for key, value in state["model"].items():
        assert torch.equal(raw["model"][key], value), key
    fresh = FNN(t_features(), D, (8,))
    fresh.load_state_dict(restore_checkpoint(path, {
        "model": fresh.state_dict(), "optimizer": state["optimizer"],
        "step": 0})["model"])
    assert all(torch.equal(a, b) for a, b in
               zip(fresh.state_dict().values(), state["model"].values()))
    restored_opt = torch.optim.Adam(fresh.parameters(), lr=1e-3)
    restored_opt.load_state_dict(raw["optimizer"])
    assert torch.equal(restored_opt.state_dict()["state"][0]["exp_avg"],
                       state["optimizer"]["state"][0]["exp_avg"])

    with pytest.raises(ValueError):  # another width
        restore_checkpoint(path, {
            "model": FNN(t_features(), D + 1, (8,)).state_dict(),
            "optimizer": state["optimizer"], "step": 0})
    with pytest.raises(ValueError):  # another structure
        restore_checkpoint(path, {"weights": torch.zeros(1)})
    with pytest.raises(FileExistsError):
        save_checkpoint(path, state, force=False)
    save_checkpoint(str(tmp_path / "step_12"), {"step": 12})
    save_checkpoint(str(tmp_path / "step_100"), {"step": 100})
    assert [p.rsplit("/", 1)[1] for p in list_step_dirs(str(tmp_path))] == [
        "step_7", "step_12", "step_100"]
    assert latest_step_dir(str(tmp_path)).endswith("step_100")
    assert latest_step_dir(str(tmp_path / "missing")) is None
