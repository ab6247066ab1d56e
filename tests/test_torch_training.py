"""Training and evaluation of the PyTorch port against the JAX package:
losses and metrics on the same probabilities, the device-resident data's
row order, and one epoch of ``fit_device`` from the same initial weights.

Tolerances: BCE and the metric counters are exact up to fp32 rounding
(rtol 1e-6). After an epoch of Adam the weights differ by accumulated fp32
rounding, so the loss gets rtol 1e-4 and AUC atol 1e-3 (a 1e-7 change in a
prediction can move it across one of the 200 thresholds).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_recommenders_torch.convert import deepfm_from_flax
from deep_recommenders_torch.datasets import movielens as t_ml
from deep_recommenders_torch.models.ranking import DeepFM as TDeepFM
from deep_recommenders_torch.training import (
    AUC,
    DeviceData,
    Mean,
    PrecisionRecall,
    Trainer,
    binary_accuracy,
    binary_cross_entropy,
    restore_checkpoint,
)
from deep_recommenders_tpu.datasets import movielens as j_ml
from deep_recommenders_tpu.models.ranking import DeepFM as JDeepFM
from deep_recommenders_tpu.training import Trainer as JTrainer
from deep_recommenders_tpu.training import losses as j_losses
from deep_recommenders_tpu.training import metrics as j_metrics
from deep_recommenders_tpu.training.data import DeviceData as JDeviceData

torch.set_num_threads(1)

D, HIDDEN, BATCH = 8, (16, 8), 256


def test_losses_and_metrics_match_jax(rng):
    logits = rng.normal(0, 2, (1000, 1)).astype(np.float32)
    labels = (rng.random((1000, 1)) < 0.4).astype(np.float32)
    probs = (1 / (1 + np.exp(-logits))).astype(np.float32)
    tl, tp = torch.from_numpy(labels), torch.from_numpy(probs)
    jl, jp = jnp.asarray(labels), jnp.asarray(probs)

    for reduction in ("mean", "sum", "none"):
        np.testing.assert_allclose(
            binary_cross_entropy(torch.from_numpy(logits), tl,
                                 reduction).numpy(),
            np.asarray(j_losses.binary_cross_entropy(
                jnp.asarray(logits), jl, reduction)),
            rtol=1e-6, atol=1e-6,
        )

    auc = AUC()
    state = auc.update(auc.update(auc.init(), tl[:500], tp[:500]),
                       tl[500:], tp[500:])
    j_auc = j_metrics.AUC()
    j_state = j_auc.update(j_auc.update(j_auc.init(), jl[:500], jp[:500]),
                           jl[500:], jp[500:])
    for k in ("tp", "fp", "tn", "fn"):
        np.testing.assert_array_equal(state[k].numpy(),
                                      np.asarray(j_state[k]))
    np.testing.assert_allclose(auc.compute(state).item(),
                               float(j_auc.compute(j_state)), rtol=1e-6)

    pr, j_pr = PrecisionRecall(), j_metrics.PrecisionRecall()
    got = pr.compute(pr.update(pr.init(), tl, tp))
    want = j_pr.compute(j_pr.update(j_pr.init(), jl, jp))
    for k in ("precision", "recall"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6)

    got = Mean.compute(Mean.update(Mean.update(Mean.init(), tp[:300]),
                                   tp[300:]))
    want = j_metrics.Mean.compute(j_metrics.Mean.update(
        j_metrics.Mean.update(j_metrics.Mean.init(), jp[:300]), jp[300:]))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_device_data_rows_match_jax(rng):
    feats = {"a": rng.integers(0, 9, (1000, 3)).astype(np.int32)}
    labels = rng.random((1000, 1)).astype(np.float32)
    got = DeviceData.from_numpy(feats, labels, 96, device="cpu")
    want = JDeviceData.from_numpy(feats, labels, 96)
    assert got.steps_per_epoch == want.steps_per_epoch == 10
    for seed, epoch in ((None, 0), (42, 0), (42, 3)):
        perm = got.permutation(seed, epoch)
        np.testing.assert_array_equal(
            perm.numpy(), np.asarray(want.permutation(seed, epoch))
        )
        gb, gl = got.gather(perm[:96])
        wb, wl = want.gather(want.permutation(seed, epoch)[:96])
        np.testing.assert_array_equal(gb["a"].numpy(), np.asarray(wb["a"]))
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


@pytest.fixture(scope="module")
def jax_epoch():
    """One JAX fit_device epoch on a 4096-rating corpus, and its init."""
    ds = j_ml.MovielensRanking(batch_size=BATCH, num_ratings=4096, seed=42,
                               cache_dir=None)
    trainer = JTrainer(JDeepFM(ds.feature_specs, embedding_dim=D,
                               hidden=HIDDEN), optax.adam(1e-3), seed=0)
    train = JDeviceData.from_numpy(*ds.train_arrays(), BATCH)
    test = JDeviceData.from_numpy(*ds.test_arrays(), BATCH)
    # fit_device initialises from trainer.init on a batch of this shape.
    init = trainer.init(train.gather(train.permutation(None, 0)[:BATCH])[0])
    init_params = jax.tree.map(np.asarray, init.params)
    result = trainer.fit_device(train, test, epochs=1, shuffle_seed=42,
                                verbose=False)
    return init_params, result["history"][0]


def _port_trainer(init_params):
    ds = t_ml.MovielensRanking(batch_size=BATCH, num_ratings=4096, seed=42)
    model = TDeepFM(ds.feature_specs, embedding_dim=D, hidden=HIDDEN)
    model.load_state_dict(deepfm_from_flax(init_params))
    trainer = Trainer(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                      device="cpu")
    return ds, trainer


def _assert_epoch_matches(got, want):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-4)
    for k in ("auc", "precision", "recall"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-3, err_msg=k)


def test_fit_device_epoch_matches_jax(jax_epoch):
    init_params, want = jax_epoch
    ds, trainer = _port_trainer(init_params)
    train = DeviceData.from_numpy(*ds.train_arrays(), BATCH, device="cpu")
    test = DeviceData.from_numpy(*ds.test_arrays(), BATCH, device="cpu")
    result = trainer.fit_device(train, test, epochs=1, shuffle_seed=42,
                                verbose=False)
    assert len(result["step_losses"]) == train.steps_per_epoch
    assert result["history"][0]["loss"] == result["step_losses"][-1]
    _assert_epoch_matches(result["history"][0], want)


def test_fit_streaming_epoch_matches_jax(jax_epoch):
    # Host batches in DeviceData's row order (rng(seed + epoch) over the
    # whole-batch split); test_batches walks the test split in order, as
    # fit_device's evaluation does.
    init_params, want = jax_epoch
    ds, trainer = _port_trainer(init_params)
    feats, labels = ds.train_arrays()

    def train_batches(epoch):
        idx = np.arange(len(labels))
        np.random.default_rng(42 + epoch).shuffle(idx)
        for s in range(len(idx) // BATCH):
            rows = idx[s * BATCH:(s + 1) * BATCH]
            yield {k: v[rows] for k, v in feats.items()}, labels[rows]

    result = trainer.fit(train_batches, lambda: ds.test_batches(), epochs=1,
                         verbose=False)
    _assert_epoch_matches(result["history"][0], want)


def test_fit_device_checkpoints_and_mesh_not_ported(tmp_path):
    """``mesh=`` takes a ("data", "model") DeviceMesh (the meshed trainer
    is held in ``tests/test_torch_parallel.py``) and refuses anything else
    with TypeError; ``checkpoint_dir`` is ported: an epoch leaves
    ``step_0`` with the model's and the optimizer's state dicts (its
    resume is held in ``tests/test_torch_multitask.py``)."""
    model = TDeepFM(t_ml.default_movielens_features(), embedding_dim=4,
                    hidden=(4,))
    opt = torch.optim.Adam(model.parameters())
    with pytest.raises(TypeError, match="DeviceMesh"):
        Trainer(model, opt, mesh=object(), device="cpu")
    linear = torch.nn.Linear(3, 1)
    trainer = Trainer(linear, torch.optim.Adam(linear.parameters()),
                      device="cpu")
    data = DeviceData.from_numpy(np.zeros((4, 3), np.float32),
                                 np.zeros((4, 1), np.float32), 2,
                                 device="cpu")
    ckpt = str(tmp_path / "ckpt")
    trainer.fit_device(data, checkpoint_dir=ckpt, verbose=False)
    state = restore_checkpoint(os.path.join(ckpt, "step_0"))
    assert sorted(state) == ["model", "optimizer"]
    assert torch.equal(state["model"]["weight"], linear.weight.detach())
    assert len(state["optimizer"]["state"]) == 2


def test_merges_and_binary_accuracy_match_jax(rng):
    labels = (rng.random((300, 1)) < 0.4).astype(np.float32)
    probs = rng.random((300, 1)).astype(np.float32)
    halves = (slice(0, 140), slice(140, 300))
    pairs = ((AUC(), j_metrics.AUC()),
             (PrecisionRecall(), j_metrics.PrecisionRecall()))
    for t_metric, j_metric in pairs:
        t_states = [t_metric.update(t_metric.init(),
                                    torch.from_numpy(labels[h]),
                                    torch.from_numpy(probs[h]))
                    for h in halves]
        j_states = [j_metric.update(j_metric.init(), jnp.asarray(labels[h]),
                                    jnp.asarray(probs[h])) for h in halves]
        merged = t_metric.merge(*t_states)
        whole = t_metric.update(t_metric.init(), torch.from_numpy(labels),
                                torch.from_numpy(probs))
        j_merged = j_metric.merge(*j_states)
        for k in merged:
            np.testing.assert_array_equal(merged[k].numpy(),
                                          whole[k].numpy())
            np.testing.assert_array_equal(merged[k].numpy(),
                                          np.asarray(j_merged[k]))
    values, weight = rng.random(300).astype(np.float32), rng.random(300)
    t_states = [Mean.update(Mean.init(), torch.from_numpy(values[h]),
                            weight[h]) for h in halves]
    j_states = [j_metrics.Mean.update(j_metrics.Mean.init(), values[h],
                                      weight[h]) for h in halves]
    merged, j_merged = Mean.merge(*t_states), j_metrics.Mean.merge(*j_states)
    np.testing.assert_allclose(Mean.compute(merged).item(),
                               float(j_metrics.Mean.compute(j_merged)),
                               rtol=1e-6)
    for threshold in (0.5, 0.3):
        np.testing.assert_allclose(
            binary_accuracy(torch.from_numpy(labels), torch.from_numpy(probs),
                            threshold).item(),
            float(j_metrics.binary_accuracy(jnp.asarray(labels),
                                            jnp.asarray(probs), threshold)),
            rtol=1e-6)


def _rows_trainer():
    model = torch.nn.Linear(3, 1)
    return Trainer(model, torch.optim.SGD(model.parameters(), lr=0.1),
                   loss_fn=lambda batch, labels: model(batch).square().mean(),
                   device="cpu")


@pytest.mark.parametrize("labels", ["dict", "tuple", "none"])
def test_fit_counts_rows_of_any_labels(labels, rng):
    """4 batches of 8 rows: 32 examples, whatever the labels' structure
    (the rows of their first array, else of the features)."""
    x = rng.random((8, 3)).astype(np.float32)
    y = {"dict": {"ctr": np.zeros(8), "cvr": np.ones(8)},
         "tuple": (np.zeros((8, 1)), np.zeros((8, 2))),
         "none": None}[labels]
    result = _rows_trainer().fit(lambda epoch: [(x, y)] * 4, epochs=1,
                                 verbose=False)
    assert result["examples"] == 32


def test_fit_takes_both_kinds_of_factory_as_jax(jax_epoch):
    """A factory with no argument is called without one; one that takes
    the epoch gets it. Each against JAX's ``Trainer.fit`` on the same
    batches from the same weights, two epochs."""
    init_params, _ = jax_epoch
    ds, _ = _port_trainer(init_params)
    feats, labels = ds.train_arrays()

    def batches(seed):
        idx = np.arange(len(labels))
        np.random.default_rng(seed).shuffle(idx)
        for s in range(len(idx) // BATCH):
            rows = idx[s * BATCH:(s + 1) * BATCH]
            yield {k: v[rows] for k, v in feats.items()}, labels[rows]

    factories = {"no_argument": lambda: batches(0),
                 "epoch": lambda epoch: batches(epoch)}
    for name, factory in factories.items():
        _, trainer = _port_trainer(init_params)
        got = trainer.fit(factory, epochs=2, verbose=False)
        jtrainer = JTrainer(JDeepFM(ds.feature_specs, embedding_dim=D,
                                    hidden=HIDDEN), optax.adam(1e-3), seed=0)
        want = jtrainer.fit(factory, epochs=2, verbose=False)
        assert got["examples"] == 2 * (len(labels) // BATCH) * BATCH
        for g, w in zip(got["history"], want["history"]):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4,
                                       err_msg=name)
