"""The multitask family of the PyTorch port against the JAX package: the
synthetic two-task data (equal exactly), MMoE and ESMM (the dense and the
``specs`` modes) through their converters (outputs, loss, every gradient,
one Adam step), the multitask evals and losses, ``mean_squared_error`` and
``Mean.update(weight=)`` on the same outputs, ``DeviceData`` with tensor
and tuple features, ``fit_device``'s checkpoints (a resume bit for bit
against an uninterrupted run on the CPU, and pruning), the MMoE example at
a tiny size, and the parts that raise until the port has sharding.

Tolerances as ``test_torch_ranking.py``'s: rtol 1e-5 on outputs and
losses, gradients within rtol 1e-4 and 1e-6 of the largest gradient of
their tensor, the Adam step within 1e-6 plus what that moves a first step.
The evals read the same outputs on both sides: MSE and BCE sums to rtol
1e-6, AUC (the same threshold counts) to 1e-6.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_recommenders_torch import convert
from deep_recommenders_torch.datasets import (
    SyntheticForMultiTask,
    default_movielens_features as t_features,
    synthetic_two_task,
)
from deep_recommenders_torch.examples import train_mmoe_on_synthetic
from deep_recommenders_torch.models import multitask as tm
from deep_recommenders_torch.models.ranking import DIN
from deep_recommenders_torch.training import (
    DeviceData,
    Mean,
    MultiTaskBCEEval,
    MultiTaskMSEEval,
    Trainer,
    list_step_dirs,
    mean_squared_error,
    multitask_mse_loss,
)
from deep_recommenders_tpu.datasets import synthetic_multitask as j_synth
from deep_recommenders_tpu.datasets.movielens import (
    default_movielens_features as j_features,
)
from deep_recommenders_tpu.models import multitask as jm
from deep_recommenders_tpu.training import evaluation as j_eval
from deep_recommenders_tpu.training import losses as j_losses
from deep_recommenders_tpu.training import metrics as j_metrics
from deep_recommenders_tpu.training.data import gather_rows as j_gather

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_ranking as base  # noqa: E402

torch.set_num_threads(1)

B, X, TASKS, EXPERTS = 32, 12, 2, 3
MMOE_WIDTHS = dict(expert_hidden=(8,), expert_dim=6, tower_hidden=(5,))
ESMM_HIDDEN = (10, 6)


def draw_biases(params, rng):
    """flax zero-initialises biases: draw them normal so that they count."""
    for key, value in params.items():
        if isinstance(value, dict):
            draw_biases(value, rng)
        elif key == "bias":
            params[key] = rng.normal(0, 0.3, value.shape).astype(np.float32)
    return params


def esmm_bce(outputs, labels, log):
    """The zoo's ESMM loss: BCE on the probabilities p_ctr (label column 0)
    and p_ctcvr (column 1), eps 1e-7 (benchmarks/run_models.py:245-251)."""
    _, p_ctr, p_ctcvr = outputs

    def bce(p, y):
        return -(y * log(p + 1e-7) + (1 - y) * log(1 - p + 1e-7)).mean()

    return bce(p_ctr, labels[:, :1]) + bce(p_ctcvr, labels[:, 1:])


def _mmoe(rng):
    x = rng.normal(size=(B, X)).astype(np.float32)
    labels = rng.normal(size=(B, TASKS)).astype(np.float32)
    j_model = jm.MMoE(num_tasks=TASKS, num_experts=EXPERTS, **MMOE_WIDTHS)
    params = draw_biases(jax.tree.map(np.array, j_model.init(
        jax.random.PRNGKey(0), jnp.asarray(x))), rng)
    t_model = tm.MMoE(X, TASKS, EXPERTS, **MMOE_WIDTHS)
    t_model.load_state_dict(convert.mmoe_from_flax(params))
    jloss = j_eval.multitask_mse_loss(j_model, TASKS)
    return {
        "x": x, "labels": labels, "j_model": j_model, "params": params,
        "t_model": t_model, "convert": convert.mmoe_from_flax,
        "j_batch": jnp.asarray(x), "t_batch": torch.from_numpy(x),
        "j_loss": lambda p: jloss(p, jnp.asarray(x), jnp.asarray(labels)),
        "t_loss": lambda m: multitask_mse_loss(m, TASKS)(
            torch.from_numpy(x), torch.from_numpy(labels)),
    }


def _esmm(rng, specs):
    ctr = (rng.random((B, 1)) < 0.5).astype(np.float32)
    labels = np.concatenate(
        [ctr, ctr * (rng.random((B, 1)) < 0.3)], axis=1).astype(np.float32)
    if specs:
        batch, _ = base.make_batch(rng, B)
        j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
        t_batch = base.torch_batch(batch)
        j_model = jm.ESMM(ESMM_HIDDEN, ESMM_HIDDEN, specs=j_features(),
                          embedding_dim=4)
        t_model = tm.ESMM(None, ESMM_HIDDEN, ESMM_HIDDEN, specs=t_features(),
                          embedding_dim=4)
    else:
        x = rng.normal(size=(B, X)).astype(np.float32)
        j_batch, t_batch = jnp.asarray(x), torch.from_numpy(x)
        j_model = jm.ESMM(ESMM_HIDDEN, ESMM_HIDDEN)
        t_model = tm.ESMM(X, ESMM_HIDDEN, ESMM_HIDDEN)
    params = draw_biases(jax.tree.map(np.array, j_model.init(
        jax.random.PRNGKey(0), j_batch)), rng)
    t_model.load_state_dict(convert.esmm_from_flax(params))
    return {
        "labels": labels, "j_model": j_model, "params": params,
        "t_model": t_model, "convert": convert.esmm_from_flax,
        "j_batch": j_batch, "t_batch": t_batch,
        "j_loss": lambda p: esmm_bce(j_model.apply(p, j_batch),
                                     jnp.asarray(labels), jnp.log),
        "t_loss": lambda m: esmm_bce(m(t_batch), torch.from_numpy(labels),
                                     torch.log),
    }


CASES = {"mmoe": _mmoe,
         "esmm_dense": lambda rng: _esmm(rng, False),
         "esmm_specs": lambda rng: _esmm(rng, True)}


def test_synthetic_two_task_equals_jax_exactly():
    """The arrays, the batches and the column view, bit for bit."""
    x, (y1, y2) = synthetic_two_task(300, 16, c=0.4, p=0.6, m=4, seed=3)
    jx, (jy1, jy2) = j_synth.synthetic_two_task(300, 16, c=0.4, p=0.6, m=4,
                                                seed=3)
    for a, b in ((x, jx), (y1, jy1), (y2, jy2)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    ds = SyntheticForMultiTask(300, 16, seed=5)
    jds = j_synth.SyntheticForMultiTask(300, 16, seed=5)
    got = list(ds.batches(epochs=2, batch_size=64))
    want = list(jds.batches(epochs=2, batch_size=64))
    assert len(got) == len(want) == 8
    for (f, l), (jf, jl) in zip(got, want):
        np.testing.assert_array_equal(f["features"], jf["features"])
        for k in ("labels0", "labels1"):
            np.testing.assert_array_equal(l[k], jl[k])
    view = SyntheticForMultiTask.column_view(got[0][0]["features"])
    jview = j_synth.SyntheticForMultiTask.column_view(want[0][0]["features"])
    assert sorted(view) == sorted(jview) and len(view) == 16
    for k in view:
        np.testing.assert_array_equal(view[k], jview[k])


@pytest.mark.parametrize("name", sorted(CASES))
def test_multitask_model_matches_flax(rng, name):
    """Every output, the loss and every gradient against flax on converted
    weights."""
    case = CASES[name](rng)
    j_model, params = case["j_model"], case["params"]
    want = [np.asarray(o) for o in j_model.apply(params, case["j_batch"])]
    want_loss, want_grads = jax.value_and_grad(case["j_loss"])(params)
    t_model = case["t_model"]
    got = t_model(case["t_batch"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == (B, 1) and g.dtype == torch.float32
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-5,
                                   atol=1e-6)
    loss = case["t_loss"](t_model)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    base.assert_grads_close(base.torch_grads(t_model), case["convert"](
        jax.tree.map(np.asarray, want_grads)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_multitask_adam_step_matches_optax(rng, name):
    """One Adam step of lr 1e-3 against optax's."""
    lr, eps = 1e-3, 1e-8
    case = CASES[name](rng)
    params, conv = case["params"], case["convert"]
    opt = optax.adam(lr)
    grads = jax.grad(case["j_loss"])(params)
    updates, _ = opt.update(grads, opt.init(params), params)
    want = conv(jax.tree.map(np.asarray, optax.apply_updates(params,
                                                              updates)))
    grads = conv(jax.tree.map(np.asarray, grads))
    t_model = case["t_model"]
    t_opt = torch.optim.Adam(t_model.parameters(), lr=lr)
    case["t_loss"](t_model).backward()
    t_opt.step()
    base.assert_adam_step_close(t_model.state_dict(), want, grads, lr, eps)


def test_mmoe_parameters_are_stacked_and_named_as_flax(rng):
    """The experts' parameters carry a leading expert axis in flax's (in,
    out) layout, and run as one contraction: expert e's output is its own
    MLP's, computed alone."""
    model = tm.MMoE(X, TASKS, EXPERTS, **MMOE_WIDTHS,
                    generator=torch.Generator().manual_seed(0))
    names = dict(model.named_parameters())
    assert tuple(names["experts.kernels.0"].shape) == (EXPERTS, X, 8)
    assert tuple(names["experts.kernels.1"].shape) == (EXPERTS, 8, 6)
    assert tuple(names["experts.biases.1"].shape) == (EXPERTS, 6)
    assert {"gate_0.weight", "gate_1.bias", "tower_1.dense.1.weight"} <= set(
        names)
    x = torch.from_numpy(rng.normal(size=(5, X)).astype(np.float32))
    with torch.no_grad():
        out = model.experts(x)
        e = 2
        k0, k1 = model.experts.kernels
        b0, b1 = model.experts.biases
        alone = torch.relu(x @ k0[e] + b0[e]) @ k1[e] + b1[e]
    assert out.shape == (5, EXPERTS, 6)
    torch.testing.assert_close(out[:, e], alone)


# -- evals and losses on the same outputs -----------------------------------

class _FixedJax:
    def __init__(self, outputs):
        self.outputs = [jnp.asarray(o) for o in outputs]

    def apply(self, params, batch, training=False, rngs=None):
        return self.outputs


class _FixedTorch(torch.nn.Module):
    def __init__(self, outputs):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(1))
        self.outputs = [torch.from_numpy(o) for o in outputs]

    def forward(self, batch):
        return self.outputs


def _run_eval(spec, labels, n_batches):
    state = spec.init()
    for i in range(n_batches):
        rows = slice(i * B, (i + 1) * B)
        state = spec.update(None, labels[rows], state)
    return spec.compute(state)


def _run_j_eval(spec, labels, n_batches):
    state = spec.init()
    for i in range(n_batches):
        rows = slice(i * B, (i + 1) * B)
        state = spec.update({}, None, jnp.asarray(labels[rows]), state)
    return spec.compute(state)


def test_multitask_mse_eval_and_loss_match_jax(rng):
    """MultiTaskMSEEval over two batches, multitask_mse_loss and
    mean_squared_error on the same outputs."""
    outputs = [rng.normal(size=(B, 1)).astype(np.float32) for _ in range(3)]
    labels = rng.normal(size=(B, 3)).astype(np.float32)
    got = _run_eval(MultiTaskMSEEval(_FixedTorch(outputs), 3),
                    torch.from_numpy(np.tile(labels, (2, 1))), 2)
    want = _run_j_eval(j_eval.MultiTaskMSEEval(_FixedJax(outputs), 3),
                       np.tile(labels, (2, 1)), 2)
    assert sorted(got) == sorted(want) == ["mse_0", "mse_1", "mse_2",
                                           "val_loss"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    t_loss = multitask_mse_loss(_FixedTorch(outputs), 3)(
        None, torch.from_numpy(labels))
    j_loss = j_eval.multitask_mse_loss(_FixedJax(outputs), 3)(
        {}, None, jnp.asarray(labels))
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-6)
    np.testing.assert_allclose(
        mean_squared_error(torch.from_numpy(outputs[0]),
                           torch.from_numpy(labels[:, :1])).item(),
        float(j_losses.mean_squared_error(jnp.asarray(outputs[0]),
                                          jnp.asarray(labels[:, :1]))),
        rtol=1e-6)


@pytest.mark.parametrize("names,indices", [(None, None),
                                           (("ctr", "ctcvr"), (1, 2))])
def test_multitask_bce_eval_matches_jax(rng, names, indices):
    """MultiTaskBCEEval over two batches: per-task AUC, BCE on the
    probabilities with eps 1e-7, val_loss; default names and indices, and
    ESMM's (ctr, ctcvr) on outputs (1, 2)."""
    n = 2 * B
    probs = [1 / (1 + np.exp(-rng.normal(size=(n, 1)))) for _ in range(3)]
    probs = [p.astype(np.float32) for p in probs]
    labels = (rng.random((n, 2)) < 0.4).astype(np.float32)

    def batches(side, outputs):
        # Each batch's outputs are the rows of that batch.
        return [side([o[i * B:(i + 1) * B] for o in outputs])
                for i in range(2)]

    t_spec = [MultiTaskBCEEval(m, 2, names, indices)
              for m in batches(_FixedTorch, probs)]
    j_spec = [j_eval.MultiTaskBCEEval(m, 2, names, indices)
              for m in batches(_FixedJax, probs)]
    state, j_state = t_spec[0].init(), j_spec[0].init()
    for i in range(2):
        rows = slice(i * B, (i + 1) * B)
        state = t_spec[i].update(None, torch.from_numpy(labels[rows]), state)
        j_state = j_spec[i].update({}, None, jnp.asarray(labels[rows]),
                                   j_state)
    got, want = t_spec[0].compute(state), j_spec[0].compute(j_state)
    assert sorted(got) == sorted(want)
    assert ("auc_ctr" in got) == (names is not None)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_mean_with_weights_matches_jax(rng):
    """Mean.update with and without weight=, over two updates."""
    v = rng.normal(size=(2, 10)).astype(np.float32)
    w = rng.random((2, 10)).astype(np.float32)
    for weights in (None, w):
        state, j_state = Mean.init(), j_metrics.Mean.init()
        for i in range(2):
            wt = None if weights is None else weights[i]
            state = Mean.update(state, torch.from_numpy(v[i]),
                                None if wt is None else torch.from_numpy(wt))
            j_state = j_metrics.Mean.update(j_state, jnp.asarray(v[i]),
                                            None if wt is None
                                            else jnp.asarray(wt))
        for k in ("total", "count"):
            np.testing.assert_allclose(state[k].item(), float(j_state[k]),
                                       rtol=1e-6)
        np.testing.assert_allclose(Mean.compute(state).item(),
                                   float(j_metrics.Mean.compute(j_state)),
                                   rtol=1e-6)


# -- data and the trainer's checkpoints --------------------------------------

def test_device_data_with_tensor_and_tuple_features(rng):
    """A bare (N, d) matrix and a (dict, matrix) tuple: the structure kept,
    rows gathered as JAX's gather_rows gathers them."""
    x = rng.normal(size=(40, 3)).astype(np.float32)
    ids = {"a": rng.integers(0, 9, 40).astype(np.int32),
           "b": rng.integers(0, 9, (40, 2)).astype(np.int32)}
    labels = rng.normal(size=(40, 2)).astype(np.float32)
    rows = np.array([5, 0, 39, 7], np.int64)
    for feats in (x, (ids, x)):
        data = DeviceData.from_numpy(feats, labels, 4, device="cpu")
        assert data.num_examples == 40 and data.steps_per_epoch == 10
        got, got_labels = data.gather(torch.from_numpy(rows))
        want, want_labels = j_gather(feats, labels, jnp.asarray(rows))
        np.testing.assert_array_equal(got_labels.numpy(), want_labels)
        if isinstance(feats, tuple):
            assert isinstance(got, tuple) and set(got[0]) == {"a", "b"}
            for k in ids:
                np.testing.assert_array_equal(got[0][k].numpy(), want[0][k])
            got, want = got[1], want[1]
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), want)


def _mmoe_trainer(seed):
    model = tm.MMoE(X, TASKS, EXPERTS, **MMOE_WIDTHS,
                    generator=torch.Generator().manual_seed(seed))
    return Trainer(model, torch.optim.Adam(model.parameters(), lr=1e-2),
                   loss_fn=multitask_mse_loss(model, TASKS),
                   eval_spec=MultiTaskMSEEval(model, TASKS), device="cpu")


@pytest.fixture
def mmoe_data():
    x, (y1, y2) = synthetic_two_task(640, X, seed=3)
    labels = np.stack([y1, y2], axis=1)
    return (DeviceData.from_numpy(x[128:], labels[128:], 64, device="cpu"),
            DeviceData.from_numpy(x[:128], labels[:128], 64, device="cpu"))


def test_fit_device_resume_is_bitwise_the_uninterrupted_run(mmoe_data,
                                                             tmp_path):
    """2 epochs straight against 1 epoch, then a fresh model (other initial
    weights) and optimizer resumed from its checkpoint for the 2nd: the same
    parameters and Adam state bit for bit, the same losses of epoch 1."""
    train, evald = mmoe_data
    straight = _mmoe_trainer(0)
    full = straight.fit_device(train, evald, epochs=2, shuffle_seed=7,
                               verbose=False)
    ckpt = str(tmp_path / "ckpt")
    first = _mmoe_trainer(0).fit_device(train, evald, epochs=1,
                                        shuffle_seed=7, checkpoint_dir=ckpt,
                                        verbose=False)
    assert [os.path.basename(d) for d in list_step_dirs(ckpt)] == ["step_0"]
    resumed = _mmoe_trainer(1)
    second = resumed.fit_device(train, evald, epochs=2, shuffle_seed=7,
                                checkpoint_dir=ckpt, verbose=False)
    assert [h["epoch"] for h in second["history"]] == [1]
    steps = train.steps_per_epoch
    assert len(first["step_losses"]) == len(second["step_losses"]) == steps
    np.testing.assert_array_equal(second["step_losses"],
                                  full["step_losses"][steps:])
    for (name, a), b in zip(straight.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    for a, b in zip(straight.optimizer.state_dict()["state"].values(),
                    resumed.optimizer.state_dict()["state"].values()):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert second["history"][0]["val_loss"] == full["history"][1]["val_loss"]
    # Nothing left to train: no epoch runs.
    done = _mmoe_trainer(1).fit_device(train, None, epochs=2,
                                       checkpoint_dir=ckpt, verbose=False)
    assert done["history"] == [] and len(done["step_losses"]) == 0


def test_fit_device_prunes_checkpoints_across_restarts(mmoe_data, tmp_path):
    """keep_checkpoint_max counts the directories an earlier run left;
    checkpoint_every_epochs skips the others."""
    train, _ = mmoe_data
    ckpt = str(tmp_path / "ckpt")

    def steps():
        return [os.path.basename(d) for d in list_step_dirs(ckpt)]

    _mmoe_trainer(0).fit_device(train, epochs=3, checkpoint_dir=ckpt,
                                keep_checkpoint_max=2, verbose=False)
    assert steps() == ["step_1", "step_2"]
    _mmoe_trainer(0).fit_device(train, epochs=5, checkpoint_dir=ckpt,
                                keep_checkpoint_max=2, verbose=False)
    assert steps() == ["step_3", "step_4"]
    every = str(tmp_path / "every")
    _mmoe_trainer(0).fit_device(train, epochs=4, checkpoint_dir=every,
                                checkpoint_every_epochs=2, verbose=False)
    assert [os.path.basename(d) for d in list_step_dirs(every)] == [
        "step_1", "step_3"]


def test_mmoe_example_with_checkpoints_on_the_cpu(tmp_path, capsys):
    """The ported example at a tiny size: 1 epoch with --checkpoint-dir and
    --out, then --epochs 2 on the same directory resumes at epoch 1 and
    trains one epoch only."""
    tiny = ["--num-examples", "2048", "--example-dim", "16",
            "--batch-size", "128", "--device", "cpu",
            "--checkpoint-dir", str(tmp_path / "ckpt")]
    out = tmp_path / "result.json"
    first = train_mmoe_on_synthetic.main(tiny + ["--out", str(out)])
    assert [h["epoch"] for h in first["history"]] == [0]
    assert len(first["step_losses"]) == (2048 - 204) // 128
    written = json.loads(out.read_text())
    assert written["model"] == "MMoE" and np.isfinite(written["mse_task0"])
    second = train_mmoe_on_synthetic.main(tiny + ["--epochs", "2"])
    assert [h["epoch"] for h in second["history"]] == [1]
    assert len(second["step_losses"]) == len(first["step_losses"])
    last = second["history"][-1]
    assert np.isfinite(last["mse_0"]) and np.isfinite(last["mse_1"])
    text = capsys.readouterr().out
    assert "resumed from" in text and "final: task0 mse" in text


def test_parts_without_sharding_raise():
    """Expert parallelism takes the default mesh, which needs a process
    group (RuntimeError here; tests/test_torch_parallel_models.py runs it
    on one), and its experts must divide over the model axis (ValueError);
    ``shard_expert_params`` and ``mesh=`` take a ("data", "model")
    DeviceMesh (tests/test_torch_parallel.py) and refuse anything else
    with TypeError, and ESMM's mesh needs its specs (ValueError, as JAX);
    ESMM takes exactly one of input_dim and specs."""
    with pytest.raises(RuntimeError, match="process group"):
        tm.MMoE(X, expert_parallel=True)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tm.shard_expert_params({}, object())
    with pytest.raises(ValueError, match="divide"):
        tm.expert_range(5, 2, 0)
    assert tm.expert_range(4, 2, 1) == (2, 4)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tm.ESMM(specs=t_features(), mesh=object())
    with pytest.raises(ValueError, match="requires specs"):
        tm.ESMM(input_dim=4, mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        DIN(num_items=10, mesh=object())
    with pytest.raises(ValueError):
        tm.ESMM()
    with pytest.raises(ValueError):
        tm.ESMM(X, specs=t_features())
