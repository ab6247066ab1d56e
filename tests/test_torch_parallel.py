"""The port's parallelism against the JAX package, on the CPU.

``MeshConfig.resolve`` runs in this process. Everything else runs in four
gloo processes (tests/torch_parallel_worker.py), spawned once for the file:
a (data=2, model=2) mesh, then a (data=2, model=1) mesh of two of them.
Each process feeds its data coordinate's slice of every global batch and
holds its model coordinate's rows of every table.

Held to the JAX package's UNMESHED result on the same weights, as
tests/test_sharded_embedding.py holds JAX's meshed path to its unmeshed
one: ``sharded_lookup``, ``sharded_embedding_bag`` and
``sharded_fused_rows`` (forward and gradients), and one step of DeepFM, the
xDeepFM flagship, DIN(``num_items``) and ESMM (the loss, rtol 1e-5, and
every gradient, rtol 1e-5 with atol 1e-7 for entries near zero; the table
shards put back together, their padding rows zero). Also:
DeepFM's step against JAX's MESHED step at (2, 2) on four of conftest's
eight virtual devices (the padding and the shard layout), the 5-step
losses of tests/multihost_worker.py's DeepFM at (data=2, model=1) against
``train_losses(mesh=None)``, one epoch of ``fit_device`` over
``DeviceData.from_numpy(mesh=)`` against the unmeshed epoch (and its
sharded checkpoint at model = 2), checkpoints at model = 1 (rank 0 writes,
both resume), merged
evaluation against unmeshed evaluation, and an all-reduce whose backward
sums (``torch.distributed.nn.functional.all_reduce``), which the gradient
check must reject.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import multihost_worker
import torch_parallel_worker as w
from deep_recommenders_torch import convert
from deep_recommenders_torch.models.ranking import DeepFM as TDeepFM
from deep_recommenders_torch.parallel import MeshConfig as TMeshConfig
from deep_recommenders_torch.training import DeviceData, Trainer
from deep_recommenders_tpu.embedding.engine import _offsets, fused_rows
from deep_recommenders_tpu.features import Feature as JFeature
from deep_recommenders_tpu.models.multitask import ESMM as JESMM
from deep_recommenders_tpu.models.ranking import DIN as JDIN
from deep_recommenders_tpu.models.ranking import DeepFM as JDeepFM
from deep_recommenders_tpu.models.ranking import XDeepFM as JXDeepFM
from deep_recommenders_tpu.parallel import MeshConfig as JMeshConfig
from deep_recommenders_tpu.parallel import create_mesh as j_create_mesh
from deep_recommenders_tpu.training import Trainer as JTrainer

torch.set_num_threads(1)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
RTOL, ATOL = 1e-5, 1e-7


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flatten(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            _flatten(v, f"{prefix}/{k}", out)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float32)
    return out


def _j_specs():
    return tuple(JFeature(**{f: getattr(s, f) for f in (
        "name", "hash_buckets", "vocab", "max_len", "combiner")})
        for s in w.specs())


def _ctr_batch(rng, b):
    feats = {
        "u": rng.integers(0, 301, b).astype(np.int32),
        "g": rng.integers(0, 3, b).astype(np.int32),
        "m": rng.integers(0, 400, b).astype(np.int32),
        "tags": rng.integers(0, 19, (b, 4)).astype(np.int32),
        "tags__wt": (rng.random((b, 4)) < 0.8).astype(np.float32),
    }
    return feats, (rng.random((b, 1)) < 0.5).astype(np.float32)


def _bce(logits, labels):
    return optax.sigmoid_binary_cross_entropy(logits, labels).mean()


def _jax_cases(rng):
    """The JAX models' initial weights, global batches, and unmeshed loss
    and gradients; the inputs the workers read."""
    inputs, want = {}, {}
    specs = _j_specs()
    ctr_feats, ctr_labels = _ctr_batch(rng, w.B)
    din_batch = {
        "behaviors": rng.integers(0, w.NUM_ITEMS, (w.B, w.T)).astype(
            np.int32),
        "mask": (rng.random((w.B, w.T)) < 0.8).astype(np.float32),
        "candidate": rng.integers(0, w.NUM_ITEMS, w.B).astype(np.int32),
    }
    esmm_labels = (rng.random((w.B, 2)) < 0.4).astype(np.float32)

    def esmm_loss(model):
        def f(p):
            _, p_ctr, p_ctcvr = model.apply(p, ctr_feats)
            return sum(
                -(y * jnp.log(q + 1e-7) + (1 - y) * jnp.log(1 - q + 1e-7))
                .mean() for q, y in ((p_ctr, esmm_labels[:, :1]),
                                     (p_ctcvr, esmm_labels[:, 1:])))
        return f

    deepfm = JDeepFM(specs, embedding_dim=w.D, hidden=(16,))
    xdeepfm = JXDeepFM(specs, embedding_dim=w.D, cin_feature_maps=(12, 20),
                       cin_activation="relu", hidden=(16, 8))
    din = JDIN(attention_units=8, hidden=(16,), num_items=w.NUM_ITEMS,
               embedding_dim=w.D)
    esmm = JESMM(cvr_hidden=(16,), ctr_hidden=(16,), specs=specs,
                 embedding_dim=w.D)
    cases = {
        "deepfm": (deepfm, (ctr_feats,), ctr_feats, ctr_labels,
                   lambda p: _bce(deepfm.apply(p, ctr_feats), ctr_labels)),
        "xdeepfm": (xdeepfm, (ctr_feats,), ctr_feats, ctr_labels,
                    lambda p: _bce(xdeepfm.apply(p, ctr_feats),
                                   ctr_labels)),
        "din": (din, tuple(din_batch.values()), din_batch, ctr_labels,
                lambda p: _bce(din.apply(p, *din_batch.values()),
                               ctr_labels)),
        "esmm": (esmm, (ctr_feats,), ctr_feats, esmm_labels,
                 esmm_loss(esmm)),
    }
    for name, (model, args, batch, labels, loss) in cases.items():
        params = model.init(jax.random.PRNGKey(0), *args)
        value, grads = jax.value_and_grad(loss)(params)
        _flatten(jax.tree.map(np.asarray, params), f"{name}/params", inputs)
        for k, v in batch.items():
            inputs[f"{name}/batch/{k}"] = v
        inputs[f"{name}/labels"] = labels
        want[name] = (float(value), jax.tree.map(np.asarray, grads))

    # The sharded primitives: a (46, 4) table, a fused (724, 5) table.
    table = rng.normal(size=(46, 4)).astype(np.float32)
    fused_table = rng.normal(size=(724, 5)).astype(np.float32)
    ids = rng.integers(0, 46, w.B).astype(np.int32)
    bag = rng.integers(0, 46, (w.B, 3)).astype(np.int32)
    wt = (rng.random((w.B, 3)) < 0.7).astype(np.float32)
    w_out = rng.normal(size=(w.B, 5)).astype(np.float32)
    pb, _ = _ctr_batch(rng, w.B)
    inputs.update({"prim/table": table, "prim/fused_table": fused_table,
                   "prim/ids": ids, "prim/bag": bag, "prim/wt": wt,
                   "prim/w_out": w_out})
    for k, v in pb.items():
        inputs[f"prim/batch/{k}"] = v

    def prim(fn, tbl):
        def loss(t):
            y = fn(t)
            ww = w_out.reshape(w.B, *([1] * (y.ndim - 2)), -1)
            return jnp.sum(y * ww[..., :y.shape[-1]])
        return fn(jnp.asarray(tbl)), jax.grad(loss)(jnp.asarray(tbl))

    def bag_fn(combiner):
        def f(t):
            s = jnp.einsum("bld,bl->bd", t[bag], wt)
            if combiner == "mean":
                s = s / jnp.maximum(wt.sum(-1, keepdims=True), 1.0)
            return s
        return f

    offsets = _offsets(specs)[0]
    want["prim"] = {
        "lookup": prim(lambda t: t[ids], table),
        "lookup2d": prim(lambda t: t[bag], table),
        "bag_sum": prim(bag_fn("sum"), table),
        "bag_mean": prim(bag_fn("mean"), table),
        "fused": prim(lambda t: fused_rows(t, specs, offsets, pb)[0],
                      fused_table),
    }

    # fit_device: a 128-row split of random CTR rows.
    fit_feats, fit_labels = _ctr_batch(rng, w.FIT_ROWS)
    for k, v in fit_feats.items():
        inputs[f"fit/feats/{k}"] = v
    inputs["fit/labels"] = fit_labels

    # tests/multihost_worker.py's DeepFM: JAX's initial weights and losses.
    trainer = JTrainer(JDeepFM(multihost_worker.specs(), embedding_dim=8,
                               hidden=(16,)), optax.sgd(0.5), seed=0)
    feats0, _ = multihost_worker.global_batch(0)
    init = trainer.init({k: jnp.asarray(v) for k, v in feats0.items()})
    _flatten(jax.tree.map(np.asarray, init.params), "multihost/params",
             inputs)
    want["multihost"] = multihost_worker.train_losses(mesh=None)
    return inputs, want


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's side here, then the four workers once; returns (inputs, the
    JAX results, each rank's results)."""
    tmp = tmp_path_factory.mktemp("parallel")
    inputs, want = _jax_cases(np.random.default_rng(0))
    np.savez(tmp / "inputs.npz", **inputs)
    ports = [str(_free_port()), str(_free_port())]
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "torch_parallel_worker.py"),
             *ports, str(rank), str(tmp), str(tmp)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for rank in range(4)
    ]
    outputs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outputs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]
    return inputs, want, ranks


def _by_model(ranks, data=0):
    """The ranks of data coordinate ``data``, in model order."""
    got = [r for r in ranks if r["coords"][0] == data]
    return sorted(got, key=lambda r: r["coords"][1])


def _grads(ranks, name, data=0):
    """The model's gradient state dict, table shards put back together."""
    states = []
    for r in _by_model(ranks, data):
        prefix = f"{name}/grad/"
        states.append({k[len(prefix):]: torch.from_numpy(v)
                       for k, v in r.items() if k.startswith(prefix)})
    return {k: v.numpy() for k, v in convert.join_shards(states).items()}


CONVERTERS = {"deepfm": convert.deepfm_from_flax,
              "xdeepfm": convert.xdeepfm_from_flax,
              "din": convert.din_from_flax,
              "esmm": convert.esmm_from_flax}


def _check_grads(got, want_tree, name):
    want = {k: v.numpy() for k, v in CONVERTERS[name](want_tree).items()}
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        ref = want[k]
        if g.shape[0] != ref.shape[0]:  # a padded table: padding rows zero
            np.testing.assert_array_equal(g[ref.shape[0]:], 0.0)
            g = g[:ref.shape[0]]
        np.testing.assert_allclose(g, ref, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name}: {k}")


def test_mesh_config_resolve_matches_jax():
    cases = [(-1, 1, 8), (2, -1, 8), (2, 4, 8), (1, 1, 1), (-1, 2, 4),
             (4, 1, 4), (-1, -1, 4), (3, 1, 4), (2, 3, 8), (-1, 3, 8)]
    for data, model, n in cases:
        results = []
        for cls in (TMeshConfig, JMeshConfig):
            try:
                results.append(cls(data, model).resolve(n))
            except ValueError as e:
                results.append(("ValueError", str(e)))
        assert results[0] == results[1], (data, model, n)


def test_ranks_lie_on_the_mesh_row_major(run):
    """Rank = data index x 2 + model index; ``replicate_on_mesh`` gives
    every rank rank 0's value; the default mesh is the one set."""
    _, _, ranks = run
    assert [tuple(r["coords"]) for r in ranks] == [(0, 0), (0, 1), (1, 0),
                                                   (1, 1)]
    for r in ranks:
        assert r["replicated"].tolist() == [0, 7]
        assert r["default_mesh"]


@pytest.mark.parametrize("case", ["lookup", "lookup2d", "bag_sum",
                                  "bag_mean", "fused"])
def test_sharded_primitives_match_dense(run, case):
    _, want, ranks = run
    out, grad = (np.asarray(x) for x in want["prim"][case])
    b = w.B // 2
    for r in ranks:
        d = r["coords"][0]
        np.testing.assert_allclose(r[f"prim/{case}/out"],
                                   out[d * b:(d + 1) * b],
                                   rtol=RTOL, atol=ATOL)
    for d in (0, 1):
        shards = _by_model(ranks, d)
        np.testing.assert_allclose(
            np.concatenate([r[f"prim/{case}/grad"] for r in shards]), grad,
            rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["deepfm", "xdeepfm", "din", "esmm"])
def test_meshed_step_matches_jax_unmeshed(run, name):
    _, want, ranks = run
    loss, grads = want[name]
    for r in ranks:
        np.testing.assert_allclose(float(r[f"{name}/loss"]), loss,
                                   rtol=RTOL)
    got = _grads(ranks, name)
    # Both data coordinates hold the same all-reduced gradients.
    other = _grads(ranks, name, data=1)
    for k in got:
        np.testing.assert_array_equal(got[k], other[k])
    _check_grads(got, grads, name)


def test_deepfm_step_matches_jax_meshed_layout(run):
    """JAX's meshed DeepFM at (2, 2) on four virtual devices: its padded
    table's gradient, row for row, is the port's shards put together."""
    inputs, want, ranks = run
    mesh = j_create_mesh(JMeshConfig(data=2, model=2),
                         devices=jax.devices()[:4])
    model = JDeepFM(_j_specs(), embedding_dim=w.D, hidden=(16,), mesh=mesh)
    flat = {k[len("deepfm/params/"):]: v for k, v in inputs.items()
            if k.startswith("deepfm/params/")}
    feats = {k[len("deepfm/batch/"):]: v for k, v in inputs.items()
             if k.startswith("deepfm/batch/")}
    labels = inputs["deepfm/labels"]
    params = model.init(jax.random.PRNGKey(0), feats)
    params = jax.tree.map(np.array, params)
    table = params["params"]["embeddings"]["table"]
    table[:] = 0.0
    src = flat["params/embeddings/table"]
    table[:src.shape[0]] = src
    for k, v in flat.items():
        if k != "params/embeddings/table":
            node = params
            *path, leaf = k.split("/")
            for p in path:
                node = node[p]
            node[leaf] = v
    value, grads = jax.jit(jax.value_and_grad(
        lambda p: _bce(model.apply(p, feats), labels)))(params)
    np.testing.assert_allclose(float(ranks[0]["deepfm/loss"]), float(value),
                               rtol=RTOL)
    got = _grads(ranks, "deepfm")
    want_table = np.asarray(grads["params"]["embeddings"]["table"])
    assert got["embeddings.table"].shape == want_table.shape == (724, w.D)
    np.testing.assert_allclose(got["embeddings.table"], want_table,
                               rtol=RTOL, atol=ATOL)


def test_all_reduce_with_summing_backward_is_rejected(run):
    """``torch.distributed.nn.functional.all_reduce`` sums the cotangents
    in its backward: at model = 2 every table gradient doubles, and the
    gradient check fails."""
    _, want, ranks = run
    got = _grads(ranks, "deepfm_summing_backward")
    ref = convert.deepfm_from_flax(want["deepfm"][1])["embeddings.table"]
    table = got["embeddings.table"][:ref.shape[0]]
    np.testing.assert_allclose(table, 2 * ref.numpy(), rtol=1e-4, atol=1e-6)
    with pytest.raises(AssertionError):
        _check_grads(got, want["deepfm"][1], "deepfm")


def _unmeshed_deepfm(inputs):
    model = TDeepFM(w.specs(), w.D, (16,))
    model.load_state_dict(convert.deepfm_from_flax(
        w.unflatten(inputs, "deepfm/params")))
    return model


def test_merged_evaluation_equals_unmeshed(run):
    inputs, _, ranks = run
    model = _unmeshed_deepfm(inputs)
    trainer = Trainer(model, torch.optim.SGD(model.parameters(), lr=0.0),
                      device="cpu")
    feats = {k[len("deepfm/batch/"):]: v for k, v in inputs.items()
             if k.startswith("deepfm/batch/")}
    want = trainer.evaluate(lambda: [(feats, inputs["deepfm/labels"])] * 2)
    for r in ranks:
        for k, v in want.items():
            np.testing.assert_allclose(float(r[f"deepfm/eval/{k}"]), v,
                                       rtol=RTOL, err_msg=k)


def test_fit_device_over_a_mesh_matches_unmeshed(run):
    inputs, _, ranks = run
    model = _unmeshed_deepfm(inputs)
    trainer = Trainer(model, torch.optim.Adam(model.parameters(), lr=1e-2),
                      device="cpu")
    feats = {k[len("fit/feats/"):]: v for k, v in inputs.items()
             if k.startswith("fit/feats/")}
    data = DeviceData.from_numpy(feats, inputs["fit/labels"], w.FIT_BATCH,
                                 device="cpu")
    want = trainer.fit_device(data, data, epochs=1, shuffle_seed=3,
                              verbose=False)
    assert len(want["step_losses"]) == w.FIT_ROWS // w.FIT_BATCH
    for r in ranks:
        np.testing.assert_allclose(r["fit/step_losses"],
                                   want["step_losses"], rtol=RTOL)
        for k, v in want["history"][0].items():
            np.testing.assert_allclose(float(r[f"fit/history/{k}"]), v,
                                       rtol=1e-4, err_msg=k)
        # At model = 2 the checkpoint is sharded: each model coordinate's
        # file, written by data coordinate 0, and the mesh's record.
        assert r["fit/checkpoint_files"].tolist() == [
            "model_0.pt", "model_1.pt", "sharding.json"]


def test_two_process_losses_match_multihost_worker(run):
    _, want, ranks = run
    for r in ranks[:2]:
        np.testing.assert_allclose(r["multihost/losses"], want["multihost"],
                                   rtol=RTOL)
    assert abs(want["multihost"][-1] - want["multihost"][0]) > 1e-4


def test_data_parallel_checkpoints_resume(run):
    """At model = 1 rank 0 writes ``step_{epoch}`` and both ranks resume
    from it: a first epoch, then epoch 1 alone."""
    _, _, ranks = run
    for r in ranks[:2]:
        assert r["multihost/ckpt_epochs"].tolist() == [0, 1]
        assert r["multihost/ckpt_dirs"].tolist() == ["step_0", "step_1"]
