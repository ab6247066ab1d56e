"""The port's meshed models against the JAX package's, on the CPU.

JAX's side runs here on four of conftest's eight virtual devices. The
port's runs in four gloo processes (tests/torch_parallel_worker.py's
``models`` form, one thread each), spawned once for the file: a (data=2,
model=2) mesh, then (1, 4), then two of them at (1, 2) and at (2, 1).

- The two-tower with ``mesh=`` and ``Retrieval(axis_name="data", mesh=)``
  against JAX's meshed TwoTower and pod-wide loss at (2, 2), as
  tests/test_two_tower_mesh.py sets them up: the loss (rtol 1e-5) and
  every gradient (rtol 1e-4, atol 1e-6), the tables put back together
  from their shards; the same with the log-Q correction and
  accidental-negative removal; one Adagrad step of ``Trainer(mesh=)``
  against the port's unmeshed step on the global batch (rtol 1e-5, atol
  1e-7: the sums run in other orders).
- ``sharded_top_k`` and ``ShardedBruteForce`` at (1, 2), (2, 2) and
  (1, 4) against JAX's (whose results do not depend on the mesh, so each
  of its calls runs on one of them) on a corpus of 37 rows (padded at
  every model size), k within a shard, past a shard and past the corpus: ids equal
  (the data has no ties), scores rtol 1e-6 with atol 1e-6 of the row's
  largest score (the fp32 rounding of the larger products); integer and
  string
  identifiers, a query model, exclusions, data-sharded queries,
  FactorizedTopK over the index, and ``save_index``/``load_index(mesh=)``.
- MMoE with ``expert_parallel=True`` at (2, 2) against JAX's: the loss
  (rtol 1e-5) and every gradient (rtol 1e-4, atol 1e-6).
- Sharded checkpoints at (1, 2): one epoch saved and resumed by a fresh
  model and optimizer gives the step losses of two uninterrupted epochs
  bit for bit; the checkpoint restored at (2, 1) and unmeshed is the
  shards' joined state, Adam's moments included, bit for bit.
- ``load_model(mesh=)`` at (1, 2) against the unmeshed load (logits rtol
  1e-6), and the artifact a meshed model saves, loaded unmeshed.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as w
from deep_recommenders_torch import convert
from deep_recommenders_torch.models.ranking import DeepFM as TDeepFM
from deep_recommenders_torch.models.retrieval import Retrieval as TRetrieval
from deep_recommenders_torch.models.retrieval import TwoTower as TTwoTower
from deep_recommenders_torch.serving.model_io import load_model, save_model
from deep_recommenders_torch.training import (
    Adagrad,
    Trainer,
    restore_train_state,
)
from deep_recommenders_torch.training.evaluation import retrieval_loss
from deep_recommenders_tpu.features import Feature as JFeature
from deep_recommenders_tpu.models.multitask import MMoE as JMMoE
from deep_recommenders_tpu.models.multitask.mmoe import (
    shard_expert_params as j_shard_expert_params,
)
from deep_recommenders_tpu.models.ranking import DeepFM as JDeepFM
from deep_recommenders_tpu.models.retrieval import Retrieval as JRetrieval
from deep_recommenders_tpu.models.retrieval import TwoTower as JTwoTower
from deep_recommenders_tpu.models.retrieval.factorized_top_k import (
    FactorizedTopK as JFactorizedTopK,
)
from deep_recommenders_tpu.models.retrieval.factorized_top_k import (
    ShardedBruteForce as JShardedBruteForce,
)
from deep_recommenders_tpu.ops.topk import sharded_top_k as j_sharded_top_k
from deep_recommenders_tpu.parallel import MeshConfig as JMeshConfig
from deep_recommenders_tpu.parallel import create_mesh as j_create_mesh
from deep_recommenders_tpu.parallel import shard_batch as j_shard_batch

torch.set_num_threads(1)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
MESHES = {"2x2": (2, 2), "1x2": (1, 2), "1x4": (1, 4)}
KS = (5, 12, 40)


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


def _j_specs(specs):
    return tuple(JFeature(**{f: getattr(s, f) for f in (
        "name", "hash_buckets", "vocab", "max_len", "combiner")})
        for s in specs)


def _jmesh(shape):
    return j_create_mesh(JMeshConfig(*shape),
                         devices=jax.devices()[:shape[0] * shape[1]])


def _graft(dense, meshed_init):
    """JAX's dense two-tower params in its meshed model's tree: each
    tower's padded table zero past the dense rows."""
    sh = jax.tree.map(np.array, meshed_init)
    d = jax.tree.map(np.asarray, dense)
    for tower in ("query_tower", "candidate_tower"):
        dt = d["params"][tower]["embeddings"]["table"]
        padded = sh["params"][tower]["embeddings"]["table"]
        padded[:] = 0.0
        padded[:dt.shape[0]] = dt
        sh["params"][tower]["projection"] = d["params"][tower]["projection"]
    return jax.tree.map(jnp.asarray, sh)


def _two_tower_side(rng, inputs, want):
    qspecs, cspecs = (_j_specs(s) for s in w.tower_specs())
    b = w.TT_B
    qb = {"user_id": rng.integers(0, 300, b).astype(np.int32),
          "user_age": rng.integers(0, 7, b).astype(np.int32)}
    cb = {"movie_id": rng.integers(0, 400, b).astype(np.int32),
          "movie_genres": rng.integers(0, 18, (b, 4)).astype(np.int32),
          "movie_genres__wt": (rng.random((b, 4)) < 0.8).astype(np.float32)}
    probs = rng.random(b).astype(np.float32) * 0.5 + 0.1
    ids = rng.integers(0, 5, b).astype(np.int32)  # collisions certain
    kw = dict(embedding_dim=8, hidden=(16,), output_dim=8)
    dense = JTwoTower(qspecs, cspecs, **kw)
    params = dense.init(jax.random.PRNGKey(0), qb, cb)
    mesh = _jmesh((2, 2))
    meshed = JTwoTower(qspecs, cspecs, mesh=mesh, **kw)
    sh_params = _graft(params, meshed.init(jax.random.PRNGKey(0), qb, cb))
    jq, jc = j_shard_batch(qb, mesh), j_shard_batch(cb, mesh)
    jprobs, jids = j_shard_batch(probs, mesh), j_shard_batch(ids, mesh)
    for name, task, extra in (
        ("plain", JRetrieval(temperature=0.2, axis_name="data", mesh=mesh),
         {}),
        ("options", JRetrieval(temperature=0.5,
                               remove_accidental_negatives=True,
                               axis_name="data", mesh=mesh),
         dict(candidate_sampling_probability=jprobs, candidate_ids=jids)),
    ):
        def loss(p, task=task, extra=extra):
            qe, ce = meshed.apply(p, jq, jc)
            return task(qe, ce, **extra)
        value, grads = jax.jit(jax.value_and_grad(loss))(sh_params)
        want[f"tt/{name}"] = (float(value),
                              jax.tree.map(np.asarray, grads))
    _flatten(jax.tree.map(np.asarray, params), "tt/params", inputs)
    for prefix, batch in (("tt/q", qb), ("tt/c", cb)):
        for k, v in batch.items():
            inputs[f"{prefix}/{k}"] = v
    inputs["tt/ids"], inputs["tt/probs"] = ids, probs


def _topk_side(rng, inputs, want):
    corpus = rng.normal(size=(37, 8)).astype(np.float32)
    queries = rng.normal(size=(6, 8)).astype(np.float32)
    int_ids = (1000 + rng.permutation(37)).astype(np.int64)
    str_ids = np.asarray([f"item{i}" for i in rng.permutation(37)])
    # Each row excludes two of its top-5 and one id it would not see.
    top = np.argsort(-(2 * queries) @ corpus.T, axis=1)
    excl = np.stack([int_ids[top[:, 0]], int_ids[top[:, 3]],
                     int_ids[top[:, 30]]], axis=1)
    inputs.update({"topk/corpus": corpus, "topk/queries": queries,
                   "topk/int_ids": int_ids, "topk/str_ids": str_ids,
                   "topk/exclusions": excl})

    def query_model(x):
        return x * 2.0

    # JAX's results do not depend on the mesh (its ShardedBruteForce
    # equals its BruteForce bit for bit): each of JAX's calls, which
    # compiles its shard_map anew, is made on one mesh, and every mesh of
    # the port is held to it.
    for k, tag in zip(KS, ("1x2", "1x4", "2x2")):
        shape = MESHES[tag]
        padded = np.concatenate([corpus, np.zeros(
            (-len(corpus) % shape[1], 8), np.float32)])
        want[f"op/{k}"] = j_sharded_top_k(
            jnp.asarray(queries), jnp.asarray(padded), k, _jmesh(shape),
            num_valid=len(corpus))
    mesh = _jmesh((2, 2))
    index = JShardedBruteForce(mesh, query_model=query_model).index(
        corpus, int_ids)
    want["int"] = want["loaded"] = index(queries, 12)
    want["excl"] = index.query_with_exclusions(queries, excl, 5)
    want["str"] = JShardedBruteForce(mesh).index(corpus, str_ids)(queries,
                                                                  40)
    want["data_sharded"] = JShardedBruteForce(
        mesh, queries_data_sharded=True).index(corpus, int_ids)(
        j_shard_batch(queries, mesh), 12)
    metric = JFactorizedTopK(JShardedBruteForce(mesh).index(corpus),
                             ks=(1, 5, 10))
    state = metric.update(metric.init(), jnp.asarray(queries),
                          jnp.asarray(corpus[:6]))
    want["metric"] = np.asarray(list(metric.compute(state).values()))


def _mmoe_side(rng, inputs, want):
    x = rng.normal(size=(16, 12)).astype(np.float32)
    y = rng.normal(size=(16, 2)).astype(np.float32)
    kw = dict(num_tasks=2, num_experts=4, expert_hidden=(8,), expert_dim=8,
              tower_hidden=(8,))
    dense = JMMoE(**kw)
    ep = JMMoE(expert_parallel=True, **kw)
    params = dense.init(jax.random.PRNGKey(0), jnp.asarray(x))
    mesh = _jmesh((2, 2))
    batch = j_shard_batch({"x": x, "y": y}, mesh)

    def loss(p, x, y):
        o0, o1 = ep.apply(p, x)
        return (jnp.mean((o0 - y[:, :1]) ** 2)
                + jnp.mean((o1 - y[:, 1:]) ** 2))

    value, (grads, x_grad) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1)))(j_shard_expert_params(params, mesh),
                               batch["x"], batch["y"])
    want["mmoe"] = (float(value), jax.tree.map(np.asarray, grads))
    want["mmoe/x_grad"] = np.asarray(x_grad)
    _flatten(jax.tree.map(np.asarray, params), "mmoe/params", inputs)
    inputs["mmoe/x"], inputs["mmoe/y"] = x, y


def _deepfm_side(rng, inputs, tmp):
    """DeepFM's JAX weights for the checkpoint runs, a batch, a 128-row
    split, and the unmeshed artifact the workers load on the mesh."""
    specs = _j_specs(w.specs())
    feats = {
        "u": rng.integers(0, 301, w.B).astype(np.int32),
        "g": rng.integers(0, 3, w.B).astype(np.int32),
        "m": rng.integers(0, 400, w.B).astype(np.int32),
        "tags": rng.integers(0, 19, (w.B, 4)).astype(np.int32),
        "tags__wt": (rng.random((w.B, 4)) < 0.8).astype(np.float32),
    }
    params = JDeepFM(specs, embedding_dim=w.D, hidden=(16,)).init(
        jax.random.PRNGKey(0), feats)
    _flatten(jax.tree.map(np.asarray, params), "deepfm/params", inputs)
    for k, v in feats.items():
        inputs[f"deepfm/batch/{k}"] = v
    n = w.FIT_ROWS
    fit = {
        "u": rng.integers(0, 301, n).astype(np.int32),
        "g": rng.integers(0, 3, n).astype(np.int32),
        "m": rng.integers(0, 400, n).astype(np.int32),
        "tags": rng.integers(0, 19, (n, 4)).astype(np.int32),
        "tags__wt": (rng.random((n, 4)) < 0.8).astype(np.float32),
    }
    for k, v in fit.items():
        inputs[f"fit/feats/{k}"] = v
    inputs["fit/labels"] = (rng.random((n, 1)) < 0.5).astype(np.float32)
    model = TDeepFM(w.specs(), w.D, (16,))
    model.load_state_dict(convert.deepfm_from_flax(
        w.unflatten(inputs, "deepfm/params")))
    save_model(str(tmp / "artifact"), model)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's side here, then the four workers once: (inputs, JAX's
    results, each rank's results, the workers' directory)."""
    tmp = tmp_path_factory.mktemp("parallel_models")
    rng = np.random.default_rng(0)
    inputs, want = {}, {}
    _two_tower_side(rng, inputs, want)
    _topk_side(rng, inputs, want)
    _mmoe_side(rng, inputs, want)
    _deepfm_side(rng, inputs, tmp)
    np.savez(tmp / "inputs.npz", **inputs)
    ports = ",".join(str(_free_port()) for _ in range(4))
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests",
                                      "torch_parallel_worker.py"),
         "models", ports, str(rank), str(tmp), str(tmp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(4)]
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
    return inputs, want, ranks, tmp


def _joined(ranks, prefix, coords=((0, 0), (0, 1))):
    """The state under ``prefix`` of the ranks at ``coords`` (model order),
    their shards put back together."""
    states = [{k[len(prefix):]: torch.from_numpy(v)
               for k, v in ranks[d * 2 + m].items() if k.startswith(prefix)}
              for d, m in coords]
    return {k: v.numpy() for k, v in convert.join_shards(states).items()}


def _assert_state_close(got, want, rtol, atol, what):
    assert sorted(got) == sorted(want), what
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {k}")


# -- the two-tower ------------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "options"])
def test_meshed_two_tower_matches_jax_meshed(run, case):
    _, want, ranks, _ = run
    loss, grads = want[f"tt/{case}"]
    for r in ranks:
        np.testing.assert_allclose(float(r[f"tt/{case}/loss"]), loss,
                                   rtol=1e-5)
    want_grads = {k: v.numpy() for k, v in
                  convert.two_tower_from_flax(grads).items()}
    for d in (0, 1):
        got = _joined(ranks, f"tt/{case}/grad/", ((d, 0), (d, 1)))
        assert got["query_tower.embeddings.table"].shape == (308, 8)
        _assert_state_close(got, want_grads, 1e-4, 1e-6, case)


def test_meshed_two_tower_exchanges(run):
    """A step's all-reduces: the candidates gathered over "data" (forward
    and backward), each tower's lookup over "model", the pod loss's sum,
    the trainer's one over "data"; the options add the ids and the
    sampling probabilities."""
    _, _, ranks, _ = run
    for r in ranks:
        assert int(r["tt/plain/all_reduces"]) == 6
        assert int(r["tt/options/all_reduces"]) == 8


def test_meshed_two_tower_adagrad_step_matches_unmeshed(run):
    inputs, _, ranks, _ = run
    model = TTwoTower(*w.tower_specs(), embedding_dim=8, hidden=(16,),
                      output_dim=8)
    model.load_state_dict(convert.two_tower_from_flax(
        w.unflatten(inputs, "tt/params")))
    trainer = Trainer(model, Adagrad(model.parameters(), 0.1),
                      loss_fn=retrieval_loss(model,
                                             TRetrieval(temperature=0.2)),
                      device="cpu")
    batches = [{k: torch.from_numpy(v) for k, v in
                w.prefixed(inputs, p).items()} for p in ("tt/q", "tt/c")]
    loss = trainer.train_step(tuple(batches), None)
    np.testing.assert_allclose(float(ranks[0]["tt/adagrad/loss"]),
                               float(loss), rtol=1e-5)
    want = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    for d in (0, 1):
        got = _joined(ranks, "tt/adagrad/param/", ((d, 0), (d, 1)))
        for k in list(got):
            got[k] = got[k][:want[k].shape[0]]
        _assert_state_close(got, want, 1e-5, 1e-7, "adagrad")


# -- sharded top-k ------------------------------------------------------------

def _ranks_of(ranks, tag):
    return [r for r in ranks if f"topk/{tag}/int/ids" in r]


def _close_scores(got, want):
    """rtol 1e-6, and 1e-6 of the row's largest score: a score near zero
    carries the rounding of its larger products."""
    want = np.asarray(want)
    finite = ~np.isinf(want)
    np.testing.assert_array_equal(np.isinf(got), ~finite)
    scale = np.abs(np.where(finite, want, 0)).max(1, keepdims=True)
    np.testing.assert_allclose(np.where(finite, got, 0),
                               np.where(finite, want, 0),
                               rtol=1e-6, atol=1e-6 * scale.max())


def _same_top(got_s, got_i, want_s, want_i):
    _close_scores(got_s, want_s)
    np.testing.assert_array_equal(got_i, np.asarray(want_i))


@pytest.mark.parametrize("tag", sorted(MESHES))
@pytest.mark.parametrize("k", KS)
def test_sharded_top_k_matches_jax(run, tag, k):
    """k = 5 within a shard, 12 past a (1, 4) shard of 10 rows, 40 past
    the corpus of 37 (sentinel id -1, score -inf)."""
    _, want, ranks, _ = run
    got_ranks = _ranks_of(ranks, tag)
    assert len(got_ranks) == int(np.prod(MESHES[tag]))
    for r in got_ranks:
        for form in ("op", "rows"):
            s, i = (r[f"topk/{tag}/{form}/{k}/{x}"] for x in ("scores",
                                                             "ids"))
            _same_top(s, i, *want[f"op/{k}"])
        if k == 40:
            assert (r[f"topk/{tag}/rows/{k}/ids"][:, 37:] == -1).all()
            assert np.isneginf(r[f"topk/{tag}/rows/{k}/scores"][:, 37:]).all()


@pytest.mark.parametrize("tag", sorted(MESHES))
@pytest.mark.parametrize("form", ["int", "excl", "str", "loaded"])
def test_sharded_brute_force_matches_jax(run, tag, form):
    """Integer identifiers with a query model, exclusions, string
    identifiers past the corpus (the sentinel wraps to the last, as
    JAX's), and the index saved and loaded on the mesh."""
    _, want, ranks, _ = run
    for r in _ranks_of(ranks, tag):
        s, i = want[form]
        got_s, got_i = r[f"topk/{tag}/{form}/scores"], \
            r[f"topk/{tag}/{form}/ids"]
        _close_scores(got_s, s)
        np.testing.assert_array_equal(got_i, np.asarray(i).astype(
            got_i.dtype))


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_sharded_brute_force_data_sharded_and_metric(run, tag):
    """Data-sharded queries: each data group gets its rows of JAX's global
    result; FactorizedTopK over the index equals JAX's."""
    _, want, ranks, _ = run
    n_data = MESHES[tag][0]
    s, i = (np.asarray(x) for x in want["data_sharded"])
    rows = s.shape[0] // n_data
    for r in _ranks_of(ranks, tag):
        d = int(r[f"topk/{tag}/data"])
        part = slice(d * rows, (d + 1) * rows)
        _same_top(r[f"topk/{tag}/data_sharded/scores"],
                  r[f"topk/{tag}/data_sharded/ids"], s[part], i[part])
        np.testing.assert_allclose(r[f"topk/{tag}/metric"], want["metric"],
                                   rtol=1e-6)


# -- expert-parallel MMoE -----------------------------------------------------

def test_expert_parallel_mmoe_matches_jax(run):
    """The loss and every parameter's gradient; and an input's gradient,
    whose expert part each process completes over "model": a process's
    loss is the mean over its data shard's rows, so its input gradient is
    the data size (2) times that rows' share of JAX's global mean."""
    _, want, ranks, _ = run
    x_grad = want["mmoe/x_grad"]
    for r in ranks:
        d = int(r["topk/2x2/data"])
        np.testing.assert_allclose(r["mmoe/x_grad"],
                                   2 * x_grad[d * 8:(d + 1) * 8],
                                   rtol=1e-4, atol=1e-6)
    loss, grads = want["mmoe"]
    want_grads = {k: v.numpy() for k, v in
                  convert.mmoe_from_flax(grads).items()}
    for r in ranks:
        np.testing.assert_allclose(float(r["mmoe/loss"]), loss, rtol=1e-5)
        assert int(r["mmoe/expert_rows"]) == 2  # 4 experts over 2
        assert "divide" in str(r["mmoe/refused"])
    for d in (0, 1):
        got = _joined(ranks, "mmoe/grad/", ((d, 0), (d, 1)))
        _assert_state_close(got, want_grads, 1e-4, 1e-6, "mmoe")


# -- sharded checkpoints ------------------------------------------------------

def test_sharded_checkpoint_resumes_bit_for_bit(run):
    _, _, ranks, _ = run
    for r in ranks[:2]:
        steps = w.FIT_ROWS // w.FIT_BATCH
        assert len(r["ckpt/uninterrupted"]) == 2 * steps
        assert r["ckpt/resumed_epochs"].tolist() == [1]
        np.testing.assert_array_equal(
            np.concatenate([r["ckpt/first"], r["ckpt/resumed"]]),
            r["ckpt/uninterrupted"])


def _joined_checkpoint(path):
    """The (1, 2) checkpoint's two files joined by hand: the fused table
    and its Adam moments concatenated and cut to the 723 unpadded rows."""
    parts = [torch.load(os.path.join(path, f"model_{m}.pt"),
                        weights_only=True) for m in (0, 1)]
    model = dict(parts[0]["model"])
    model["embeddings.table"] = torch.cat(
        [p["model"]["embeddings.table"] for p in parts])[:723]
    opt = parts[0]["optimizer"]
    names = list(model)  # Adam was built on model.parameters()
    state = {}
    for i, entry in opt["state"].items():
        state[i] = dict(entry)
        if names[i] == "embeddings.table":
            for k in ("exp_avg", "exp_avg_sq"):
                state[i][k] = torch.cat(
                    [p["optimizer"]["state"][i][k] for p in parts])[:723]
    return model, state


def test_sharded_checkpoint_restores_joined(run):
    """At (2, 1) (both ranks) and unmeshed: the joined state, Adam's
    moments and steps included, bit for bit."""
    _, _, ranks, tmp = run
    path = os.path.join(tmp, "ckpt12", "step_0")
    assert sorted(os.listdir(path)) == ["model_0.pt", "model_1.pt",
                                        "sharding.json"]
    model_state, opt_state = _joined_checkpoint(path)
    assert model_state["embeddings.table"].shape == (723, w.D)
    model = TDeepFM(w.specs(), w.D, (16,))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    restore_train_state(path, model, opt, None)
    got = [({k: v.numpy() for k, v in model.state_dict().items()},
            {i: {k: v.numpy() for k, v in e.items()}
             for i, e in opt.state_dict()["state"].items()})]
    for r in ranks[:2]:
        got.append((
            {k[len("restored/model/"):]: v for k, v in r.items()
             if k.startswith("restored/model/")},
            {i: {k: r[f"restored/opt/{i}/{k}"] for k in opt_state[i]}
             for i in opt_state}))
    for model_got, opt_got in got:
        assert sorted(model_got) == sorted(model_state)
        for k, v in model_state.items():
            np.testing.assert_array_equal(model_got[k], v.numpy(),
                                          err_msg=k)
        for i, entry in opt_state.items():
            for k, v in entry.items():
                np.testing.assert_array_equal(opt_got[i][k], v.numpy(),
                                              err_msg=f"{i}/{k}")


# -- load_model(mesh=) --------------------------------------------------------

def test_load_model_on_a_mesh_matches_unmeshed(run):
    """Each rank of (1, 2) holds half of the padded table (362 of 724
    rows) and gives the unmeshed logits; the artifact the meshed model
    saved (its shards joined, padding dropped) loads unmeshed to the same
    logits."""
    inputs, _, ranks, tmp = run
    feats = {k: torch.from_numpy(v)
             for k, v in w.prefixed(inputs, "deepfm/batch").items()}
    want = load_model(str(tmp / "artifact"), device="cpu")(feats)
    for r in ranks[:2]:
        assert int(r["serve/table_rows"]) == 362
        np.testing.assert_allclose(r["serve/meshed_logits"],
                                   want.detach().numpy(), rtol=1e-6)
    again = load_model(str(tmp / "meshed_artifact"), device="cpu")
    assert again.embeddings.table.shape == (723, w.D)
    np.testing.assert_allclose(again(feats).detach().numpy(),
                               want.detach().numpy(), rtol=1e-6)


# -- the cuts of convert.py, in this process ----------------------------------

def test_shard_state_cuts_both_towers_and_the_experts():
    """``shard_state``/``join_shards`` cut each tower's table (the
    ``.embeddings.table`` suffix), padded, and MMoE's stacked experts
    along their leading axis with no padding (ValueError unless they
    divide); projections, gates and towers stay whole."""
    from deep_recommenders_torch.models.multitask import MMoE

    tower = TTwoTower(*w.tower_specs(), embedding_dim=8, hidden=(16,),
                      output_dim=8).state_dict()
    cut = [convert.shard_state(tower, 2, m) for m in (0, 1)]
    for name in ("query_tower", "candidate_tower"):
        key = f"{name}.embeddings.table"
        rows = tower[key].shape[0]
        assert [c[key].shape[0] for c in cut] == [-(-rows // 2)] * 2
        joined = convert.join_shards(cut)[key]
        np.testing.assert_array_equal(joined[:rows].numpy(),
                                      tower[key].numpy())
        assert not joined[rows:].any()
        proj = f"{name}.projection.dense.0.weight"
        assert torch.equal(cut[1][proj], tower[proj])
    mmoe = MMoE(12, num_experts=4, expert_hidden=(8,),
                expert_dim=8).state_dict()
    cut = [convert.shard_state(mmoe, 2, m) for m in (0, 1)]
    assert cut[1]["experts.kernels.0"].shape == (2, 12, 8)
    assert cut[1]["experts.biases.1"].shape == (2, 8)
    assert torch.equal(cut[1]["gate_0.weight"], mmoe["gate_0.weight"])
    joined = convert.join_shards(cut)
    for k, v in mmoe.items():
        assert torch.equal(joined[k], v), k
    with pytest.raises(ValueError, match="divide"):
        convert.shard_state(mmoe, 3, 0)


def test_optimizer_state_cuts_and_joins():
    """Adam's moments of a sharded table are cut as the table is (step
    replicated) and joined back bit for bit; the replicated parameters'
    state stays whole."""
    model = TDeepFM(w.specs(), w.D, (16,))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    model(w.shard_batch({k: v[:4] for k, v in {
        "u": np.arange(4, dtype=np.int32), "g": np.zeros(4, np.int32),
        "m": np.arange(4, dtype=np.int32),
        "tags": np.zeros((4, 4), np.int32),
        "tags__wt": np.ones((4, 4), np.float32)}.items()}, None)).sum(
    ).backward()
    opt.step()
    names = [n for n, _ in model.named_parameters()]
    state = opt.state_dict()
    cut = [convert.shard_optimizer_state(state, names, 2, m)
           for m in (0, 1)]
    table = names.index("embeddings.table")
    assert cut[0]["state"][table]["exp_avg"].shape == (362, w.D)
    assert torch.equal(cut[1]["state"][table]["step"],
                       state["state"][table]["step"])
    joined = convert.join_optimizer_shards(cut, names)
    for i, entry in state["state"].items():
        for k, v in entry.items():
            got = joined["state"][i][k]
            assert torch.equal(got[:v.shape[0]] if v.dim() else got, v)
