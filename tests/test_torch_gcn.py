"""GCN on Cora in the PyTorch port against the JAX package: ``ops/sparse.py``
(``SparseAdjacency``), ``datasets/cora.py``, ``models/retrieval/gcn.py``
through ``convert.gcn_from_flax``, and the ported example.

The same numpy inputs go to both sides. Tolerances: the logits and
gradients are fp32 products of the same operands summed in another order
(XLA's and torch's dot kernels; the sparse product's row sums): rtol 1e-5,
atol 1e-6 (1e-5 for gradients, which sum over every node). The dataset's
arrays are numpy on both sides, from the same draws: equal bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse
import torch

from deep_recommenders_torch.convert import gcn_from_flax
from deep_recommenders_torch.datasets import Cora, cora as tcora
from deep_recommenders_torch.examples import train_gcn_on_cora
from deep_recommenders_torch.models.retrieval import GCN, GCNLayer
from deep_recommenders_torch.ops.sparse import SparseAdjacency
from deep_recommenders_torch.training.losses import softmax_cross_entropy
from deep_recommenders_tpu.datasets import Cora as JCora
from deep_recommenders_tpu.datasets import cora as jcora
from deep_recommenders_tpu.models.retrieval import GCN as JGCN
from deep_recommenders_tpu.models.retrieval import GCNLayer as JGCNLayer
from deep_recommenders_tpu.ops.sparse import SparseAdjacency as JSparse
from deep_recommenders_tpu.training.losses import (
    softmax_cross_entropy as jsoftmax_cross_entropy,
)

torch.set_num_threads(1)


def close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def graph(rng, n=24, f=10, density=0.2):
    x = rng.normal(size=(n, f)).astype(np.float32)
    adj = (rng.random((n, n)) < density).astype(np.float32)
    adj = jcora.normalize_adjacency(np.maximum(adj, adj.T))
    return x, adj.astype(np.float32)


# -- SparseAdjacency -------------------------------------------------------------

def test_sparse_adjacency_matches_jax(rng):
    _, adj = graph(rng)
    x = rng.normal(size=(24, 5)).astype(np.float32)
    sp, jsp = SparseAdjacency.from_dense(adj), JSparse.from_dense(adj)
    for mine, theirs in ((sp.rows, jsp.rows), (sp.cols, jsp.cols),
                         (sp.vals, jsp.vals)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    assert sp.nnz == jsp.nnz and sp.num_nodes == jsp.num_nodes == 24
    close((sp @ torch.from_numpy(x)).numpy(), np.asarray(jsp @ jnp.asarray(x)))
    close((sp @ torch.from_numpy(x)).numpy(), adj @ x)
    np.testing.assert_array_equal(sp.todense().numpy(),
                                  np.asarray(jsp.todense()))
    np.testing.assert_array_equal(sp.todense().numpy(), adj)


def test_sparse_adjacency_from_scipy_matches_jax(rng):
    dense = (rng.random((30, 30)) < 0.1).astype(np.float32)
    dense[3, 5] = 0.0
    coo = scipy.sparse.coo_matrix(dense)
    # a duplicate entry: the CSR round trip sums it
    coo = scipy.sparse.coo_matrix(
        (np.append(coo.data, 2.0), (np.append(coo.row, 3),
                                    np.append(coo.col, 5))), shape=(30, 30))
    sp, jsp = SparseAdjacency.from_scipy(coo), JSparse.from_scipy(coo)
    np.testing.assert_array_equal(sp.rows.numpy(), np.asarray(jsp.rows))
    np.testing.assert_array_equal(sp.cols.numpy(), np.asarray(jsp.cols))
    np.testing.assert_array_equal(sp.vals.numpy(), np.asarray(jsp.vals))
    assert (np.diff(sp.rows.numpy()) >= 0).all()
    np.testing.assert_array_equal(sp.todense().numpy(), coo.toarray())
    x = rng.normal(size=(30, 3)).astype(np.float32)
    close((sp @ torch.from_numpy(x)).numpy(),
          np.asarray(jsp @ jnp.asarray(x)))


# -- Cora ------------------------------------------------------------------------

def test_synthetic_cora_is_bit_identical_to_jax():
    mine = tcora._synthesize_cora(300, 84, 7)
    theirs = jcora._synthesize_cora(300, 84, 7)
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    _, _, adj = mine
    np.testing.assert_array_equal(tcora.normalize_adjacency(adj),
                                  jcora.normalize_adjacency(adj))


@pytest.mark.parametrize("kwargs", [
    dict(), dict(num_per_class=10, num_valid=50)])
def test_cora_and_splits_are_bit_identical_to_jax(kwargs):
    mine = Cora(seed=3, synthetic_nodes=300, synthetic_features=84)
    theirs = JCora(seed=3, synthetic_nodes=300, synthetic_features=84)
    for name in ("features", "labels", "adjacency", "spectral_adjacency"):
        np.testing.assert_array_equal(getattr(mine, name),
                                      getattr(theirs, name))
    a, b = mine.splits(**kwargs), theirs.splits(**kwargs)
    assert set(a) == set(b) == {"train", "valid", "test"}
    for split in a:
        for x, y in zip(a[split], b[split]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_the_parser_reads_written_cora_files(tmp_path):
    feats, labels, adj = tcora._synthesize_cora(60, 20, 11)
    root = tmp_path / "cora"
    root.mkdir()
    ids = 1000 + 7 * np.arange(60)  # paper ids are not row numbers
    with open(root / "cora.content", "w") as f:
        for i in range(60):
            words = " ".join(str(int(v)) for v in feats[i])
            f.write(f"{ids[i]} {words} {tcora.CORA_CLASSES[labels[i]]}\n")
    rows, cols = np.nonzero(np.triu(adj))
    with open(root / "cora.cites", "w") as f:
        for a, b in zip(rows, cols):
            f.write(f"{ids[b]} {ids[a]}\n")  # cited, citing
    mine, theirs = Cora(path=str(tmp_path)), JCora(path=str(tmp_path))
    np.testing.assert_array_equal(mine.adjacency, adj)
    np.testing.assert_array_equal(mine.labels, labels)
    np.testing.assert_array_equal(
        mine.features, feats / np.maximum(feats.sum(1, keepdims=True), 1e-12))
    for name in ("features", "labels", "adjacency", "spectral_adjacency"):
        np.testing.assert_array_equal(getattr(mine, name),
                                      getattr(theirs, name))
    assert not os.path.exists(tmp_path / "cora.tgz")  # nothing fetched


# -- GCNLayer and GCN against flax --------------------------------------------------

@pytest.mark.parametrize("units,activation", [(4, None), (16, "relu")])
@pytest.mark.parametrize("sparse", [False, True])
def test_gcn_layer_matches_flax(rng, units, activation, sparse):
    """units 4 <= F: A @ (X @ W); units 16 > F: (A @ X) @ W."""
    x, adj = graph(rng)
    layer = JGCNLayer(units, activation=activation)
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        jnp.asarray(adj))
    want = layer.apply(params, jnp.asarray(x), jnp.asarray(adj))
    mine = GCNLayer(10, units, activation)
    mine.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                          params["params"].items()})
    a = SparseAdjacency.from_dense(adj) if sparse else torch.from_numpy(adj)
    with torch.no_grad():
        got = mine(torch.from_numpy(x), a)
    close(got.numpy(), np.asarray(want))


def test_gcn_layer_residual_contract():
    x, adj = torch.ones(5, 4), torch.eye(5)
    with pytest.raises(ValueError, match="residual"):
        GCNLayer(4, 3, use_residual=True)(x, adj)
    layer = GCNLayer(4, 4, use_residual=True)
    with torch.no_grad():
        out = layer(x, adj)
        want = torch.relu(x @ layer.kernel + layer.bias) + x
    assert out.shape == (5, 4)
    close(out.numpy(), want.numpy())


def test_gcn_init_is_glorot_uniform():
    model = GCN(200, hidden=(100,), num_classes=7,
                generator=torch.Generator().manual_seed(0))
    w = model.layers[0].kernel.detach().numpy()
    limit = np.sqrt(6.0 / 300)
    assert np.abs(w).max() <= limit and np.abs(w).max() > 0.95 * limit
    assert abs(w.std() - limit / np.sqrt(3)) < 0.02 * limit
    assert (model.layers[0].bias.detach().numpy() == 0).all()


def _flax_gcn(rng, sparse):
    x, adj = graph(rng, n=30, f=12)
    jmodel = JGCN(hidden=(8, 6), num_classes=3, dropout=0.5)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x),
                         jnp.asarray(adj))
    model = GCN(12, hidden=(8, 6), num_classes=3, dropout=0.5)
    model.load_state_dict(gcn_from_flax(
        jax.tree.map(np.asarray, params)))
    a = SparseAdjacency.from_dense(adj) if sparse else torch.from_numpy(adj)
    ja = JSparse.from_dense(adj) if sparse else jnp.asarray(adj)
    return x, a, ja, jmodel, params, model


@pytest.mark.parametrize("sparse", [False, True])
def test_gcn_logits_match_flax(rng, sparse):
    x, a, ja, jmodel, params, model = _flax_gcn(rng, sparse)
    want = jmodel.apply(params, jnp.asarray(x), ja)
    with torch.no_grad():
        got = model(torch.from_numpy(x), a)
    close(got.numpy(), np.asarray(want))


def test_dense_and_sparse_logits_agree(rng):
    x, a, _, _, _, model = _flax_gcn(rng, sparse=True)
    with torch.no_grad():
        sparse = model(torch.from_numpy(x), a)
        dense = model(torch.from_numpy(x), a.todense())
    close(sparse.numpy(), dense.numpy())


@pytest.mark.parametrize("sparse", [False, True])
def test_one_adam_step_matches_optax(rng, sparse):
    x, a, ja, jmodel, params, model = _flax_gcn(rng, sparse)
    labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 30)]
    mask = (rng.random(30) < 0.4).astype(np.float32)

    def loss_fn(p):
        return jsoftmax_cross_entropy(jmodel.apply(p, jnp.asarray(x), ja),
                                      jnp.asarray(labels),
                                      mask=jnp.asarray(mask))

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    opt = optax.adam(0.01)
    updates, _ = opt.update(jgrads, opt.init(params), params)
    jnew = gcn_from_flax(jax.tree.map(np.asarray,
                                      optax.apply_updates(params, updates)))
    jgrads = gcn_from_flax(jax.tree.map(np.asarray, jgrads))

    adam = torch.optim.Adam(model.parameters(), lr=0.01)
    loss = softmax_cross_entropy(model(torch.from_numpy(x), a),
                                 torch.from_numpy(labels),
                                 mask=torch.from_numpy(mask))
    loss.backward()
    close(loss.item(), float(jloss))
    for name, p in model.named_parameters():
        close(p.grad.numpy(), jgrads[name].numpy(), atol=1e-5)
    adam.step()
    for name, p in model.named_parameters():
        close(p.detach().numpy(), jnew[name].numpy(), atol=1e-5)


def test_dropout_draws_from_the_generator(rng):
    x, adj = graph(rng, n=30, f=12)
    model = GCN(12, hidden=(8,), num_classes=3, dropout=0.5,
                generator=torch.Generator().manual_seed(0))
    xt, at = torch.from_numpy(x), torch.from_numpy(adj)
    with pytest.raises(ValueError, match="generator"):
        model(xt, at, training=True)
    outs = [model(xt, at, training=True,
                  generator=torch.Generator().manual_seed(s))
            for s in (5, 5, 6)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    # the hidden layer's inverted dropout, redrawn from the same seed
    with torch.no_grad():
        h = model.layers[0](xt, at)
        keep = torch.rand(h.shape, generator=torch.Generator().manual_seed(5)
                          ) < 0.5
        want = model.layers[1](torch.where(keep, h / 0.5, 0.0), at)
    close(outs[0].detach().numpy(), want.numpy())
    # no dropout without training, or with dropout 0
    close(model(xt, at).detach().numpy(),
          model.layers[1](model.layers[0](xt, at), at).detach().numpy())


# -- the example -------------------------------------------------------------------

@pytest.mark.parametrize("sparse", [False, True])
def test_example_runs_on_the_cpu(capsys, sparse):
    argv = ["--epochs", "50", "--device", "cpu"]
    result = train_gcn_on_cora.main(argv + (["--sparse-adjacency"]
                                            if sparse else []))
    assert len(result["losses"]) == 50
    assert np.isfinite(result["losses"]).all()
    assert result["losses"][-1] < result["losses"][0]
    assert isinstance(result["adjacency"], SparseAdjacency) == sparse
    assert result["test_accuracy"] > 0.9
    out = capsys.readouterr().out
    assert "epoch 50: loss" in out and "test accuracy:" in out
