"""The approximate indexes of the PyTorch port against the JAX package:
``kmeans``, ``IVF`` and ``ApproxTopK`` of
``deep_recommenders_torch/models/retrieval/ann.py``, built on each side
from the same numpy inputs, each side's index files read by the other, and
the single-device cases of ``tests/test_ann.py``.

Ties and near ties: every test that compares ids or assignments uses
well-separated data and checks it first (in fp64). k-means runs on
clustered corpora (16 or 8 centres drawn N(0, 5^2), points N(0, 0.3^2)
or N(0, 1) around them), from one point of each cluster or, for IVF's seeded draw,
with fewer centroids than clusters (so that no cluster is split between
two centroids); each point's nearest and second-nearest centroid are
checked to differ by 1e-4 (|v|^2 + max |c|^2), 25 times the fp32 error of
a squared distance of D = 32 terms, so both sides assign alike; then the
centroids agree within 1e-5. Scores
of the indexes are fp32 sums of D products on both sides: within rtol
1e-5; ids compared only in the rows where no two of the top k + 1 exact
scores lie within 4 D u max sum|q c| (u = 2^-24), the bound under which
two fp32 sums of the same D products cannot swap places: every row of the
data the ApproxTopK tests draw, at least half the rows (asserted) of the
clustered corpora, whose points crowd a cluster's scores.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_recommenders_torch.models.retrieval import (
    IVF,
    ApproxTopK,
    BruteForce,
    FactorizedTopK,
    kmeans,
    load_index,
    save_index,
)
from deep_recommenders_torch.models.retrieval.ann import NEG_INF
from deep_recommenders_tpu.models import retrieval as jret

torch.set_num_threads(1)

CPU = "cpu"
U = 2.0**-24


def clustered_corpus(rng, n_clusters=16, per=64, dim=32, spread=0.3):
    centers = rng.normal(0, 5.0, (n_clusters, dim))
    return np.concatenate(
        [c + rng.normal(0, spread, (per, dim)) for c in centers]
    ).astype(np.float32)


def tie_free_rows(queries, cands, k):
    """The rows in which no two of the top k + 1 exact scores lie within
    4 D u max sum|q c| (fp64): two fp32 sums of the D products keep their
    order there."""
    q, c = queries.astype(np.float64), cands.astype(np.float64)
    gap = 4 * q.shape[1] * U * (np.abs(q) @ np.abs(c).T).max()
    top = -np.sort(-(q @ c.T), axis=-1)[..., :k + 1]
    return (np.diff(-top, axis=-1) > gap).all(axis=-1)


def assert_tie_free(queries, cands, k):
    assert tie_free_rows(queries, cands, k).all(), "the test data has a tie"


def equal_ids_where_tie_free(got, want, queries, cands, k):
    rows = tie_free_rows(queries, cands, k)
    assert rows.mean() >= 0.5, "the test data has ties in most rows"
    np.testing.assert_array_equal(np.asarray(got)[rows],
                                  np.asarray(want)[rows])


def assert_separated(points, centroids):
    """Each point's nearest centroid beats the second by far more than the
    fp32 error of a squared distance (both sides assign alike)."""
    p, c = points.astype(np.float64), centroids.astype(np.float64)
    d = ((p[:, None, :] - c[None]) ** 2).sum(-1)
    two = np.sort(d, axis=1)[:, :2]
    scale = (p * p).sum(1) + (c * c).sum(1).max()
    assert (two[:, 1] - two[:, 0] > 1e-4 * scale).all(), "near tie"


def close(got, want, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=1e-5)


# -- kmeans --------------------------------------------------------------------

@pytest.mark.parametrize("iters", [1, 10])
def test_kmeans_matches_jax(rng, iters):
    pts = clustered_corpus(rng)
    init = pts[::64] + rng.normal(0, 1.0, (16, 32)).astype(np.float32)
    c, a = kmeans(torch.from_numpy(pts), torch.from_numpy(init), 16, iters)
    jc, ja = jret.kmeans(jnp.asarray(pts), jnp.asarray(init), 16, iters)
    assert_separated(pts, np.asarray(jc))
    close(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    # the assignment is the nearest centroid
    d = ((pts[:, None, :] - c.numpy()[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(a.numpy(), d.argmin(1))


def test_kmeans_keeps_an_empty_cluster(rng):
    pts = clustered_corpus(rng, n_clusters=2, per=8, dim=4)
    far = np.full((1, 4), 1e3, np.float32)  # a centroid no point is near
    init = np.concatenate([pts[:1], pts[-1:], far])
    c, a = kmeans(torch.from_numpy(pts), torch.from_numpy(init), 3, 5)
    np.testing.assert_array_equal(c[2].numpy(), far[0])
    assert not (a == 2).any()


# -- IVF and ApproxTopK against JAX ---------------------------------------------

def _queries(rng, pts, n=24):
    return pts[rng.choice(len(pts), n)] + rng.normal(
        0, 0.05, (n, pts.shape[1])).astype(np.float32)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("nprobe", [1, 4])
def test_ivf_matches_jax(rng, normalize, nprobe):
    pts = clustered_corpus(rng, spread=1.0)
    q = rng.normal(0, 5.0, (24, 32)).astype(np.float32)
    kw = dict(nlist=4, nprobe=nprobe, normalize=normalize, seed=3)
    ivf = IVF(device=CPU, **kw).index(pts)
    jivf = jret.IVF(**kw).index(pts)
    assert_separated(ivf._candidates.numpy(), np.asarray(jivf._centroids))
    close(ivf._centroids.numpy(), np.asarray(jivf._centroids))
    np.testing.assert_array_equal(ivf._buckets.numpy(),
                                  np.asarray(jivf._buckets))
    s, i = ivf(q, k=10)
    js, ji = jivf(q, k=10)
    close(s.numpy(), np.asarray(js))
    qq = q / np.linalg.norm(q, axis=1, keepdims=True) if normalize else q
    # Equal ids among the probed candidates follow from equal probes and
    # tie-free scores over the whole corpus.
    equal_ids_where_tie_free(i.numpy(), ji, qq, ivf._candidates.numpy(), 10)


@pytest.mark.parametrize("normalize", [False, True])
def test_approx_top_k_matches_jax_and_brute_force(rng, normalize):
    pts = rng.normal(0, 1, (256, 16)).astype(np.float32)
    q = rng.normal(0, 1, (8, 16)).astype(np.float32)
    s, i = ApproxTopK(recall_target=0.99, normalize=normalize,
                      device=CPU).index(pts)(q, k=10)
    js, ji = jret.ApproxTopK(recall_target=0.99,
                             normalize=normalize).index(pts)(q, k=10)
    c = pts / np.linalg.norm(pts, axis=1, keepdims=True) if normalize \
        else pts
    qq = q / np.linalg.norm(q, axis=1, keepdims=True) if normalize else q
    assert_tie_free(qq, c, 10)
    close(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    es, ei = BruteForce(device=CPU).index(c)(qq, k=10)
    close(s.numpy(), es.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(i.numpy(), ei.numpy())
    if normalize:  # cosine scores
        assert (s.numpy() <= 1.0 + 1e-5).all()


INDEXES = [
    ("IVF", dict(nlist=8, nprobe=8, seed=1), None),
    ("IVF", dict(nlist=8, nprobe=3, normalize=True), "ints"),
    ("IVF", dict(nlist=8, nprobe=8), "strings"),
    ("ApproxTopK", dict(recall_target=0.9), None),
    ("ApproxTopK", dict(normalize=True), "ints"),
    ("ApproxTopK", dict(), "strings"),
]


def _ids(kind, n):
    if kind == "ints":
        return np.arange(5000, 5000 + n, dtype=np.int64)
    if kind == "strings":
        return np.array([f"item_{j}" for j in range(n)])
    return None


@pytest.mark.parametrize("name,kw,ids", INDEXES)
def test_index_files_read_both_ways(tmp_path, rng, name, kw, ids):
    pts = clustered_corpus(rng, n_clusters=8, per=32)
    q = _queries(rng, pts, 10)
    ident = _ids(ids, len(pts))
    port = {"IVF": IVF, "ApproxTopK": ApproxTopK}[name]
    mine = port(device=CPU, **kw).index(pts, ident)
    theirs = getattr(jret, name)(**kw).index(pts, ident)
    save_index(str(tmp_path / "port"), mine)
    jret.save_index(str(tmp_path / "jax"), theirs)
    from_jax = load_index(str(tmp_path / "jax"), device=CPU)
    from_port = jret.load_index(str(tmp_path / "port"))
    assert type(from_jax) is port and from_jax.config() == theirs.config()
    assert from_port.config() == mine.config()
    want_s, want_i = theirs(q, k=7)
    for got_s, got_i in (mine(q, k=7), from_jax(q, k=7),
                         from_port(q, k=7)):
        close(np.asarray(got_s), np.asarray(want_s))
        got_i = got_i.numpy() if isinstance(got_i, torch.Tensor) \
            else np.asarray(got_i)
        np.testing.assert_array_equal(got_i, np.asarray(want_i))


# -- the single-device cases of tests/test_ann.py ------------------------------

def test_ivf_full_probe_matches_brute_force(rng):
    pts = clustered_corpus(rng, n_clusters=8, per=32)
    q = _queries(rng, pts, 10)
    es, ei = BruteForce(device=CPU).index(pts)(q, k=5)
    s, i = IVF(nlist=8, nprobe=8, device=CPU).index(pts)(q, k=5)
    close(s.numpy(), es.numpy())
    equal_ids_where_tie_free(i.numpy(), ei.numpy(), q, pts, 5)


def test_ivf_partial_probe_recall(rng):
    pts = clustered_corpus(rng, n_clusters=16, per=64)
    q = _queries(rng, pts, 32)
    _, ei = BruteForce(device=CPU).index(pts)(q, k=10)
    _, i = IVF(nlist=16, nprobe=4, device=CPU).index(pts)(q, k=10)
    recall = np.mean([len(set(i[r].tolist()) & set(ei[r].tolist())) / 10
                      for r in range(32)])
    assert recall > 0.8, recall


def test_ivf_identifier_remapping(rng):
    pts = rng.normal(0, 1, (64, 8)).astype(np.float32)
    q = rng.normal(0, 1, (4, 8)).astype(np.float32)
    _, i = IVF(nlist=4, nprobe=4, device=CPU).index(
        pts, np.arange(1000, 1064))(q, k=3)
    assert (i >= 1000).all()
    sids = np.array([f"movie_{j}" for j in range(64)])
    _, si = IVF(nlist=4, nprobe=4, device=CPU).index(pts, sids)(q, k=3)
    assert si.dtype.kind == "U" and si.shape == (4, 3)


def test_ivf_error_contracts():
    with pytest.raises(ValueError):
        IVF(nlist=4, nprobe=8, device=CPU)
    with pytest.raises(ValueError):
        IVF(nlist=64, nprobe=4, device=CPU).index(np.zeros((8, 4), np.float32))
    with pytest.raises(ValueError):
        IVF(nlist=4, nprobe=2, device=CPU).index(
            np.zeros((8, 4), np.float32), identifiers=np.arange(7))
    for index in (IVF(nlist=4, nprobe=2, device=CPU),
                  ApproxTopK(device=CPU)):
        with pytest.raises(ValueError, match="index"):
            index(np.zeros((2, 4), np.float32))
        with pytest.raises(ValueError, match="index"):
            index.state_dict()


@pytest.mark.parametrize("ids", [None, "ints"])
def test_ivf_k_larger_than_probed_pads(rng, ids):
    pts = rng.normal(0, 1, (16, 4)).astype(np.float32)
    q = rng.normal(0, 1, (2, 4)).astype(np.float32)
    ident = _ids(ids, 16)
    s, i = IVF(nlist=8, nprobe=1, device=CPU).index(pts, ident)(q, k=12)
    js, ji = jret.IVF(nlist=8, nprobe=1).index(pts, ident)(q, k=12)
    assert s.shape == (2, 12) and i.shape == (2, 12)
    pad = s.numpy() <= NEG_INF / 2
    assert pad.any() and (i.numpy()[pad] == -1).all()
    np.testing.assert_array_equal(pad, np.asarray(js) <= -1e29)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    close(s.numpy()[~pad], np.asarray(js)[~pad])


def test_factorized_top_k_with_an_ivf_index(rng):
    pts = clustered_corpus(rng, n_clusters=8, per=32, dim=16)
    q = _queries(rng, pts, 16)
    true = pts[rng.choice(len(pts), 16)]
    ks = (1, 5, 10)
    mine = FactorizedTopK(IVF(nlist=8, nprobe=8, device=CPU).index(pts),
                          ks=ks)
    theirs = jret.FactorizedTopK(jret.IVF(nlist=8, nprobe=8).index(pts),
                                 ks=ks)
    exact = FactorizedTopK(ks=ks)
    got = mine.compute(mine.update(mine.init(), torch.from_numpy(q),
                                   torch.from_numpy(true)))
    want = theirs.compute(theirs.update(theirs.init(), jnp.asarray(q),
                                        jnp.asarray(true)))
    full = exact.compute(exact.update(exact.init(), torch.from_numpy(q),
                                      torch.from_numpy(true),
                                      torch.from_numpy(pts)))
    for name in want:
        assert float(got[name]) == pytest.approx(float(want[name]))
        assert float(got[name]) == pytest.approx(float(full[name]))


def test_query_model_applies_before_scoring(rng):
    pts = rng.normal(0, 1, (64, 8)).astype(np.float32)
    q = rng.normal(0, 1, (4, 8)).astype(np.float32)
    doubled = IVF(nlist=4, nprobe=4, query_model=lambda x: 2 * x,
                  device=CPU).index(pts)
    plain = IVF(nlist=4, nprobe=4, device=CPU).index(pts)
    s2, i2 = doubled(q, k=3)
    s1, i1 = plain(q, k=3)
    close(s2.numpy(), 2 * s1.numpy())
    np.testing.assert_array_equal(i2.numpy(), i1.numpy())
