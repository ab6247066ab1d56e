"""Top-k retrieval of the PyTorch port against the JAX package: the ops of
``ops/topk.py`` (``exact_top_k`` against JAX's narrow and two-level block
paths, ``top_k_scores``, ``merge_top_k``, ``chunked_top_k``, ``exclude``),
the indexes of ``models/retrieval/factorized_top_k.py`` (``BruteForce``
with row, integer and string identifiers, ``Streaming``,
``InMemoryStreaming``, ``query_with_exclusions``, a ``query_model``),
``FactorizedTopK`` and ``save_index``/``load_index``, after the
single-device cases of ``tests/test_retrieval.py``.

Ties: ``lax.top_k`` puts the lower index first among equal scores and
``torch.topk`` promises no order, so every test that compares ids uses
tie-free data and says so: scores given directly are distinct multiples of
1/64 (exact in fp32 on both sides); scores that both sides compute as
products of seeded normals are checked first (in fp64) to have no two of a
row's top k + 1 within 4 D u max sum|q c| (u = 2^-24): each side's fp32
sum of D products lies within D u sum|q c| of the exact score, so no two
can swap places. Then ids are equal exactly and scores within rtol 1e-6
(atol 1e-6: two fp32 sums of D = 8 products in other orders).
FactorizedTopK's hit counts are equal exactly, on data checked to have no
candidate score within 1e-5 of its row's hit threshold.
"""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_recommenders_torch.models.retrieval import (
    BruteForce,
    FactorizedTopK,
    InMemoryStreaming,
    Streaming,
    factorized_top_k as tfk,
    load_index,
    save_index,
)
from deep_recommenders_torch.ops import topk as tt
from deep_recommenders_tpu.models import retrieval as jret
from deep_recommenders_tpu.ops import topk as jt

torch.set_num_threads(1)

CPU = "cpu"


def distinct_scores(rng, shape):
    """Each row a permutation of distinct multiples of 1/64 (exact in fp32),
    centred at 0: no ties."""
    n = shape[-1]
    rows = int(np.prod(shape[:-1]))
    out = np.stack([rng.permutation(n) for _ in range(rows)])
    return ((out - n / 2) / 64.0).astype(np.float32).reshape(shape)


def assert_tie_free(queries, cands, k):
    """Test-data precondition: no two of each row's top k + 1 scores q c
    (fp64) lie within 4 D u max sum|q c|, twice the most by which two fp32
    sums of the D products can each miss the exact score."""
    q, c = queries.astype(np.float64), cands.astype(np.float64)
    gap = 4 * q.shape[1] * 2.0**-24 * (np.abs(q) @ np.abs(c).T).max()
    top = -np.sort(-(q @ c.T), axis=-1)[..., :k + 1]
    assert (np.diff(-top, axis=-1) > gap).all(), "the test data has a tie"


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def t(x):
    return torch.from_numpy(np.array(x))


# -- ops/topk.py --------------------------------------------------------------

# block: the width of JAX's two-level selection (the port makes one
# torch.topk at every width).
@pytest.mark.parametrize("shape,k,block", [
    ((7, 5000), 100, 512),     # blocks, the last one padded
    ((3, 2049), 64, 512),      # blocks: just past 2 * 1024 at block 1024
    ((2, 4, 3000), 10, 512),   # a 3-D batch
    ((4, 5000), 100, None),    # the default block
    ((5, 900), 20, 512),       # narrow rows: one selection
    ((3, 3000), 600, 512),     # k above the block: one selection
])
def test_exact_top_k_matches_jax(rng, shape, k, block):
    """Scores and ids equal to JAX's on distinct scores, a few -inf (which
    stay out of the top k)."""
    scores = distinct_scores(rng, shape)
    scores.reshape(-1)[1::101] = -np.inf
    kw = {} if block is None else {"block": block}
    got_s, got_i = tt.exact_top_k(t(scores), k)
    want_s, want_i = jt.exact_top_k(jnp.asarray(scores), k, **kw)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_exact_top_k_with_ties_selects_the_same_scores(rng):
    """With ties the selected scores are JAX's (its block path), and every
    id points at its score (which of two equal scores comes first may
    differ)."""
    scores = rng.normal(size=(7, 5000)).astype(np.float32)
    scores.flat[::97] = 1.5
    scores.flat[1::101] = -np.inf
    got_s, got_i = tt.exact_top_k(t(scores), 100)
    want_s, _ = jt.exact_top_k(jnp.asarray(scores), 100, block=512)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(
        np.take_along_axis(scores, got_i.numpy(), -1), np.asarray(want_s))


def test_top_k_scores_and_merge_match_jax(rng):
    q = rng.normal(size=(4, 8)).astype(np.float32)
    c = rng.normal(size=(300, 8)).astype(np.float32)
    assert_tie_free(q, c, 10)
    got_s, got_i = tt.top_k_scores(t(q), t(c), 10)
    want_s, want_i = jt.top_k_scores(jnp.asarray(q), jnp.asarray(c), 10)
    close(got_s, want_s)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    # Two top-k states with disjoint ids merge into JAX's.
    s = distinct_scores(rng, (4, 20))
    ids = np.stack([rng.permutation(1000)[:20] for _ in range(4)])
    a = (s[:, :10], ids[:, :10])
    b = (s[:, 10:], ids[:, 10:])
    got = tt.merge_top_k(t(a[0]), t(a[1]), t(b[0]), t(b[1]), 7)
    want = jt.merge_top_k(*(jnp.asarray(x) for x in (*a, *b)), 7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n,chunk,k", [(97, 16, 7), (64, 64, 5),
                                       (300, 128, 100)])
def test_chunked_top_k_matches_jax(rng, n, chunk, k):
    """Chunks of the corpus folded with the merge: the corpus not a
    multiple of the chunk, one chunk, k near the chunk."""
    q = rng.normal(size=(3, 8)).astype(np.float32)
    c = rng.normal(size=(n, 8)).astype(np.float32)
    assert_tie_free(q, c, k)
    got_s, got_i = tt.chunked_top_k(t(q), t(c), k, chunk)
    want_s, want_i = jt.chunked_top_k(jnp.asarray(q), jnp.asarray(c), k,
                                      chunk)
    close(got_s, want_s)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("per_row", [False, True])
def test_exclude_matches_jax(rng, per_row):
    """-1e5 on each row's excluded identifiers, then the top k: identifiers
    shared by the rows (N,) or per row (B, N)."""
    b, n, k = 4, 40, 6
    scores = distinct_scores(rng, (b, n))
    if per_row:
        idents = np.stack([rng.permutation(500)[:n] for _ in range(b)])
        excl = idents[:, :3]
    else:
        idents = rng.permutation(500)[:n]
        excl = idents[rng.integers(0, n, (b, 3))]
    got_s, got_i = tt.exclude(t(scores), t(idents), t(excl), k)
    want_s, want_i = jt.exclude(jnp.asarray(scores), jnp.asarray(idents),
                                jnp.asarray(excl), k)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    for row in range(b):
        assert not set(got_i[row].tolist()) & set(excl[row].tolist())


# -- the indexes --------------------------------------------------------------

def corpus(rng, n=50, d=8, b=4, k=10):
    cands = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(b, d)).astype(np.float32)
    assert_tie_free(queries, cands, k)
    return cands, queries


@pytest.mark.parametrize("kind", ["rows", "ints", "strings"])
def test_brute_force_matches_jax(rng, kind):
    """Row ids, integer identifiers (gathered on the device) and string
    identifiers (on the host)."""
    cands, queries = corpus(rng)
    ids = {"rows": None, "ints": np.arange(100, 150, dtype=np.int64),
           "strings": np.asarray([f"movie_{i}" for i in range(50)],
                                 dtype=object)}[kind]
    got_s, got_i = BruteForce(device=CPU).index(cands, ids)(queries, k=5)
    want_s, want_i = jret.BruteForce().index(cands, ids)(queries, k=5)
    close(got_s, want_s)
    assert isinstance(got_i, np.ndarray if kind == "strings"
                      else torch.Tensor)
    np.testing.assert_array_equal(np.asarray(got_i), np.asarray(want_i))
    with pytest.raises(ValueError):
        BruteForce(device=CPU).index(cands, np.arange(3))
    with pytest.raises(ValueError):
        BruteForce(device=CPU)(queries)


@pytest.mark.parametrize("with_ids", [False, True])
def test_streaming_and_in_memory_match_brute_force_and_jax(rng, with_ids):
    """A stream of batches of 20 (the last short), with or without
    identifiers, and InMemoryStreaming in chunks of 16: each equal to JAX's
    and to BruteForce on the same corpus."""
    n, d, b, k = 97, 8, 3, 7
    cands, queries = corpus(rng, n, d, b, k)
    ids = np.arange(1000, 1000 + n, dtype=np.int64)

    def batches():
        for lo in range(0, n, 20):
            yield ((ids[lo:lo + 20], cands[lo:lo + 20]) if with_ids
                   else cands[lo:lo + 20])

    q = t(queries)
    want_s, want_i = jret.Streaming(batches)(queries, k=k)
    results = {
        "streaming": Streaming(batches, device=CPU)(q, k=k),
        "brute_force": BruteForce(device=CPU).index(
            cands, ids if with_ids else None)(q, k=k)}
    s, rows = InMemoryStreaming(chunk_size=16, device=CPU).index(cands)(
        q, k=k)
    results["in_memory"] = (s, t(ids)[rows] if with_ids else rows)
    for name, (got_s, got_i) in results.items():
        close(got_s, want_s)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i),
                                      err_msg=name)


def test_query_model_and_exclusions_match_jax(rng):
    """A query_model on every index; query_with_exclusions drops each row's
    excluded identifiers, as JAX's."""
    n, d, b, k = 53, 6, 4, 5
    w = rng.normal(size=(d, d)).astype(np.float32)
    cands = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(b, d)).astype(np.float32)
    assert_tie_free(queries @ w, cands, k + 2)
    tw = t(w)
    want_s, want_i = jret.BruteForce(
        query_model=lambda x: x @ jnp.asarray(w)).index(cands)(queries, k=k)

    def batches():
        for lo in range(0, n, 17):
            yield cands[lo:lo + 17]

    for index in (BruteForce(lambda x: x @ tw, device=CPU).index(cands),
                  Streaming(batches, lambda x: x @ tw, device=CPU),
                  InMemoryStreaming(16, lambda x: x @ tw,
                                    device=CPU).index(cands)):
        got_s, got_i = index(t(queries), k=k)
        close(got_s, want_s)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))

    assert_tie_free(queries, cands, k + 2)
    excl = np.asarray(jret.BruteForce().index(cands)(queries, k=2)[1])
    got = BruteForce(device=CPU).index(cands).query_with_exclusions(
        t(queries), t(excl), k=3)
    want = jret.BruteForce().index(cands).query_with_exclusions(
        queries, jnp.asarray(excl), k=3)
    close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for row in range(b):
        assert not set(got[1][row].tolist()) & set(excl[row].tolist())


# -- FactorizedTopK -----------------------------------------------------------

def _metric_inputs(rng, b=16, n=40, d=8):
    corpus_ = rng.normal(size=(n, d)).astype(np.float32)
    true_idx = rng.integers(0, n, b)
    q = (corpus_[true_idx]
         + rng.normal(size=(b, d)).astype(np.float32) * 0.3)
    q64, c64 = q.astype(np.float64), corpus_.astype(np.float64)
    pos = (q64 * c64[true_idx]).sum(1)
    margin = np.abs(q64 @ c64.T - (pos + 1e-6 * (1 + np.abs(pos)))[:, None])
    margin[np.arange(b), true_idx] = np.inf  # the positive itself
    assert (margin > 1e-5).all(), "a candidate at its row's threshold"
    return q, corpus_, true_idx


@pytest.mark.parametrize("source", ["candidates", "in_batch", "index"])
def test_factorized_top_k_matches_jax(rng, source):
    """Hit counts over two updates equal to JAX's exactly, against all
    candidates, the batch's own, or a BruteForce index."""
    q, corpus_, true_idx = _metric_inputs(rng)
    ks = (1, 5, 10)
    got_m = FactorizedTopK(
        BruteForce(device=CPU).index(corpus_) if source == "index" else None,
        ks)
    want_m = jret.FactorizedTopK(
        jret.BruteForce().index(corpus_) if source == "index" else None, ks)
    state, want_state = got_m.init(), want_m.init()
    for rows in (slice(0, 8), slice(8, 16)):
        kw = {"candidates": corpus_} if source == "candidates" else {}
        state = got_m.update(state, t(q[rows]), t(corpus_[true_idx[rows]]),
                             **{k: t(v) for k, v in kw.items()})
        want_state = want_m.update(want_state, q[rows],
                                   corpus_[true_idx[rows]], **kw)
    np.testing.assert_array_equal(state["hits"].numpy(),
                                  np.asarray(want_state["hits"]))
    assert state["count"].item() == float(want_state["count"]) == 16
    got, want = got_m.compute(state), want_m.compute(want_state)
    assert sorted(got) == sorted(want)
    for key in want:
        assert float(got[key]) == float(want[key]), key
    merged = FactorizedTopK.merge(state, state)
    assert merged["count"].item() == 32


# -- persistence --------------------------------------------------------------

INDEXES = [("BruteForce", None), ("BruteForce", "ints"),
           ("BruteForce", "strings"), ("InMemoryStreaming", None)]


def _identifiers(kind):
    return {None: None, "ints": np.arange(100, 164, dtype=np.int64),
            "strings": np.array([f"item_{i}" for i in range(64)])}[kind]


def _make(side, cls, device=CPU):
    mod = tfk if side == "port" else jret
    if cls == "BruteForce":
        return mod.BruteForce(device=device) if side == "port" \
            else mod.BruteForce()
    return mod.InMemoryStreaming(16, device=device) if side == "port" \
        else mod.InMemoryStreaming(chunk_size=16)


@pytest.mark.parametrize("cls,ids", INDEXES)
def test_index_round_trips_and_reads_jax_files(tmp_path, rng, cls, ids):
    """save_index -> load_index in the port gives the same results, with
    the candidates on the requested device; the files are JAX's format both
    ways (the port loads JAX's files, JAX loads the port's), with no pickled
    array (read with allow_pickle=False)."""
    cands = rng.normal(0, 1, (64, 8)).astype(np.float32)
    q = rng.normal(0, 1, (4, 8)).astype(np.float32)
    assert_tie_free(q, cands, 5)
    idx = _make("port", cls).index(cands, _identifiers(ids))
    s0, i0 = idx(t(q), k=5)

    path = save_index(str(tmp_path / "port"), idx)
    with np.load(f"{path}/state.npz", allow_pickle=False) as data:
        assert all(data[k].dtype != object for k in data.files)
    restored = load_index(path, device=CPU)
    assert type(restored) is type(idx)
    assert restored._candidates.device.type == "cpu"
    s1, i1 = restored(t(q), k=5)
    np.testing.assert_array_equal(s1.numpy(), s0.numpy())
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i0))

    by_jax = jret.load_index(path)
    close(by_jax(q, k=5)[0], s0)
    np.testing.assert_array_equal(np.asarray(by_jax(q, k=5)[1]),
                                  np.asarray(i0))
    jax_path = jret.save_index(
        str(tmp_path / "jax"),
        _make("jax", cls).index(cands, _identifiers(ids)))
    from_jax = load_index(jax_path, device=CPU)
    close(from_jax(t(q), k=5)[0], s0)
    np.testing.assert_array_equal(np.asarray(from_jax(t(q), k=5)[1]),
                                  np.asarray(i0))


def test_load_index_with_query_model_and_unknown_class(tmp_path, rng,
                                                       monkeypatch):
    """The query_model is given again at load; an index class this port
    lacks (JAX's ShardedBruteForce) raises, and one of JAX's ann.py loads;
    the default device is the card, which raises without one."""
    cands = rng.normal(0, 1, (32, 8)).astype(np.float32)
    q = t(rng.normal(0, 1, (4, 8)).astype(np.float32))

    def qm(x):
        return x * 2.0

    idx = BruteForce(query_model=qm, device=CPU).index(cands)
    path = save_index(str(tmp_path / "bf"), idx)
    restored = load_index(path, query_model=qm, device=CPU)
    for a, b in zip(idx(q, k=3), restored(q, k=3)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    ann = jret.save_index(str(tmp_path / "ann"),
                          jret.ApproxTopK().index(cands))
    assert type(load_index(ann, device=CPU)).__name__ == "ApproxTopK"
    sharded = str(tmp_path / "sharded")
    shutil.copytree(path, sharded)
    with open(os.path.join(sharded, "config.json"), "w") as f:
        json.dump({"class": "ShardedBruteForce", "config": {}}, f)
    with pytest.raises(ValueError, match="ShardedBruteForce"):
        load_index(sharded, device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_index(path)
