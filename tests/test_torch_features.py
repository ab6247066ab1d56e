"""Host layer of the PyTorch port against the JAX package: feature encoding
(``DenseFeature`` and ``FeatureEncoder.categorical`` too), the MovieLens
corpus, its artifact (``serialize_corpus``/``read_corpus``, each package
reading the other's file), ``MovielensRanking`` from a corpus file with a
``train_size``, and its cache. Both are numpy; the arrays must be
identical."""

import os

import numpy as np
import pytest
import torch

from deep_recommenders_torch.datasets import movielens as t_ml
from deep_recommenders_torch.features import columns as t_cols
from deep_recommenders_tpu.datasets import movielens as j_ml
from deep_recommenders_tpu.features import columns as j_cols

torch.set_num_threads(1)


def _assert_same_columns(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].shape == b[k].shape, k
        assert all(x == y for x, y in zip(a[k].tolist(), b[k].tolist())), k


@pytest.mark.parametrize("seed", [42, 7])
def test_synthesize_ml1m_identical(seed):
    kw = dict(num_ratings=3000, seed=seed)
    _assert_same_columns(
        t_ml.synthesize_ml1m(**kw), j_ml.synthesize_ml1m(**kw)
    )


def test_feature_encoder_identical():
    raw = j_ml.synthesize_ml1m(num_ratings=3000, seed=42)
    cols = {
        "user_id": raw["UserID"], "user_gender": raw["Gender"],
        "user_age": raw["Age"], "user_occupation": raw["Occupation"],
        "movie_id": raw["MovieID"], "movie_genres": raw["Genres"],
    }
    got = t_cols.FeatureEncoder(t_ml.default_movielens_features()).encode(cols)
    want = j_cols.FeatureEncoder(j_ml.default_movielens_features()).encode(
        cols
    )
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    assert got["movie_genres"].dtype == np.int32
    assert got["movie_genres__wt"].dtype == np.float32


def test_hash_and_vocab_identical():
    values = ["a", b"b", 7, "user_42", "", 3.5] * 200  # > 512 values
    np.testing.assert_array_equal(
        t_cols.crc32_hash_bucket(values, 97),
        j_cols.crc32_hash_bucket(values, 97),
    )
    vocab = ("F", "M")
    np.testing.assert_array_equal(
        t_cols.vocab_lookup(["M", "F", "X"], vocab),
        j_cols.vocab_lookup(["M", "F", "X"], vocab),
    )


@pytest.mark.parametrize("kwargs", [
    dict(name="x"),
    dict(name="x", vocab=("a",), hash_buckets=3),
    dict(name="x", vocab=("a",), combiner="max"),
])
def test_feature_rejects_bad_specs(kwargs):
    with pytest.raises(ValueError):
        t_cols.Feature(**kwargs)
    with pytest.raises(ValueError):
        j_cols.Feature(**kwargs)


def test_movielens_ranking_identical():
    kw = dict(batch_size=256, num_ratings=3000, seed=42)
    got = t_ml.MovielensRanking(**kw)
    want = j_ml.MovielensRanking(cache_dir=None, **kw)
    assert got.train_steps_per_epoch == want.train_steps_per_epoch
    assert got.test_steps == want.test_steps
    for split in ("train_arrays", "test_arrays"):
        (gf, gl), (wf, wl) = getattr(got, split)(), getattr(want, split)()
        np.testing.assert_array_equal(gl, wl)
        for k in wf:
            np.testing.assert_array_equal(gf[k], wf[k])
    for (gf, gl), (wf, wl) in zip(got.train_batches(1, shuffle_seed=3),
                                  want.train_batches(1, shuffle_seed=3)):
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gf["movie_id"], wf["movie_id"])


def test_load_ml1m_identical(tmp_path):
    (tmp_path / "users.dat").write_text(
        "1::F::1::10::48067\n2::M::56::16::70072\n"
    )
    (tmp_path / "movies.dat").write_text(
        "1::Toy Story (1995)::Animation|Children's|Comedy\n"
        "2::Jumanji (1995)::Adventure\n"
    )
    (tmp_path / "ratings.dat").write_text(
        "1::1::5::978300760\n2::2::3::978302109\n1::2::4::978301968\n"
        "2::1::1::978300275\n"
    )
    _assert_same_columns(
        t_ml.load_ml1m(str(tmp_path), seed=1),
        j_ml.load_ml1m(str(tmp_path), seed=1),
    )
    got = t_ml.MovielensRanking(batch_size=1, datadir=str(tmp_path))
    want = j_ml.MovielensRanking(batch_size=1, datadir=str(tmp_path),
                                 cache_dir=None)
    np.testing.assert_array_equal(got.test_arrays()[1],
                                  want.test_arrays()[1])


def test_dense_feature_and_categorical_match_jax(rng):
    values = rng.normal(size=(20, 3)).astype(np.float64)
    for dim, x in ((3, values), (1, values[:, 0])):
        got = t_cols.DenseFeature("c", dim).encode(x)
        want = j_cols.DenseFeature("c", dim).encode(x)
        assert got["c"].dtype == want["c"].dtype == np.float32
        np.testing.assert_array_equal(got["c"], want["c"])
    for cols in (t_cols, j_cols):
        with pytest.raises(ValueError, match="expected 2-D"):
            cols.DenseFeature("c", 3).encode(values[:, 0])
    specs = {}
    for name, cols in (("t", t_cols), ("j", j_cols)):
        enc = cols.FeatureEncoder([
            cols.Feature("u", hash_buckets=50), cols.DenseFeature("c", 3),
            cols.CrossedFeature("x", keys=("u", "v"), hash_buckets=9),
            cols.Feature("v", vocab=("a", "b")),
        ])
        specs[name] = enc.categorical
        raw = {"u": np.arange(20), "c": values, "v": ["a", "b"] * 10}
        specs[name + "_out"] = enc.encode(raw)
    assert [s.name for s in specs["t"]] == [s.name for s in specs["j"]] \
        == ["u", "v"]
    assert all(isinstance(s, t_cols.Feature) for s in specs["t"])
    _assert_same_columns(specs["t_out"], specs["j_out"])


def test_corpus_artifact_both_ways(tmp_path):
    raw = t_ml.synthesize_ml1m(num_ratings=2000, seed=3)
    mine = t_ml.serialize_corpus(raw, str(tmp_path / "port" / "c.npz"))
    theirs = j_ml.serialize_corpus(j_ml.synthesize_ml1m(2000, seed=3),
                                   str(tmp_path / "jax.npz"))
    assert t_ml.CORPUS_COLUMNS == j_ml.CORPUS_COLUMNS
    with np.load(mine, allow_pickle=False) as f:
        assert sorted(f.files) == sorted(t_ml.CORPUS_COLUMNS)
        assert not any(f[k].dtype == object for k in f.files)
    _assert_same_columns(t_ml.read_corpus(theirs), j_ml.read_corpus(mine))
    _assert_same_columns(t_ml.read_corpus(mine), j_ml.read_corpus(theirs))
    with pytest.raises(ValueError, match="missing columns"):
        t_ml.serialize_corpus({"UserID": raw["UserID"]},
                              str(tmp_path / "x.npz"))


@pytest.mark.parametrize("train_size", [0.8, 0.65])
def test_movielens_from_corpus_matches_jax(tmp_path, train_size):
    path = t_ml.serialize_corpus(t_ml.synthesize_ml1m(3000, seed=5),
                                 str(tmp_path / "c.npz"))
    kw = dict(batch_size=64, corpus_path=path, seed=9, train_size=train_size)
    got = t_ml.MovielensRanking(**kw)
    want = j_ml.MovielensRanking(cache_dir=None, **kw)
    assert got.train_steps_per_epoch == want.train_steps_per_epoch \
        == int(3000 * train_size) // 64
    assert got.test_steps == want.test_steps
    for split in ("train_arrays", "test_arrays"):
        (gf, gl), (wf, wl) = getattr(got, split)(), getattr(want, split)()
        np.testing.assert_array_equal(gl, wl)
        _assert_same_columns(gf, wf)
    np.testing.assert_array_equal(got.raw_movie_ids("test"),
                                  want.raw_movie_ids("test").astype(str))


def test_movielens_cache_hit_equals_cold_build(tmp_path):
    kw = dict(batch_size=64, num_ratings=2500, seed=4,
              cache_dir=str(tmp_path / "cache"))
    cold = t_ml.MovielensRanking(**kw)
    files = os.listdir(tmp_path / "cache")
    assert len(files) == 1 and files[0].startswith("torch_movielens_v1_")
    with np.load(tmp_path / "cache" / files[0], allow_pickle=False) as f:
        assert not any(f[k].dtype == object for k in f.files)
    hit = t_ml.MovielensRanking(**kw)
    uncached = t_ml.MovielensRanking(**dict(kw, cache_dir=None))
    for ds in (hit, uncached):
        for split in ("train_arrays", "test_arrays"):
            (gf, gl), (wf, wl) = getattr(ds, split)(), getattr(cold, split)()
            np.testing.assert_array_equal(gl, wl)
            _assert_same_columns(gf, wf)
        np.testing.assert_array_equal(ds.raw_movie_ids(),
                                      cold.raw_movie_ids())
    # Another seed is another key, not a stale hit.
    t_ml.MovielensRanking(**dict(kw, seed=5))
    assert len(os.listdir(tmp_path / "cache")) == 2
