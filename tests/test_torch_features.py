"""Host layer of the PyTorch port against the JAX package: feature encoding
and the MovieLens corpus. Both are numpy; the arrays must be identical."""

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
