"""The port's native ETL and prefetch loader against the JAX package's.

The port compiles its own copies of fastetl.cpp (with a CRC-32 table of its
own, no zlib) and loader.cpp into build/native/; every result here is held
bit for bit to the JAX package's native functions (and to Python's
``zlib.crc32``) on the same inputs.
"""

import os
import zlib

import numpy as np
import pytest

from deep_recommenders_torch import native
from deep_recommenders_torch.datasets import movielens as t_ml
from deep_recommenders_torch.examples import train_deepfm_on_movielens
from deep_recommenders_torch.features import columns as t_columns
from deep_recommenders_tpu import native as j_native
from deep_recommenders_tpu.datasets import movielens as j_ml

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def test_library_builds_into_build_native():
    assert native.available()
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "build", "native")
    assert os.path.exists(path)
    assert os.path.basename(path).startswith("libfastetl-")


def test_crc32_bucket_matches_zlib_and_jax(rng):
    values = ([str(i) for i in rng.integers(0, 10**9, 2000)]
              + ["", "héllo wörld", "a" * 300, b"\x00\xff\x10", 42, 3.5,
                 ("t", 1)])
    want = np.asarray(
        [zlib.crc32(v if isinstance(v, bytes) else str(v).encode("utf-8"))
         % 977 for v in values], np.int32)
    got = native.crc32_bucket(values, 977)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, j_native.crc32_bucket(values, 977))
    # The feature hashing routes past 512 values through the native loop;
    # its zlib loop gives the same buckets.
    np.testing.assert_array_equal(
        t_columns.crc32_hash_bucket(values, 977), want)
    np.testing.assert_array_equal(
        t_columns.crc32_hash_bucket(values[:512], 977), want[:512])


def _write_ml1m(d, rng, n=300):
    users = [f"{u}::{'FM'[u % 2]}::{[1, 18, 25][u % 3]}::{u % 21}::"
             f"{10000 + u}" for u in range(1, 41)]
    movies = [f"{m}::Movie {m} (199{m % 10})::"
              f"{'|'.join(['Action', 'Comedy', 'Drama'][:1 + m % 3])}"
              for m in range(1, 61)]
    ratings = [f"{rng.integers(1, 41)}::{rng.integers(1, 61)}::"
               f"{rng.integers(1, 6)}::{rng.integers(9e8, 1e9)}"
               for _ in range(n)]
    for name, lines in (("users.dat", users), ("movies.dat", movies),
                        ("ratings.dat", ratings)):
        with open(os.path.join(d, name), "w") as f:
            f.write("\n".join(lines) + "\n")


def test_parse_ml1m_ratings_matches_jax(tmp_path, rng):
    _write_ml1m(str(tmp_path), rng)
    path = str(tmp_path / "ratings.dat")
    got = native.parse_ml1m_ratings(path)
    want = j_native.parse_ml1m_ratings(path)
    assert len(got[0]) == 300
    for g, x in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, x)
    with pytest.raises(FileNotFoundError):
        native.parse_ml1m_ratings(str(tmp_path / "missing.dat"))


def test_load_ml1m_native_and_python_match_jax(tmp_path, rng, monkeypatch):
    _write_ml1m(str(tmp_path), rng)
    native_cols = t_ml.load_ml1m(str(tmp_path), seed=5)
    monkeypatch.setattr(native, "available", lambda: False)
    python_cols = t_ml.load_ml1m(str(tmp_path), seed=5)
    want = j_ml.load_ml1m(str(tmp_path), seed=5)
    assert list(native_cols) == list(python_cols) == list(want)
    for k in want:
        for got in (native_cols, python_cols):
            assert got[k].dtype == want[k].dtype, k
            assert list(got[k]) == list(want[k]), k


def test_pack_bags_matches_jax(rng):
    lengths = rng.integers(0, 9, 200)  # empty bags and bags past max_len
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    flat = rng.integers(0, 1000, offsets[-1]).astype(np.int32)
    ids, wt = native.pack_bags(flat, offsets, 6)
    j_ids, j_wt = j_native.pack_bags(flat, offsets, 6)
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_array_equal(wt, j_wt)
    assert ids.dtype == np.int32 and wt.dtype == np.float32
    np.testing.assert_array_equal(wt.sum(1), np.minimum(lengths, 6))
    with pytest.raises(ValueError):
        native.pack_bags(flat, offsets[::-1].copy(), 6)


def _corpus(rng, n=1000):
    feats = {"ids": rng.integers(0, 100, (n, 3)).astype(np.int32),
             "x": rng.random(n).astype(np.float32)}
    return feats, rng.random((n, 1)).astype(np.float32)


@pytest.mark.parametrize("shuffle", [True, False])
def test_stream_loader_matches_jax(rng, shuffle):
    feats, labels = _corpus(rng)
    got = native.NativeStreamLoader(feats, labels, 64, seed=7,
                                    shuffle=shuffle)
    want = j_native.NativeStreamLoader(feats, labels, 64, seed=7,
                                       shuffle=shuffle)
    try:
        assert got.steps_per_epoch == want.steps_per_epoch == 15
        for _ in range(2 * got.steps_per_epoch + 3):  # past two epochs
            gf, gl = got.next_batch()
            wf, wl = want.next_batch()
            assert sorted(gf) == sorted(wf)
            for k in feats:
                np.testing.assert_array_equal(gf[k], wf[k])
            np.testing.assert_array_equal(gl, wl)
        if not shuffle:
            got2 = native.NativeStreamLoader(feats, labels, 64,
                                             shuffle=False)
            f, lab = got2.next_batch()
            np.testing.assert_array_equal(lab, labels[:64])
            got2.close()
    finally:
        got.close()
        want.close()


def test_kept_batch_survives_next_batch(rng):
    feats, labels = _corpus(rng)
    with native.NativeStreamLoader(feats, labels, 64, capacity=2,
                                   seed=1) as loader:
        kept_f, kept_l = loader.next_batch()
        saved = {k: v.copy() for k, v in kept_f.items()}, kept_l.copy()
        for _ in range(6):  # every slot of the ring is refilled
            loader.next_batch()
        for k in feats:
            np.testing.assert_array_equal(kept_f[k], saved[0][k])
        np.testing.assert_array_equal(kept_l, saved[1])
    with pytest.raises(RuntimeError, match="closed"):
        loader.next_batch()


def test_explicit_requests_raise_without_the_library(monkeypatch, rng):
    def refuse():
        raise RuntimeError("native ETL build failed (g++ exit 1)")

    monkeypatch.setattr(native, "library", refuse)
    assert not native.available()
    feats, labels = _corpus(rng, 100)
    with pytest.raises(RuntimeError, match="native ETL build failed"):
        native.NativeStreamLoader(feats, labels, 10)
    with pytest.raises(RuntimeError, match="native ETL build failed"):
        native.crc32_bucket(["a"], 3)
    # The implicit speed-up falls back to zlib, with the same buckets.
    values = [str(i) for i in range(600)]
    np.testing.assert_array_equal(
        t_columns.crc32_hash_bucket(values, 50),
        [zlib.crc32(v.encode()) % 50 for v in values])


def test_example_native_loader_runs_on_cpu(capsys):
    result = train_deepfm_on_movielens.main([
        "--num-ratings", "3000", "--epochs", "2", "--batch-size", "256",
        "--embedding-dim", "4", "--device", "cpu", "--host-streaming",
        "--native-loader",
    ])
    assert len(result["history"]) == 2
    assert 0.0 <= result["history"][-1]["auc"] <= 1.0
    assert "final: auc=" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        train_deepfm_on_movielens.main(["--native-loader", "--device", "cpu"])
