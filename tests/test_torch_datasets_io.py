"""The port's readers and fetchers of real corpora against the JAX
package's, on the CPU, with no network: ``load_imdb_npz`` on npz files the
tests write, ``download_ml1m`` and ``download_cora`` on ``file://`` URLs of
archives the tests build in ``tmp_path``.
"""

import io
import os
import pickle
import tarfile
import zipfile

import numpy as np
import pytest

from deep_recommenders_torch.datasets import (
    download_cora as t_download_cora,
    download_ml1m as t_download_ml1m,
    load_imdb_npz as t_load_imdb_npz,
)
from deep_recommenders_torch.examples import train_transformer_on_imdb
from deep_recommenders_tpu.datasets.cora import download_cora as j_download_cora
from deep_recommenders_tpu.datasets.imdb import load_imdb_npz as j_load_imdb_npz
from deep_recommenders_tpu.datasets.movielens import (
    download_ml1m as j_download_ml1m,
)


def _sequences(rng, n, as_arrays=False):
    """An object array of n token sequences of ragged length, with tokens
    past any small vocabulary, as keras's imdb.npz holds them (lists of
    ints), or as numpy arrays."""
    seqs = np.empty(n, dtype=object)
    for i in range(n):
        s = rng.integers(1, 20000, rng.integers(0, 60))
        seqs[i] = s.astype(np.int64) if as_arrays else s.tolist()
    return seqs


def _write_imdb(path, rng, as_arrays=False):
    np.savez(path, x_train=_sequences(rng, 40, as_arrays),
             y_train=rng.integers(0, 2, 40),
             x_test=_sequences(rng, 25, as_arrays),
             y_test=rng.integers(0, 2, 25).astype(np.int8))


@pytest.mark.parametrize("num_words,max_len", [(10000, 200), (500, 16),
                                               (20000, 1)])
@pytest.mark.parametrize("as_arrays", [False, True])
def test_load_imdb_npz_matches_jax(tmp_path, num_words, max_len, as_arrays):
    """Clipping (out of vocabulary -> 2), cutting and post-padding with 0,
    int32 labels: every array JAX's reader returns, bit for bit."""
    path = tmp_path / "imdb.npz"
    _write_imdb(path, np.random.default_rng(max_len), as_arrays)
    got = t_load_imdb_npz(str(path), num_words, max_len)
    want = j_load_imdb_npz(str(path), num_words, max_len)
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype == np.int32 and gx.shape == wx.shape
        assert gy.dtype == wy.dtype == np.int32
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    assert got[0][0].shape == (40, max_len)


class _Call:
    """A pickle that calls ``fn(*args)`` when it is loaded."""

    def __init__(self, fn, *args):
        self.fn, self.args = fn, args

    def __reduce__(self):
        return self.fn, self.args


@pytest.mark.parametrize("payload", [
    _Call(os.system, "echo unpickled"),
    _Call(eval, "1 + 1"),
    _Call(np.load, "missing.npy"),
])
def test_load_imdb_npz_refuses_other_callables(tmp_path, payload):
    """An object member whose pickle names anything but numpy's array
    reconstruction, ``ndarray``, ``dtype`` and ``list`` is refused before
    it is called."""
    x = np.empty(2, dtype=object)
    x[0], x[1] = [1, 2, 3], payload
    path = tmp_path / "evil.npz"
    np.savez(path, x_train=x, y_train=np.zeros(2), x_test=x,
             y_test=np.zeros(2))
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        t_load_imdb_npz(str(path))


def test_transformer_example_trains_on_an_imdb_npz(tmp_path):
    path = tmp_path / "imdb.npz"
    rng = np.random.default_rng(3)
    np.savez(path, x_train=_sequences(rng, 64), y_train=rng.integers(0, 2, 64),
             x_test=_sequences(rng, 32), y_test=rng.integers(0, 2, 32))
    result = train_transformer_on_imdb.main([
        "--imdb-npz", str(path), "--epochs", "1", "--batch-size", "16",
        "--num-words", "300", "--max-len", "12", "--model-dim", "16",
        "--device", "cpu"])
    assert len(result["step_losses"]) == 4
    assert np.isfinite(result["step_losses"]).all()
    assert 0.0 <= result["history"][0]["accuracy"] <= 1.0


# -- downloads ----------------------------------------------------------------

ML1M_FILES = {"ml-1m/ratings.dat": b"1::1193::5::978300760\n",
              "ml-1m/users.dat": b"1::F::1::10::48067\n",
              "ml-1m/movies.dat": b"1193::Title (1975)::Drama\n",
              "ml-1m/README": b"synthetic\n"}
CORA_FILES = {"cora/cora.content": b"31336\t0\t1\tNeural_Networks\n",
              "cora/cora.cites": b"35\t1033\n",
              "cora/README": b"synthetic\n"}


def _zip(path, files):
    with zipfile.ZipFile(path, "w") as zf:
        for name, data in files.items():
            zf.writestr(name, data)
    return "file://" + str(path)


def _tgz(path, files):
    with tarfile.open(path, "w:gz") as tf:
        for name, data in files.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return "file://" + str(path)


def _tree(root):
    out = {}
    for base, _, names in os.walk(root):
        for name in names:
            full = os.path.join(base, name)
            with open(full, "rb") as f:
                out[os.path.relpath(full, root)] = f.read()
    return out


@pytest.mark.parametrize("kind", ["ml1m", "cora"])
def test_download_extracts_as_jax_and_skips_a_second_time(tmp_path, kind):
    """The extracted tree and the returned path are JAX's; a second call
    with the archive and its URL gone fetches nothing and returns the same
    path; an interrupted fetch leaves no ``.part`` file."""
    files = ML1M_FILES if kind == "ml1m" else CORA_FILES
    build = _zip if kind == "ml1m" else _tgz
    port, jax_ = ((t_download_ml1m, j_download_ml1m) if kind == "ml1m"
                  else (t_download_cora, j_download_cora))
    archive = tmp_path / ("src.zip" if kind == "ml1m" else "src.tgz")
    url = build(archive, files)
    got = port(str(tmp_path / "port"), url=url, timeout=5)
    want = jax_(str(tmp_path / "jax"), url=url, timeout=5)
    assert os.path.relpath(got, tmp_path / "port") == os.path.relpath(
        want, tmp_path / "jax")
    tree = _tree(tmp_path / "port")
    assert tree == _tree(tmp_path / "jax")
    for name, data in files.items():
        assert tree[name] == data
    assert not any(n.endswith(".part") for n in tree)
    # no archive, no URL: nothing is fetched
    os.remove(archive)
    os.remove(os.path.join(tmp_path / "port", os.path.basename(
        "ml-1m.zip" if kind == "ml1m" else "cora.tgz")))
    assert port(str(tmp_path / "port"), url=url, timeout=5) == got


def test_download_ml1m_refuses_a_member_outside_dest(tmp_path):
    url = _zip(tmp_path / "evil.zip",
               {"ml-1m/ratings.dat": b"x", "../escaped.txt": b"x"})
    with pytest.raises(ValueError, match="leaves"):
        t_download_ml1m(str(tmp_path / "dest"), url=url, timeout=5)
    assert not (tmp_path / "escaped.txt").exists()
    assert not (tmp_path / "dest" / "ml-1m" / "ratings.dat").exists()


@pytest.mark.parametrize("kind", ["dotdot", "symlink"])
def test_download_cora_refuses_a_member_outside_dest(tmp_path, kind):
    """A ``..`` member, or a link pointing out of the destination, is
    refused by the tar's ``data`` filter."""
    path = tmp_path / "evil.tgz"
    with tarfile.open(path, "w:gz") as tf:
        info = tarfile.TarInfo("cora/cora.cites")
        info.size = 1
        tf.addfile(info, io.BytesIO(b"x"))
        if kind == "dotdot":
            info = tarfile.TarInfo("../escaped.txt")
            info.size = 1
            tf.addfile(info, io.BytesIO(b"x"))
        else:
            info = tarfile.TarInfo("cora/link")
            info.type, info.linkname = tarfile.SYMTYPE, "../../escaped.txt"
            tf.addfile(info)
    with pytest.raises(tarfile.FilterError):
        t_download_cora(str(tmp_path / "dest"), url="file://" + str(path),
                        timeout=5)
    assert not (tmp_path / "escaped.txt").exists()
    assert not os.path.lexists(tmp_path / "dest" / "cora" / "link")


@pytest.mark.parametrize("fn", [t_download_ml1m, t_download_cora])
def test_download_of_an_unreachable_url_raises_oserror(tmp_path, fn):
    dest = tmp_path / "dest"
    with pytest.raises(OSError):
        fn(str(dest), url="file://" + str(tmp_path / "missing.archive"),
           timeout=5)
    assert not any(n.endswith(".part") for n in os.listdir(dest))
