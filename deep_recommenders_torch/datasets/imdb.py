"""IMDB-style binary text classification data.

Counterpart of ``deep_recommenders_tpu/datasets/imdb.py``.
``SyntheticImdb`` makes the same arrays as the JAX package's for the same
arguments: integer token sequences (0 = padding, ids below 10 reserved,
Zipfian background vocabulary), post-padded to ``max_len``, and a binary
label carried by planted "polarity" tokens. The numpy draws are the JAX
module's, in its order. ``load_imdb_npz`` reads the real keras
``imdb.npz``, whose sequences are pickled object arrays, through an
unpickler that builds numpy arrays and lists and nothing else.
"""

from __future__ import annotations

import dataclasses
import io
import pickle
import zipfile
from typing import Iterator, Tuple

import numpy as np

# What an object array saved by numpy may name in its pickle: the array's
# reconstruction (numpy 1.x and 2.x module paths), its type and dtype, and
# plain lists.
_RECONSTRUCT = np.zeros(1).__reduce__()[0]
_ALLOWED = {
    ("numpy.core.multiarray", "_reconstruct"): _RECONSTRUCT,
    ("numpy._core.multiarray", "_reconstruct"): _RECONSTRUCT,
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): np.dtype,
    ("builtins", "list"): list,
}


class _ArrayUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        try:
            return _ALLOWED[(module, name)]
        except KeyError:
            raise pickle.UnpicklingError(
                f"refusing to unpickle {module}.{name}: an object array "
                "here may hold only numpy arrays and lists") from None


def _read_npy(data: bytes) -> np.ndarray:
    """One ``.npy`` member: a plain array as numpy reads it with
    ``allow_pickle=False``, an object array through
    :class:`_ArrayUnpickler`."""
    f = io.BytesIO(data)
    version = np.lib.format.read_magic(f)
    if version == (1, 0):
        _, _, dtype = np.lib.format.read_array_header_1_0(f)
    elif version == (2, 0):
        _, _, dtype = np.lib.format.read_array_header_2_0(f)
    else:
        raise ValueError(f".npy format version {version} is not supported")
    if not dtype.hasobject:
        f.seek(0)
        return np.lib.format.read_array(f, allow_pickle=False)
    array = _ArrayUnpickler(f).load()
    if not isinstance(array, np.ndarray):
        raise pickle.UnpicklingError("an object member holds no array")
    return array


def _pad(seqs, max_len: int) -> np.ndarray:
    out = np.zeros((len(seqs), max_len), np.int32)
    for i, s in enumerate(seqs):
        s = list(s)[:max_len]
        out[i, :len(s)] = s  # post-padding with 0
    return out


def load_imdb_npz(
    path: str, num_words: int = 10000, max_len: int = 200
) -> Tuple[Tuple[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]:
    """Parse a keras ``imdb.npz`` (``x_train``/``y_train``/``x_test``/
    ``y_test``, the sequences as object arrays) into
    ``((x_train, y_train), (x_test, y_test))``: tokens at or above
    ``num_words`` become 2 (out of vocabulary), each sequence is cut to
    ``max_len`` and post-padded with 0 as an int32 row, labels are int32.

    The object arrays are unpickled with only numpy's array reconstruction,
    ``ndarray``, ``dtype`` and ``list`` admitted: a file whose pickle names
    any other callable raises ``pickle.UnpicklingError``.
    """
    with zipfile.ZipFile(path) as zf:
        arrays = {name[:-len(".npy")]: _read_npy(zf.read(name))
                  for name in zf.namelist() if name.endswith(".npy")}
    x_train, y_train = arrays["x_train"], arrays["y_train"]
    x_test, y_test = arrays["x_test"], arrays["y_test"]

    def clip(seqs):
        return [[t if t < num_words else 2 for t in s] for s in seqs]

    return (
        (_pad(clip(x_train), max_len), y_train.astype(np.int32)),
        (_pad(clip(x_test), max_len), y_test.astype(np.int32)),
    )


@dataclasses.dataclass
class SyntheticImdb:
    num_examples: int = 5000
    num_words: int = 2000
    max_len: int = 128
    num_polarity_tokens: int = 40
    seed: int = 42

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        n, v, length = self.num_examples, self.num_words, self.max_len
        # Zipfian background tokens in [10, v); ids < 10 reserved.
        tokens = 10 + (
            rng.zipf(1.3, size=(n, length)) % (v - 10)
        ).astype(np.int32)
        lengths = rng.integers(length // 4, length + 1, n)
        labels = rng.integers(0, 2, n).astype(np.int32)
        # Two disjoint pools of polarity tokens; a document draws mostly
        # from its class's pool.
        polar = rng.choice(
            np.arange(10, v), 2 * self.num_polarity_tokens, replace=False
        )
        pools = (polar[: self.num_polarity_tokens],
                 polar[self.num_polarity_tokens:])
        for i in range(n):
            num_polar = rng.integers(3, 10)
            positions = rng.integers(0, lengths[i], num_polar)
            tokens[i, positions] = rng.choice(pools[labels[i]], num_polar)
            tokens[i, lengths[i]:] = 0  # padding
        split = int(n * 0.8)
        self.train = (tokens[:split], labels[:split])
        self.test = (tokens[split:], labels[split:])

    def batches(
        self, split: str = "train", batch_size: int = 64,
        epochs: int = 1, shuffle_seed: int = 0,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Whole batches of (tokens, labels); the train split is shuffled
        anew each epoch with seed ``shuffle_seed + epoch``."""
        x, y = self.train if split == "train" else self.test
        for e in range(epochs):
            idx = np.arange(len(y))
            if split == "train":
                np.random.default_rng(shuffle_seed + e).shuffle(idx)
            for s in range(len(y) // batch_size):
                rows = idx[s * batch_size: (s + 1) * batch_size]
                yield x[rows], y[rows]
