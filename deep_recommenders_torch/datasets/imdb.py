"""IMDB-style binary text classification data.

Counterpart of ``deep_recommenders_tpu/datasets/imdb.py``.
``SyntheticImdb`` makes the same arrays as the JAX package's for the same
arguments: integer token sequences (0 = padding, ids below 10 reserved,
Zipfian background vocabulary), post-padded to ``max_len``, and a binary
label carried by planted "polarity" tokens. The numpy draws are the JAX
module's, in its order. Reading the real keras ``imdb.npz`` is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


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
