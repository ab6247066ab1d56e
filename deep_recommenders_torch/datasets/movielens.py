"""MovieLens-1M ingest: ETL, the ranking view and the retrieval view, as
pre-batched id arrays.

Counterpart of ``deep_recommenders_tpu/datasets/movielens.py``:

- ``load_ml1m`` joins users.dat + movies.dat onto shuffled ratings.dat;
- ``synthesize_ml1m`` is the deterministic stand-in with the same schema and
  marginals, bit-identical to the JAX package's for the same arguments (both
  movie-popularity forms);
- ``MovielensRanking`` encodes the six CTR features, label = rating > 3, and
  splits 0.8/0.2 once over the shuffled examples; its retrieval view gives
  the positive (user, movie) pairs of a split for the two-tower task.

The corpus is built in memory on every construction: there is no on-disk
cache, so nothing here unpickles a file.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from deep_recommenders_torch.features.columns import (
    WEIGHT_SUFFIX,
    Feature,
    FeatureEncoder,
)

NUM_RATINGS = 1_000_209
NUM_USERS = 6_040
NUM_MOVIES = 3_952
GENDER_VOCAB = ("F", "M")
AGE_VOCAB = (1, 18, 25, 35, 45, 50, 56)
OCCUPATION_VOCAB = tuple(range(21))
GENRES_VOCAB = (
    "Action", "Adventure", "Animation", "Children's", "Comedy",
    "Crime", "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror",
    "Musical", "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western",
)
MAX_GENRES = 6  # ml-1m movies carry at most 6 genres


def _load_dat(path: str, columns) -> Dict[str, Dict[str, str]]:
    """Parse an ml-1m ``::``-separated .dat file into {key: row_dict}."""
    data: Dict[str, Dict[str, str]] = {}
    with open(path, "r", encoding="unicode_escape") as f:
        for line in f:
            parts = line.strip("\n").split("::")
            data[parts[0]] = dict(zip(columns[1:], parts[1:]))
    return data


def load_ml1m(datadir: str, seed: int = 42) -> Dict[str, np.ndarray]:
    """ml-1m ETL: join users/movies onto ratings, shuffled with ``seed``."""
    users = _load_dat(
        os.path.join(datadir, "users.dat"),
        ["UserID", "Gender", "Age", "Occupation", "Zip-code"],
    )
    movies = _load_dat(
        os.path.join(datadir, "movies.dat"), ["MovieID", "Title", "Genres"]
    )
    cols = {k: [] for k in (
        "UserID", "MovieID", "Rating", "Timestamp", "Gender", "Age",
        "Occupation", "Zip-code", "Title", "Genres",
    )}
    with open(
        os.path.join(datadir, "ratings.dat"), "r", encoding="unicode_escape"
    ) as f:
        for line in f:
            u, m, r, t = line.strip().split("::")
            urow, mrow = users[u], movies[m]
            cols["UserID"].append(u)
            cols["MovieID"].append(m)
            cols["Rating"].append(int(r))
            cols["Timestamp"].append(int(t))
            cols["Gender"].append(urow["Gender"])
            cols["Age"].append(int(urow["Age"]))
            cols["Occupation"].append(int(urow["Occupation"]))
            cols["Zip-code"].append(urow["Zip-code"])
            cols["Title"].append(mrow["Title"])
            cols["Genres"].append(tuple(mrow["Genres"].split("|")))
    perm = np.random.default_rng(seed).permutation(len(cols["UserID"]))
    out = {}
    for k, values in cols.items():
        if isinstance(values[0], int):
            out[k] = np.asarray(values, dtype=np.int64)[perm]
            continue
        arr = np.empty(len(values), dtype=object)  # one cell per genre tuple
        for i, v in enumerate(values):
            arr[i] = v
        out[k] = arr[perm]
    return out


def synthesize_ml1m(
    num_ratings: int = NUM_RATINGS,
    num_users: int = NUM_USERS,
    num_movies: int = NUM_MOVIES,
    latent_dim: int = 8,
    seed: int = 42,
    movie_popularity: str = "zipf-draw",
) -> Dict[str, np.ndarray]:
    """Deterministic MovieLens-like corpus with learnable structure.

    Ratings follow a latent-factor model (user_factor . movie_factor + biases
    + noise), quantile-mapped to 1..5 with ml-1m's marginals, so
    ``rating > 3`` is predictable from ids and weakly from demographics.
    The random draws are the JAX package's, in its order.

    ``movie_popularity``:
    - ``"zipf-draw"`` (the CTR corpus): popularity drawn per movie from
      Zipf(1.4). Its unbounded tail puts about half the ratings on a few
      movies, too few distinct movies for a retrieval corpus.
    - ``"rank-power"`` (the retrieval corpus): popularity proportional to
      rank^-0.7 over a seeded permutation of the movies, so 1M draws cover
      about every movie. It consumes the generator differently from the
      Zipf branch, so the two forms give two distinct corpora.
    """
    rng = np.random.default_rng(seed)
    user_gender = rng.choice(len(GENDER_VOCAB), num_users)
    user_age = rng.choice(len(AGE_VOCAB), num_users)
    user_occ = rng.choice(len(OCCUPATION_VOCAB), num_users)
    u_fac = rng.normal(0, 1.0, (num_users, latent_dim))
    u_fac[:, 0] += 0.5 * (user_gender * 2 - 1)
    u_fac[:, 1] += 0.25 * (user_age - len(AGE_VOCAB) / 2)
    u_bias = rng.normal(0, 0.5, num_users)
    m_fac = rng.normal(0, 1.0, (num_movies, latent_dim))
    m_bias = rng.normal(0, 0.5, num_movies)
    n_genres = rng.integers(1, 4, num_movies)
    movie_genres = [
        tuple(
            GENRES_VOCAB[g]
            for g in rng.choice(len(GENRES_VOCAB), k, replace=False)
        )
        for k in n_genres
    ]
    # Zip-code and Title come from a stream of their own.
    rng_aux = np.random.default_rng(seed + 7919)
    user_zip = np.char.mod("%05d", rng_aux.integers(0, 100000, num_users))
    movie_year = rng_aux.integers(1919, 2001, num_movies)
    movie_title = np.asarray(
        [f"Movie {m} ({movie_year[m]})" for m in range(num_movies)],
        dtype=object,
    )
    if movie_popularity == "zipf-draw":
        movie_pop = rng.zipf(1.4, num_movies).astype(np.float64)
    elif movie_popularity == "rank-power":
        shuffle = rng.permutation(num_movies)
        ranks = np.empty(num_movies, np.float64)
        ranks[shuffle] = np.arange(1, num_movies + 1)
        movie_pop = ranks**-0.7
    else:
        raise ValueError(f"unknown movie_popularity {movie_popularity!r}")
    movie_p = movie_pop / movie_pop.sum()
    uid = rng.integers(0, num_users, num_ratings)
    mid = rng.choice(num_movies, num_ratings, p=movie_p)
    score = (
        (u_fac[uid] * m_fac[mid]).sum(-1) / np.sqrt(latent_dim)
        + u_bias[uid]
        + m_bias[mid]
        + rng.normal(0, 0.8, num_ratings)
    )
    # ~57.5% of ml-1m ratings are > 3.
    qs = np.quantile(score, [0.06, 0.17, 0.425, 0.77])
    rating = np.digitize(score, qs) + 1
    return {
        "UserID": np.char.mod("%d", uid),
        "MovieID": np.char.mod("%d", mid),
        "Rating": rating.astype(np.int64),
        "Timestamp": rng.integers(9.5e8, 1.05e9, num_ratings),
        "Gender": np.asarray(GENDER_VOCAB, dtype=object)[user_gender[uid]],
        "Age": np.asarray(AGE_VOCAB, dtype=np.int64)[user_age[uid]],
        "Occupation": np.asarray(OCCUPATION_VOCAB, dtype=np.int64)[
            user_occ[uid]
        ],
        "Zip-code": user_zip[uid].astype(object),
        "Title": movie_title[mid],
        "Genres": np.asarray(movie_genres, dtype=object)[mid],
    }


def default_movielens_features(
    user_hash_buckets: int = NUM_USERS,
    movie_hash_buckets: int = NUM_MOVIES,
) -> Tuple[Feature, ...]:
    """The canonical MovieLens feature set: hash-bucket ids, vocab-list
    demographics and the real genres vocab as a mean-combined bag."""
    return (
        Feature("user_id", hash_buckets=user_hash_buckets),
        Feature("user_gender", vocab=GENDER_VOCAB),
        Feature("user_age", vocab=AGE_VOCAB),
        Feature("user_occupation", vocab=OCCUPATION_VOCAB),
        Feature("movie_id", hash_buckets=movie_hash_buckets),
        Feature(
            "movie_genres",
            vocab=GENRES_VOCAB,
            max_len=MAX_GENRES,
            combiner="mean",
        ),
    )


@dataclasses.dataclass
class MovielensRanking:
    """CTR ranking view of MovieLens: encoded id arrays + binary label.

    label = float(rating > 3); the 0.8/0.2 train/test split is taken once
    over the shuffled examples. Reads ``datadir`` when it holds
    ratings.dat, else synthesizes the corpus with ``movie_popularity``
    (``"zipf-draw"``, the CTR corpus, or ``"rank-power"``, the retrieval
    corpus: see :func:`synthesize_ml1m`).
    """

    batch_size: int = 1024
    datadir: Optional[str] = None
    num_ratings: int = NUM_RATINGS
    seed: int = 42
    movie_popularity: str = "zipf-draw"
    features: Tuple[Feature, ...] = dataclasses.field(
        default_factory=default_movielens_features
    )

    def __post_init__(self):
        if self.datadir and os.path.exists(
            os.path.join(self.datadir, "ratings.dat")
        ):
            raw = load_ml1m(self.datadir, seed=self.seed)
        else:
            raw = synthesize_ml1m(self.num_ratings, seed=self.seed,
                                  movie_popularity=self.movie_popularity)
        self._data = FeatureEncoder(self.features).encode(
            {
                "user_id": raw["UserID"],
                "user_gender": raw["Gender"],
                "user_age": raw["Age"],
                "user_occupation": raw["Occupation"],
                "movie_id": raw["MovieID"],
                "movie_genres": raw["Genres"],
            }
        )
        self._label = (raw["Rating"] > 3).astype(np.float32)[:, None]
        self._raw_movie_id = np.asarray(raw["MovieID"])
        self._n = len(self._label)
        self._n_train = int(self._n * 0.8)

    @property
    def feature_specs(self) -> Tuple[Feature, ...]:
        return tuple(self.features)

    @property
    def train_steps_per_epoch(self) -> int:
        return self._n_train // self.batch_size

    @property
    def test_steps(self) -> int:
        return (self._n - self._n_train) // self.batch_size

    def _slice(self, lo: int, hi: int):
        feats = {k: v[lo:hi] for k, v in self._data.items()}
        return feats, self._label[lo:hi]

    def train_arrays(self) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """The train split as (features dict, labels) numpy arrays, cut to
        whole batches."""
        return self._slice(0, self.train_steps_per_epoch * self.batch_size)

    def test_arrays(self) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """The whole test split as (features dict, labels) numpy arrays."""
        return self._slice(self._n_train, self._n)

    def train_batches(
        self, epochs: int = 1, shuffle_seed: Optional[int] = None
    ) -> Iterator[Tuple[Dict[str, np.ndarray], np.ndarray]]:
        """Yield fixed-size train batches (remainder dropped)."""
        b = self.batch_size
        for e in range(epochs):
            idx = np.arange(self._n_train)
            if shuffle_seed is not None:
                np.random.default_rng(shuffle_seed + e).shuffle(idx)
            for s in range(self.train_steps_per_epoch):
                rows = idx[s * b : (s + 1) * b]
                feats = {k: v[rows] for k, v in self._data.items()}
                yield feats, self._label[rows]

    def test_batches(
        self,
    ) -> Iterator[Tuple[Dict[str, np.ndarray], np.ndarray]]:
        b = self.batch_size
        for s in range(self.test_steps):
            lo = self._n_train + s * b
            yield self._slice(lo, lo + b)

    # -- retrieval (two-tower) view ------------------------------------------
    USER_KEYS = ("user_id", "user_gender", "user_age", "user_occupation")
    ITEM_KEYS = ("movie_id", "movie_genres")

    def _positives(self, split: str) -> np.ndarray:
        """Rows of the split's positively rated examples (label 1)."""
        if split == "train":
            return np.flatnonzero(self._label[: self._n_train, 0] > 0.5)
        return self._n_train + np.flatnonzero(
            self._label[self._n_train :, 0] > 0.5)

    def _pair_view(self, rows: np.ndarray):
        """The rows' (user features, movie features) dicts; a bag's
        ``__wt`` weights go with its feature."""
        def side(keys):
            return {k: v[rows] for k, v in self._data.items()
                    if k.split(WEIGHT_SUFFIX)[0] in keys}

        return side(self.USER_KEYS), side(self.ITEM_KEYS)

    def retrieval_batches(
        self,
        epochs: int = 1,
        shuffle_seed: Optional[int] = None,
        split: str = "train",
    ) -> Iterator[Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]]:
        """(user features, watched-movie features) positive pairs of the
        split in whole batches; in-batch negatives supply the contrast."""
        pos = self._positives(split)
        b = self.batch_size
        for e in range(epochs):
            idx = pos.copy()
            if shuffle_seed is not None:
                np.random.default_rng(shuffle_seed + e).shuffle(idx)
            for s in range(len(idx) // b):
                yield self._pair_view(idx[s * b : (s + 1) * b])

    def retrieval_arrays(self, split: str = "train"):
        """Every positive pair of the split as (user dict, movie dict) and
        the pairs' encoded movie ids (the two-tower ``labels``: candidate
        ids for accidental-negative removal)."""
        pos = self._positives(split)
        user, item = self._pair_view(pos)
        return user, item, self._data["movie_id"][pos]

    def raw_movie_ids(self, split: str = "train") -> np.ndarray:
        """The raw (pre-hash) MovieID of each positive pair of the split.
        The encoded ids are CRC32 buckets, so distinct raw ids may share
        one (3,952 raw ids fall into about 2,468 buckets)."""
        return self._raw_movie_id[self._positives(split)]

    def user_specs(self) -> Tuple[Feature, ...]:
        return tuple(f for f in self.features if f.name in self.USER_KEYS)

    def item_specs(self) -> Tuple[Feature, ...]:
        return tuple(f for f in self.features if f.name in self.ITEM_KEYS)
