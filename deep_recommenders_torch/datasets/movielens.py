"""MovieLens-1M ingest: ETL, the ranking view and the retrieval view, as
pre-batched id arrays.

Counterpart of ``deep_recommenders_tpu/datasets/movielens.py``:

- ``load_ml1m`` joins users.dat + movies.dat onto shuffled ratings.dat
  (ratings.dat through the native parser when the library can be built);
- ``synthesize_ml1m`` is the deterministic stand-in with the same schema and
  marginals, bit-identical to the JAX package's for the same arguments (both
  movie-popularity forms);
- ``serialize_corpus`` / ``read_corpus`` write and read the joined corpus
  as one artifact (``CORPUS_COLUMNS``, no object arrays);
- ``download_ml1m`` fetches and unzips the real corpus (each member's
  path checked to stay under the destination);
- ``MovielensRanking`` encodes the six CTR features, label = rating > 3, and
  splits ``train_size``/rest once over the shuffled examples; its retrieval
  view gives the positive (user, movie) pairs of a split for the two-tower
  task.

With a ``cache_dir`` the encoded arrays are kept there between
constructions, in files of the port's own (``torch_movielens_v1_<key>.npz``,
numeric and fixed-width string arrays only). Every file here is read with
``allow_pickle=False``, so nothing unpickles a file.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import zipfile
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from deep_recommenders_torch import native
from deep_recommenders_torch.datasets._download import fetch
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

ML1M_URL = "https://files.grouplens.org/datasets/movielens/ml-1m.zip"


def download_ml1m(
    dest_dir: str, url: str = ML1M_URL, timeout: float = 60.0
) -> str:
    """Download and unzip the real ml-1m corpus; return the directory of
    its ``.dat`` files, ``<dest_dir>/ml-1m``.

    Skips both the download and the extraction when ``ratings.dat`` is
    already there, and the download when ``ml-1m.zip`` is. Raises
    ``OSError`` when the URL is unreachable (callers offline fall back to
    ``synthesize_ml1m``), ``ValueError`` when a member's path leaves
    ``dest_dir``.
    """
    out = os.path.join(dest_dir, "ml-1m")
    if os.path.exists(os.path.join(out, "ratings.dat")):
        return out
    os.makedirs(dest_dir, exist_ok=True)
    zip_path = os.path.join(dest_dir, "ml-1m.zip")
    fetch(url, zip_path, timeout)
    root = os.path.realpath(dest_dir)
    with zipfile.ZipFile(zip_path) as zf:
        for name in zf.namelist():
            target = os.path.realpath(os.path.join(root, name))
            if os.path.commonpath([root, target]) != root:
                raise ValueError(f"{zip_path}: member {name!r} leaves "
                                 f"{dest_dir}")
        zf.extractall(dest_dir)
    return out


def _load_dat(path: str, columns) -> Dict[str, Dict[str, str]]:
    """Parse an ml-1m ``::``-separated .dat file into {key: row_dict}."""
    data: Dict[str, Dict[str, str]] = {}
    with open(path, "r", encoding="unicode_escape") as f:
        for line in f:
            parts = line.strip("\n").split("::")
            data[parts[0]] = dict(zip(columns[1:], parts[1:]))
    return data


def _objects(values) -> np.ndarray:
    arr = np.empty(len(values), dtype=object)  # one cell per genre tuple
    for i, v in enumerate(values):
        arr[i] = v
    return arr


def load_ml1m(datadir: str, seed: int = 42) -> Dict[str, np.ndarray]:
    """ml-1m ETL: join users/movies onto ratings, shuffled with ``seed``.

    ratings.dat is parsed by the native library when it can be built (ids
    joined by integer index), else line by line; both give the same
    columns."""
    users = _load_dat(
        os.path.join(datadir, "users.dat"),
        ["UserID", "Gender", "Age", "Occupation", "Zip-code"],
    )
    movies = _load_dat(
        os.path.join(datadir, "movies.dat"), ["MovieID", "Title", "Genres"]
    )
    ratings_path = os.path.join(datadir, "ratings.dat")
    if native.available():
        uid_i, mid_i, rating, ts = native.parse_ml1m_ratings(ratings_path)
        u_attr = np.empty((int(uid_i.max()) + 1, 4), dtype=object)
        for k, row in users.items():
            u_attr[int(k)] = (row["Gender"], int(row["Age"]),
                              int(row["Occupation"]), row["Zip-code"])
        m_attr = np.empty((int(mid_i.max()) + 1, 2), dtype=object)
        for k, row in movies.items():
            m_attr[int(k), 0] = row["Title"]
            m_attr[int(k), 1] = tuple(row["Genres"].split("|"))
        ua, ma = u_attr[uid_i], m_attr[mid_i]
        cols = {
            "UserID": np.char.mod("%d", uid_i).astype(object),
            "MovieID": np.char.mod("%d", mid_i).astype(object),
            "Rating": rating, "Timestamp": ts, "Gender": ua[:, 0],
            "Age": ua[:, 1].astype(np.int64),
            "Occupation": ua[:, 2].astype(np.int64), "Zip-code": ua[:, 3],
            "Title": ma[:, 0], "Genres": _objects(list(ma[:, 1])),
        }
    else:
        rows = {k: [] for k in CORPUS_COLUMNS}
        with open(ratings_path, "r", encoding="unicode_escape") as f:
            for line in f:
                u, m, r, t = line.strip().split("::")
                urow, mrow = users[u], movies[m]
                for k, v in (
                    ("UserID", u), ("MovieID", m), ("Rating", int(r)),
                    ("Timestamp", int(t)), ("Gender", urow["Gender"]),
                    ("Age", int(urow["Age"])),
                    ("Occupation", int(urow["Occupation"])),
                    ("Zip-code", urow["Zip-code"]), ("Title", mrow["Title"]),
                    ("Genres", tuple(mrow["Genres"].split("|"))),
                ):
                    rows[k].append(v)
        cols = {k: (np.asarray(v, dtype=np.int64) if k in _INT_COLUMNS
                    else _objects(v)) for k, v in rows.items()}
    perm = np.random.default_rng(seed).permutation(len(cols["UserID"]))
    return {k: v[perm] for k, v in cols.items()}


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


# The corpus schema: 10 columns per example (int64 Rating, Timestamp, Age
# and Occupation; string UserID, MovieID, Gender, Zip-code and Title; the
# variable-length Genres).
CORPUS_COLUMNS = (
    "UserID", "MovieID", "Rating", "Timestamp", "Gender", "Age",
    "Occupation", "Zip-code", "Title", "Genres",
)
_STR_COLUMNS = ("UserID", "MovieID", "Gender", "Zip-code", "Title")
_INT_COLUMNS = ("Rating", "Timestamp", "Age", "Occupation")


def serialize_corpus(raw: Dict[str, np.ndarray], path: str) -> str:
    """Write the joined corpus as one compressed .npz artifact, so ETL runs
    once. Strings are stored as fixed-width unicode arrays and Genres
    '|'-joined (movies.dat's own encoding), so the file holds no object
    arrays. The JAX package's ``read_corpus`` reads it, and this module's
    reads the JAX package's."""
    missing = [c for c in CORPUS_COLUMNS if c not in raw]
    if missing:
        raise ValueError(f"corpus missing columns {missing}")
    cols = {}
    for c in CORPUS_COLUMNS:
        if c == "Genres":
            cols[c] = np.asarray(["|".join(g) for g in raw[c]], dtype=np.str_)
        elif c in _STR_COLUMNS:
            cols[c] = np.asarray(raw[c]).astype(np.str_)
        else:
            cols[c] = np.asarray(raw[c], dtype=np.int64)
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **cols)
    return path


def read_corpus(path: str) -> Dict[str, np.ndarray]:
    """Load a :func:`serialize_corpus` artifact back into raw columns
    (strings as object arrays, Genres re-split into tuples)."""
    with np.load(path, allow_pickle=False) as f:
        out = {k: f[k] for k in f.files}
    out["Genres"] = _objects(
        [tuple(s.split("|")) if s else () for s in out["Genres"]])
    for c in _STR_COLUMNS:
        out[c] = out[c].astype(object)
    return out


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

    label = float(rating > 3); the ``train_size``/rest train/test split is
    taken once over the shuffled examples. The corpus is read from
    ``corpus_path`` (a :func:`serialize_corpus` artifact) when that file
    exists, else from ``datadir`` when it holds ratings.dat, else
    synthesized with ``movie_popularity`` (``"zipf-draw"``, the CTR corpus,
    or ``"rank-power"``, the retrieval corpus: see :func:`synthesize_ml1m`).

    With ``cache_dir`` the encoded arrays are written there on a first
    construction and read back on the next one with the same features,
    sizes, seed and sources (file ``torch_movielens_v1_<key>.npz``, read
    with ``allow_pickle=False``). The JAX package caches by default; the
    port caches only when asked.
    """

    batch_size: int = 1024
    train_size: float = 0.8
    datadir: Optional[str] = None
    corpus_path: Optional[str] = None
    num_ratings: int = NUM_RATINGS
    seed: int = 42
    movie_popularity: str = "zipf-draw"
    features: Tuple[Feature, ...] = dataclasses.field(
        default_factory=default_movielens_features
    )
    cache_dir: Optional[str] = None

    def _cache_path(self) -> Optional[str]:
        if not self.cache_dir:
            return None
        key = hashlib.md5(repr((
            self.features, self.num_ratings, self.seed, self.datadir,
            self.corpus_path, self.movie_popularity,
        )).encode()).hexdigest()[:12]
        return os.path.join(self.cache_dir, f"torch_movielens_v1_{key}.npz")

    def _build(self) -> None:
        if self.corpus_path and os.path.exists(self.corpus_path):
            raw = read_corpus(self.corpus_path)
        elif self.datadir and os.path.exists(
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
        self._raw_movie_id = np.asarray(raw["MovieID"]).astype(np.str_)

    def __post_init__(self):
        cache_path = self._cache_path()
        if cache_path and os.path.exists(cache_path):
            with np.load(cache_path, allow_pickle=False) as f:
                self._data = {k: f[k] for k in f.files
                              if k not in ("__label__", "__raw_movie_id__")}
                self._label = f["__label__"]
                self._raw_movie_id = f["__raw_movie_id__"]
        else:
            self._build()
            if cache_path:
                os.makedirs(self.cache_dir, exist_ok=True)
                tmp = f"{cache_path}.{os.getpid()}.tmp.npz"
                np.savez(tmp, __label__=self._label,
                         __raw_movie_id__=self._raw_movie_id, **self._data)
                os.replace(tmp, cache_path)
        self._n = len(self._label)
        self._n_train = int(self._n * self.train_size)

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
