"""Sparse-feature ingest: raw columns -> dense int32 id arrays, on the host.

Counterpart of ``deep_recommenders_tpu/features/columns.py``. Every
raw-value -> id transform runs once on the host when the dataset is built, so
the device only sees statically shaped int32 id tensors:

- single-valued feature  ->  ids  : (B,)    int32
- multi-valued bag       ->  ids  : (B, L) int32, padded
                             "<name>__wt" : (B, L) float32 pad mask/weights

Out-of-vocabulary values map to a bucket of their own at index len(vocab);
hash bucketing is CRC32(bytes) % buckets, computed with ``zlib`` (bit-identical
to the JAX package's native kernel, which is not ported).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

WEIGHT_SUFFIX = "__wt"


def crc32_hash_bucket(values: Sequence, num_buckets: int) -> np.ndarray:
    """Deterministic hash bucketing of arbitrary values (via str encoding)."""
    out = np.empty(len(values), dtype=np.int32)
    for i, v in enumerate(values):
        b = v if isinstance(v, bytes) else str(v).encode("utf-8")
        out[i] = zlib.crc32(b) % num_buckets
    return out


def vocab_lookup(values: Sequence, vocab: Sequence) -> np.ndarray:
    """Map values to vocab indices; OOV -> len(vocab)."""
    table = {v: i for i, v in enumerate(vocab)}
    oov = len(vocab)
    return np.asarray([table.get(v, oov) for v in values], dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class Feature:
    """A categorical feature spec (vocab-list or hash-bucket transform).

    max_len > 1 declares a multi-valued bag (e.g. movie genres), encoded as a
    fixed-width padded id tensor + weight tensor. ``combiner`` ("mean"/"sum")
    matches tf.feature_column embedding combiners.
    """

    name: str
    vocab: Optional[Tuple] = None
    hash_buckets: Optional[int] = None
    max_len: int = 1
    combiner: str = "mean"

    def __post_init__(self):
        if (self.vocab is None) == (self.hash_buckets is None):
            raise ValueError(
                f"Feature {self.name!r}: exactly one of vocab / hash_buckets "
                "must be set"
            )
        if self.combiner not in ("mean", "sum"):
            raise ValueError(f"Unknown combiner {self.combiner!r}")

    @property
    def cardinality(self) -> int:
        """Number of id buckets (vocab features reserve an OOV bucket)."""
        if self.vocab is not None:
            return len(self.vocab) + 1
        return int(self.hash_buckets)

    @property
    def is_multi(self) -> bool:
        return self.max_len > 1

    def _encode_values(self, values: Sequence) -> np.ndarray:
        if self.vocab is not None:
            return vocab_lookup(values, self.vocab)
        return crc32_hash_bucket(values, self.hash_buckets)

    def encode(self, values: Sequence) -> Dict[str, np.ndarray]:
        """Encode one column of raw values into the id-tensor dict entries.

        The transform runs once per unique value (or bag) and a vectorised
        take fans it back out to the rows.
        """
        if not self.is_multi:
            arr = np.asarray(values, dtype=object)
            uniques, inverse = np.unique(arr, return_inverse=True)
            encoded = self._encode_values(list(uniques))
            return {self.name: encoded[inverse].astype(np.int32)}
        index_of: Dict[tuple, int] = {}
        inverse = np.empty(len(values), dtype=np.int64)
        unique_bags = []
        for i, bag in enumerate(values):
            key = tuple(bag)
            slot = index_of.get(key)
            if slot is None:
                slot = len(unique_bags)
                index_of[key] = slot
                unique_bags.append(key)
            inverse[i] = slot
        ids_u = np.zeros((len(unique_bags), self.max_len), dtype=np.int32)
        wt_u = np.zeros((len(unique_bags), self.max_len), dtype=np.float32)
        for i, bag in enumerate(unique_bags):
            bag = list(bag)[: self.max_len]
            if not bag:
                continue
            row = self._encode_values(bag)
            ids_u[i, : len(row)] = row
            wt_u[i, : len(row)] = 1.0
        return {
            self.name: ids_u[inverse],
            self.name + WEIGHT_SUFFIX: wt_u[inverse],
        }


class FeatureEncoder:
    """Encodes a raw-column dict into the framework's id-tensor batch dict."""

    def __init__(self, features: Sequence[Feature]):
        self.features = list(features)
        names = [f.name for f in self.features]
        if len(set(names)) != len(names):
            raise ValueError("Duplicate feature names")

    def encode(self, raw: Mapping[str, Sequence]) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        for f in self.features:
            if f.name not in raw:
                raise KeyError(f"Missing raw column {f.name!r}")
            out.update(f.encode(raw[f.name]))
        return out
