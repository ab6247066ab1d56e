"""Cora citation graph for GCN: parser, renormalized adjacency, splits.

Counterpart of ``deep_recommenders_tpu/datasets/cora.py``, in numpy, with
the same draws, so every array is bit-identical to the JAX package's:

- parse ``cora/cora.content`` (node id, bag of words, class) and
  ``cora/cora.cites`` under ``path``, features row-normalized;
- a symmetric adjacency from the directed citations;
- the renormalization trick D^-1/2 (A + I) D^-1/2, returned dense;
- 20 train nodes per class, 500 validation nodes, the rest test, as
  one-hot labels and boolean masks.

Without the files under ``path`` a deterministic synthetic graph of the
same size stands in (class-assortative edges, class-correlated features).
``download_cora`` fetches the real corpus and extracts it through
``tarfile``'s ``data`` filter, which refuses members that leave the
destination; nothing else here fetches data.
"""

from __future__ import annotations

import os
import tarfile
from typing import Dict, Optional, Tuple

import numpy as np

from deep_recommenders_torch.datasets._download import fetch

CORA_CLASSES = (
    "Case_Based",
    "Genetic_Algorithms",
    "Neural_Networks",
    "Probabilistic_Methods",
    "Reinforcement_Learning",
    "Rule_Learning",
    "Theory",
)
NUM_CLASSES = len(CORA_CLASSES)

CORA_URL = "https://linqs-data.soe.ucsc.edu/public/lbc/cora.tgz"


def download_cora(
    dest_dir: str, url: str = CORA_URL, timeout: float = 60.0
) -> str:
    """Download and extract the real Cora corpus; return ``dest_dir``,
    which then holds ``cora/cora.content`` and ``cora/cora.cites`` (pass
    it as ``Cora(path=...)``).

    Skips both steps when ``cora/cora.content`` is already there, and the
    download when ``cora.tgz`` is. Raises ``OSError`` when the URL is
    unreachable (``Cora`` falls back to the synthetic graph), and
    ``tarfile.FilterError`` (a ``ValueError``) for a member that leaves
    ``dest_dir``.
    """
    content = os.path.join(dest_dir, "cora", "cora.content")
    if os.path.exists(content):
        return dest_dir
    os.makedirs(dest_dir, exist_ok=True)
    tgz_path = os.path.join(dest_dir, "cora.tgz")
    fetch(url, tgz_path, timeout)
    # The data filter refuses absolute paths, "..", links out of dest_dir
    # and device files.
    with tarfile.open(tgz_path, "r:gz") as tf:
        tf.extractall(dest_dir, filter="data")
    return dest_dir


def normalize_adjacency(adj: np.ndarray) -> np.ndarray:
    """Renormalization trick: D^-1/2 (A + I) D^-1/2 (ref cora.py:64-70)."""
    a = adj + np.eye(adj.shape[0], dtype=adj.dtype)
    d = np.power(a.sum(1), -0.5)
    return (a * d[None, :]) * d[:, None]


def _synthesize_cora(
    num_nodes: int, num_features: int, seed: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Class-assortative random graph with class-correlated BoW features."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, NUM_CLASSES, num_nodes)
    # Features: each class activates a preferred slice of the vocabulary.
    feats = (rng.random((num_nodes, num_features)) < 0.01).astype(np.float32)
    slice_w = num_features // NUM_CLASSES
    for c in range(NUM_CLASSES):
        rows = labels == c
        block = (
            rng.random((rows.sum(), slice_w)) < 0.08
        ).astype(np.float32)
        feats[rows, c * slice_w : (c + 1) * slice_w] += block
    feats = np.minimum(feats, 1.0)
    # Edges: mostly intra-class (assortative), ~4 per node.
    adj = np.zeros((num_nodes, num_nodes), dtype=np.float32)
    num_edges = num_nodes * 2
    src = rng.integers(0, num_nodes, num_edges)
    for s in src:
        if rng.random() < 0.9:
            same = np.flatnonzero(labels == labels[s])
            t = same[rng.integers(0, len(same))]
        else:
            t = rng.integers(0, num_nodes)
        if t != s:
            adj[s, t] = adj[t, s] = 1.0
    return feats, labels, adj


class Cora:
    """Cora dataset: features, dense normalized adjacency, one-hot splits."""

    def __init__(
        self,
        path: Optional[str] = None,
        seed: int = 42,
        synthetic_nodes: int = 2708,
        synthetic_features: int = 1433,
    ):
        self.num_classes = NUM_CLASSES
        content = os.path.join(path or "", "cora", "cora.content")
        cites = os.path.join(path or "", "cora", "cora.cites")
        if path is not None and os.path.exists(content):
            feats, labels, adj = self._load(content, cites)
        else:
            feats, labels, adj = _synthesize_cora(
                synthetic_nodes, synthetic_features, seed
            )
        row_sum = feats.sum(1, keepdims=True)
        self.features = feats / np.maximum(row_sum, 1e-12)
        self.labels = labels
        self.adjacency = adj
        self.spectral_adjacency = normalize_adjacency(adj)
        self._rng = np.random.default_rng(seed)

    @staticmethod
    def _load(content_path: str, cites_path: str):
        content = np.genfromtxt(content_path, dtype=str)
        ids = content[:, 0].astype(np.int64)
        feats = content[:, 1:-1].astype(np.float32)
        label_names = content[:, -1]
        labels = np.asarray(
            [CORA_CLASSES.index(l) for l in label_names], dtype=np.int64
        )
        idx_map = {j: i for i, j in enumerate(ids)}
        edges = np.genfromtxt(cites_path, dtype=np.int64)
        n = len(ids)
        adj = np.zeros((n, n), dtype=np.float32)
        for a, b in edges:
            i, j = idx_map[a], idx_map[b]
            adj[i, j] = adj[j, i] = 1.0
        return feats, labels, adj

    def splits(
        self, num_per_class: int = 20, num_valid: int = 500
    ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """(one_hot_labels, mask) per split (ref cora.py:72-116 semantics)."""
        n = len(self.labels)
        onehot = np.eye(self.num_classes, dtype=np.float32)[self.labels]
        train_idx = []
        for c in range(self.num_classes):
            pool = np.flatnonzero(self.labels == c)
            take = min(num_per_class, len(pool))
            train_idx += self._rng.choice(pool, take, replace=False).tolist()
        rest = sorted(set(range(n)) - set(train_idx))
        valid_idx, test_idx = rest[:num_valid], rest[num_valid:]

        def _split(idx):
            mask = np.zeros(n, dtype=bool)
            mask[idx] = True
            lab = np.where(mask[:, None], onehot, 0.0).astype(np.float32)
            return lab, mask

        return {
            "train": _split(train_idx),
            "valid": _split(valid_idx),
            "test": _split(test_idx),
        }
