"""Factorized top-k retrieval: exact indexes and the FactorizedTopK metric.

Counterpart of ``deep_recommenders_tpu/models/retrieval/factorized_top_k.py``,
single-device part:

- ``TopK``: ``index(candidates[, identifiers])``, then ``index(queries, k)``
  -> (scores, identifiers); ``query_with_exclusions``; persistence through
  ``config``/``state_dict``/``load_state`` and :func:`save_index` /
  :func:`load_index`;
- ``BruteForce``: the candidates on the device, one product and top-k;
- ``Streaming``: top-k over a stream of candidate batches, folded with the
  merge algebra (``ops/topk.py``);
- ``InMemoryStreaming``: the candidates on the device, scored in chunks;
- ``FactorizedTopK``: the top-k categorical accuracy bank: the positive is
  in the top k when fewer than k candidates score above it.

The indexes hold their candidates (and integer identifiers) as tensors on a
device: the tensor's own when ``index`` is given a tensor, else the
constructor's ``device``, the card unless the caller asks for the CPU.
String identifiers stay a numpy array on the host. ``ShardedBruteForce``
(the corpus over a mesh) is not ported yet. :func:`load_index` also knows
the approximate indexes of ``ann.py`` (ApproxTopK, IVF).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from deep_recommenders_torch.device import DeviceLike, resolve_device
from deep_recommenders_torch.ops.topk import (
    chunked_top_k,
    exact_top_k,
    exclude as exclude_op,
    merge_top_k,
    top_k_scores,
)

# The classes save_index/load_index know, by name; filled by
# TopK.__init_subclass__.
_INDEX_REGISTRY: Dict[str, type] = {}


def _streaming_fold_step(best_s, best_i, queries, batch, ids, offset, k):
    """Fold one candidate batch into the running (B, k) top-k state: its
    scores, its top min(k, rows), their identifiers (``ids`` gathered, or
    the row number plus ``offset`` when ``ids`` is None), merged. JAX pads
    each batch to one width so that one compiled step serves the stream;
    PyTorch runs eagerly, so no batch is padded here."""
    scores = queries @ batch.T
    s, local_i = exact_top_k(scores, min(k, batch.shape[0]))
    i = local_i + offset if ids is None else ids[local_i]
    return merge_top_k(best_s, best_i, s, i, k)


class TopK:
    """A queryable top-k index over candidate embeddings.

    Subclasses give ``config()`` (JSON constructor arguments) and
    ``state_dict()``/``load_state()`` (numpy arrays) for
    :func:`save_index`/:func:`load_index`. ``query_model`` (a callable)
    maps raw queries to embeddings before scoring.
    """

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if not cls.__name__.startswith("_"):  # a shared base is no index
            _INDEX_REGISTRY[cls.__name__] = cls

    def __init__(self, query_model: Optional[Callable] = None,
                 device: DeviceLike = "cuda"):
        self._query_model = query_model
        self._device = device

    def _to_device(self, x) -> torch.Tensor:
        """A tensor stays where it is; an array goes to the index's
        device."""
        if isinstance(x, torch.Tensor):
            return x
        return torch.as_tensor(np.asarray(x)).to(resolve_device(self._device))

    def _queries(self, queries, device: torch.device) -> torch.Tensor:
        queries = torch.as_tensor(queries).to(device)
        if self._query_model is not None:
            queries = self._query_model(queries)
        return queries

    def index(self, candidates, identifiers=None) -> "TopK":
        raise NotImplementedError

    def __call__(self, queries, k: int = 10):
        raise NotImplementedError

    def query_with_exclusions(self, queries, exclusions, k: int = 10):
        """Retrieve k + E, then drop each row's excluded identifiers
        (``exclusions``, (B, E)) and keep the top k."""
        scores, identifiers = self(queries, k + exclusions.shape[1])
        return exclude_op(scores, identifiers,
                          torch.as_tensor(exclusions).to(scores.device), k)

    def config(self) -> dict:
        """JSON-serializable constructor arguments."""
        return {}

    def state_dict(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError(
            f"{type(self).__name__} does not support persistence")

    def load_state(self, state: Dict[str, np.ndarray]) -> "TopK":
        raise NotImplementedError(
            f"{type(self).__name__} does not support persistence")


def save_index(path: str, index: TopK) -> str:
    """Persist a built index under ``path``: ``config.json`` (its class and
    constructor arguments) and ``state.npz`` (its arrays; string identifiers
    as a unicode array, so nothing is pickled)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"class": type(index).__name__, "config": index.config()},
                  f)
    np.savez(os.path.join(path, "state.npz"), **index.state_dict())
    return path


def load_index(path: str, query_model: Optional[Callable] = None,
               device: DeviceLike = "cuda") -> TopK:
    """Rebuild a saved index, its arrays on ``device`` (the card unless the
    caller asks for the CPU), read with ``allow_pickle=False``.
    ``query_model`` is not saved: give it again here."""
    # ann.py registers its index classes on import.
    from deep_recommenders_torch.models.retrieval import ann  # noqa: F401

    path = os.path.abspath(path)
    with open(os.path.join(path, "config.json")) as f:
        spec = json.load(f)
    if spec["class"] not in _INDEX_REGISTRY:
        raise ValueError(f"unknown index class {spec['class']!r}; this port "
                         f"has {sorted(_INDEX_REGISTRY)}")
    idx = _INDEX_REGISTRY[spec["class"]](
        query_model=query_model, device=device, **spec["config"])
    with np.load(os.path.join(path, "state.npz"), allow_pickle=False) as data:
        return idx.load_state({k: data[k] for k in data.files})


class BruteForce(TopK):
    """Exact search over the candidates held on the device: one (B, N)
    product and its top-k. Identifiers default to row numbers; integer ones
    are gathered on the device, others (strings) on the host."""

    def __init__(self, query_model: Optional[Callable] = None,
                 device: DeviceLike = "cuda"):
        super().__init__(query_model, device)
        self._candidates = None
        self._identifiers = None  # host array of non-integer identifiers
        self._int_identifiers = None  # device tensor

    def index(self, candidates, identifiers=None) -> "BruteForce":
        self._candidates = self._to_device(candidates)
        self._identifiers = self._int_identifiers = None
        if identifiers is None:
            return self
        if isinstance(identifiers, torch.Tensor):
            ids = identifiers
        else:
            ids = np.asarray(identifiers)
        if ids.shape[0] != self._candidates.shape[0]:
            raise ValueError(
                "identifiers/candidates length mismatch: "
                f"{ids.shape[0]} vs {self._candidates.shape[0]}")
        if isinstance(ids, torch.Tensor) or np.issubdtype(ids.dtype,
                                                           np.integer):
            self._int_identifiers = torch.as_tensor(ids).to(
                self._candidates.device)
        else:
            self._identifiers = ids
        return self

    def __call__(self, queries, k: int = 10):
        if self._candidates is None:
            raise ValueError("index() must be called before querying")
        queries = self._queries(queries, self._candidates.device)
        scores, indices = top_k_scores(queries, self._candidates, k)
        if self._int_identifiers is not None:
            return scores, self._int_identifiers[indices]
        if self._identifiers is not None:
            return scores, np.take(self._identifiers, indices.cpu().numpy(),
                                   axis=0)
        return scores, indices

    def state_dict(self) -> Dict[str, np.ndarray]:
        if self._candidates is None:
            raise ValueError("index() must be called before saving")
        out = {"candidates": self._candidates.cpu().numpy()}
        if self._int_identifiers is not None:
            out["int_identifiers"] = self._int_identifiers.cpu().numpy()
        if self._identifiers is not None:
            out["str_identifiers"] = self._identifiers.astype(np.str_)
        return out

    def load_state(self, state) -> "BruteForce":
        ids = state.get("int_identifiers", state.get("str_identifiers"))
        return self.index(state["candidates"], ids)


class Streaming(TopK):
    """Exact top-k over a stream of candidate batches without holding the
    corpus: ``candidates()`` returns an iterable of batches, or of
    (identifiers, batch) pairs; without identifiers a running row count
    numbers the candidates. Each batch goes to the queries' device."""

    def __init__(self, candidates: Callable[[], Iterable],
                 query_model: Optional[Callable] = None,
                 device: DeviceLike = "cuda"):
        super().__init__(query_model, device)
        self._candidates = candidates

    def index(self, candidates, identifiers=None) -> "Streaming":
        del identifiers
        self._candidates = candidates
        return self

    def __call__(self, queries, k: int = 10):
        queries = self._to_device(queries)
        device = queries.device
        queries = self._queries(queries, device)
        b = queries.shape[0]
        best_s = torch.full((b, k), float("-inf"), device=device)
        best_i = torch.full((b, k), -1, dtype=torch.int64, device=device)
        offset = 0
        for item in self._candidates():
            ids = None
            if isinstance(item, tuple):
                ids, item = item
                ids = torch.as_tensor(ids).to(device)
            batch = torch.as_tensor(item).to(device)
            best_s, best_i = _streaming_fold_step(best_s, best_i, queries,
                                                  batch, ids, offset, k)
            offset += batch.shape[0]
        return best_s, best_i


class InMemoryStreaming(TopK):
    """The candidates held on the device, scored ``chunk_size`` rows at a
    time (``ops/topk.chunked_top_k``); identifiers are row numbers."""

    def __init__(self, chunk_size: int = 4096,
                 query_model: Optional[Callable] = None,
                 device: DeviceLike = "cuda"):
        super().__init__(query_model, device)
        self._chunk_size = chunk_size
        self._candidates = None

    def index(self, candidates, identifiers=None) -> "InMemoryStreaming":
        del identifiers
        self._candidates = self._to_device(candidates)
        return self

    def __call__(self, queries, k: int = 10):
        if self._candidates is None:
            raise ValueError("index() must be called before querying")
        queries = self._queries(queries, self._candidates.device)
        return chunked_top_k(queries, self._candidates, k, self._chunk_size)

    def config(self) -> dict:
        return {"chunk_size": self._chunk_size}

    def state_dict(self) -> Dict[str, np.ndarray]:
        if self._candidates is None:
            raise ValueError("index() must be called before saving")
        return {"candidates": self._candidates.cpu().numpy()}

    def load_state(self, state) -> "InMemoryStreaming":
        return self.index(state["candidates"])


class FactorizedTopK:
    """Top-k categorical accuracy over k in ``ks``, streamed over batches.

    A state is {"hits": (len(ks),), "count": ()} fp32 on a device.
    ``update_from_scores`` counts a hit at k where fewer than k candidates
    score above the positive by more than 1e-6 * (1 + |positive|): the true
    candidate's product score may differ from the positive's elementwise
    score by a rounding, and a tie counts for the positive. ``update``
    scores the queries against the index's top max(ks), the given
    ``candidates``, or the batch's own candidates.
    """

    def __init__(self, index: Optional[TopK] = None,
                 ks: Tuple[int, ...] = (1, 5, 10, 50, 100)):
        self.index = index
        self.ks = tuple(ks)

    def init(self, device: DeviceLike = "cpu"):
        return {"hits": torch.zeros(len(self.ks), device=device),
                "count": torch.zeros((), device=device)}

    def update_from_scores(self, state, positive_scores, candidate_scores):
        """positive_scores (B,); candidate_scores (B, N), the retrieved or
        all candidates' scores (the positive among them or not)."""
        eps = 1e-6 * (1.0 + positive_scores.abs()[:, None])
        above = (candidate_scores > positive_scores[:, None] + eps).sum(1)
        hits = torch.stack([(above < k).float().sum() for k in self.ks])
        return {"hits": state["hits"] + hits,
                "count": state["count"] + positive_scores.shape[0]}

    def update(self, state, query_embeddings, true_candidate_embeddings,
               candidates=None):
        q, c = query_embeddings, true_candidate_embeddings
        positive = (q * c).sum(-1)
        if self.index is not None:
            scores, _ = self.index(q, k=max(self.ks))
        elif candidates is not None:
            scores = q @ candidates.T
        else:
            scores = q @ c.T  # the batch's candidates
        return self.update_from_scores(state, positive, scores)

    @staticmethod
    def merge(a, b):
        return {k: a[k] + b[k] for k in a}

    def compute(self, state) -> Dict[str, torch.Tensor]:
        acc = state["hits"] / state["count"].clamp_min(1.0)
        return {f"top_{k}_categorical_accuracy": acc[i]
                for i, k in enumerate(self.ks)}
