"""Approximate nearest-neighbour (MIPS) indexes: ApproxTopK and IVF.

Counterpart of ``deep_recommenders_tpu/models/retrieval/ann.py``:

- :class:`ApproxTopK`: exhaustive scoring, one (B, N) product, and top-k
  selection. JAX selects with ``lax.approx_max_k`` and a recall target;
  the port selects exactly with ``torch.topk`` (``ops/topk.exact_top_k``),
  which meets any recall target (recall 1). ``approx_max_k`` is exact on
  the CPU too, so the two agree wherever the JAX package is run off a TPU.
- :class:`IVF`: an inverted file, faiss IVFFlat's semantics. ``index``
  runs Lloyd's k-means (:func:`kmeans`) over the corpus on its device from
  ``nlist`` rows drawn with ``np.random.default_rng(seed)``, then buckets
  each candidate under its nearest centroid, on the host, into a padded
  (nlist, cap) table (cap the largest bucket). A query scores the
  centroids, probes the ``nprobe`` nearest buckets, gathers their
  candidates, (B, nprobe * cap, D), and takes the top k of the masked
  scores; with fewer probed candidates than k the result is padded with
  identifier -1 and score ``NEG_INF``.

Both take ``normalize=True`` (cosine scores: candidates and queries
L2-normalised) and integer or string identifiers: integer ones are
gathered on the device, strings on the host. ``config``, ``state_dict``
and ``load_state`` hold the JAX package's keys, so ``save_index`` and
``load_index`` read and write one file format with it both ways. The
indexes hold their arrays on a device, as the exact ones do
(``factorized_top_k.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from deep_recommenders_torch.device import DeviceLike
from deep_recommenders_torch.models.retrieval.factorized_top_k import TopK
from deep_recommenders_torch.ops.topk import exact_top_k

NEG_INF = -1e30


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp_min((x * x).sum(-1, keepdim=True),
                                          eps))


def kmeans(
    vectors: torch.Tensor,
    init_centroids: torch.Tensor,
    n_clusters: int,
    iters: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means on the vectors' device: (centroids, assignments).

    Two products an iteration: the assignment, argmin over clusters of
    |v|^2 - 2 (v . c - |c|^2 / 2), and the update, a one-hot matrix times
    the vectors over the counts. A cluster left empty keeps its centroid.
    """
    v2 = (vectors * vectors).sum(1)

    def assign(centroids):
        c2 = (centroids * centroids).sum(1)
        aff = vectors @ centroids.T - 0.5 * c2[None, :]
        return torch.argmin(v2[:, None] - 2.0 * aff, dim=1)

    centroids = init_centroids
    for _ in range(iters):
        one_hot = torch.nn.functional.one_hot(
            assign(centroids), n_clusters).to(vectors.dtype)
        sums = one_hot.T @ vectors
        counts = one_hot.sum(0)[:, None]
        centroids = torch.where(counts > 0, sums / counts.clamp_min(1.0),
                                centroids)
    return centroids, assign(centroids)


def _ivf_search(queries, centroids, candidates, buckets, bucket_mask,
                k: int, nprobe: int):
    """Probe the top ``nprobe`` centroids, gather their buckets, score and
    select: (scores, rows) (B, k), rows -1 where no candidate fills a
    place."""
    b = queries.shape[0]
    _, probe = exact_top_k(queries @ centroids.T, nprobe)  # (B, nprobe)
    rows = buckets[probe].reshape(b, -1)  # (B, nprobe * cap)
    mask = bucket_mask[probe].reshape(b, -1)
    safe_rows = rows.clamp_min(0)
    vecs = candidates[safe_rows]  # (B, P, D)
    scores = torch.einsum("bpd,bd->bp", vecs, queries)
    scores = torch.where(mask, scores, NEG_INF)
    kk = min(k, scores.shape[1])
    s, local = exact_top_k(scores, kk)
    i = safe_rows.gather(1, local).long()
    i = torch.where(s > NEG_INF / 2, i, -1)
    if kk < k:  # fewer probed candidates than k: pad
        s = torch.cat([s, s.new_full((b, k - kk), NEG_INF)], dim=1)
        i = torch.cat([i, i.new_full((b, k - kk), -1)], dim=1)
    return s, i


class _ApproximateIndex(TopK):
    """What the two indexes share: the candidates (normalised or not) and
    their identifiers on the device, the queries' preparation, the
    identifiers' mapping and their state."""

    def __init__(self, normalize: bool, query_model: Optional[Callable],
                 device: DeviceLike):
        super().__init__(query_model, device)
        self._normalize = normalize
        self._candidates = None
        self._identifiers = None  # host array of non-integer identifiers
        self._int_identifiers = None  # device tensor

    def _set_candidates(self, candidates) -> torch.Tensor:
        c = self._to_device(candidates).float()
        self._candidates = _l2_normalize(c) if self._normalize else c
        return self._candidates

    def _set_identifiers(self, identifiers) -> None:
        self._identifiers = self._int_identifiers = None
        if identifiers is None:
            return
        ids = identifiers if isinstance(identifiers, torch.Tensor) \
            else np.asarray(identifiers)
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

    def _prepared(self, queries) -> torch.Tensor:
        if self._candidates is None:
            raise ValueError("index() must be called before querying")
        q = self._queries(queries, self._candidates.device).float()
        return _l2_normalize(q) if self._normalize else q

    def _identified(self, scores, rows):
        """Rows -> identifiers; -1 (a padded place) stays -1 for integer
        identifiers, as JAX's IVF maps it."""
        if self._int_identifiers is not None:
            mapped = self._int_identifiers[rows.clamp_min(0)]
            return scores, torch.where(rows >= 0, mapped, -1)
        if self._identifiers is not None:
            return scores, np.take(self._identifiers,
                                   np.maximum(rows.cpu().numpy(), 0), axis=0)
        return scores, rows

    def _identifier_state(self) -> Dict[str, np.ndarray]:
        out = {}
        if self._int_identifiers is not None:
            out["int_identifiers"] = self._int_identifiers.cpu().numpy()
        if self._identifiers is not None:
            out["str_identifiers"] = np.asarray(
                self._identifiers).astype(np.str_)
        return out


class ApproxTopK(_ApproximateIndex):
    """Exhaustive scoring and top-k selection over the candidates on the
    device. ``recall_target`` is JAX's ``approx_max_k`` argument, kept for
    its configs and files; the port's selection is exact, recall 1."""

    def __init__(self, recall_target: float = 0.95, normalize: bool = False,
                 query_model: Optional[Callable] = None,
                 device: DeviceLike = "cuda"):
        super().__init__(normalize, query_model, device)
        self._recall = float(recall_target)

    def index(self, candidates, identifiers=None) -> "ApproxTopK":
        self._set_candidates(candidates)
        self._set_identifiers(identifiers)
        return self

    def __call__(self, queries, k: int = 10):
        q = self._prepared(queries)
        scores = q @ self._candidates.T
        s, i = exact_top_k(scores, min(k, scores.shape[-1]))
        return self._identified(s, i)

    def config(self) -> dict:
        return {"recall_target": self._recall, "normalize": self._normalize}

    def state_dict(self) -> Dict[str, np.ndarray]:
        if self._candidates is None:
            raise ValueError("index() must be called before saving")
        return {"candidates": self._candidates.cpu().numpy(),
                **self._identifier_state()}

    def load_state(self, state) -> "ApproxTopK":
        # index() normalises again, which leaves saved unit vectors as
        # they are.
        ids = state.get("int_identifiers", state.get("str_identifiers"))
        return self.index(state["candidates"], ids)


class IVF(_ApproximateIndex):
    """Inverted-file index (faiss IVFFlat semantics; the module docstring
    gives the algorithm). ``index`` raises ValueError on fewer candidates
    than ``nlist``, the constructor on ``nprobe`` above ``nlist``."""

    def __init__(self, nlist: int = 64, nprobe: int = 8,
                 normalize: bool = False, kmeans_iters: int = 10,
                 seed: int = 0, query_model: Optional[Callable] = None,
                 device: DeviceLike = "cuda"):
        if nprobe > nlist:
            raise ValueError(f"nprobe ({nprobe}) must be <= nlist ({nlist})")
        super().__init__(normalize, query_model, device)
        self._nlist = int(nlist)
        self._nprobe = int(nprobe)
        self._iters = int(kmeans_iters)
        self._seed = seed
        self._centroids = None
        self._buckets = None  # (nlist, cap) int32 rows of the corpus, -1 pad
        self._bucket_mask = None

    @property
    def cap(self) -> int:
        """The padded bucket width: the largest bucket's size."""
        return int(self._buckets.shape[1])

    def index(self, candidates, identifiers=None) -> "IVF":
        c = self._set_candidates(candidates)
        n = c.shape[0]
        if n < self._nlist:
            self._candidates = None
            raise ValueError(
                f"need at least nlist={self._nlist} candidates, got {n}")
        rng = np.random.default_rng(self._seed)
        first = torch.as_tensor(rng.choice(n, self._nlist, replace=False),
                                device=c.device)
        centroids, assign = kmeans(c, c[first], self._nlist, self._iters)
        # The buckets are assembled on the host (the index is built
        # offline; the search is the hot path).
        assign_np = assign.cpu().numpy()
        order = np.argsort(assign_np, kind="stable")
        counts = np.bincount(assign_np, minlength=self._nlist)
        buckets = np.full((self._nlist, max(int(counts.max()), 1)), -1,
                          np.int32)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        for cl in range(self._nlist):
            buckets[cl, :counts[cl]] = order[starts[cl]:starts[cl]
                                             + counts[cl]]
        self._set_quantizer(centroids, torch.as_tensor(buckets,
                                                       device=c.device))
        self._set_identifiers(identifiers)
        return self

    def _set_quantizer(self, centroids, buckets) -> None:
        self._centroids = centroids
        self._buckets = buckets
        self._bucket_mask = buckets >= 0

    def __call__(self, queries, k: int = 10):
        q = self._prepared(queries)
        s, i = _ivf_search(q, self._centroids, self._candidates,
                           self._buckets, self._bucket_mask, k, self._nprobe)
        return self._identified(s, i)

    def config(self) -> dict:
        return {
            "nlist": self._nlist,
            "nprobe": self._nprobe,
            "normalize": self._normalize,
            "kmeans_iters": self._iters,
            "seed": self._seed,
        }

    def state_dict(self) -> Dict[str, np.ndarray]:
        if self._candidates is None:
            raise ValueError("index() must be called before saving")
        return {
            "candidates": self._candidates.cpu().numpy(),
            "centroids": self._centroids.cpu().numpy(),
            "buckets": self._buckets.cpu().numpy(),
            **self._identifier_state(),
        }

    def load_state(self, state) -> "IVF":
        """Restore the trained quantizer as saved: no k-means run."""
        self._candidates = self._to_device(state["candidates"])
        device = self._candidates.device
        self._set_quantizer(
            torch.as_tensor(state["centroids"]).to(device),
            torch.as_tensor(state["buckets"]).to(device))
        ids = state.get("int_identifiers", state.get("str_identifiers"))
        self._set_identifiers(ids)
        return self
