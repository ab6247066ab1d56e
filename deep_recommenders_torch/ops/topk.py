"""Exact top-k retrieval primitives: scoring, the merge algebra, exclusions.

Counterpart of ``deep_recommenders_tpu/ops/topk.py``, single-device part.
Scoring is one (B, D) x (D, N) matrix product (``torch.matmul``, fp32),
and selection is one ``torch.topk`` where JAX uses ``lax.top_k``. Merging
two per-row top-k states is concatenate-and-re-select; it is associative,
so the same step folds candidate chunks (``chunked_top_k``) and dataset
batches (``Streaming``).

Ties: ``lax.top_k`` returns the lower index first among equal scores;
``torch.topk`` promises no order among them (on the card least of all). The
selected scores are the same either way; only which of two equal-scoring
candidates comes first, or is kept at the k-th place, may differ.
``sharded_top_k`` (the corpus over a mesh) is not ported yet: it is
``ROADMAP.md`` queue 1, item 2b.
"""

from __future__ import annotations

from typing import Tuple

import torch

Pair = Tuple[torch.Tensor, torch.Tensor]


def exact_top_k(scores: torch.Tensor, k: int) -> Pair:
    """Exact top-k (scores, indices) over the last axis of ``scores``: one
    ``torch.topk``. JAX selects from rows wider than 2048 in two levels
    (each 1024-column block's top-k, then the top-k of the winners)
    because XLA sorts the whole row; ``torch.topk`` selects by radix and
    beats those two levels on the card (``chip_smoke.py`` times both at
    the two-tower index's shape; PERF.md)."""
    return torch.topk(scores, k, dim=-1)


def top_k_scores(queries: torch.Tensor, candidates: torch.Tensor,
                 k: int) -> Pair:
    """(B, D) x (N, D) -> top-k (scores, candidate rows), each (B, k)."""
    return exact_top_k(queries @ candidates.T, k)


def merge_top_k(scores_a: torch.Tensor, ids_a: torch.Tensor,
                scores_b: torch.Tensor, ids_b: torch.Tensor, k: int) -> Pair:
    """Merge two per-row top-k states: the top k of both, with their ids."""
    top, idx = torch.topk(torch.cat([scores_a, scores_b], dim=1), k, dim=1)
    return top, torch.cat([ids_a, ids_b], dim=1).gather(1, idx)


def chunked_top_k(queries: torch.Tensor, candidates: torch.Tensor, k: int,
                  chunk_size: int = 4096) -> Pair:
    """Exact top-k over a corpus on the device, ``chunk_size`` candidate rows
    at a time: each chunk's scores and top-k, folded into the running state
    with :func:`merge_top_k` (JAX's ``lax.scan`` as a loop). k is capped at
    the corpus size; the state starts at (-inf, -1)."""
    n = candidates.shape[0]
    b = queries.shape[0]
    k = min(k, n)
    best_s = torch.full((b, k), float("-inf"), device=queries.device)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=queries.device)
    for lo in range(0, n, chunk_size):
        chunk = candidates[lo:lo + chunk_size]
        s, i = exact_top_k(queries @ chunk.T, min(k, chunk.shape[0]))
        best_s, best_i = merge_top_k(best_s, best_i, s, i + lo, k)
    return best_s, best_i


def exclude(scores: torch.Tensor, identifiers: torch.Tensor,
            exclusions: torch.Tensor, k: int) -> Pair:
    """Top-k of ``scores`` (B, N) without each row's ``exclusions`` (B, E):
    -1e5 added where a column's identifier (``identifiers``, (N,) or (B, N))
    is among the row's exclusions, then the top-k, with the identifiers of
    the kept columns."""
    idents = identifiers
    if idents.dim() == 1:
        idents = idents[None, :].expand(scores.shape[0], -1)
    isin = (idents[:, :, None] == exclusions[:, None, :]).any(dim=-1)
    top, idx = exact_top_k(scores + isin.to(scores.dtype) * -1e5, k)
    return top, idents.gather(1, idx)
