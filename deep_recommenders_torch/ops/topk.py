"""Exact top-k retrieval primitives: scoring, the merge algebra, exclusions,
and the top-k of a corpus row-sharded over a mesh.

Counterpart of ``deep_recommenders_tpu/ops/topk.py``. Scoring is one
(B, D) x (D, N) matrix product (``torch.matmul``, fp32), and selection is
one ``torch.topk`` where JAX uses ``lax.top_k``. Merging
two per-row top-k states is concatenate-and-re-select; it is associative,
so the same step folds candidate chunks (``chunked_top_k``) and dataset
batches (``Streaming``).

Ties: ``lax.top_k`` returns the lower index first among equal scores;
``torch.topk`` promises no order among them (on the card least of all). The
selected scores are the same either way; only which of two equal-scoring
candidates comes first, or is kept at the k-th place, may differ.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from deep_recommenders_torch.parallel.sharding import (
    DATA_AXIS,
    MODEL_AXIS,
    all_gather,
    axis_index,
    axis_size,
)

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


def sharded_top_k(
    queries: torch.Tensor,
    candidate_shard: torch.Tensor,
    k: int,
    mesh,
    *,
    num_valid: Optional[int] = None,
    model_axis: str = MODEL_AXIS,
    data_axis: str = DATA_AXIS,
    queries_data_sharded: bool = False,
) -> Pair:
    """Exact top-k with the corpus row-sharded over the mesh's
    ``model_axis``: the merge algebra folded over shards.

    ``candidate_shard`` is this process's rows of the (N_padded, D) corpus
    (model coordinate m holds rows [m R, (m + 1) R), R = N_padded / n_model,
    as ``ShardedBruteForce.index`` cuts it); rows at or past ``num_valid``
    (default N_padded) score -inf. Each process scores its rows
    (``torch.matmul``, fp32) and takes its top min(k, R), with GLOBAL row
    ids; the partials are padded to k with (-inf, -1) and exchanged as
    (B, n_model k) buffers over the model group (``parallel.all_gather``),
    and one ``torch.topk`` picks the winners. Returns (scores, ids), each
    (B, k), on every process of the group; ids of -inf slots are -1.

    The exchange stays within this process's model group, whose processes
    share a data coordinate: replicated queries (the default) give every
    process the same result, and with ``queries_data_sharded`` each data
    group's processes pass and get their own rows of the batch. The flag
    is JAX's; in the port both cases run the same code.
    """
    del data_axis, queries_data_sharded  # the group is the model axis's
    n_model = axis_size(mesh, model_axis)
    rows = candidate_shard.shape[0]
    n_valid = rows * n_model if num_valid is None else num_valid
    k_local = min(k, rows)
    base = axis_index(mesh, model_axis) * rows
    scores = queries @ candidate_shard.T
    col = torch.arange(rows, device=scores.device) + base
    scores = torch.where(col < n_valid, scores, float("-inf"))
    s, local = exact_top_k(scores, k_local)
    i = torch.where(torch.isinf(s), -1, col[local])
    if k_local < k:
        b = s.shape[0]
        s = torch.cat([s, s.new_full((b, k - k_local), float("-inf"))], 1)
        i = torch.cat([i, i.new_full((b, k - k_local), -1)], 1)
    # (B, k) -> (n_model k, B) -> (B, n_model k): shard m's slots at m k.
    all_s = all_gather(s.T.contiguous(), mesh, model_axis).T
    all_i = all_gather(i.T.contiguous(), mesh, model_axis).T
    top, idx = torch.topk(all_s, k, dim=1)
    return top, all_i.gather(1, idx)
