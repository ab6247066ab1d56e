"""Embedding engine and lookup of the PyTorch port against the JAX package.

On the CPU the JAX lookup's backward and ``factored_scatter_add`` take their
exact XLA scatter, and the port's take ``index_add_``: both sum in fp32, in
orders that may differ, so the tolerances below allow fp32 rounding of sums
of at most a few dozen terms of size ~1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_recommenders_torch.embedding import engine as t_engine
from deep_recommenders_torch.features.columns import Feature as TFeature
from deep_recommenders_torch.ops import embedding_kernels as t_ek
from deep_recommenders_tpu.embedding import engine as j_engine
from deep_recommenders_tpu.features.columns import Feature as JFeature
from deep_recommenders_tpu.ops import embedding_kernels as j_ek

torch.set_num_threads(1)

# Small, big single-valued and big multi-valued features (mean and sum).
_SPEC_ARGS = [
    dict(name="gender", vocab=("F", "M")),
    dict(name="genres", vocab=tuple(range(5)), max_len=3, combiner="mean"),
    dict(name="user", hash_buckets=300),
    dict(name="movie", hash_buckets=400),
    dict(name="tags", hash_buckets=500, max_len=4, combiner="mean"),
    dict(name="words", hash_buckets=260, max_len=3, combiner="sum"),
]
B = 32


def _specs(cls):
    return tuple(cls(**kw) for kw in _SPEC_ARGS)


def _batch(rng):
    batch = {}
    for kw in _SPEC_ARGS:
        card = len(kw["vocab"]) + 1 if "vocab" in kw else kw["hash_buckets"]
        l = kw.get("max_len", 1)
        shape = (B,) if l == 1 else (B, l)
        batch[kw["name"]] = rng.integers(0, card, shape).astype(np.int32)
        if l > 1:
            wt = (rng.random((B, l)) < 0.6).astype(np.float32)
            wt[:3] = 0.0  # empty bags: the mean divisor clamps at 1
            batch[kw["name"] + "__wt"] = wt
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_fused_rows_forward_and_table_grad(rng):
    specs_t, specs_j = _specs(TFeature), _specs(JFeature)
    offs, total = t_engine._offsets(specs_t)
    assert (offs, total) == j_engine._offsets(specs_j)
    batch = _batch(rng)
    table = rng.normal(0, 1, (total, 5)).astype(np.float32)
    w = rng.normal(0, 1, (B, len(specs_t), 5)).astype(np.float32)

    def j_loss(tab):
        rows, denom = j_engine.fused_rows(tab, specs_j, offs, _jax(batch))
        return jnp.sum(rows * w / denom), (rows, denom)

    (_, (j_rows, j_denom)), j_grad = jax.value_and_grad(
        j_loss, has_aux=True
    )(jnp.asarray(table))

    t_table = torch.tensor(table, requires_grad=True)
    rows, denom = t_engine.fused_rows(t_table, specs_t, offs, _torch(batch))
    (rows * torch.from_numpy(w) / denom).sum().backward()

    # Forward: each row is a sum of at most 4 table rows; 1e-6 is fp32
    # rounding of such sums.
    np.testing.assert_allclose(rows.detach().numpy(), np.asarray(j_rows),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(denom.numpy(), np.asarray(j_denom))
    # Gradient: per-row sums over the 32 examples' updates.
    np.testing.assert_allclose(t_table.grad.numpy(), np.asarray(j_grad),
                               rtol=1e-5, atol=1e-5)


def test_lookup_table_gradient_matches_jax_grad(rng):
    table = rng.normal(0, 1, (50, 7)).astype(np.float32)
    ids = rng.integers(0, 50, (64, 3)).astype(np.int32)  # colliding ids
    w = rng.normal(0, 1, (64, 3, 7)).astype(np.float32)
    j_grad = jax.grad(
        lambda t: jnp.sum(j_ek.lookup(t, jnp.asarray(ids)) * w)
    )(jnp.asarray(table))
    t_table = torch.tensor(table, requires_grad=True)
    out = t_ek.lookup(t_table, torch.from_numpy(ids))
    np.testing.assert_array_equal(
        out.detach().numpy(), np.asarray(jnp.take(table, ids, axis=0))
    )
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(t_table.grad.numpy(), np.asarray(j_grad),
                               atol=1e-6)


@pytest.mark.parametrize("skewed", [False, True])
def test_scatter_add_rows_reference_matches_factored_scatter_add(
    rng, skewed
):
    n, c, v = 2048, 17, 1000
    g = rng.normal(0, 1, (n, c)).astype(np.float32)
    ids = rng.integers(0, v, n).astype(np.int32)
    if skewed:  # 90% of the ids on 16 hot rows
        hot = rng.random(n) < 0.9
        ids[hot] = rng.integers(0, 16, hot.sum())
    want = np.asarray(j_ek.factored_scatter_add(
        jnp.asarray(g), jnp.asarray(ids), v
    ))
    got = t_ek.scatter_add_rows_reference(
        torch.from_numpy(g), torch.from_numpy(ids), v
    )
    # A hot row sums ~115 updates of size ~1 in another order.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    # On a CPU tensor the wrapper is the plain version.
    np.testing.assert_array_equal(
        t_ek.scatter_add_rows(torch.from_numpy(g), torch.from_numpy(ids),
                              v).numpy(),
        got.numpy(),
    )


def test_modules_match_flax(rng):
    specs_t, specs_j = _specs(TFeature), _specs(JFeature)
    batch = _batch(rng)
    _, total = t_engine._offsets(specs_t)
    table = rng.normal(0, 1, (total, 6)).astype(np.float32)
    weights = rng.normal(0, 1, (total, 1)).astype(np.float32)
    bias = np.asarray([0.25], np.float32)

    emb = t_engine.EmbeddingCollection(specs_t, 6)
    emb.load_state_dict({"table": torch.from_numpy(table)})
    lin = t_engine.LinearTerms(specs_t)
    lin.load_state_dict({"weights": torch.from_numpy(weights),
                         "bias": torch.from_numpy(bias)})
    j_emb = j_engine.EmbeddingCollection(specs_j, 6)
    j_lin = j_engine.LinearTerms(specs_j)
    with torch.no_grad():
        got_emb = emb(_torch(batch)).numpy()
        got_lin = lin(_torch(batch)).numpy()
        got_per = lin.per_feature(_torch(batch)).numpy()
    want_emb = j_emb.apply({"params": {"table": table}}, _jax(batch))
    lin_params = {"params": {"weights": weights, "bias": bias}}
    want_lin = j_lin.apply(lin_params, _jax(batch))
    want_per = j_lin.apply(lin_params, _jax(batch),
                           method=j_engine.LinearTerms.per_feature)
    np.testing.assert_allclose(got_emb, np.asarray(want_emb),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_lin, np.asarray(want_lin),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_per, np.asarray(want_per),
                               rtol=1e-6, atol=1e-6)
    assert emb.table.shape == (total, 6)
    # Initialisation as flax's: normal(0, 1/sqrt(D)) table, zero linear.
    fresh = t_engine.EmbeddingCollection(
        specs_t, 16, generator=torch.Generator().manual_seed(0)
    )
    assert abs(fresh.table.std().item() - 0.25) < 0.01
    assert not t_engine.LinearTerms(specs_t).weights.any()


@pytest.mark.parametrize("kwargs", [dict(mesh=object()),
                                    dict(compute_dtype=torch.float16)])
def test_mesh_and_bf16_not_ported(kwargs):
    """``mesh`` takes a ("data", "model") DeviceMesh
    (tests/test_torch_parallel.py) and refuses anything else with
    TypeError; bf16 is ported (tests/test_torch_ranking_bf16.py), and any
    compute dtype but fp32 and bf16 raises."""
    error = TypeError if "mesh" in kwargs else ValueError
    with pytest.raises(error):
        t_engine.EmbeddingCollection(_specs(TFeature), 4, **kwargs)


def test_lookup_rejects_bad_arguments():
    table = torch.zeros(4, 2)
    with pytest.raises(ValueError):
        t_ek.lookup(table, torch.zeros(3, dtype=torch.int32), "fp8")
    with pytest.raises(TypeError):
        t_ek.lookup(table, torch.zeros(3, dtype=torch.int64))


def _in_order_loop(g, ids, v):
    """zeros((v, C)).at[ids].add(g) by a numpy loop over the ids in index
    order: ids in [-v, 0) wrap to v + id, other out-of-range ids drop."""
    out = np.zeros((v, g.shape[1]), np.float32)
    for i, idx in enumerate(ids.tolist()):
        row = idx + v if idx < 0 else idx
        if 0 <= row < v:
            out[row] = out[row] + g[i]  # one fp32 add per column
    return out


@pytest.mark.parametrize("skewed", [False, True])
def test_scatter_add_rows_reference_is_the_in_order_sum(rng, skewed):
    """The plain version sums each row's updates in index order from +0.0,
    bit for bit: the card's kernel's order within one segment. Tolerance:
    none (the int32 views are equal)."""
    n, c, v = 2048, 17, 1000
    g = rng.normal(0, 1, (n, c)).astype(np.float32)
    ids = rng.integers(0, v, n).astype(np.int32)
    if skewed:  # 90% of the ids on 16 hot rows
        hot = rng.random(n) < 0.9
        ids[hot] = rng.integers(0, 16, hot.sum())
    got = t_ek.scatter_add_rows_reference(torch.from_numpy(g),
                                          torch.from_numpy(ids), v).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  _in_order_loop(g, ids, v).view(np.int32))


def test_scatter_add_rows_out_of_range_ids_as_jax(rng):
    """Ids in [-V, 0) add into row V + id and every other id outside
    [0, V) is dropped, as JAX's zeros((V, C)).at[ids].add(g) on the CPU:
    the plain version, the CPU wrapper and the kernel's order (one segment
    here) against it (each row sums at most a few updates of size ~1 in
    fp32: atol 1e-6), and bit for bit against the in-order loop."""
    n, c, v = 512, 5, 40
    g = rng.normal(0, 1, (n, c)).astype(np.float32)
    ids = rng.integers(-2 * v, 2 * v, n).astype(np.int32)
    ids[:4] = [-v, -1, v, -v - 1]  # the edges of the wrapped range
    want = np.asarray(jnp.zeros((v, c), jnp.float32).at[
        jnp.asarray(ids)].add(jnp.asarray(g)))
    tg, tids = torch.from_numpy(g), torch.from_numpy(ids)
    for got in (t_ek.scatter_add_rows_reference(tg, tids, v),
                t_ek.scatter_add_rows(tg, tids, v),
                t_ek.scatter_add_rows_in_segments(tg, tids, v)):
        assert got.shape == (v, c) and got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(
            got.numpy().view(np.int32),
            _in_order_loop(g, ids, v).view(np.int32))


def _segment_order_loop(g, ids, v, segment):
    """The kernel's order by a numpy loop: within each segment of `segment`
    positions a row's updates added in index order from +0.0, then each
    row's segment sums added in segment order from +0.0."""
    out = np.zeros((v, g.shape[1]), np.float32)
    for s0 in range(0, len(ids), segment):
        parts = {}
        for i in range(s0, min(s0 + segment, len(ids))):
            row = int(ids[i]) + v if ids[i] < 0 else int(ids[i])
            if 0 <= row < v:
                parts[row] = parts.get(row, np.zeros(g.shape[1],
                                                     np.float32)) + g[i]
        for row, part in parts.items():
            out[row] = out[row] + part
    return out


@pytest.mark.parametrize("segment", [64, 2048])
@pytest.mark.parametrize("skewed", [False, True])
def test_scatter_add_rows_in_segments_is_the_segment_order(rng, skewed,
                                                           segment):
    """The kernel's order model equals a numpy loop in that order bit for
    bit, with ids out of range among them, at many segments (64) and at
    the segment length of C = 17 (2048). Tolerance: none (the int32 views
    are equal)."""
    n, c, v = 3000, 17, 500
    g = rng.normal(0, 1, (n, c)).astype(np.float32)
    ids = rng.integers(-v - 20, v + 20, n).astype(np.int32)
    if skewed:  # a quarter of the ids on one row, as a train batch's movie
        ids[rng.random(n) < 0.25] = 7
    got = t_ek.scatter_add_rows_in_segments(
        torch.from_numpy(g), torch.from_numpy(ids), v, segment).numpy()
    np.testing.assert_array_equal(
        got.view(np.int32), _segment_order_loop(g, ids, v, segment)
        .view(np.int32))


def test_scatter_add_rows_in_segments_within_one_segment_is_the_plain_sum(
        rng):
    """With every id in one segment the kernel's order is the plain
    version's in-order sum, bit for bit; over several segments a hot row
    differs from it by rounding only (fp32 sums of 16384 terms of size ~1:
    atol 1e-3)."""
    c, v = 17, 100
    assert t_ek.segment_length(c) == 2048
    g = torch.from_numpy(rng.normal(0, 1, (16384, c)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 8, 16384).astype(np.int32))
    one = t_ek.scatter_add_rows_in_segments(g[:2048], ids[:2048], v)
    assert torch.equal(one.view(torch.int32), t_ek.scatter_add_rows_reference(
        g[:2048], ids[:2048], v).view(torch.int32))
    many = t_ek.scatter_add_rows_in_segments(g, ids, v)
    torch.testing.assert_close(many, t_ek.scatter_add_rows_reference(
        g, ids, v), rtol=0, atol=1e-3)


def test_segment_length_fits_the_kernel_stage():
    """The segment is the largest power of two up to 2048 whose rows of g
    fit the kernel's stage of 2048 x 17 floats; wider rows are refused."""
    assert [t_ek.segment_length(c) for c in (1, 17, 18, 32, 8192)] == [
        2048, 2048, 1024, 1024, 4]
    with pytest.raises(ValueError):
        t_ek.segment_length(8193)


@pytest.mark.parametrize("n,c,v,large", [
    (16384, 17, 10044, False),      # DeepFM's batch into its table
    (16384, 17, 131072, False),     # one round: the crossover's near side
    (16384, 17, 262144, True),      # ... and its far side
    (16385, 17, 131072, True),      # two rounds
    (131072, 17, 16384, False),     # eight rounds
    (131072, 17, 32768, True),
    (0, 17, 4_000_000, False),      # no ids: no round
    (4096, 32, 1_000_000, True),    # the two-tower's width: segments of 1024
])
def test_large_table_plan_routes_by_rows_and_rounds(n, c, v, large):
    """The bf16 K1 takes its large-table plan where the table's rows times
    the cluster plan's rounds (CLUSTER segments of segment_length(C) ids)
    reach LARGE_TABLE_ROW_ROUNDS, the crossover measured on the card."""
    assert t_ek.large_table_plan(n, c, v) == large
    rounds = -(-n // (t_ek.CLUSTER * t_ek.segment_length(c)))
    assert large == (v * rounds >= t_ek.LARGE_TABLE_ROW_ROUNDS)


def _by_row_ranges(g, ids, num_rows):
    """K1's order model (``scatter_add_rows_in_segments``) as the bf16
    K1's large-table plan (csrc/scatter_add_rows.cu) computes it: each
    segment's ids grouped by row in position order (a stable sort) and
    each run summed in index order from +0.0, the runs kept sorted by row;
    then each row's segment sums (which the kernel finds through a table
    of each segment's first run a range of rows) added in segment order
    onto +0.0."""
    n, c = g.shape
    segment = t_ek.segment_length(c)
    out = torch.zeros((num_rows, c), dtype=g.dtype, device=g.device)
    rows_all = t_ek._rows(ids, num_rows)
    for s0 in range(0, n, segment):
        rows = rows_all[s0:s0 + segment]
        order = torch.sort(rows, stable=True).indices
        run_rows, slot = torch.unique_consecutive(rows[order],
                                                  return_inverse=True)
        sums = torch.zeros((run_rows.shape[0], c), dtype=g.dtype,
                           device=g.device)
        sums.index_add_(0, slot, g[s0:s0 + segment][order])
        kept = run_rows < num_rows
        out[run_rows[kept]] += sums[kept]
    return out


@pytest.mark.parametrize("n,c", [(16384, 17), (131072, 17), (5001, 40)])
def test_row_range_order_is_the_segment_order(rng, n, c):
    """The large-table plan's order (each segment's runs by row, summed in
    index order; each row's segment sums merged in segment order) equals
    K1's order model bit for bit on bf16-valued g into 10^6 rows, with
    ids repeated across segments (a hot row in every segment, rows shared
    by a few), ids in [-V, 0) and ids dropped; and a merge that takes a
    row's segment sums out of segment order does not."""
    v = 1_000_000
    ids = rng.integers(0, v, n).astype(np.int32)
    ids[rng.random(n) < 0.2] = 123_457                      # every segment
    ids[rng.random(n) < 0.2] = rng.integers(0, 50, n)[:1]   # a few rows
    ids[rng.random(n) < 0.02] = -5                          # row V - 5
    ids[rng.random(n) < 0.02] = v + 3                       # dropped
    g = torch.from_numpy(rng.normal(0, 1, (n, c)).astype(np.float32))
    g = g.to(torch.bfloat16).float()
    ids = torch.from_numpy(ids)
    want = t_ek.scatter_add_rows_in_segments(g, ids, v)
    got = _by_row_ranges(g, ids, v)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # The same segments merged last to first: another fp32 sum.
    segment = t_ek.segment_length(c)
    if n > 2 * segment:
        order = torch.cat([torch.arange(s, min(s + segment, n)) for s in
                           reversed(range(0, n, segment))])
        backwards = _by_row_ranges(g[order], ids[order], v)
        assert not torch.equal(backwards.view(torch.int32),
                               want.view(torch.int32))
