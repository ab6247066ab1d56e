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
                                    dict(compute_dtype=torch.bfloat16)])
def test_mesh_and_bf16_not_ported(kwargs):
    with pytest.raises(NotImplementedError):
        t_engine.EmbeddingCollection(_specs(TFeature), 4, **kwargs)


def test_lookup_rejects_bad_arguments():
    table = torch.zeros(4, 2)
    with pytest.raises(ValueError):
        t_ek.lookup(table, torch.zeros(3, dtype=torch.int32), "fp8")
    with pytest.raises(TypeError):
        t_ek.lookup(table, torch.zeros(3, dtype=torch.int64))
