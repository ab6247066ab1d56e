"""The port's attention ops (deep_recommenders_torch/ops/attention.py)
against the JAX package's, on the CPU.

On the CPU the flash wrappers take their plain versions; the JAX flash
kernels run in Pallas interpret mode, as the JAX package's own tests run
them. Inputs are made with numpy from a seed and fed to both sides.
Tolerances: both sides compute fp32 attention in different orders, dense
against blockwise with online rescaling; outputs and lse agree to 2e-5
(the JAX tests' own bound between its flash kernel and dense SDPA), the
gradients to atol 3e-5 and rtol 1e-4 (likewise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_recommenders_torch.ops import attention as att
from deep_recommenders_torch.ops import attention_tolerances as at
from deep_recommenders_tpu.ops import attention as jatt

torch.set_num_threads(1)


def _inputs(rng, bh, sq, sk, d, masked_row=None):
    q = rng.normal(size=(bh, sq, d)).astype(np.float32)
    k = rng.normal(size=(bh, sk, d)).astype(np.float32)
    v = rng.normal(size=(bh, sk, d)).astype(np.float32)
    mask = (rng.random((bh, sk)) < 0.8).astype(np.float32)
    if masked_row is not None:
        mask[masked_row] = 0.0  # a (bh) row with no valid key
    return q, k, v, mask


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_matches_jax(rng, causal):
    q, k, v, mask = _inputs(rng, 3, 10, 13, 8, masked_row=1)
    want = jatt.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        key_mask=jnp.asarray(mask), causal=causal)
    got = att.scaled_dot_product_attention(*_t(q, k, v), key_mask=_t(mask)[0],
                                           causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert not got[1].any()  # the fully masked row gives zeros


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_jax_interpret(rng, causal):
    q, k, v, mask = _inputs(rng, 4, 70, 90, 32, masked_row=2)
    want_out, want_lse = jatt.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        key_mask=jnp.asarray(mask), causal=causal, block_q=32, block_k=32,
        interpret=True, return_lse=True)
    before = dict(att.flash_attention.launches)
    out, lse = att.flash_attention(*_t(q, k, v), _t(mask)[0], causal,
                                   return_lse=True)
    assert att.flash_attention.launches == before  # plain on the CPU
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=2e-5)
    assert not out[2].any() and not lse[2].any()


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_grads_match_jax_interpret(rng, causal):
    q, k, v, mask = _inputs(rng, 2, 70, 90, 32, masked_row=1)
    g = rng.normal(size=q.shape).astype(np.float32)

    def loss(q_, k_, v_):
        out = jatt.flash_attention_diff(q_, k_, v_, jnp.asarray(mask), causal,
                                        True)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = [t.requires_grad_() for t in _t(q, k, v)]
    out = att.FlashAttention.apply(tq, tk, tv, _t(mask)[0], causal)
    out.backward(torch.from_numpy(g))
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5,
                                   rtol=1e-4, err_msg=f"d{name}")
    # The fully masked (bh) row: every gradient it touches is exactly 0.
    for grad in (tq.grad, tk.grad, tv.grad):
        assert not grad[1].any()


def test_dispatch_constants_are_jax_s():
    assert att.FLASH_SCORE_BYTES == jatt.FLASH_SCORE_BYTES
    assert att.DENSE_RESIDENT_SCORE_TENSORS == \
        jatt.DENSE_RESIDENT_SCORE_TENSORS
    assert att.NEG_INF == jatt.NEG_INF


@pytest.mark.parametrize("bh,s,device,dropout,want", [
    (2048, 512, "cuda", False, True),  # the slice: 6.44 GB of scores
    (2048, 512, "cpu", False, False),  # the CPU always goes dense
    (2048, 256, "cuda", False, False),  # 1.61 GB: dense
    (2048, 128, "cuda", False, False),
    (2048, 512, "cuda", True, False),  # dropout active: dense
    (256, 128, "cuda", False, False),  # the IMDB example
])
def test_dispatch_rule(bh, s, device, dropout, want):
    assert att.use_flash_for(bh, s, s, device, dropout) is want


def test_attention_dispatch_on_cpu_and_the_dropout_guard(rng):
    q, k, v, mask = _t(*_inputs(rng, 4, 9, 9, 8))
    before = dict(att.flash_attention.launches)
    got = att.attention(q, k, v, key_mask=mask, causal=True)
    torch.testing.assert_close(
        got, att.scaled_dot_product_attention(q, k, v, mask, True))
    forced = att.attention(q, k, v, key_mask=mask, causal=True,
                           use_flash=True)
    torch.testing.assert_close(forced, got, rtol=1e-5, atol=1e-6)
    assert att.flash_attention.launches == before
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="flash"):
        att.attention(q, k, v, use_flash=True, dropout_rate=0.5,
                      generator=gen)


def test_sdpa_weight_dropout_semantics(rng):
    """Inverted dropout hits the softmax weights, drawn from the generator:
    replaying its draw on the dense weights gives the same output."""
    q, k, v, _ = _t(*_inputs(rng, 2, 8, 8, 4))
    rate = 0.4
    got = att.scaled_dot_product_attention(
        q, k, v, dropout_rate=rate,
        generator=torch.Generator().manual_seed(7))
    w = torch.softmax(q @ k.transpose(1, 2) / 2.0, dim=-1)
    keep = torch.rand(w.shape, generator=torch.Generator().manual_seed(7)) \
        < 1.0 - rate
    want = torch.where(keep, w / (1.0 - rate), 0.0) @ v
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # Without a generator dropout is inactive, as JAX's without an rng.
    torch.testing.assert_close(
        att.scaled_dot_product_attention(q, k, v, dropout_rate=rate),
        att.scaled_dot_product_attention(q, k, v), rtol=0, atol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_tolerances_accept_fp32_plain_and_reject_planted_fault(rng, causal):
    """The card checks (ops/attention_tolerances.py) on the CPU, with the
    fp32 plain versions in the kernels' place: they accept them, and the
    dk check rejects dk less one 64-query tile."""
    q, k, v, mask = _t(*_inputs(rng, 4, 150, 130, 16, masked_row=3))
    out, lse = att.flash_attention(q, k, v, mask, causal, return_lse=True)
    fwd = at.check_forward((out, lse), q, k, v, mask, causal)
    assert fwd["out"]["err_over_tol"] < 1 and fwd["lse"]["err_over_tol"] < 1
    g = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))
    grads = att.flash_attention_backward(q, k, v, mask, out, lse, g, causal)
    checks = at.check_backward(grads, q, k, v, mask, out, lse, g, causal,
                               planted_rows=64)
    for name in ("dq", "dk", "dv"):
        assert checks[name]["fro_over_tol"] < 1
    assert checks["dk"]["planted"]["query_tile_dropped"] > 1
    with pytest.raises(AssertionError):
        at.check_backward((grads[0], grads[1] * 1.01, grads[2]), q, k, v,
                          mask, out, lse, g, causal)
