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

import itertools
import os
import subprocess
import sys
import warnings

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


# -- fp32 operands on the card: 3xTF32 products ------------------------------

def test_round_tf32_rounds_to_nearest_ties_away(rng):
    """round_tf32 is cvt.rna.tf32.f32: 10 explicit mantissa bits, nearest,
    ties away from zero; the 3xTF32 split leaves at most 2^-22 of x."""
    x = torch.from_numpy(rng.normal(size=4096).astype(np.float32))
    hi = at.round_tf32(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert ((x - hi).abs() <= 2.0**-11 * x.abs()).all()
    lo = at.round_tf32(x - hi)
    assert ((x.double() - hi.double() - lo.double()).abs()
            <= 2.0**-22 * x.double().abs()).all()
    ties = torch.tensor([1 + 2**-11, -(1 + 2**-11), 1 + 2**-11 - 2**-23,
                         3 * 2**-11], dtype=torch.float32)
    want = torch.tensor([1 + 2**-10, -(1 + 2**-10), 1.0, 3 * 2**-11])
    assert torch.equal(at.round_tf32(ties), want)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_3xtf32_emulation_matches_jax_interpret(rng, causal):
    """The 3xTF32 emulation of K5 (the fp32 kernels' products) against
    JAX's Pallas kernel in interpret mode on fp32 inputs: the split puts
    each product within 13 u of its value, so the fp32 tests' 2e-5
    holds."""
    q, k, v, mask = _inputs(rng, 4, 70, 90, 32, masked_row=2)
    want_out, want_lse = jatt.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        key_mask=jnp.asarray(mask), causal=causal, block_q=32, block_k=32,
        interpret=True, return_lse=True)
    out, lse = at.flash_attention_tf32(*_t(q, k, v, mask), causal, passes=3)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_tolerances_accept_3xtf32_and_reject_1xtf32_forward(rng, causal):
    """The fp32 forward check (ops/attention_tolerances.py) accepts the
    3xTF32 emulation and rejects single-pass TF32 products at least
    TF32_REJECT_FACTOR times over its limit."""
    q, k, v, mask = _t(*_inputs(rng, 4, 150, 130, 16, masked_row=3))
    got = at.flash_attention_tf32(q, k, v, mask, causal, passes=3)
    fwd = at.check_forward(got, q, k, v, mask, causal, planted_tf32=True)
    assert fwd["out"]["err_over_tol"] < 1 and fwd["out"]["fro_over_tol"] < 1
    assert fwd["lse"]["err_over_tol"] < 1
    assert fwd["planted"]["single_pass_tf32"] >= at.TF32_REJECT_FACTOR
    with pytest.raises(AssertionError):
        at.check_forward(at.flash_attention_tf32(q, k, v, mask, causal,
                                                 passes=1),
                         q, k, v, mask, causal)


@pytest.mark.parametrize("causal", [False, True])
def test_tolerances_accept_3xtf32_and_reject_1xtf32_backward(rng, causal):
    """The fp32 backward check accepts the 3xTF32 emulation of K6 and
    rejects single-pass TF32 products at least TF32_REJECT_FACTOR times
    over its limit."""
    q, k, v, mask = _t(*_inputs(rng, 4, 150, 130, 16, masked_row=3))
    g = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))
    out, lse = at.flash_attention_tf32(q, k, v, mask, causal, passes=3)
    grads = at.flash_attention_backward_tf32(q, k, v, mask, out, lse, g,
                                             causal, passes=3)
    checks = at.check_backward(grads, q, k, v, mask, out, lse, g, causal,
                               planted_rows=64, planted_tf32=True)
    for name in ("dq", "dk", "dv"):
        assert checks[name]["err_over_tol"] < 1
        assert checks[name]["fro_over_tol"] < 1
    assert checks["planted"]["single_pass_tf32"] >= at.TF32_REJECT_FACTOR
    assert checks["dk"]["planted"]["query_tile_dropped"] > 1
    with pytest.raises(AssertionError):
        at.check_backward(at.flash_attention_backward_tf32(
            q, k, v, mask, out, lse, g, causal, passes=1),
            q, k, v, mask, out, lse, g, causal)


# -- bf16 operands: the JAX kernels' bf16 contract ---------------------------

def _bf16_pair(*arrays):
    """Each array rounded to bf16, for JAX and for torch."""
    return ([jnp.asarray(a).astype(jnp.bfloat16) for a in arrays],
            [torch.from_numpy(a).to(torch.bfloat16) for a in arrays])


def _f32(x):
    return np.array(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_bf16_rounds_as_jax(rng, causal):
    """bf16 q, k, v: fp32 scores and softmax, the weights rounded to bf16
    before the product with v (fp32 accumulation), the output in bf16, as
    JAX's. Both sides sum the same exact fp32 products of bf16 values, so
    the outputs agree to within one bf16 ulp (2^-7 relative) and nearly
    all bitwise; the unrounded weights the port used before differ from
    JAX in about a quarter of the elements."""
    q, k, v, mask = _inputs(rng, 3, 10, 13, 8, masked_row=1)
    (jq, jk, jv), (tq, tk, tv) = _bf16_pair(q, k, v)
    want = jatt.scaled_dot_product_attention(
        jq, jk, jv, key_mask=jnp.asarray(mask), causal=causal)
    got = att.scaled_dot_product_attention(tq, tk, tv,
                                           key_mask=_t(mask)[0],
                                           causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2**-7, atol=0)
    assert (_f32(got) != _f32(want)).mean() <= 0.02
    assert not got[1].any()


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_bf16_matches_jax_interpret(rng, causal):
    """The bf16 plain K5 against JAX's Pallas kernel in interpret mode on
    bf16 inputs (32-key tiles). Both round p to bf16 (2^-8 relative), JAX
    against the running max of its tiles and the port against the row's
    max, so a term may round to the other neighbour, and each rounds its
    output once: |out - want| <= 2^-7 (sum_k w |v| + |out|), below
    2^-7 (max|v| + |out|). lse is fp32 on both sides: 2e-5, as fp32."""
    q, k, v, mask = _inputs(rng, 4, 70, 90, 32, masked_row=2)
    (jq, jk, jv), (tq, tk, tv) = _bf16_pair(q, k, v)
    want_out, want_lse = jatt.flash_attention(
        jq, jk, jv, key_mask=jnp.asarray(mask), causal=causal, block_q=32,
        block_k=32, interpret=True, return_lse=True)
    before = dict(att.flash_attention.launches)
    out, lse = att.flash_attention(tq, tk, tv, _t(mask)[0], causal,
                                   return_lse=True)
    assert att.flash_attention.launches == before  # plain on the CPU
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    vmax = float(np.abs(_f32(tv)).max())
    np.testing.assert_allclose(_f32(out), _f32(want_out), rtol=2**-7,
                               atol=2**-7 * vmax)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=2e-5)
    assert not out[2].any() and not lse[2].any()


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_bf16_grads_match_jax_interpret(rng, causal):
    """The bf16 plain K6, through FlashAttention's backward, against JAX's
    Pallas backward in interpret mode on the same bf16 q, k, v, g and JAX's
    own out and lse. p and ds are rebuilt in fp32 on both sides in other
    orders and rounded to bf16 (a term may round to the other neighbour),
    and each gradient is rounded once: within 2^-7 of its largest element
    and 2^-7 relative."""
    q, k, v, mask = _inputs(rng, 2, 70, 90, 32, masked_row=1)
    g = rng.normal(size=q.shape).astype(np.float32)
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _bf16_pair(q, k, v, g)
    jmask = jnp.asarray(mask)
    out, lse = jatt.flash_attention(jq, jk, jv, key_mask=jmask,
                                    causal=causal, interpret=True,
                                    return_lse=True)
    want = jatt._flash_backward_impl(jq, jk, jv, jmask, out, lse, jg,
                                     causal=causal, interpret=True)
    tout = torch.from_numpy(_f32(out)).to(torch.bfloat16)
    tlse = torch.from_numpy(np.array(lse))
    got = att.flash_attention_backward(tq, tk, tv, _t(mask)[0], tout, tlse,
                                       tg, causal)
    for name, grad, ref in zip("qkv", got, want):
        assert grad.dtype == torch.bfloat16
        ref = _f32(ref)
        np.testing.assert_allclose(_f32(grad), ref, rtol=2**-7,
                                   atol=2**-7 * np.abs(ref).max(),
                                   err_msg=f"d{name}")
        assert not grad[1].any()
    # The autograd Function takes bf16 and gives bf16 gradients.
    args = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    att.FlashAttention.apply(*args, _t(mask)[0], causal).backward(tg)
    assert all(a.grad.dtype == torch.bfloat16 for a in args)


def test_flash_attention_rejects_other_dtypes_on_the_cpu(rng):
    q, k, v, mask = _t(*_inputs(rng, 2, 8, 8, 16))
    with pytest.raises(TypeError):
        att.flash_attention(q.half(), k.half(), v.half(), mask)
    with pytest.raises(TypeError):
        att.flash_attention(q.bfloat16(), k, v, mask)
    out, lse = att.flash_attention(q, k, v, mask, return_lse=True)
    with pytest.raises(TypeError):
        att.flash_attention_backward(q, k, v, mask, out, lse, q.bfloat16())


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_tolerances_accept_blockwise_and_reject_planted(rng, causal):
    """The bf16 card checks (ops/attention_tolerances.py) on the CPU, with
    JAX's blockwise kernels at the card kernels' 64-key tiles in the
    kernels' place: they accept them; the dk check rejects dk less its
    first 64-query tile, and a dk 3% off."""
    q, k, v, mask = _inputs(rng, 4, 150, 130, 16, masked_row=3)
    g = rng.normal(size=q.shape).astype(np.float32)
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _bf16_pair(q, k, v, g)
    jmask = jnp.asarray(mask)
    out, lse = jatt.flash_attention(jq, jk, jv, key_mask=jmask,
                                    causal=causal, block_q=64, block_k=64,
                                    interpret=True, return_lse=True)
    grads = jatt._flash_backward_impl(jq, jk, jv, jmask, out, lse, jg,
                                      causal=causal, block_q=64, block_k=64,
                                      interpret=True)
    tout, *tgrads = [torch.from_numpy(_f32(t)).to(torch.bfloat16)
                     for t in (out, *grads)]
    tlse, tmask = torch.from_numpy(np.array(lse)), _t(mask)[0]
    fwd = at.check_forward_bf16((tout, tlse), tq, tk, tv, tmask, causal)
    assert max(c["err_over_tol"] for c in fwd.values()) < 1
    checks = at.check_backward_bf16(tgrads, tq, tk, tv, tmask, tout, tlse,
                                    tg, causal, planted_rows=64)
    for name in ("dq", "dk", "dv", "dq_bf16_plain"):
        assert checks[name]["fro_over_tol"] < 1
    assert checks["dk"]["planted"]["query_tile_dropped"] > 1
    with pytest.raises(AssertionError):
        at.check_backward_bf16(
            (tgrads[0], tgrads[1] * 1.03, tgrads[2]), tq, tk, tv, tmask,
            tout, tlse, tg, causal)


# -- head widths the card's kernels are not built for -------------------------

def _padded(tensors, width):
    return [att.pad_head_dim(t, width) for t in tensors]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 24])
def test_padded_plain_versions_match_unpadded(rng, d, dtype, causal):
    """What FlashAttention does on the card for a head width without a
    kernel, through the plain K5 and K6: q, k, v and g padded with zero
    columns to the next kernel width and run at scale = D ** -0.5, then
    sliced back, against the unpadded plain versions. The zero columns add
    exact zeros to every score, so fp32 agrees to the rounding of the
    einsums' other summation order over the wider axis (rtol 1e-6, atol
    1e-6 on values ~1), and bf16 to one bf16 rounding of out or of a
    gradient (2^-7 relative and of the largest element); out's padded
    columns and every padded gradient column are exactly 0."""
    q, k, v, mask = _t(*_inputs(rng, 3, 40, 50, d, masked_row=1))
    g = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))
    q, k, v, g = (t.to(dtype) for t in (q, k, v, g))
    width = att.kernel_head_dim(d)
    assert width == {8: 16, 24: 32}[d]
    bf16 = dtype == torch.bfloat16
    fwd = (att.flash_attention_reference_bf16 if bf16
           else att.flash_attention_reference)
    bwd = (att.flash_attention_backward_reference_bf16 if bf16
           else att.flash_attention_backward_reference)
    out, lse = fwd(q, k, v, mask, causal)
    grads = bwd(q, k, v, mask, out, lse, g, causal)
    qp, kp, vp, gp = _padded((q, k, v, g), width)
    out_p, lse_p = fwd(qp, kp, vp, mask, causal, d ** -0.5)
    grads_p = bwd(qp, kp, vp, mask, out_p, lse_p, gp, causal, d ** -0.5)
    for got, want in zip((out_p, *grads_p), (out, *grads)):
        assert got.dtype == dtype and not got[..., d:].any()
        got, want = got[..., :d].float(), want.float()
        if bf16:
            np.testing.assert_allclose(
                got.numpy(), want.numpy(), rtol=2**-7,
                atol=2**-7 * want.abs().max().item())
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                       atol=1e-6)
    np.testing.assert_allclose(lse_p.numpy(), lse.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 24])
def test_padded_flash_attention_matches_jax_interpret(rng, monkeypatch, d,
                                                      dtype, causal):
    """FlashAttention with the card's padding of the head width forced on
    the CPU (the plain versions in the kernels' place), forward and
    gradients, against JAX's flash kernels in interpret mode at the true
    D, which JAX's blocks take whole. fp32: out and lse to 2e-5, gradients
    to atol 3e-5 and rtol 1e-4, as the unpadded tests above; bf16: out to
    one bf16 rounding and 2^-7 of max|v|, lse to 2e-5, and each gradient
    (here from the port's own out and lse, JAX's from its own) within 2^-7
    relative and 2^-7 of its largest element, as the bf16 tests above."""
    monkeypatch.setattr(att, "_operand_width",
                        lambda t: att.kernel_head_dim(t.shape[-1]))
    q, k, v, mask = _inputs(rng, 2, 70, 90, d, masked_row=1)
    g = rng.normal(size=q.shape).astype(np.float32)
    jmask = jnp.asarray(mask)
    if dtype == torch.bfloat16:
        (jq, jk, jv, jg), (tq, tk, tv, tg) = _bf16_pair(q, k, v, g)
    else:
        jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
        tq, tk, tv, tg = _t(q, k, v, g)
    want_out, want_lse = jatt.flash_attention(
        jq, jk, jv, key_mask=jmask, causal=causal, block_q=32, block_k=32,
        interpret=True, return_lse=True)
    if dtype == torch.bfloat16:
        want = jatt._flash_backward_impl(jq, jk, jv, jmask, want_out,
                                         want_lse, jg, causal=causal,
                                         interpret=True)
    else:
        want = jax.grad(lambda *a: jnp.sum(jatt.flash_attention_diff(
            *a, jmask, causal, True) * jg), argnums=(0, 1, 2))(jq, jk, jv)
    args = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    before = dict(att.flash_attention.launches)
    out = att.FlashAttention.apply(*args, _t(mask)[0], causal)
    out.backward(tg)
    assert att.flash_attention.launches == before  # plain on the CPU
    assert out.shape == q.shape and out.dtype == dtype
    qp, kp, vp = _padded((tq, tk, tv), att.kernel_head_dim(d))
    _, lse = att.flash_attention(qp, kp, vp, _t(mask)[0], causal,
                                 return_lse=True, scale=d ** -0.5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=2e-5)
    if dtype == torch.bfloat16:
        vmax = float(np.abs(_f32(tv)).max())
        np.testing.assert_allclose(_f32(out.detach()), _f32(want_out),
                                   rtol=2**-7, atol=2**-7 * vmax)
    else:
        np.testing.assert_allclose(out.detach().numpy(),
                                   np.asarray(want_out), atol=2e-5)
    for name, arg, ref in zip("qkv", args, want):
        assert arg.grad.shape == arg.shape and arg.grad.dtype == dtype
        ref = _f32(ref)
        if dtype == torch.bfloat16:
            np.testing.assert_allclose(_f32(arg.grad), ref, rtol=2**-7,
                                       atol=2**-7 * np.abs(ref).max(),
                                       err_msg=f"d{name}")
        else:
            np.testing.assert_allclose(arg.grad.numpy(), ref, atol=3e-5,
                                       rtol=1e-4, err_msg=f"d{name}")
        assert not arg.grad[1].any()  # the (bh) row with no valid key


def test_attention_dispatch_above_the_widest_kernel(rng, monkeypatch):
    """kernel_head_dim's widths: every width from 129 to 256 pads to the
    D = 256 kernels, a wider one to the next multiple of 64 (257 to 320;
    512 stays). attention() takes every head width: at D = 257
    use_flash=True raises nothing, and a call that the budget sends
    blockwise (its verdict forced on the CPU, where it always says dense)
    goes through FlashAttention with no warning and equals the plain
    versions. Attention-weight dropout still warns there and still raises
    with use_flash=True."""
    assert [att.kernel_head_dim(d) for d in (1, 8, 16, 24, 48, 96, 128,
                                             129)] == \
        [16, 16, 16, 32, 64, 128, 128, 256]
    assert all(att.kernel_head_dim(d) == 256 for d in range(129, 257))
    assert [att.kernel_head_dim(d) for d in (257, 300, 320, 321, 448, 512,
                                             513, 1000)] == \
        [320, 320, 320, 384, 448, 512, 576, 1024]
    assert all(att.kernel_head_dim(d) % att.WIDE_HEAD_STEP == 0 and
               att.kernel_head_dim(d) - d < att.WIDE_HEAD_STEP
               for d in range(257, 1025))
    wide = _t(*_inputs(rng, 2, 6, 6, 257))
    want = att.flash_attention_reference(*wide[:3], wide[3])[0]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = att.attention(*wide[:3], key_mask=wide[3], use_flash=True)
        torch.testing.assert_close(got, want)
        monkeypatch.setattr(att, "use_flash_for", lambda *a: not a[-1])
        got = att.attention(*wide[:3], key_mask=wide[3])
    torch.testing.assert_close(got, want)
    gen = torch.Generator().manual_seed(0)
    with pytest.warns(UserWarning, match="attention-weight dropout"):
        att.attention(*wide[:3], key_mask=wide[3], dropout_rate=0.1,
                      generator=gen)
    with pytest.raises(ValueError, match="dropout"):
        att.attention(*wide[:3], key_mask=wide[3], use_flash=True,
                      dropout_rate=0.1, generator=gen)
    narrow = [t.requires_grad_() for t in _t(*_inputs(rng, 2, 6, 6, 8))[:3]]
    att.attention(*narrow, causal=True).sum().backward()  # FlashAttention
    assert all(t.grad is not None for t in narrow)


# (source, C function) of K5 ("fwd") and K6 ("bwd") by operand dtype and
# head width (at every shape):
# csrc/flash_attention.cu up to 128 for fp32 operands; the bf16 kernels of
# csrc/flash_attention_tma_bf16.cu at D = 16 and K5's at 64, and the
# one-block instances of csrc/flash_attention_cluster_bf16.cu for the bf16
# K6 at 64 and 128 and K5 at 128;
# csrc/flash_attention_wide(_bf16).cu for K6 and the fp32 K5 from 256 on;
# csrc/flash_attention_cluster_bf16.cu for the bf16 K5 from 256 to 4096 and
# the bf16 K6 above 256 to 4096, csrc/flash_attention_wide_bf16.cu for the
# bf16 K6 at 256 (and both above 4096: test_bf16_cluster_routes_end_at_4096).
_WIDTHS = (16, 64, 128, 256, 320, 512, 768, 2048, 2304)
_ROUTES = {
    ("float32", "fwd"): {**{d: "flash_attention" for d in _WIDTHS[:3]},
                         **{d: "flash_attention_wide" for d in _WIDTHS[3:]}},
    ("float32", "bwd"): {**{d: "flash_attention" for d in _WIDTHS[:3]},
                         **{d: "flash_attention_wide" for d in _WIDTHS[3:]}},
    ("bfloat16", "fwd"): {16: "flash_attention_tma_bf16",
                          64: "flash_attention_tma_bf16",
                          **{d: "flash_attention_cluster_bf16"
                             for d in _WIDTHS[2:]}},
    ("bfloat16", "bwd"): {16: "flash_attention_tma_bf16",
                          64: "flash_attention_cluster_bf16",
                          128: "flash_attention_cluster_bf16",
                          256: "flash_attention_wide_bf16",
                          **{d: "flash_attention_cluster_bf16"
                             for d in _WIDTHS[4:]}},
}


def _check_route(dtype, direction, source, symbol):
    """The C function's name follows its source's, and the source is one
    the build compiles and defines that function."""
    from deep_recommenders_torch.ops import _build

    prefix = source[:-len("_bf16")] if dtype == "bfloat16" else source
    suffix = "bf16" if dtype == "bfloat16" else "f32"
    assert symbol == f"{prefix}_{direction}_{suffix}"
    assert source in _build.SOURCES
    with open(_build.source_path(source)) as f:
        assert f'extern "C" int {symbol}(' in f.read()


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("d", _WIDTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_routing_by_dtype_width_and_direction(dtype, d, direction):
    """_kernel() names the source and C function the card launches for each
    operand dtype, head width and direction; the source is one the build
    compiles and defines that function."""
    source, symbol = att._kernel(getattr(torch, dtype), d,
                                 direction == "bwd")
    assert source == _ROUTES[dtype, direction][d]
    _check_route(dtype, direction, source, symbol)


# (dtype, direction, D, BH, Sq) -> source: the bf16 K5 of
# flash_attention_tma_bf16.cu at D = 16, 32 and 64 and its K6 at D = 16 and
# 32 whatever the shape (on both sides of the most rows a query range holds,
# TMA_BWD_MAX_ROWS, and of the card's SMs in BH); flash_attention.cu for
# fp32 operands; the one-block instances of flash_attention_cluster_bf16.cu
# for the bf16 K5 at D = 128 (CLUSTER_FWD_NARROW_DIMS) and K6 at 64 and 128
# (CLUSTER_BWD_NARROW_DIMS) whatever the shape (on both sides of the TMA
# K6's edges: one (bh) or many, one query row or more than its most); the
# bf16 K6 of flash_attention_cluster_bf16.cu up to CLUSTER_BWD_HEAD_DIM_MAX
# whatever the shape, flash_attention_wide_bf16.cu's one step past it.
_SHAPE_ROUTES = [
    ("bfloat16", "fwd", 16, 2, 100, "flash_attention_tma_bf16"),
    ("bfloat16", "fwd", 32, 6, 150, "flash_attention_tma_bf16"),
    ("bfloat16", "fwd", 64, 2048, 4096, "flash_attention_tma_bf16"),
    ("bfloat16", "fwd", 128, 2048, 512, "flash_attention_cluster_bf16"),
    ("bfloat16", "fwd", 128, 1, 1, "flash_attention_cluster_bf16"),
    ("bfloat16", "fwd", 128, 131, 4096, "flash_attention_cluster_bf16"),
    ("float32", "fwd", 128, 2048, 512, "flash_attention"),
    ("float32", "fwd", 16, 2048, 512, "flash_attention"),
    ("bfloat16", "bwd", 16, 132, 2176, "flash_attention_tma_bf16"),
    ("bfloat16", "bwd", 16, 132, 2177, "flash_attention_tma_bf16"),
    ("bfloat16", "bwd", 16, 131, 512, "flash_attention_tma_bf16"),
    ("bfloat16", "bwd", 32, 2048, 768, "flash_attention_tma_bf16"),
    ("bfloat16", "bwd", 32, 2048, 769, "flash_attention_tma_bf16"),
    ("bfloat16", "bwd", 16, 64, 4096, "flash_attention_tma_bf16"),
    ("bfloat16", "bwd", 16, 1, 1, "flash_attention_tma_bf16"),
    ("bfloat16", "bwd", 16, 1, 100_000, "flash_attention_tma_bf16"),
    ("bfloat16", "bwd", 32, 131, 768, "flash_attention_tma_bf16"),
    ("bfloat16", "bwd", 32, 4096, 4096, "flash_attention_tma_bf16"),
    ("bfloat16", "bwd", 64, 2048, 512, "flash_attention_cluster_bf16"),
    ("bfloat16", "bwd", 64, 131, 512, "flash_attention_cluster_bf16"),
    ("bfloat16", "bwd", 64, 132, 769, "flash_attention_cluster_bf16"),
    ("bfloat16", "bwd", 64, 1, 1, "flash_attention_cluster_bf16"),
    ("bfloat16", "bwd", 128, 2048, 512, "flash_attention_cluster_bf16"),
    ("bfloat16", "bwd", 128, 131, 2177, "flash_attention_cluster_bf16"),
    ("bfloat16", "bwd", 128, 1, 1, "flash_attention_cluster_bf16"),
    ("float32", "bwd", 64, 2048, 512, "flash_attention"),
    ("float32", "bwd", 16, 2048, 512, "flash_attention"),
    ("bfloat16", "bwd", 2048, 2, 70, "flash_attention_cluster_bf16"),
    ("bfloat16", "bwd", 2112, 2, 70, "flash_attention_cluster_bf16"),
    ("bfloat16", "bwd", 4096, 2048, 512, "flash_attention_cluster_bf16"),
    ("bfloat16", "bwd", 4160, 2, 70, "flash_attention_wide_bf16"),
    ("bfloat16", "bwd", 320, 1, 4096, "flash_attention_cluster_bf16"),
]


@pytest.mark.parametrize("dtype,direction,d,bh,sq,want", _SHAPE_ROUTES)
def test_kernel_routing_by_shape(dtype, direction, d, bh, sq, want):
    """_kernel() routes the bf16 kernels of narrow heads, and the bf16 K6
    above 256, by width alone to the source and C function documented for
    each case; where that is the bf16 K6 of flash_attention_tma_bf16.cu,
    bwd_query_ranges covers the case's (BH, Sq) in ranges it takes."""
    source, symbol = att._kernel(getattr(torch, dtype), d,
                                 direction == "bwd")
    assert source == want
    _check_route(dtype, direction, source, symbol)
    if source == "flash_attention_tma_bf16" and direction == "bwd":
        for causal in (False, True):
            starts = att.bwd_query_ranges(bh, sq, sq, d, 132, causal)
            assert starts[0] == 0 and starts[-1] == max(1, -(-sq // 128))
            assert all(0 < (b - a) * 128 <= att.TMA_BWD_MAX_ROWS[d]
                       for a, b in zip(starts, starts[1:]))


# Above 2048 columns: the bf16 K5 and K6 on clusters of 9-16 blocks
# (csrc/flash_attention_cluster_bf16.cu, up to CLUSTER_FWD_HEAD_DIM_MAX and
# CLUSTER_BWD_HEAD_DIM_MAX), everything past 4096 on
# flash_attention_wide_bf16.cu, the fp32 kernels on flash_attention_wide.cu,
# whatever the shape.
_ABOVE_2048_ROUTES = [
    ("bfloat16", "fwd", 2112, "flash_attention_cluster_bf16"),
    ("bfloat16", "fwd", 2304, "flash_attention_cluster_bf16"),
    ("bfloat16", "fwd", 4096, "flash_attention_cluster_bf16"),
    ("bfloat16", "fwd", 4160, "flash_attention_wide_bf16"),
    ("bfloat16", "bwd", 2112, "flash_attention_cluster_bf16"),
    ("bfloat16", "bwd", 2304, "flash_attention_cluster_bf16"),
    ("bfloat16", "bwd", 3072, "flash_attention_cluster_bf16"),
    ("bfloat16", "bwd", 4096, "flash_attention_cluster_bf16"),
    ("bfloat16", "bwd", 4160, "flash_attention_wide_bf16"),
    ("bfloat16", "bwd", 8192, "flash_attention_wide_bf16"),
    ("float32", "fwd", 4096, "flash_attention_wide"),
    ("float32", "bwd", 4096, "flash_attention_wide"),
]


@pytest.mark.parametrize("bh,sq", [(2048, 512), (1, 70)])
@pytest.mark.parametrize("dtype,direction,d,want", _ABOVE_2048_ROUTES)
def test_kernel_routing_above_2048(dtype, direction, d, want, bh, sq):
    """_kernel() sends the bf16 K5 and K6 from 2048 to 4096 to the clusters
    of csrc/flash_attention_cluster_bf16.cu and the rest above 2048 to the
    wide kernels, at any (BH, Sq) (it takes none: the cases name two); the
    source defines the C function."""
    source, symbol = att._kernel(getattr(torch, dtype), d,
                                 direction == "bwd")
    assert source == want
    _check_route(dtype, direction, source, symbol)


@pytest.mark.parametrize("backward", [False, True])
def test_bf16_cluster_routes_end_at_4096(backward):
    """Every multiple of 64 above 2048: the bf16 K5 and K6 run the clusters
    of csrc/flash_attention_cluster_bf16.cu up to 4096 (9-16 blocks of 4
    chunks) and flash_attention_wide_bf16.cu above, where 16 blocks of 4
    chunks no longer cover D."""
    top = (att.CLUSTER_BWD_HEAD_DIM_MAX if backward
           else att.CLUSTER_FWD_HEAD_DIM_MAX)
    assert top == 4096
    for d in range(2112, 8193, 64):
        source, symbol = att._kernel(torch.bfloat16, d, backward)
        assert source == ("flash_attention_cluster_bf16" if d <= top
                          else "flash_attention_wide_bf16"), d
        assert 9 <= _cluster_split(d)[0] <= 16 or d > top
        _check_route("bfloat16", "bwd" if backward else "fwd", source,
                     symbol)


# Every bf16 route of K5 and K6 at the kernel widths up to 128, at shapes on
# both sides of every edge the routes have had: none is
# csrc/flash_attention_bf16.cu (its mma.sync kernels stay only as a
# yardstick), and the bf16 K6 at D = 16 and 32 is
# csrc/flash_attention_tma_bf16.cu's.
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_no_bf16_route_reaches_the_mma_sync_kernels(d):
    for bh, sq in itertools.product((1, 6, 64, 131, 132, 133, 2048),
                                    (1, 100, 512, 768, 769, 2176, 2177,
                                     4096, 16384)):
        for backward in (False, True):
            source, symbol = att._kernel(torch.bfloat16, d, backward)
            assert source != "flash_attention_bf16"
            _check_route("bfloat16", "bwd" if backward else "fwd", source,
                         symbol)
            if backward and d in (16, 32):
                assert source == "flash_attention_tma_bf16"


# (BH, Sq = Sk, D, causal) -> the starts of the query ranges (in 128-row
# tiles) on the H100's 132 SMs: one range where it fits and BH fills the
# card (the one-pass kernel's former shapes, and BH = 131 at Sq = 512,
# where two cost as much); past TMA_BWD_MAX_ROWS ranges of one length (the
# last shorter), causal more than the fewest where that balances the
# blocks (13 + 13 + 6 tiles at Sq = 4096); few (bh) rows cut into ranges
# that fill the SMs, down to one query tile a range; and past the kernel's
# table of 256 ranges, in groups.
_RANGE_PLANS = [
    ((2048, 512, 16, False), (0, 4)),
    ((2048, 512, 16, True), (0, 4)),
    ((132, 2176, 16, False), (0, 17)),
    ((132, 2177, 16, False), (0, 9, 18)),
    ((132, 2177, 16, True), (0, 9, 18)),
    ((131, 512, 16, False), (0, 4)),
    ((132, 512, 16, True), (0, 4)),
    ((64, 4096, 16, False), (0, 16, 32)),
    ((64, 4096, 16, True), (0, 13, 26, 32)),
    ((1, 4096, 16, True), tuple(range(33))),
    ((128, 2048, 16, False), (0, 16)),
    ((64, 512, 16, False), (0, 2, 4)),
    ((64, 512, 16, True), (0, 3, 4)),
    ((1, 4096, 16, False), tuple(range(33))),
    ((1, 1, 16, False), (0, 1)),
    ((2048, 768, 32, False), (0, 6)),
    ((2048, 769, 32, False), (0, 4, 7)),
    ((256, 1024, 32, False), (0, 4, 8)),
    ((64, 4096, 32, False), (0, 4, 8, 12, 16, 20, 24, 28, 32)),
    ((1, 600_000, 16, False), tuple(range(0, 4688, 14)) + (4688,)),
]


@pytest.mark.parametrize("shape,want", _RANGE_PLANS)
def test_bwd_query_ranges(shape, want):
    """bwd_query_ranges: ranges of whole 128-row tiles from 0 to the last
    tile's end, each at most TMA_BWD_MAX_ROWS[d] rows (the C function's
    limit, flash_attention_tma_bwd_max_rows_bf16, as the source computes
    it), all of one length but the last; the plan pinned for each case; a
    launch takes at most TMA_BWD_GROUP_MAX of them (the kernel's table) and
    the partials of a group fit TMA_BWD_PART_BYTES."""
    bh, sq, d, causal = shape
    starts = att.bwd_query_ranges(bh, sq, sq, d, 132, causal)
    assert starts == want
    nq = max(1, -(-sq // 128))
    most = att.TMA_BWD_MAX_ROWS[d] // 128
    assert starts[0] == 0 and starts[-1] == nq
    lengths = [b - a for a, b in zip(starts, starts[1:])]
    assert all(0 < n <= most for n in lengths)
    assert all(n == lengths[0] for n in lengths[:-1])
    group = att.bwd_range_group(bh, sq, d, len(lengths))
    assert 1 <= group <= min(len(lengths), att.TMA_BWD_GROUP_MAX)
    assert group == 1 or 2 * group * bh * sq * d * 4 <= \
        att.TMA_BWD_PART_BYTES


# (BH, Sq = Sk, causal, starts, the partials' bytes budget or None) -> the
# planner's time in (query tile, key tile) pairs, counted by hand at D = 16
# (c = TMA_BWD_PART_PAIRS[16] pairs a visited key tile where there is more
# than one range): one range of 16 x 16 pairs on a block each; two ranges
# of 8 query tiles, two items a block; causal, 1 + 2 + 3 + 4 pairs; causal
# two ranges on four blocks, the second (3 + 4 pairs, 4 key tiles) the
# longest; and one range a launch (a budget of one range's partials), two
# launches of one item.
_PLAN_TIMES = [
    ((132, 2048, False, (0, 16), None), lambda c: 256),
    ((132, 2048, False, (0, 8, 16), None), lambda c: 2 * (128 + 16 * c)),
    ((1, 512, True, (0, 4), None), lambda c: 10),
    ((2, 512, True, (0, 2, 4), None), lambda c: 7 + 4 * c),
    ((1, 512, False, (0, 2, 4), 2 * 512 * 16 * 4),
     lambda c: 2 * (2 * 4 + 4 * c)),
]


@pytest.mark.parametrize("shape,want", _PLAN_TIMES)
def test_bwd_plan_time(monkeypatch, shape, want):
    """bwd_plan_time counts each block's items' pairs and the partials'
    price, launch by launch, as its docstring says."""
    bh, s, causal, starts, budget = shape
    if budget is not None:
        monkeypatch.setattr(att, "TMA_BWD_PART_BYTES", budget)
        assert att.bwd_range_group(bh, s, 16, len(starts) - 1) == 1
    c = att.TMA_BWD_PART_PAIRS[16]
    assert att.bwd_plan_time(bh, s, s, 16, 132, causal, starts) == \
        pytest.approx(want(c))


def test_bwd_max_rows_mirrors_the_source():
    """TMA_BWD_MAX_ROWS is what BwdLayout's kMaxRows gives: the shared
    memory a block may take (kMaxSmem) less its rings, barriers and ds
    buffers, over (2 + D) fp32 a row, in whole 128-row tiles."""
    from deep_recommenders_torch.ops import _build

    with open(_build.source_path("flash_attention_tma_bf16")) as f:
        source = f.read()
    assert "constexpr int kMaxRows =" in source
    assert "extern \"C\" int flash_attention_tma_bwd_max_rows_bf16(int d)" \
        in source
    smem = 232448
    for d, rows in att.TMA_BWD_MAX_ROWS.items():
        tile = 128 * 2 * d
        fixed = (2 * 64 * 64 * 2 * 2 + 2 * 2 * tile + 3 * 2 * tile
                 + 2 * 2 * 16 + 8 * 2 * (2 + 3))
        assert rows == (smem - fixed) // ((2 + d) * 4) // 128 * 128


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,sq,sk,d", [(2, 600, 600, 16), (3, 900, 200, 32)])
def test_backward_checks_reject_a_lost_query_range(bh, sq, sk, d, causal):
    """flash_attention_backward_lost_range on the CPU (the bf16 plain
    version less one query range's terms in dk and dv, the ranges of
    bwd_query_ranges on the H100's 132 SMs, given by the caller): dq is
    whole, and the bf16 backward check, which accepts the plain version,
    rejects dk or dv with any one range lost; a shape of one range raises,
    and so does a call on the CPU that names no SM count."""
    rng = np.random.default_rng(7)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(
        (bh, s, d)).astype(np.float32)).to(torch.bfloat16)
        for s in (sq, sk, sk, sq))
    mask = torch.from_numpy((rng.random((bh, sk)) < 0.8).astype(np.float32))
    out, lse = att.flash_attention_reference_bf16(q, k, v, mask, causal)
    grads = att.flash_attention_backward(q, k, v, mask, out, lse, g, causal)
    at.check_backward_bf16(grads, q, k, v, mask, out, lse, g, causal)
    ranges = len(att.bwd_query_ranges(bh, sq, sk, d, 132, causal)) - 1
    assert ranges > 1
    for drop in range(ranges):
        lost = att.flash_attention_backward_lost_range(
            q, k, v, mask, out, lse, g, causal, drop, sms=132)
        assert torch.equal(lost[0], grads[0])
        checks = at.check_backward_bf16(lost, q, k, v, mask, out, lse, g,
                                        causal, hold=False)
        assert max(checks[n]["err_over_tol"] for n in ("dk", "dv")) > 1
    with pytest.raises(ValueError, match="one query range"):
        att.flash_attention_backward_lost_range(
            *(t[:, :128] for t in (q, k, v)), mask[:, :128],
            out[:, :128], lse[:, :128], g[:, :128], causal, sms=132)
    with pytest.raises(ValueError, match="SMs"):
        att.flash_attention_backward_lost_range(
            q, k, v, mask, out, lse, g, causal)


def _cluster_split(d: int):
    """A plain mirror of csrc/flash_attention_cluster_bf16.cu's split_of:
    the blocks of a cluster at head width d (one a 256 columns) and the
    64-column chunks each block owns (an even share)."""
    chunks = d // 64
    blocks = -(-chunks // 4)
    return blocks, -(-chunks // blocks)


def test_cluster_split_mirrors_split_of():
    """split_of's rule as the source states it, and for every multiple of
    64 from 256 to CLUSTER_FWD_HEAD_DIM_MAX (= CLUSTER_BWD_HEAD_DIM_MAX)
    its plain mirror: one block a 256 columns, at most 16, an even share
    of 3 or 4 chunks a block (every block owns at least one column of D, so
    each rank has a partial), 4 chunks in every cluster of more than 8
    blocks."""
    from deep_recommenders_torch.ops import _build

    with open(_build.source_path("flash_attention_cluster_bf16")) as f:
        source = f.read()
    assert ("  const int nc = d / kC;\n"
            "  const int group = (nc + kMaxChunks - 1) / kMaxChunks;\n"
            "  return make_int2(group, (nc + group - 1) / group);\n") in source
    assert "constexpr int kClusterMaxWide = 16;" in source
    assert att.CLUSTER_FWD_HEAD_DIM_MAX == 16 * 256
    assert att.CLUSTER_BWD_HEAD_DIM_MAX == 16 * 256
    for d in range(256, att.CLUSTER_FWD_HEAD_DIM_MAX + 1, 64):
        blocks, chunks = _cluster_split(d)
        assert blocks == -(-d // 256)
        assert (blocks - 1) * chunks * 64 < d <= blocks * chunks * 64
        assert chunks == 4 if d == 256 or blocks > 8 else chunks in (3, 4)
    assert _cluster_split(att.CLUSTER_FWD_HEAD_DIM_MAX) == (16, 4)
    assert _cluster_split(2112) == (9, 4)


def _mirror_slices(group: int, shift: int):
    """The plain mirror of a reduce-scatter's slices of a slot of
    1 << shift float4s among ``group`` ranks: rank r sums float4
    [r N / G, (r + 1) N / G), and the all-gather reads float4 f from rank
    ((f + 1) G - 1) / N. The slices cover the slot once, every rank owns
    one, and each f is read from the rank whose slice holds it."""
    n = 1 << shift
    bounds = [(r * n // group, (r + 1) * n // group) for r in range(group)]
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    for f in range(n):
        owner = ((f + 1) * group - 1) >> shift
        lo, hi = bounds[owner]
        assert lo <= f < hi


def _cluster_source() -> str:
    from deep_recommenders_torch.ops import _build

    with open(_build.source_path("flash_attention_cluster_bf16")) as f:
        return f.read()


@pytest.mark.parametrize("group", range(3, 17))
def test_reduce_scatter_slices_mirror_the_source(group):
    """The bf16 K5's reduce-scatter among G = 3-16 blocks, as the source
    states it: rank r sums float4 [r 1024 / G, (r + 1) 1024 / G) of a
    warpgroup's 1024-float4 slot, and the all-gather reads float4 f from
    rank ((f + 1) G - 1) / 1024 (:func:`_mirror_slices`)."""
    source = _cluster_source()
    assert ("const int lo = (rank << 10) / group, "
            "hi = ((rank + 1) << 10) / group;") in source
    assert "const int owner = ((f + 1) * group - 1) >> 10;" in source
    _mirror_slices(group, 10)


@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("group", range(9, 17))
def test_backward_reduce_scatter_slices_mirror_the_source(group, parts):
    """The bf16 K6's reduce-scatter among G = 9-16 blocks (Partials<P,
    kReduce> of csrc/flash_attention_cluster_bf16.cu), as the source states
    it: K5's slices and owners on a slot of 1 << kShift float4s, 1024 for
    dq's s and dp (P = 2), 512 for dk/dv's s^T or dp^T (P = 1), so that
    every rank owns a slice (:func:`_mirror_slices`)."""
    source = _cluster_source()
    assert "static constexpr int kShift = P == 2 ? 10 : 9;" in source
    assert "static_assert(Q * 128 == 1 << kShift" in source
    assert "  static constexpr int Q = 4 * P;  // float4s a thread\n" in source
    assert ("      const int lo = (rank << kShift) / group,\n"
            "                hi = ((rank + 1) << kShift) / group;\n") in source
    assert ("        const int owner = ((f + 1) * group - 1) >> kShift;\n"
            in source)
    shift = 10 if parts == 2 else 9
    assert 4 * parts * 128 == 1 << shift
    _mirror_slices(group, shift)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [2112, 2304, 3072, 4096])
def test_forward_checks_at_clusters_of_9_to_16(rng, d, causal):
    """The bf16 K5 above 2048 sums the partial scores of 9-16 blocks
    (reduce-scatter, then all-gather) in rank order: that function passes
    check_forward_bf16 at G = 9, 9, 12 and 16 (D = 2112's last block owns
    one chunk of D), and with any one rank's partial left out (the first,
    the middle or the last) it fails, its worst share above 1."""
    q, k, v, mask = _t(*_inputs(rng, 2, 70, 90, d, masked_row=1))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    ranks = _cluster_split(d)[0]
    assert -(-d // at.PARTIAL_WIDTH) == ranks
    whole = at.flash_attention_partial_scores(q, k, v, mask, causal)
    checks = at.check_forward_bf16(whole, q, k, v, mask, causal,
                                   planted_partial=True)
    assert max(c["err_over_tol"] for name, c in checks.items()
               if name != "planted") < 1
    assert checks["planted"]["partial_dropped"] > 1
    for drop in (0, ranks // 2, ranks - 1):
        lost = at.flash_attention_partial_scores(q, k, v, mask, causal,
                                                 drop=drop)
        with pytest.raises(AssertionError, match="disagrees|outside"):
            at.check_forward_bf16(lost, q, k, v, mask, causal)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [2112, 2304, 3072, 4096])
def test_backward_checks_at_clusters_of_9_to_16(rng, d, causal):
    """The bf16 K6 above 2048 sums the partial s and dp (s^T and dp^T) of
    9-16 blocks (reduce-scatter, then all-gather) in rank order: that
    function passes check_backward_bf16 at G = 9, 9, 12 and 16 (D = 2112's
    last block owns one chunk of D), and with any one rank's partials left
    out (the first, the middle or the last) it fails, its worst share
    above 1."""
    q, k, v, mask = _t(*_inputs(rng, 2, 70, 90, d, masked_row=1))
    g = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))
    q, k, v, g = (t.to(torch.bfloat16) for t in (q, k, v, g))
    ranks = _cluster_split(d)[0]
    assert -(-d // at.PARTIAL_WIDTH) == ranks
    out, lse = att.flash_attention_reference_bf16(q, k, v, mask, causal)
    whole = at.flash_attention_backward_partial_scores(q, k, v, mask, out,
                                                       lse, g, causal)
    checks = at.check_backward_bf16(whole, q, k, v, mask, out, lse, g,
                                    causal, planted_partial=True)
    assert max(c["err_over_tol"] for name, c in checks.items()
               if name != "planted") < 1
    assert checks["planted"]["partial_dropped"] > 1
    for drop in (0, ranks // 2, ranks - 1):
        lost = at.flash_attention_backward_partial_scores(
            q, k, v, mask, out, lse, g, causal, drop=drop)
        with pytest.raises(AssertionError, match="disagrees"):
            at.check_backward_bf16(lost, q, k, v, mask, out, lse, g, causal)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [512, 1024])
def test_forward_checks_reject_a_lost_partial_score(rng, d, dtype, causal):
    """The forward checks keep the power to catch a lost exchange between
    the blocks of a cluster that splits D: K5 with its scores summed in
    fp32 from per-256-column partials in rank order passes check_forward
    (fp32 operands) or check_forward_bf16 (bf16 operands); the same with
    the last partial left out fails, its worst share of a tolerance above
    1 (reported as reject_planted reports a gradient's)."""
    q, k, v, mask = _t(*_inputs(rng, 2, 70, 90, d, masked_row=1))
    check = at.check_forward
    if dtype == "bfloat16":
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        check = at.check_forward_bf16
    whole = at.flash_attention_partial_scores(q, k, v, mask, causal)
    checks = check(whole, q, k, v, mask, causal, planted_partial=True)
    assert max(c["err_over_tol"] for name, c in checks.items()
               if name != "planted") < 1
    assert checks["planted"]["partial_dropped"] > 1
    lost = at.flash_attention_partial_scores(
        q, k, v, mask, causal, drop=d // at.PARTIAL_WIDTH - 1)
    with pytest.raises(AssertionError, match="disagrees|outside"):
        check(lost, q, k, v, mask, causal)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [512, 1024])
def test_backward_checks_reject_a_lost_partial_score(rng, d, dtype, causal):
    """The backward checks keep the power to catch a lost exchange between
    the blocks of a cluster that splits D: K6 with s and dp summed in fp32
    from per-256-column partials in rank order passes check_backward
    (fp32 operands) or check_backward_bf16 (bf16 operands); the same with
    the last block's partials left out fails, its worst share of a
    tolerance above 1."""
    q, k, v, mask = _t(*_inputs(rng, 2, 70, 90, d, masked_row=1))
    g = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))
    check, forward = at.check_backward, att.flash_attention_reference
    if dtype == "bfloat16":
        q, k, v, g = (t.to(torch.bfloat16) for t in (q, k, v, g))
        check = at.check_backward_bf16
        forward = att.flash_attention_reference_bf16
    out, lse = forward(q, k, v, mask, causal)
    whole = at.flash_attention_backward_partial_scores(q, k, v, mask, out,
                                                       lse, g, causal)
    checks = check(whole, q, k, v, mask, out, lse, g, causal,
                   planted_partial=True)
    assert max(c["err_over_tol"] for name, c in checks.items()
               if name != "planted") < 1
    assert checks["planted"]["partial_dropped"] > 1
    lost = at.flash_attention_backward_partial_scores(
        q, k, v, mask, out, lse, g, causal, drop=d // at.PARTIAL_WIDTH - 1)
    with pytest.raises(AssertionError, match="disagrees"):
        check(lost, q, k, v, mask, out, lse, g, causal)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [200, 256, 257, 320, 512])
def test_wide_heads_use_flash_match_jax_interpret(rng, monkeypatch, d,
                                                  causal):
    """attention(use_flash=True) at D = 256, 320 and 512 and at D = 200 and
    257, which the card pads to the D = 256 and D = 320 kernels (the
    padding forced here on the CPU, the plain versions in the kernels'
    place), forward and gradients, against JAX's flash_attention_diff in
    interpret mode, whose blocks take any D: out rtol 1e-5 with atol 2e-5,
    the gradients rtol 1e-5 with atol 3e-5, the file's bounds for the two
    summation orders."""
    monkeypatch.setattr(att, "_operand_width",
                        lambda t: att.kernel_head_dim(t.shape[-1]))
    q, k, v, mask = _inputs(rng, 2, 64, 64, d, masked_row=1)
    g = rng.normal(size=q.shape).astype(np.float32)
    jq, jk, jv, jg, jmask = (jnp.asarray(a) for a in (q, k, v, g, mask))
    want_out, vjp = jax.vjp(lambda *a: jatt.flash_attention_diff(
        *a, jmask, causal, True), jq, jk, jv)
    want = vjp(jg)
    args = [t.requires_grad_() for t in _t(q, k, v)]
    before = dict(att.flash_attention.launches)
    out = att.attention(*args, key_mask=_t(mask)[0], causal=causal,
                        use_flash=True)
    out.backward(torch.from_numpy(g))
    assert att.flash_attention.launches == before  # plain on the CPU
    assert out.shape == q.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=1e-5, atol=2e-5)
    for name, arg, ref in zip("qkv", args, want):
        np.testing.assert_allclose(arg.grad.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=3e-5, err_msg=f"d{name}")
        assert not arg.grad[1].any()


# JAX's side of the bf16 test at D = 256: its Pallas forward and backward
# in interpret mode on bf16 inputs, in a subprocess under
# --xla_allow_excess_precision=false, so that XLA on the CPU keeps every
# bf16 rounding that the TPU kernels make.
_JAX_WIDE_BF16 = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
from deep_recommenders_tpu.ops import attention as jatt

a = dict(np.load(sys.argv[1]))
out = {}
for causal in (False, True):
    q, k, v, g = (jnp.asarray(a[n], jnp.bfloat16) for n in "qkvg")
    mask = jnp.asarray(a["mask"])
    o, lse = jatt.flash_attention(q, k, v, key_mask=mask, causal=causal,
                                  interpret=True, return_lse=True)
    grads = jatt._flash_backward_impl(q, k, v, mask, o, lse, g,
                                      causal=causal, interpret=True)
    for name, t in zip(("out", "lse", "dq", "dk", "dv"), (o, lse, *grads)):
        out[f"{int(causal)}/{name}"] = np.asarray(t.astype(jnp.float32))
np.savez(sys.argv[2], **out)
"""


def test_wide_head_bf16_plain_versions_match_jax_pallas(rng, tmp_path):
    """The bf16 plain K5 and K6 at D = 256, non-causal and causal, against
    JAX's Pallas kernels in interpret mode on the same bf16 inputs (JAX in
    a subprocess with excess precision off): out within one bf16 rounding
    and 2^-7 of max|v|, lse to 2e-5, each gradient (from JAX's out and
    lse) within 2^-7 relative and 2^-7 of its largest element, as the bf16
    tests above."""
    _wide_bf16_against_jax(rng, tmp_path, 256)


def test_bf16_k5_above_2048_matches_jax_pallas(rng, tmp_path):
    """At D = 2304, where the card's bf16 K5 and K6 run on clusters of 9
    blocks that add their partial scores in rank order: the bf16 plain K5
    and K6 and those summation orders (flash_attention_partial_scores, and
    flash_attention_backward_partial_scores for s and dp) against JAX's
    Pallas kernels in interpret mode, as at D = 256."""
    _wide_bf16_against_jax(rng, tmp_path, 2304, partial_scores=True)


def _wide_bf16_against_jax(rng, tmp_path, d, partial_scores=False):
    q, k, v, mask = _inputs(rng, 2, 64, 64, d, masked_row=1)
    g = rng.normal(size=q.shape).astype(np.float32)
    np.savez(tmp_path / "in.npz", q=q, k=k, v=v, g=g, mask=mask)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=root,
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    subprocess.run([sys.executable, "-c", _JAX_WIDE_BF16,
                    str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                   check=True, cwd=root, env=env, timeout=300)
    want = dict(np.load(tmp_path / "out.npz"))
    tq, tk, tv, tg = (torch.from_numpy(a).to(torch.bfloat16)
                      for a in (q, k, v, g))
    tmask = _t(mask)[0]
    vmax = float(np.abs(_f32(tv)).max())
    for causal in (False, True):
        w = {n: want[f"{int(causal)}/{n}"] for n in
             ("out", "lse", "dq", "dk", "dv")}
        out, lse = att.flash_attention(tq, tk, tv, tmask, causal,
                                       return_lse=True)
        np.testing.assert_allclose(_f32(out), w["out"], rtol=2**-7,
                                   atol=2**-7 * vmax)
        np.testing.assert_allclose(lse.numpy(), w["lse"], atol=2e-5)
        if partial_scores:
            out, lse = at.flash_attention_partial_scores(tq, tk, tv, tmask,
                                                         causal)
            np.testing.assert_allclose(_f32(out), w["out"], rtol=2**-7,
                                       atol=2**-7 * vmax)
            np.testing.assert_allclose(lse.numpy(), w["lse"], atol=2e-5)
        residuals = (torch.from_numpy(w["out"]).to(torch.bfloat16),
                     torch.from_numpy(w["lse"]))
        runs = [att.flash_attention_backward(tq, tk, tv, tmask, *residuals,
                                             tg, causal)]
        if partial_scores:
            runs.append(at.flash_attention_backward_partial_scores(
                tq, tk, tv, tmask, *residuals, tg, causal))
        for got in runs:
            for name, grad in zip(("dq", "dk", "dv"), got):
                assert grad.dtype == torch.bfloat16 and not grad[1].any()
                np.testing.assert_allclose(
                    _f32(grad), w[name], rtol=2**-7,
                    atol=2**-7 * np.abs(w[name]).max(), err_msg=name)
