"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present. This file
imports neither JAX nor the JAX package, so it runs on the card alone (see
README, "PyTorch port"). The tolerances follow the fp32 summation bound:
atomics and the reference sum each output in different orders. The CIN
kernels' checks are ``ops/cin_tolerances.py``'s (K4's forward and K3's
and K4's backwards at the TPU kernels' bf16 contract, against their bf16
emulations and fp64), the attention kernels' ``ops/attention_tolerances.py``'s;
each module states them.
"""

import numpy as np
import pytest
import torch

from deep_recommenders_torch.ops import attention as att
from deep_recommenders_torch.ops import attention_tolerances as at
from deep_recommenders_torch.ops import cin_kernels as ck
from deep_recommenders_torch.ops import cin_tolerances as ct
from deep_recommenders_torch.ops import embedding_kernels as ek
from deep_recommenders_torch.ops import fm

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("skewed", [False, True])
def test_scatter_add_rows_kernel(device, skewed):
    rng = np.random.default_rng(0)
    n, c, v = 16384, 17, 10044
    ids = rng.integers(0, v, n).astype(np.int32)
    if skewed:
        hot = rng.random(n) < 0.9
        ids[hot] = rng.integers(0, 16, hot.sum())
    g = torch.from_numpy(rng.normal(0, 1, (n, c)).astype(np.float32))
    ids = torch.from_numpy(ids)
    want = ek.scatter_add_rows_reference(g.double(), ids, v)
    before = ek.scatter_add_rows.launches
    got = ek.scatter_add_rows(g.to(device), ids.to(device), v)
    torch.cuda.synchronize()
    assert ek.scatter_add_rows.launches == before + 1
    # fp64 reference; ~1500 fp32 adds into a hot row of size ~40.
    np.testing.assert_allclose(got.cpu().double().numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-3)


def test_lookup_backward_launches_kernel_once(device):
    table = torch.randn(100, 17, device=device, requires_grad=True)
    ids = torch.randint(0, 100, (64, 2), device=device, dtype=torch.int32)
    before = ek.scatter_add_rows.launches
    ek.lookup(table, ids).square().sum().backward()
    assert ek.scatter_add_rows.launches == before + 1
    want = ek.scatter_add_rows_reference(
        2 * table.detach()[ids.long()].reshape(-1, 17), ids.reshape(-1), 100
    )
    torch.testing.assert_close(table.grad, want, rtol=1e-5, atol=1e-5)


def test_scatter_add_rows_rejects_bad_inputs(device):
    g = torch.zeros(4, 3, device=device)
    with pytest.raises(TypeError):
        ek.scatter_add_rows(g, torch.zeros(4, dtype=torch.int64,
                                           device=device), 5)
    with pytest.raises(TypeError):
        ek.scatter_add_rows(g.double(), torch.zeros(4, dtype=torch.int32,
                                                    device=device), 5)


@pytest.mark.parametrize("shape", [(8192, 6, 16), (5, 3, 70), (1, 1, 1)])
def test_fm_interaction_kernel(device, shape):
    emb = torch.randn(*shape, generator=torch.Generator().manual_seed(1))
    want = fm.fm_interaction(emb)
    before = fm.fm_interaction_fused.launches
    got = fm.fm_interaction_fused(emb.to(device))
    torch.cuda.synchronize()
    assert fm.fm_interaction_fused.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-4)


def _normal(gen, *shape, std=1.0):
    return torch.randn(*shape, device=gen.device, generator=gen) * std


@pytest.mark.parametrize("r,f0,h,m", [
    (131072, 6, 128, 128),  # the layered xDeepFM's layers 1 and 2
    (131072, 6, 6, 128),  # its layer 0 (H = F0)
    (1000, 6, 20, 12),
    (37, 3, 130, 200),  # two column tiles each way, one partial row tile
])
def test_cin2d_kernel(device, r, f0, h, m):
    """K4's forward and backward at the TPU kernel's bf16 contract, each
    held against its bf16 emulation and against fp64
    (ops/cin_tolerances.py), one launch each."""
    gen = torch.Generator(device=device).manual_seed(0)
    x0 = _normal(gen, r, f0, std=0.25)
    x = _normal(gen, r, h, std=0.25)
    w = _normal(gen, f0, h, m, std=0.05)
    g = _normal(gen, r, m)
    before = dict(ck.cin2d.launches)
    out = ck.cin2d_forward(x0, x, w)
    grads = ck.cin2d_backward(x0, x, w, g)
    assert ck.cin2d.launches == {"fwd": before["fwd"] + 1,
                                 "bwd": before["bwd"] + 1}
    ct.check_cin2d_forward(out, x0, x, w)
    ct.check_cin2d_backward(grads, x0, x, w, g)


def test_cin2d_autograd_launches_both_kernels(device):
    gen = torch.Generator(device=device).manual_seed(1)
    x0, x = _normal(gen, 4096, 6), _normal(gen, 4096, 128)
    w, g = _normal(gen, 6, 128, 128, std=0.05), _normal(gen, 4096, 128)
    args = [t.clone().requires_grad_() for t in (x0, x, w)]
    before = dict(ck.cin2d.launches)
    out = ck.cin2d(*args)
    out.backward(g)
    assert ck.cin2d.launches == {"fwd": before["fwd"] + 1,
                                 "bwd": before["bwd"] + 1}
    ct.check_cin2d_forward(out.detach(), x0, x, w)
    ct.check_cin2d_backward([a.grad for a in args], x0, x, w, g)


@pytest.mark.parametrize("h", [128, 6])
def test_cin2d_backward_check_rejects_planted_faults(device, h):
    """At the layered xDeepFM's shapes, on the card: K4's backward passes,
    and its check rejects dW scaled by 1 + 1e-3, dW less one weight chunk
    of rows, and the fp32 function."""
    gen = torch.Generator(device=device).manual_seed(5)
    x0 = _normal(gen, 131072, 6, std=0.25)
    x = x0 if h == 6 else torch.relu(_normal(gen, 131072, h, std=0.25))
    w = _normal(gen, 6, h, 128, std=0.05)
    g = _normal(gen, 131072, 128)
    checks = ct.check_cin2d_backward(ck.cin2d_backward(x0, x, w, g), x0, x,
                                     w, g, planted_rows=ct.PLANTED_ROWS)
    assert set(checks["planted"]) == {"fp32", "dw_scaled_1e-3",
                                      "dw_chunk_dropped"}
    assert min(checks["planted"].values()) > 1
    assert ct.worst_share(checks) <= 1


def test_cin2d_forward_check_rejects_planted_outputs(device):
    """At the layered xDeepFM's shape, on the card: the fp32 function and
    the bf16 emulation without one f-slice both fail the forward check."""
    gen = torch.Generator(device=device).manual_seed(4)
    x0 = _normal(gen, 131072, 6, std=0.25)
    x = torch.relu(_normal(gen, 131072, 128, std=0.25))
    w = _normal(gen, 6, 128, 128, std=0.05)
    checks = ct.check_cin2d_forward(ck.cin2d_forward(x0, x, w), x0, x, w,
                                    planted=True)
    assert min(checks["bf16"]["planted"].values()) > 1
    assert ct.worst_share(checks) <= 1


@pytest.mark.parametrize("b,f0,d,m1,m2", [
    (8192, 6, 16, 128, 128),  # the flagship xDeepFM
    (16, 6, 8, 12, 20),
    (5, 6, 3, 7, 5),  # R = 15 rows
    (9, 4, 70, 130, 200),  # examples over three blocks; two column tiles
])
def test_cin_stack_kernel(device, b, f0, d, m1, m2):
    gen = torch.Generator(device=device).manual_seed(2)
    x0 = _normal(gen, b * d, f0, std=0.25).to(torch.bfloat16)
    w1 = _normal(gen, f0, f0, m1, std=0.05)
    w2 = _normal(gen, f0, m1, m2, std=0.05)
    gp1, gp2 = _normal(gen, b, m1), _normal(gen, b, m2)
    before = dict(ck.cin_stack_pooled.launches)
    got = ck.stack_forward(x0, w1, w2, d, residuals=True)
    ct.check_stack_forward(got, x0, w1, w2, d)
    bare = ck.stack_forward(x0, w1, w2, d, residuals=False)
    assert bare[2] is None and bare[3] is None
    ct.check_stack_forward(bare, x0, w1, w2, d)

    z1, z2 = got[2], got[3]
    grads = ck.stack_backward(x0, w1, w2, z1, z2, gp1, gp2)
    assert grads[0].dtype == torch.bfloat16
    ct.check_stack_backward(grads, x0, w1, w2, z1, z2, gp1, gp2)
    assert ck.cin_stack_pooled.launches == {"fwd": before["fwd"] + 2,
                                            "bwd": before["bwd"] + 1}


def test_cin_stack_backward_check_rejects_planted_faults(device):
    """At the flagship xDeepFM's shape, on the card: K3's backward passes,
    and its check rejects each dW scaled by 1 + 1e-3 and less one weight
    chunk of rows, and the fp32 function."""
    gen = torch.Generator(device=device).manual_seed(6)
    b, f0, d, m1, m2 = 8192, 6, 16, 128, 128
    x0 = _normal(gen, b * d, f0, std=0.25).to(torch.bfloat16)
    w1 = _normal(gen, f0, f0, m1, std=0.05)
    w2 = _normal(gen, f0, m1, m2, std=0.05)
    gp1, gp2 = _normal(gen, b, m1), _normal(gen, b, m2)
    _, _, z1, z2 = ck.stack_forward(x0, w1, w2, d, residuals=True)
    args = (x0, w1, w2, z1, z2, gp1, gp2)
    checks = ct.check_stack_backward(ck.stack_backward(*args), *args,
                                     planted_rows=ct.PLANTED_ROWS)
    assert len(checks["planted"]) == 5
    assert min(checks["planted"].values()) > 1
    assert ct.worst_share(checks) <= 1


def test_cin_stack_pooled_autograd_and_no_grad_launches(device):
    gen = torch.Generator(device=device).manual_seed(3)
    x0 = _normal(gen, 64 * 16, 6, std=0.25).to(torch.bfloat16)
    x0.requires_grad_()
    w1 = _normal(gen, 6, 6, 16, std=0.05).requires_grad_()
    w2 = _normal(gen, 6, 16, 24, std=0.05).requires_grad_()
    before = dict(ck.cin_stack_pooled.launches)
    p1, p2 = ck.cin_stack_pooled(x0, w1, w2, 16)
    (p1.sum() + p2.square().sum()).backward()
    with torch.no_grad():
        q1, q2 = ck.cin_stack_pooled(x0, w1, w2, 16)
    assert ck.cin_stack_pooled.launches == {"fwd": before["fwd"] + 2,
                                            "bwd": before["bwd"] + 1}
    torch.testing.assert_close(q1, p1.detach(), rtol=0, atol=0)
    assert x0.grad.dtype == torch.bfloat16 and w1.grad.shape == w1.shape
    assert bool(torch.isfinite(w2.grad).all())


@pytest.mark.parametrize("f0,h,m,fits", [
    (55, 128, 128, True),  # 256 Mp + 1024 F0 = 89088, the limit
    (56, 128, 128, False),
    (6, 128, 320, True),
    (6, 128, 321, False),  # Mp = 336
    (171, 6, 128, True),  # H <= 16: 256 Mp + 1024 F0 <= 208384
    (172, 6, 128, False),
])
def test_cin2d_backward_at_its_shared_memory_limit(device, f0, h, m, fits):
    """K4's backward runs and passes its check up to the shapes whose data
    block fits in shared memory, and refuses the next with a ValueError."""
    gen = torch.Generator(device=device).manual_seed(8)
    r = 300
    x0 = _normal(gen, r, f0, std=0.25)
    x = _normal(gen, r, h, std=0.25)
    w = _normal(gen, f0, h, m, std=0.05)
    g = _normal(gen, r, m)
    if not fits:
        with pytest.raises(ValueError, match="shared memory"):
            ck.cin2d_backward(x0, x, w, g)
        return
    ct.check_cin2d_backward(ck.cin2d_backward(x0, x, w, g), x0, x, w, g)


@pytest.mark.parametrize("f0,fits", [(55, True), (56, False)])
def test_cin_stack_backward_at_its_shared_memory_limit(device, f0, fits):
    """K3's backward at M1 = M2 = 128 runs and passes its check up to
    F0 = 55 (256 (K2p + 2 K1p) + 1024 F0 = 154624) and refuses F0 = 56."""
    gen = torch.Generator(device=device).manual_seed(9)
    b, d, m1, m2 = 20, 16, 128, 128
    x0 = _normal(gen, b * d, f0, std=0.25).to(torch.bfloat16)
    w1 = _normal(gen, f0, f0, m1, std=0.02)
    w2 = _normal(gen, f0, m1, m2, std=0.02)
    gp1, gp2 = _normal(gen, b, m1), _normal(gen, b, m2)
    _, _, z1, z2 = ck.stack_forward(x0, w1, w2, d, residuals=True)
    args = (x0, w1, w2, z1, z2, gp1, gp2)
    if not fits:
        with pytest.raises(ValueError, match="shared memory"):
            ck.stack_backward(*args)
        return
    ct.check_stack_backward(ck.stack_backward(*args), *args)


def test_cin_kernels_reject_bad_inputs(device):
    x0, x = torch.zeros(64, 6, device=device), torch.zeros(64, 8,
                                                           device=device)
    w = torch.zeros(6, 8, 4, device=device)
    with pytest.raises(TypeError):
        ck.cin2d_forward(x0.double(), x, w)
    with pytest.raises(TypeError):
        ck.cin2d_forward(x0, x, torch.zeros(6, 7, 4, device=device))
    with pytest.raises(ValueError):
        ck.cin2d_forward(x0, x, w.cpu())
    with pytest.raises(ValueError):
        ck.cin2d_forward(x0, torch.zeros(8, 64, device=device).T, w)
    with pytest.raises(TypeError):
        ck.cin2d_backward(x0, x, w, torch.zeros(64, 5, device=device))
    w1 = torch.zeros(6, 6, 4, device=device)
    w2 = torch.zeros(6, 4, 4, device=device)
    with pytest.raises(TypeError):  # the stack reads bf16 rows
        ck.stack_forward(x0, w1, w2, 16)
    with pytest.raises(ValueError):  # rows that are not whole examples
        ck.stack_forward(x0.to(torch.bfloat16), w1, w2, 10)
    z = torch.zeros(64, 4, device=device)
    with pytest.raises(TypeError):
        ck.stack_backward(x0.to(torch.bfloat16), w1, w2, z, z,
                          torch.zeros(4, 4, device=device),
                          torch.zeros(4, 5, device=device))


# -- K5 and K6 ----------------------------------------------------------------

def _attention_inputs(gen, bh, sq, sk, d):
    q, k, v = (_normal(gen, bh, s, d) for s in (sq, sk, sk))
    mask = (torch.rand(bh, sk, device=gen.device, generator=gen) < 0.8).float()
    mask[1] = 0.0  # a (bh) row with no valid key
    return q, k, v, mask


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,sq,sk,d", [
    (6, 150, 130, 16),  # ragged tiles both ways, Sq != Sk
    (6, 130, 150, 32),
    (4, 64, 200, 64),
    (4, 100, 100, 128),
    (64, 512, 512, 16),  # the Transformer slice's sequence length
])
def test_flash_attention_kernels(device, bh, sq, sk, d, causal):
    """K5 and K6 against their fp64 plain versions
    (ops/attention_tolerances.py states the tolerances), one launch each;
    the check rejects dk less one query tile."""
    gen = torch.Generator(device=device).manual_seed(4)
    q, k, v, mask = _attention_inputs(gen, bh, sq, sk, d)
    g = _normal(gen, bh, sq, d)
    before = dict(att.flash_attention.launches)
    out, lse = att.flash_attention(q, k, v, mask, causal, return_lse=True)
    grads = att.flash_attention_backward(q, k, v, mask, out, lse, g, causal)
    torch.cuda.synchronize()
    assert att.flash_attention.launches == {
        **before, "fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}
    at.check_forward((out, lse), q, k, v, mask, causal)
    checks = at.check_backward(grads, q, k, v, mask, out, lse, g, causal,
                               planted_rows=64)
    assert checks["dk"]["planted"]["query_tile_dropped"] > 1
    # The row with no valid key: out 0, lse 0, and no gradient.
    assert not out[1].any() and not lse[1].any()
    for grad in grads:
        assert not grad[1].any()


def test_flash_attention_autograd_launches_both_kernels(device):
    gen = torch.Generator(device=device).manual_seed(5)
    q, k, v, mask = _attention_inputs(gen, 16, 200, 200, 16)
    g = _normal(gen, 16, 200, 16)
    args = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(att.flash_attention.launches)
    out = att.FlashAttention.apply(*args, mask, True)
    out.backward(g)
    with torch.no_grad():
        att.FlashAttention.apply(q, k, v, mask, True)
    assert att.flash_attention.launches == {
        **before, "fwd": before["fwd"] + 2, "bwd": before["bwd"] + 1}
    # The forward is deterministic: this lse is the one the backward used.
    again, lse = att.flash_attention(q, k, v, mask, True, return_lse=True)
    assert torch.equal(again, out.detach())
    at.check_backward([a.grad for a in args], q, k, v, mask, again, lse, g,
                      True)


def test_attention_dispatch_on_the_card(device):
    """The slice's shape goes through K5 and K6 unasked; a short sequence
    goes dense, and so does dropout, with a warning above the budget."""
    gen = torch.Generator(device=device).manual_seed(6)
    before = dict(att.flash_attention.launches)
    q = _normal(gen, 2048, 512, 16).requires_grad_()
    att.attention(q, q, q, causal=True).sum().backward()
    assert att.flash_attention.launches == {
        **before, "fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}
    small = _normal(gen, 2048, 256, 16)
    att.attention(small, small, small)
    with pytest.warns(UserWarning, match="memory budget"):
        att.attention(q.detach(), q.detach(), q.detach(), dropout_rate=0.1,
                      generator=gen)
    assert att.flash_attention.launches["fwd"] == before["fwd"] + 1


def test_flash_attention_rejects_bad_inputs(device):
    q = torch.zeros(2, 8, 16, device=device)
    mask = torch.ones(2, 8, device=device)
    with pytest.raises(ValueError):  # no kernel for D = 24
        z = torch.zeros(2, 8, 24, device=device)
        att.flash_attention(z, z, z, mask)
    with pytest.raises(TypeError):
        att.flash_attention(q.double(), q.double(), q.double(), mask.double())
    with pytest.raises(ValueError):
        t = torch.zeros(2, 16, 8, device=device).transpose(1, 2)
        att.flash_attention(t, t, t, mask)
    with pytest.raises(TypeError):
        att.flash_attention(q, q, q, torch.ones(2, 7, device=device))
    with pytest.raises(ValueError):
        att.flash_attention(q, q.cpu(), q, mask)


# -- K5 and K6 in bf16 --------------------------------------------------------

def _bf16(*tensors):
    return [t.to(torch.bfloat16) for t in tensors]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,sq,sk,d", [
    (6, 150, 130, 16),  # ragged tiles both ways, Sq != Sk
    (6, 130, 150, 32),
    (4, 64, 200, 64),
    (4, 100, 100, 128),
    (64, 512, 512, 16),  # the Transformer slice's sequence length
])
def test_flash_attention_bf16_kernels(device, bh, sq, sk, d, causal):
    """The bf16 K5 and K6 against their fp64 and bf16 plain versions
    (ops/attention_tolerances.py states the tolerances), one launch each
    and no fp32 launch; the check rejects dk less one query tile."""
    gen = torch.Generator(device=device).manual_seed(7)
    q, k, v, mask = _attention_inputs(gen, bh, sq, sk, d)
    mask[2, sk // 2:] = 0.0  # post-padding: whole key tiles of padding
    q, k, v, g = _bf16(q, k, v, _normal(gen, bh, sq, d))
    before = dict(att.flash_attention.launches)
    out, lse = att.flash_attention(q, k, v, mask, causal, return_lse=True)
    grads = att.flash_attention_backward(q, k, v, mask, out, lse, g, causal)
    torch.cuda.synchronize()
    assert att.flash_attention.launches == {
        **before, "fwd_bf16": before["fwd_bf16"] + 1,
        "bwd_bf16": before["bwd_bf16"] + 1}
    at.check_forward_bf16((out, lse), q, k, v, mask, causal)
    checks = at.check_backward_bf16(grads, q, k, v, mask, out, lse, g,
                                    causal, planted_rows=64)
    assert checks["dk"]["planted"]["query_tile_dropped"] > 1
    assert not out[1].any() and not lse[1].any()
    for grad in grads:
        assert grad.dtype == torch.bfloat16 and not grad[1].any()


def test_flash_attention_bf16_autograd_and_dispatch(device):
    """bf16 operands through FlashAttention and attention(): the bf16
    kernels, gradients in bf16, the same out as the direct call."""
    gen = torch.Generator(device=device).manual_seed(8)
    q, k, v, mask = _attention_inputs(gen, 16, 200, 200, 16)
    q, k, v, g = _bf16(q, k, v, _normal(gen, 16, 200, 16))
    args = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(att.flash_attention.launches)
    out = att.FlashAttention.apply(*args, mask, True)
    out.backward(g)
    assert att.flash_attention.launches == {
        **before, "fwd_bf16": before["fwd_bf16"] + 1,
        "bwd_bf16": before["bwd_bf16"] + 1}
    again, lse = att.flash_attention(q, k, v, mask, True, return_lse=True)
    assert out.dtype == torch.bfloat16 and torch.equal(again, out.detach())
    assert all(a.grad.dtype == torch.bfloat16 for a in args)
    at.check_backward_bf16([a.grad for a in args], q, k, v, mask, again, lse,
                           g, True)
    big = _normal(gen, 2048, 512, 16).to(torch.bfloat16).requires_grad_()
    before = dict(att.flash_attention.launches)
    att.attention(big, big, big, causal=True).float().sum().backward()
    assert att.flash_attention.launches == {
        **before, "fwd_bf16": before["fwd_bf16"] + 1,
        "bwd_bf16": before["bwd_bf16"] + 1}


def test_flash_attention_bf16_rejects_other_dtypes(device):
    q = torch.zeros(2, 8, 16, device=device, dtype=torch.bfloat16)
    mask = torch.ones(2, 8, device=device)
    with pytest.raises(TypeError):  # fp16 has no kernel
        h = q.half()
        att.flash_attention(h, h, h, mask)
    with pytest.raises(TypeError):  # operands of two dtypes
        att.flash_attention(q, q.float(), q, mask)
    out, lse = att.flash_attention(q, q, q, mask, return_lse=True)
    with pytest.raises(TypeError):  # lse stays fp32
        att.flash_attention_backward(q, q, q, mask, out, lse.bfloat16(), q)
    with pytest.raises(TypeError):  # g in q's dtype
        att.flash_attention_backward(q, q, q, mask, out, lse, q.float())
    with pytest.raises(ValueError):  # the kernels copy 16-byte pieces
        shifted = torch.zeros(2 * 8 * 16 + 1, device=device,
                              dtype=torch.bfloat16)[1:].view(2, 8, 16)
        att.flash_attention(shifted, q, q, mask)
