"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present. This file
imports neither JAX nor the JAX package, so it runs on the card alone (see
README, "PyTorch port"). The tolerances follow the fp32 summation bound:
atomics and the reference sum each output in different orders.
"""

import numpy as np
import pytest
import torch

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
