"""FM interaction of the PyTorch port against the JAX package.

Off the TPU, ``fm_interaction_pallas`` is the jnp expression, and the port's
``fm_interaction_fused`` on a CPU tensor is its plain ``fm_interaction``.
Both accumulate in fp32 in the same order up to XLA's and ATen's reduction
trees, hence rtol 1e-5 (with atol for rows whose two terms cancel).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_recommenders_torch.ops import fm as t_fm
from deep_recommenders_tpu.ops import fm as j_fm

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(64, 6, 16), (37, 5, 7), (3, 1, 40)])
def test_fm_interaction_matches_jax(rng, shape):
    emb = rng.normal(0, 1, shape).astype(np.float32)
    want = np.asarray(j_fm.fm_interaction(jnp.asarray(emb)))
    want_pallas = np.asarray(j_fm.fm_interaction_pallas(jnp.asarray(emb)))
    x = torch.from_numpy(emb)
    for got in (t_fm.fm_interaction(x), t_fm.fm_interaction_fused(x)):
        assert got.shape == (shape[0], 1) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), want_pallas, rtol=1e-5,
                                   atol=1e-5)


def test_fm_interaction_bf16_input_accumulates_in_fp32(rng):
    emb = rng.normal(0, 1, (16, 6, 16)).astype(np.float32)
    emb_bf16 = jnp.asarray(emb, jnp.bfloat16)
    want = np.asarray(j_fm.fm_interaction(emb_bf16))
    got = t_fm.fm_interaction(torch.from_numpy(emb).to(torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
