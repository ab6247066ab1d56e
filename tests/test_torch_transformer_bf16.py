"""The port's bf16 Transformer (``compute_dtype=torch.bfloat16``) against
the JAX package's (``compute_dtype=jnp.bfloat16``), on the CPU, on weights
converted from flax: the Dense layers and the token embedding in bf16, the
tied loss's bf16 logits stream, the Transformer's logits (dense attention
and the flash path's bf16 plain versions), its loss and gradients, one Adam
step, and the IMDB example's ``--bf16``.

Inputs are made with numpy from a seed. Both sides round the same values
to bf16 at the same places; they sum in fp32 in other orders, so now and
then an intermediate element rounds to the other bf16 neighbour (2^-7
relative). Each tolerance says how far that carries, and sets it beside the
distance between JAX's bf16 and fp32 results, which is what a port that
kept fp32 would show.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from deep_recommenders_torch.convert import transformer_from_flax
from deep_recommenders_torch.examples import train_transformer_on_imdb as ex
from deep_recommenders_torch.models import nlp as tnlp
from deep_recommenders_torch.training import losses as tlosses
from deep_recommenders_tpu.models import nlp as jnlp
from deep_recommenders_tpu.training import losses as jlosses

torch.set_num_threads(1)

VOCAB, D, HEADS, FFN = 40, 32, 4, 64
BF16 = torch.bfloat16


def _tokens(rng, b, s):
    """Ids in [1, VOCAB), each row post-padded with 0 from a random length
    (at least 1)."""
    t = rng.integers(1, VOCAB, (b, s)).astype(np.int32)
    for i, n in enumerate(rng.integers(1, s + 1, b)):
        t[i, n:] = 0
    return t


def _seq2seq(rng, b=3, s_in=11, s_out=9):
    inp = _tokens(rng, b, s_in)
    tgt_out = _tokens(rng, b, s_out)
    tgt_in = np.concatenate([np.ones((b, 1), np.int32), tgt_out[:, :-1]], 1)
    return inp, tgt_in, tgt_out, (tgt_out != 0).astype(np.float32)


def _j_transformer(dtype=None):
    return jnlp.Transformer(vocab_size=VOCAB, model_dim=D, num_heads=HEADS,
                            num_encoder_layers=2, num_decoder_layers=2,
                            ffn_dim=FFN, dropout=0.0, compute_dtype=dtype)


def _t_transformer(params, dtype=BF16):
    model = tnlp.Transformer(VOCAB, D, HEADS, 2, 2, FFN, dropout=0.0,
                             compute_dtype=dtype)
    model.load_state_dict(transformer_from_flax(params))
    return model


def _params(rng):
    inp, tgt_in, _, _ = _seq2seq(rng)
    params = _j_transformer().init(jax.random.PRNGKey(0), jnp.asarray(inp),
                                   jnp.asarray(tgt_in))
    return jax.tree.map(np.asarray, params)


def _f32(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def test_dense_bf16_matches_flax(rng):
    """The product rounded to bf16, then the bias added in bf16: bitwise
    JAX's ``nn.Dense(dtype=bf16)`` but where the two fp32 sums of 64 exact
    products round to neighbouring bf16 values (one ulp, 2^-7)."""
    x = rng.normal(size=(5, 64)).astype(np.float32)
    j_dense = fnn.Dense(48, dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray,
                          j_dense.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    params["params"]["bias"] = rng.normal(size=48).astype(np.float32)
    want = _f32(j_dense.apply(params, jnp.asarray(x)))
    layer = tnlp.Dense(64, 48, dtype=BF16)
    layer.load_state_dict({
        "weight": torch.from_numpy(params["params"]["kernel"].T.copy()),
        "bias": torch.from_numpy(params["params"]["bias"])})
    got = layer(torch.from_numpy(x))
    assert got.dtype == BF16 and layer.weight.dtype == torch.float32
    np.testing.assert_allclose(got.float().detach().numpy(), want,
                               rtol=2**-7, atol=0)
    assert (got.float().detach().numpy() != want).mean() <= 0.01


def test_token_embedding_bf16_matches_flax(rng):
    """The lookup is the bf16 row times bf16(sqrt(dim)), rounded: bitwise
    JAX's. ``attend`` gives fp32 logits, the fp32 sum of exact products of
    bf16 values: within fp32 summation error."""
    tokens = rng.integers(0, 20, (2, 5)).astype(np.int32)
    j_emb = jnlp.TokenEmbedding(vocab_size=20, dim=16, dtype=jnp.bfloat16)
    params = jax.tree.map(np.asarray, j_emb.init(jax.random.PRNGKey(0),
                                                 jnp.asarray(tokens)))
    want = j_emb.apply(params, jnp.asarray(tokens))
    want_logits = j_emb.apply(params, want, method=jnlp.TokenEmbedding.attend)
    emb = tnlp.TokenEmbedding(20, 16, dtype=BF16)
    emb.load_state_dict(transformer_from_flax(params))
    with torch.no_grad():
        got = emb(torch.from_numpy(tokens))
        logits = emb.attend(got)
    assert got.dtype == BF16 and logits.dtype == torch.float32
    np.testing.assert_array_equal(got.float().numpy(), _f32(want))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("epsilon", [0.0, 0.1])
def test_tied_loss_bf16_matches_jax(rng, epsilon):
    """bf16 features and table: the logits rounded once to bf16 (bitwise
    JAX's here), fp32 reductions, an fp32 loss. Both sides then reduce in
    fp32 in other orders: rtol 1e-6."""
    feats = rng.normal(size=(3, 9, 32)).astype(np.float32)
    table = rng.normal(size=(40, 32)).astype(np.float32)
    targets = rng.integers(0, 40, (3, 9)).astype(np.int32)
    mask = (rng.random((3, 9)) < 0.7).astype(np.float32)
    want = jlosses.tied_smoothed_sparse_softmax_cross_entropy(
        jnp.asarray(feats).astype(jnp.bfloat16),
        jnp.asarray(table).astype(jnp.bfloat16), jnp.asarray(targets),
        epsilon=epsilon, mask=jnp.asarray(mask))
    got = tlosses.tied_smoothed_sparse_softmax_cross_entropy(
        torch.from_numpy(feats).to(BF16), torch.from_numpy(table).to(BF16),
        torch.from_numpy(targets), epsilon=epsilon,
        mask=torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_bf16_transformer_keeps_fp32_params_and_logits(rng):
    """As JAX's tests/test_mixed_precision.py:85-110: parameters and the
    returned logits stay fp32 (and finite), and so do the gradients."""
    inp, tgt_in, tgt_out, mask = _seq2seq(rng)
    model = tnlp.Transformer(VOCAB, D, HEADS, 1, 1, FFN, dropout=0.0,
                             compute_dtype=BF16,
                             generator=torch.Generator().manual_seed(0))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    logits = model(torch.from_numpy(inp), torch.from_numpy(tgt_in))
    assert logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())
    model.loss(torch.from_numpy(inp), torch.from_numpy(tgt_in),
               torch.from_numpy(tgt_out),
               mask=torch.from_numpy(mask)).backward()
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("use_flash", [None, True])
def test_bf16_transformer_logits_match_flax(rng, use_flash):
    """The bf16 logits against JAX's bf16 model (dense attention) and, as
    the yardstick, JAX's fp32 model on the same weights. Dense: the same
    roundings, bitwise in most elements; a rounding that flips carries to
    the logits as a few bf16 ulps of an activation times a table row, so
    atol 2e-2 (the logits reach about 20). With ``use_flash`` the port
    takes the bf16 K5 plain version, which rounds the unnormalised p where
    JAX's dense path rounds the weights: within half the distance between
    JAX's bf16 and fp32 logits. Both hold the port's logits nearer JAX's
    bf16 than its fp32."""
    params = _params(rng)
    inp, tgt_in, _, _ = _seq2seq(rng)
    args = [jnp.asarray(a) for a in (inp, tgt_in)]
    want = np.asarray(_j_transformer(jnp.bfloat16).apply(params, *args))
    want32 = np.asarray(_j_transformer().apply(params, *args))
    model = _t_transformer(params)
    for layer in model.modules():
        if isinstance(layer, tnlp.MultiHeadAttention):
            layer.use_flash = use_flash
    with torch.no_grad():
        got = model(torch.from_numpy(inp), torch.from_numpy(tgt_in)).numpy()
    gap = np.abs(want - want32).max()
    assert np.abs(got - want).max() <= 0.5 * gap
    if use_flash is None:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)


@pytest.mark.parametrize("epsilon", [0.0, 0.1])
def test_bf16_transformer_loss_and_grads_match_flax(rng, epsilon):
    """Transformer.loss in bf16 against JAX's: the loss to rtol 1e-4 (fp32
    reductions of nearly the same bf16 logits), each gradient to a relative
    Frobenius error of 5e-2. JAX's bf16 gradients lie about 0.3 from its
    fp32 ones here; flipped roundings of bf16 intermediates move the two
    bf16 evaluations apart by under 2%. The key projections' biases are
    left out: their exact gradient is 0 (a shift of every key by one vector
    moves a row's scores by a constant), so both sides hold rounding noise
    there."""
    params = _params(rng)
    inp, tgt_in, tgt_out, mask = _seq2seq(rng)
    j_model = _j_transformer(jnp.bfloat16)

    def j_loss(p):
        return j_model.apply(p, jnp.asarray(inp), jnp.asarray(tgt_in),
                             jnp.asarray(tgt_out), epsilon=epsilon,
                             mask=jnp.asarray(mask),
                             method=jnlp.Transformer.loss)

    want, j_grads = jax.value_and_grad(j_loss)(
        jax.tree.map(jnp.asarray, params))
    model = _t_transformer(params)
    loss = model.loss(torch.from_numpy(inp), torch.from_numpy(tgt_in),
                      torch.from_numpy(tgt_out), epsilon=epsilon,
                      mask=torch.from_numpy(mask))
    loss.backward()
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-4)
    want_grads = transformer_from_flax(jax.tree.map(np.asarray, j_grads))
    for name, p in model.named_parameters():
        if name.endswith("k_proj.bias"):
            continue
        ref = want_grads[name].numpy()
        err = np.linalg.norm(p.grad.numpy() - ref) / np.linalg.norm(ref)
        assert err < 5e-2, (name, err)


def test_bf16_adam_step_matches_optax(rng):
    """One Adam step (lr 1e-3) from the bf16 gradients of both sides.
    Adam's first step moves each weight by lr g / (|g| + eps), about
    lr sign(g): where JAX's gradient is at least a tenth of its tensor's
    rms, well above the rounding noise, the weights agree to 1e-6; every
    weight moves by at most lr, plus the rounding of the fp32 update (below
    1e-6 at these weights' size), on either side, so no two lie more than
    2 lr apart. The key projections' biases, whose exact
    gradient is 0 (see above), are held only to that bound."""
    params = _params(rng)
    inp, tgt_in, tgt_out, mask = _seq2seq(rng)
    j_model = _j_transformer(jnp.bfloat16)
    jparams = jax.tree.map(jnp.asarray, params)
    opt = optax.adam(1e-3)

    def j_loss(p):
        return j_model.apply(p, jnp.asarray(inp), jnp.asarray(tgt_in),
                             jnp.asarray(tgt_out), epsilon=0.1,
                             mask=jnp.asarray(mask),
                             method=jnlp.Transformer.loss)

    grads = jax.grad(j_loss)(jparams)
    updates, _ = opt.update(grads, opt.init(jparams), jparams)
    want = transformer_from_flax(jax.tree.map(
        np.asarray, optax.apply_updates(jparams, updates)))
    j_grads = transformer_from_flax(jax.tree.map(np.asarray, grads))
    init = transformer_from_flax(params)
    model = _t_transformer(params)
    t_opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    model.loss(torch.from_numpy(inp), torch.from_numpy(tgt_in),
               torch.from_numpy(tgt_out), epsilon=0.1,
               mask=torch.from_numpy(mask)).backward()
    t_opt.step()
    got = model.state_dict()
    for name, value in want.items():
        moved = (got[name] - init[name]).abs().max().item()
        assert moved <= 1e-3 + 1e-6, name
        if name.endswith("k_proj.bias"):
            continue
        g = j_grads[name].numpy()
        sure = np.abs(g) >= 0.1 * np.sqrt(np.mean(g**2))
        np.testing.assert_allclose(got[name].numpy()[sure],
                                   value.numpy()[sure], rtol=0, atol=1e-6,
                                   err_msg=name)


def test_bf16_example_runs_on_cpu(capsys):
    result = ex.main(["--epochs", "1", "--max-len", "32", "--model-dim",
                      "16", "--num-words", "300", "--device", "cpu",
                      "--bf16"])
    losses = result["step_losses"]
    assert len(losses) == 4000 // 64 and np.isfinite(losses).all()
    assert 0.0 <= result["history"][0]["accuracy"] <= 1.0
    assert "epoch 0: test accuracy" in capsys.readouterr().out
