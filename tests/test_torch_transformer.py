"""The port's Transformer slice against the JAX package's, on the CPU, on
weights converted from flax: token embedding, position encoding,
multi-head attention (dense, and through the flash path's plain versions),
the Transformer's logits and fused loss, three Adam steps under the Noam
schedule, the losses, SyntheticImdb, and the IMDB example's classifier.

Inputs are made with numpy from a seed. Tolerances: both sides compute in
fp32 in different orders; activations and logits agree to rtol 1e-5 and an
atol of 1e-5 times their scale (the tied logits are sums over the model
width of unit-scale terms, so atol 1e-4 there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from deep_recommenders_torch.convert import (
    transformer_classifier_from_flax,
    transformer_from_flax,
)
from deep_recommenders_torch.datasets import SyntheticImdb as TImdb
from deep_recommenders_torch.examples import train_transformer_on_imdb as ex
from deep_recommenders_torch.models import nlp as tnlp
from deep_recommenders_torch.ops import attention as tatt
from deep_recommenders_torch.training import losses as tlosses
from deep_recommenders_tpu.datasets.imdb import SyntheticImdb as JImdb
from deep_recommenders_tpu.models import nlp as jnlp
from deep_recommenders_tpu.training import losses as jlosses

torch.set_num_threads(1)

VOCAB, D, HEADS, FFN = 40, 32, 4, 64


def _tokens(rng, b, s, pad_from=None):
    """Ids in [1, VOCAB) with each row padded with 0 from a random length
    (at least 1); ``pad_from`` pads one row from position 0 of its own."""
    t = rng.integers(1, VOCAB, (b, s)).astype(np.int32)
    lengths = rng.integers(1, s + 1, b)
    for i, n in enumerate(lengths):
        t[i, n:] = 0
    if pad_from is not None:
        t[pad_from] = 0  # a row of padding only
    return t


def _j_transformer(**kw):
    return jnlp.Transformer(vocab_size=VOCAB, model_dim=D, num_heads=HEADS,
                            num_encoder_layers=2, num_decoder_layers=2,
                            ffn_dim=FFN, dropout=0.0, **kw)


def _t_transformer(params):
    model = tnlp.Transformer(vocab_size=VOCAB, model_dim=D, num_heads=HEADS,
                             num_encoder_layers=2, num_decoder_layers=2,
                             ffn_dim=FFN, dropout=0.0)
    model.load_state_dict(transformer_from_flax(params))
    return model


def _seq2seq(rng, b=3, s_in=11, s_out=9):
    inp = _tokens(rng, b, s_in)
    tgt_out = _tokens(rng, b, s_out)
    tgt_in = np.concatenate([np.ones((b, 1), np.int32), tgt_out[:, :-1]], 1)
    return inp, tgt_in, tgt_out


def _flax(model, *args):
    params = model.init(jax.random.PRNGKey(0),
                        *[jnp.asarray(a) for a in args])
    return jax.tree.map(np.asarray, params)


def test_token_embedding_lookup_and_attend(rng):
    tokens = rng.integers(0, 20, (2, 5)).astype(np.int32)
    j_emb = jnlp.TokenEmbedding(vocab_size=20, dim=16)
    params = _flax(j_emb, tokens)
    want = j_emb.apply(params, jnp.asarray(tokens))
    want_logits = j_emb.apply(params, want, method=jnlp.TokenEmbedding.attend)
    emb = tnlp.TokenEmbedding(20, 16)
    emb.load_state_dict(transformer_from_flax(params))
    with torch.no_grad():
        got = emb(torch.from_numpy(tokens))
        logits = emb.attend(got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-5, atol=1e-4)
    assert logits.dtype == torch.float32
    # A fresh table is normal(1.0), as flax's initializer.
    fresh = tnlp.TokenEmbedding(2000, 64,
                                generator=torch.Generator().manual_seed(0))
    assert abs(fresh.table.std().item() - 1.0) < 0.02


def test_position_encoding_matches_jax():
    want = np.asarray(jnlp.position_encoding(64, 16))
    got = tnlp.position_encoding(64, 16).numpy()
    # sin and cos of angles up to 63 rad, from fp32 powers that may differ
    # by an ulp: about 63 * 2^-24 apart at most.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("use_flash", [None, True])
@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_matches_flax(rng, causal, use_flash):
    """With use_flash=True the port goes through FlashAttention (K5/K6's
    plain versions on the CPU), against JAX's dense path."""
    b, sq, sk = 2, 12, 15
    x = rng.normal(size=(b, sq, D)).astype(np.float32)
    mem = rng.normal(size=(b, sk, D)).astype(np.float32)
    mask = np.ones((b, sk), np.float32)
    mask[0, 9:] = 0.0
    mask[1, :] = 0.0  # an example with no valid key
    j_mha = jnlp.MultiHeadAttention(num_heads=HEADS, model_dim=D,
                                    causal=causal)
    params = _flax(j_mha, x, mem, mem)
    want = j_mha.apply(params, jnp.asarray(x), jnp.asarray(mem),
                       jnp.asarray(mem), key_mask=jnp.asarray(mask))
    mha = tnlp.MultiHeadAttention(HEADS, D, causal=causal,
                                  use_flash=use_flash)
    mha.load_state_dict(transformer_from_flax(params))
    xt = torch.from_numpy(x).requires_grad_()
    got = mha(xt, torch.from_numpy(mem), torch.from_numpy(mem),
              key_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    got.square().sum().backward()  # both paths differentiate
    assert bool(torch.isfinite(xt.grad).all())


def test_key_mask_repeats_per_head(rng):
    """The (B, Sk) mask becomes (B * H, Sk) with row b * H + h = example b:
    the head layout (B, S, H, Dh) -> (B, H, S, Dh) -> (B * H, S, Dh)."""
    mask = torch.tensor([[1.0, 0.0, 1.0], [0.0, 1.0, 1.0]])
    seen = {}

    def spy(q, k, v, key_mask=None, **kw):
        seen["mask"] = key_mask
        return tatt.scaled_dot_product_attention(q, k, v, key_mask,
                                                 kw["causal"])

    mha = tnlp.MultiHeadAttention(2, 8)
    orig = tnlp.attention.attention
    try:
        tnlp.attention.attention = spy
        mha(torch.zeros(2, 4, 8), torch.zeros(2, 3, 8), torch.zeros(2, 3, 8),
            key_mask=mask)
    finally:
        tnlp.attention.attention = orig
    torch.testing.assert_close(seen["mask"], torch.tensor(
        [[1.0, 0.0, 1.0], [1.0, 0.0, 1.0], [0.0, 1.0, 1.0], [0.0, 1.0, 1.0]]))


def test_transformer_logits_match_flax(rng):
    inp, tgt_in, _ = _seq2seq(rng)
    j_model = _j_transformer()
    params = _flax(j_model, inp, tgt_in)
    want = j_model.apply(params, jnp.asarray(inp), jnp.asarray(tgt_in))
    model = _t_transformer(params)
    with torch.no_grad():
        got = model(torch.from_numpy(inp), torch.from_numpy(tgt_in))
    assert got.shape == (3, 9, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("epsilon", [0.0, 0.1])
def test_transformer_loss_and_grads_match_flax(rng, epsilon):
    inp, tgt_in, tgt_out = _seq2seq(rng)
    mask = (tgt_out != 0).astype(np.float32)
    j_model = _j_transformer()
    params = _flax(j_model, inp, tgt_in)

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
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    want_grads = transformer_from_flax(jax.tree.map(np.asarray, j_grads))
    # Gradients are of unit scale and sum many terms; elements that cancel
    # to near 0 keep an absolute error of that scale times fp32 rounding.
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_adam_noam_three_steps_match_optax(rng):
    """optax reads the schedule at counts 0, 1, 2 and noam clamps the step
    at 1, so the first two updates both use noam(1); LambdaLR(noam) gives
    the same factors. After three steps of about lr = 5.6e-3 each, weights
    agree to atol 1e-4, under 2% of one step: gradients agree to fp32
    rounding, which Adam's normalised step amplifies where a gradient
    element is small, while a wrong schedule factor or an off-by-one in the
    Noam count would move every weight by about lr.

    The key projections' biases are the exception. Their exact gradient is
    0 (adding one vector to every key shifts a row's scores by a constant,
    which the softmax ignores), so each side's gradient is rounding noise
    and Adam's normalised step turns it into a move of up to about lr in
    either direction. Those are held only to that bound: both sides move
    them by less than 3.2 lr per step (Adam's largest step in the first
    steps, lr (1 - b1) / sqrt(1 - b2))."""
    inp, tgt_in, tgt_out = _seq2seq(rng)
    mask = (tgt_out != 0).astype(np.float32)
    j_model = _j_transformer()
    params = jax.tree.map(jnp.asarray, _flax(j_model, inp, tgt_in))
    opt = optax.adam(jnlp.noam_schedule(D, warmup_steps=10))
    opt_state = opt.init(params)
    args = [jnp.asarray(a) for a in (inp, tgt_in, tgt_out)]

    def j_loss(p):
        return j_model.apply(p, *args, epsilon=0.1, mask=jnp.asarray(mask),
                             method=jnlp.Transformer.loss)

    init = transformer_from_flax(jax.tree.map(np.asarray, params))
    model = _t_transformer(jax.tree.map(np.asarray, params))
    t_opt = torch.optim.Adam(model.parameters(), lr=1.0)
    sched = torch.optim.lr_scheduler.LambdaLR(
        t_opt, tnlp.noam_schedule(D, warmup_steps=10))
    targs = [torch.from_numpy(a) for a in (inp, tgt_in, tgt_out)]
    moved = 0.0
    for step in range(3):
        moved += 3.2 * tnlp.noam_schedule(D, warmup_steps=10)(step)
        grads = jax.grad(j_loss)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        t_opt.zero_grad()
        model.loss(*targs, epsilon=0.1,
                   mask=torch.from_numpy(mask)).backward()
        t_opt.step()
        sched.step()
    want = transformer_from_flax(jax.tree.map(np.asarray, params))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        if name.endswith("k_proj.bias"):
            for side in (got[name], value):
                assert (side - init[name]).abs().max().item() < moved, name
            continue
        np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                   rtol=0, atol=1e-4, err_msg=name)


def test_noam_schedule_matches_jax():
    j_sched = jnlp.noam_schedule(128, warmup_steps=100)
    t_sched = tnlp.noam_schedule(128, warmup_steps=100)
    for step in (0, 1, 2, 50, 100, 101, 1000):
        np.testing.assert_allclose(t_sched(step),
                                   float(j_sched(jnp.asarray(step))),
                                   rtol=1e-6)


def test_losses_match_jax(rng):
    logits = rng.normal(size=(3, 5, 11)).astype(np.float32) * 3
    targets = rng.integers(0, 11, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) < 0.7).astype(np.float32)
    labels = np.array(jax.nn.one_hot(targets, 11))
    tl, tt, tm, tlab = [torch.from_numpy(a)
                        for a in (logits, targets, mask, labels)]
    smoothed = np.asarray(jlosses.label_smoothing(jnp.asarray(labels), 0.1))
    np.testing.assert_allclose(tlosses.label_smoothing(tlab, 0.1).numpy(),
                               smoothed, rtol=1e-6)
    for reduction in ("mean", "sum", "none"):
        for m, tmask in ((None, None), (jnp.asarray(mask), tm)):
            want = jlosses.softmax_cross_entropy(
                jnp.asarray(logits), jnp.asarray(smoothed), reduction, m)
            got = tlosses.softmax_cross_entropy(
                tl, torch.from_numpy(smoothed), reduction, tmask)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)
            want = jlosses.smoothed_sparse_softmax_cross_entropy(
                jnp.asarray(logits), jnp.asarray(targets), 0.1, reduction, m)
            got = tlosses.smoothed_sparse_softmax_cross_entropy(
                tl, tt, 0.1, reduction, tmask)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)


def test_tied_loss_keeps_no_vocab_sized_tensor(rng):
    """The tied loss saves nothing of the (B, S, V) logits for backward:
    only its inputs, whose sizes do not grow with V."""
    feats = torch.from_numpy(rng.normal(size=(4, 6, 8)).astype(np.float32))
    feats.requires_grad_()
    table = torch.from_numpy(
        rng.normal(size=(500, 8)).astype(np.float32)).requires_grad_()
    targets = torch.from_numpy(rng.integers(0, 500, (4, 6)))
    sizes = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: sizes.append(t.numel()) or t, lambda t: t):
        loss = tlosses.tied_smoothed_sparse_softmax_cross_entropy(
            feats, table, targets, epsilon=0.1)
    assert max(sizes) < 4 * 6 * 500
    loss.backward()
    want = tlosses.smoothed_sparse_softmax_cross_entropy(
        feats.detach() @ table.detach().T, targets, epsilon=0.1)
    torch.testing.assert_close(loss.detach(), want)


def test_synthetic_imdb_matches_jax():
    kw = dict(num_examples=300, num_words=500, max_len=40, seed=7)
    j, t = JImdb(**kw), TImdb(**kw)
    for a, b in zip(j.train + j.test, t.train + t.test):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    for (xa, ya), (xb, yb) in zip(j.batches("train", 32, 2, 3),
                                  t.batches("train", 32, 2, 3)):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


class _JClassifier(fnn.Module):
    """The JAX example's TransformerClassifier (examples/ is a script)."""

    vocab_size: int
    model_dim: int = 16
    num_heads: int = 4
    num_layers: int = 2

    def setup(self):
        self.transformer = jnlp.Transformer(
            vocab_size=self.vocab_size, model_dim=self.model_dim,
            num_heads=self.num_heads, num_encoder_layers=self.num_layers,
            num_decoder_layers=0, ffn_dim=self.model_dim * 4, dropout=0.0)
        self.head = fnn.Dense(2)

    def __call__(self, tokens, training: bool = False):
        memory, mask = self.transformer.encode(tokens, training=training)
        denom = jnp.maximum(mask.sum(-1, keepdims=True), 1.0)
        pooled = (memory * mask[..., None]).sum(1) / denom
        return self.head(pooled)


def test_classifier_logits_match_flax(rng):
    tokens = _tokens(rng, 4, 13, pad_from=2)
    j_model = _JClassifier(vocab_size=VOCAB)
    params = _flax(j_model, tokens)
    want = j_model.apply(params, jnp.asarray(tokens))
    model = ex.TransformerClassifier(VOCAB, model_dim=16, num_heads=4)
    model.load_state_dict(transformer_classifier_from_flax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_compute_dtype_raises():
    """bf16 is ported (tests/test_torch_transformer_bf16.py); any dtype but
    fp32 and bf16 raises."""
    with pytest.raises(ValueError):
        tnlp.Transformer(VOCAB, D, HEADS, compute_dtype=torch.float16)


def test_imdb_example_runs_on_cpu(capsys):
    result = ex.main(["--epochs", "1", "--max-len", "32", "--model-dim",
                      "16", "--num-words", "300", "--device", "cpu"])
    losses = result["step_losses"]
    assert len(losses) == 4000 // 64 and np.isfinite(losses).all()
    assert 0.0 <= result["history"][0]["accuracy"] <= 1.0
    assert "epoch 0: test accuracy" in capsys.readouterr().out
