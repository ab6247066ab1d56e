"""Transformer encoder-decoder and the Noam schedule.

Counterpart of ``deep_recommenders_tpu/models/nlp/transformer.py``:

- sinusoidal position encodings, computed in fp32 as the JAX function does;
- position-wise FFN, and post-norm layers: x = LN(x + sublayer(x)), with
  LayerNorm eps 1e-6 as flax's (torch's default is 1e-5);
- one token embedding shared by the input embedding and the tied vocab
  projection; causal decoder self-attention; padding mask (tokens != 0);
- :meth:`Transformer.loss`, the training loss through the tied smoothed
  cross-entropy that keeps no (B, S, V) logits for backward;
- :func:`noam_schedule`, the Noam learning rate as a function of the step,
  clamped at step 1 (for ``torch.optim.lr_scheduler.LambdaLR`` with base
  lr 1.0, whose factor for the first update is that of step 0, as optax's
  first count is 0).

The Transformer's attention goes through ``ops.attention.attention``: on the
card, above the memory budget and without dropout, through the flash
kernels K5 and K6.

``compute_dtype=torch.bfloat16`` is the JAX module's mixed precision: the
embedding lookup, every projection, the FFN, attention (the bf16 K5 and K6
on the card) and the tied loss's logits run in bf16; the parameters,
LayerNorm (its input upcast, as flax's ``LayerNorm(dtype=float32)``), the
residual stream after each LayerNorm and the returned logits stay fp32.
Layer 0's stream is bf16 (the bf16 embedding plus the encodings cast to
bf16), as in JAX; a later ``x + sublayer`` adds bf16 to fp32 in fp32.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from deep_recommenders_torch.models.common import records_config
from deep_recommenders_torch.models.nlp.attention import (
    Dense,
    MultiHeadAttention,
    TokenEmbedding,
)
from deep_recommenders_torch.training.losses import (
    tied_smoothed_sparse_softmax_cross_entropy,
)

LAYER_NORM_EPS = 1e-6  # flax nn.LayerNorm's default


def position_encoding(seq_len: int, dim: int,
                      device: Optional[torch.device] = None) -> torch.Tensor:
    """Sinusoidal encodings, shape (seq_len, dim), fp32."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(dim, dtype=torch.float32, device=device)[None, :]
    angle = pos / 10000.0 ** ((2.0 * torch.floor(i / 2.0)) / dim)
    even = torch.arange(dim, device=device)[None, :] % 2 == 0
    return torch.where(even, torch.sin(angle), torch.cos(angle))


class _LayerNorm(nn.LayerNorm):
    """flax's ``LayerNorm(dtype=float32)``: eps 1e-6, statistics and output
    in fp32 whatever the input's dtype."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=LAYER_NORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())



class PositionWiseFeedForward(nn.Module):
    def __init__(self, model_dim: int, inner_dim: int,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.inner = Dense(model_dim, inner_dim, generator, dtype)
        self.outer = Dense(inner_dim, model_dim, generator, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.outer(torch.relu(self.inner(x)))


class EncoderLayer(nn.Module):
    def __init__(self, num_heads: int, model_dim: int, ffn_dim: int,
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.self_attention = MultiHeadAttention(
            num_heads, model_dim, dropout=dropout, generator=generator,
            dtype=dtype)
        self.attn_norm = _LayerNorm(model_dim)
        self.ffn = PositionWiseFeedForward(model_dim, ffn_dim, generator,
                                           dtype)
        self.ffn_norm = _LayerNorm(model_dim)

    def forward(self, x, key_mask, training: bool = False, generator=None):
        attn = self.self_attention(x, x, x, key_mask=key_mask,
                                   training=training, generator=generator)
        x = self.attn_norm(x + attn)
        return self.ffn_norm(x + self.ffn(x))


class DecoderLayer(nn.Module):
    def __init__(self, num_heads: int, model_dim: int, ffn_dim: int,
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.self_attention = MultiHeadAttention(
            num_heads, model_dim, dropout=dropout, causal=True,
            generator=generator, dtype=dtype)
        self.self_norm = _LayerNorm(model_dim)
        self.cross_attention = MultiHeadAttention(
            num_heads, model_dim, dropout=dropout, generator=generator,
            dtype=dtype)
        self.cross_norm = _LayerNorm(model_dim)
        self.ffn = PositionWiseFeedForward(model_dim, ffn_dim, generator,
                                           dtype)
        self.ffn_norm = _LayerNorm(model_dim)

    def forward(self, x, memory, self_mask, memory_mask,
                training: bool = False, generator=None):
        attn = self.self_attention(x, x, x, key_mask=self_mask,
                                   training=training, generator=generator)
        x = self.self_norm(x + attn)
        cross = self.cross_attention(x, memory, memory, key_mask=memory_mask,
                                     training=training, generator=generator)
        x = self.cross_norm(x + cross)
        return self.ffn_norm(x + self.ffn(x))


@records_config
class Transformer(nn.Module):
    """Encoder-decoder over token ids; 0 is the padding token.

    ``forward`` returns decoder logits over the vocab through the tied
    embedding projection; ``encode``/``decode`` serve encoder-only use. A
    ``generator`` draws the attention-weight dropout of training calls
    (needed when ``dropout`` > 0 and ``training``); the constructor's
    ``generator`` draws the initial weights. ``compute_dtype`` (None or
    ``torch.bfloat16``) is the mixed precision of the module docstring.
    """

    def __init__(
        self,
        vocab_size: int,
        model_dim: int = 512,
        num_heads: int = 8,
        num_encoder_layers: int = 2,
        num_decoder_layers: int = 2,
        ffn_dim: int = 2048,
        dropout: float = 0.1,
        compute_dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if compute_dtype not in (None, torch.bfloat16):
            raise ValueError(f"compute_dtype must be None (fp32) or "
                             f"torch.bfloat16, got {compute_dtype}")
        self.model_dim = model_dim
        self.compute_dtype = compute_dtype
        self.token_embedding = TokenEmbedding(vocab_size, model_dim,
                                              generator, compute_dtype)
        self.encoder_layers = nn.ModuleList(
            EncoderLayer(num_heads, model_dim, ffn_dim, dropout, generator,
                         compute_dtype)
            for _ in range(num_encoder_layers)
        )
        self.decoder_layers = nn.ModuleList(
            DecoderLayer(num_heads, model_dim, ffn_dim, dropout, generator,
                         compute_dtype)
            for _ in range(num_decoder_layers)
        )

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.token_embedding(tokens)
        pe = position_encoding(tokens.shape[1], self.model_dim, x.device)
        return x + pe[None].to(x.dtype)

    def encode(self, tokens, training: bool = False, generator=None):
        """tokens: (B, S) int ids -> ((B, S, D) memory, (B, S) mask)."""
        mask = (tokens != 0).float()
        x = self._embed(tokens)
        for layer in self.encoder_layers:
            x = layer(x, mask, training=training, generator=generator)
        return x, mask

    def decode(self, tokens, memory, memory_mask, training: bool = False,
               generator=None):
        mask = (tokens != 0).float()
        x = self._embed(tokens)
        for layer in self.decoder_layers:
            x = layer(x, memory, mask, memory_mask, training=training,
                      generator=generator)
        return x

    def forward(self, inputs, targets, training: bool = False,
                generator=None) -> torch.Tensor:
        memory, memory_mask = self.encode(inputs, training, generator)
        out = self.decode(targets, memory, memory_mask, training, generator)
        return self.token_embedding.attend(out)  # (B, St, vocab) logits

    def loss(self, inputs, targets_in, targets_out, epsilon: float = 0.0,
             training: bool = True, mask=None, generator=None):
        """The training loss: tied vocab projection and smoothed sparse CE,
        with no (B, S, V) logits kept for backward."""
        memory, memory_mask = self.encode(inputs, training, generator)
        out = self.decode(targets_in, memory, memory_mask, training,
                          generator)
        table = self.token_embedding.table
        if self.compute_dtype is not None:  # JAX transformer.py:194-197
            table = table.to(self.compute_dtype)
            out = out.to(self.compute_dtype)
        return tied_smoothed_sparse_softmax_cross_entropy(
            out, table, targets_out, epsilon=epsilon, mask=mask,
        )


def noam_schedule(model_dim: int,
                  warmup_steps: int = 4000) -> Callable[[int], float]:
    """Noam LR d^-0.5 min(step^-0.5, step warmup^-1.5), step clamped at 1."""

    def schedule(step: int) -> float:
        step = max(float(step), 1.0)
        return model_dim**-0.5 * min(step**-0.5, step * warmup_steps**-1.5)

    return schedule
