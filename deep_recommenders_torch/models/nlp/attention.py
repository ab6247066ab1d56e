"""Token embedding and multi-head attention.

Counterpart of ``deep_recommenders_tpu/models/nlp/attention.py``:

- :class:`Dense` (``models/common.py``, shared with the ranking models):
  flax's ``nn.Dense`` as a Linear layer, with its compute ``dtype``.
- :class:`TokenEmbedding`: a normal(1.0) table; a lookup is scaled by
  sqrt(dim), and :meth:`TokenEmbedding.attend` is the tied pre-softmax
  projection onto the unscaled table, returning fp32 logits.
- :class:`MultiHeadAttention`: separate Q, K, V projections and an output
  projection (:class:`Dense` layers). Heads are
  folded into the batch as the JAX module folds them, (B, S, H, Dh) ->
  (B, H, S, Dh) -> (B * H, S, Dh), and the key mask is repeated per head
  with ``repeat_interleave``, so row b * H + h of the mask is example b's.
  The score path is ``ops.attention.attention``: the flash kernels K5/K6 on
  the card above the memory budget, dense SDPA otherwise.

With a compute ``dtype`` (bf16 mixed precision, as the JAX modules' ``dtype``)
the parameters stay fp32; lookups, projections and attention run in that
dtype, and ``attend`` returns fp32 logits of the bf16 operands.

Dropout is applied to the softmax weights inside the dense path and needs
an explicit ``generator`` when active, as the JAX module needs a
``dropout`` rng; the flash kernels never hold the weight matrix, so the
dispatch sends dropout-active calls dense.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from deep_recommenders_torch.models.common import Dense
from deep_recommenders_torch.ops.attention import attention


class TokenEmbedding(nn.Module):
    def __init__(self, vocab_size: int, dim: int,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dim = dim
        self.compute_dtype = dtype
        self.table = nn.Parameter(torch.empty(vocab_size, dim))
        nn.init.normal_(self.table, 0.0, 1.0, generator=generator)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        # F.embedding, not table[ids]: on the card the indexing backward
        # serialises on repeated ids (Zipfian tokens repeat a great deal),
        # where embedding's backward sums sorted segments.
        dt = self.compute_dtype
        if dt is None:
            return F.embedding(token_ids, self.table) * math.sqrt(self.dim)
        # Rows of the cast table times sqrt(dim) rounded to the dtype, the
        # product in the dtype, as JAX's (attention.py:45-49).
        scale = torch.tensor(math.sqrt(self.dim), dtype=dt,
                             device=self.table.device)
        return F.embedding(token_ids, self.table.to(dt)) * scale

    def attend(self, embeddings: torch.Tensor) -> torch.Tensor:
        """Tied pre-softmax projection: fp32 logits over the vocab with the
        same table. With a compute dtype, the fp32 product of the operands
        rounded to it (JAX's ``preferred_element_type=float32``: the
        product of two bf16 values is exact in fp32)."""
        dt = self.compute_dtype
        if dt is None:
            return embeddings @ self.table.T
        return embeddings.to(dt).float() @ self.table.to(dt).float().T


class MultiHeadAttention(nn.Module):
    """``use_flash`` is ``attention()``'s: None dispatches by the memory
    budget, True forces the flash kernels, False the dense path. ``dtype``
    is the projections' and attention's compute dtype (None: the
    input's)."""

    def __init__(
        self,
        num_heads: int,
        model_dim: int,
        dropout: float = 0.0,
        causal: bool = False,
        use_flash: Optional[bool] = None,
        generator: Optional[torch.Generator] = None,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if model_dim % num_heads != 0:
            raise ValueError(
                f"model_dim {model_dim} not divisible by num_heads "
                f"{num_heads}"
            )
        self.num_heads = num_heads
        self.model_dim = model_dim
        self.dropout = dropout
        self.causal = causal
        self.use_flash = use_flash
        self.q_proj = Dense(model_dim, model_dim, generator, dtype)
        self.k_proj = Dense(model_dim, model_dim, generator, dtype)
        self.v_proj = Dense(model_dim, model_dim, generator, dtype)
        self.out_proj = Dense(model_dim, model_dim, generator, dtype)

    def forward(
        self,
        queries: torch.Tensor,
        keys: torch.Tensor,
        values: torch.Tensor,
        key_mask: Optional[torch.Tensor] = None,
        training: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """queries: (B, Sq, D); keys/values: (B, Sk, D); key_mask: (B, Sk)
        with 1 = valid token. ``generator`` draws the weight dropout when
        ``training`` and ``dropout`` > 0."""
        b, sq, _ = queries.shape
        sk = keys.shape[1]
        h, dh = self.num_heads, self.model_dim // self.num_heads

        def split_heads(x, s):
            return x.reshape(b, s, h, dh).transpose(1, 2).reshape(b * h, s, dh)

        q = split_heads(self.q_proj(queries), sq)
        k = split_heads(self.k_proj(keys), sk)
        v = split_heads(self.v_proj(values), sk)
        mask_bh = None
        if key_mask is not None:
            mask_bh = key_mask.repeat_interleave(h, dim=0)  # (B * H, Sk)
        drop_active = bool(self.dropout) and training
        if drop_active and generator is None:
            raise ValueError("training with dropout needs a generator")
        out = attention(
            q, k, v, key_mask=mask_bh, causal=self.causal,
            use_flash=self.use_flash,
            dropout_rate=self.dropout if drop_active else 0.0,
            generator=generator if drop_active else None,
        )
        out = out.reshape(b, h, sq, dh).transpose(1, 2).reshape(
            b, sq, self.model_dim)
        return self.out_proj(out)
