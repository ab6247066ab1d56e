"""Deep Interest Network: the ActivationUnit scorer, Dice, and the DIN model.

Counterpart of ``deep_recommenders_tpu/models/ranking/din.py``. The
ActivationUnit scores every position of a user-behavior sequence against
the candidate; the scores are masked-softmaxed and pool the sequence; a
Dice tower over [interest, candidate, interest * candidate (, context)]
gives the (B, 1) logit.

Torch modules build their parameters at construction, so the widths that
flax infers at the first call are arguments here: ``dim`` of the
ActivationUnit, and DIN's ``embedding_dim`` (the width D of the behaviors
and the candidate in both modes) and ``context_dim``.

Mixed precision (``compute_dtype=torch.bfloat16``) rounds where the JAX
model rounds. Its ``einsum``s with ``preferred_element_type=float32``
return fp32 sums of bf16 products, unrounded; a torch bf16 matmul would
round its output, so :func:`_dot_f32` multiplies the bf16-rounded operands
in fp32 (each product of two bf16 values is exact in fp32). The
candidate's term ``y @ (wy - wi)`` and the tower's Dense layers compute in
bf16 and round their outputs, as JAX's. The softmax, the concat, Dice and
the last Dense stay fp32. The parameters and the logits are fp32.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from deep_recommenders_torch.embedding.engine import check_compute_dtype
from deep_recommenders_torch.models.common import (
    Dense,
    records_config,
    resolve_activation,
    truncated_normal_,
)
from deep_recommenders_torch.ops.dice import dice


def _dot_f32(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """``jnp.einsum(a.astype(dtype), b.astype(dtype),
    preferred_element_type=float32)`` for a (..., K) @ (K, N) product: the
    operands rounded to ``dtype``, the products summed in fp32."""
    return a.to(dtype).float() @ b.to(dtype).float()


def _dot_rounded(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """``a.astype(dtype) @ b.astype(dtype)``: computed in ``dtype``, so a
    bf16 result is rounded once to bf16."""
    return a.to(dtype) @ b.to(dtype)


class Dice(nn.Module):
    """Dice activation with a learnable PReLU slope ``alpha`` (``units``,),
    zero-initialised; ``normalization`` as in :func:`ops.dice.dice`."""

    def __init__(self, units: int, epsilon: float = 1e-8,
                 normalization: str = "paper"):
        super().__init__()
        self.epsilon = epsilon
        self.normalization = normalization
        self.alpha = nn.Parameter(torch.zeros(units))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dice(x, self.alpha, epsilon=self.epsilon,
                    normalization=self.normalization)


def subtract_interacter(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The canonical DIN interacter (keras Subtract equivalent)."""
    return x - y


class ActivationUnit(nn.Module):
    """Attention scorer between two embeddings of width ``dim`` -> (..., 1).

    concat [x, y, interacter(x, y)] -> Dense(units, act) -> Dense(1), with
    the flax layer's flat parameters in its layout: ``dense_kernel``
    (n * dim, units), ``dense_output`` (units, 1), ``dense_kernel_bias``
    and ``dense_output_bias`` (n = 3 with an interacter, else 2). For the
    subtract interacter scored against a sequence (x (B, T, D), y (B, D)),
    the weight split of the JAX layer: with ``dense_kernel`` cut into row
    blocks (Wx, Wy, Wi),

        concat([x, y, x - y]) @ W  ==  x @ (Wx + Wi) + y @ (Wy - Wi),

    so neither the (B, T, 3D) concat nor a tiled copy of y is built.
    """

    def __init__(
        self,
        dim: int,
        units: int,
        interacter: Optional[Callable] = None,
        use_bias: bool = True,
        activation: str = "relu",
        dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dim = dim
        self.interacter = interacter
        self.dtype = dtype
        self.act = resolve_activation(activation)
        n_parts = 2 + (interacter is not None)
        self.dense_kernel = nn.Parameter(truncated_normal_(
            torch.empty(n_parts * dim, units), 0.05, generator))
        self.dense_output = nn.Parameter(truncated_normal_(
            torch.empty(units, 1), 0.05, generator))
        if use_bias:
            self.dense_kernel_bias = nn.Parameter(torch.zeros(units))
            self.dense_output_bias = nn.Parameter(torch.zeros(1))
        else:
            self.dense_kernel_bias = self.dense_output_bias = None

    def forward(self, x: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        if y is None:
            y = x
        d = x.shape[-1]
        w1, w2 = self.dense_kernel, self.dense_output
        cdt = self.dtype or x.dtype
        if x.ndim == 3 and y.ndim == 2 \
                and self.interacter is subtract_interacter:
            wx, wy, wi = w1[:d], w1[d:2 * d], w1[2 * d:]
            h = _dot_f32(x, wx + wi, cdt) + _dot_rounded(
                y, wy - wi, cdt)[:, None, :].float()
        else:
            parts = [x, y]
            if self.interacter is not None:
                parts.append(self.interacter(x, y))
            h = _dot_f32(torch.cat(parts, dim=-1), w1, cdt)
        if self.dense_kernel_bias is not None:
            h = h + self.dense_kernel_bias
        if self.act is not None:
            h = self.act(h)
        out = _dot_f32(h, w2, cdt)
        if self.dense_output_bias is not None:
            out = out + self.dense_output_bias
        return out


@records_config
class DIN(nn.Module):
    """Full DIN head over a user-behavior sequence.

    Inputs: behavior sequence embeddings (B, T, D) and mask (B, T), the
    candidate's embedding (B, D), optional context features (B,
    ``context_dim``). Output: (B, 1) fp32 logits.

    With ``num_items`` set, DIN owns the item table (``num_items``, D),
    initialised normal(0, 1/sqrt(D)), and takes int ids ((B, T) and (B,))
    instead of vectors; the rows are gathered with plain PyTorch, as JAX
    gathers them with ``jnp.take``. ``mesh`` raises NotImplementedError
    until the port has sharding. ``compute_dtype`` is None (fp32) or
    ``torch.bfloat16`` (see the module docstring). Masked positions score
    -1e9, not -inf, so a row with no valid position gets uniform weights
    and not NaN.
    """

    def __init__(
        self,
        attention_units: int = 36,
        hidden: Tuple[int, ...] = (200, 80),
        use_dice: bool = True,
        num_items: Optional[int] = None,
        embedding_dim: int = 16,
        mesh=None,
        compute_dtype=None,
        context_dim: int = 0,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if mesh is not None:
            raise NotImplementedError("mesh sharding is not ported yet")
        self.compute_dtype = check_compute_dtype(compute_dtype)
        self.num_items = num_items
        d = embedding_dim
        if num_items is not None:
            table = torch.empty(num_items, d)
            nn.init.normal_(table, 0.0, 1.0 / math.sqrt(d),
                            generator=generator)
            self.item_table = nn.Parameter(table)
        self.unit = ActivationUnit(d, attention_units,
                                   interacter=subtract_interacter,
                                   dtype=compute_dtype, generator=generator)
        widths = [3 * d + context_dim, *hidden]
        self.dense = nn.ModuleList(
            Dense(a, b, generator, compute_dtype)
            for a, b in zip(widths[:-1], widths[1:]))
        self.dense.append(Dense(widths[-1], 1, generator))
        self.dice = nn.ModuleList(Dice(u) for u in hidden) if use_dice \
            else None

    def forward(
        self,
        behaviors: torch.Tensor,
        behavior_mask: torch.Tensor,
        candidate: torch.Tensor,
        context: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if self.num_items is not None:
            behaviors = nn.functional.embedding(behaviors, self.item_table)
            candidate = nn.functional.embedding(candidate, self.item_table)
        scores = self.unit(behaviors, candidate)[..., 0]  # (B, T)
        scores = torch.where(behavior_mask > 0, scores, -1e9)
        weights = torch.softmax(scores, dim=-1)
        cdt = self.compute_dtype or behaviors.dtype
        interest = (weights.to(cdt).float()[:, None, :]
                    @ behaviors.to(cdt).float())[:, 0]  # (B, D)
        parts = [interest, candidate, interest * candidate]
        if context is not None:
            parts.append(context)
        x = torch.cat(parts, dim=-1)
        for i, layer in enumerate(self.dense[:-1]):
            x = layer(x).float()
            x = self.dice[i](x) if self.dice is not None else torch.relu(x)
        return self.dense[-1](x)
