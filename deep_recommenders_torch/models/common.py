"""Shared model building blocks: MLP tower, activation resolution.

Counterpart of ``deep_recommenders_tpu/models/common.py``. Dense layers
initialise as flax's ``nn.Dense`` does (lecun-normal kernels, zero biases),
and "gelu" is the tanh approximation, as ``jax.nn.gelu``'s default.
BatchNorm is not ported: no model of the JAX package turns it on.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

Activation = Union[str, Callable[[torch.Tensor], torch.Tensor], None]

_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "gelu": functools.partial(F.gelu, approximate="tanh"),
    "softmax": functools.partial(torch.softmax, dim=-1),
    "linear": None,
    "none": None,
}


def resolve_activation(act: Activation) -> Optional[Callable]:
    if act is None or callable(act):
        return act
    if act not in _ACTIVATIONS:
        raise ValueError(f"Unknown activation {act!r}")
    return _ACTIVATIONS[act]


def lecun_normal_(
    weight: torch.Tensor, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """flax's ``lecun_normal``: truncated normal at +-2 sigma, variance
    1/fan_in after truncation. ``weight`` is a Linear (out, in) weight."""
    # 0.8796... is the std of a standard normal truncated to [-2, 2].
    std = math.sqrt(1.0 / weight.shape[1]) / 0.87962566103423978
    return nn.init.trunc_normal_(
        weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator
    )


class MLP(nn.Module):
    """Hidden layers with activation (+ optional dropout), then a final
    linear layer of ``output_dim`` units (omitted when output_dim is None).

    ``in_features`` is explicit: flax infers it at the first call. The
    layers are ``dense.0``, ``dense.1``, ... in the order of flax's
    ``Dense_0``, ``Dense_1``, ...
    """

    def __init__(
        self,
        in_features: int,
        hidden: Sequence[int],
        output_dim: Optional[int] = 1,
        activation: Activation = "relu",
        dropout: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        widths = [in_features, *hidden]
        if output_dim is not None:
            widths.append(output_dim)
        self.num_hidden = len(hidden)
        self.dense = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:])
        )
        for layer in self.dense:
            lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)
        self.act = resolve_activation(activation)
        self.drop = nn.Dropout(dropout) if dropout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.dense):
            x = layer(x)
            if i < self.num_hidden:
                if self.act is not None:
                    x = self.act(x)
                if self.drop is not None:
                    x = self.drop(x)
        return x
