"""Shared model building blocks: Dense, MLP tower, activation resolution.

Counterpart of ``deep_recommenders_tpu/models/common.py``. Dense layers
initialise as flax's ``nn.Dense`` does (lecun-normal kernels, zero biases)
and compute in its ``dtype``; "gelu" is the tanh approximation, as
``jax.nn.gelu``'s default. BatchNorm is not ported: no model of the JAX
package turns it on.
"""

from __future__ import annotations

import functools
import inspect
import math
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

Activation = Union[str, Callable[[torch.Tensor], torch.Tensor], None]


def records_config(cls):
    """Class decorator of the zoo's models: each instance keeps the
    arguments it was constructed with, bound to ``__init__``'s signature
    with the defaults filled in, as the dict ``constructor_args``. It is
    the model's config (``serving.model_io.model_config``), the counterpart
    of a flax module's dataclass fields."""
    init = cls.__init__
    signature = inspect.signature(init)

    @functools.wraps(init)
    def __init__(self, *args, **kwargs):
        bound = signature.bind(self, *args, **kwargs)
        bound.apply_defaults()
        init(self, *args, **kwargs)
        if type(self) is cls:  # a subclass records its own arguments
            self.constructor_args = dict(list(bound.arguments.items())[1:])

    cls.__init__ = __init__
    cls._records_config = True
    return cls

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


def truncated_normal_(
    tensor: torch.Tensor, std: float,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """flax's ``truncated_normal(stddev)``: a normal cut at +-2 sigma, not
    rescaled."""
    return nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class Dense(nn.Linear):
    """flax's ``nn.Dense``: lecun-normal weight, zero bias. With a compute
    ``dtype`` the input, weight and bias are cast to it and the output is in
    it: the product is rounded once (fp32 accumulation), then the bias is
    added in that dtype, as XLA does for ``nn.Dense(dtype=bf16)``. The
    parameters stay fp32. Without one, the input and the weight are
    promoted to a common dtype as flax promotes them (a bf16 input to an
    fp32 layer computes in fp32 and gives fp32)."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype
        lecun_normal_(self.weight, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            dt = torch.promote_types(x.dtype, self.weight.dtype)
            if dt == self.weight.dtype:
                return super().forward(x.to(dt))
        return x.to(dt) @ self.weight.to(dt).T + self.bias.to(dt)


class MLP(nn.Module):
    """Hidden layers with activation (+ optional dropout), then a final
    linear layer of ``output_dim`` units (omitted when output_dim is None).

    ``in_features`` is explicit: flax infers it at the first call. The
    layers are :class:`Dense` ``dense.0``, ``dense.1``, ... in the order of
    flax's ``Dense_0``, ``Dense_1``, ..., all in the compute ``dtype``
    (None: fp32), so the output is in that dtype.
    """

    def __init__(
        self,
        in_features: int,
        hidden: Sequence[int],
        output_dim: Optional[int] = 1,
        activation: Activation = "relu",
        dropout: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        widths = [in_features, *hidden]
        if output_dim is not None:
            widths.append(output_dim)
        self.num_hidden = len(hidden)
        self.dense = nn.ModuleList(
            Dense(a, b, generator, dtype)
            for a, b in zip(widths[:-1], widths[1:])
        )
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
