"""Graph Convolutional Network layer and node-classification model.

Counterpart of ``deep_recommenders_tpu/models/retrieval/gcn.py``: a layer
is act(A @ X @ W) with an optional bias and residual; the spectral
normalization of A lives in the dataset (``datasets/cora.py``). The
adjacency is a dense tensor, or an ``ops.sparse.SparseAdjacency`` whose
product is a gather and a row sum. The contraction order follows the
widths: X @ W first when it does not widen the columns, (A @ X) @ W
otherwise. Kernels are glorot-uniform in flax's (in, units) layout, biases
zero. No TPU kernel: the products are ``torch.matmul`` (dense) or
``index_add_`` (sparse).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from deep_recommenders_torch.models.common import (
    Activation,
    records_config,
    resolve_activation,
)


def glorot_uniform_(w: torch.Tensor,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """flax's ``glorot_uniform`` on an (in, out) kernel: U(-a, a) with
    a = sqrt(6 / (in + out))."""
    limit = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    return nn.init.uniform_(w, -limit, limit, generator=generator)


class GCNLayer(nn.Module):
    """act(A @ X @ W + b) (+ X with ``use_residual``). ``in_features`` is
    explicit: flax infers it at the first call."""

    def __init__(
        self,
        in_features: int,
        units: int,
        activation: Activation = "relu",
        use_bias: bool = True,
        use_residual: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.units = units
        self.kernel = nn.Parameter(
            glorot_uniform_(torch.empty(in_features, units), generator))
        self.bias = nn.Parameter(torch.zeros(units)) if use_bias else None
        self.act = resolve_activation(activation)
        self.use_residual = use_residual

    def forward(self, x: torch.Tensor, adjacency) -> torch.Tensor:
        if self.units <= x.shape[-1]:
            out = adjacency @ (x @ self.kernel)
        else:
            out = (adjacency @ x) @ self.kernel
        if self.bias is not None:
            out = out + self.bias
        if self.act is not None:
            out = self.act(out)
        if self.use_residual:
            if x.shape[-1] != self.units:
                raise ValueError(
                    "residual requires matching dims, got "
                    f"{x.shape[-1]} -> {self.units}"
                )
            out = out + x
        return out


@records_config
class GCN(nn.Module):
    """Stacked GCN for node classification: relu layers of ``hidden``
    widths, each followed by dropout, then a layer of ``num_classes``
    logits (softmax left to the loss). ``forward(x, adjacency, training,
    generator)``: dropout is active when ``training`` and ``dropout``, and
    draws from ``generator`` (required then). The constructor's
    ``generator`` draws the initial weights."""

    def __init__(
        self,
        in_features: int,
        hidden: Tuple[int, ...] = (16,),
        num_classes: int = 7,
        dropout: Optional[float] = 0.5,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        widths = (in_features,) + tuple(hidden)
        self.layers = nn.ModuleList(
            GCNLayer(a, b, "relu", generator=generator)
            for a, b in zip(widths[:-1], widths[1:])
        )
        self.layers.append(GCNLayer(widths[-1], num_classes, None,
                                    generator=generator))
        self.dropout = dropout

    def forward(self, x: torch.Tensor, adjacency, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        drop = bool(self.dropout) and training
        if drop and generator is None:
            raise ValueError("training with dropout needs a generator")
        for layer in self.layers[:-1]:
            x = layer(x, adjacency)
            if drop:  # inverted dropout, as flax's nn.Dropout
                keep = torch.rand(x.shape, generator=generator,
                                  device=x.device) < 1.0 - self.dropout
                x = torch.where(keep, x / (1.0 - self.dropout), 0.0)
        return self.layers[-1](x, adjacency)
