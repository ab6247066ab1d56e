"""MMoE: multi-gate mixture-of-experts, all experts in one contraction.

Counterpart of ``deep_recommenders_tpu/models/multitask/mmoe.py``. The JAX
model runs its experts as an ``nn.vmap``'d MLP whose parameters carry a
leading expert axis (``variable_axes={"params": 0}``, ``out_axes=1``);
here :class:`StackedMLP` holds the same stacked parameters and runs every
layer for all experts as one batched ``einsum`` over (B, E, H), never a
Python loop over experts. Each task has its own softmax gate ``gate_{t}``
over the experts and its own tower ``tower_{t}``.

Expert parallelism (``expert_parallel=True``, ``shard_expert_params``)
raises NotImplementedError: it is ``ROADMAP.md`` queue 1, item 2b.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from deep_recommenders_torch.models.common import (
    MLP,
    Dense,
    lecun_normal_,
    records_config,
)

_NOT_PORTED = ("expert parallelism is not ported yet (ROADMAP.md queue 1, "
               "item 2b)")


def shard_expert_params(params, mesh, *, model_axis: str = "model"):
    """Expert-parallel placement of the stacked expert parameters."""
    raise NotImplementedError(_NOT_PORTED)


class StackedMLP(nn.Module):
    """``num`` MLPs of the same widths (relu hidden layers, then a linear
    ``output_dim`` layer) with stacked parameters: ``kernels.i`` (num, in,
    out), flax's (in, out) kernel under a leading axis, and ``biases.i``
    (num, out). Each kernel is lecun-normal over its own fan-in and each
    bias zero, as flax initialises every vmapped copy. Input (B, in), shared
    by all; output (B, num, output_dim)."""

    def __init__(self, num: int, in_features: int, hidden: Sequence[int],
                 output_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = [in_features, *hidden, output_dim]
        self.kernels = nn.ParameterList()
        self.biases = nn.ParameterList()
        for a, b in zip(widths[:-1], widths[1:]):
            w = torch.empty(num, a, b)
            for kernel in w:
                lecun_normal_(kernel.T, generator)  # a Linear's (out, in)
            self.kernels.append(nn.Parameter(w))
            self.biases.append(nn.Parameter(torch.zeros(num, b)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.einsum("bx,exh->beh", x, self.kernels[0]) + self.biases[0]
        for w, b in zip(self.kernels[1:], self.biases[1:]):
            h = torch.relu(h)
            h = torch.einsum("beh,ehk->bek", h, w) + b
        return h


@records_config
class MMoE(nn.Module):
    """``forward(x)``: x (B, ``input_dim``) dense -> a list of
    ``num_tasks`` (B, 1) outputs. ``input_dim`` is explicit (flax infers
    it at the first call)."""

    def __init__(
        self,
        input_dim: int,
        num_tasks: int = 2,
        num_experts: int = 4,
        expert_hidden: Tuple[int, ...] = (256,),
        expert_dim: int = 128,
        tower_hidden: Tuple[int, ...] = (64,),
        expert_parallel: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if expert_parallel:
            raise NotImplementedError(_NOT_PORTED)
        self.num_tasks = num_tasks
        self.experts = StackedMLP(num_experts, input_dim, expert_hidden,
                                  expert_dim, generator)
        for t in range(num_tasks):
            self.add_module(f"gate_{t}",
                            Dense(input_dim, num_experts, generator))
            self.add_module(f"tower_{t}",
                            MLP(expert_dim, tower_hidden, output_dim=1,
                                generator=generator))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        expert_out = self.experts(x)  # (B, E, H)
        outputs = []
        for t in range(self.num_tasks):
            gate = torch.softmax(getattr(self, f"gate_{t}")(x), dim=-1)
            mixed = torch.einsum("be,beh->bh", gate, expert_out)
            outputs.append(getattr(self, f"tower_{t}")(mixed))
        return outputs
