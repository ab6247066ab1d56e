"""MMoE: multi-gate mixture-of-experts, all experts in one contraction.

Counterpart of ``deep_recommenders_tpu/models/multitask/mmoe.py``. The JAX
model runs its experts as an ``nn.vmap``'d MLP whose parameters carry a
leading expert axis (``variable_axes={"params": 0}``, ``out_axes=1``);
here :class:`StackedMLP` holds the same stacked parameters and runs every
layer for all experts as one batched ``einsum`` over (B, E, H), never a
Python loop over experts. Each task has its own softmax gate ``gate_{t}``
over the experts and its own tower ``tower_{t}``.

Expert parallelism (``expert_parallel=True``) splits the experts over the
"model" axis of the default mesh (``parallel.set_default_mesh``), where
JAX's constrains them to the ambient mesh's: each model coordinate holds
and runs its ``num_experts / n_model`` experts on the whole local batch,
the gate mixture sums the local experts' share, and one all-reduce over
"model" completes it (an identity backward, as the sharded lookup's). The
gates reach only the local experts on each process, so their cotangent is
made whole by one all-reduce over "model" in the backward (as the linear
weights beside a sharded table are), and so is that of an input that
carries a gradient. :func:`shard_expert_params` cuts a whole state dict to
a process's experts.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from deep_recommenders_torch.embedding.sharded import (
    shard_rows,
    sum_over_model,
)
from deep_recommenders_torch.models.common import (
    MLP,
    Dense,
    lecun_normal_,
    records_config,
)
from deep_recommenders_torch.parallel.mesh import check_mesh, get_default_mesh
from deep_recommenders_torch.parallel.sharding import (
    MODEL_AXIS,
    all_reduce,
    axis_index,
    axis_size,
    row_shard,
)


def expert_range(num_experts: int, n_model: int, index: int
                 ) -> Tuple[int, int]:
    """``[lo, hi)``: the experts of model coordinate ``index``; ValueError
    unless ``num_experts`` divides over the ``n_model`` processes (the
    expert axis takes no padding)."""
    if num_experts % n_model:
        raise ValueError(f"num_experts ({num_experts}) must divide over the "
                         f"model axis ({n_model})")
    size = num_experts // n_model
    return index * size, (index + 1) * size


def shard_expert_params(state: Mapping[str, torch.Tensor], mesh, *,
                        model_axis: str = MODEL_AXIS
                        ) -> Dict[str, torch.Tensor]:
    """Expert-parallel placement: a whole MMoE state dict with every
    stacked expert parameter (``experts.kernels.i``, ``experts.biases.i``)
    cut along its leading expert axis to this process's coordinate on
    ``model_axis``; the gates and towers as they are. JAX's places the
    expert subtree of a params tree on the mesh the same way."""
    from deep_recommenders_torch.convert import shard_state

    check_mesh(mesh)
    return shard_state(state, axis_size(mesh, model_axis),
                       axis_index(mesh, model_axis))


class _SumGradOverModel(torch.autograd.Function):
    """The identity; the backward sums the cotangent over the model group
    (an input replicated over "model" whose experts are split)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mesh, MODEL_AXIS), None


class StackedMLP(nn.Module):
    """``num`` MLPs of the same widths (relu hidden layers, then a linear
    ``output_dim`` layer) with stacked parameters: ``kernels.i`` (num, in,
    out), flax's (in, out) kernel under a leading axis, and ``biases.i``
    (num, out). Each kernel is lecun-normal over its own fan-in and each
    bias zero, as flax initialises every vmapped copy. Input (B, in), shared
    by all; output (B, num, output_dim)."""

    def __init__(self, num: int, in_features: int, hidden: Sequence[int],
                 output_dim: int,
                 generator: Optional[torch.Generator] = None,
                 shard: Optional[Tuple[int, int]] = None):
        super().__init__()
        widths = [in_features, *hidden, output_dim]
        self.kernels = nn.ParameterList()
        self.biases = nn.ParameterList()
        for a, b in zip(widths[:-1], widths[1:]):
            w = torch.empty(num, a, b)
            for kernel in w:
                lecun_normal_(kernel.T, generator)  # a Linear's (out, in)
            bias = torch.zeros(num, b)
            if shard is None:
                self.kernels.append(nn.Parameter(w))
                self.biases.append(nn.Parameter(bias))
            else:  # the experts [lo, hi) of ``num``, drawn as all of them
                lo, hi = shard
                self.kernels.append(row_shard(w[lo:hi].clone(), num))
                self.biases.append(row_shard(bias[lo:hi].clone(), num))

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
    it at the first call). With ``expert_parallel`` the default mesh's
    "model" coordinate holds its share of the experts (the whole set drawn
    from ``generator``, then cut), and ``experts.mesh`` is that mesh."""

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
        self.num_tasks = num_tasks
        self.mesh = get_default_mesh() if expert_parallel else None
        self.expert_lo = 0
        shard = None
        if self.mesh is not None:
            shard = expert_range(num_experts, axis_size(self.mesh, MODEL_AXIS),
                                 axis_index(self.mesh, MODEL_AXIS))
            self.expert_lo = shard[0]
        self.experts = StackedMLP(num_experts, input_dim, expert_hidden,
                                  expert_dim, generator, shard)
        for t in range(num_tasks):
            self.add_module(f"gate_{t}",
                            Dense(input_dim, num_experts, generator))
            self.add_module(f"tower_{t}",
                            MLP(expert_dim, tower_hidden, output_dim=1,
                                generator=generator))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        gates = [torch.softmax(getattr(self, f"gate_{t}")(x), dim=-1)
                 for t in range(self.num_tasks)]  # (B, E) each
        if self.mesh is None:
            expert_out = self.experts(x)  # (B, E, H)
            mixed = [torch.einsum("be,beh->bh", gate, expert_out)
                     for gate in gates]
        else:
            if x.requires_grad:
                x = _SumGradOverModel.apply(x, self.mesh)
            expert_out = self.experts(x)  # (B, E / n_model, H)
            lo = self.expert_lo
            hi = lo + expert_out.shape[1]
            # (E, T, B): the local experts' gates, their cotangent summed
            # over "model" in the backward.
            local = shard_rows(torch.stack(gates).permute(2, 0, 1), lo, hi,
                               self.mesh)
            both = sum_over_model(
                torch.einsum("etb,beh->tbh", local, expert_out), self.mesh)
            mixed = list(both)
        return [getattr(self, f"tower_{t}")(m) for t, m in enumerate(mixed)]
