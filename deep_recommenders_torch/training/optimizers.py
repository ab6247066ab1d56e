"""Optimizers: FTRL-Proximal, optax's Adagrad, Adam with optax's order on
bf16 parameters, and one optimizer per parameter scope.

Counterpart of ``deep_recommenders_tpu/training/optimizers.py``. PyTorch has
no FTRL, so :class:`Ftrl` is the FTRL-Proximal update (McMahan et al.
2013) with tf.train.FtrlOptimizer's arguments, as JAX's ``ftrl``.
:class:`Adagrad` is ``optax.adagrad``, which the two-tower example trains
with: ``torch.optim.Adagrad`` starts its accumulator at 0 and divides by
``sqrt(acc) + eps``, another optimizer. :class:`Adam` is
``torch.optim.Adam`` on full-precision parameters and ``optax.adam``'s
sequence of bf16 roundings on a bf16 parameter (a table stored in bf16),
where torch's own order moves many elements by one bf16 ulp or more.
:func:`scoped_optimizer` is the per-scope split of JAX's
``optax.multi_transform`` over parameter paths (FTRL on ``wide``, Adam
elsewhere, in the Wide & Deep example).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch


class Ftrl(torch.optim.Optimizer):
    """FTRL-Proximal at ``learning_rate_power=-0.5`` (any other power raises
    NotImplementedError). Per element, with gradient g, weight w, and state
    z, n (zeros at first)::

        n' = n + g^2
        z' = z + g - (sqrt(n') - sqrt(n)) / lr * w
        w' = 0 if |z'| <= l1 else -(z' - sign(z') l1) / ((beta + sqrt(n'))
             / lr + l2)

    applied as ``w + (w' - w)``, the update JAX adds to the parameter, so
    the fp32 roundings match. The L1 term sets weights to exactly 0.
    """

    def __init__(self, params, learning_rate: float = 0.1,
                 learning_rate_power: float = -0.5,
                 l1_regularization_strength: float = 0.0,
                 l2_regularization_strength: float = 0.0,
                 beta: float = 1.0):
        if learning_rate_power != -0.5:
            raise NotImplementedError(
                "Only learning_rate_power=-0.5 supported")
        super().__init__(params, dict(
            lr=learning_rate, l1=l1_regularization_strength,
            l2=l2_regularization_strength, beta=beta))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, l1, l2, beta = (group[k] for k in ("lr", "l1", "l2", "beta"))
            for w in group["params"]:
                if w.grad is None:
                    continue
                g = w.grad
                state = self.state[w]
                if not state:
                    state["z"] = torch.zeros_like(w)
                    state["n"] = torch.zeros_like(w)
                z, n = state["z"], state["n"]
                n_new = n + g * g
                z.copy_(z + g - (n_new.sqrt() - n.sqrt()) / lr * w)
                n.copy_(n_new)
                denom = (beta + n.sqrt()) / lr + l2
                w_new = torch.where(z.abs() <= l1, torch.zeros_like(z),
                                    -(z - z.sign() * l1) / denom)
                w.add_(w_new - w)
        return loss


class Adagrad(torch.optim.Optimizer):
    """``optax.adagrad(learning_rate, initial_accumulator_value, eps)``. Per
    element, with gradient g and accumulator a (``initial_accumulator_value``
    at first)::

        a' = g^2 + a
        w' = w + (-lr) * (g * (rsqrt(a' + eps) if a' > 0 else 0))

    in optax's order of fp32 operations. The accumulator is the state
    ``sum_of_squares``, saved by ``state_dict``.
    """

    def __init__(self, params, learning_rate: float,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, dict(
            lr=learning_rate,
            initial_accumulator_value=initial_accumulator_value, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, eps = group["lr"], group["eps"]
            for w in group["params"]:
                if w.grad is None:
                    continue
                state = self.state[w]
                if not state:
                    state["sum_of_squares"] = torch.full_like(
                        w, group["initial_accumulator_value"])
                acc = state["sum_of_squares"]
                acc.copy_(w.grad * w.grad + acc)
                scale = torch.where(acc > 0, torch.rsqrt(acc + eps),
                                    torch.zeros_like(acc))
                w.add_((scale * w.grad) * -lr)
        return loss


class Adam(torch.optim.Adam):
    """``torch.optim.Adam`` on fp32 parameters; ``optax.adam(lr, b1, b2,
    eps)`` operation for operation on bf16 ones.

    optax keeps a bf16 parameter's moments in bf16 and rounds every
    operation to bf16, its constants too (b2 = 0.999 becomes 1.0); torch
    folds the bias corrections into the step size and the denominator, so
    in bf16 an element's update rounds differently, by one ulp or more.
    Per element of a bf16 parameter, with each constant c rounded to bf16
    (``c~``) and every operation rounded to bf16::

        m' = (1 - b1)~ * g + b1~ * m
        v' = (1 - b2)~ * (g * g) + b2~ * v
        c1 = bf16(1 - b1^t), c2 = bf16(1 - b2^t)   (fp32 powers, t = step)
        u  = (m' / c1) / (sqrt(v' / c2) + eps~)
        p' = p + (-lr)~ * u

    The state keeps torch's names (``step``, ``exp_avg``,
    ``exp_avg_sq``), so ``state_dict`` and the checkpoints read it as
    torch's.
    """

    def __init__(self, params, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, lr=lr, betas=betas, eps=eps)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        # torch's own step over the fp32 parameters alone (its foreach or
        # fused implementation, bit for bit torch.optim.Adam), then optax's
        # order over the bf16 ones.
        groups = [g["params"] for g in self.param_groups]
        try:
            for group, params in zip(self.param_groups, groups):
                group["params"] = [p for p in params
                                   if p.dtype != torch.bfloat16]
            super().step()
        finally:
            for group, params in zip(self.param_groups, groups):
                group["params"] = params
        for group in self.param_groups:
            for p in group["params"]:
                if p.dtype == torch.bfloat16 and p.grad is not None:
                    self._optax_step(p, group)
        return loss

    def _optax_step(self, p: torch.Tensor, group) -> None:
        b1, b2 = group["betas"]
        state = self.state[p]
        if not state:
            state["step"] = torch.tensor(0.0)
            state["exp_avg"] = torch.zeros_like(p)
            state["exp_avg_sq"] = torch.zeros_like(p)
        state["step"] += 1

        def c(x):  # a constant of optax's in fp32, then the parameter's
            # dtype; made on the device, so the step copies nothing to it
            return torch.full((), x, dtype=torch.float32,
                              device=p.device).to(p.dtype)

        def correction(beta):
            t = np.float32(state["step"].item())
            return c(np.float32(1) - np.float32(beta) ** t)

        g, m, v = p.grad, state["exp_avg"], state["exp_avg_sq"]
        m.copy_(c(1 - b1) * g + c(b1) * m)
        v.copy_(c(1 - b2) * (g * g) + c(b2) * v)
        u = (m / correction(b1)) / (
            (v / correction(b2)).sqrt() + c(group["eps"]))
        p.copy_(p + c(-group["lr"]) * u)


class ScopedOptimizer:
    """One optimizer per scope over a model's named parameters, presented
    as one: ``step``, ``zero_grad``, ``state_dict`` and ``load_state_dict``,
    which is what :class:`~deep_recommenders_torch.training.Trainer`
    calls. ``optimizers`` maps each scope (and ``"__default__"``) to its
    optimizer and ``routes`` each parameter name to its scope."""

    def __init__(self, optimizers: Dict[str, torch.optim.Optimizer],
                 routes: Dict[str, str]):
        self.optimizers = optimizers
        self.routes = routes

    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for opt in self.optimizers.values():
            opt.step()
        return loss

    def zero_grad(self, set_to_none: bool = True) -> None:
        for opt in self.optimizers.values():
            opt.zero_grad(set_to_none=set_to_none)

    def state_dict(self) -> dict:
        return {scope: opt.state_dict()
                for scope, opt in self.optimizers.items()}

    def load_state_dict(self, state: dict) -> None:
        if set(state) != set(self.optimizers):
            raise KeyError(f"scopes {sorted(state)} do not match "
                           f"{sorted(self.optimizers)}")
        for scope, opt in self.optimizers.items():
            opt.load_state_dict(state[scope])


OptimizerFactory = Callable[[list], torch.optim.Optimizer]


def scoped_optimizer(
    scope_optimizers: Dict[str, OptimizerFactory],
    default: OptimizerFactory,
    named_parameters: Iterable[Tuple[str, torch.nn.Parameter]],
) -> ScopedOptimizer:
    """Route each parameter to the optimizer of the first scope found in
    its ``named_parameters()`` name (a substring, as JAX matches the scope
    in the joined parameter path), else to ``default``.

    ``scope_optimizers`` maps a scope to a factory that builds its
    optimizer from a list of parameters (``lambda p: Ftrl(p, 0.1)``), and
    ``default`` is the factory for the rest (``lambda p:
    torch.optim.Adam(p, lr=1e-3)``). A scope that no parameter matches
    gets no optimizer.
    """
    groups: Dict[str, list] = {}
    routes: Dict[str, str] = {}
    for name, param in named_parameters:
        scope = next((s for s in scope_optimizers if s in name),
                     "__default__")
        groups.setdefault(scope, []).append(param)
        routes[name] = scope
    factories = dict(scope_optimizers, __default__=default)
    return ScopedOptimizer(
        {scope: factories[scope](params) for scope, params in groups.items()},
        routes)
