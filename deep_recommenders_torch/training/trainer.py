"""Training loop (counterpart of training/trainer.py).

The JAX trainer jits one train step and scans it over a device-resident
epoch. Here the model and optimizer own the state, PyTorch runs eagerly, and
an epoch is a Python loop of steps over batches gathered on the device from
:class:`DeviceData`; the host reads a value only at the end of an epoch.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from deep_recommenders_torch.device import DeviceLike, resolve_device
from deep_recommenders_torch.training.evaluation import BinaryCTREval
from deep_recommenders_torch.training.losses import binary_cross_entropy

LossFn = Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor]


def _monitor_value(summary: Dict[str, Any], monitor: str, mode: str) -> float:
    """Scalar driving early stopping: ``"auto"`` is AUC if present, else
    -val_loss; any other name selects that key, maximised (``mode="max"``)
    or minimised (``mode="min"``)."""
    if monitor == "auto":
        if "auc" in summary:
            return summary["auc"]
        return -summary.get("val_loss", summary["loss"])
    if monitor not in summary:
        raise KeyError(
            f"early-stop monitor {monitor!r} not in epoch summary "
            f"{sorted(summary)}"
        )
    value = summary[monitor]
    return -value if mode == "min" else value


def bce_loss(model: torch.nn.Module) -> LossFn:
    """Default CTR loss: sigmoid BCE on the model's logits."""

    def loss_fn(batch, labels):
        return binary_cross_entropy(model(batch), labels)

    return loss_fn


class Trainer:
    """fit/evaluate loops around a model and its optimizer.

    ``optimizer`` is built on ``model.parameters()`` (e.g.
    ``torch.optim.Adam(model.parameters(), lr=1e-3)``, which, like
    ``optax.adam``, puts eps outside the square root). The model moves to
    ``device`` in place, which keeps the optimizer's parameter references.
    Training continues from the model's current weights.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        optimizer: torch.optim.Optimizer,
        loss_fn: Optional[LossFn] = None,
        mesh=None,
        eval_spec=None,
        device: DeviceLike = "cuda",
    ):
        if mesh is not None:
            raise NotImplementedError("mesh sharding is not ported yet")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.optimizer = optimizer
        self.loss_fn = loss_fn or bce_loss(model)
        self.eval_spec = eval_spec or BinaryCTREval(model)

    def _put(self, x) -> Any:
        if isinstance(x, dict):
            return {k: self._put(v) for k, v in x.items()}
        return torch.as_tensor(x).to(self.device)

    # -- steps --------------------------------------------------------------
    def train_step(self, batch, labels) -> torch.Tensor:
        """One optimizer step; returns the loss as a device scalar."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(batch, labels)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def eval_step(self, batch, labels, metric_state):
        return self.eval_spec.update(batch, labels, metric_state)

    # -- loops --------------------------------------------------------------
    def fit(
        self,
        train_batches: Callable[[int], Iterable[Tuple[Dict, Any]]],
        eval_batches: Optional[Callable[[], Iterable[Tuple[Dict, Any]]]] = None,
        epochs: int = 1,
        early_stopping_patience: Optional[int] = None,
        monitor: str = "auto",
        monitor_mode: str = "max",
        log_every: int = 100,
        verbose: bool = True,
    ) -> Dict[str, Any]:
        """Host-streaming loop: ``train_batches(epoch)`` yields numpy
        (features, labels) batches, each copied to the device per step."""
        history = []
        best_metric, best_epoch = -float("inf"), -1
        examples, step = 0, 0
        t0 = time.perf_counter()
        for epoch in range(epochs):
            loss = None
            for batch, labels in train_batches(epoch):
                loss = self.train_step(self._put(batch), self._put(labels))
                examples += len(labels)
                step += 1
                if verbose and log_every and step % log_every == 0:
                    elapsed = time.perf_counter() - t0
                    print(f"step {step} loss {float(loss):.4f} "
                          f"({examples / elapsed:.0f} ex/s)")
            if loss is None:
                raise ValueError(
                    "train_batches yielded no batches (corpus smaller than "
                    "one batch?): nothing to train on"
                )
            summary = {"epoch": epoch, "loss": float(loss)}
            stop = False
            if eval_batches is not None:
                summary.update(self.evaluate(eval_batches))
                metric = _monitor_value(summary, monitor, monitor_mode)
                if metric > best_metric:
                    best_metric, best_epoch = metric, epoch
                elif (early_stopping_patience is not None
                      and epoch - best_epoch >= early_stopping_patience):
                    stop = True
            history.append(summary)
            if verbose:
                print({k: round(v, 4) if isinstance(v, float) else v
                       for k, v in summary.items()})
            if stop:
                break
        elapsed = time.perf_counter() - t0
        return {"history": history, "examples_per_sec": examples / elapsed}

    def fit_device(
        self,
        train_data,
        eval_data=None,
        epochs: int = 1,
        shuffle_seed: Optional[int] = 42,
        early_stopping_patience: Optional[int] = None,
        monitor: str = "auto",
        monitor_mode: str = "max",
        checkpoint_dir: Optional[str] = None,
        verbose: bool = True,
    ) -> Dict[str, Any]:
        """Epochs over :class:`DeviceData`, batches gathered on the device.

        Returns ``history`` (per-epoch summaries), ``step_losses`` (every
        step's loss, in order), ``examples_per_sec`` over the whole call and
        ``examples_per_sec_steady`` from the end of the first epoch on.
        """
        if checkpoint_dir is not None:
            raise NotImplementedError("checkpoints are not ported yet")
        batch = train_data.batch_size
        history, step_losses = [], []
        best_metric, best_epoch = -float("inf"), -1
        examples, examples_steady = 0, 0
        t0 = time.perf_counter()
        t_steady = t_last = None
        for epoch in range(epochs):
            perm = train_data.permutation(shuffle_seed, epoch)
            losses = []
            for s in range(perm.shape[0] // batch):
                b, labels = train_data.gather(perm[s * batch:(s + 1) * batch])
                losses.append(self.train_step(b, labels))
            losses = torch.stack(losses).cpu().numpy()  # fences the epoch
            step_losses.append(losses)
            examples += int(perm.shape[0])
            if t_steady is not None:
                examples_steady += int(perm.shape[0])
            else:
                t_steady = time.perf_counter()
            t_last = time.perf_counter()
            summary = {"epoch": epoch, "loss": float(losses[-1])}
            stop = False
            if eval_data is not None:
                summary.update(self._evaluate_device(eval_data))
                metric = _monitor_value(summary, monitor, monitor_mode)
                if metric > best_metric:
                    best_metric, best_epoch = metric, epoch
                elif (early_stopping_patience is not None
                      and epoch - best_epoch >= early_stopping_patience):
                    stop = True
            history.append(summary)
            if verbose:
                elapsed = time.perf_counter() - t0
                print({k: round(v, 4) if isinstance(v, float) else v
                       for k, v in summary.items()},
                      f"[{examples / elapsed:.0f} ex/s]")
            if stop:
                break
        result = {
            "history": history,
            "step_losses": np.concatenate(step_losses),
            "examples_per_sec": examples / (time.perf_counter() - t0),
        }
        if examples_steady > 0:
            # Eval time between epochs is included, as in the JAX trainer.
            result["examples_per_sec_steady"] = examples_steady / (
                t_last - t_steady
            )
        return result

    def _evaluate_device(self, eval_data) -> Dict[str, float]:
        perm = eval_data.permutation(None, 0)
        batch = eval_data.batch_size
        state = self.eval_spec.init()
        for s in range(perm.shape[0] // batch):
            b, labels = eval_data.gather(perm[s * batch:(s + 1) * batch])
            state = self.eval_step(b, labels, state)
        return self.eval_spec.compute(state)

    def evaluate(self, eval_batches) -> Dict[str, float]:
        """Metrics over ``eval_batches()``, numpy batches copied per step."""
        state = self.eval_spec.init()
        for batch, labels in eval_batches():
            state = self.eval_step(self._put(batch), self._put(labels), state)
        return self.eval_spec.compute(state)
