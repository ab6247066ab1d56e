"""Training loop (counterpart of training/trainer.py).

The JAX trainer jits one train step and scans it over a device-resident
epoch. Here the model and optimizer own the state, PyTorch runs eagerly, and
an epoch is a Python loop of steps over batches gathered on the device from
:class:`DeviceData`; the host reads a value only at the end of an epoch.

Under a mesh (``Trainer(mesh=)``, a ("data", "model") ``DeviceMesh``) every
process runs the same loop on its data coordinate's slice of each global
batch. The local loss is the mean over the local rows; after the backward
every gradient (the replicated dense parameters, and the process's table
shard, which holds the same rows across its data group) and the loss go
through ONE all-reduce over the data group and are divided by its size.
That is the gradient of the global batch's mean loss, which JAX's GSPMD
computes, and the step returns the global mean loss. Metric states are
merged over the data group the same way (their ``merge`` is a sum). Only
rank 0 prints.
"""

from __future__ import annotations

import inspect
import os
import shutil
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from deep_recommenders_torch.device import DeviceLike, resolve_device
from deep_recommenders_torch.parallel.mesh import check_mesh
from deep_recommenders_torch.parallel.sharding import (
    DATA_AXIS,
    MODEL_AXIS,
    all_reduce,
    axis_group,
    axis_index,
    axis_size,
    is_row_shard,
    mesh_device,
    shard_batch,
)
from deep_recommenders_torch.training.checkpoints import (
    list_step_dirs,
    restore_train_state,
    save_train_state,
)
from deep_recommenders_torch.training.data import leaves, map_features
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

    With ``mesh`` the model must have been built with the same mesh (its
    tables row-sharded) and runs on this process's device of the mesh,
    whose type ``device`` must name. The constructor makes the weights
    agree: every replicated parameter is broadcast from rank 0, and every
    table shard from the first process of its data group.
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
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None:
            check_mesh(mesh)
            if mesh.device_type != self.device.type:
                raise ValueError(f"device {self.device} but a "
                                 f"{mesh.device_type} mesh")
            self.device = mesh_device(mesh)
        self.model = model.to(self.device)
        self.optimizer = optimizer
        self.loss_fn = loss_fn or bce_loss(model)
        self.eval_spec = eval_spec or BinaryCTREval(model)
        self.verbose_rank = mesh is None or dist.get_rank() == 0
        if mesh is not None:
            self._sync_parameters()

    def _put(self, x) -> Any:
        if self.mesh is not None:
            return shard_batch(x, self.mesh)
        return map_features(lambda v: torch.as_tensor(v).to(self.device), x)

    # -- the mesh -------------------------------------------------------------
    def _sync_parameters(self) -> None:
        """Broadcast the replicated parameters from rank 0 and each table
        shard from its data group's first process (two broadcasts)."""
        shards, replicated = [], []
        for p in self.model.parameters():
            (shards if is_row_shard(p) else replicated).append(p)
        first_of_data_group = int(
            self.mesh.mesh[0, axis_index(self.mesh, MODEL_AXIS)])
        with torch.no_grad():
            for params, src, group in (
                (replicated, 0, None),
                (shards, first_of_data_group,
                 axis_group(self.mesh, DATA_AXIS)),
            ):
                if not params:
                    continue
                flat = torch.cat([p.reshape(-1) for p in params])
                dist.broadcast(flat, src=src, group=group)
                offset = 0
                for p in params:
                    p.copy_(flat[offset:offset + p.numel()].view_as(p))
                    offset += p.numel()

    def _mean_over_data(self, loss: torch.Tensor) -> torch.Tensor:
        """Every gradient and ``loss`` summed over the data group in one
        all-reduce and divided by its size; returns the mean loss. The
        buffer is fp32: a bf16 gradient (a table stored in bf16) is summed
        there and rounded once to bf16 after the division, the same bits
        on NCCL and gloo (at two data shards, the bf16 sum of the two)."""
        params = [p for p in self.model.parameters() if p.requires_grad]
        flat = torch.cat(
            [(p.grad if p.grad is not None else torch.zeros_like(p))
             .reshape(-1).float() for p in params]
            + [loss.detach().reshape(1).float()])
        all_reduce(flat, self.mesh, DATA_AXIS)
        flat /= axis_size(self.mesh, DATA_AXIS)
        offset = 0
        for p in params:
            p.grad = flat[offset:offset + p.numel()].view_as(p).to(p.dtype)
            offset += p.numel()
        return flat[-1]

    def _merge_over_data(self, state):
        """The metric states of the data group merged: every metric's
        ``merge`` adds its states elementwise, so one all-reduce of the
        flattened state over the data group merges them all."""
        if self.mesh is None:
            return state
        parts = leaves(state)
        flat = torch.cat([t.float().reshape(-1) for t in parts])
        all_reduce(flat, self.mesh, DATA_AXIS)
        merged, offset = [], 0
        for t in parts:
            merged.append(flat[offset:offset + t.numel()].view_as(t)
                          .to(t.dtype))
            offset += t.numel()
        it = iter(merged)
        return map_features(lambda _: next(it), state)

    def _local_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """This process's share of a global batch's rows: its data
        coordinate's contiguous slice, as JAX's P("data") shards it."""
        if self.mesh is None:
            return rows
        n = axis_size(self.mesh, DATA_AXIS)
        if rows.shape[0] % n:
            raise ValueError(f"batch of {rows.shape[0]} rows does not "
                             f"split over {n} data shards")
        b = rows.shape[0] // n
        d = axis_index(self.mesh, DATA_AXIS)
        return rows[d * b:(d + 1) * b]

    # -- steps --------------------------------------------------------------
    def train_step(self, batch, labels) -> torch.Tensor:
        """One optimizer step; returns the loss as a device scalar (under a
        mesh, the global batch's mean)."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(batch, labels)
        loss.backward()
        if self.mesh is not None:
            loss = self._mean_over_data(loss)
        self.optimizer.step()
        return loss.detach()

    def eval_step(self, batch, labels, metric_state):
        return self.eval_spec.update(batch, labels, metric_state)

    # -- loops --------------------------------------------------------------
    def fit(
        self,
        train_batches: Callable[..., Iterable[Tuple[Dict, Any]]],
        eval_batches: Optional[Callable[[], Iterable[Tuple[Dict, Any]]]] = None,
        epochs: int = 1,
        early_stopping_patience: Optional[int] = None,
        monitor: str = "auto",
        monitor_mode: str = "max",
        log_every: int = 100,
        verbose: bool = True,
    ) -> Dict[str, Any]:
        """Host-streaming loop: ``train_batches(epoch)`` (or
        ``train_batches()``, a factory that takes no argument) yields numpy
        (features, labels) batches, each copied to the device per step.
        Under a mesh each batch is this process's slice of the global batch.

        Returns ``history``, ``examples`` and ``examples_per_sec``.
        ``examples`` counts the leading size of the first array of the
        labels, or of the features when the labels hold none, times the
        data axis's size under a mesh, as JAX counts the global batch.
        """
        takes_epoch = bool(inspect.signature(train_batches).parameters)
        verbose = verbose and self.verbose_rank
        n_data = 1 if self.mesh is None else axis_size(self.mesh, DATA_AXIS)
        history = []
        best_metric, best_epoch = -float("inf"), -1
        examples, step = 0, 0
        t0 = time.perf_counter()
        for epoch in range(epochs):
            loss = None
            epoch_batches = (train_batches(epoch) if takes_epoch
                             else train_batches())
            for batch, labels in epoch_batches:
                loss = self.train_step(self._put(batch), self._put(labels))
                examples += (leaves(labels) or leaves(batch))[0].shape[0] \
                    * n_data
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
        return {"history": history, "examples": examples,
                "examples_per_sec": examples / elapsed}

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
        checkpoint_every_epochs: int = 1,
        keep_checkpoint_max: int = 10,
        verbose: bool = True,
    ) -> Dict[str, Any]:
        """Epochs over :class:`DeviceData`, batches gathered on the device.

        With ``checkpoint_dir``, training resumes from the latest
        ``step_{epoch}`` directory there (the model's and the optimizer's
        state dicts, ``training/checkpoints.py``) at ``epoch + 1``; every
        ``checkpoint_every_epochs`` epochs the state is saved to
        ``step_{epoch}``, and the oldest directories are removed past
        ``keep_checkpoint_max``, counting those left by earlier runs.

        Returns ``history`` (per-epoch summaries), ``step_losses`` (every
        step's loss, in order), ``examples_per_sec`` over the whole call and
        ``examples_per_sec_steady`` from the end of the first epoch on.

        Under a mesh ``train_data`` holds the whole split on every process
        (``DeviceData.from_numpy(mesh=)``) and each step trains on this
        process's share of the global batch. With ``checkpoint_dir`` every
        process saves and resumes (``checkpoints.save_train_state``,
        ``restore_train_state``): at model = 1 rank 0 writes the whole
        state; at model > 1 the processes of data coordinate 0 write their
        model coordinate's shard, and a checkpoint resumes under this mesh
        or is joined and cut again for another (or for none).
        """
        verbose = verbose and self.verbose_rank
        batch = train_data.batch_size
        start_epoch, saved_ckpts = 0, []
        if checkpoint_dir is not None:
            saved_ckpts = list_step_dirs(checkpoint_dir)
            if saved_ckpts:
                latest = saved_ckpts[-1]
                restore_train_state(latest, self.model, self.optimizer,
                                    self.mesh)
                start_epoch = int(os.path.basename(latest).split("_")[1]) + 1
                if verbose:
                    print(f"resumed from {latest} (epoch {start_epoch})")
        history, step_losses = [], []
        best_metric, best_epoch = -float("inf"), -1
        examples, examples_steady = 0, 0
        t0 = time.perf_counter()
        t_steady = t_last = None
        for epoch in range(start_epoch, epochs):
            perm = train_data.permutation(shuffle_seed, epoch)
            losses = []
            for s in range(perm.shape[0] // batch):
                b, labels = train_data.gather(
                    self._local_rows(perm[s * batch:(s + 1) * batch]))
                losses.append(self.train_step(b, labels))
            losses = torch.stack(losses).cpu().numpy()  # fences the epoch
            step_losses.append(losses)
            examples += int(perm.shape[0])
            if t_steady is not None:
                examples_steady += int(perm.shape[0])
            else:
                t_steady = time.perf_counter()
            t_last = time.perf_counter()
            if (checkpoint_dir is not None
                    and (epoch + 1) % checkpoint_every_epochs == 0):
                path = os.path.join(checkpoint_dir, f"step_{epoch}")
                save_train_state(path, self.model, self.optimizer, self.mesh)
                saved_ckpts.append(path)
                while len(saved_ckpts) > keep_checkpoint_max:
                    old = saved_ckpts.pop(0)
                    if self.mesh is None or dist.get_rank() == 0:
                        shutil.rmtree(old, ignore_errors=True)
                if self.mesh is not None:
                    dist.barrier()
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
            "step_losses": (np.concatenate(step_losses) if step_losses
                            else np.zeros(0, np.float32)),
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
            b, labels = eval_data.gather(
                self._local_rows(perm[s * batch:(s + 1) * batch]))
            state = self.eval_step(b, labels, state)
        return self.eval_spec.compute(self._merge_over_data(state))

    def evaluate(self, eval_batches) -> Dict[str, float]:
        """Metrics over ``eval_batches()``, numpy batches copied per step
        (under a mesh, this process's slices; the states are merged over
        the data group)."""
        state = self.eval_spec.init()
        for batch, labels in eval_batches():
            state = self.eval_step(self._put(batch), self._put(labels), state)
        return self.eval_spec.compute(self._merge_over_data(state))
