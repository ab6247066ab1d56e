"""Pluggable eval programs for the Trainer (counterpart of
training/evaluation.py).

An eval program is three methods:
- ``init()``   -> metric-state dict of tensors on the model's device
- ``update(batch, labels, state)`` -> new state, computed on the device
- ``compute(state)`` -> {name: float} epoch summary (host side)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from deep_recommenders_torch.training import metrics as metrics_lib
from deep_recommenders_torch.training.losses import (
    binary_cross_entropy,
    mean_squared_error,
)


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


class BinaryCTREval:
    """AUC + precision/recall + BCE val_loss on sigmoid(logits).

    ``update`` runs the model's eval-mode forward under ``no_grad``: the
    forward that serving runs.
    """

    def __init__(self, model: torch.nn.Module,
                 auc: Optional[metrics_lib.AUC] = None,
                 pr: Optional[metrics_lib.PrecisionRecall] = None):
        self.model = model
        self.auc = auc or metrics_lib.AUC()
        self.pr = pr or metrics_lib.PrecisionRecall()

    def init(self):
        device = _device(self.model)
        return {
            "auc": self.auc.init(device),
            "pr": self.pr.init(device),
            "loss": metrics_lib.Mean.init(device),
        }

    @torch.no_grad()
    def update(self, batch, labels, state):
        self.model.eval()
        logits = self.model(batch)
        probs = torch.sigmoid(logits)
        loss = binary_cross_entropy(logits, labels)
        return {
            "auc": self.auc.update(state["auc"], labels, probs),
            "pr": self.pr.update(state["pr"], labels, probs),
            "loss": metrics_lib.Mean.update(state["loss"], loss),
        }

    def compute(self, state) -> Dict[str, float]:
        pr = self.pr.compute(state["pr"])
        return {
            "auc": float(self.auc.compute(state["auc"])),
            "precision": float(pr["precision"]),
            "recall": float(pr["recall"]),
            "val_loss": float(metrics_lib.Mean.compute(state["loss"])),
        }


class MultiTaskMSEEval:
    """Per-task MSE of a multi-output regressor (MMoE on the synthetic
    two-task data). ``labels``: (B, num_tasks), task t's target in column t.
    Summary: ``mse_0..mse_{T-1}`` and ``val_loss``, their sum."""

    def __init__(self, model: torch.nn.Module, num_tasks: int = 2):
        self.model = model
        self.num_tasks = num_tasks

    def init(self):
        device = _device(self.model)
        return {f"mse_{t}": metrics_lib.Mean.init(device)
                for t in range(self.num_tasks)}

    @torch.no_grad()
    def update(self, batch, labels, state):
        self.model.eval()
        outputs = self.model(batch)
        return {
            f"mse_{t}": metrics_lib.Mean.update(
                state[f"mse_{t}"],
                (outputs[t].reshape(-1) - labels[:, t]).square())
            for t in range(self.num_tasks)
        }

    def compute(self, state) -> Dict[str, float]:
        out = {f"mse_{t}": float(metrics_lib.Mean.compute(state[f"mse_{t}"]))
               for t in range(self.num_tasks)}
        out["val_loss"] = sum(out.values())
        return out


class MultiTaskBCEEval:
    """Per-task AUC and BCE of a model that returns a sequence of per-task
    PROBABILITIES (ESMM multiplies sigmoids). ``labels``: (B, num_tasks);
    ``output_indices`` maps label column t to the model output it scores
    (ESMM returns (p_cvr, p_ctr, p_ctcvr) and trains on (ctr, ctcvr)
    labels: ``(1, 2)``). The BCE is on the probabilities with eps 1e-7.
    Summary: ``auc_{name}``, ``loss_{name}`` per task and ``val_loss``,
    the sum of the losses."""

    def __init__(self, model: torch.nn.Module, num_tasks: int = 2,
                 task_names: Optional[Tuple[str, ...]] = None,
                 output_indices: Optional[Tuple[int, ...]] = None):
        self.model = model
        self.num_tasks = num_tasks
        self.names = tuple(task_names or
                           (f"task_{t}" for t in range(num_tasks)))
        self.output_indices = tuple(output_indices or range(num_tasks))
        self.auc = metrics_lib.AUC()

    def init(self):
        device = _device(self.model)
        state = {}
        for name in self.names:
            state[f"auc_{name}"] = self.auc.init(device)
            state[f"loss_{name}"] = metrics_lib.Mean.init(device)
        return state

    @torch.no_grad()
    def update(self, batch, labels, state):
        self.model.eval()
        probs = self.model(batch)
        new = {}
        for t, name in enumerate(self.names):
            p = probs[self.output_indices[t]].reshape(-1)
            y = labels[:, t]
            new[f"auc_{name}"] = self.auc.update(state[f"auc_{name}"], y, p)
            eps = 1e-7
            bce = -(y * torch.log(p + eps) + (1 - y) * torch.log(1 - p + eps))
            new[f"loss_{name}"] = metrics_lib.Mean.update(
                state[f"loss_{name}"], bce)
        return new

    def compute(self, state) -> Dict[str, float]:
        out, total = {}, 0.0
        for name in self.names:
            out[f"auc_{name}"] = float(self.auc.compute(state[f"auc_{name}"]))
            loss = float(metrics_lib.Mean.compute(state[f"loss_{name}"]))
            out[f"loss_{name}"] = loss
            total += loss
        out["val_loss"] = total
        return out


class RetrievalEval:
    """Two-tower eval: the retrieval loss per example and the in-batch
    FactorizedTopK accuracy bank. ``batch`` is a (query batch, candidate
    batch) tuple, or one dict feeding both towers; labels are not read.

    The loss is the task's on the eval batch with single-device semantics:
    a copy of ``task`` without metrics, mesh, axis and accidental-negative
    removal (whose candidate ids the eval does not thread). Full-corpus
    recall against an index is a separate pass, since the corpus's
    embeddings change with the weights.
    """

    def __init__(self, model: torch.nn.Module, task=None, metric=None):
        from deep_recommenders_torch.models.retrieval import (
            FactorizedTopK,
            Retrieval,
        )

        self.model = model
        self._loss_task = dataclasses.replace(
            task or Retrieval(), metrics=None, axis_name=None, mesh=None,
            remove_accidental_negatives=False)
        self.metric = metric or FactorizedTopK()

    def init(self):
        device = _device(self.model)
        return {"loss": metrics_lib.Mean.init(device),
                "topk": self.metric.init(device)}

    @torch.no_grad()
    def update(self, batch, labels, state):
        del labels
        self.model.eval()
        qb, cb = batch if isinstance(batch, tuple) else (batch, batch)
        qe, ce = self.model(qb, cb)
        loss_sum = self._loss_task(qe, ce)
        b = qe.shape[0]
        return {
            "loss": metrics_lib.Mean.update(state["loss"],
                                            (loss_sum / b).expand(b)),
            "topk": self.metric.update(state["topk"], qe, ce),
        }

    def compute(self, state) -> Dict[str, float]:
        out = {k: float(v)
               for k, v in self.metric.compute(state["topk"]).items()}
        out["val_loss"] = float(metrics_lib.Mean.compute(state["loss"]))
        return out


def retrieval_loss(model: torch.nn.Module, task):
    """Two-tower train loss for ``Trainer(loss_fn=...)``: ``batch`` is the
    (query batch, candidate batch) tuple, or one dict for both towers.
    ``labels`` is None (plain in-batch softmax), a tensor of candidate ids
    (for accidental-negative removal, when the task has it), or a dict with
    optional ``candidate_ids`` and ``sampling_prob``, each positive's corpus
    sampling probability for the log-Q correction."""

    def loss_fn(batch, labels):
        qb, cb = batch if isinstance(batch, tuple) else (batch, batch)
        qe, ce = model(qb, cb)
        if isinstance(labels, dict):
            return task(
                qe, ce, candidate_ids=labels.get("candidate_ids"),
                candidate_sampling_probability=labels.get("sampling_prob"))
        return task(qe, ce, candidate_ids=labels)

    return loss_fn


def multitask_mse_loss(model: torch.nn.Module, num_tasks: int = 2):
    """Summed per-task MSE train loss for ``Trainer(loss_fn=...)``: one
    update for all tasks."""

    def loss_fn(batch, labels):
        outputs = model(batch)
        return sum(mean_squared_error(outputs[t], labels[:, t:t + 1])
                   for t in range(num_tasks))

    return loss_fn
