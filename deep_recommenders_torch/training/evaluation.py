"""Pluggable eval programs for the Trainer (counterpart of
training/evaluation.py).

An eval program is three methods:
- ``init()``   -> metric-state dict of tensors on the model's device
- ``update(batch, labels, state)`` -> new state, computed on the device
- ``compute(state)`` -> {name: float} epoch summary (host side)
"""

from __future__ import annotations

from typing import Dict

import torch

from deep_recommenders_torch.training import metrics as metrics_lib
from deep_recommenders_torch.training.losses import binary_cross_entropy


class BinaryCTREval:
    """AUC + precision/recall + BCE val_loss on sigmoid(logits).

    ``update`` runs the model's eval-mode forward under ``no_grad``: the
    forward that serving runs.
    """

    def __init__(self, model: torch.nn.Module):
        self.model = model
        self.auc = metrics_lib.AUC()
        self.pr = metrics_lib.PrecisionRecall()

    def init(self):
        device = next(self.model.parameters()).device
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
