"""Streaming metrics as state dicts of device tensors.

Counterpart of ``deep_recommenders_tpu/training/metrics.py``: each metric is
a state + ``init/update/compute``, updated on the device with no host
sync per batch. AUC follows tf.metrics.auc's thresholded confusion matrix
(200 thresholds on an epsilon-padded [0, 1] grid, trapezoidal ROC
integration), so values compare with the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

State = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AUC:
    """Streaming ROC-AUC over sigmoid scores in [0, 1] (predictions are
    clipped to [0, 1]: raw logits would give a plausible but wrong value).
    """

    num_thresholds: int = 200

    def init(self, device="cpu") -> State:
        return {
            k: torch.zeros(self.num_thresholds, dtype=torch.float32,
                           device=device)
            for k in ("tp", "fp", "tn", "fn")
        }

    def update(self, state: State, labels: torch.Tensor,
               predictions: torch.Tensor) -> State:
        """labels, predictions: (B,) or (B, 1); probabilities in [0, 1]."""
        labels = labels.reshape(-1).float()
        preds = predictions.reshape(-1).clamp(0.0, 1.0)
        eps = 1e-7
        thresholds = torch.linspace(
            0.0 - eps, 1.0 + eps, self.num_thresholds, device=preds.device
        )
        pred_pos = preds[None, :] > thresholds[:, None]  # (T, B)
        lab_pos = (labels > 0.5)[None, :]
        return {
            "tp": state["tp"] + (pred_pos & lab_pos).sum(1),
            "fp": state["fp"] + (pred_pos & ~lab_pos).sum(1),
            "tn": state["tn"] + (~pred_pos & ~lab_pos).sum(1),
            "fn": state["fn"] + (~pred_pos & lab_pos).sum(1),
        }

    @staticmethod
    def compute(state: State) -> torch.Tensor:
        eps = 1e-7
        tpr = state["tp"] / (state["tp"] + state["fn"] + eps)
        fpr = state["fp"] / (state["fp"] + state["tn"] + eps)
        # Thresholds ascend => fpr/tpr descend; integrate |d fpr| * mean tpr.
        return torch.sum((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) / 2.0)


@dataclasses.dataclass(frozen=True)
class PrecisionRecall:
    """Precision / recall at a fixed decision threshold."""

    threshold: float = 0.5

    def init(self, device="cpu") -> State:
        return {k: torch.zeros((), dtype=torch.float32, device=device)
                for k in ("tp", "fp", "fn")}

    def update(self, state: State, labels: torch.Tensor,
               predictions: torch.Tensor) -> State:
        labels = labels.reshape(-1) > 0.5
        preds = predictions.reshape(-1) > self.threshold
        return {
            "tp": state["tp"] + (preds & labels).sum(),
            "fp": state["fp"] + (preds & ~labels).sum(),
            "fn": state["fn"] + (~preds & labels).sum(),
        }

    @staticmethod
    def compute(state: State) -> Dict[str, torch.Tensor]:
        eps = 1e-7
        return {
            "precision": state["tp"] / (state["tp"] + state["fp"] + eps),
            "recall": state["tp"] / (state["tp"] + state["fn"] + eps),
        }


class Mean:
    """Streaming mean (loss, MSE, accuracy...)."""

    @staticmethod
    def init(device="cpu") -> State:
        return {k: torch.zeros((), dtype=torch.float32, device=device)
                for k in ("total", "count")}

    @staticmethod
    def update(state: State, values: torch.Tensor) -> State:
        values = values.float().reshape(-1)
        return {"total": state["total"] + values.sum(),
                "count": state["count"] + values.numel()}

    @staticmethod
    def compute(state: State) -> torch.Tensor:
        return state["total"] / state["count"].clamp_min(1e-12)
