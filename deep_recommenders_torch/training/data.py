"""Device-resident training data (counterpart of training/data.py).

The encoded split is uploaded to the device once; an epoch then gathers its
batches on the device from shuffled row indices, and only the epoch's
permutation crosses from the host. The shuffle is the JAX package's
(``np.random.default_rng(seed + epoch)``), so both packages visit rows in the
same order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deep_recommenders_torch.device import DeviceLike, resolve_device

Features = Dict[str, torch.Tensor]


@dataclasses.dataclass
class DeviceData:
    """Encoded features (a dict of row-aligned tensors) + labels on a device."""

    features: Features
    labels: torch.Tensor
    batch_size: int

    @classmethod
    def from_numpy(
        cls,
        features: Dict[str, np.ndarray],
        labels: np.ndarray,
        batch_size: int,
        device: DeviceLike = "cuda",
    ) -> "DeviceData":
        """Upload an encoded split to ``device`` (the card by default)."""
        device = resolve_device(device)

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        return cls(
            features={k: put(v) for k, v in features.items()},
            labels=put(labels),
            batch_size=batch_size,
        )

    @property
    def device(self) -> torch.device:
        return self.labels.device

    @property
    def num_examples(self) -> int:
        return int(self.labels.shape[0])

    @property
    def steps_per_epoch(self) -> int:
        return self.num_examples // self.batch_size

    def permutation(self, seed: Optional[int], epoch: int) -> torch.Tensor:
        """Epoch-shuffled row order, cut to whole batches (host RNG, device
        tensor); ``seed=None`` keeps the stored order."""
        n = self.steps_per_epoch * self.batch_size
        idx = np.arange(self.num_examples)
        if seed is not None:
            np.random.default_rng(seed + epoch).shuffle(idx)
        return torch.from_numpy(idx[:n]).to(self.device)

    def gather(self, rows: torch.Tensor) -> Tuple[Features, torch.Tensor]:
        """Device-side batch materialization."""
        return gather_rows(self.features, self.labels, rows)


def gather_rows(
    features: Features, labels: torch.Tensor, rows: torch.Tensor
) -> Tuple[Features, torch.Tensor]:
    """Batch-gather ``rows`` from row-aligned (features, labels)."""
    return (
        {k: v.index_select(0, rows) for k, v in features.items()},
        labels.index_select(0, rows),
    )
