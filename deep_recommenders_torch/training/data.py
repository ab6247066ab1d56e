"""Device-resident training data (counterpart of training/data.py).

The encoded split is uploaded to the device once; an epoch then gathers its
batches on the device from shuffled row indices, and only the epoch's
permutation crosses from the host. The shuffle is the JAX package's
(``np.random.default_rng(seed + epoch)``), so both packages visit rows in the
same order.

Features are a tensor (MMoE's dense (N, d) matrix), a dict of tensors (the
CTR models' feature dict), or a tuple of those (a (query, candidate) pair):
the structures of the JAX ``DeviceData``'s pytrees that the port's models
take.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from deep_recommenders_torch.device import DeviceLike, resolve_device

Features = Union[torch.Tensor, Dict[str, Any], Tuple[Any, ...]]


def map_features(fn: Callable, features):
    """``fn`` on every array of a tensor, dict or tuple (nested) of them,
    keeping the structure."""
    if isinstance(features, dict):
        return {k: map_features(fn, v) for k, v in features.items()}
    if isinstance(features, tuple):
        return tuple(map_features(fn, v) for v in features)
    return fn(features)


@dataclasses.dataclass
class DeviceData:
    """Encoded features (row-aligned tensors: one, a dict or a tuple) and
    labels on a device."""

    features: Features
    labels: torch.Tensor
    batch_size: int

    @classmethod
    def from_numpy(
        cls,
        features,
        labels: np.ndarray,
        batch_size: int,
        device: DeviceLike = "cuda",
    ) -> "DeviceData":
        """Upload an encoded split to ``device`` (the card by default)."""
        device = resolve_device(device)

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        return cls(
            features=map_features(put, features),
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
        map_features(lambda v: v.index_select(0, rows), features),
        labels.index_select(0, rows),
    )
