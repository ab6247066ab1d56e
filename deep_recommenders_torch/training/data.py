"""Device-resident training data (counterpart of training/data.py).

The encoded split is uploaded to the device once; an epoch then gathers its
batches on the device from shuffled row indices, and only the epoch's
permutation crosses from the host. The shuffle is the JAX package's
(``np.random.default_rng(seed + epoch)``), so both packages visit rows in the
same order.

Features are a tensor (MMoE's dense (N, d) matrix), a dict of tensors (the
CTR models' feature dict), or a tuple of those (a (query, candidate) pair):
the structures of the JAX ``DeviceData``'s pytrees that the port's models
take. Labels take the same structures (the two-tower example's dict of
candidate ids and sampling probabilities), or None.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from deep_recommenders_torch.device import DeviceLike, resolve_device

Features = Union[torch.Tensor, Dict[str, Any], Tuple[Any, ...]]


def map_features(fn: Callable, features):
    """``fn`` on every array of a tensor, dict or tuple (nested) of them,
    keeping the structure; None stays None (an empty pytree in JAX)."""
    if features is None:
        return None
    if isinstance(features, dict):
        return {k: map_features(fn, v) for k, v in features.items()}
    if isinstance(features, tuple):
        return tuple(map_features(fn, v) for v in features)
    return fn(features)


def leaves(tree) -> List[Any]:
    """The arrays of a tensor, dict or tuple (nested) of them, in order."""
    out: List[Any] = []
    map_features(out.append, tree)
    return out


@dataclasses.dataclass
class DeviceData:
    """Encoded features and labels on a device: row-aligned tensors, each
    one tensor, a dict or a tuple of them (labels may also be None)."""

    features: Features
    labels: Any
    batch_size: int

    @classmethod
    def from_numpy(
        cls,
        features,
        labels,
        batch_size: int,
        device: DeviceLike = "cuda",
        mesh=None,
    ) -> "DeviceData":
        """Upload an encoded split to ``device`` (the card by default).

        With ``mesh`` each process passes ITS slice of the split, in data
        coordinate order (global rows = local rows x data size, the same
        on every process), as in JAX. The port assembles the whole split on
        every process once, at upload, so that an epoch draws the same
        global batches as JAX's global permutation and each process takes
        its data coordinate's share of every batch (``Trainer(mesh=)``).
        ``batch_size`` is the global batch. The assembly is one all-reduce
        per array over the data group, of each slice placed at its rows of
        a zero array on the device (collectives on device tensors work
        with NCCL and gloo alike); it costs the whole split's memory on
        every process. A float -0.0 comes back as +0.0.
        """
        device = resolve_device(device)

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        if mesh is not None:
            from deep_recommenders_torch.parallel.sharding import (
                DATA_AXIS,
                all_reduce,
                axis_index,
                axis_size,
                mesh_device,
            )

            device = mesh_device(mesh)
            n, d = axis_size(mesh, DATA_AXIS), axis_index(mesh, DATA_AXIS)
            local = (leaves(labels) or leaves(features))[0].shape[0]
            counts = torch.zeros(n, dtype=torch.int64, device=device)
            counts[d] = local
            all_reduce(counts, mesh, DATA_AXIS)
            if (counts != local).any():
                raise ValueError("every data shard must pass the same "
                                 f"number of rows, got {counts.tolist()}")

            def put(x):  # noqa: F811
                x = torch.from_numpy(np.ascontiguousarray(x))
                whole = torch.zeros((n * local,) + tuple(x.shape[1:]),
                                    dtype=x.dtype, device=device)
                whole[d * local:(d + 1) * local] = x.to(device)
                return all_reduce(whole, mesh, DATA_AXIS)

        return cls(
            features=map_features(put, features),
            labels=map_features(put, labels),
            batch_size=batch_size,
        )

    def _first(self) -> torch.Tensor:
        return (leaves(self.labels) or leaves(self.features))[0]

    @property
    def device(self) -> torch.device:
        return self._first().device

    @property
    def num_examples(self) -> int:
        return int(self._first().shape[0])

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

    def gather(self, rows: torch.Tensor) -> Tuple[Features, Any]:
        """Device-side batch materialization."""
        return gather_rows(self.features, self.labels, rows)


def gather_rows(
    features: Features, labels, rows: torch.Tensor
) -> Tuple[Features, Any]:
    """Batch-gather ``rows`` from row-aligned (features, labels)."""
    def take(v):
        return v.index_select(0, rows)

    return map_features(take, features), map_features(take, labels)
