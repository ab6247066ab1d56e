"""MMoE-paper synthetic two-task regression data.

Counterpart of ``deep_recommenders_tpu/datasets/synthetic_multitask.py``,
kept as its own copy (the port imports nothing of the JAX package): two
label functions y_k = w_k.x + sum_i sin(alpha_i * w_k.x + beta_i) + noise,
where the weight vectors w1, w2 have cosine similarity p (the task
correlation of the MMoE paper). numpy with a seeded ``default_rng``, so the
arrays equal the JAX package's exactly. Batches carry one dense (B, d)
float32 matrix under "features"; ``column_view`` gives the reference's
C0..C{d-1} scalar-column dict.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np


def synthetic_two_task(
    num_examples: int,
    example_dim: int = 100,
    c: float = 0.3,
    p: float = 0.8,
    m: int = 5,
    seed: int = 42,
) -> Tuple[np.ndarray, Tuple[np.ndarray, np.ndarray]]:
    """Generate the MMoE synthetic dataset (ref synthetic_for_multi_task.py:8-36)."""
    rng = np.random.default_rng(seed)
    mu1 = rng.normal(size=example_dim)
    mu1 = (mu1 - mu1.mean()) / (mu1.std() * np.sqrt(example_dim))
    mu2 = rng.normal(size=example_dim)
    mu2 -= mu2.dot(mu1) * mu1
    mu2 /= np.linalg.norm(mu2)
    w1 = c * mu1
    w2 = c * (p * mu1 + np.sqrt(1.0 - p**2) * mu2)
    alpha = rng.normal(size=m)
    beta = rng.normal(size=m)
    x = rng.normal(size=(num_examples, example_dim))
    w1x, w2x = x @ w1, x @ w2
    sin1 = np.sin(alpha[None, :] * w1x[:, None] + beta[None, :]).sum(-1)
    sin2 = np.sin(alpha[None, :] * w2x[:, None] + beta[None, :]).sum(-1)
    y1 = w1x + sin1 + rng.normal(scale=0.01, size=num_examples)
    y2 = w2x + sin2 + rng.normal(scale=0.01, size=num_examples)
    return x.astype(np.float32), (y1.astype(np.float32), y2.astype(np.float32))


@dataclasses.dataclass
class SyntheticForMultiTask:
    """Batched view of the synthetic two-task data."""

    num_examples: int
    example_dim: int = 100
    c: float = 0.3
    p: float = 0.8
    m: int = 5
    seed: int = 42

    def __post_init__(self):
        self._x, (self._y1, self._y2) = synthetic_two_task(
            self.num_examples, self.example_dim, self.c, self.p, self.m,
            self.seed,
        )

    def batches(
        self, epochs: int = 1, batch_size: int = 512
    ) -> Iterator[Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]]:
        steps = self.num_examples // batch_size
        for _ in range(epochs):
            for s in range(steps):
                lo, hi = s * batch_size, (s + 1) * batch_size
                yield (
                    {"features": self._x[lo:hi]},
                    {
                        "labels0": self._y1[lo:hi, None],
                        "labels1": self._y2[lo:hi, None],
                    },
                )

    @staticmethod
    def column_view(features: np.ndarray) -> Dict[str, np.ndarray]:
        """The reference's C0..C{d-1} scalar-column dict view (ref :55-59)."""
        return {
            f"C{i}": features[:, i : i + 1] for i in range(features.shape[1])
        }
