"""Weight conversion from the JAX package's flax parameter trees.

The tree arrives as numpy arrays (``jax.tree.map(np.asarray, params)``), so
this module needs neither JAX nor flax.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _tensor(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def deepfm_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``DeepFM`` parameter tree -> the port's ``DeepFM`` state dict.

    - ``embeddings/table`` (V, D) -> ``embeddings.table``;
    - ``linear/weights`` (V, 1) and ``linear/bias`` (1,) as they are;
    - ``deep/Dense_i/kernel`` (in, out) -> ``deep.dense.i.weight`` (out, in),
      transposed, and ``deep/Dense_i/bias`` -> ``deep.dense.i.bias``.

    ``params`` may be the whole ``{"params": ...}`` collection or its inside.
    """
    p = params.get("params", params)
    state = {
        "embeddings.table": _tensor(p["embeddings"]["table"]),
        "linear.weights": _tensor(p["linear"]["weights"]),
        "linear.bias": _tensor(p["linear"]["bias"]),
    }
    deep = p["deep"]
    for i in range(len(deep)):
        layer = deep[f"Dense_{i}"]
        state[f"deep.dense.{i}.weight"] = _tensor(np.asarray(layer["kernel"]).T)
        state[f"deep.dense.{i}.bias"] = _tensor(layer["bias"])
    return state
