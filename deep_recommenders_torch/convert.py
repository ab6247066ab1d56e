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


def _tables_and_deep(p: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
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


def deepfm_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``DeepFM`` parameter tree -> the port's ``DeepFM`` state dict.

    - ``embeddings/table`` (V, D) -> ``embeddings.table``;
    - ``linear/weights`` (V, 1) and ``linear/bias`` (1,) as they are;
    - ``deep/Dense_i/kernel`` (in, out) -> ``deep.dense.i.weight`` (out, in),
      transposed, and ``deep/Dense_i/bias`` -> ``deep.dense.i.bias``.

    ``params`` may be the whole ``{"params": ...}`` collection or its inside.
    """
    return _tables_and_deep(params.get("params", params))


def xdeepfm_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``XDeepFM`` parameter tree -> the port's ``XDeepFM`` state dict.

    The tables and the MLP map as in :func:`deepfm_from_flax`, and:

    - the fused stack's ``cin_w1`` (F0, F0, M1) and ``cin_w2`` (F0, M1, M2)
      as they are;
    - the layered stack's ``cins_i/kernel`` (F0, F_prev, M_i) ->
      ``cins.i.kernel`` (and ``cins_i/bias`` where present);
    - ``cin_head/kernel`` (sum M_i, 1) -> ``cin_head.weight`` (1, sum M_i).
    """
    p = params.get("params", params)
    state = _tables_and_deep(p)
    state["cin_head.weight"] = _tensor(np.asarray(p["cin_head"]["kernel"]).T)
    if "cin_w1" in p:
        state["cin_w1"] = _tensor(p["cin_w1"])
        state["cin_w2"] = _tensor(p["cin_w2"])
    i = 0
    while f"cins_{i}" in p:
        for name, value in p[f"cins_{i}"].items():
            state[f"cins.{i}.{name}"] = _tensor(value)
        i += 1
    return state
