"""Warm start: graft parameter scopes of one model's state into another's.

Counterpart of ``deep_recommenders_tpu/training/warmstart.py``. The ranking
models name their shared submodules alike (``linear``, ``embeddings``), so
an FNN starts from a trained FM by taking over those scopes of its state
dict: a scope is the first component of a parameter name
(``embeddings.table`` lies in ``embeddings``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch

State = Mapping[str, torch.Tensor]


def _scope(state: State, scope: str) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in state.items() if k.split(".", 1)[0] == scope}


def warm_start_from(
    target_state: State,
    source_state: State,
    scopes: Sequence[str] = ("linear", "embeddings"),
) -> Dict[str, torch.Tensor]:
    """A copy of ``target_state`` with each scope of ``scopes`` replaced by
    the source's (copies of its tensors, in the target's dtype and device
    where the target has the entry). Raises KeyError if the source lacks a
    scope, and ValueError if the target has the scope with other names or
    shapes."""
    out = {k: v.clone() for k, v in target_state.items()}
    for scope in scopes:
        src, dst = _scope(source_state, scope), _scope(target_state, scope)
        if not src:
            raise KeyError(f"Source has no scope {scope!r}")
        src_shapes = sorted((k, tuple(v.shape)) for k, v in src.items())
        dst_shapes = sorted((k, tuple(v.shape)) for k, v in dst.items())
        if dst and src_shapes != dst_shapes:
            raise ValueError(
                f"Scope {scope!r} structure mismatch:\n"
                f"  source: {src_shapes}\n  target: {dst_shapes}")
        for k, v in src.items():
            like = dst.get(k, v)
            out[k] = v.detach().to(like.device, like.dtype, copy=True)
    return out
