"""Checkpoints of tensor state: save, restore, step directories.

Counterpart of ``deep_recommenders_tpu/training/checkpoints.py``, with
``torch.save`` in place of Orbax. A checkpoint is a directory holding
``state.pt``: a state dict (or a nested dict of them, such as
``{"model": ..., "optimizer": ...}``) of tensors and plain values. It is
read back with ``torch.load(weights_only=True)``, which unpickles no
arbitrary object.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

_FILE = "state.pt"


def save_checkpoint(path: str, state: Any, force: bool = True) -> str:
    """Write ``state`` into the directory ``path`` (made if missing) and
    return its absolute path. An existing checkpoint there is replaced when
    ``force`` is True and raises FileExistsError otherwise."""
    path = os.path.abspath(path)
    target = os.path.join(path, _FILE)
    if os.path.exists(target) and not force:
        raise FileExistsError(f"checkpoint exists: {path}")
    os.makedirs(path, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, target)  # a reader sees the old file or the new one
    return path


def _restore_like(saved: Any, template: Any, where: str) -> Any:
    if isinstance(template, dict):
        if not isinstance(saved, dict) or set(saved) != set(template):
            raise ValueError(
                f"checkpoint structure differs at {where or 'the root'}: "
                f"saved {sorted(saved) if isinstance(saved, dict) else saved!r}"
                f", template {sorted(template)}")
        return {k: _restore_like(saved[k], v, f"{where}/{k}")
                for k, v in template.items()}
    if isinstance(template, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != template.shape:
            raise ValueError(f"checkpoint entry {where}: saved "
                             f"{getattr(saved, 'shape', saved)}, template "
                             f"{tuple(template.shape)}")
        return saved.to(template.device, template.dtype)
    return saved


def restore_checkpoint(path: str, template: Optional[Any] = None) -> Any:
    """Read the state saved at ``path``. ``template`` (a state of the same
    structure) pins the structure, the shapes, the dtypes and the devices:
    a mismatch raises ValueError. Without it the saved state is returned as
    it was saved (tensors on the CPU)."""
    path = os.path.abspath(path)
    saved = torch.load(os.path.join(path, _FILE), map_location="cpu",
                       weights_only=True)
    return saved if template is None else _restore_like(saved, template, "")


def list_step_dirs(root: str) -> list:
    """All checkpoint dirs under root (step_N naming), ordered by step."""
    if not os.path.isdir(root):
        return []
    entries = [e for e in os.listdir(root) if e.startswith("step_")]
    entries.sort(key=lambda e: int(e.split("_")[1]))
    return [os.path.join(root, e) for e in entries]


def latest_step_dir(root: str) -> Optional[str]:
    """The checkpoint dir of the highest step under root, or None."""
    dirs = list_step_dirs(root)
    return dirs[-1] if dirs else None
