"""Checkpoints of tensor state: save, restore, step directories.

Counterpart of ``deep_recommenders_tpu/training/checkpoints.py``, with
``torch.save`` in place of Orbax. A checkpoint is a directory holding
``state.pt``: a state dict (or a nested dict of them, such as
``{"model": ..., "optimizer": ...}``) of tensors and plain values. It is
read back with ``torch.load(weights_only=True)``, which unpickles no
arbitrary object.

A trainer's state under a mesh (:func:`save_train_state`,
:func:`restore_train_state`) is sharded where the model is: at model > 1
each model coordinate's file holds its rows of the sharded tables and of
their optimizer moments, and a record of the mesh lets the state be joined
and cut again for another mesh, as Orbax restores a sharded checkpoint
under a new mesh by resharding.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from deep_recommenders_torch import convert
from deep_recommenders_torch.parallel.sharding import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_index,
    axis_size,
    is_row_shard,
)

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


def _cast(saved: torch.Tensor, dtype: torch.dtype,
          where: str) -> torch.Tensor:
    """``saved`` in ``dtype``, rounded to nearest as JAX's restore casts a
    saved array to its template's dtype; the cast is not silent here: it
    warns (an fp32 checkpoint read into a bf16 table loses its low bits)."""
    if saved.dtype != dtype:
        warnings.warn(f"checkpoint entry {where or 'the root'}: saved "
                      f"{saved.dtype}, restored as {dtype}", stacklevel=3)
    return saved.to(dtype)


def warn_dtype_casts(state: Dict[str, torch.Tensor],
                     model: torch.nn.Module) -> None:
    """Warn, as :func:`_cast`, for each entry of ``state`` whose dtype is
    not the model's: ``load_state_dict`` would cast it without a word."""
    own = model.state_dict()
    for key, value in state.items():
        if (key in own and isinstance(value, torch.Tensor)
                and value.dtype != own[key].dtype):
            _cast(value, own[key].dtype, key)


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
        return _cast(saved, template.dtype, where).to(template.device)
    return saved


def restore_checkpoint(path: str, template: Optional[Any] = None) -> Any:
    """Read the state saved at ``path``. ``template`` (a state of the same
    structure) pins the structure, the shapes, the dtypes and the devices:
    a structure or shape that differs raises ValueError, and a tensor saved
    in another dtype is cast to the template's, as JAX's restore casts it,
    with a warning. Without it the saved state is returned as it was saved
    (tensors on the CPU)."""
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


# -- training state under a mesh -------------------------------------------

_LAYOUT = "sharding.json"


def _shard_file(index: int) -> str:
    return f"model_{index}.pt"


def sharded_rows(model: torch.nn.Module) -> Dict[str, int]:
    """{state dict key: leading size of the whole tensor before padding}
    of the model's parameters that a mesh cuts over "model"."""
    return {name: p.full_rows for name, p in model.named_parameters()
            if is_row_shard(p)}


def _optimizer_names(model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer) -> List[str]:
    """The state dict keys of the optimizer's parameters, in its order."""
    name_of = {id(p): name for name, p in model.named_parameters()}
    return [name_of[id(p)] for g in optimizer.param_groups
            for p in g["params"]]


def _coordinates(mesh) -> Tuple[int, int, int]:
    """(data size, model size, model coordinate); (1, 1, 0) unmeshed."""
    if mesh is None:
        return 1, 1, 0
    return (axis_size(mesh, DATA_AXIS), axis_size(mesh, MODEL_AXIS),
            axis_index(mesh, MODEL_AXIS))


def save_train_state(path: str, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer, mesh=None) -> None:
    """Write the model's and the optimizer's state dicts into the
    checkpoint directory ``path``; every process of the mesh calls it.

    Unmeshed or at model = 1 the state is whole and one process (rank 0)
    writes ``state.pt``. At model > 1 the processes of data coordinate 0
    each write their model coordinate's state, ``model_{m}.pt`` (a
    row-sharded table's Adam or Adagrad moments are its rows' too), and
    model coordinate 0 writes ``sharding.json``: the mesh and each sharded
    entry's row count before padding, which :func:`restore_train_state`
    reads to cut the state for another mesh."""
    n_data, n_model, m = _coordinates(mesh)
    state = {"model": model.state_dict(), "optimizer": optimizer.state_dict()}
    if n_model == 1:
        if mesh is None or dist.get_rank() == 0:
            save_checkpoint(path, state)
    elif axis_index(mesh, DATA_AXIS) == 0:
        os.makedirs(path, exist_ok=True)
        target = os.path.join(path, _shard_file(m))
        torch.save(state, f"{target}.tmp")
        os.replace(f"{target}.tmp", target)
        if m == 0:
            with open(os.path.join(path, _LAYOUT), "w") as f:
                json.dump({"mesh": [n_data, n_model],
                           "rows": sharded_rows(model)}, f)
    if mesh is not None:
        dist.barrier()


def _load(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_train_state(path: str, model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer, mesh=None) -> None:
    """Load a :func:`save_train_state` checkpoint into ``model`` and
    ``optimizer``, built for ``mesh`` (or for none).

    Under the mesh it was saved on, each process reads its own model
    coordinate's file. Under a mesh of another model size, or none, the
    saved shards are joined (``convert.join_shards``,
    ``join_optimizer_shards``), the padding rows dropped, and the whole
    state cut again for this process (``shard_state``,
    ``shard_optimizer_state``; new padding rows are zero). An entry saved
    in another dtype than the model's is cast to it with a warning, as
    :func:`restore_checkpoint` casts one."""
    _, n_model, m = _coordinates(mesh)
    names = _optimizer_names(model, optimizer)
    cuts = sharded_rows(model)
    layout_path = os.path.join(path, _LAYOUT)
    if not os.path.exists(layout_path):
        whole = restore_checkpoint(path)
    else:
        with open(layout_path) as f:
            layout = json.load(f)
        saved_n = layout["mesh"][1]
        if saved_n == n_model:
            state = _load(os.path.join(path, _shard_file(m)))
            warn_dtype_casts(state["model"], model)
            model.load_state_dict(state["model"])
            optimizer.load_state_dict(state["optimizer"])
            return
        rows = layout["rows"]
        parts = [_load(os.path.join(path, _shard_file(i)))
                 for i in range(saved_n)]
        whole = {
            "model": convert.join_shards([p["model"] for p in parts],
                                         rows),
            "optimizer": convert.join_optimizer_shards(
                [p["optimizer"] for p in parts], names, rows),
        }
        whole["model"] = {k: v[:rows[k]] if k in rows else v
                          for k, v in whole["model"].items()}
        whole["optimizer"] = convert._map_moments(
            whole["optimizer"], names, lambda k, t: t[:rows[k]], rows)
    warn_dtype_casts(whole["model"], model)
    model.load_state_dict(convert.shard_state(whole["model"], n_model, m,
                                              cuts))
    optimizer.load_state_dict(convert.shard_optimizer_state(
        whole["optimizer"], names, n_model, m, cuts))
