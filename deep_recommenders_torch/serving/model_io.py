"""Model artifact round trip: constructor config and parameters, reloaded
without the script that built the model.

Counterpart of ``deep_recommenders_tpu/serving/model_io.py``. There a zoo
model is a flax dataclass whose fields are its config; here each zoo class
records the arguments it was constructed with
(``models.common.records_config``), and those are the config.
:func:`save_model` writes the class's import path and the tagged JSON
encoding of its arguments (``config.json``) beside a checkpoint of its
state dict (``params/``); :func:`load_model` re-imports the class,
rebuilds it from the decoded arguments and loads the state.

The encoding is JAX's: ``Feature``, ``CrossedFeature`` and ``DenseFeature``
specs as ``{"__spec__": name, "fields": ...}``, tuples as
``{"__tuple__": [...]}``, so round-tripped configs compare equal. Runtime
arguments (``generator``, ``mesh``) are stored as null. A value JAX refuses
is refused here with ``TypeError``, a ``torch.dtype`` in ``compute_dtype``
among them, as a jnp dtype is in JAX's ``_encode``. The one dtype that is
stored is a ``param_dtype`` argument, the dtype a table is stored in
(``EmbeddingCollection(param_dtype=)``): by name, ``"float32"`` or
``"bfloat16"``, read back by :func:`decode_config`. A saved tensor whose
dtype is not the rebuilt model's is cast to it with a warning
(``checkpoints.warn_dtype_casts``).

A model whose tables (or experts) are sharded over a mesh's "model" axis
saves its whole state: the shards joined over "model", their padding rows
dropped. So an artifact loads meshed or unmeshed; ``load_model(mesh=)``
cuts it to the process's shard.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from deep_recommenders_torch import convert
from deep_recommenders_torch.device import DeviceLike, resolve_device
from deep_recommenders_torch.features.columns import (
    CrossedFeature,
    DenseFeature,
    Feature,
)
from deep_recommenders_torch.parallel.mesh import check_mesh
from deep_recommenders_torch.parallel.sharding import (
    MODEL_AXIS,
    all_gather,
    axis_index,
    axis_size,
)
from deep_recommenders_torch.training.checkpoints import (
    restore_checkpoint,
    save_checkpoint,
    sharded_rows,
    warn_dtype_casts,
)

_SPEC_TYPES = {
    "Feature": Feature,
    "CrossedFeature": CrossedFeature,
    "DenseFeature": DenseFeature,
}

# Arguments holding runtime objects, stored as null.
_RUNTIME_FIELDS = ("mesh", "generator")
# The dtype a table is stored in (a ``param_dtype`` argument), by name.
_PARAM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _encode(v: Any) -> Any:
    if isinstance(v, tuple(_SPEC_TYPES.values())):
        return {
            "__spec__": type(v).__name__,
            "fields": {
                f.name: _encode(getattr(v, f.name))
                for f in dataclasses.fields(v)
            },
        }
    if isinstance(v, tuple):
        return {"__tuple__": [_encode(x) for x in v]}
    if isinstance(v, list):
        return [_encode(x) for x in v]
    if isinstance(v, dict):
        return {k: _encode(x) for k, x in v.items()}
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    raise TypeError(
        f"Field value {v!r} ({type(v).__name__}) is not serializable; "
        "runtime-only fields (mesh, callables) must be defaulted/None when "
        "saving"
    )


def _decode(v: Any) -> Any:
    if isinstance(v, dict):
        if "__spec__" in v:
            cls = _SPEC_TYPES[v["__spec__"]]
            return cls(**{k: _decode(x) for k, x in v["fields"].items()})
        if "__tuple__" in v:
            return tuple(_decode(x) for x in v["__tuple__"])
        return {k: _decode(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_decode(x) for x in v]
    return v


def model_config(model: torch.nn.Module) -> Dict[str, Any]:
    """The model's constructor arguments, encoded; runtime ones as null.
    TypeError for a model whose class records none."""
    args = getattr(model, "constructor_args", None)
    if args is None:
        raise TypeError(f"{type(model).__name__} records no constructor "
                        "arguments (models.common.records_config)")
    return {k: None if k in _RUNTIME_FIELDS else
            _encode_param_dtype(v) if k == "param_dtype" else _encode(v)
            for k, v in args.items()}


def _encode_param_dtype(v: Any) -> str:
    for name, dtype in _PARAM_DTYPES.items():
        if v == dtype:
            return name
    raise TypeError(f"param_dtype={v!r} is not serializable")


def decode_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """The constructor arguments of an encoded config (``model_config``'s
    output, read back from JSON): specs and tuples rebuilt, a
    ``param_dtype`` name turned back into its ``torch.dtype``."""
    kwargs = {k: _decode(v) for k, v in config.items()}
    if "param_dtype" in kwargs:
        if kwargs["param_dtype"] not in _PARAM_DTYPES:
            raise ValueError(f"param_dtype={kwargs['param_dtype']!r}: not "
                             f"one of {sorted(_PARAM_DTYPES)}")
        kwargs["param_dtype"] = _PARAM_DTYPES[kwargs["param_dtype"]]
    return kwargs


def _mesh_of(model: torch.nn.Module):
    """The mesh a model's sharded parameters live on, or None."""
    return next((m.mesh for m in model.modules()
                 if getattr(m, "mesh", None) is not None), None)


def _whole_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict with each row-sharded entry gathered over
    "model" and cut to its rows before padding."""
    state = model.state_dict()
    for name, rows in sharded_rows(model).items():
        state[name] = all_gather(state[name], _mesh_of(model),
                                 MODEL_AXIS)[:rows]
    return state


def save_model(path: str, model: torch.nn.Module) -> str:
    """Persist ``config.json`` (class path and arguments) and ``params/``
    (the state dict). The port takes the module where JAX takes
    ``(model, params)``: a port module holds its parameters.

    A model built on a mesh is saved by every process of the mesh: its
    sharded entries are gathered over "model" and rank 0 writes the whole
    state."""
    path = os.path.abspath(path)
    spec = {
        "module": type(model).__module__,
        "class": type(model).__qualname__,
        "config": model_config(model),
    }
    state = _whole_state(model)
    meshed = _mesh_of(model) is not None
    if not meshed or dist.get_rank() == 0:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(spec, f, indent=1)
        save_checkpoint(os.path.join(path, "params"), state)
    if meshed:
        dist.barrier()
    return path


def load_model(path: str, mesh: Optional[object] = None,
               device: DeviceLike = "cuda") -> torch.nn.Module:
    """Rebuild the model of a :func:`save_model` artifact, with its saved
    parameters, on ``device`` (the card unless the caller asks for the
    CPU). JAX returns ``(model, params)``; the port's model holds them.

    The class must be one of this package's that record their config, so
    a config file cannot make it import anything else.

    ``mesh`` re-attaches a runtime mesh (a ("data", "model")
    ``DeviceMesh``) to a model with a ``mesh`` argument, ValueError for one
    without, as JAX's: the model is rebuilt on the mesh and the saved whole
    state cut to this process's shard (``convert.shard_state``).
    """
    path = os.path.abspath(path)
    device = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        spec = json.load(f)
    if not spec["module"].startswith("deep_recommenders_torch."):
        raise ValueError(f"{spec['module']} is not a module of this package")
    cls = getattr(importlib.import_module(spec["module"]), spec["class"])
    if not getattr(cls, "_records_config", False):
        raise ValueError(f"{cls.__name__} records no config")
    kwargs = decode_config(spec["config"])
    if mesh is not None:
        if "mesh" not in kwargs:
            raise ValueError(f"{cls.__name__} has no mesh field to "
                             "re-attach")
        kwargs["mesh"] = check_mesh(mesh)
    # The initial draw is overwritten by the saved state: keep it off the
    # caller's random stream.
    with torch.random.fork_rng(devices=[]):
        model = cls(**kwargs)
    state = restore_checkpoint(os.path.join(path, "params"))
    warn_dtype_casts(state, model)
    if mesh is not None:
        state = convert.shard_state(state, axis_size(mesh, MODEL_AXIS),
                                    axis_index(mesh, MODEL_AXIS),
                                    sharded_rows(model))
    model.load_state_dict(state)
    return model.to(device)
