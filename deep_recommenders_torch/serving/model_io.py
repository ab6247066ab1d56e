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

The encoding is JAX's: ``Feature`` and ``CrossedFeature`` specs as
``{"__spec__": name, "fields": ...}``, tuples as ``{"__tuple__": [...]}``,
so round-tripped configs compare equal. Runtime arguments (``generator``,
``mesh``) are stored as null. A value JAX refuses is refused here with
``TypeError``, a ``torch.dtype`` in ``compute_dtype`` among them, as a jnp
dtype is in JAX's ``_encode``.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
from typing import Any, Dict, Optional

import torch

from deep_recommenders_torch.device import DeviceLike, resolve_device
from deep_recommenders_torch.features.columns import CrossedFeature, Feature
from deep_recommenders_torch.training.checkpoints import (
    restore_checkpoint,
    save_checkpoint,
)

_SPEC_TYPES = {
    "Feature": Feature,
    "CrossedFeature": CrossedFeature,
}

# Arguments holding runtime objects, stored as null.
_RUNTIME_FIELDS = ("mesh", "generator")


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
    return {k: None if k in _RUNTIME_FIELDS else _encode(v)
            for k, v in args.items()}


def save_model(path: str, model: torch.nn.Module) -> str:
    """Persist ``config.json`` (class path and arguments) and ``params/``
    (the state dict). The port takes the module where JAX takes
    ``(model, params)``: a port module holds its parameters."""
    path = os.path.abspath(path)
    spec = {
        "module": type(model).__module__,
        "class": type(model).__qualname__,
        "config": model_config(model),
    }
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(spec, f, indent=1)
    save_checkpoint(os.path.join(path, "params"), model.state_dict())
    return path


def load_model(path: str, mesh: Optional[object] = None,
               device: DeviceLike = "cuda") -> torch.nn.Module:
    """Rebuild the model of a :func:`save_model` artifact, with its saved
    parameters, on ``device`` (the card unless the caller asks for the
    CPU). JAX returns ``(model, params)``; the port's model holds them.

    The class must be one of this package's that record their config, so
    a config file cannot make it import anything else. ``mesh`` raises
    NotImplementedError until the port has sharding.
    """
    if mesh is not None:
        raise NotImplementedError("mesh sharding is not ported yet")
    path = os.path.abspath(path)
    device = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        spec = json.load(f)
    if not spec["module"].startswith("deep_recommenders_torch."):
        raise ValueError(f"{spec['module']} is not a module of this package")
    cls = getattr(importlib.import_module(spec["module"]), spec["class"])
    if not getattr(cls, "_records_config", False):
        raise ValueError(f"{cls.__name__} records no config")
    kwargs = {k: _decode(v) for k, v in spec["config"].items()}
    # The initial draw is overwritten by the saved state: keep it off the
    # caller's random stream.
    with torch.random.fork_rng(devices=[]):
        model = cls(**kwargs)
    model.load_state_dict(restore_checkpoint(os.path.join(path, "params")))
    return model.to(device)
