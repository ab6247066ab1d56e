"""Serving export: a model's forward saved with ``torch.export``.

Counterpart of ``deep_recommenders_tpu/serving/export.py``, with
``torch.export`` in place of ``jax.export``. An exported directory holds:

- ``predict.pt2``: the model's forward on a batch dict, traced by
  ``torch.export`` and written by ``torch.export.save``; it runs without
  the model's Python class.
- ``params/``: the model's state dict as a checkpoint
  (``training.checkpoints.save_checkpoint``, read back with
  ``weights_only=True``).
- ``signature.json``: the inputs by name, ``{"shape": ["batch", ...],
  "dtype": "int32" | "float32" | ...}``, in the JAX package's schema.

:func:`export_model` writes it; :func:`load_serving_module` restores a
:class:`ServingModule` that runs the program.

Where JAX's StableHLO carries its Pallas kernels inline, a ``.pt2`` names
the port's kernel ops only (``deep_recommenders_torch::cin_stack_fwd_pooled``,
``cin2d_fwd``, ``flash_attention_fwd``, ``flash_attention_fwd_bf16``;
``ops/custom_ops.py``): serving an artifact needs this package, whose
registrations :func:`load_serving_module` imports before
``torch.export.load``. The program runs on the device it was exported on.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

from deep_recommenders_torch.device import DeviceLike, resolve_device
from deep_recommenders_torch.ops import custom_ops
from deep_recommenders_torch.training.checkpoints import (
    restore_checkpoint,
    save_checkpoint,
)

_PROGRAM = "predict.pt2"


def _signature(batch: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, Any]]:
    return {
        name: {"shape": ["batch"] + list(x.shape[1:]),
               "dtype": str(x.dtype).replace("torch.", "")}
        for name, x in batch.items()
    }


def _batch_on(batch: Mapping[str, Any], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v).to(device) for k, v in batch.items()}


def export_model(
    path: str,
    model: torch.nn.Module,
    sample_batch: Mapping[str, Any],
    polymorphic_batch: bool = True,
) -> str:
    """Export ``model(batch)`` as a serving artifact under ``path``.

    The port takes the module, called on the batch dict, where JAX takes
    ``(apply_fn, params)``: a port module holds its parameters. The forward
    is traced in eval mode without gradients, so the program computes
    what inference computes (K3 without its residuals). The sample batch
    goes to the device of the model's parameters.

    ``polymorphic_batch=True`` gives every input's leading dim one
    ``torch.export.Dim``, so any batch size is served (SavedModel's None
    batch dim). A model in which the batch size decides a branch cannot
    be exported so: the Transformer on the card, whose attention goes to
    K5 or to the dense path by the bytes of its score tensors, raises
    ``ValueError`` (``ops.attention.use_flash_for``), and a guard on the
    batch size raises ``torch.export``'s own error. Export such a model
    with ``polymorphic_batch=False``: the program then serves the sample's
    batch size alone and refuses any other. It is never specialised to the
    sample's batch size without being asked.
    """
    path = os.path.abspath(path)
    device = next(model.parameters()).device
    batch = _batch_on(sample_batch, device)
    dynamic = None
    if polymorphic_batch:
        dim = torch.export.Dim("batch")
        dynamic = ({name: {0: dim} for name in batch},)
    training = model.training
    model.eval()
    try:
        with torch.no_grad():
            program = torch.export.export(model, (batch,),
                                          dynamic_shapes=dynamic)
    finally:
        model.train(training)
    os.makedirs(path, exist_ok=True)
    torch.export.save(program, os.path.join(path, _PROGRAM))
    save_checkpoint(os.path.join(path, "params"), model.state_dict())
    with open(os.path.join(path, "signature.json"), "w") as f:
        json.dump(_signature(batch), f, indent=2)
    return path


class ServingModule:
    """A loaded serving artifact: validates feeds and runs the program.

    ``program`` is the ``torch.export.ExportedProgram``; ``module`` the
    module that runs it, on ``device``."""

    def __init__(self, program, module: torch.nn.Module,
                 signature: Dict[str, Any], device: torch.device):
        self.program = program
        self.module = module
        self.signature = signature
        self.device = device

    def __call__(self, batch: Mapping[str, Any]):
        missing = set(self.signature) - set(batch)
        if missing:
            raise ValueError(f"missing serving inputs: {sorted(missing)}")
        # In the signature's order: the program's inputs are that dict.
        feed = _batch_on({k: batch[k] for k in self.signature}, self.device)
        with torch.no_grad():
            return self.module(feed)


def load_serving_module(path: str,
                        device: DeviceLike = "cuda") -> ServingModule:
    """Load an :func:`export_model` artifact to serve on ``device`` (the
    card unless the caller asks for the CPU), which must be the device it
    was exported on (ValueError otherwise). The kernel ops' registrations
    are imported first; ``params/`` is then loaded into the program, so a
    retrained checkpoint of the same shapes serves with the same
    program."""
    path = os.path.abspath(path)
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    custom_ops.load_registrations()
    program = torch.export.load(os.path.join(path, _PROGRAM))
    module = program.module()
    state = module.state_dict()
    exported_on = {t.device for t in state.values()}
    if exported_on and exported_on != {device}:
        raise ValueError(f"load_serving_module: the program was exported on "
                         f"{sorted(map(str, exported_on))}; serve it there, "
                         f"not on {device}")
    module.load_state_dict(
        restore_checkpoint(os.path.join(path, "params"), state))
    with open(os.path.join(path, "signature.json")) as f:
        signature = json.load(f)
    return ServingModule(program, module, signature, device)
