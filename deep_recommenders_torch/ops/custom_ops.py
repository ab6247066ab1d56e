"""The forward kernels K3, K4 and K5 as operators that ``torch.export``
records.

``torch.export`` traces a model with fake tensors, which have no data
pointer, so a kernel launched through ctypes on ``tensor.data_ptr()``
cannot be traced. Each forward kernel on a served path is therefore a
``torch.library`` custom op in the ``deep_recommenders_torch`` namespace:

- the CUDA implementation checks its inputs and launches the kernel on the
  current stream, with the shared-memory checks, the padded weight tiles
  and the launch count;
- the CPU implementation is the kernel's plain version;
- the fake implementation gives only the outputs' shapes and dtypes.

``ops/cin_kernels.py`` registers ``cin_stack_fwd`` (K3 with its residuals
z1, z2), ``cin_stack_fwd_pooled`` (K3 without them, the inference call) and
``cin2d_fwd`` (K4); ``ops/attention.py`` registers ``flash_attention_fwd``
(fp32 K5) and ``flash_attention_fwd_bf16`` (bf16 K5). A saved program finds
them by name only: :func:`load_registrations` imports those modules, and
must run before ``torch.export.load`` reads a program that calls them.
"""

from __future__ import annotations

import importlib
from typing import Callable, Iterable, Set

import torch

NAMESPACE = "deep_recommenders_torch"

# The modules whose import registers the ops.
_REGISTERING_MODULES = ("deep_recommenders_torch.ops.cin_kernels",
                        "deep_recommenders_torch.ops.attention")


def kernel_op(name: str, schema: str, cuda: Callable, cpu: Callable,
              fake: Callable):
    """Register ``NAMESPACE::name`` with its ``schema``: ``cuda`` runs on
    CUDA tensors, ``cpu`` on CPU tensors and ``fake`` under tracing.
    Returns the op (``torch.ops.deep_recommenders_torch.<name>``)."""
    torch.library.custom_op(f"{NAMESPACE}::{name}", cuda, mutates_args=(),
                            device_types="cuda", schema=schema)
    op = getattr(getattr(torch.ops, NAMESPACE), name)
    torch.library.register_kernel(op.default, "cpu", cpu)
    torch.library.register_fake(op.default, fake)
    return op


def load_registrations() -> None:
    """Import every module that registers an op of ``NAMESPACE``."""
    for module in _REGISTERING_MODULES:
        importlib.import_module(module)


def graph_ops(graph_module: torch.nn.Module) -> Set[str]:
    """The names of the ``NAMESPACE`` ops that the graph of an exported
    program (``ExportedProgram.graph_module`` or ``.module()``) calls."""
    found = set()
    nodes: Iterable = graph_module.graph.nodes
    for node in nodes:
        target = node.target
        if node.op == "call_function" and isinstance(
                target, torch._ops.OpOverload) and \
                target.namespace == NAMESPACE:
            found.add(target._opname)
    return found
