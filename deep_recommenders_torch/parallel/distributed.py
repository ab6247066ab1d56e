"""Multi-process initialisation (counterpart of
``deep_recommenders_tpu/parallel/distributed.py``).

Each process runs the same program on one device and joins one
``torch.distributed`` process group. The arguments default from the
environment variables JAX's ``initialize`` reads: ``COORDINATOR_ADDRESS``
(``host:port`` of rank 0's rendezvous), ``NUM_PROCESSES`` and
``PROCESS_ID``. Nothing on a machine tells a program of its cluster, so a
multi-process run gives all three.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from deep_recommenders_torch.device import DeviceLike, resolve_device

# The backend that follows each device type.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: DeviceLike = "cuda",
    backend: Optional[str] = None,
) -> bool:
    """Join the process group; returns True when more than one process runs.

    With no coordinator and no process count (arguments or environment) it
    is a no-op that returns False: one process needs no group. Otherwise
    every argument must be known; the group is created over
    ``tcp://{coordinator_address}`` with the backend that follows ``device``
    (``nccl`` on the card, ``gloo`` on the CPU) unless ``backend`` names
    one, and on the card the process's device is set to
    ``cuda:{process_id % device_count}``. Called again in a process that
    has a group, it changes nothing.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("NUM_PROCESSES"):
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and os.environ.get("PROCESS_ID"):
        process_id = int(os.environ["PROCESS_ID"])
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None and num_processes is None:
        return False
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            "initialize needs coordinator_address, num_processes and "
            "process_id (or COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID)")
    device = resolve_device(device)
    backend = backend or BACKENDS[device.type]
    if device.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )
    return num_processes > 1
