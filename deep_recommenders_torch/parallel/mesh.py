"""The 2-D ("data", "model") device mesh (counterpart of
``deep_recommenders_tpu/parallel/mesh.py``).

"data" carries data parallelism: each process feeds its data coordinate's
slice of every global batch, and gradients are all-reduced over the data
group. "model" carries row-sharded embedding tables: each process holds its
model coordinate's rows, and one all-reduce over the model group completes
a lookup. Ranks lie on the mesh row-major: rank = data index * model size +
model index.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXIS_NAMES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape. -1 means "all remaining devices"."""

    data: int = -1
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        data, model = self.data, self.model
        if data == -1 and model == -1:
            raise ValueError("At most one mesh axis may be -1")
        if model == -1:
            model = n_devices // max(data, 1)
        if data == -1:
            data = n_devices // max(model, 1)
        if data * model != n_devices:
            raise ValueError(
                f"Mesh {data}x{model} does not cover {n_devices} devices"
            )
        return data, model


def create_mesh(config: Optional[MeshConfig] = None, *,
                device: str = "cuda") -> DeviceMesh:
    """A ("data", "model") mesh over every process of the group (one device
    each), built by ``init_device_mesh`` with one process group per axis.
    ``device`` is the mesh's device type, the card's unless the caller asks
    for the CPU. Needs a process group (``parallel.initialize``)."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call "
                           "deep_recommenders_torch.parallel."
                           "initialize_distributed first")
    shape = (config or MeshConfig()).resolve(dist.get_world_size())
    return init_device_mesh(device, shape, mesh_dim_names=AXIS_NAMES)


def check_mesh(mesh) -> DeviceMesh:
    """``mesh`` if it is a ("data", "model") DeviceMesh, else TypeError."""
    if not (isinstance(mesh, DeviceMesh)
            and mesh.mesh_dim_names == AXIS_NAMES):
        raise TypeError(f"mesh must be a DeviceMesh with dims {AXIS_NAMES} "
                        f"(parallel.create_mesh), got {mesh!r}")
    return mesh


_DEFAULT_MESH: Optional[DeviceMesh] = None


def set_default_mesh(mesh: Optional[DeviceMesh]) -> None:
    global _DEFAULT_MESH
    _DEFAULT_MESH = None if mesh is None else check_mesh(mesh)


def get_default_mesh() -> DeviceMesh:
    """The process-wide default mesh, created pure data-parallel on first
    use."""
    global _DEFAULT_MESH
    if _DEFAULT_MESH is None:
        _DEFAULT_MESH = create_mesh(MeshConfig(data=-1, model=1))
    return _DEFAULT_MESH
