"""The port's parallelism over ``torch.distributed``: one process per device.

Counterpart of ``deep_recommenders_tpu/parallel``. A 2-D ("data", "model")
:class:`~torch.distributed.device_mesh.DeviceMesh` carries data parallelism
(each process feeds its data coordinate's slice of every global batch;
gradients are all-reduced over the data group) and row-sharded embedding
tables (each process holds its model coordinate's rows; see
``embedding/sharded.py``).
"""

from deep_recommenders_torch.parallel.distributed import (
    initialize as initialize_distributed,
)
from deep_recommenders_torch.parallel.mesh import (
    MeshConfig,
    check_mesh,
    create_mesh,
    get_default_mesh,
    set_default_mesh,
)
from deep_recommenders_torch.parallel.sharding import (
    DATA_AXIS,
    MODEL_AXIS,
    all_gather,
    all_reduce,
    axis_group,
    axis_index,
    axis_size,
    host_array,
    is_row_shard,
    replicate_on_mesh,
    row_range,
    row_shard,
    shard_batch,
)
