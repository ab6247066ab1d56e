from deep_recommenders_torch.models.multitask.esmm import ESMM
from deep_recommenders_torch.models.multitask.mmoe import (
    MMoE,
    StackedMLP,
    expert_range,
    shard_expert_params,
)
