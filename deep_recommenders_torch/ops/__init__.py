"""Ops with hand-written CUDA kernels, each beside its plain version."""

from deep_recommenders_torch.ops.embedding_kernels import (
    lookup,
    scatter_add_rows,
    scatter_add_rows_reference,
)
from deep_recommenders_torch.ops.fm import fm_interaction, fm_interaction_fused
