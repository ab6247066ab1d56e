"""Ops with hand-written CUDA kernels, each beside its plain version."""

from deep_recommenders_torch.ops.attention import (
    FlashAttention,
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_reference,
    flash_attention_reference,
    scaled_dot_product_attention,
)
from deep_recommenders_torch.ops.cin import cin_interaction
from deep_recommenders_torch.ops.cin_kernels import (
    cin2d,
    cin2d_backward_reference,
    cin2d_reference,
    cin2d_reference_bf16,
    cin_interaction_fused,
    cin_stack_pooled,
    stack_backward_reference,
    stack_reference,
)
from deep_recommenders_torch.ops.embedding_kernels import (
    lookup,
    scatter_add_rows,
    scatter_add_rows_reference,
)
from deep_recommenders_torch.ops.fm import fm_interaction, fm_interaction_fused
