"""Ops with hand-written CUDA kernels, each beside its plain version, and
the JAX package's other exported ops (``deep_recommenders_tpu/ops``).
JAX's ``fm_interaction_pallas`` (K2) is ``fm_interaction_fused`` here."""

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
from deep_recommenders_torch.ops.dice import dice
from deep_recommenders_torch.ops.fm import fm_interaction, fm_interaction_fused
from deep_recommenders_torch.ops.retrieval import (
    hard_negative_mining,
    in_batch_retrieval_loss,
    pod_retrieval_loss,
    remove_accidental_negatives,
    sampling_probability_correction,
)
from deep_recommenders_torch.ops.topk import (
    chunked_top_k,
    exclude,
    merge_top_k,
    sharded_top_k,
    top_k_scores,
)
