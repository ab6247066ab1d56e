"""Compressed Interaction Network (xDeepFM) op.

Counterpart of ``deep_recommenders_tpu/ops/cin.py``. One CIN layer is one
tensor contraction,

    out[b, m, d] = sum_{f,g} x0[b, f, d] * x[b, g, d] * W[f, g, m],

written here as two einsums (x against the kernel first, then x0), in plain
PyTorch. ``ops/cin_kernels.py`` holds the flattened-row kernels.
"""

from __future__ import annotations

import torch


def cin_interaction(
    x0: torch.Tensor, x: torch.Tensor, kernel: torch.Tensor
) -> torch.Tensor:
    """One CIN layer.

    Args:
      x0: (B, F0, D) the original stacked feature embeddings.
      x: (B, F, D) the previous CIN layer output (x0 at layer 0).
      kernel: (F0, F, M) compression weights.

    Returns:
      (B, M, D) feature maps.
    """
    if x0.shape[0] != x.shape[0] or x0.shape[2] != x.shape[2]:
        raise ValueError(
            f"Incompatible CIN inputs {tuple(x0.shape)} / {tuple(x.shape)}"
        )
    t = torch.einsum("bgd,fgm->bfmd", x, kernel)  # (B, F0, M, D)
    return torch.einsum("bfd,bfmd->bmd", x0, t)
