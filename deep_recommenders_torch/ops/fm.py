"""FM second-order interaction op (K2).

Counterpart of ``deep_recommenders_tpu/ops/fm.py``: the O(F*D) sum-square
trick 0.5 * sum_d[(sum_f v)^2 - sum_f v^2] over stacked per-feature
embeddings (B, F, D) -> (B, 1).

- :func:`fm_interaction`: plain torch, the one DeepFM calls (as the JAX
  DeepFM calls the plain jnp version).
- :func:`fm_interaction_fused`: the counterpart of ``fm_interaction_pallas``.
  On a CUDA tensor it launches ``csrc/fm_interaction.cu`` (one warp per row,
  one read of the embeddings); on a CPU tensor it is :func:`fm_interaction`.
  Forward only, as in JAX.
"""

from __future__ import annotations

import ctypes

import torch

from deep_recommenders_torch.ops import _build

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
]


def fm_interaction(embeddings: torch.Tensor) -> torch.Tensor:
    """(B, F, D) stacked feature embeddings -> (B, 1) interaction logit.

    Reductions accumulate in fp32 regardless of input dtype: the
    (sum)^2 - sum^2 cancellation loses significance in 8-bit mantissas.
    """
    x = embeddings.float()
    sum_v = x.sum(dim=1)  # (B, D)
    sum_sq = sum_v.square().sum(dim=-1)  # (B,)
    sq_sum = x.square().sum(dim=(1, 2))  # (B,)
    return (0.5 * (sum_sq - sq_sum))[:, None]


def fm_interaction_fused(embeddings: torch.Tensor) -> torch.Tensor:
    """Kernel K2 on a CUDA tensor; identical math to :func:`fm_interaction`.

    Counts each launch in ``fm_interaction_fused.launches``.
    """
    if embeddings.device.type == "cpu":
        return fm_interaction(embeddings)
    if embeddings.device.type != "cuda":
        raise ValueError(f"fm_interaction_fused: unsupported device "
                         f"{embeddings.device}")
    if embeddings.dtype != torch.float32 or embeddings.dim() != 3:
        raise TypeError(
            "fm_interaction_fused: embeddings must be (B, F, D) float32, got "
            f"{embeddings.dtype} {tuple(embeddings.shape)}"
        )
    b, f, d = embeddings.shape
    out = torch.empty((b, 1), dtype=torch.float32, device=embeddings.device)
    if b == 0:
        return out
    if f * d >= 2**31 or b >= 2**34:
        raise ValueError(f"fm_interaction_fused: shape {(b, f, d)} too large")
    x = embeddings.contiguous()
    fn = _build.function("fm_interaction", "fm_interaction_f32", _ARGTYPES)
    code = fn(
        x.data_ptr(), out.data_ptr(), b, f, d,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(code, "fm_interaction_fused")
    fm_interaction_fused.launches += 1
    return out


fm_interaction_fused.launches = 0
