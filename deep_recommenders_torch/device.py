"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Check that ``device`` exists and prepare it.

    A CUDA device with no GPU present raises instead of running on the CPU.
    On the card path this turns TF32 off for float32 matmuls and cuDNN, so
    float32 work stays float32 (the JAX reference computes in full fp32).
    The fp32 flash-attention kernels (K5, K6) use the tensor cores all the
    same, at fp32 accuracy: each product in three TF32 passes over split
    operands (3xTF32), within 13 units of fp32 roundoff of the exact
    product where one TF32 pass is 2^14 off; the card checks against fp64
    (``ops/attention_tolerances.py``) hold them to fp32-sized bounds and
    reject a single pass.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but no CUDA device is available; pass "
                "device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def check_compute_dtype(dtype):
    """The models' mixed precision: None (fp32) or ``torch.bfloat16``."""
    if dtype not in (None, torch.bfloat16):
        raise ValueError(f"compute_dtype must be None (fp32) or "
                         f"torch.bfloat16, got {dtype}")
    return dtype


def check_param_dtype(dtype):
    """The dtype a table is stored in: ``torch.float32`` or
    ``torch.bfloat16``."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"param_dtype must be torch.float32 or "
                         f"torch.bfloat16, got {dtype}")
    return dtype
