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
