"""Device selection for the port's entry points.

Every entry point renders on CUDA unless the caller names another device.
Without a card and without an explicit device it raises: the port never
runs on the CPU unless asked to.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; None means the current CUDA card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the plain "
                "PyTorch version on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def as_float32(data, device: torch.device) -> torch.Tensor:
    """``data`` (tensor or array-like) as a contiguous float32 tensor on
    ``device``; numpy input is copied, so the tensor never shares a
    read-only buffer."""
    if isinstance(data, torch.Tensor):
        return data.to(device, torch.float32).contiguous()
    return torch.tensor(np.asarray(data, np.float32), device=device)
