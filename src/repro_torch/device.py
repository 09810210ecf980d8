"""Where the port runs: on the card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means CUDA; without a card that raises instead of falling
    back to the CPU, which has to be asked for with ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def as_tensor(x, *, device: torch.device,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A tensor on ``device`` from a tensor or an array-like (numpy)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    x = np.asarray(x)
    if not x.flags.writeable:          # e.g. a view of a JAX array
        x = x.copy()
    return torch.as_tensor(x, dtype=dtype, device=device)
