"""Device resolution for the port's entry points.

The rule: an entry point runs on the GPU unless its caller asks for the CPU.
``device=None`` means CUDA, and a CUDA request on a machine without a GPU
raises; nothing falls back to the CPU silently.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA request needs a visible GPU.

    Raises:
      RuntimeError: CUDA was requested (explicitly or by default) and
        ``torch.cuda.is_available()`` is false.
      ValueError: a device type other than ``cpu`` or ``cuda``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the GPU by default and no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
