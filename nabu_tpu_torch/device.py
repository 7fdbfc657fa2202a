"""Device selection for the port's entry points.

Every entry point runs on the GPU unless its caller asks for the CPU.
Without a GPU and without an explicit CPU request it raises: it never
carries on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None or "cuda[:i]" -> a CUDA device (raises if there is none);
    "cpu" -> the CPU, only when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}; use cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run on the CPU"
        )
    return dev
