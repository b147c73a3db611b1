"""Device choice for the port's entry points: ``cuda`` unless asked otherwise."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``.  A CUDA device with no card raises: the port
    never falls back to the CPU on its own; ``device="cpu"`` asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mustafar_tpu_torch: CUDA is not available; pass device='cpu' to "
            "run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
