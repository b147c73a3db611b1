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


def device_int(x, device) -> torch.Tensor:
    """A count as a 0-d int64 tensor on ``device``: a tensor as it is
    (reshaped, cast), a host int filled in by a kernel, with no
    host-to-device copy (a copy from pageable memory waits for the
    stream)."""
    if torch.is_tensor(x):
        return x.reshape(()).to(torch.int64)
    return torch.full((), int(x), dtype=torch.int64, device=device)
