"""Carry the JAX package's params across to the port.

``params_from_jax`` takes the JAX params as a nested dict of numpy arrays
(for example ``jax.tree.map(numpy.asarray, params)``) and returns the port's
params dict on ``device``: bf16 leaves go through f32 (numpy has no bf16 of
its own; the JAX side hands over ml_dtypes' bfloat16), every other dtype is
kept.  The layouts are the same in both packages, so nothing is transposed.
"""

from __future__ import annotations

import numpy as np
import torch

from mustafar_tpu_torch.device import resolve_device


def _leaf(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(a.copy()).to(device)


def params_from_jax(np_tree: dict, device=None) -> dict:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``
    (default ``cuda``)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _leaf(node, dev)

    return conv(np_tree)
