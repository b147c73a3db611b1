"""Rotary position embeddings (Llama-2/3), port of ``mustafar_tpu/models/rope.py``.

head_dim splits into two halves; cos/sin come from
``inv_freq = theta ** (-2i/d)`` duplicated across the halves.  Supports the
Llama-3.1 "llama3" and "linear" rope-scaling recipes.
"""

from __future__ import annotations

import math

import torch


def _inv_freq(head_dim: int, theta: float, rope_scaling: dict | None,
              device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponents)
    if rope_scaling:
        kind = rope_scaling.get("rope_type", rope_scaling.get("type", "llama3"))
        if kind == "llama3":
            factor = rope_scaling["factor"]
            low = rope_scaling.get("low_freq_factor", 1.0)
            high = rope_scaling.get("high_freq_factor", 4.0)
            orig = rope_scaling.get("original_max_position_embeddings", 8192)
            low_wavelen = orig / low
            high_wavelen = orig / high
            wavelen = 2 * math.pi / inv_freq
            scaled = inv_freq / factor
            smooth = (orig / wavelen - low) / (high - low)
            smoothed = (1 - smooth) / factor * inv_freq + smooth * inv_freq
            inv_freq = torch.where(
                wavelen > low_wavelen, scaled,
                torch.where(wavelen < high_wavelen, inv_freq, smoothed))
        elif kind == "linear":
            inv_freq = inv_freq / rope_scaling["factor"]
        else:
            raise ValueError(f"unsupported rope_scaling type: {kind}")
    return inv_freq


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 rope_scaling: dict | None = None):
    """cos/sin tables for integer positions, shape positions.shape + (head_dim,)."""
    inv_freq = _inv_freq(head_dim, theta, rope_scaling, positions.device)
    freqs = positions[..., None].to(torch.float32) * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    """[-x2, x1]: the same values as the JAX package's roll-and-sign form."""
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., T, heads, head_dim]; cos/sin [..., T, head_dim], broadcast over
    heads.  Computed in x's dtype, as HF and the JAX package do."""
    c = cos.to(x.dtype)[..., :, None, :]
    s = sin.to(x.dtype)[..., :, None, :]
    return x * c + _rotate_half(x) * s
