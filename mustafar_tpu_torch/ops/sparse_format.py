"""Exact top-keep masks by magnitude, port of the pruning pieces of
``mustafar_tpu/ops/sparse_format.py`` (``_mag_key`` .. ``topk_mask``).

The mask keeps exactly ``keep`` entries per row, the largest |x|, with ties
going to the lower channel.  ``torch.topk`` promises no order among ties, so
it would pack other rows than the JAX package; this is the same sort-free
bisection on an integer magnitude key.
"""

from __future__ import annotations

import torch


def _mag_key(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """|x| as a monotone non-negative int32 key and its bit width: the raw
    bits of a non-negative float order like the float.  bf16 gives a 15-bit
    key; other float dtypes go through f32 (31 bits)."""
    if x.dtype == torch.bfloat16:
        return x.abs().view(torch.int16).to(torch.int32), 15
    return x.to(torch.float32).abs().view(torch.int32), 31


def _kth_largest_key(key: torch.Tensor, keep: int, bits: int) -> torch.Tensor:
    """Per-row value of the ``keep``-th largest key: the largest t with
    count(key >= t) >= keep, found bit by bit."""
    thr = torch.zeros(key.shape[:-1], dtype=torch.int32, device=key.device)
    for b in reversed(range(bits)):
        cand = thr | (1 << b)
        cnt = (key >= cand[..., None]).sum(dim=-1)
        thr = torch.where(cnt >= keep, cand, thr)
    return thr


def _mask_from_key(key: torch.Tensor, keep: int, bits: int) -> torch.Tensor:
    """Exactly ``keep`` largest keys per row, ties to the lower index."""
    thr = _kth_largest_key(key, keep, bits)[..., None]
    above = key > thr
    n_above = above.sum(dim=-1, keepdim=True)
    tie = key == thr
    tie_rank = torch.cumsum(tie.to(torch.int32), dim=-1)          # 1-based
    return above | (tie & (tie_rank <= keep - n_above))


def topk_mask(x: torch.Tensor, keep: int) -> torch.Tensor:
    """Keep-mask of the ``keep`` largest |x| along the last axis (stable ties)."""
    if keep >= x.shape[-1]:
        return torch.ones(x.shape, dtype=torch.bool, device=x.device)
    key, bits = _mag_key(x)
    return _mask_from_key(key, keep, bits)
