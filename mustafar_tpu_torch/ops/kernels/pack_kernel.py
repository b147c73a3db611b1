"""Fused prune + quantize + pack for the quant codecs: the CUDA kernel, its
plain PyTorch version and the wrapper that picks between them by device.

Port of ``mustafar_tpu/ops/kernels/pack_kernel.py`` ``prune_quant_pack``
(Pallas body ``_prune_quant_pack_kernel``), kernel
``csrc/prune_quant_pack.cu``.  Per head-chunk x [C, 128] (bf16):
  1. keep exactly ``keep`` entries per token row, the largest |x| (or the
     largest ``score``), ties to the lower channel (``sparse_format``'s
     sort-free bisection on the integer magnitude key);
  2. per channel over the chunk's C tokens: scale = max(amax * f32(1/qmax),
     1e-8) in f32, stored as bf16;
  3. codes = clamp(round_half_even(x / scale), +-qmax), packed ``16/bits``
     token blocks to an int16 row (``quant_format.pack_codes``).
The plain version is the cache's chain (``sparse_format.topk_mask`` then
``quant_format.encode_chunk``), which the JAX package's kernel says it is
bit-exact with; kernel and plain version are held bit-equal on the card.

Layouts: x [BH, C, 128] or [B, H, C, 128] bf16, any strides with the
channel axis contiguous (the cache hands it windows and prompt slices where
they lie); rows [.., C*bits/16, 128] int16 and scales [.., 128] bf16, which
the caller may pass as views to write into (the pool slot and the scales'
K or V column), with the channel axis contiguous.
"""

from __future__ import annotations

import ctypes

import torch

from mustafar_tpu_torch.ops import quant_format as qf
from mustafar_tpu_torch.ops import sparse_format as sf
from mustafar_tpu_torch.ops.kernels import build
from mustafar_tpu_torch.ops.kernels import quant_attention as qa

D = 128
MAX_CHUNK = 512        # tokens the kernel keeps in shared memory (C * 256 bytes)
ROW_GROUP = 128        # tokens a CUDA block's 32 warps take at a time, 4 each


def prune_quant_pack_plain(x, keep: int, bits: int, score=None, rows_out=None,
                           scales_out=None):
    """``topk_mask`` then ``encode_chunk`` on x (shapes and outputs as
    ``prune_quant_pack``)."""
    lead, C = x.shape[:-2], x.shape[-2]
    xb = x.to(torch.bfloat16).reshape(-1, C, D)
    sel = xb if score is None else score.reshape(-1, C, D)
    pruned = torch.where(sf.topk_mask(sel, keep), xb, torch.zeros_like(xb))
    rows, scales = qf.encode_chunk(pruned, qf.QuantCodec(C, D, bits, bits), "k")
    rows, scales = rows.reshape(*lead, -1, D), scales.reshape(*lead, D)
    if rows_out is not None:
        rows_out.copy_(rows)
        scales_out.copy_(scales)
        return rows_out, scales_out
    return rows, scales


def _as4(t):
    """[BH, n, 128] -> [BH, 1, n, 128] (a view); [B, H, n, 128] as it is."""
    return t[:, None] if t.dim() == 3 else t


def _check(x, keep, bits, score, rows_out, scales_out):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    if x.dim() not in (3, 4) or x.shape[-1] != D:
        raise ValueError(f"x must be [BH, C, 128] or [B, H, C, 128], got {tuple(x.shape)}")
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits!r}")
    C = x.shape[-2]
    if C < 1 or C % ROW_GROUP or C > MAX_CHUNK:
        raise ValueError(f"a chunk of {C} tokens: the kernel takes a multiple of "
                         f"{ROW_GROUP} up to {MAX_CHUNK}")
    if not isinstance(keep, int) or keep < 1:
        raise ValueError(f"keep must be an int >= 1, got {keep!r}")
    if x.stride(-1) != 1:
        raise ValueError("x's channel axis must be contiguous")
    if score is not None:
        if score.dtype != torch.float32 or score.shape != x.shape:
            raise ValueError(f"score must be float32 {tuple(x.shape)}, got "
                             f"{score.dtype} {tuple(score.shape)}")
        if not score.is_contiguous():
            raise ValueError("score must be contiguous")
        if score.device != x.device:
            raise ValueError(f"score is on {score.device}, x on {x.device}")
    if (rows_out is None) != (scales_out is None):
        raise ValueError("pass both rows_out and scales_out, or neither")
    if rows_out is not None:
        lead = tuple(x.shape[:-2])
        R = C * bits // 16
        for name, t, shape, dt in (("rows_out", rows_out, (*lead, R, D), torch.int16),
                                   ("scales_out", scales_out, (*lead, D), torch.bfloat16)):
            if tuple(t.shape) != shape or t.dtype != dt:
                raise ValueError(f"{name} must be {dt} {shape}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
            if t.stride(-1) != 1:
                raise ValueError(f"{name}'s channel axis must be contiguous")
            if t.device != x.device:
                raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def prune_quant_pack(x, keep: int, bits: int, score=None, *, rows_out=None,
                     scales_out=None):
    """Prune x [BH, C, 128] (or [B, H, C, 128]) to ``keep`` entries per
    token, quantize per channel to ``bits`` (8 or 4) and pack -> (rows
    [.., C*bits/16, 128] int16, scales [.., 128] bf16), written into
    ``rows_out`` / ``scales_out`` when given (views with a contiguous
    channel axis).  ``score`` (float32, x's shape, contiguous) ranks the
    entries in place of |x|.

    CUDA tensors launch the kernel of ``csrc/prune_quant_pack.cu`` (built
    at first use) on the current stream, reading x and writing the outputs
    through their strides (no copy); CPU tensors run the plain version.  A
    CUDA request the kernel cannot serve raises; nothing falls back."""
    _check(x, keep, bits, score, rows_out, scales_out)
    if x.device.type == "cpu":
        return prune_quant_pack_plain(x, keep, bits, score, rows_out, scales_out)
    stream = qa._stream(x)
    C = x.shape[-2]
    if rows_out is None:
        lead = tuple(x.shape[:-2])
        rows_out = torch.empty((*lead, C * bits // 16, D), dtype=torch.int16,
                               device=x.device)
        scales_out = torch.empty((*lead, D), dtype=torch.bfloat16, device=x.device)
    # (b, h, token) strides in elements; a 3-D x is [BH, 1, C, 128]
    x4, r4 = _as4(x), _as4(rows_out)
    s_st = (scales_out.stride(0), scales_out.stride(1) if x.dim() == 4 else 0)
    if x.data_ptr() % 8 or any(st % 4 for st in x4.stride()[:3]):
        raise ValueError("x must be 8-byte aligned with strides in multiples of 4")
    if score is not None and score.data_ptr() % 16:
        raise ValueError("score must be 16-byte aligned")
    fn = getattr(build.load("prune_quant_pack"), "prune_quant_pack")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 8 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    B, H = x4.shape[:2]
    rc = fn(x.data_ptr(), 0 if score is None else score.data_ptr(),
            rows_out.data_ptr(), scales_out.data_ptr(), x.device.index or 0, B, H, C,
            keep, bits, *x4.stride()[:3], *r4.stride()[:3], *s_st,
            qf.recip_f32(float(2 ** (bits - 1) - 1)), stream)
    if rc != 0:
        raise RuntimeError(f"prune_quant_pack launch failed: CUDA error {rc}")
    prune_quant_pack.launches += 1
    return rows_out, scales_out


prune_quant_pack.launches = 0
