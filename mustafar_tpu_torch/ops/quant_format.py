"""Quantized-dense chunk codec ("q8" family), port of
``mustafar_tpu/ops/quant_format.py``.

Pruned chunks are stored dense-zeroed and quantized per (chunk, head,
channel):

  * K: int8, two tokens per int16 row: token t < C/2 in the low byte of row
    t, token t + C/2 in the high byte.  C/2 rows of 128 lanes per chunk.
  * V: int8 (same layout) or int4, four tokens per int16 row, token
    t + j*C/4 in nibble j.  C/4 rows when int4.
  * scales: bf16 per channel.  Codes are computed with the f32 scale; only
    the stored scale is rounded to bf16.

A 256-token chunk is 256, 192 or 128 int16 rows per head at codec "q8"
(int8 K and V), "q8q4" (int8 K, int4 V) or "q4q4" (int4 K and V).  The int16 rows are raw bit carriers, so packing and unpacking
here work on explicit masks and sign fixes rather than on shifts that
overflow.
"""

from __future__ import annotations

import dataclasses

import torch


# (kbits, vbits) of each quant codec by name (the JAX package's map)
CODECS = {"q8": (8, 8), "q8q4": (8, 4), "q4q4": (4, 4)}


@dataclasses.dataclass(frozen=True)
class QuantCodec:
    chunk: int = 256          # tokens per packed chunk (C)
    dim: int = 128            # head_dim == lane width
    kbits: int = 8
    vbits: int = 8

    def __post_init__(self):
        assert self.dim == 128, "lane-width layouts require head_dim 128"
        assert self.kbits in (8, 4) and self.vbits in (8, 4)
        assert self.chunk % 4 == 0

    @staticmethod
    def rows_for(chunk: int, bits: int) -> int:
        return chunk // (16 // bits)

    @property
    def k_rows(self) -> int:
        return self.rows_for(self.chunk, self.kbits)

    @property
    def v_rows(self) -> int:
        return self.rows_for(self.chunk, self.vbits)

    @property
    def stream_rows(self) -> int:
        """int16 rows per chunk per head (K stream then V stream)."""
        return self.k_rows + self.v_rows


def _to_i16(v: torch.Tensor) -> torch.Tensor:
    """int32 holding a 16-bit pattern in its low bits -> int16 (exact)."""
    v = v & 0xFFFF
    return torch.where(v >= 0x8000, v - 0x10000, v).to(torch.int16)


def recip_f32(c: float) -> float:
    """1/c rounded to f32 (as a Python float, which an f32 tensor product
    takes as that f32 value).  The JAX package's served path is jitted, and
    XLA rewrites a division by a constant into a product with this
    reciprocal; matching it keeps scales and codes bit-exact with that path.
    A host scalar, not a tensor: copying a tensor to the card would make
    every pack wait for the device."""
    return torch.tensor(1.0 / c, dtype=torch.float32).item()


def quantize_chunk(x: torch.Tensor, bits: int):
    """x [BH, C, D] -> (codes int32 [BH, C, D], scales f32 [BH, D]).

    Symmetric per-channel quantization over the chunk's tokens, rounding
    half to even (as ``jnp.round``).  Pruned zeros map to code 0 exactly."""
    qmax = float(2 ** (bits - 1) - 1)
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=1)
    scales = torch.clamp_min(amax * recip_f32(qmax), 1e-8)
    codes = torch.clamp(torch.round(xf / scales[:, None, :]), -qmax, qmax)
    return codes.to(torch.int32), scales


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """codes int32 [BH, C, D] -> int16 rows [BH, C/(16/bits), 128]; token
    blocks stack along the row axis."""
    BH, C, D = codes.shape
    n = 16 // bits
    R = C // n
    mask = (1 << bits) - 1
    v = torch.zeros((BH, R, D), dtype=torch.int32, device=codes.device)
    for j in range(n):
        v = v | ((codes[:, j * R:(j + 1) * R, :] & mask) << (bits * j))
    return _to_i16(v)


def unpack_rows(rows: torch.Tensor, bits: int) -> torch.Tensor:
    """int16 rows [..., R, 128] -> codes int32 [..., R*(16/bits), 128],
    each field sign-extended: field j shifted to the top of an int32, then
    arithmetically back down."""
    n = 16 // bits
    w = rows.to(torch.int32)
    return torch.cat([(w << (32 - bits * (j + 1))) >> (32 - bits) for j in range(n)], dim=-2)


def encode_chunk(x: torch.Tensor, codec: QuantCodec, kind: str):
    """x [BH, C, D] (already pruned) -> (rows int16, scales bf16 [BH, D])."""
    bits = codec.kbits if kind == "k" else codec.vbits
    codes, scales = quantize_chunk(x, bits)
    return pack_codes(codes, bits), scales.to(torch.bfloat16)


def decode_chunk(rows: torch.Tensor, scales: torch.Tensor, codec: QuantCodec,
                 kind: str) -> torch.Tensor:
    """rows [..., R, 128] + scales [..., D] -> dense bf16 [..., C, D]."""
    bits = codec.kbits if kind == "k" else codec.vbits
    codes = unpack_rows(rows, bits)
    return (codes.to(torch.float32)
            * scales.to(torch.float32)[..., None, :]).to(torch.bfloat16)
