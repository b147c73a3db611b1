"""Exact top-keep pruning and the bitmap chunk format, port of
``mustafar_tpu/ops/sparse_format.py`` (the pruning pieces, the fused-stream
codecs: bf16 values, ``qbits=16``, and int8 codes with per-channel scales,
``qbits=8``, and the split pools the archived decode kernels read).

The mask keeps exactly ``keep`` entries per row, the largest |x|, with ties
going to the lower channel.  ``torch.topk`` promises no order among ties, so
it would pack other rows than the JAX package; this is the same sort-free
bisection on an integer magnitude key.

**The bitmap codec** (``codec="bitmap"``).  A pruned chunk of C tokens x D
channels keeps exactly ``keep`` values per token row.  ``keep`` is stored
as at most two power-of-two segments (0.7 sparsity: 40 = 32 + 8; 0.5: 65
stored as 68 = 64 + 4, with zero pads).  A width-k segment is ``[R, 128]``
with ``R = C*k/128``: token t's k values lie in row ``t % R`` at lanes
``(t // R)*k ..``.  The bitmap is C/16 uint16 word planes carried in int16:
the bit of (token t, channel d) is bit ``t // (C/16)`` of word
``[t % (C/16), d]``.  One chunk's fused stream is the segments' rows, then
the word planes: 96 int16 rows of 128 at C=256, keep 40.  The j-th set
channel of row t (its rank) reads segment 0 while j < k0, else segment 1
at j - k0.

**Split pools** (``encode_chunk``, read by the archived kernels of
``ops/kernels/sparse_attention_archive.py``).  The same segments, kept in
the dense dtype as separate tensors, and a bitmap of ``P = C/32`` uint32
word planes ``[P, D]``: the bit of (token t, channel d) is bit ``t // P``
of word ``[t % P, d]``.  The words are carried in int32 (torch's uint32
lacks shifts and sums on the CPU): bit 31 makes the carrier negative, and
every right shift is masked.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from mustafar_tpu_torch.ops.quant_format import recip_f32


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


# ---------------------------------------------------------------------------
# The bitmap chunk format
# ---------------------------------------------------------------------------

@functools.cache
def decompose_keep(keep: int, sum_multiple: int = 1) -> tuple[int, ...]:
    """Smallest sum of at most two powers of two that is >= keep and a
    multiple of ``sum_multiple``; a single segment breaks ties.  Cached:
    ``ChunkFormat.segs`` asks for it on every kernel call."""
    assert 1 <= keep <= 128, keep
    pows = [1, 2, 4, 8, 16, 32, 64, 128]
    candidates = [(a,) for a in pows if a >= keep] + \
        [(a, b) for a in pows for b in pows if b <= a and keep <= a + b <= 128]
    candidates = [c for c in candidates if sum(c) % sum_multiple == 0]
    return min(candidates, key=lambda c: (sum(c), len(c)))


@dataclasses.dataclass(frozen=True)
class ChunkFormat:
    """Geometry of one bitmap-coded chunk: bf16 values (``qbits=16``) or
    int8 codes two to an int16 row (``qbits=8``, codec "bitmap-q8")."""

    chunk: int          # C, tokens per chunk
    dim: int            # D, head_dim (128)
    keep: int           # survivors per token row
    qbits: int = 16

    def __post_init__(self):
        assert self.chunk % 32 == 0
        assert self.qbits in (16, 8), self.qbits
        for k in self.segs:
            assert (self.chunk * k) % 128 == 0, (self.chunk, k)
            if self.qbits == 8:
                # the byte pairing splits each segment's logical rows in halves
                assert self.seg_logical_rows(k) % 2 == 0, \
                    f"qbits=8 needs even seg rows (chunk {self.chunk}, k {k})"

    @property
    def segs(self) -> tuple[int, ...]:
        # the physical value rows land on a multiple of 8 (the TPU's sublane
        # tiling, kept so the pools match byte for byte): sum(segs) * C/128
        # rows at qbits=16, half that at qbits=8
        rpt = self.chunk // 128
        if self.qbits == 8:
            return decompose_keep(self.keep, 16 // math.gcd(rpt, 16))
        return decompose_keep(self.keep, 8 // math.gcd(rpt, 8))

    @property
    def keep_stored(self) -> int:
        return sum(self.segs)

    @property
    def planes(self) -> int:
        """uint32 word planes of one chunk's split-pool bitmap."""
        return self.chunk // 32

    def seg_logical_rows(self, k: int) -> int:
        """Rows of 128 values of a width-k segment."""
        return self.chunk * k // 128

    def seg_rows(self, k: int) -> int:
        """int16 rows of a width-k segment (two logical rows each at qbits=8)."""
        r = self.seg_logical_rows(k)
        return r // 2 if self.qbits == 8 else r

    @property
    def total_rows(self) -> int:
        return sum(self.seg_rows(k) for k in self.segs)

    @property
    def bmp16_rows(self) -> int:
        return self.chunk // 16

    @property
    def stream_rows(self) -> int:
        """int16 rows of one chunk's fused stream (values, then bitmap)."""
        return self.total_rows + self.bmp16_rows

    @property
    def bytes_per_chunk(self) -> int:
        """Bytes of one chunk of one stream: value rows and bitmap words."""
        return self.total_rows * 128 * 2 + self.planes * self.dim * 4

    @property
    def dense_bytes(self) -> int:
        return self.chunk * self.dim * 2

    @property
    def compression_ratio(self) -> float:
        return self.dense_bytes / self.bytes_per_chunk


def _stored_slots(dense: torch.Tensor, keep: int) -> torch.Tensor:
    """Exactly ``keep`` stored slots per row: every nonzero (ties to the
    lower channel), then the lowest zero channels as pads."""
    key, bits = _mag_key(dense)
    key = torch.where(dense != 0, key, 0)
    return _mask_from_key(key, keep, bits)


def _compact_rows(dense: torch.Tensor, mask: torch.Tensor, keep: int):
    """The ``keep`` masked values of each row in channel order -> (vals
    [..., keep] in dense.dtype, bits [..., D] int32).  Each slot is placed
    by its rank (a scatter, where the JAX package sums a [..., D, keep]
    select); every output takes exactly one input, and ``+ 0`` turns a
    -0.0 pad into the +0.0 the JAX sum gives."""
    bits = mask.to(torch.int32)
    rank = torch.cumsum(bits, dim=-1) - 1
    slot = torch.where(mask, rank, keep).to(torch.int64)      # unmasked: spare column
    vals = torch.zeros((*dense.shape[:-1], keep + 1), dtype=dense.dtype,
                       device=dense.device)
    vals.scatter_(-1, slot, dense)
    return vals[..., :keep] + 0, bits


def _interleave_vals(vals_ck: torch.Tensor, C: int, k: int) -> torch.Tensor:
    """[..., C, k] -> [..., R, 128]: token t -> row t % R, lanes (t//R)*k.."""
    R = C * k // 128
    arr = vals_ck.reshape(*vals_ck.shape[:-2], C // R, R, k).transpose(-3, -2)
    return arr.reshape(*vals_ck.shape[:-2], R, 128)


def _deinterleave_vals(seg: torch.Tensor, C: int, k: int) -> torch.Tensor:
    R = C * k // 128
    arr = seg.reshape(*seg.shape[:-2], R, C // R, k).transpose(-3, -2)
    return arr.reshape(*seg.shape[:-2], C, k)


def _to_i16(v: torch.Tensor) -> torch.Tensor:
    """int32 holding a 16-bit pattern -> int16 with the same bits."""
    v = v & 0xFFFF
    return torch.where(v >= 0x8000, v - 0x10000, v).to(torch.int16)


def bitmap16(bits: torch.Tensor, C: int) -> torch.Tensor:
    """bits [..., C, D] (0/1) -> word planes [..., C//16, D], uint16 patterns
    in int16 carriers."""
    rows16 = C // 16
    planes = bits.reshape(*bits.shape[:-2], 16, rows16, bits.shape[-1]).to(torch.int32)
    shifts = (1 << torch.arange(16, dtype=torch.int32, device=bits.device))[:, None, None]
    return _to_i16((planes * shifts).sum(dim=-3))


def unpack_bitmap16(words: torch.Tensor, C: int) -> torch.Tensor:
    """Word planes [..., C//16, D] int16 -> int32 bits [..., C, D].  The
    words widen to int32 and are masked to 16 bits before the shift: an
    int16 shift would be arithmetic."""
    rows16 = C // 16
    w = words.to(torch.int32) & 0xFFFF
    tiled = torch.cat([w] * 16, dim=-2)                         # row t = word t % rows16
    shift = (torch.arange(C, dtype=torch.int32, device=words.device) // rows16)[:, None]
    return (tiled >> shift) & 1


def encode_stream(dense: torch.Tensor, fmt: ChunkFormat) -> torch.Tensor:
    """Pack a pruned chunk [..., C, D] (at most ``fmt.keep`` nonzeros a row)
    into fused int16 rows [..., fmt.stream_rows, 128]; values are stored as
    bf16 (``qbits=16``; ``encode_stream_q8`` packs ``qbits=8``)."""
    assert fmt.qbits == 16, fmt
    C = fmt.chunk
    keep = fmt.keep_stored
    mask = _stored_slots(dense, keep)
    vals, bits = _compact_rows(dense, mask, keep)
    vals = vals.to(torch.bfloat16)
    rows, off = [], 0
    for k in fmt.segs:
        rows.append(_interleave_vals(vals[..., off:off + k], C, k).view(torch.int16))
        off += k
    rows.append(bitmap16(bits, C))
    return torch.cat(rows, dim=-2)


def decode_stream(rows: torch.Tensor, fmt: ChunkFormat) -> torch.Tensor:
    """Inverse of ``encode_stream`` -> dense [..., C, D]: the bf16 values at
    ``qbits=16``; at ``qbits=8`` the int8 codes as exact f32 integers (0
    where the bit is unset), the tile the kernels attend before a scale is
    applied (``decode_stream_q8`` dequantizes)."""
    C = fmt.chunk
    segs, off = [], 0
    for k in fmt.segs:
        R = fmt.seg_rows(k)
        seg = rows[..., off:off + R, :]
        if fmt.qbits == 8:
            seg = _unpack_bytes_rows(seg).to(torch.float32)
        else:
            seg = seg.contiguous().view(torch.bfloat16)
        segs.append(_deinterleave_vals(seg, C, k))
        off += R
    vals = torch.cat(segs, dim=-1)                              # [..., C, keep]
    bits = unpack_bitmap16(rows[..., off:off + C // 16, :], C)
    rank = torch.cumsum(bits, dim=-1) - 1
    take = rank.clamp(0, fmt.keep_stored - 1).to(torch.int64)
    dense = torch.gather(vals, -1, take)
    return torch.where(bits > 0, dense, torch.zeros_like(dense))


def prune_and_encode_stream(dense: torch.Tensor, fmt: ChunkFormat,
                            score: torch.Tensor | None = None) -> torch.Tensor:
    """Keep the ``fmt.keep`` largest |x| of each token row (or, given
    ``score`` of dense's shape, non-negative f32, the largest scores: the
    Opa policies' ranking, with the same tie rule), then pack."""
    mask = topk_mask(dense if score is None else score, fmt.keep)
    return encode_stream(torch.where(mask, dense, torch.zeros_like(dense)), fmt)


# ---------------------------------------------------------------------------
# bitmap-q8: int8 codes, two logical rows to an int16 row
# ---------------------------------------------------------------------------

def _pack_bytes_rows(codes_rows: torch.Tensor) -> torch.Tensor:
    """Logical int32 code rows [..., R, 128] -> int16 rows [..., R/2, 128]:
    row r's low byte is logical row r, its high byte logical row r + R/2."""
    R = codes_rows.shape[-2]
    low = codes_rows[..., :R // 2, :] & 0xFF
    high = codes_rows[..., R // 2:, :] & 0xFF
    return _to_i16(low | (high << 8))


def _unpack_bytes_rows(phys: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_pack_bytes_rows`` -> int32 [..., R, 128], each byte
    sign-extended (JAX's ``(w << 24) >> 24`` and ``(w << 16) >> 24`` on the
    int16 widened to int32)."""
    w = phys.to(torch.int32)
    return torch.cat([(w << 24) >> 24, (w << 16) >> 24], dim=-2)


def encode_stream_q8(dense: torch.Tensor, fmt: ChunkFormat):
    """Pack a pruned chunk [..., C, D] (at most ``fmt.keep`` nonzeros a row)
    into int8-code fused rows -> (rows [..., fmt.stream_rows, 128] int16,
    scales [..., D] f32; the cache stores them as bf16).

    The scale multiplies amax by the f32 reciprocal of 127, as XLA computes
    the JAX package's jitted ``amax / 127.0`` (``quant_format.recip_f32``);
    the codes divide by the f32 scale."""
    assert fmt.qbits == 8, fmt
    C = fmt.chunk
    keep = fmt.keep_stored
    xf = dense.to(torch.float32)
    amax = xf.abs().amax(dim=-2)                                 # [..., D]
    scales = torch.clamp_min(amax * recip_f32(127.0), 1e-8)
    codes = torch.clamp(torch.round(xf / scales[..., None, :]), -127, 127).to(torch.int32)
    mask = _stored_slots(dense, keep)
    vals, bits = _compact_rows(codes * mask, mask, keep)         # int32 [..., C, keep]
    rows, off = [], 0
    for k in fmt.segs:
        rows.append(_pack_bytes_rows(_interleave_vals(vals[..., off:off + k], C, k)))
        off += k
    rows.append(bitmap16(bits, C))
    return torch.cat(rows, dim=-2), scales


def decode_stream_q8(rows: torch.Tensor, scales: torch.Tensor,
                     fmt: ChunkFormat) -> torch.Tensor:
    """Inverse of ``encode_stream_q8`` -> dense bf16 [..., C, D]: the codes
    times the f32 of ``scales`` [..., D]."""
    assert fmt.qbits == 8, fmt
    codes = decode_stream(rows, fmt)
    return (codes * scales.to(torch.float32)[..., None, :]).to(torch.bfloat16)


def prune_and_encode_stream_q8(dense: torch.Tensor, fmt: ChunkFormat,
                               score: torch.Tensor | None = None):
    """Keep the ``fmt.keep`` largest |x| of each token row (or the largest
    ``score``, as ``prune_and_encode_stream``), then quantize and pack ->
    (rows, f32 scales)."""
    mask = topk_mask(dense if score is None else score, fmt.keep)
    return encode_stream_q8(torch.where(mask, dense, torch.zeros_like(dense)), fmt)


# ---------------------------------------------------------------------------
# Split pools: separate value segments and a [P, D] uint32 bitmap
# ---------------------------------------------------------------------------

def _to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 holding a 32-bit pattern -> int32 with the same bits."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def encode_chunk(dense: torch.Tensor, fmt: ChunkFormat):
    """Pack a pruned chunk [..., C, D] (at most ``fmt.keep`` nonzeros a row)
    -> (segs: list of [..., R_i, 128] in dense.dtype, bitmap [..., P, D]:
    uint32 patterns in int32 carriers).  The bitmap marks the stored slots,
    zero-valued pads included, so every row has ``keep_stored`` bits."""
    C, D = fmt.chunk, fmt.dim
    keep = fmt.keep_stored
    assert tuple(dense.shape[-2:]) == (C, D), (tuple(dense.shape), fmt)
    lead = dense.shape[:-2]
    mask = _stored_slots(dense, keep)
    vals, bits = _compact_rows(dense, mask, keep)
    P = fmt.planes
    planes = bits.reshape(*lead, 32, P, D).to(torch.int64)          # t = b*P + r
    shifts = torch.arange(32, dtype=torch.int64, device=dense.device)[:, None, None]
    bitmap = _to_i32((planes << shifts).sum(dim=-3))
    segs, off = [], 0
    for k in fmt.segs:
        segs.append(_interleave_vals(vals[..., off:off + k], C, k).to(dense.dtype))
        off += k
    return segs, bitmap


def unpack_bitmap(bitmap: torch.Tensor, fmt: ChunkFormat) -> torch.Tensor:
    """bitmap [..., P, D] (int32 carriers) -> int32 bits [..., C, D]; the
    shift is arithmetic on a negative carrier, so its result is masked."""
    C, P = fmt.chunk, fmt.planes
    words = torch.cat([bitmap.to(torch.int32)] * (C // P), dim=-2)   # row t = word t % P
    shift = (torch.arange(C, dtype=torch.int32, device=bitmap.device) // P)[:, None]
    return (words >> shift) & 1


def decode_chunk(segs: list[torch.Tensor], bitmap: torch.Tensor,
                 fmt: ChunkFormat) -> torch.Tensor:
    """Inverse of ``encode_chunk`` -> dense [..., C, D] in the segments'
    dtype; a rank past the stored count is clamped, as in JAX."""
    C = fmt.chunk
    bits = unpack_bitmap(bitmap, fmt)
    rank = torch.cumsum(bits, dim=-1) - 1
    vals = torch.cat([_deinterleave_vals(s, C, k) for s, k in zip(segs, fmt.segs)],
                     dim=-1)                                         # [..., C, keep]
    take = rank.clamp(0, fmt.keep_stored - 1).to(torch.int64)
    dense = torch.gather(vals, -1, take)
    return torch.where(bits > 0, dense, torch.zeros_like(dense))


def prune_and_encode_chunk(dense: torch.Tensor, fmt: ChunkFormat):
    """Keep the ``fmt.keep`` largest |x| of each token row, then pack into
    split pools (``encode_chunk``)."""
    mask = topk_mask(dense, fmt.keep)
    return encode_chunk(torch.where(mask, dense, torch.zeros_like(dense)), fmt)
