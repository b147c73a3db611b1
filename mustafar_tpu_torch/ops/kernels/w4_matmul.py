"""W4 decode matmul: the CUDA kernel, its plain PyTorch version and the
wrapper that picks between them by device.

Port of ``mustafar_tpu/ops/kernels/w4_matmul.py`` ``w4_matmul`` (Pallas
body ``_w4_matmul_kernel``), kernel ``csrc/w4_matmul.cu``: x [T, DIN] @ W4
[DIN, DOUT] -> [T, DOUT] for T <= 128 tokens (decode).  x is rounded to
bf16; each 128-row block's bf16 x code product is summed in f32 and
multiplied by that block's bf16 scale widened to f32; the blocks' sum is
rounded to x's dtype.  Layouts (``models/quant.py``):
  carriers  int16 [DIN/4, DOUT]     block-local nibbles: carrier row
                                    b*32 + r holds in-rows b*128 + 32 j + r
                                    in nibble j (two's complement)
  scales    bf16  [DIN/128, DOUT]
DIN and DOUT are multiples of 128;
nothing is padded (the TPU's 8-row and 1,024-lane padding is its tiling).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from mustafar_tpu_torch.ops.kernels import quant_attention as qa

BLOCK = 128            # in-rows per scale
MAX_TOKENS = 128       # most tokens the kernel takes
COLS = 128             # out channels per column tile
CTAS_PER_SM = 2        # persistent CTAs an SM (the kernel's launch bounds)
SLOTS_PER_CTA = 2      # workspace partials a CTA may leave: its first and last tile
MIN_UNITS = 4          # fewest scale blocks a CTA takes, where there are few


def unpack_w4(carriers: torch.Tensor) -> torch.Tensor:
    """int16 carriers [..., DIN/4, DOUT] -> int4 codes as int16 [..., DIN, DOUT].
    Nibble j is shifted to the top of the int16 (torch's left shift of a
    signed int wraps) and shifted back arithmetically, which sign-extends
    it: one int16 pass per nibble, no wider temporaries."""
    *lead, rq, dout = carriers.shape
    w = carriers.reshape(*lead, rq // 32, 1, 32, dout)
    shifts = torch.arange(12, -1, -4, dtype=torch.int16,     # 12, 8, 4, 0
                          device=carriers.device).view(4, 1, 1)
    return ((w << shifts) >> 12).reshape(*lead, rq * 4, dout)


def w4_matmul_plain(x: torch.Tensor, carriers: torch.Tensor,
                    scales: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, block by block as the TPU kernel
    loops: acc += (bf16(x_b) @ codes_b, in f32) * f32(scale_b)."""
    xb = x.to(torch.bfloat16).to(torch.float32)
    codes = unpack_w4(carriers).to(torch.float32)
    s = scales.to(torch.float32)
    acc = torch.zeros((x.shape[0], carriers.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for b in range(s.shape[0]):
        rows = slice(b * BLOCK, (b + 1) * BLOCK)
        acc = acc + (xb[:, rows] @ codes[rows]) * s[b]
    return acc.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class Partition:
    """The kernel's work over a persistent grid (``csrc/w4_matmul.cu``): a
    unit is one token tile x one column tile of ``COLS`` out channels x one
    ``BLOCK``-row scale block, numbered with the block fastest (then the
    column tile, then the token tile); CTA c takes units
    ``[first(c), first(c + 1))``, the kernel's rule."""
    T: int
    din: int
    dout: int
    tok: int             # tokens a token tile: 8, 16 or 32
    token_tiles: int
    tiles: int           # column tiles
    blocks: int          # scale blocks along DIN
    ctas: int

    @property
    def units(self) -> int:
        return self.token_tiles * self.tiles * self.blocks

    def first(self, c: int) -> int:
        return c * self.units // self.ctas

    @property
    def ws_floats(self) -> int:
        """f32 workspace: a [tok, COLS] partial per slot, two slots a CTA."""
        return self.ctas * SLOTS_PER_CTA * self.tok * COLS

    @property
    def n_counters(self) -> int:
        """One arrival counter a (token tile, column tile)."""
        return self.token_tiles * self.tiles


@functools.lru_cache(maxsize=None)
def partition(T: int, din: int, dout: int, sms: int) -> Partition:
    """The kernel's grid for x [T, din] @ W4 [din, dout] on a card of ``sms``
    SMs, at most ``CTAS_PER_SM`` CTAs an SM.  Where the (token tile, column
    tile) pairs fit, each is split over the same number of CTAs (at least
    ``MIN_UNITS`` blocks each), so that the ranges fall on tile boundaries
    where the division is even and the CTAs stream the same block rows at
    about the same time; else every CTA takes an even share of all units
    (stream-K), never fewer than ``MIN_UNITS``."""
    tok = 8 if T <= 8 else 16 if T <= 16 else 32
    token_tiles, tiles, blocks = -(-T // tok), dout // COLS, din // BLOCK
    pairs, cap = token_tiles * tiles, CTAS_PER_SM * sms
    if pairs <= cap:
        ctas = pairs * max(1, min(cap // pairs, blocks // MIN_UNITS))
    else:
        ctas = max(1, min(cap, pairs * blocks // MIN_UNITS))
    return Partition(T, din, dout, tok, token_tiles, tiles, blocks, ctas)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_WORKSPACE: dict = {}


def _workspace(part: Partition, device, stream):
    """The kernel's f32 workspace and int32 counters for ``part``: one pair
    per (device, stream), grown when a call needs more and kept.  The
    counters start at zero and every launch leaves them so; the workspace
    is not initialised (a tile's partials are all written before the last
    CTA on it reads them).  Calls on one stream run in order."""
    key = (device.index or 0, stream)
    ws, counters = _WORKSPACE.get(key, (None, None))
    if ws is None or ws.numel() < part.ws_floats:
        ws = torch.empty(part.ws_floats, dtype=torch.float32, device=device)
    if counters is None or counters.numel() < part.n_counters:
        counters = torch.zeros(part.n_counters, dtype=torch.int32, device=device)
    _WORKSPACE[key] = (ws, counters)
    return ws, counters


def _check_workspace(part: Partition, ws, counters):
    """Refuses a workspace or counter array shorter than ``part`` needs (the
    C entry refuses them too)."""
    if ws.numel() < part.ws_floats or counters.numel() < part.n_counters:
        raise ValueError(f"the W4 kernel's workspace is short: {ws.numel()} floats and "
                         f"{counters.numel()} counters for {part.ws_floats} and "
                         f"{part.n_counters}")


def w4_matmul(x: torch.Tensor, carriers: torch.Tensor,
              scales: torch.Tensor) -> torch.Tensor:
    """x [T, DIN] @ W4 -> [T, DOUT] in x's dtype (module note).  For stacked
    weights pass the layer's view (``carriers[li]``): the kernel reads the
    view where it lies, so no layer index is needed.

    CUDA tensors launch the kernel of ``csrc/w4_matmul.cu`` (built at first
    use) on the current stream, for 1 to 128 tokens, over the persistent
    grid of ``partition`` with the stream's workspace (``_workspace``); CPU
    tensors run the plain version.  A CUDA request the kernel cannot serve
    raises; nothing falls back."""
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] % BLOCK:
        raise ValueError(f"x must be [T, DIN] with DIN a multiple of {BLOCK}, "
                         f"got {tuple(x.shape)}")
    T, din = x.shape
    dout = carriers.shape[-1]
    if carriers.dim() != 2 or tuple(carriers.shape) != (din // 4, dout) or dout % BLOCK:
        raise ValueError(f"carriers must be [{din // 4}, DOUT] with DOUT a multiple "
                         f"of {BLOCK}, got {tuple(carriers.shape)}")
    if tuple(scales.shape) != (din // BLOCK, dout):
        raise ValueError(f"scales must be {(din // BLOCK, dout)}, got {tuple(scales.shape)}")
    qa._check_tensors(x, (("carriers", carriers, torch.int16),
                          ("scales", scales, torch.bfloat16)))
    if x.device.type == "cpu":
        return w4_matmul_plain(x, carriers, scales)
    stream = qa._stream(x)
    if T > MAX_TOKENS:
        raise ValueError(f"the W4 kernel takes at most {MAX_TOKENS} tokens, got {T}")
    xb = x.to(torch.bfloat16).contiguous()
    qa._check_aligned((("x", xb), ("carriers", carriers), ("scales", scales)))
    dev = x.device.index or 0
    part = partition(T, din, dout, _sms(dev))
    ws, counters = _workspace(part, x.device, stream)
    _check_workspace(part, ws, counters)
    out = torch.empty((T, dout), dtype=x.dtype, device=x.device)
    fn = qa._library("w4_matmul", "w4_matmul", 6, 8)
    rc = fn(xb.data_ptr(), carriers.data_ptr(), scales.data_ptr(), out.data_ptr(),
            ws.data_ptr(), counters.data_ptr(), ws.numel(), counters.numel(),
            int(out.dtype == torch.float32), dev, T, din, dout, part.ctas, stream)
    if rc != 0:
        raise RuntimeError(f"w4_matmul launch failed: CUDA error {rc}")
    w4_matmul.launches += 1
    return out


w4_matmul.launches = 0
