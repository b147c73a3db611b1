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

import torch

from mustafar_tpu_torch.ops.kernels import quant_attention as qa

BLOCK = 128            # in-rows per scale
MAX_TOKENS = 128       # most tokens the kernel takes
_COLS = 64             # out channels per CUDA block
_WARPS = 4             # warps per CUDA block, each on its own scale blocks
_TARGET_WARPS = 2048   # warps to spread over the card's 132 SMs (~16 each)


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


def split(T: int, din: int, dout: int):
    """The kernel's work split: (scale blocks per warp, CUDA blocks along
    DIN).  A warp covers 64 out channels and 8, 16 or 32 tokens; DIN is cut
    so that some ``_TARGET_WARPS`` warps cover the whole product (DOUT
    1,024 alone would give 16 warps), and the CUDA blocks along DIN leave f32
    partials that a second pass sums."""
    nb = din // BLOCK
    tile = 8 if T <= 8 else 16 if T <= 16 else 32
    warps_out = (dout // _COLS) * -(-T // tile)
    ns = max(1, min(nb, -(-_TARGET_WARPS // warps_out)))
    bpw = -(-nb // ns)
    return bpw, -(-nb // (_WARPS * bpw))


def w4_matmul(x: torch.Tensor, carriers: torch.Tensor,
              scales: torch.Tensor) -> torch.Tensor:
    """x [T, DIN] @ W4 -> [T, DOUT] in x's dtype (module note).  For stacked
    weights pass the layer's view (``carriers[li]``): the kernel reads the
    view where it lies, so no layer index is needed.

    CUDA tensors launch the kernel of ``csrc/w4_matmul.cu`` (built at first
    use) on the current stream, for 1 to 128 tokens; CPU tensors run the
    plain version.  A CUDA request the kernel cannot serve raises; nothing
    falls back."""
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
    bpw, nsc = split(T, din, dout)
    out = torch.empty((T, dout), dtype=x.dtype, device=x.device)
    ws = (torch.empty((nsc, T, dout), dtype=torch.float32, device=x.device)
          if nsc > 1 else out)
    fn = qa._library("w4_matmul", "w4_matmul", 5, 7)
    rc = fn(xb.data_ptr(), carriers.data_ptr(), scales.data_ptr(), out.data_ptr(),
            ws.data_ptr(), int(out.dtype == torch.float32), x.device.index or 0,
            T, din, dout, bpw, nsc, stream)
    if rc != 0:
        raise RuntimeError(f"w4_matmul launch failed: CUDA error {rc}")
    w4_matmul.launches += 1
    return out


w4_matmul.launches = 0
