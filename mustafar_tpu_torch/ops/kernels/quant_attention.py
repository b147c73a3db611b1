"""Fused q8q4 decode attention: the CUDA kernel, its plain PyTorch version
and the wrapper that picks between them by device.

Port of ``mustafar_tpu/ops/kernels/quant_attention.py``
``fused_q_decode_attention`` (uniform batch, codec q8q4, options off).  The
kernel is ``csrc/q_decode.cu``; its header note says what it computes, what
bounds it and how it is laid out.  The plain version below repeats its
arithmetic step by step (same casts, same order of scaling, the same
online-softmax tiles), so the two agree to f32 rounding.

Layouts are the JAX package's stacked ones, indexed at layer ``li``:
  q          [B, 1, Hq, 128]              bf16 or f32 (read as bf16)
  kv_pool    [L, mc, B*Hkv, 192, 128]     int16   (K rows, then V rows)
  kv_scales  [L, mc, B*Hkv, 2, 128]       bf16    (K scale, V scale)
  k_win/v_win [L, B*Hkv, W, 128]          bf16
The cache keeps [L, mc, B, Hkv, ...] and [L, B, Hkv, W, D]; both flatten to
these views for free.
"""

from __future__ import annotations

import ctypes

import torch

from mustafar_tpu_torch.ops import quant_format as qf
from mustafar_tpu_torch.ops.kernels import build

NEG_INF = -1e30
SM_SCALE = 0.08838834764831845      # 1 / sqrt(128)
WINDOW_TILE = 96                    # most window tokens per softmax step
_GROUPS = (1, 2, 4, 8)              # query heads per kv head the kernel takes


def _check(q, kv_pool, kv_scales, k_win, v_win, n_chunks, win_len, li, codec,
           window, return_norm, return_win_probs):
    """Raise on anything the kernel does not take; return (BH, G)."""
    if (codec.kbits, codec.vbits, codec.chunk, codec.dim) != (8, 4, 256, 128):
        raise NotImplementedError(
            "fused_q_decode_attention serves codec q8q4 with 256-token chunks; "
            "q8 and q4q4 are ROADMAP Queue A item 8")
    if window is not None:
        raise NotImplementedError("sliding-window decode is ROADMAP Queue A item 14")
    if return_norm or return_win_probs:
        raise NotImplementedError(
            "softmax stats and window probabilities (Opa) are ROADMAP Queue A item 12")
    if q.dim() != 4 or q.shape[1] != 1 or q.shape[3] != 128:
        raise ValueError(f"q must be [B, 1, Hq, 128], got {tuple(q.shape)}")
    B, _, Hq, _ = q.shape
    if kv_pool.dim() != 5 or tuple(kv_pool.shape[3:]) != (codec.stream_rows, 128):
        raise ValueError(f"kv_pool must be [L, mc, BH, {codec.stream_rows}, 128], "
                         f"got {tuple(kv_pool.shape)}")
    L, mc, BH = kv_pool.shape[:3]
    if tuple(kv_scales.shape) != (L, mc, BH, 2, 128):
        raise ValueError(f"kv_scales must be {(L, mc, BH, 2, 128)}, "
                         f"got {tuple(kv_scales.shape)}")
    if k_win.dim() != 4 or tuple(k_win.shape[:2]) != (L, BH) or k_win.shape[3] != 128:
        raise ValueError(f"k_win must be [{L}, {BH}, W, 128], got {tuple(k_win.shape)}")
    if v_win.shape != k_win.shape:
        raise ValueError(f"v_win {tuple(v_win.shape)} != k_win {tuple(k_win.shape)}")
    if B < 1 or BH % B:
        raise ValueError(f"pool heads {BH} are not a multiple of batch {B}")
    Hkv = BH // B
    if Hq % Hkv or Hq // Hkv not in _GROUPS:
        raise ValueError(f"{Hq} query heads over {Hkv} kv heads: the kernel "
                         f"takes groups of {_GROUPS}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    for name, t, dt in (("q", q, q.dtype), ("kv_pool", kv_pool, torch.int16),
                        ("kv_scales", kv_scales, torch.bfloat16),
                        ("k_win", k_win, torch.bfloat16),
                        ("v_win", v_win, torch.bfloat16)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, val, hi in (("n_chunks", n_chunks, mc), ("win_len", win_len, k_win.shape[2]),
                          ("li", li, L - 1)):
        if not isinstance(val, int) or not 0 <= val <= hi:
            raise ValueError(f"{name} must be an int in [0, {hi}], got {val!r}")
    return BH, Hq // Hkv


def window_tile(W: int) -> int:
    """Window tokens per online-softmax step: the largest multiple of 8 that
    divides the window capacity W and is at most 96, the TPU kernel's rule
    (``sparse_attention._window_tile``).  Taking the same steps keeps the
    bf16 rounding of p, which depends on the running max, the same too."""
    cands = [d for d in range(8, min(WINDOW_TILE, W) + 1, 8) if W % d == 0]
    return max(cands) if cands else W


def fused_q_decode_attention_plain(q, kv_pool, kv_scales, k_win, v_win,
                                   n_chunks: int, win_len: int, li: int):
    """The kernel's arithmetic in PyTorch.  Per (b, kv head) and query head:
    chunk scores bf16(q * kscale) . codes / sqrt(128), then window scores
    q . k / sqrt(128), under one online softmax in steps of one chunk or one
    window tile (``window_tile``); p rounded to bf16 for the value product,
    which each chunk scales by its V scale.  Out is f32 -> q's dtype."""
    B, _, Hq, D = q.shape
    BH = kv_pool.shape[2]
    G = Hq // (BH // B)
    KR = kv_pool.shape[3] * 2 // 3          # q8q4: 128 K rows of 192
    f32, bf16 = torch.float32, torch.bfloat16
    qf32 = q.to(bf16).to(f32).reshape(BH, G, D)
    m = torch.full((BH, G, 1), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((BH, G, 1), dtype=f32, device=q.device)
    acc = torch.zeros((BH, G, D), dtype=f32, device=q.device)

    def step(s, vmat, vscale):
        nonlocal m, l, acc
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        pv = p.to(bf16).to(f32) @ vmat
        if vscale is not None:
            pv = pv * vscale[:, None, :]
        acc = acc * corr + pv
        m = m_new

    for ci in range(n_chunks):
        rows = kv_pool[li, ci]                                # [BH, 192, 128]
        kc = qf.unpack_rows(rows[:, :KR], 8).to(f32)          # [BH, 256, 128]
        vc = qf.unpack_rows(rows[:, KR:], 4).to(f32)
        ks = kv_scales[li, ci, :, 0].to(f32)                  # [BH, 128]
        vs = kv_scales[li, ci, :, 1].to(f32)
        qk = (qf32 * ks[:, None, :]).to(bf16).to(f32)
        step((qk @ kc.transpose(1, 2)) * SM_SCALE, vc, vs)
    wt = window_tile(k_win.shape[2])
    for t0 in range(0, win_len, wt):
        t1 = min(win_len, t0 + wt)
        kw = k_win[li, :, t0:t1].to(f32)
        vw = v_win[li, :, t0:t1].to(f32)
        step((qf32 @ kw.transpose(1, 2)) * SM_SCALE, vw, None)
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def _library():
    lib = build.load("q_decode")
    fn = lib.q8q4_decode
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fused_q_decode_attention(q, kv_pool, kv_scales, k_win, v_win,
                             n_chunks: int, win_len: int, li: int,
                             codec: qf.QuantCodec, *, window=None,
                             return_norm: bool = False,
                             return_win_probs: bool = False):
    """q8q4 flash-decode of layer ``li`` over ``n_chunks`` pool chunks and the
    first ``win_len`` window tokens -> [B, 1, Hq, 128] in q's dtype (q is
    read as bf16, the output is computed in f32, as on the TPU).

    CUDA tensors launch the kernel of ``csrc/q_decode.cu`` (built at first
    use) on the current stream; CPU tensors run the plain version.  A CUDA
    request the kernel cannot serve raises; nothing falls back."""
    BH, G = _check(q, kv_pool, kv_scales, k_win, v_win, n_chunks, win_len, li,
                   codec, window, return_norm, return_win_probs)
    if q.device.type == "cpu":
        return fused_q_decode_attention_plain(q, kv_pool, kv_scales, k_win,
                                              v_win, n_chunks, win_len, li)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    for name, t in (("q", q), ("kv_pool", kv_pool), ("kv_scales", kv_scales),
                    ("k_win", k_win), ("v_win", v_win)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    fn = _library()
    out = torch.empty_like(q)
    qb = q.to(torch.bfloat16)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    W = k_win.shape[2]
    rc = fn(qb.data_ptr(), kv_pool.data_ptr(), kv_scales.data_ptr(),
            k_win.data_ptr(), v_win.data_ptr(), out.data_ptr(),
            int(out.dtype == torch.float32), q.device.index or 0, BH, G,
            kv_pool.shape[1], W, window_tile(W), n_chunks, win_len, li, stream)
    if rc != 0:
        raise RuntimeError(f"q8q4_decode launch failed: CUDA error {rc}")
    fused_q_decode_attention.launches += 1
    return out


fused_q_decode_attention.launches = 0
