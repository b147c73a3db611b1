"""Dense flash-decode attention: the CUDA kernel, its plain PyTorch versions
and the wrapper that picks between them by device.

Port of ``mustafar_tpu/ops/kernels/dense_decode.py`` ``flash_decode_attention``
(Pallas body ``_flash_decode_kernel``), kernel ``csrc/dense_decode.cu``,
with its final (m, l) (``return_norm``) and its sliding window
(``window``).  Each query head attends its kv head's cached rows [0, pos]
inclusive (the newest token is already written), with a window only rows
k > pos - window: ``window`` rows, the newest included.  q, K and V are
read as bf16; scores q . k / sqrt(D) in f32; p rounded to bf16 for the
value product, accumulated in f32, out = acc / max(l, 1e-30) in q's dtype.  A slot at pos -1 attends nothing and comes out
0.  Layouts: q [B, 1, Hq, D], k/v [B, S, Hkv, D].  With ``return_norm``
the final online-softmax stats (m, l) come too, each [B, Hkv, G, 1] f32 (l
unclamped; a slot with nothing to attend -1e30 and 0): the probability of
any cached token is exp(s - m) / l, which the masked cache's Opa scoring
reads at its window's columns.

Two plain versions:
  flash_decode_attention_plain        the TPU kernel's arithmetic: one
      online softmax in steps of ``decode_tile(S)`` tokens, so the running
      max, and with it the bf16 rounding of p, is the TPU's at every step;
      the window masks scores to -1e30 (a step wholly below the window
      still runs, and the next live step's correction exp(-1e30 - m) = 0
      wipes it, as on the TPU); the CPU path, held against JAX;
  flash_decode_attention_split_plain  the CUDA kernel's: the tokens cut
      into splits of ``split_len`` (the rule below), one softmax step per
      split from a fresh state over the split's rows inside the window (a
      split wholly below it takes no step, as the kernel's block reads
      nothing), the partials merged in split order with
      ``ops.attention.merge_partials``.
The two differ only in where p is rounded, well within 2 bf16 ulps of the
output's scale.
"""

from __future__ import annotations

import functools
import math

import torch

from mustafar_tpu_torch.ops.attention import merge_partials
from mustafar_tpu_torch.ops.kernels import quant_attention as qa

MAX_TILE = 512
H100_SMS = 132          # streaming multiprocessors of an H100 SXM
MIN_SPLIT, MAX_SPLIT = 64, 128   # the tokens a split the CUDA kernel takes


def decode_tile(S: int) -> int:
    """Tokens per online-softmax step: the TPU kernel's tile (512, halved
    until it divides S; 32 at S = 1,312, 256 at 8,448)."""
    ts = min(MAX_TILE, S)
    while S % ts:
        ts //= 2
    return ts


def split_len(n: int, BH: int, sms: int = H100_SMS) -> int:
    """Tokens per split of the CUDA kernel's grid: 128 where the grid then
    holds at least four blocks an SM, else 64 (csrc/dense_decode.cu's
    note).  ``n`` is the tokens the grid covers (pos + 1 for a scalar pos,
    S per slot) and ``BH`` the (batch row, kv head) pairs: 600 tokens at
    B=8, Hkv=8 give 10 splits of 64, 640 blocks; a per-slot grid at S=8,448
    66 of 128."""
    return MAX_SPLIT if BH * -(-n // MAX_SPLIT) >= 4 * sms else MIN_SPLIT


def _sms(device) -> int:
    """SMs of the card the tensors lie on; an H100's for the CPU."""
    if device.type == "cuda":
        return _card_sms(device.index or 0)
    return H100_SMS


@functools.lru_cache(maxsize=None)
def _card_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _covered(pos, S: int) -> int:
    """Tokens the kernel's grid covers: pos + 1 for a scalar pos, S per slot."""
    return S if torch.is_tensor(pos) else max(pos + 1, 0)


def first_row(p: int, window) -> int:
    """The first row a slot at ``p`` attends: p - window + 1 with a sliding
    window (at least 0), else 0."""
    return 0 if window is None else max(p - window + 1, 0)


def _with_norm(outs, ms, ls, q, Hkv, return_norm):
    out = torch.cat(outs).to(q.dtype)
    if not return_norm:
        return out
    B, G = q.shape[0], q.shape[2] // Hkv
    return out, torch.stack(ms).reshape(B, Hkv, G, 1), torch.stack(ls).reshape(B, Hkv, G, 1)


def flash_decode_attention_plain(q, k_cache, v_cache, pos, return_norm: bool = False,
                                 window=None):
    """The TPU kernel's arithmetic in PyTorch, slot by slot and tile by tile
    (``quant_attention._softmax_step``), scores of rows at or below p -
    window set to -1e30; with ``return_norm`` also the final (m, l)."""
    B, _, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    f32 = torch.float32
    ts = decode_tile(S)
    scale = 1.0 / math.sqrt(D)
    outs, ms, ls = [], [], []
    for b, p in enumerate([pos] * B if isinstance(pos, int) else pos.tolist()):
        qf = q[b, 0].to(torch.bfloat16).to(f32).reshape(Hkv, G, D)
        m = torch.full((Hkv, G, 1), qa.NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros((Hkv, G, 1), dtype=f32, device=q.device)
        acc = torch.zeros((Hkv, G, D), dtype=f32, device=q.device)
        n = min(p + 1, S)
        lo = first_row(p, window)
        for t0 in range(0, n, ts):
            t1 = min(t0 + ts, n)
            k = k_cache[b, t0:t1].to(torch.bfloat16).to(f32).transpose(0, 1)
            v = v_cache[b, t0:t1].to(torch.bfloat16).to(f32).transpose(0, 1)
            s = (qf @ k.transpose(1, 2)) * scale
            if t0 < lo:
                s = s.masked_fill(torch.arange(t0, t1, device=q.device) < lo, qa.NEG_INF)
            m, l, acc = qa._softmax_step(m, l, acc, s, v, None)
        outs.append((acc / torch.clamp_min(l, 1e-30)).reshape(1, 1, Hq, D))
        ms.append(m)
        ls.append(l)
    return _with_norm(outs, ms, ls, q, Hkv, return_norm)


def flash_decode_attention_split_plain(q, k_cache, v_cache, pos, split=None,
                                       return_norm: bool = False, window=None):
    """The CUDA kernel's arithmetic in PyTorch: per slot, the partials
    (acc, m, l) of each split of ``split`` tokens (default: ``split_len``'s
    rule for the card the tensors lie on; the kernel takes 64 to 128), one
    softmax step each from a fresh state (``quant_attention._softmax_step``)
    over the split's rows past p - window (a split wholly at or below it
    takes none), merged in split order (``merge_partials``).  A slot with
    nothing to attend comes out 0.  With ``return_norm`` also the merge's
    final (m, l), as the kernel's merge writes them."""
    B, _, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    f32 = torch.float32
    if split is None:
        split = split_len(_covered(pos, S), B * Hkv, _sms(q.device))
    if not MIN_SPLIT <= split <= MAX_SPLIT:
        raise ValueError(f"the kernel takes {MIN_SPLIT} to {MAX_SPLIT} tokens a split, "
                         f"got {split}")
    scale = 1.0 / math.sqrt(D)
    outs, ms, ls = [], [], []
    for b, p in enumerate([pos] * B if isinstance(pos, int) else pos.tolist()):
        qf = q[b, 0].to(torch.bfloat16).to(f32).reshape(Hkv, G, D)
        fresh = (torch.full((Hkv, G, 1), qa.NEG_INF, dtype=f32, device=q.device),
                 torch.zeros((Hkv, G, 1), dtype=f32, device=q.device),
                 torch.zeros((Hkv, G, D), dtype=f32, device=q.device))
        parts = []
        n = min(p + 1, S)
        lo = first_row(p, window)
        for t0 in range(0, n, split):
            t1 = min(t0 + split, n)
            t0 = max(t0, lo)
            if t0 >= t1:
                continue
            k = k_cache[b, t0:t1].to(torch.bfloat16).to(f32).transpose(0, 1)
            v = v_cache[b, t0:t1].to(torch.bfloat16).to(f32).transpose(0, 1)
            m, l, acc = qa._softmax_step(*fresh, (qf @ k.transpose(1, 2)) * scale, v, None)
            parts.append((acc, m, l))
        out, m, l = (merge_partials(parts, return_stats=True) if parts
                     else (fresh[2], fresh[0], fresh[1]))
        outs.append(out.reshape(1, 1, Hq, D))
        ms.append(m)
        ls.append(l)
    return _with_norm(outs, ms, ls, q, Hkv, return_norm)


def flash_decode_attention(q, k_cache, v_cache, pos, *, window=None,
                           return_norm: bool = False):
    """Dense flash-decode over the post-append cache -> [B, 1, Hq, D] in q's
    dtype, and with ``return_norm`` the final (m, l) (module note).
    ``pos`` is the newest token's index: a host int (uniform batch,
    -1..S-1) or an int32 tensor [B] on q's device (per slot, read by the
    kernel, -1 for an idle slot).  ``window`` (an int >= 1, or None): the
    sliding window, rows k > pos - window.

    CUDA tensors launch the kernels of ``csrc/dense_decode.cu`` (built at
    first use; the split kernel, then its merge, from one C call) on the
    current stream, for D = 128 and 1, 2, 4 or 8 query heads a kv head,
    with the stream's split scratch (``quant_attention._split_scratch``);
    K and V that are not bf16 are cast first, as the TPU wrapper casts
    them.  CPU tensors run the plain version.  A CUDA request the kernel
    cannot serve raises; nothing falls back."""
    qa.check_window(window)
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [B, 1, Hq, D], got {tuple(q.shape)}")
    B, _, Hq, D = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape or k_cache.shape[0] != B \
            or k_cache.shape[3] != D:
        raise ValueError(f"k_cache and v_cache must be [{B}, S, Hkv, {D}], got "
                         f"{tuple(k_cache.shape)} and {tuple(v_cache.shape)}")
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    if D % 128 or Hq % Hkv:
        raise ValueError(f"head_dim {D} must be a multiple of 128 and {Hq} query "
                         f"heads must group over {Hkv} kv heads")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if torch.is_tensor(pos):
        if tuple(pos.shape) != (B,) or pos.dtype != torch.int32 or pos.device != q.device:
            raise ValueError(f"per-slot pos must be an int32 tensor [{B}] on {q.device}, "
                             f"got {pos.dtype} {tuple(pos.shape)} on {pos.device}")
    else:
        qa._check_int("pos", pos, -1, S - 1)
    if q.device.type == "cpu":
        return flash_decode_attention_plain(q, k_cache, v_cache, pos, return_norm, window)
    stream = qa._stream(q)
    G = Hq // Hkv
    if D != 128 or G not in qa._GROUPS:
        raise NotImplementedError(f"the dense decode kernel takes head_dim 128 and "
                                  f"{qa._GROUPS} query heads a kv head, got {D}, {G}")
    qb = q.to(torch.bfloat16).contiguous()
    kb = k_cache.to(torch.bfloat16)
    vb = v_cache.to(torch.bfloat16)
    for name, t in (("k_cache", kb), ("v_cache", vb)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    qa._check_aligned((("q", qb), ("k_cache", kb), ("v_cache", vb)))
    fn = qa._library("dense_decode", "dense_decode", 7, 11)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ml = (torch.empty((2, B, Hkv, G, 1), dtype=torch.float32, device=q.device)
          if return_norm else None)
    per_slot = torch.is_tensor(pos)
    n = _covered(pos, S)
    split = split_len(n, B * Hkv, _sms(q.device))
    n_splits = max(1, -(-n // split))
    scratch = qa._split_scratch(B * Hkv, n_splits, G, q.device, stream)
    rc = fn(qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), out.data_ptr(),
            None if ml is None else ml.data_ptr(), pos.data_ptr() if per_slot else None, scratch.data_ptr(), scratch.numel(),
            int(out.dtype == torch.float32), q.device.index or 0, B * Hkv, Hkv, G, S,
            split, n_splits, 0 if per_slot else pos, window or 0, stream)
    if rc != 0:
        raise RuntimeError(f"dense_decode launch failed: CUDA error {rc}")
    flash_decode_attention.launches += 1
    return (out, ml[0], ml[1]) if return_norm else out


flash_decode_attention.launches = 0
