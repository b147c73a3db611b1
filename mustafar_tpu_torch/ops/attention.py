"""Plain attention math: causal prefill (with Mistral's sliding window),
and decode partials, port of ``mustafar_tpu/ops/attention.py``.

On the TPU the JAX package's prefill reaches a flash kernel that ships with
JAX, not one of its own; off the TPU it runs this masked attention, and so
does the port.  A sliding-window prompt longer than the window goes through
``banded_window_prefill``, whose memory grows with T, not T^2.  Softmax is
taken in float32.  Layouts: q [B, T, Hq, D]; k/v [B, S, Hkv, D]; GQA folds
the query heads into kv groups.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _fold_gqa(q: torch.Tensor, num_kv_heads: int) -> torch.Tensor:
    B, T, Hq, D = q.shape
    return q.reshape(B, T, num_kv_heads, Hq // num_kv_heads, D)


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, valid_len,
                window=None) -> torch.Tensor:
    """[Tq, Tk] bool: k attends iff k_pos <= q_pos, k_pos < valid_len and,
    with a sliding ``window``, k_pos > q_pos - window (``window`` keys, the
    query's own included)."""
    m = (k_pos[None, :] <= q_pos[:, None]) & (k_pos[None, :] < valid_len)
    if window is not None:
        m &= k_pos[None, :] > q_pos[:, None] - window
    return m


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: torch.Tensor, return_weights: bool = False):
    """Masked GQA attention.  q [B, Tq, Hq, D]; k/v [B, S, Hkv, D]; mask
    [Tq, S] or [B, Tq, S] bool.  Products in f32 (bf16 inputs multiply
    exactly in f32), the probabilities rounded to v's dtype before the
    value product, as the JAX package does.  With ``return_weights`` also
    the f32 post-softmax weights [B, Tq, Hq, S] (the masked cache's Opa
    scoring reads them)."""
    B, Tq, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = _fold_gqa(q, Hkv).to(torch.float32)                 # [B,Tq,Hkv,G,D]
    logits = torch.einsum("bthgd,bshd->bthgs", qg, k.to(torch.float32))
    logits = logits * (1.0 / math.sqrt(D))
    m = mask[None, :, None, None, :] if mask.ndim == 2 else mask[:, :, None, None, :]
    logits = logits.masked_fill(~m, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bthgs,bshd->bthgd",
                       w.to(v.dtype).to(torch.float32), v.to(torch.float32))
    out = out.reshape(B, Tq, Hq, D).to(q.dtype)
    if return_weights:
        return out, w.reshape(B, Tq, Hq, w.shape[-1])
    return out


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      true_len: int, window=None) -> torch.Tensor:
    """Causal prefill attention, q [B,T,Hq,D], k/v [B,T,Hkv,D] -> [B,T,Hq,D].
    Rows at or past ``true_len`` are garbage that no caller reads.  With a
    sliding ``window`` shorter than the prompt, the banded path
    (``banded_window_prefill``); a window that covers the prompt masks
    nothing (k > q - window holds for every causal pair) and runs causal."""
    T = q.shape[1]
    if window is not None and T > window:
        return banded_window_prefill(q, k, v, true_len, int(window))
    pos = torch.arange(T, device=q.device)
    return mha(q, k, v, causal_mask(pos, pos, true_len))


BAND_LOGIT_BYTES = 256 * 2 ** 20     # most f32 logits one band may hold


def band_block(B: int, Hq: int, W: int) -> int:
    """The query block of ``banded_window_prefill``: the largest of 512 and
    256 whose f32 band logits B * Bq * Hq * (W + Bq) * 4 fit in 256 MiB,
    else 128 (the JAX package's rule; 128 even where it does not fit)."""
    for cand in (512, 256):
        if B * cand * Hq * (W + cand) * 4 <= BAND_LOGIT_BYTES:
            return cand
    return 128


def banded_window_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          true_len: int, window: int, block=None) -> torch.Tensor:
    """Sliding-window prefill at O(T) memory and O(T (W + Bq)) work: query
    block i of Bq rows attends only its band of W + Bq keys (positions
    i Bq - W .. i Bq + Bq - 1, K and V left-padded by W zeros), which holds
    every key its queries see, so each band's softmax is the whole softmax
    and no merge is needed.  Blocks run one at a time, so the largest
    temporary is one band's f32 logits [B, Bq, Hq, W + Bq] (``band_block``
    picks Bq).  Keys at or past ``true_len`` and the padding are masked; rows
    at or past ``true_len`` are garbage that no caller reads."""
    B, T, Hq, D = q.shape
    W = int(window)
    Bq = band_block(B, Hq, W) if block is None else int(block)
    n = -(-T // Bq)
    Tp = n * Bq
    pad = torch.nn.functional.pad
    qp = pad(q, (0, 0, 0, 0, 0, Tp - T))
    kp = pad(k, (0, 0, 0, 0, W, Tp - T))
    vp = pad(v, (0, 0, 0, 0, W, Tp - T))
    out = torch.empty((B, Tp, Hq, D), dtype=q.dtype, device=q.device)
    ar_q = torch.arange(Bq, device=q.device)
    ar_k = torch.arange(W + Bq, device=q.device)
    for i in range(n):
        s = i * Bq
        kpos = s - W + ar_k
        mask = causal_mask(s + ar_q, kpos, true_len, W) & (kpos >= 0)[None, :]
        out[:, s:s + Bq] = mha(qp[:, s:s + Bq], kp[:, s:s + W + Bq],
                               vp[:, s:s + W + Bq], mask)
    return out[:, :T]


def attention_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask: torch.Tensor):
    """Unnormalised flash partials of masked GQA attention.

    q [B,Tq,Hq,D]; k/v [B,S,Hkv,D]; mask [Tq,S] or [B,Tq,S] bool (a
    segment's window and causal-self masks are [Tq,S]; per-slot decode's
    [B,1,S]).  Returns (acc [B,Tq,Hq,D] f32, m [B,Tq,Hq,1], l [B,Tq,Hq,1]);
    all-masked rows give m = -1e30, l = 0, acc = 0."""
    B, Tq, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = _fold_gqa(q, Hkv).to(torch.float32)
    s = torch.einsum("bthgd,bshd->bthgs", qg, k.to(torch.float32))
    s = s * (1.0 / math.sqrt(D))
    m_ = mask[None, :, None, None, :] if mask.ndim == 2 else mask[:, :, None, None, :]
    s = s.masked_fill(~m_, NEG_INF)
    m = torch.clamp_min(s.amax(dim=-1, keepdim=True), NEG_INF)
    p = torch.exp(s - m).masked_fill(~m_, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bthgs,bshd->bthgd",
                       p.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return (acc.reshape(B, Tq, Hq, D), m.reshape(B, Tq, Hq, 1),
            l.reshape(B, Tq, Hq, 1))


def merge_partials(parts, return_stats: bool = False):
    """Merge flash partials [(acc, m, l), ...] into the normalised f32 output;
    with ``return_stats`` also the merged softmax stats (M, l) (l
    unclamped), in the order the kernels' merges take them."""
    M = parts[0][1]
    for _, m, _ in parts[1:]:
        M = torch.maximum(M, m)
    num = 0.0
    den = 0.0
    for acc, m, l in parts:
        a = torch.exp(m - M)
        num = num + acc * a
        den = den + l * a
    out = num / torch.clamp_min(den, 1e-30)
    return (out, M, den) if return_stats else out
