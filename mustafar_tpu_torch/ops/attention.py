"""Plain attention math: causal prefill and decode partials, port of
``mustafar_tpu/ops/attention.py``.

On the TPU the JAX package's prefill reaches a flash kernel that ships with
JAX, not one of its own; off the TPU it runs this masked attention, and so
does the port.  Softmax is taken in float32.  Layouts: q [B, T, Hq, D];
k/v [B, S, Hkv, D]; GQA folds the query heads into kv groups.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _fold_gqa(q: torch.Tensor, num_kv_heads: int) -> torch.Tensor:
    B, T, Hq, D = q.shape
    return q.reshape(B, T, num_kv_heads, Hq // num_kv_heads, D)


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, valid_len) -> torch.Tensor:
    """[Tq, Tk] bool: k attends iff k_pos <= q_pos and k_pos < valid_len.
    (The JAX package's sliding-window term waits for the Mistral slice.)"""
    return (k_pos[None, :] <= q_pos[:, None]) & (k_pos[None, :] < valid_len)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: torch.Tensor) -> torch.Tensor:
    """Masked GQA attention.  q [B, Tq, Hq, D]; k/v [B, S, Hkv, D]; mask
    [Tq, S] or [B, Tq, S] bool.  Products in f32 (bf16 inputs multiply
    exactly in f32), the probabilities rounded to v's dtype before the
    value product, as the JAX package does."""
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
    return out.reshape(B, Tq, Hq, D).to(q.dtype)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      true_len: int) -> torch.Tensor:
    """Causal prefill attention, q [B,T,Hq,D], k/v [B,T,Hkv,D] -> [B,T,Hq,D].
    Rows at or past ``true_len`` are garbage that no caller reads."""
    T = q.shape[1]
    pos = torch.arange(T, device=q.device)
    return mha(q, k, v, causal_mask(pos, pos, true_len))


def attention_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask: torch.Tensor):
    """Unnormalised flash partials of masked GQA attention.

    q [B,Tq,Hq,D]; k/v [B,S,Hkv,D]; mask [Tq,S] bool.  Returns
    (acc [B,Tq,Hq,D] f32, m [B,Tq,Hq,1], l [B,Tq,Hq,1]); all-masked rows give
    m = -1e30, l = 0, acc = 0."""
    B, Tq, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = _fold_gqa(q, Hkv).to(torch.float32)
    s = torch.einsum("bthgd,bshd->bthgs", qg, k.to(torch.float32))
    s = s * (1.0 / math.sqrt(D))
    m_ = mask[None, :, None, None, :]
    s = s.masked_fill(~m_, NEG_INF)
    m = torch.clamp_min(s.amax(dim=-1, keepdim=True), NEG_INF)
    p = torch.exp(s - m).masked_fill(~m_, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bthgs,bshd->bthgd",
                       p.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return (acc.reshape(B, Tq, Hq, D), m.reshape(B, Tq, Hq, 1),
            l.reshape(B, Tq, Hq, 1))


def merge_partials(parts):
    """Merge flash partials [(acc, m, l), ...] into the normalised f32 output."""
    M = parts[0][1]
    for _, m, _ in parts[1:]:
        M = torch.maximum(M, m)
    num = 0.0
    den = 0.0
    for acc, m, l in parts:
        a = torch.exp(m - M)
        num = num + acc * a
        den = den + l * a
    return num / torch.clamp_min(den, 1e-30)
