"""KV-cache pruning policies: port of ``mustafar_tpu/ops/pruning.py``.

Tensor-to-tensor functions of the masked cache's pruning matrix:
  * per-token magnitude (``prune_token_mag``) and per-channel magnitude in
    groups of tokens (``prune_channel_mag``);
  * output-aware (Opa) scores (``key_opa_score``, ``value_opa_score``) and
    pruning by an arbitrary score (``prune_by_score_lastdim``,
    ``prune_channel_by_score``);
  * ThinK / ThinV structured channel pruning (``think_prune_key``,
    ``thinv_prune_value``).

The threshold rule is the reference's: the ``k = max(1, int(sparsity * n))``
-th smallest |x| of a row is the threshold and every entry at or above it
is kept, ties included, so a row may keep more than ``keep_count``.  This
is not ``sparse_format.topk_mask`` (the compressed cache's exact top-k).
``exact=True`` keeps exactly ``keep_count`` entries, ties to the lower
index, as ``jax.lax.top_k`` breaks them: a stable sort, since
``torch.topk`` orders ties arbitrarily.  Keep masks equal the JAX
package's bit for bit.
"""

from __future__ import annotations

import torch


def _kth_smallest_threshold(mag: torch.Tensor, k: int) -> torch.Tensor:
    """k-th smallest value along the last axis (1-indexed), keepdims."""
    return torch.sort(mag, dim=-1).values[..., k - 1:k]


def keep_count(n: int, sparsity: float) -> int:
    """Survivor count per pruned row under the reference threshold rule."""
    if sparsity <= 0:
        return n
    k = max(1, int(sparsity * n))
    return n - k + 1


def _top_mask(score: torch.Tensor, count: int) -> torch.Tensor:
    """Mask of the ``count`` largest entries of each row, ties to the lower
    index (``jax.lax.top_k``'s order)."""
    idx = torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :count]
    mask = torch.zeros(score.shape, dtype=torch.bool, device=score.device)
    return mask.scatter(-1, idx, True)


def _bottom_mask(score: torch.Tensor, count: int) -> torch.Tensor:
    """Mask of the ``count`` smallest entries of each row, ties to the lower
    index (``jax.lax.top_k(-score, count)``)."""
    idx = torch.sort(score, dim=-1, stable=True).indices[..., :count]
    mask = torch.zeros(score.shape, dtype=torch.bool, device=score.device)
    return mask.scatter(-1, idx, True)


def magnitude_mask_lastdim(x: torch.Tensor, sparsity: float,
                           exact: bool = False) -> torch.Tensor:
    """Keep-mask pruning along the last axis by magnitude: ``|x| >=
    kthvalue(|x|, int(sparsity * n))``, or with ``exact`` the top
    ``keep_count`` by |x|."""
    if sparsity <= 0:
        return torch.ones(x.shape, dtype=torch.bool, device=x.device)
    n = x.shape[-1]
    k = max(1, int(sparsity * n))
    mag = x.abs()
    if not exact:
        return mag >= _kth_smallest_threshold(mag, k)
    return _top_mask(mag, n - k + 1)


def prune_token_mag(x: torch.Tensor, sparsity: float, exact: bool = False) -> torch.Tensor:
    """Per-token magnitude pruning along head_dim: x [..., T, D], the
    smallest |x| of each token row zeroed."""
    return torch.where(magnitude_mask_lastdim(x, sparsity, exact), x,
                       torch.zeros_like(x))


def prune_channel_mag(x: torch.Tensor, sparsity: float, group_size: int,
                      exact: bool = False) -> torch.Tensor:
    """Per-channel magnitude pruning along the token axis, in groups: x
    [..., T, D] with T a multiple of ``group_size``; within each group each
    channel keeps its largest |x| across the group's tokens."""
    if sparsity <= 0:
        return x
    *lead, T, D = x.shape
    assert T % group_size == 0, (T, group_size)
    gt = x.reshape(*lead, T // group_size, group_size, D).transpose(-1, -2)
    mask = magnitude_mask_lastdim(gt, sparsity, exact).transpose(-1, -2).reshape(x.shape)
    return torch.where(mask, x, torch.zeros_like(x))


def key_opa_score(q_abs_mean: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Output-aware key score |mean_q(|q|) * k|: q_abs_mean [..., D] (query
    heads folded to their kv head), k [..., T, D]."""
    return (q_abs_mean[..., None, :] * k).abs()


def value_opa_score(attn_w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Output-aware value score |attn_weight * v|: attn_w [..., T] post-softmax
    weights (folded to kv heads), v [..., T, D]."""
    return (attn_w[..., None] * v).abs()


def prune_by_score_lastdim(x: torch.Tensor, score: torch.Tensor, sparsity: float,
                           exact: bool = False) -> torch.Tensor:
    """Zero the lowest-score entries of each row (last axis), by the
    threshold rule (or exact top-k with ``exact``)."""
    if sparsity <= 0:
        return x
    n = x.shape[-1]
    k = max(1, int(sparsity * n))
    if not exact:
        mask = score >= _kth_smallest_threshold(score, k)
    else:
        mask = _top_mask(score, n - k + 1)
    return torch.where(mask, x, torch.zeros_like(x))


def prune_channel_by_score(x: torch.Tensor, score: torch.Tensor, sparsity: float,
                           group_size: int, exact: bool = False) -> torch.Tensor:
    """Per-channel pruning along the token axis by an arbitrary score, in
    groups of ``group_size`` tokens (x and score [..., T, D])."""
    if sparsity <= 0:
        return x
    *lead, T, D = x.shape
    g = x.reshape(*lead, T // group_size, group_size, D).transpose(-1, -2)
    s = score.reshape(*lead, T // group_size, group_size, D).transpose(-1, -2)
    out = prune_by_score_lastdim(g, s, sparsity, exact)
    return out.transpose(-1, -2).reshape(x.shape)


def think_prune_key(k: torch.Tensor, q: torch.Tensor, sparsity: float,
                    last_queries: int = 32) -> torch.Tensor:
    """ThinK structured channel pruning of K, once at prefill: per channel
    score = mean(q[-last_queries:]**2) * mean(k**2); the ``int(sparsity*D)``
    lowest channels are zeroed for every token.  k [B, Hkv, T, D]; q [B, Hq,
    T, D], whose last rows are those of the padded bucket, pad rows
    included (the JAX package reads them so)."""
    if sparsity <= 0:
        return k
    B, Hkv, T, D = k.shape
    G = q.shape[1] // Hkv
    qg = q.reshape(B, Hkv, G, T, D)
    q_score = (qg[..., -last_queries:, :].to(torch.float32) ** 2).mean(dim=(2, 3))
    k_score = (k.to(torch.float32) ** 2).mean(dim=2)
    n_prune = int(sparsity * D)
    if n_prune == 0:
        return k
    drop = _bottom_mask(q_score * k_score, n_prune)            # [B, Hkv, D]
    return torch.where(drop[:, :, None, :], torch.zeros_like(k), k)


def thinv_prune_value(v: torch.Tensor, sparsity: float) -> torch.Tensor:
    """ThinV structured channel pruning of V, once at prefill: score =
    mean(v**2) per channel over the tokens; v [..., T, D]."""
    if sparsity <= 0:
        return v
    D = v.shape[-1]
    n_prune = int(sparsity * D)
    if n_prune == 0:
        return v
    drop = _bottom_mask((v.to(torch.float32) ** 2).mean(dim=-2), n_prune)
    return torch.where(drop[..., None, :], torch.zeros_like(v), v)


def sparsity_of(x: torch.Tensor) -> torch.Tensor:
    """Fraction of zero elements."""
    return (x == 0).to(torch.float32).mean()
