"""Dense and masked (prune-in-place) KV caches: port of ``DenseKVCache`` and
``MaskedKVCache`` in ``mustafar_tpu/cache/dense.py`` (uniform batch and
per-slot continuous batching).

State: k / v [L, B, S, Hkv, D], updated in place (and, for the masked
cache's output-aware methods, the score rings k_score / v_score [L, B, r,
Hkv, D] f32).  Decode, as in the JAX package, takes one of two routes:
  * by default (``use_pallas`` False, the JAX package's default), plain
    PyTorch: attention over the cached tokens (all max_seq_len rows, masked
    by each row's position) and the new token as two flash partials,
    merged, as the JAX package's stacked decode does;
  * with ``use_pallas`` (and head_dim a multiple of 128), the new row is
    written first and the post-append cache [0, pos] is attended in one call
    of the dense flash-decode kernel (``ops/kernels/dense_decode.py``): its
    CUDA kernel on the card, its plain version on the CPU.  The name is the
    JAX package's; here it selects the hand-written CUDA kernel.

With a sliding window (Mistral, ``ModelConfig.sliding_window``) a token at
position p attends keys k with p - window < k <= p, in prefill
(``prefill_attention``, banded past the window) and in decode, on every
route: the plain one masks the cached rows, the kernel takes ``window``.

The masked cache keeps the dense layout and zeroes pruned entries in place,
with the reference's semantics:
  * prefill attends the dense prompt, then prunes every token but the most
    recent ``residual_length`` (ThinK prunes every token and leaves V dense;
    channel policies prune only the groups of ``group_size`` tokens that lie
    wholly in the prefix);
  * decode attends the unpruned cache, then prunes the one token leaving
    the residual window (index pos - r), and nothing while that index is
    below 0; ThinK and ThinV prune nothing at decode;
  * the output-aware (Opa) methods accumulate each window token's score in
    a ring of r slots (slot = absolute index mod r) and prune a token by
    its ring score as it leaves; they decode over the post-append cache in
    one softmax, whose weights score V: ``mha`` with weights on the plain
    route, the dense kernel's final (m, l) (``return_norm``) and
    ``_window_probs`` with ``use_pallas``.
The JAX package's stacked twins of the row and block helpers (``*5``) fold
into ``_prune_row_at`` / ``_prune_block_at``: the port loops over layers in
Python and writes each layer's view in place.
"""

from __future__ import annotations

import math

import torch

from mustafar_tpu_torch.config import EngineConfig, PruneMethod
from mustafar_tpu_torch.device import resolve_device
from mustafar_tpu_torch.ops import pruning
from mustafar_tpu_torch.ops.kernels.dense_decode import flash_decode_attention
from mustafar_tpu_torch.ops.attention import (attention_partials, causal_mask,
                                              merge_partials, mha, prefill_attention)


class DenseKVCache:
    def __init__(self, engine: EngineConfig, use_pallas: bool | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.engine = engine
        self.model = engine.model
        self.use_pallas = False if use_pallas is None else use_pallas
        self.window = self.model.sliding_window

    def init(self, batch: int, dtype=torch.bfloat16) -> dict:
        m, S = self.model, self.engine.max_seq_len
        shape = (m.num_layers, batch, S, m.num_kv_heads, m.head_dim)
        state = {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                 "v": torch.zeros(shape, dtype=dtype, device=self.device)}
        state.update(self.extra_state(batch, dtype))
        return state

    def extra_state(self, batch: int, dtype) -> dict:
        return {}

    def prefill_attend(self, state, li: int, q, k, v, true_len: int):
        """q [B,T,Hq,D], k/v [B,T,Hkv,D] (roped) -> out; stores all T rows
        (after ``prefill_prune``)."""
        out = prefill_attention(q, k, v, true_len, self.window)
        k_store, v_store = self.prefill_prune(q, k, v, true_len)
        T = k.shape[1]
        state["k"][li, :, :T] = k_store
        state["v"][li, :, :T] = v_store
        return out

    def prefill_prune(self, q, k, v, true_len: int):
        return k, v

    def insert_slot(self, state, sub, slot: int) -> dict:
        """Copy the batch-1 cache ``sub`` into batch slot ``slot`` (in place):
        every key, the masked cache's score rings too."""
        for key, val in sub.items():
            state[key][:, slot] = val[:, 0].to(state[key].dtype)
        return state

    def reset(self, state: dict) -> dict:
        """``init``'s state again, in place: every tensor zeroed where it
        lies (a graph of the decode step holds their addresses)."""
        for val in state.values():
            val.zero_()
        return state

    def decode_attend(self, state, li: int, q, k, v, pos):
        """q [B,1,Hq,D], k/v [B,1,Hkv,D]; the token lands at row ``pos`` (a
        host int, uniform batch) or ``pos[b]`` (a [B] device tensor,
        per-slot; a 0-d device tensor is the uniform batch's position, taken
        as every slot's: ``slot_positions``).  Attention over the cache's
        rows before the token (past pos - window with a sliding window) and
        the token itself, merged: the plain route attends all max_seq_len
        rows masked by the position, as the JAX package's static-shape decode
        does, so a host position and a device one (the compiled decode) give
        the same bits; with ``use_pallas``, the post-append rows [0, pos] in
        one kernel call."""
        pos = slot_positions(pos, q.shape[0])
        if self.use_pallas and self.model.head_dim % 128 == 0:
            return self._decode_attend_kernel(state, li, q, k, v, pos)
        if not torch.is_tensor(pos):
            if pos < 1:
                raise ValueError(f"decode needs a prefilled cache, got pos {pos}")
            pos = torch.full((q.shape[0],), pos, dtype=torch.int64, device=q.device)
        return self._decode_attend_per_slot(state, li, q, k, v, pos)

    def _decode_attend_per_slot(self, state, li: int, q, k, v, pos):
        """Per-slot positions: slot b attends its rows [0, pos[b]) (past
        pos[b] - window with a sliding window) of all S rows, masked, and its
        token; an idle slot (pos -1) writes nothing (``_write_rows``)."""
        k_l, v_l = state["k"][li], state["v"][li]
        S = k_l.shape[1]
        dev = q.device
        kp = torch.arange(S, device=dev)[None, None, :]
        cached = kp < pos[:, None, None]
        if self.window is not None:
            cached &= kp > pos[:, None, None] - self.window
        p_cached = attention_partials(q, k_l, v_l, cached)          # [B, 1, S] mask
        _write_rows(k_l, v_l, k, v, pos)
        p_self = attention_partials(q, k.to(k_l.dtype), v.to(v_l.dtype),
                                    torch.ones((1, 1), dtype=torch.bool, device=dev))
        return merge_partials([p_cached, p_self]).to(q.dtype)

    def _append(self, state, li: int, k, v, pos):
        """Write the token's K and V at row ``pos`` (per slot ``pos[b]``, an
        idle slot at -1 writes nothing) of layer li; returns the layer's
        views and ``pos`` as the kernel takes it."""
        k_l, v_l = state["k"][li], state["v"][li]
        if torch.is_tensor(pos):
            _write_rows(k_l, v_l, k, v, pos)
            return k_l, v_l, pos.to(torch.int32)
        k_l[:, pos] = k[:, 0]
        v_l[:, pos] = v[:, 0]
        return k_l, v_l, pos

    def _decode_attend_kernel(self, state, li: int, q, k, v, pos):
        """Write the token's row, then attend rows [0, pos] (per slot
        [0, pos[b]]; an idle slot at -1 writes nothing and comes out 0;
        past pos - window with a sliding window) through the dense
        flash-decode kernel, as the JAX package's stacked path does with
        ``use_pallas``."""
        k_l, v_l, kpos = self._append(state, li, k, v, pos)
        return flash_decode_attention(q, k_l, v_l, kpos, window=self.window)


def slot_positions(pos, B: int):
    """A 0-d device position (a uniform batch's, the static decode step's)
    as the per-slot positions [B] it stands for; a host int or a [B] tensor
    as it is."""
    if torch.is_tensor(pos) and pos.dim() == 0:
        return pos.reshape(1).repeat(B)
    return pos


def _write_rows(k_l, v_l, k, v, pos):
    """Per slot, write the token's K and V at row ``pos[b]``; an idle slot
    (pos -1) writes nothing.  (The JAX package wraps its index to the last
    row, which the next ``insert_slot`` of that slot overwrites anyway.)"""
    bidx = torch.arange(k_l.shape[0], device=k_l.device)
    row = pos.clamp(min=0)
    live = (pos >= 0)[:, None, None]
    for buf, tok in ((k_l, k), (v_l, v)):
        buf[bidx, row] = torch.where(live, tok[:, 0].to(buf.dtype), buf[bidx, row])


def _per_slot(idx, B: int, device) -> torch.Tensor:
    """A host int or a [B] tensor of indices as an int64 tensor [B]."""
    if torch.is_tensor(idx):
        return idx.to(torch.int64)
    return torch.full((B,), idx, dtype=torch.int64, device=device)


def _prune_row_at(buf, idx, prune_fn):
    """Apply prune_fn to the token row ``idx`` of buf [B, S, H, D] in place:
    ``idx`` a host int (uniform) or [B] (per slot); an index below 0 leaves
    the row as it is."""
    if not torch.is_tensor(idx):
        if idx >= 0:
            buf[:, idx] = prune_fn(buf[:, idx:idx + 1])[:, 0]
        return
    bidx = torch.arange(buf.shape[0], device=buf.device)
    cidx = idx.clamp(min=0)
    row = buf[bidx, cidx][:, None]                                  # [B, 1, H, D]
    new = torch.where((idx >= 0)[:, None, None, None], prune_fn(row), row)
    buf[bidx, cidx] = new[:, 0]


def _prune_block_at(buf, start, size: int, do, prune_fn):
    """Apply prune_fn to buf[:, start:start+size] (in place) where ``do``
    and start >= 0: host ints (uniform) or [B] tensors (per slot, each
    sequence its own boundary)."""
    S = buf.shape[1]
    if not torch.is_tensor(start):
        if do and start >= 0:
            s = min(start, S - size)
            buf[:, s:s + size] = prune_fn(buf[:, s:s + size])
        return
    bidx = torch.arange(buf.shape[0], device=buf.device)[:, None]
    idx = start.clamp(0, S - size)[:, None] + torch.arange(size, device=buf.device)
    blk = buf[bidx, idx]                                            # [B, size, H, D]
    sel = (do & (start >= 0))[:, None, None, None]
    buf[bidx, idx] = torch.where(sel, prune_fn(blk), blk)


def _channel_fn(prune):
    """A [.., T, H, D] block pruned by a [.., H, T, D] channel policy."""
    return lambda blk: prune(blk.transpose(1, 2)).transpose(1, 2)


def prefill_k_opa_score(q, k, true_len: int) -> torch.Tensor:
    """Output-aware prefill K score |mean_valid(|q|) * k|, query heads folded
    to kv groups: q [B,T,Hq,D], k [B,T,Hkv,D] -> [B,T,Hkv,D] f32.  Shared
    by the masked and compressed caches."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    valid = (torch.arange(T, device=q.device) < true_len)[None, :, None, None]
    qa = torch.where(valid, q.to(torch.float32).abs(), 0.0)
    q_mean = qa.reshape(B, T, Hkv, Hq // Hkv, D).sum(dim=(1, 3)) / float(max(true_len, 1))
    return (q_mean[:, None] * k.to(torch.float32)).abs()


def prefill_v_opa_score(q, k, v, true_len: int, group_size: int,
                        window=None) -> torch.Tensor:
    """Output-aware prefill V score |attn_weight * v|, the weights the
    softmaxed attention of the last ``group_size`` queries (under the
    sliding ``window``, if any) summed over them and the query group ->
    [B,T,Hkv,D] f32.  Shared by the masked and compressed caches."""
    B, T, Hq, D = q.shape
    Hkv = v.shape[2]
    gs = group_size
    start = min(max(true_len - gs, 0), T - gs)          # JAX's dynamic_slice clamp
    pos = torch.arange(T, device=q.device)
    mask = causal_mask(start + torch.arange(gs, device=q.device), pos, true_len, window)
    _, w = mha(q[:, start:start + gs], k, v, mask, return_weights=True)
    w_kv = w.reshape(B, gs, Hkv, Hq // Hkv, T).sum(dim=(1, 3))     # [B, Hkv, T]
    return (w_kv[..., None] * v.transpose(1, 2).to(torch.float32)).abs().transpose(1, 2)


class MaskedKVCache(DenseKVCache):
    """Dense storage with the reference's pruning applied in place."""

    def __init__(self, engine: EngineConfig, use_pallas: bool | None = None,
                 device=None):
        super().__init__(engine, use_pallas, device)
        self.p = engine.prune
        self.method = self.p.method
        self.score_keys = ((("k_score",) if self.method.k_policy == "token_opa" else ())
                           + (("v_score",) if self._needs_weights() else ()))

    def _needs_weights(self) -> bool:
        """The Opa value policies score with post-softmax weights."""
        return self.method.v_policy in ("token_opa", "channel_opa")

    # -- prefill ----------------------------------------------------------
    def prefill_prune(self, q, k, v, true_len: int):
        """Prune every token but the most recent ``residual_length`` (ThinK
        and ThinV: every token)."""
        p, method = self.p, self.method
        if method in (PruneMethod.THINK, PruneMethod.THINV):
            k_store = pruning.think_prune_key(k.transpose(1, 2), q.transpose(1, 2),
                                              p.k_sparsity).transpose(1, 2)
            if method == PruneMethod.THINK:
                return k_store, v
            return k_store, pruning.thinv_prune_value(v.transpose(1, 2),
                                                      p.v_sparsity).transpose(1, 2)
        T = k.shape[1]
        in_prefix = (torch.arange(T, device=k.device) < true_len - p.residual_length)
        in_prefix = in_prefix[None, :, None, None]

        if method.k_policy == "token_mag":
            k_store = torch.where(in_prefix, pruning.prune_token_mag(k, p.k_sparsity), k)
        elif method.k_policy == "token_opa":
            k_pruned = pruning.prune_by_score_lastdim(
                k, prefill_k_opa_score(q, k, true_len), p.k_sparsity)
            k_store = torch.where(in_prefix, k_pruned, k)
        else:
            k_store = k

        if method.v_policy == "token_mag":
            v_store = torch.where(in_prefix, pruning.prune_token_mag(v, p.v_sparsity), v)
        elif method.v_policy == "channel_mag":
            v_store = self._prefill_prune_v_channel(v, true_len, None)
        elif method.v_policy == "token_opa":
            v_pruned = pruning.prune_by_score_lastdim(
                v, prefill_v_opa_score(q, k, v, true_len, p.group_size, self.window),
                p.v_sparsity)
            v_store = torch.where(in_prefix, v_pruned, v)
        elif method.v_policy == "channel_opa":
            v_store = self._prefill_prune_v_channel(
                v, true_len, prefill_v_opa_score(q, k, v, true_len, p.group_size,
                                                 self.window))
        else:
            v_store = v
        return k_store, v_store

    def _prefill_prune_v_channel(self, v, true_len: int, score):
        """Channel (Vc) prefill prune: T padded to a multiple of group_size,
        each group pruned along the token axis per channel, kept only for
        the groups whose last token lies before true_len - r."""
        gs, r = self.p.group_size, self.p.residual_length
        B, T, H, D = v.shape
        pad = (-T) % gs
        vt = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)).transpose(1, 2)
        if score is None:
            pruned = pruning.prune_channel_mag(vt, self.p.v_sparsity, gs)
        else:
            st = torch.nn.functional.pad(score, (0, 0, 0, 0, 0, pad)).transpose(1, 2)
            pruned = pruning.prune_channel_by_score(vt, st, self.p.v_sparsity, gs)
        pruned = pruned.transpose(1, 2)[:, :T]
        grp_end = torch.arange(T, device=v.device) // gs * gs + (gs - 1)
        return torch.where((grp_end < true_len - r)[None, :, None, None], pruned, v)

    # -- decode -----------------------------------------------------------
    def decode_attend(self, state, li: int, q, k, v, pos):
        """The dense cache's decode, then ``decode_prune``.  The Opa methods
        attend the post-append rows in one softmax: ``mha`` with weights
        (plain), or the dense kernel, with its final (m, l) when V is
        scored (``use_pallas``)."""
        pos = slot_positions(pos, q.shape[0])
        if not self.score_keys:
            out = super().decode_attend(state, li, q, k, v, pos)
            self.decode_prune(state, li, q, None, pos)
            return out
        k_l, v_l, kpos = self._append(state, li, k, v, pos)
        if self.use_pallas and self.model.head_dim % 128 == 0:
            if self._needs_weights():
                out, m, l = flash_decode_attention(q, k_l, v_l, kpos, window=self.window,
                                                   return_norm=True)
                w = ("win", self._window_probs(q, k_l, pos, m, l))
            else:
                out, w = flash_decode_attention(q, k_l, v_l, kpos, window=self.window), None
        else:
            kp = torch.arange(k_l.shape[1], device=q.device)
            if torch.is_tensor(pos):
                mask = kp[None, None, :] <= pos[:, None, None]
                if self.window is not None:
                    mask &= kp[None, None, :] > pos[:, None, None] - self.window
            else:
                mask = causal_mask(torch.tensor([pos], device=q.device), kp, pos + 1,
                                   self.window)
            out, w = mha(q, k_l, v_l, mask, return_weights=True)
        self.decode_prune(state, li, q, w, pos)
        return out

    def decode_prune(self, state, li: int, q, attn_w, pos):
        """Prune layer li's token leaving the residual window (index pos - r),
        in place."""
        p, m = self.p, self.method
        if m in (PruneMethod.THINK, PruneMethod.THINV):
            return
        exit_idx = pos - p.residual_length
        k_l, v_l = state["k"][li], state["v"][li]
        if m.k_policy == "token_mag":
            _prune_row_at(k_l, exit_idx, lambda x: pruning.prune_token_mag(x, p.k_sparsity))
        elif m.k_policy == "token_opa":
            self._decode_prune_k_opa(k_l, state["k_score"][li], q, exit_idx)
        if m.v_policy == "token_mag":
            _prune_row_at(v_l, exit_idx, lambda x: pruning.prune_token_mag(x, p.v_sparsity))
        elif m.v_policy == "channel_mag":
            gs = p.group_size
            # a whole group has left the window: prune it along the tokens
            _prune_block_at(v_l, exit_idx - (gs - 1), gs,
                            (exit_idx >= gs - 1) & ((exit_idx - (gs - 1)) % gs == 0),
                            _channel_fn(lambda x: pruning.prune_channel_mag(
                                x, p.v_sparsity, gs)))
        elif m.v_policy == "token_opa":
            self._decode_prune_v_opa(v_l, state["v_score"][li], attn_w, exit_idx)
        elif m.v_policy == "channel_opa":
            self._decode_prune_v_channel_opa(v_l, state["v_score"][li], attn_w, exit_idx)

    # ---- Opa rings --------------------------------------------------------
    # A ring of r slots holds the accumulated score of each window token
    # (slot = absolute index mod r).  A step prunes the token leaving the
    # window by its ring score and zeroes its slot, then adds the step's
    # scores for the r tokens now in the window.  As in the JAX package the
    # slot of index max(pos - r, 0) is zeroed every step, also while
    # pos - r < 0.

    def extra_state(self, batch: int, dtype) -> dict:
        m, r = self.model, self.p.residual_length
        return {key: torch.zeros((m.num_layers, batch, r, m.num_kv_heads, m.head_dim),
                                 dtype=torch.float32, device=self.device)
                for key in self.score_keys}

    def _window_geometry(self, pos, B: int, device):
        """The r window tokens [pos-r+1 .. pos] (post-append): (abs_idx
        [B, r], slots [B, r], valid [B, r])."""
        r = self.p.residual_length
        abs_idx = _per_slot(pos, B, device)[:, None] - (r - 1) + torch.arange(r, device=device)
        return abs_idx, abs_idx % r, abs_idx >= 0

    def _ring_prune_row(self, buf, ring, exit_idx, sparsity: float):
        """Prune cache row exit_idx by its ring score; zero its slot after."""
        B = buf.shape[0]
        bidx = torch.arange(B, device=buf.device)
        exit_v = _per_slot(exit_idx, B, buf.device)
        cidx = exit_v.clamp(min=0)
        slot = cidx % self.p.residual_length
        row = buf[bidx, cidx][:, None]
        pruned = pruning.prune_by_score_lastdim(row, ring[bidx, slot][:, None], sparsity)
        buf[bidx, cidx] = torch.where((exit_v >= 0)[:, None, None, None], pruned, row)[:, 0]
        ring[bidx, slot] = 0.0

    @staticmethod
    def _ring_accumulate(ring, step, slots, valid):
        """Add step [B, r, H, D] into the ring slots where valid."""
        bidx = torch.arange(ring.shape[0], device=ring.device)[:, None]
        ring[bidx, slots] = ring[bidx, slots] + torch.where(valid[:, :, None, None], step, 0.0)

    @staticmethod
    def _window_rows(buf, abs_idx):
        """Rows of buf [B, S, H, D] at abs_idx [B, r] (clamped at 0)."""
        bidx = torch.arange(buf.shape[0], device=buf.device)[:, None]
        return buf[bidx, abs_idx.clamp(min=0)]

    def _decode_prune_k_opa(self, k_l, ring, q, exit_idx):
        r = self.p.residual_length
        B, _, Hq, D = q.shape
        Hkv = k_l.shape[2]
        self._ring_prune_row(k_l, ring, exit_idx, self.p.k_sparsity)
        abs_idx, slots, valid = self._window_geometry(exit_idx + r, B, k_l.device)
        qa = q[:, 0].to(torch.float32).abs().reshape(B, Hkv, Hq // Hkv, D).mean(dim=2)
        rows = self._window_rows(k_l, abs_idx).to(torch.float32)
        self._ring_accumulate(ring, (qa[:, None] * rows).abs(), slots, valid)

    def _window_probs(self, q, kbuf, pos, m, l):
        """Post-softmax weights at the r window columns from the dense
        kernel's final stats: p = exp(bf16(q) . bf16(k) / sqrt(D) - m) / l
        (l clamped at 1e-30), summed over the query group -> [B, Hkv, r],
        0 at invalid columns (before the sequence, or at or below pos -
        window)."""
        B, _, Hq, D = q.shape
        Hkv = kbuf.shape[2]
        abs_idx, _, valid = self._window_geometry(pos, B, q.device)
        if self.window is not None:
            valid = valid & (abs_idx > _per_slot(pos, B, q.device)[:, None] - self.window)
        rows = self._window_rows(kbuf, abs_idx).to(torch.bfloat16).to(torch.float32)
        qg = q[:, 0].reshape(B, Hkv, Hq // Hkv, D).to(torch.bfloat16).to(torch.float32)
        s = torch.einsum("bhgd,brhd->bhgr", qg, rows) * (1.0 / math.sqrt(D))
        p = torch.exp(s - m) / torch.clamp_min(l, 1e-30)
        return torch.where(valid[:, None, None, :], p, 0.0).sum(dim=2)

    def _win_w(self, attn_w, abs_idx):
        """Window-column weights [B, Hkv, r] from either source: the
        kernel's (``("win", w)``) or the full weights [B, 1, Hq, S]."""
        if isinstance(attn_w, tuple) and attn_w[0] == "win":
            return attn_w[1]
        B, _, Hq, S = attn_w.shape
        Hkv = self.model.num_kv_heads
        w_kv = attn_w.reshape(B, Hkv, Hq // Hkv, S).sum(dim=2)
        return torch.gather(w_kv, 2, abs_idx.clamp(min=0)[:, None, :].expand(B, Hkv, -1))

    def _accumulate_v(self, v_l, ring, attn_w, pos):
        abs_idx, slots, valid = self._window_geometry(pos, v_l.shape[0], v_l.device)
        w_win = self._win_w(attn_w, abs_idx)                        # [B, Hkv, r]
        rows = self._window_rows(v_l, abs_idx).to(torch.float32)
        self._ring_accumulate(ring, (w_win.transpose(1, 2)[..., None] * rows).abs(),
                              slots, valid)

    def _decode_prune_v_opa(self, v_l, ring, attn_w, exit_idx):
        self._ring_prune_row(v_l, ring, exit_idx, self.p.v_sparsity)
        self._accumulate_v(v_l, ring, attn_w, exit_idx + self.p.residual_length)

    def _decode_prune_v_channel_opa(self, v_l, ring, attn_w, exit_idx):
        """Channel Opa: when a whole group has left the window, prune it
        along the tokens by its ring scores and zero those slots; then
        accumulate as token Opa."""
        B, S = v_l.shape[:2]
        r, gs = self.p.residual_length, self.p.group_size
        dev = v_l.device
        exit_v = _per_slot(exit_idx, B, dev)
        boundary = (exit_v >= gs - 1) & ((exit_v - (gs - 1)) % gs == 0)
        if torch.is_tensor(exit_idx) or (exit_idx >= gs - 1 and (exit_idx + 1) % gs == 0):
            bidx = torch.arange(B, device=dev)[:, None]
            g_idx = (exit_v - (gs - 1)).clamp(0, S - gs)[:, None] + torch.arange(gs, device=dev)
            g_slots = g_idx % r
            blk = v_l[bidx, g_idx]                                  # [B, gs, H, D]
            sblk = ring[bidx, g_slots]
            pruned = pruning.prune_channel_by_score(
                blk.transpose(1, 2), sblk.transpose(1, 2), self.p.v_sparsity,
                gs).transpose(1, 2)
            sel = boundary[:, None, None, None]
            v_l[bidx, g_idx] = torch.where(sel, pruned, blk)
            ring[bidx, g_slots] = torch.where(sel, 0.0, sblk)
        self._accumulate_v(v_l, ring, attn_w, exit_v + r)
