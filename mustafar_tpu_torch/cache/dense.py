"""Dense KV cache, the baseline twin of the compressed cache: port of
``DenseKVCache`` in ``mustafar_tpu/cache/dense.py`` (uniform batch and
per-slot continuous batching).

State: k / v [L, B, S, Hkv, D], updated in place.  Decode, as in the JAX
package, takes one of two routes:
  * by default (``use_pallas`` False, the JAX package's default), plain
    PyTorch: attention over the cached tokens and the new token as two
    flash partials, merged, as the JAX package's stacked decode does;
  * with ``use_pallas`` (and head_dim a multiple of 128), the new row is
    written first and the post-append cache [0, pos] is attended in one call
    of the dense flash-decode kernel (``ops/kernels/dense_decode.py``): its
    CUDA kernel on the card, its plain version on the CPU.  The name is the
    JAX package's; here it selects the hand-written CUDA kernel.
"""

from __future__ import annotations

import torch

from mustafar_tpu_torch.config import EngineConfig
from mustafar_tpu_torch.device import resolve_device
from mustafar_tpu_torch.ops.kernels.dense_decode import flash_decode_attention
from mustafar_tpu_torch.ops.attention import (attention_partials, merge_partials,
                                              prefill_attention)


class DenseKVCache:
    def __init__(self, engine: EngineConfig, use_pallas: bool | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.engine = engine
        self.model = engine.model
        self.use_pallas = False if use_pallas is None else use_pallas
        if self.model.sliding_window is not None:
            raise NotImplementedError("sliding windows are ROADMAP Queue A item 14")

    def init(self, batch: int, dtype=torch.bfloat16) -> dict:
        m, S = self.model, self.engine.max_seq_len
        shape = (m.num_layers, batch, S, m.num_kv_heads, m.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device)}

    def prefill_attend(self, state, li: int, q, k, v, true_len: int):
        """q [B,T,Hq,D], k/v [B,T,Hkv,D] (roped) -> out; stores all T rows."""
        out = prefill_attention(q, k, v, true_len)
        T = k.shape[1]
        state["k"][li, :, :T] = k
        state["v"][li, :, :T] = v
        return out

    def insert_slot(self, state, sub, slot: int) -> dict:
        """Copy the batch-1 cache ``sub`` into batch slot ``slot`` (in place)."""
        for key in ("k", "v"):
            state[key][:, slot] = sub[key][:, 0].to(state[key].dtype)
        return state

    def decode_attend(self, state, li: int, q, k, v, pos):
        """q [B,1,Hq,D], k/v [B,1,Hkv,D]; the token lands at row ``pos`` (a
        host int, uniform batch) or ``pos[b]`` (a [B] device tensor,
        per-slot).  Attention over rows [0, pos) and the token itself,
        merged; with ``use_pallas``, over the post-append rows [0, pos] in
        one kernel call."""
        if self.use_pallas and self.model.head_dim % 128 == 0:
            return self._decode_attend_kernel(state, li, q, k, v, pos)
        if torch.is_tensor(pos):
            return self._decode_attend_per_slot(state, li, q, k, v, pos)
        if pos < 1:
            raise ValueError(f"decode needs a prefilled cache, got pos {pos}")
        k_l, v_l = state["k"][li], state["v"][li]
        ones = torch.ones((1, pos), dtype=torch.bool, device=q.device)
        p_cached = attention_partials(q, k_l[:, :pos], v_l[:, :pos], ones)
        k_l[:, pos] = k[:, 0]
        v_l[:, pos] = v[:, 0]
        p_self = attention_partials(q, k.to(k_l.dtype), v.to(v_l.dtype),
                                    torch.ones((1, 1), dtype=torch.bool,
                                               device=q.device))
        return merge_partials([p_cached, p_self]).to(q.dtype)

    def _decode_attend_per_slot(self, state, li: int, q, k, v, pos):
        """Per-slot positions: slot b attends its rows [0, pos[b]) and its
        token; an idle slot (pos -1) writes nothing (``_write_rows``)."""
        k_l, v_l = state["k"][li], state["v"][li]
        S = k_l.shape[1]
        dev = q.device
        cached = torch.arange(S, device=dev)[None, None, :] < pos[:, None, None]
        p_cached = attention_partials(q, k_l, v_l, cached)          # [B, 1, S] mask
        _write_rows(k_l, v_l, k, v, pos)
        p_self = attention_partials(q, k.to(k_l.dtype), v.to(v_l.dtype),
                                    torch.ones((1, 1), dtype=torch.bool, device=dev))
        return merge_partials([p_cached, p_self]).to(q.dtype)

    def _decode_attend_kernel(self, state, li: int, q, k, v, pos):
        """Write the token's row, then attend rows [0, pos] (per slot
        [0, pos[b]]; an idle slot at -1 writes nothing and comes out 0)
        through the dense flash-decode kernel, as the JAX package's stacked
        path does with ``use_pallas``."""
        k_l, v_l = state["k"][li], state["v"][li]
        if torch.is_tensor(pos):
            _write_rows(k_l, v_l, k, v, pos)
            pos = pos.to(torch.int32)
        else:
            k_l[:, pos] = k[:, 0]
            v_l[:, pos] = v[:, 0]
        return flash_decode_attention(q, k_l, v_l, pos)


def _write_rows(k_l, v_l, k, v, pos):
    """Per slot, write the token's K and V at row ``pos[b]``; an idle slot
    (pos -1) writes nothing.  (The JAX package wraps its index to the last
    row, which the next ``insert_slot`` of that slot overwrites anyway.)"""
    bidx = torch.arange(k_l.shape[0], device=k_l.device)
    row = pos.clamp(min=0)
    live = (pos >= 0)[:, None, None]
    for buf, tok in ((k_l, k), (v_l, v)):
        buf[bidx, row] = torch.where(live, tok[:, 0].to(buf.dtype), buf[bidx, row])
