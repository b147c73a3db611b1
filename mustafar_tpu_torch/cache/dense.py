"""Dense KV cache, the baseline twin of the compressed cache: port of
``DenseKVCache`` in ``mustafar_tpu/cache/dense.py`` (uniform batch and
per-slot continuous batching).

State: k / v [L, B, S, Hkv, D], updated in place.  The JAX package decodes
this cache through XLA (its Pallas flash-decode kernel is off by default),
so the port decodes it in plain PyTorch and needs no kernel: attention over
the cached tokens and the new token as two flash partials, merged, as the
JAX package's stacked decode does.
"""

from __future__ import annotations

import torch

from mustafar_tpu_torch.config import EngineConfig
from mustafar_tpu_torch.device import resolve_device
from mustafar_tpu_torch.ops.attention import (attention_partials, merge_partials,
                                              prefill_attention)


class DenseKVCache:
    def __init__(self, engine: EngineConfig, device=None):
        self.device = resolve_device(device)
        self.engine = engine
        self.model = engine.model
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
        merged."""
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
        token.  An idle slot (pos -1) writes nothing; the JAX package would
        wrap its index to the last row, which the next ``insert_slot`` of
        that slot overwrites anyway."""
        k_l, v_l = state["k"][li], state["v"][li]
        B, S = k_l.shape[:2]
        dev = q.device
        cached = torch.arange(S, device=dev)[None, None, :] < pos[:, None, None]
        p_cached = attention_partials(q, k_l, v_l, cached)          # [B, 1, S] mask
        bidx = torch.arange(B, device=dev)
        row = pos.clamp(min=0)
        live = (pos >= 0)[:, None, None]
        for buf, tok in ((k_l, k), (v_l, v)):
            buf[bidx, row] = torch.where(live, tok[:, 0].to(buf.dtype), buf[bidx, row])
        p_self = attention_partials(q, k.to(k_l.dtype), v.to(v_l.dtype),
                                    torch.ones((1, 1), dtype=torch.bool, device=dev))
        return merge_partials([p_cached, p_self]).to(q.dtype)
