"""Dense KV cache, the baseline twin of the compressed cache: port of
``DenseKVCache`` in ``mustafar_tpu/cache/dense.py`` (uniform batch).

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

    def decode_attend(self, state, li: int, q, k, v, pos: int):
        """q [B,1,Hq,D], k/v [B,1,Hkv,D]; the token lands at row ``pos``.
        Attention over rows [0, pos) and the token itself, merged."""
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
