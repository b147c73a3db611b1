"""Compressed KV cache, q8q4 codec, uniform batch: port of the served subset
of ``mustafar_tpu/cache/compressed.py``.

State (a dict, the JAX package's layouts, updated in place):
  kv_pool   [L, mc, B, Hkv, 192, 128] int16  packed chunks, K rows then V rows
  kv_scales [L, mc, B, Hkv, 2, 128]   bf16   per-channel K and V scales
  k_win / v_win [L, B, Hkv, r+C, 128]        dense residual window
  n_chunks  [L, B] int32                     active chunks
  nc_host   int                              host copy of n_chunks (uniform
                                             batch), so a decode step never
                                             reads the device to size itself
Semantics:
  * prefill: attention over the dense prompt; then the first
    ``((T - r) // C) * C`` tokens are pruned (exact top-|x| per token) and
    packed chunk by chunk, and the rest becomes the dense window.
  * decode: the new token goes into the window; attention covers the pool
    chunks and the window in one online softmax (the q8q4 kernel on the
    card, its plain version on the CPU).
  * compaction is a separate call between decode steps: when the window
    holds r + C tokens the oldest C are pruned and packed into the pool and
    the window shifts.
"""

from __future__ import annotations

import torch

from mustafar_tpu_torch.config import EngineConfig
from mustafar_tpu_torch.device import resolve_device
from mustafar_tpu_torch.ops import quant_format as qf
from mustafar_tpu_torch.ops import sparse_format as sf
from mustafar_tpu_torch.ops.attention import prefill_attention
from mustafar_tpu_torch.ops.kernels import quant_attention as qa


class CompressedKVCache:
    def __init__(self, engine: EngineConfig, device=None):
        self.device = resolve_device(device)
        self.engine = engine
        self.model = m = engine.model
        p = engine.prune
        self.p = p
        if p.method.k_policy != "token_mag" or p.method.v_policy != "token_mag":
            raise NotImplementedError(
                f"compressed cache serves KT_MAG_VT_MAG; {p.method} "
                "(output-aware policies) is ROADMAP Queue A item 12")
        if engine.codec != "q8q4":
            raise NotImplementedError(
                f"codec {engine.codec!r}: q8 and q4q4 are ROADMAP Queue A item 8, "
                "the bitmap codecs item 11")
        if m.sliding_window is not None:
            raise NotImplementedError("sliding windows are ROADMAP Queue A item 14")
        assert m.head_dim == 128, (
            f"the compressed format packs 128-wide rows; head_dim must be 128 "
            f"(got {m.head_dim})")
        C = engine.chunk_size
        self.C = C
        self.r = p.residual_length
        self.wcap = self.r + C
        self.max_chunks = max(1, (engine.max_seq_len - self.r) // C)
        self.k_keep = p.kept_per_row(m.head_dim, p.k_sparsity)
        self.v_keep = p.kept_per_row(m.head_dim, p.v_sparsity)
        self.qcodec = qf.QuantCodec(C, m.head_dim, 8, 4)

    # -- state ------------------------------------------------------------
    def init(self, batch: int, dtype=torch.bfloat16) -> dict:
        m, mc, dev = self.model, self.max_chunks, self.device
        L, H, D = m.num_layers, m.num_kv_heads, m.head_dim
        return {
            "k_win": torch.zeros((L, batch, H, self.wcap, D), dtype=dtype, device=dev),
            "v_win": torch.zeros((L, batch, H, self.wcap, D), dtype=dtype, device=dev),
            "n_chunks": torch.zeros((L, batch), dtype=torch.int32, device=dev),
            "kv_pool": torch.zeros((L, mc, batch, H, self.qcodec.stream_rows, 128),
                                   dtype=torch.int16, device=dev),
            "kv_scales": torch.zeros((L, mc, batch, H, 2, D), dtype=torch.bfloat16,
                                     device=dev),
            "nc_host": 0,
        }

    # -- packing ----------------------------------------------------------
    def _pack_chunk_q(self, dense_bhtd: torch.Tensor, kind: str):
        """dense [B, Hkv, C, D] -> (rows [BH, R, 128] int16, scales [BH, D]
        bf16): top-|x| keep per token, then quantize the survivors."""
        B, H, C, D = dense_bhtd.shape
        x = dense_bhtd.reshape(B * H, C, D).to(torch.bfloat16)
        keep = self.k_keep if kind == "k" else self.v_keep
        pruned = torch.where(sf.topk_mask(x, keep), x, torch.zeros_like(x))
        return qf.encode_chunk(pruned, self.qcodec, kind)

    def _pack_rows_scales(self, k_chunk, v_chunk):
        """K and V chunks [B, Hkv, C, D] -> (rows [B, Hkv, ROWS, 128],
        scales [B, Hkv, 2, D])."""
        B, H = k_chunk.shape[:2]
        k_rows, k_sc = self._pack_chunk_q(k_chunk, "k")
        v_rows, v_sc = self._pack_chunk_q(v_chunk, "v")
        rows = torch.cat([k_rows, v_rows], dim=-2)
        scales = torch.stack([k_sc, v_sc], dim=1)
        return (rows.reshape(B, H, *rows.shape[1:]),
                scales.reshape(B, H, 2, k_sc.shape[-1]))

    def _append_chunk(self, state, li: int, chunk_idx: int, k_chunk, v_chunk):
        """Prune and pack one dense chunk into pool slot ``chunk_idx`` of layer li."""
        rows, scales = self._pack_rows_scales(k_chunk, v_chunk)
        state["kv_pool"][li, chunk_idx] = rows
        state["kv_scales"][li, chunk_idx] = scales

    # -- prefill ----------------------------------------------------------
    def prefill_attend(self, state, li: int, q, k, v, true_len: int):
        """q [B,T,Hq,D], k/v [B,T,Hkv,D] (roped) -> out [B,T,Hq,D]; fills
        layer li's pool and window."""
        T = q.shape[1]
        out = prefill_attention(q, k, v, true_len)
        C = self.C
        comp_len = max(true_len - self.r, 0) // C * C
        n_pre = comp_len // C
        kh = k.transpose(1, 2)                                  # [B, Hkv, T, D]
        vh = v.transpose(1, 2)
        for i in range(n_pre):
            self._append_chunk(state, li, i, kh[:, :, i * C:(i + 1) * C],
                               vh[:, :, i * C:(i + 1) * C])
        state["n_chunks"][li] = n_pre
        state["nc_host"] = n_pre
        # window <- tokens [comp_len, true_len), zero past true_len
        idx = comp_len + torch.arange(self.wcap, device=k.device)
        take = torch.clamp_max(idx, T - 1)
        valid = (idx < true_len)[None, None, :, None]
        for key, src in (("k_win", kh), ("v_win", vh)):
            rows = src[:, :, take]
            state[key][li] = torch.where(valid, rows, torch.zeros_like(rows))
        return out

    # -- decode -----------------------------------------------------------
    def decode_attend(self, state, li: int, q, k, v, pos: int):
        """q [B,1,Hq,D], k/v [B,1,Hkv,D]; appends the token to layer li's
        window and attends pools + window.  ``pos`` is the host index of the
        token.  Compaction is not done here (see ``compact``)."""
        B, _, _, D = q.shape
        nc = state["nc_host"]
        win_len = pos + 1 - nc * self.C
        if not 1 <= win_len <= self.wcap:
            raise ValueError(
                f"token {pos} leaves a window of {win_len} beside {nc} chunks "
                f"(capacity {self.wcap}): compact() was not called when due")
        state["k_win"][li, :, :, win_len - 1] = k[:, 0]
        state["v_win"][li, :, :, win_len - 1] = v[:, 0]
        H = self.model.num_kv_heads
        L, mc = state["kv_pool"].shape[:2]
        pool = state["kv_pool"].view(L, mc, B * H, *state["kv_pool"].shape[4:])
        scales = state["kv_scales"].view(L, mc, B * H, 2, D)
        kw = state["k_win"].view(L, B * H, self.wcap, D)
        vw = state["v_win"].view(L, B * H, self.wcap, D)
        lk = li
        if kw.dtype != torch.bfloat16:
            # float32 caches (CPU parity runs): the kernel reads bf16 windows,
            # so cast this layer's slice, as the JAX package casts its window
            kw, vw = kw[li:li + 1].to(torch.bfloat16), vw[li:li + 1].to(torch.bfloat16)
            pool, scales, lk = pool[li:li + 1], scales[li:li + 1], 0
        return qa.fused_q_decode_attention(q, pool, scales, kw, vw, nc, win_len,
                                           lk, self.qcodec)

    # -- compaction -------------------------------------------------------
    def needs_compact(self, total: int) -> bool:
        """True when a sequence of ``total`` tokens has a full r+C window."""
        d = total - self.r
        return d >= self.C and d % self.C == 0

    def window_full(self, state, total: int) -> bool:
        """The generator's compaction test: the window holds
        ``total - nc*C`` tokens and is full at r + C."""
        return total - state["nc_host"] * self.C >= self.r + self.C

    def compact(self, state) -> dict:
        """Pack the oldest C window tokens of every layer into the next pool
        slot and shift the windows (uniform batch, in place)."""
        C, nc = self.C, state["nc_host"]
        if nc >= self.max_chunks:
            raise ValueError(f"pool full: {nc} of {self.max_chunks} chunks in use")
        for li in range(self.model.num_layers):
            self._append_chunk(state, li, nc, state["k_win"][li, :, :, :C],
                               state["v_win"][li, :, :, :C])
            for key in ("k_win", "v_win"):
                w = state[key][li]
                w[:, :, :self.wcap - C] = w[:, :, C:].clone()
                w[:, :, self.wcap - C:] = 0
        state["n_chunks"] += 1
        state["nc_host"] = nc + 1
        return state
