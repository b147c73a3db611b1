"""Compressed KV cache: port of the served subset of
``mustafar_tpu/cache/compressed.py`` (uniform batch, per-slot continuous
batching and chunked prefill) for the codecs "bitmap" (the default: a
bitmap plus the packed bf16 non-zeros, ``ops/sparse_format.py``),
"bitmap-q8" (the same bitmap, the non-zeros as int8 codes with per-channel
scales) and the quant codecs "q8", "q8q4" and "q4q4" (pruned chunks
quantized dense, int8 or int4 K and V, ``ops/quant_format.py``).

State (a dict, the JAX package's layouts, updated in place):
  kv_pool   [L, mc, B, Hkv, ROWS, 128] int16 packed chunks, K rows then V
                                             rows (ROWS 256 / 192 / 128 for
                                             q8 / q8q4 / q4q4; 192 for
                                             bitmap and 112 for bitmap-q8
                                             at sparsity 0.7)
  kv_scales [L, mc, B, Hkv, 2, 128]   bf16   per-channel K and V scales
                                             (quant codecs and bitmap-q8)
  k_win / v_win [L, B, Hkv, r+C, 128]        dense residual window
  n_chunks  [L, B] int32                     active chunks (device)
  k_score / v_score [L, B, Hkv, r+C, 128] f32  the output-aware (Opa)
                                             policies' accumulated scores,
                                             a column each window column
  nc_host   int or None                      host copy of n_chunks while the
                                             batch is uniform, so a uniform
                                             decode step never reads the
                                             device to size itself; None
                                             once slots hold their own
                                             counts (``insert_slot``)
Semantics:
  * prefill: attention over the dense prompt; then the first
    ``((T - r) // C) * C`` tokens are pruned (exact top-|x| per token) and
    packed chunk by chunk, and the rest becomes the dense window.  The
    quant codecs prune, quantize and pack in one kernel on the card
    (``ops/kernels/pack_kernel.py``), K and V of all a layer's prompt
    chunks in one launch, writing into the pool slots; the bitmap codecs
    pack with eager torch ops (``sparse_format``), all the chunks in one
    pass.
  * chunked prefill (``segment_attend``): one C-token segment attends the
    packed pools (the segment kernel), the window and itself, merged; the
    window's oldest C tokens are packed as soon as the segment's tokens
    leave it more than r + C, and the window is rebuilt.
  * decode: the new token goes into the window; attention covers the pool
    chunks and the window in one online softmax (the codec's kernels on
    the card, their plain versions on the CPU).  ``pos`` is a host int for a
    uniform batch, or a [B] device tensor with per-slot positions
    (continuous batching; an idle slot has pos -1 and is neither written
    nor attended).
  * compaction is a separate call between decode steps: when a window
    holds r + C tokens the oldest C are pruned and packed into the pool and
    the window shifts (``compact`` for a uniform batch, ``compact_slots``
    for chosen slots), which packs every layer's chunk at once (the quant
    codecs in one launch).
  * the output-aware (Opa) policies KT_OPA_VT_MAG and KT_MAG_VT_OPA: the
    packed prefix keeps the top entries by the prefill scores of the
    masked cache (``prefill_k_opa_score``, ``prefill_v_opa_score``); each
    decode step, uniform or per slot, adds its scores to each slot's live
    window columns (K: |mean_g |q| * k|; V: |p * v|, p the window
    probabilities that the decode kernel returns, ``return_win_probs``);
    compaction (``compact``, ``compact_slots``) packs the oldest C tokens by
    their scores and shifts the scores with the window.  Chunked prefill
    scores as it streams (``segment_attend``, the JAX package's rule): a
    segment adds, to the window's columns and to its own, what its valid
    queries give each key (K: the sum of |mean_g |q|| over the queries
    that see the key, times |k|; V: the sum over those queries and the
    group of the post-softmax p, rebuilt from the merged (m, l) of the
    pool, window and self partials, times |v|), before the window's oldest
    C tokens are packed by those scores.
  * a sliding window (Mistral, ``ModelConfig.sliding_window``, at least the
    window's capacity r + C): prefill attends through
    ``prefill_attention``'s banded path, and every decode and segment kernel
    takes ``window``, so a token at position p attends only pool columns
    past p - window (the window's own columns are all inside it at decode).
    The per-slot decode passes it to kernels 2 and 7 (each slot's edge at
    its own counts); chunked prefill (``segment_attend``) to kernels 3 and 8
    (each segment row's edge at its own position) and masks the window and
    self partials, and the streamed Opa scores, as the JAX package does;
    ``compact_slots`` packs the same chunks with or without a window.
"""

from __future__ import annotations

import math

import torch

from mustafar_tpu_torch.cache.dense import prefill_k_opa_score, prefill_v_opa_score
from mustafar_tpu_torch.config import EngineConfig
from mustafar_tpu_torch.device import resolve_device
from mustafar_tpu_torch.ops import quant_format as qf
from mustafar_tpu_torch.ops import sparse_format as sf
from mustafar_tpu_torch.ops.attention import (attention_partials, merge_partials,
                                              prefill_attention)
from mustafar_tpu_torch.ops.kernels import quant_attention as qa
from mustafar_tpu_torch.ops.kernels import sparse_attention as ska
from mustafar_tpu_torch.ops.kernels.pack_kernel import prune_quant_pack_kv


class CompressedKVCache:
    def __init__(self, engine: EngineConfig, device=None):
        self.device = resolve_device(device)
        self.engine = engine
        self.model = m = engine.model
        p = engine.prune
        self.p = p
        if p.method.k_policy not in ("token_mag", "token_opa") or \
                p.method.v_policy not in ("token_mag", "token_opa"):
            raise ValueError(f"the compressed cache packs per-token policies, got "
                             f"{p.method}: use the masked cache")
        self.k_opa = p.method.k_policy == "token_opa"
        self.v_opa = p.method.v_policy == "token_opa"
        self.score_keys = (("k_score",) if self.k_opa else ()) + \
            (("v_score",) if self.v_opa else ())
        assert m.head_dim == 128, (
            f"the compressed format packs 128-wide rows; head_dim must be 128 "
            f"(got {m.head_dim})")
        C = engine.chunk_size
        self.C = C
        self.r = p.residual_length
        self.wcap = self.r + C
        self.window = m.sliding_window
        if self.window is not None:
            assert self.window >= self.wcap, (
                f"sliding window ({self.window}) must cover the dense residual "
                f"window capacity ({self.wcap})")
        self.max_chunks = max(1, (engine.max_seq_len - self.r) // C)
        self.k_keep = p.kept_per_row(m.head_dim, p.k_sparsity)
        self.v_keep = p.kept_per_row(m.head_dim, p.v_sparsity)
        if engine.codec in qf.CODECS:
            self.qcodec = qf.QuantCodec(C, m.head_dim, *qf.CODECS[engine.codec])
            self.kfmt = self.vfmt = None
            self.rows = self.qcodec.stream_rows
            self.pool_keys = ("kv_pool", "kv_scales")
        else:
            # bitmap streams: bf16 values, or int8 codes with scales (bitmap-q8)
            self.qcodec = None
            qbits = 8 if engine.codec == "bitmap-q8" else 16
            self.kfmt = sf.ChunkFormat(C, m.head_dim, self.k_keep, qbits=qbits)
            self.vfmt = sf.ChunkFormat(C, m.head_dim, self.v_keep, qbits=qbits)
            self.rows = self.kfmt.stream_rows + self.vfmt.stream_rows
            self.pool_keys = ("kv_pool", "kv_scales") if qbits == 8 else ("kv_pool",)

    # -- state ------------------------------------------------------------
    def init(self, batch: int, dtype=torch.bfloat16) -> dict:
        m, mc, dev = self.model, self.max_chunks, self.device
        L, H, D = m.num_layers, m.num_kv_heads, m.head_dim
        state = {
            "k_win": torch.zeros((L, batch, H, self.wcap, D), dtype=dtype, device=dev),
            "v_win": torch.zeros((L, batch, H, self.wcap, D), dtype=dtype, device=dev),
            "n_chunks": torch.zeros((L, batch), dtype=torch.int32, device=dev),
            "kv_pool": torch.zeros((L, mc, batch, H, self.rows, 128),
                                   dtype=torch.int16, device=dev),
            "nc_host": 0,
        }
        if "kv_scales" in self.pool_keys:
            state["kv_scales"] = torch.zeros((L, mc, batch, H, 2, D),
                                             dtype=torch.bfloat16, device=dev)
        for key in self.score_keys:
            state[key] = torch.zeros((L, batch, H, self.wcap, D), dtype=torch.float32,
                                     device=dev)
        return state

    # -- packing ----------------------------------------------------------
    def _pack_chunk_bitmap(self, dense: torch.Tensor, fmt: sf.ChunkFormat, score=None):
        """dense [.., C, D] -> (fused-stream rows [.., stream_rows, 128],
        scales [.., D] bf16 or None): top-|x| keep per token, then the
        bitmap and the packed values; at ``qbits=8`` the survivors are
        quantized first (codes from the f32 scales, stored as bf16).  With
        ``score`` (dense's shape, f32) the keep ranks by score.  Every
        step works token row by token row (the scales head-chunk by
        head-chunk), so any leading axes take one pass."""
        x = dense.to(torch.bfloat16)
        if fmt.qbits == 16:
            return sf.prune_and_encode_stream(x, fmt, score), None
        rows, scales = sf.prune_and_encode_stream_q8(x, fmt, score)
        return rows, scales.to(torch.bfloat16)

    def _pack(self, k_chunk, v_chunk, k_score=None, v_score=None) -> dict:
        """Dense K and V chunks [.., C, D] (one to three leading axes: chunk
        or layer, batch, kv head) -> their pool entries: {"kv_pool": rows
        [.., ROWS, 128]} (K rows, then V rows) and, for the quant codecs and
        bitmap-q8, "kv_scales" [.., 2, D].  ``k_score`` / ``v_score`` (the
        chunks' shape, f32): the Opa ranking in place of |x|."""
        if self.qcodec is None:
            (k_rows, k_sc), (v_rows, v_sc) = (
                self._pack_chunk_bitmap(k_chunk, self.kfmt, k_score),
                self._pack_chunk_bitmap(v_chunk, self.vfmt, v_score))
            entry = {"kv_pool": torch.cat([k_rows, v_rows], dim=-2)}
            if k_sc is not None:
                entry["kv_scales"] = torch.stack([k_sc, v_sc], dim=-2)
            return entry
        lead = tuple(k_chunk.shape[:-2])
        entry = {"kv_pool": torch.empty((*lead, self.rows, 128), dtype=torch.int16,
                                        device=k_chunk.device),
                 "kv_scales": torch.empty((*lead, 2, 128), dtype=torch.bfloat16,
                                          device=k_chunk.device)}
        self._pack_q_into(entry["kv_pool"], entry["kv_scales"], k_chunk, v_chunk,
                          k_score, v_score)
        return entry

    def _pack_q_into(self, rows, scales, k_chunk, v_chunk, k_score=None, v_score=None):
        """Quant codecs: prune (top-|x| keep per token), quantize and pack
        dense K and V chunks [.., C, D] straight into ``rows`` [.., ROWS,
        128] (K rows, then V rows) and ``scales`` [.., 2, D], through
        ``prune_quant_pack_kv``: one launch of kernel 9 on the card for every
        head-chunk of both, reading the chunks through their strides (a bf16
        window or prompt slice is not copied; an f32 one is cast to bf16
        first), no copy out.  A score ranks its operand (the kernel takes
        it contiguous: a strided one is copied)."""
        qc = self.qcodec
        KR = qc.k_rows
        prune_quant_pack_kv(k_chunk.to(torch.bfloat16), v_chunk.to(torch.bfloat16),
                            self.k_keep, self.v_keep, qc.kbits, qc.vbits,
                            k_out=(rows[..., :KR, :], scales[..., 0, :]),
                            v_out=(rows[..., KR:, :], scales[..., 1, :]),
                            k_score=_contig(k_score), v_score=_contig(v_score))

    def _append(self, state, at, k_chunk, v_chunk, k_score=None, v_score=None):
        """Prune and pack dense K and V chunks [.., C, D] into the pool slots
        ``state[key][at]`` (``at`` a basic index: a layer's slot in a
        segment, a layer's first slots in prefill, every layer's slot in a
        compaction): the quant codecs straight into the slots, in one
        launch; the bitmap codecs in one pass of eager ops, then a copy."""
        if self.qcodec is not None:
            self._pack_q_into(state["kv_pool"][at], state["kv_scales"][at], k_chunk, v_chunk,
                              k_score, v_score)
            return
        for key, val in self._pack(k_chunk, v_chunk, k_score, v_score).items():
            state[key][at] = val

    # -- prefill ----------------------------------------------------------
    def prefill_attend(self, state, li: int, q, k, v, true_len: int):
        """q [B,T,Hq,D], k/v [B,T,Hkv,D] (roped) -> out [B,T,Hq,D]; fills
        layer li's pool and window."""
        T = q.shape[1]
        out = prefill_attention(q, k, v, true_len, self.window)
        C = self.C
        comp_len = max(true_len - self.r, 0) // C * C
        n_pre = comp_len // C
        kh = k.transpose(1, 2)                                  # [B, Hkv, T, D]
        vh = v.transpose(1, 2)
        if n_pre:
            # the prompt's chunks as views [n_pre, B, Hkv, C, D], and the Opa
            # scores of the packed prefix, the masked cache's prefill scores
            ks = (prefill_k_opa_score(q, k, true_len).transpose(1, 2)
                  if self.k_opa else None)
            vs = (prefill_v_opa_score(q, k, v, true_len, self.p.group_size,
                                      self.window).transpose(1, 2)
                  if self.v_opa else None)
            kc, vc, ksc, vsc = (
                None if x is None else
                x[:, :, :comp_len].unflatten(2, (n_pre, C)).movedim(2, 0)
                for x in (kh, vh, ks, vs))
            self._append(state, (li, slice(0, n_pre)), kc, vc, ksc, vsc)
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
    def _views(self, state, li: int):
        """Layer li's kernel views (pool, scales or None, k_win, v_win, layer
        index): the stacked state flattened to B*Hkv heads; a float32 state
        (CPU parity runs) casts this layer's windows to bf16, as the JAX
        package casts its window for the kernel."""
        L, mc, B, H = state["kv_pool"].shape[:4]
        D = self.model.head_dim
        pool = state["kv_pool"].view(L, mc, B * H, *state["kv_pool"].shape[4:])
        scales = (state["kv_scales"].view(L, mc, B * H, 2, D)
                  if "kv_scales" in state else None)
        kw = state["k_win"].view(L, B * H, self.wcap, D)
        vw = state["v_win"].view(L, B * H, self.wcap, D)
        if kw.dtype != torch.bfloat16:
            return (pool[li:li + 1], None if scales is None else scales[li:li + 1],
                    kw[li:li + 1].to(torch.bfloat16), vw[li:li + 1].to(torch.bfloat16), 0)
        return pool, scales, kw, vw, li

    def decode_attend(self, state, li: int, q, k, v, pos):
        """q [B,1,Hq,D], k/v [B,1,Hkv,D]; appends the token to layer li's
        window and attends pools + window.  ``pos`` is the host index of the
        token (uniform batch) or a [B] device tensor of per-slot indices.
        Compaction is not done here (see ``compact``, ``compact_slots``)."""
        if torch.is_tensor(pos):
            return self._decode_attend_per_slot(state, li, q, k, v, pos)
        nc = state["nc_host"]
        if nc is None:
            raise ValueError("the slots of this cache hold their own counts: "
                             "decode it with per-slot positions")
        win_len = pos + 1 - nc * self.C
        if not 1 <= win_len <= self.wcap:
            raise ValueError(
                f"token {pos} leaves a window of {win_len} beside {nc} chunks "
                f"(capacity {self.wcap}): compact() was not called when due")
        state["k_win"][li, :, :, win_len - 1] = k[:, 0]
        state["v_win"][li, :, :, win_len - 1] = v[:, 0]
        pool, scales, kw, vw, lk = self._views(state, li)
        if self.qcodec is None:
            out = ska.fused_sparse_decode_attention(q, pool, kw, vw, nc, win_len, lk,
                                                    self.kfmt, self.vfmt,
                                                    kv_scales=scales, window=self.window,
                                                    return_win_probs=self.v_opa)
        else:
            out = qa.fused_q_decode_attention(q, pool, scales, kw, vw, nc, win_len,
                                              lk, self.qcodec, window=self.window,
                                              return_win_probs=self.v_opa)
        return self._with_scores(state, li, q, out, win_len)

    def _with_scores(self, state, li: int, q, out, win_len):
        """The decode kernel's result ``out`` (with the window probabilities
        when V is scored) -> its output, after this step's Opa scores are
        added (``_accumulate_scores``) at each slot's live window columns
        [0, win_len) (a host int, or a [B] tensor: an idle slot's 0), those
        inside the sliding window (all of them, as the window covers the
        capacity)."""
        if not self.score_keys:
            return out
        p_win = None
        if self.v_opa:
            out, p_win = out
        cols = torch.arange(self.wcap, device=q.device)[None, :]
        wl = win_len[:, None] if torch.is_tensor(win_len) else win_len
        live = cols < wl
        if self.window is not None:
            live &= cols > wl - 1 - self.window
        self._accumulate_scores(state, li, q, live[:, None, :, None], p_win)
        return out

    def _accumulate_scores(self, state, li: int, q, live, p_win):
        """Add this step's Opa scores at layer li's live window columns
        (``live`` [B or 1, 1, W, 1] bool): K |mean_g |q| * k| per element, V
        |p * v| with p the kernel's window probabilities [B, Hkv, W]."""
        B, _, Hq, D = q.shape
        Hkv = self.model.num_kv_heads
        if self.k_opa:
            qm = q[:, 0].to(torch.float32).abs().reshape(B, Hkv, Hq // Hkv, D).mean(dim=2)
            step = (qm[:, :, None, :] * state["k_win"][li].to(torch.float32)).abs()
            state["k_score"][li] += torch.where(live, step, 0.0)
        if self.v_opa:
            step = (p_win[..., None] * state["v_win"][li].to(torch.float32)).abs()
            state["v_score"][li] += torch.where(live, step, 0.0)

    def _decode_attend_per_slot(self, state, li: int, q, k, v, pos):
        """Per-slot decode (``_decode_attend_per_slot`` of the JAX package):
        slot b's token lands at window column pos[b] - n_chunks[b]*C and the
        per-slot kernel attends its own counts, all read on the device.  An
        idle slot (pos -1) is written nowhere and passed to the kernel as
        (0 chunks, 0 window tokens): after a retire its n_chunks still holds
        the old request's count, and the window index it would give may lie
        far out of range."""
        B = q.shape[0]
        nc = state["n_chunks"][li]
        active = pos >= 0
        win_len = torch.where(active, pos + 1 - nc * self.C, 0).to(torch.int32)
        nc = torch.where(active, nc, 0).to(torch.int32)
        # the clamp (and the kernel's clamp of win_len into [0, W]) can only
        # bite when a compaction was missed; the schedulers compact on time
        col = (win_len - 1).clamp(0, self.wcap - 1).long()
        bidx = torch.arange(B, device=q.device)
        live = active[:, None, None]
        for key, tok in (("k_win", k), ("v_win", v)):
            win = state[key][li]                               # [B, Hkv, W, D]
            win[bidx, :, col] = torch.where(live, tok[:, 0].to(win.dtype),
                                            win[bidx, :, col])
        pool, scales, kw, vw, lk = self._views(state, li)
        if self.qcodec is None:
            out = ska.fused_sparse_decode_attention_ps(q, pool, kw, vw, nc, win_len, lk,
                                                       self.kfmt, self.vfmt,
                                                       kv_scales=scales, window=self.window,
                                                       return_win_probs=self.v_opa)
        else:
            out = qa.fused_q_decode_attention_ps(q, pool, scales, kw, vw, nc, win_len,
                                                 lk, self.qcodec, window=self.window,
                                                 return_win_probs=self.v_opa)
        return self._with_scores(state, li, q, out, win_len)

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
        if nc is None:
            raise ValueError("the slots of this cache hold their own counts: "
                             "compact it with compact_slots")
        if nc >= self.max_chunks:
            raise ValueError(f"pool full: {nc} of {self.max_chunks} chunks in use")
        self._append(state, (slice(None), nc), state["k_win"][..., :C, :],
                     state["v_win"][..., :C, :],
                     *(state[key][..., :C, :] if key in state else None
                       for key in ("k_score", "v_score")))
        for key in ("k_win", "v_win") + self.score_keys:
            w = state[key]
            w[..., :self.wcap - C, :] = w[..., C:, :].clone()
            w[..., self.wcap - C:, :] = 0
        state["n_chunks"] += 1
        state["nc_host"] = nc + 1
        return state

    def compact_slots(self, state, do) -> dict:
        """Pack the oldest C window tokens of every layer into the next pool
        slot, for the slots b with ``do[b]`` (a host sequence of bools; the
        scheduler knows on the host which windows just filled), and shift
        their windows (in place).  The chunk index is slot b's n_chunks,
        read on the device as the JAX package reads it (layer 0's, the
        layers move in lockstep).  Under Opa the chunk keeps the top entries
        by the slots' scores, which shift with their windows."""
        sel = [b for b, flag in enumerate(do) if flag]
        if not sel:
            return state
        C = self.C
        b_sel = torch.tensor(sel, device=state["n_chunks"].device)
        ci = state["n_chunks"][0, b_sel].long()
        # one host read per compaction (every C steps of a slot), as compact()
        # refuses a full pool rather than overwrite its last chunk
        used = int(ci.max())
        if used >= self.max_chunks:
            raise ValueError(f"pool full: {used} of {self.max_chunks} chunks in use")
        packed = self._pack(*(state[key][:, b_sel, :, :C] if key in state else None
                              for key in ("k_win", "v_win", "k_score", "v_score")))
        for key, val in packed.items():                  # every layer at once
            state[key][:, ci, b_sel] = val
        for key in ("k_win", "v_win") + self.score_keys:
            win = state[key]
            win[:, b_sel] = torch.cat([win[:, b_sel, :, C:],
                                       torch.zeros_like(win[:, b_sel, :, :C])], dim=3)
        state["n_chunks"][:, b_sel] += 1
        return state

    def insert_slot(self, state, sub, slot: int) -> dict:
        """Copy the batch-1 cache ``sub`` (one request's prefill) into batch
        slot ``slot`` of ``state``, in place: its whole pool (and scales),
        windows and counts.  The slots then hold their own counts, so
        ``nc_host`` becomes None."""
        for key in self.pool_keys:
            state[key][:, :, slot] = sub[key][:, :, 0]
        for key in ("k_win", "v_win") + self.score_keys:
            state[key][:, slot] = sub[key][:, 0].to(state[key].dtype)
        state["n_chunks"][:, slot] = sub["n_chunks"][:, 0]
        state["nc_host"] = None
        return state

    # -- chunked prefill --------------------------------------------------
    def _segment_counts(self, nc: int, seg_start: int, true_len: int):
        """(window length on entry, segment's valid rows, chunks after) of a
        segment at ``seg_start`` over ``nc`` packed chunks (host ints)."""
        seg_valid = min(max(true_len - seg_start, 0), self.C)
        nc_after = max(seg_start + seg_valid - self.r, 0) // self.C
        return seg_start - nc * self.C, seg_valid, nc_after

    def segment_attend(self, state, li: int, q, k, v, seg_start: int,
                       true_len: int):
        """Chunked-prefill step of layer ``li``: the segment q/k/v
        [B, C, H*, D] (roped) attends the packed pools (the segment kernel),
        the window and itself (causal), merged -> out [B, C, Hq, D]; then it
        is absorbed into layer li's state.

        Invariants with seg_start = s*C: on entry n_chunks = max(0, s-1) (the
        host ``nc_host``, uniform across the batch) and the window holds
        tokens [n_chunks*C, seg_start) (0 or C of them); on exit they take
        the same form for s+1, and the last segment leaves the window
        [comp_len, true_len) exactly as monolithic prefill.  Under Opa the
        score buffers stream too (``_segment_scores``) and shift with the
        window; the chunk packed here ranks by the scores after this
        segment's are added.

        Where the JAX package stages the pack of the window's first C tokens
        and applies it to every layer after the layer scan
        (``finalize_segment``), the port writes it in place right away, into
        pool slot n_chunks of layer li: a layer reads only its own pools and
        only chunks below n_chunks, so nothing reads the slot before the
        segment ends.  ``finalize_segment`` then moves the host count.

        With a sliding window the segment row at position qpos sees the pool
        columns (the kernels' ``window``), the window columns and its own
        segment's columns past qpos - window.  The window mask cuts real
        columns where the window is narrower than C plus the window's length
        (a test window of 288-320; never at Mistral's 4,096); the self mask,
        as the window covers r + C > C, cuts none."""
        B, T, Hq, D = q.shape
        C, W = self.C, self.wcap
        if T != C:
            raise ValueError(f"a segment has {C} tokens, got {T}")
        nc = state["nc_host"]
        if nc is None:
            raise ValueError("chunked prefill needs a uniform batch cache")
        wl, seg_valid, nc_after = self._segment_counts(nc, seg_start, true_len)
        kwin = state["k_win"][li]                               # [B, Hkv, W, D]
        vwin = state["v_win"][li]
        pool, scales, _, _, lk = self._views(state, li)
        if self.qcodec is None:
            p_pool = ska.fused_sparse_segment_attention(q, pool, nc, seg_start, lk,
                                                        self.kfmt, self.vfmt,
                                                        kv_scales=scales, window=self.window)
        else:
            p_pool = qa.fused_q_segment_attention(q, pool, scales, nc, seg_start, lk,
                                                  self.qcodec, window=self.window)
        dev = q.device
        cols, rows = torch.arange(W, device=dev), torch.arange(T, device=dev)
        wmask = (cols < wl)[None, :].expand(T, W)
        smask = torch.ones((T, T), dtype=torch.bool, device=dev).tril()
        if self.window is not None:
            # window column c holds position nc*C + c, segment row t sits at
            # seg_start + t
            low = (seg_start + rows)[:, None] - self.window
            wmask = wmask & ((nc * C + cols)[None, :] > low)
            smask = smask & (rows[None, :] > rows[:, None] - self.window)
        p_win = attention_partials(q, kwin.transpose(1, 2), vwin.transpose(1, 2),
                                   wmask)
        p_self = attention_partials(q, k, v, smask)
        out = merge_partials([p_pool, p_win, p_self]).to(q.dtype)

        seg_rows = (torch.arange(C, device=dev) < seg_valid)[None, None, :, None]
        # the Opa scores: the window's columns (zero past wl) and the segment's
        sc = (self._segment_scores(state, li, q, k, v, (p_pool, p_win, p_self), wmask,
                                   smask, wl, seg_valid, seg_rows)
              if self.score_keys else {})
        if nc_after > nc:
            self._append(state, (li, nc), kwin[:, :, :C], vwin[:, :, :C],
                         *(sc[key][0][:, :, :C] if key in sc else None
                           for key in ("k_score", "v_score")))
        shift = C if nc_after > nc else 0
        rebuilt = [(kwin, kwin[:, :, :wl], k.transpose(1, 2)),
                   (vwin, vwin[:, :, :wl], v.transpose(1, 2))]
        rebuilt += [(state[key][li], *sc[key]) for key in self.score_keys]
        for buf, old, seg in rebuilt:
            # [old columns ++ segment] shifted by the pack, C + W rows so the
            # slice [shift, shift + W) never runs off the end
            tmp = torch.zeros((B, buf.shape[1], C + W, D), dtype=buf.dtype, device=dev)
            tmp[:, :, :wl] = old[:, :, :wl]
            tmp[:, :, wl:wl + C] = torch.where(seg_rows, seg, 0).to(buf.dtype)
            buf.copy_(tmp[:, :, shift:shift + W])
        state["n_chunks"][li] = nc_after
        return out

    def _segment_scores(self, state, li: int, q, k, v, partials, wmask, smask,
                        wl: int, seg_valid: int, seg_rows):
        """A segment's streaming Opa scores (the JAX package's rule,
        ``segment_attend`` there): {key: (window columns [B, Hkv, W, D], the
        segment's own [B, Hkv, C, D])} f32, the window's the buffer on entry
        plus this segment's, zero at and past ``wl``, the segment's zero at
        its pad rows.  Only the ``seg_valid`` valid queries count, each for
        the keys it sees (``wmask`` [T, W] the window's, ``smask`` [T, T]
        the causal self mask).  K: the sum over those queries of
        |mean_g |q||, times |k|.  V: p = exp(s - M) / L, M and L the merged
        stats of the pool, window and self partials (``partials``, the
        (acc, m, l) triples that ``merge_partials`` merged for the output,
        m and l [B, T, Hq, 1] with the query heads kv head by kv head; the
        segment kernels give theirs in ``attention_partials``' layout),
        summed over the group's heads and the queries, times |v|.  f32
        products of the operands as given (bf16 windows and segments on the
        card, as the JAX package's bf16 x bf16 -> f32 dots)."""
        B, T, Hq, D = q.shape
        Hkv = self.model.num_kv_heads
        G = Hq // Hkv
        f32 = torch.float32
        dev = q.device
        qvalid = torch.arange(T, device=dev) < seg_valid
        wmask_q = wmask & qvalid[:, None]                       # [T, W]
        smask_q = smask & qvalid[:, None] & qvalid[None, :]     # [T, T]
        # the window's and the segment's K and V [B, Hkv, W or C, D], the
        # operands each key's score multiplies
        kx = (state["k_win"][li], k.transpose(1, 2))
        operand = {"k_score": kx, "v_score": (state["v_win"][li], v.transpose(1, 2))}
        contrib = {}
        if self.k_opa:
            qa_ = q.to(f32).abs().reshape(B, T, Hkv, G, D).mean(dim=3)      # [B,T,Hkv,D]
            contrib["k_score"] = tuple(torch.einsum("bthd,ts->bhsd", qa_, mask.to(f32))
                                       for mask in (wmask_q, smask_q))
        if self.v_opa:
            (_, m0, l0), (_, m1, l1), (_, m2, l2) = partials
            M = torch.maximum(torch.maximum(m0, m1), m2)
            L = l0 * torch.exp(m0 - M) + l1 * torch.exp(m1 - M) + l2 * torch.exp(m2 - M)
            Mg = M.reshape(B, T, Hkv, G, 1)
            Lg = torch.clamp_min(L.reshape(B, T, Hkv, G, 1), 1e-30)
            qg = q.to(f32).reshape(B, T, Hkv, G, D)
            scale = 1.0 / math.sqrt(D)

            def probs(kx, mask):                                # kx [B, Hkv, S, D]
                s = torch.einsum("bthgd,bhsd->bthgs", qg, kx.to(f32)) * scale
                p = torch.where(mask[None, :, None, None, :], torch.exp(s - Mg) / Lg, 0.0)
                return p.sum(dim=3).sum(dim=1)[..., None]       # [B, Hkv, S, 1]
            contrib["v_score"] = (probs(kx[0], wmask_q), probs(kx[1], smask_q))
        win_cols = (torch.arange(self.wcap, device=dev) < wl)[None, None, :, None]
        sc = {}
        for key in self.score_keys:
            (cw, cs), (xw, xs) = contrib[key], operand[key]
            sc[key] = (torch.where(win_cols, state[key][li] + cw * xw.to(f32).abs(), 0.0),
                       torch.where(seg_rows, cs * xs.to(f32).abs(), 0.0))
        return sc

    def finalize_segment(self, state, seg_start: int, true_len: int) -> dict:
        """After every layer's ``segment_attend``: the host count follows
        the chunk the layers packed (if any)."""
        state["nc_host"] = self._segment_counts(state["nc_host"], seg_start,
                                                true_len)[2]
        return state


def _contig(t):
    return None if t is None else t.contiguous()
