"""Fused bitmap-codec attention kernels: the CUDA kernels, their plain
PyTorch versions and the wrappers that pick between them by device.

Ports of ``mustafar_tpu/ops/kernels/sparse_attention.py`` for the codecs
"bitmap" (bf16 values, ``ops/sparse_format.ChunkFormat`` at ``qbits=16``)
and "bitmap-q8" (int8 codes with per-channel scales, ``qbits=8``), with the
options the output-aware (Opa) policies read, as the quant kernels take
them (``quant_attention``): the decode kernels' window probabilities
(``return_win_probs``) and the uniform decode's final (m, l)
(``return_norm``), and the sliding window (``window``) of every kernel, the
quant kernels' rule (``quant_attention`` module note):
  fused_sparse_decode_attention     uniform-batch decode  csrc/sp_decode.cu
                                    (TPU kernel v7)       (entry sp_decode: one
                                                          CTA a split, the
                                                          merge fused)
  fused_sparse_decode_attention_ps  per-slot decode       csrc/sp_decode.cu
                                    (TPU kernel v6ps)     (entry sp_decode_ps)
  fused_sparse_segment_attention    chunked-prefill       csrc/sp_segment.cu
                                    partials over the pools (thread block
                                    clusters that share each chunk's
                                    expansion: ``segment_grid``)
Each chunk's K and V are expanded from the bitmap word planes and the
interleaved value segments (``csrc/bitmap_expand.cuh``), then attended as
dense tiles.  At ``qbits=16`` no scale applies: scores are bf16(q) . K /
sqrt(128) in f32, p is rounded to bf16 for the value product.  At
``qbits=8`` the tiles hold the int8 codes and the chunk's scales fold in as
the quant codecs fold theirs: scores bf16(bf16(q) * kscale) . codes /
sqrt(128), the V scale times the value product.  The softmax steps are
those of the quant kernels (one per chunk, then window tiles of
``quant_attention.window_tile``); the plain versions below take them with
``quant_attention.decode_steps`` / ``segment_steps`` over chunks expanded by
``sparse_format.decode_stream``.  The per-slot kernel splits each slot's
work (one chunk, or one window tile, a split) and merges the splits'
partials; ``fused_sparse_decode_attention_ps_split_plain`` is its
arithmetic, ``fused_sparse_decode_attention_ps_plain`` the TPU's.  The
uniform kernel splits likewise, each chunk into ``CHUNK_CUT`` runs of 64
tokens: ``fused_sparse_decode_attention_split_plain`` is its arithmetic,
``fused_sparse_decode_attention_plain`` the TPU's.  With a sliding window
its grid leaves out the runs of 64 tokens wholly at or below the window's
lower edge, so the edge falls inside at most one run a row; the per-slot
kernel's chunk splits below a slot's edge exit unread, and the segment
kernel's clusters leave out the chunks dead for their oldest row.

Layouts are the JAX package's stacked ones, indexed at layer ``li``:
  q           [B, 1, Hq, 128]              bf16 or f32 (read as bf16)
  q_seg       [B, Tseg, Hq, 128]           bf16 or f32 (read as bf16)
  kv_pool     [L, mc, B*Hkv, KR + VR, 128] int16  (K stream, then V stream;
                                           KR = kfmt.stream_rows, 96 at
                                           keep 40, 56 at qbits=8)
  kv_scales   [L, mc, B*Hkv, 2, 128]       bf16   (K scale, V scale;
                                           qbits=8 only, else None)
  k_win/v_win [L, B*Hkv, W, 128]           bf16
"""

from __future__ import annotations

import torch

from mustafar_tpu_torch.ops import sparse_format as sf
from mustafar_tpu_torch.ops.kernels import quant_attention as qa


def _check_formats(kfmt, vfmt, kv_scales, name):
    for fmt in (kfmt, vfmt):
        if not isinstance(fmt, sf.ChunkFormat) or (fmt.chunk, fmt.dim) != (256, 128):
            raise NotImplementedError(
                f"{name} serves bitmap chunks of 256 tokens x 128 channels, got {fmt!r}")
    if kfmt.qbits != vfmt.qbits:
        raise ValueError(f"K and V streams of {kfmt.qbits} and {vfmt.qbits} bits")
    if (kfmt.qbits == 8) != (kv_scales is not None):
        raise ValueError("kv_scales go with qbits=8 chunks (bitmap-q8) and only "
                         f"with them; got qbits={kfmt.qbits} and "
                         f"kv_scales={'None' if kv_scales is None else 'a tensor'}")


def _check_pool(kv_pool, kv_scales, kfmt, vfmt, B):
    """Return (L, mc, BH, Hkv) of the stacked pool."""
    rows = kfmt.stream_rows + vfmt.stream_rows
    if kv_pool.dim() != 5 or tuple(kv_pool.shape[3:]) != (rows, 128):
        raise ValueError(f"kv_pool must be [L, mc, BH, {rows}, 128], "
                         f"got {tuple(kv_pool.shape)}")
    L, mc, BH = kv_pool.shape[:3]
    if kv_scales is not None and tuple(kv_scales.shape) != (L, mc, BH, 2, 128):
        raise ValueError(f"kv_scales must be {(L, mc, BH, 2, 128)}, "
                         f"got {tuple(kv_scales.shape)}")
    if B < 1 or BH % B:
        raise ValueError(f"pool heads {BH} are not a multiple of batch {B}")
    return L, mc, BH, BH // B


def _scales(kv_scales):
    """The scales as a (name, tensor) pair for the checks, if given."""
    return () if kv_scales is None else (("kv_scales", kv_scales),)


_ptr = qa._ptr


def _check_decode(q, kv_pool, kv_scales, k_win, v_win, li, kfmt, vfmt, name):
    """Shapes, types and devices both decode kernels share; returns
    (BH, G, mc, W)."""
    _check_formats(kfmt, vfmt, kv_scales, name)
    if q.dim() != 4 or q.shape[1] != 1 or q.shape[3] != 128:
        raise ValueError(f"q must be [B, 1, Hq, 128], got {tuple(q.shape)}")
    B, _, Hq, _ = q.shape
    L, mc, BH, Hkv = _check_pool(kv_pool, kv_scales, kfmt, vfmt, B)
    if k_win.dim() != 4 or tuple(k_win.shape[:2]) != (L, BH) or k_win.shape[3] != 128:
        raise ValueError(f"k_win must be [{L}, {BH}, W, 128], got {tuple(k_win.shape)}")
    if v_win.shape != k_win.shape:
        raise ValueError(f"v_win {tuple(v_win.shape)} != k_win {tuple(k_win.shape)}")
    if Hq % Hkv or Hq // Hkv not in qa._GROUPS:
        raise ValueError(f"{Hq} query heads over {Hkv} kv heads: the kernel "
                         f"takes groups of {qa._GROUPS}")
    qa._check_tensors(q, (("q", q, q.dtype), ("kv_pool", kv_pool, torch.int16),
                          *((n, t, torch.bfloat16) for n, t in _scales(kv_scales)),
                          ("k_win", k_win, torch.bfloat16),
                          ("v_win", v_win, torch.bfloat16)))
    qa._check_int("li", li, 0, L - 1)
    return BH, Hq // Hkv, mc, k_win.shape[2]


def _segs(fmt):
    """(k0, k1) segment widths of a format, k1 = 0 for one segment."""
    return (*fmt.segs, 0)[:2]


def _sp_chunk_step(kv_pool, kv_scales, li, kfmt, vfmt, ordered: bool = False):
    """Bitmap chunk step: chunk ci's K and V expanded (``decode_stream``).
    bf16 values: scores bf16(q) . K / sqrt(128), no V scale.  int8 codes
    (``kv_scales`` given): the quant codecs' step on the codes
    (``quant_attention.scaled_chunk_step``).  Scores summed in the uniform
    kernels' order with ``ordered`` (``quant_attention._scores``)."""
    KR = kfmt.stream_rows

    def step(qf32, ci):
        rows = kv_pool[li, ci]                                  # [BH, KR + VR, 128]
        kd = sf.decode_stream(rows[:, :KR], kfmt).to(torch.float32)
        vd = sf.decode_stream(rows[:, KR:], vfmt).to(torch.float32)
        if kv_scales is None:
            return qa._scores(qf32, kd, ordered), vd, None
        sc = kv_scales[li, ci].to(torch.float32)                # [BH, 2, 128]
        return qa.scaled_chunk_step(qf32, kd, vd, sc[:, 0], sc[:, 1], ordered)
    return step


def fused_sparse_decode_attention_plain(q, kv_pool, k_win, v_win, n_chunks: int,
                                        win_len: int, li: int, kfmt, vfmt,
                                        kv_scales=None, win_probs: bool = False,
                                        norm: bool = False, window=None):
    """The uniform bitmap decode TPU kernel's arithmetic in PyTorch."""
    return qa.decode_steps(q, kv_pool.shape[2], n_chunks,
                           _sp_chunk_step(kv_pool, kv_scales, li, kfmt, vfmt), k_win,
                           v_win, win_len, li, win_probs, norm, window)


CHUNK_CUT = 4           # softmax steps the uniform kernel cuts a chunk into


def fused_sparse_decode_attention_split_plain(q, kv_pool, k_win, v_win, n_chunks: int,
                                              win_len: int, li: int, kfmt, vfmt,
                                              kv_scales=None, win_probs: bool = False,
                                              norm: bool = False, window=None):
    """The uniform CUDA kernel's arithmetic (``quant_attention.ps_split_steps``
    with every slot at the call's counts and the bitmap chunk step): each
    chunk's ``CHUNK_CUT`` runs of 64 tokens (past a sliding window's edge)
    and each window tile one split from a fresh softmax state, merged in
    split order, the scores summed in the kernel's order
    (``quant_attention._scores``)."""
    nc, wl = qa.uniform_counts(q.shape[0], n_chunks, win_len, q.device)
    return qa.ps_split_steps(
        q, kv_pool.shape[2], nc, wl, kv_pool.shape[1],
        lambda hs: _sp_chunk_step(kv_pool[:, :, hs], None if kv_scales is None
                                  else kv_scales[:, :, hs], li, kfmt, vfmt, True),
        k_win, v_win, li, cut=CHUNK_CUT, ordered=True, win_probs=win_probs, norm=norm,
        window=window)


def fused_sparse_decode_attention(q, kv_pool, k_win, v_win, n_chunks: int,
                                  win_len: int, li: int, kfmt: sf.ChunkFormat,
                                  vfmt: sf.ChunkFormat, *, kv_scales=None,
                                  window=None, return_norm: bool = False,
                                  return_win_probs: bool = False):
    """Bitmap flash-decode of layer ``li`` over ``n_chunks`` pool chunks and
    the first ``win_len`` window tokens -> [B, 1, Hq, 128] in q's dtype (q
    is read as bf16, the output is computed in f32, as on the TPU); with a
    sliding ``window`` only the pool columns past its edge; with
    ``return_norm`` also the final (m, l), with ``return_win_probs`` the
    window probabilities [B, Hkv, W] f32
    (``quant_attention.fused_q_decode_attention``).  ``kv_scales`` is
    required for ``qbits=8`` formats and refused otherwise.

    CUDA tensors launch the kernel of ``csrc/sp_decode.cu`` (entry
    ``sp_decode``, built at first use; the instance of the formats' value
    width) on the current stream, one CTA a split
    (``quant_attention.uniform_splits`` with ``CHUNK_CUT``), with the
    stream's split scratch and merge counters; with nothing to attend the
    output is 0 (m -1e30, l 0) and nothing launches.  CPU tensors run the
    plain version.  A CUDA request the kernel cannot serve raises; nothing
    falls back."""
    BH, G, mc, W = _check_decode(q, kv_pool, kv_scales, k_win, v_win, li, kfmt, vfmt,
                                 "fused_sparse_decode_attention")
    qa.check_window(window)
    qa._check_int("n_chunks", n_chunks, 0, mc)
    qa._check_int("win_len", win_len, 0, W)
    if q.device.type == "cpu":
        return fused_sparse_decode_attention_plain(q, kv_pool, k_win, v_win, n_chunks,
                                                   win_len, li, kfmt, vfmt, kv_scales,
                                                   return_win_probs, return_norm, window)
    n_splits = sum(qa.uniform_splits(n_chunks, win_len, W, CHUNK_CUT, window))
    probs = qa.win_probs_out(q, BH, W, return_win_probs, n_splits)
    ml = qa.norm_out(q, BH, return_norm, n_splits)
    if n_splits == 0:
        return qa.uniform_result(torch.zeros_like(q), ml, probs, return_norm,
                                 return_win_probs)
    qa.split_scratch_floats(BH, n_splits, G)     # a grid too large: refused up front
    stream = qa._stream(q)
    qa._check_aligned((("q", q), ("kv_pool", kv_pool), ("k_win", k_win),
                       ("v_win", v_win), *_scales(kv_scales)))
    fn = qa._library("sp_decode", "sp_decode", 10, 18)
    out = torch.empty_like(q)
    qb = q.to(torch.bfloat16)
    scratch = qa._split_scratch(BH, n_splits, G, q.device, stream,
                                BH * G * W if return_win_probs else 0)
    counters = qa._split_counters(BH, q.device, stream)
    rc = fn(qb.data_ptr(), kv_pool.data_ptr(), _ptr(kv_scales), k_win.data_ptr(),
            v_win.data_ptr(), out.data_ptr(), _ptr(probs), _ptr(ml), scratch.data_ptr(),
            counters.data_ptr(), scratch.numel(), counters.numel(),
            int(out.dtype == torch.float32), q.device.index or 0, kfmt.qbits, BH, G, mc, W,
            qa.window_tile(W), n_chunks, win_len, li, window or 0, *_segs(kfmt),
            *_segs(vfmt), stream)
    if rc != 0:
        raise RuntimeError(f"sp_decode launch failed: CUDA error {rc}")
    fused_sparse_decode_attention.launches += 1
    return qa.uniform_result(out, ml, probs, return_norm, return_win_probs)


fused_sparse_decode_attention.launches = 0


# ---------------------------------------------------------------------------
# Per-slot decode (continuous batching)
# ---------------------------------------------------------------------------

def fused_sparse_decode_attention_ps_plain(q, kv_pool, k_win, v_win, n_chunks,
                                           win_len, li: int, kfmt, vfmt,
                                           kv_scales=None, win_probs: bool = False,
                                           window=None):
    """The per-slot kernel's arithmetic: slot b is the uniform computation
    over its own clamped counts (``quant_attention.slots``), with a sliding
    ``window``'s edge at those counts.  The TPU
    kernel loops a block of 16 heads to the largest counts among them and
    masks each head's columns; those steps add exactly zero to a head with
    something to attend, so looping over a slot's own counts is the same.
    A slot with nothing to attend comes out 0, and so do its window
    probabilities (``win_probs``)."""
    return qa.per_slot_plain(
        lambda b, hs, nc, wl: fused_sparse_decode_attention_plain(
            q[b:b + 1], kv_pool[:, :, hs], k_win[:, hs], v_win[:, hs], nc, wl, li,
            kfmt, vfmt, None if kv_scales is None else kv_scales[:, :, hs], win_probs,
            window=window),
        q, kv_pool.shape[2], n_chunks, win_len, kv_pool.shape[1], k_win.shape[2],
        win_probs)


ps_splits = qa.ps_splits


def fused_sparse_decode_attention_ps_split_plain(q, kv_pool, k_win, v_win, n_chunks,
                                                 win_len, li: int, kfmt, vfmt,
                                                 kv_scales=None, win_probs: bool = False,
                                                 window=None):
    """The per-slot CUDA kernel's arithmetic (``quant_attention.ps_split_steps``
    with the bitmap chunk step): each chunk (past its slot's window edge)
    and each window tile of a slot one split from a fresh softmax state,
    merged in split order; with ``win_probs`` also the window probabilities
    on the merge's stats."""
    return qa.ps_split_steps(
        q, kv_pool.shape[2], n_chunks, win_len, kv_pool.shape[1],
        lambda hs: _sp_chunk_step(kv_pool[:, :, hs], None if kv_scales is None
                                  else kv_scales[:, :, hs], li, kfmt, vfmt),
        k_win, v_win, li, win_probs=win_probs, window=window)


def fused_sparse_decode_attention_ps(q, kv_pool, k_win, v_win,
                                     n_chunks: torch.Tensor, win_len: torch.Tensor,
                                     li: int, kfmt: sf.ChunkFormat,
                                     vfmt: sf.ChunkFormat, *, kv_scales=None,
                                     window=None, return_win_probs: bool = False):
    """Per-slot bitmap flash-decode of layer ``li``: slot b attends its first
    ``n_chunks[b]`` pool chunks and ``win_len[b]`` window tokens ->
    [B, 1, Hq, 128] in q's dtype.  ``kv_scales`` as for
    ``fused_sparse_decode_attention``.

    ``n_chunks`` and ``win_len`` are int32 tensors [B] on q's device, read
    per slot by the kernel (no host sync) and clamped there to [0, mc] and
    [0, W]; an idle slot is passed as (0, 0) and comes out 0.  With a
    sliding ``window`` slot b attends only the pool columns past its own
    edge (``quant_attention.window_low``).  With ``return_win_probs`` also
    the window probabilities [B, Hkv, W] f32
    (``quant_attention.fused_q_decode_attention_ps``).

    CUDA tensors launch the kernels of ``csrc/sp_decode.cu`` (entry
    ``sp_decode_ps``, built at first use: the split kernel, then its merge,
    then with ``return_win_probs`` the probabilities from the merge's
    stats) on the current stream, with the stream's split scratch
    (``quant_attention._split_scratch``); a split below its slot's window
    edge exits unread.  CPU tensors run the plain version.  A CUDA request
    the kernel cannot serve raises; nothing falls back."""
    BH, G, mc, W = _check_decode(q, kv_pool, kv_scales, k_win, v_win, li, kfmt, vfmt,
                                 "fused_sparse_decode_attention_ps")
    qa.check_window(window)
    B = q.shape[0]
    for name, t in (("n_chunks", n_chunks), ("win_len", win_len)):
        if not torch.is_tensor(t) or tuple(t.shape) != (B,):
            raise ValueError(f"{name} must be a tensor [{B}], got {t!r}")
    qa._check_tensors(q, (("n_chunks", n_chunks, torch.int32),
                          ("win_len", win_len, torch.int32)))
    if q.device.type == "cpu":
        return fused_sparse_decode_attention_ps_plain(q, kv_pool, k_win, v_win,
                                                      n_chunks, win_len, li, kfmt,
                                                      vfmt, kv_scales, return_win_probs,
                                                      window)
    stream = qa._stream(q)
    qa._check_aligned((("q", q), ("kv_pool", kv_pool), ("k_win", k_win),
                       ("v_win", v_win), *_scales(kv_scales)))
    fn = qa._library("sp_decode", "sp_decode_ps", 10, 17)
    out = torch.empty_like(q)
    qb = q.to(torch.bfloat16)
    n_splits = ps_splits(mc, W)
    probs = qa.win_probs_out(q, BH, W, return_win_probs, n_splits)
    scratch = qa._split_scratch(BH, n_splits, G, q.device, stream,
                                qa.per_slot_probs_scratch(BH, G, W, return_win_probs))
    rc = fn(qb.data_ptr(), kv_pool.data_ptr(), _ptr(kv_scales), k_win.data_ptr(),
            v_win.data_ptr(), n_chunks.data_ptr(), win_len.data_ptr(), out.data_ptr(),
            _ptr(probs), scratch.data_ptr(), scratch.numel(), int(out.dtype == torch.float32),
            q.device.index or 0, kfmt.qbits, BH, BH // B, G, mc, W, qa.window_tile(W), li,
            *_segs(kfmt), *_segs(vfmt), n_splits, window or 0, stream)
    if rc != 0:
        raise RuntimeError(f"sp_decode_ps launch failed: CUDA error {rc}")
    fused_sparse_decode_attention_ps.launches += 1
    return (out, probs) if return_win_probs else out


fused_sparse_decode_attention_ps.launches = 0


# ---------------------------------------------------------------------------
# Segment partials over the pools (chunked prefill)
# ---------------------------------------------------------------------------

def fused_sparse_segment_attention_plain(q_seg, kv_pool, n_chunks: int, li: int,
                                         kfmt, vfmt, kv_scales=None, seg_start: int = 0,
                                         window=None):
    """The bitmap segment kernel's arithmetic: one online-softmax step a
    chunk over the expanded K and V, with a sliding ``window`` each row's
    columns at or below its edge scored -1e30
    (``quant_attention.segment_steps``)."""
    return qa.segment_steps(q_seg, kv_pool.shape[2], n_chunks,
                            _sp_chunk_step(kv_pool, kv_scales, li, kfmt, vfmt),
                            seg_start, window)


SEG_TILE_ROWS = 128          # query rows a CTA of the segment kernel takes
MAX_CLUSTER = 8              # the portable thread block cluster size


def segment_grid(T: int, G: int) -> tuple[int, int]:
    """The segment kernel's grid along one kv head's T*G query rows:
    (cluster, row tiles).  The rows go in tiles of 128, a CTA each; the
    tiles form thread block clusters of the smallest power of two that
    covers them, at most 8, each cluster expanding a chunk once; the tiles
    are padded to a multiple of the cluster (a padding tile expands its
    share and writes nothing)."""
    tiles = -(-T * G // SEG_TILE_ROWS)
    cluster = min(MAX_CLUSTER, 1 << (tiles - 1).bit_length())
    return cluster, -(-tiles // cluster) * cluster


def fused_sparse_segment_attention(q_seg, kv_pool, n_chunks: int, seg_start: int,
                                   li: int, kfmt: sf.ChunkFormat,
                                   vfmt: sf.ChunkFormat, *, kv_scales=None,
                                   window=None):
    """Flash partials of a chunked-prefill segment over layer ``li``'s first
    ``n_chunks`` bitmap pool chunks: (acc [B,Tseg,Hq,128] f32, m, l
    [B,Tseg,Hq,1] f32), unnormalised, for ``ops.attention.merge_partials``.
    ``n_chunks`` is uniform across the batch and known on the host;
    ``seg_start`` is the segment's first position, at or past the packed
    chunks.  Chunks at or past ``n_chunks`` are never read.  ``kv_scales``
    as for ``fused_sparse_decode_attention``.  With a sliding ``window`` the
    row of token t sees only the pool columns past seg_start + t - window
    (``quant_attention.fused_q_segment_attention``).

    CUDA tensors launch the kernel of ``csrc/sp_segment.cu`` (built at first
    use; the instance of the formats' value width) on the current stream,
    as thread block clusters over each kv head's row tiles
    (``segment_grid``), each cluster leaving out the chunks dead for its
    oldest row; CPU tensors run the plain version.  A CUDA request the
    kernel cannot serve, or a cluster launch the card refuses, raises;
    nothing falls back."""
    _check_formats(kfmt, vfmt, kv_scales, "fused_sparse_segment_attention")
    qa.check_window(window)
    if q_seg.dim() != 4 or q_seg.shape[3] != 128 or q_seg.shape[1] < 1:
        raise ValueError(f"q_seg must be [B, Tseg, Hq, 128], got {tuple(q_seg.shape)}")
    B, T, Hq, _ = q_seg.shape
    L, mc, BH, Hkv = _check_pool(kv_pool, kv_scales, kfmt, vfmt, B)
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} kv heads")
    qa._check_tensors(q_seg, (("q_seg", q_seg, q_seg.dtype),
                              ("kv_pool", kv_pool, torch.int16),
                              *((n, t, torch.bfloat16) for n, t in _scales(kv_scales))))
    qa._check_int("li", li, 0, L - 1)
    qa._check_int("n_chunks", n_chunks, 0, mc)
    if not isinstance(seg_start, int) or seg_start < n_chunks * kfmt.chunk:
        raise ValueError(f"seg_start must be an int at or past the {n_chunks} "
                         f"packed chunks, got {seg_start!r}")
    if q_seg.device.type == "cpu":
        return fused_sparse_segment_attention_plain(q_seg, kv_pool, n_chunks, li,
                                                    kfmt, vfmt, kv_scales, seg_start,
                                                    window)
    stream = qa._stream(q_seg)
    qa._check_aligned((("q_seg", q_seg), ("kv_pool", kv_pool), *_scales(kv_scales)))
    fn = qa._library("sp_segment", "sp_segment", 6, 17)
    dev = q_seg.device
    acc = torch.empty((B, T, Hq, 128), dtype=torch.float32, device=dev)
    m = torch.empty((B, T, Hq, 1), dtype=torch.float32, device=dev)
    l = torch.empty((B, T, Hq, 1), dtype=torch.float32, device=dev)
    qb = q_seg.to(torch.bfloat16)
    rc = fn(qb.data_ptr(), kv_pool.data_ptr(), _ptr(kv_scales), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(), dev.index or 0, kfmt.qbits, BH, Hkv, Hq // Hkv,
            T, mc, n_chunks, li, seg_start, window or 0, *_segs(kfmt), *_segs(vfmt),
            *segment_grid(T, Hq // Hkv), stream)
    if rc != 0:
        raise RuntimeError(f"sp_segment launch failed: CUDA error {rc}")
    fused_sparse_segment_attention.launches += 1
    return acc, m, l


fused_sparse_segment_attention.launches = 0
