"""The archived decode-attention generations v1-v6: the CUDA kernels, their
plain PyTorch versions and the wrappers that pick between them by device.

Ports of ``mustafar_tpu/ops/kernels/sparse_attention_archive.py``, the
development history of the production bitmap kernels
(``sparse_attention.py``); no serving path runs them, and the cache, the
``Generator`` and the engine never import this module.  v1-v3 read the
split pools of ``ops/sparse_format.encode_chunk``: per (chunk, kv head,
stream) the value segments [R_i, 128] in the dense dtype and a bitmap of
P = C/32 = 8 uint32 word planes [P, 128] in int32 carriers.  v4-v6 read the
fused int16 stream of ``encode_stream`` [mc, B*Hkv, KR + VR, 128] (K's
value segments and 16 uint16 word planes, then V's), which is one layer
``kv_pool[li]`` of the compressed cache's stacked pool, passed as that view.
  sparse_key_scores               v1 key SpMV     csrc/sp_archive_spmv.cu
                                                  (entry sp_key_scores)
  sparse_value_combine            v1 value SpMV   csrc/sp_archive_spmv.cu
                                                  (entry sp_value_combine)
  sparse_decode_attention         v1: the pair, with the softmax and the
                                  window in plain torch between them
  fused_sparse_decode_attention   v2, head-major  csrc/sp_archive_fused.cu
                                                  (entry sp_fused_v2)
  fused_sparse_decode_attention_v3
                                  v3, chunk-major csrc/sp_archive_fused.cu
                                                  (entry sp_fused_v3)
  fused_sparse_decode_attention_v4
                                  v4, the stream  csrc/sp_archive_stream.cu
                                                  (entry sp_fused_v4)
  fused_sparse_decode_attention_v5
                                  v5, head-batched
                                                  csrc/sp_archive_stream.cu
                                                  (entry sp_fused_v5)
  fused_sparse_decode_attention_v6
                                  v6: the pools' partials
                                  (``..._v6_partials``, entry sp_fused_v6 of
                                  csrc/sp_archive_stream.cu), the window and
                                  the flash merge in plain torch
Each source's header note says which TPU kernel it replaces, what bounds it
and what its design does.  Chunks are expanded to bf16 values (a segment
in f32 is rounded, as the TPU kernels' expansion rounds it) and attended in
f32 with 1/sqrt(128) scaling.  The archive takes no scales: chunks must be
``qbits=16`` (a ``qbits=8`` stream would be attended as raw codes), and
other formats are refused with ``NotImplementedError``.

v2-v5 take one online-softmax step a chunk, then the whole window in one
step, masked with -1e30 (not the production kernel's window tiles): the
plain versions repeat these steps.  On the card v2 and v3 (kernels 12 and
13) run as the production bitmap decode does, one CTA a softmax step of 64
chunk tokens or of a window tile, merged in step order; a step rounds p to
bf16 at its own max, which their split plain versions repeat
(``fused_sparse_decode_attention_split_plain``, ``..._v3_split_plain``).
v2 and v3 take their counts as host ints or as one-element int32 tensors
on the card, read there (a CUDA graph replays a call at any counts).  With
nothing to attend (n_chunks = win_len = 0) every masked column gets
p = exp(0) = 1: v2-v4 give the mean of the head's W window rows, v5 (whose
window step also masks the other heads of its TPU grid step) the mean of
the windows of all ``hpb`` heads of that step, ``hpb`` reduced as the JAX
package reduces it (``tpu_hpb``).  v1's softmax runs over -inf masks and
v6 merges l = 0 with l = 0: both give NaN there.

Layouts are the JAX package's:
  q              [B, 1, Hq, 128]            bf16 or f32
  head-major     k_segs[i] [BH, mc*R_i, 128], k_bmp [BH, mc*P, 128] (or
  (v1, v2)       [BH, mc*P*128])
  chunk-major    k_segs[i] [mc, BH, R_i, 128], k_bmp [mc, BH, P, 128]
  (v3)
  stream (v4-v6) kv_pool [mc, BH, KR + VR, 128] int16
  k_win / v_win  [B, W, Hkv, 128]           (the dense cache's per-layer
                                            layout)
with BH = B*Hkv, G = Hq/Hkv query heads a kv head (1, 2, 4 or 8), padded
to G8 = 8 rows where the JAX package pads them.
"""

from __future__ import annotations

import torch

from mustafar_tpu_torch.ops import sparse_format as sf
from mustafar_tpu_torch.ops.kernels import quant_attention as qa

G8 = 8                                # q rows of the v1 pair (G padded with zeros)
_SEG_DTYPES = (torch.bfloat16, torch.float32)


def _check_format(fmt, name):
    if (not isinstance(fmt, sf.ChunkFormat) or (fmt.chunk, fmt.dim) != (256, 128)
            or fmt.qbits != 16):
        raise NotImplementedError(
            f"{name} serves 256-token x 128-channel chunks of bf16 values "
            f"(qbits=16; the archive takes no scales), got {fmt!r}")


def _check_hpb(hpb):
    """The TPU kernels' heads per grid step: a positive int."""
    if not isinstance(hpb, int) or isinstance(hpb, bool) or hpb < 1:
        raise ValueError(f"hpb must be a positive int, got {hpb!r}")


def _check_pools(segs, bmp, fmt, BH, mc, chunk_major, label):
    """Shapes and dtypes of one stream's split pools; returns the bitmap
    as [BH, mc*P, 128] (head-major) or as given (chunk-major)."""
    if not isinstance(segs, (list, tuple)) or len(segs) != len(fmt.segs):
        raise ValueError(f"{label}_segs must be a list of {len(fmt.segs)} tensors "
                         f"(segments {fmt.segs})")
    P, D = fmt.planes, fmt.dim
    for i, (s, k) in enumerate(zip(segs, fmt.segs)):
        R = fmt.seg_rows(k)
        want = (mc, BH, R, 128) if chunk_major else (BH, mc * R, 128)
        if not torch.is_tensor(s) or tuple(s.shape) != want:
            raise ValueError(f"{label}_segs[{i}] must be {want}, got "
                             f"{tuple(s.shape) if torch.is_tensor(s) else s!r}")
        if s.dtype not in _SEG_DTYPES or s.dtype != segs[0].dtype:
            raise TypeError(f"{label}_segs must all be bfloat16 or all float32, "
                            f"got {[x.dtype for x in segs]}")
    if not torch.is_tensor(bmp):
        raise ValueError(f"{label}_bmp must be a tensor, got {bmp!r}")
    if chunk_major:
        if tuple(bmp.shape) != (mc, BH, P, D):
            raise ValueError(f"{label}_bmp must be {(mc, BH, P, D)}, "
                             f"got {tuple(bmp.shape)}")
        return bmp
    if tuple(bmp.shape) not in ((BH, mc * P, D), (BH, mc * P * D)):
        raise ValueError(f"{label}_bmp must be {(BH, mc * P, D)} or "
                         f"{(BH, mc * P * D)}, got {tuple(bmp.shape)}")
    return bmp.reshape(BH, mc * P, D)


def _stream_named(label, segs, bmp):
    """(name, tensor, dtype) of one stream's pools for
    ``quant_attention._check_tensors`` (segment dtypes checked before)."""
    return ([(f"{label}_segs[{i}]", s, segs[0].dtype) for i, s in enumerate(segs)]
            + [(f"{label}_bmp", bmp, torch.int32)])


def _segs(fmt):
    """(k0, k1) segment widths of a format, k1 = 0 for one segment."""
    return (*fmt.segs, 0)[:2]


def _seg_ptrs(segs):
    """The segments in bf16 (the expansion's rounding) and their two
    addresses, the second NULL for one segment."""
    segs = [s.to(torch.bfloat16).contiguous() for s in segs]
    return segs, [s.data_ptr() for s in segs] + [None] * (2 - len(segs))


def _expand(segs, bmp, fmt):
    """Chunks of split pools -> their dense values in f32, rounded to bf16
    as the TPU kernels' expansion rounds them (0 where the bit is unset)."""
    return sf.decode_chunk(segs, bmp, fmt).to(torch.bfloat16).to(torch.float32)


def _head_major_chunk(segs, bmp, fmt, mc, ci):
    """Chunk ``ci`` of every head of head-major pools -> [BH, C, D] f32."""
    BH = bmp.shape[0]
    return _expand([s.view(BH, mc, -1, 128)[:, ci] for s in segs],
                   bmp.view(BH, mc, fmt.planes, fmt.dim)[:, ci], fmt)


def _chunk_major_chunk(segs, bmp, fmt, ci):
    return _expand([s[ci] for s in segs], bmp[ci], fmt)


def _heads(win):
    """[B, W, Hkv, D] -> [B*Hkv, W, D]."""
    B, W, Hkv, D = win.shape
    return win.permute(0, 2, 1, 3).reshape(B * Hkv, W, D)


# ---------------------------------------------------------------------------
# v1, kernel 1: sparse key scores
# ---------------------------------------------------------------------------

def _check_spmv(x, x_name, x_cols, segs, bmp, n_chunks, fmt, max_chunks, label, name):
    _check_format(fmt, name)
    qa._check_int("max_chunks", max_chunks, 1, 1 << 20)
    if x.dim() != 3 or x.shape[1] != G8 or x.shape[2] != x_cols(max_chunks):
        raise ValueError(f"{x_name} must be [BH, {G8}, {x_cols(max_chunks)}], "
                         f"got {tuple(x.shape)}")
    BH = x.shape[0]
    bmp = _check_pools(segs, bmp, fmt, BH, max_chunks, False, label)
    qa._check_tensors(x, [(x_name, x, torch.bfloat16)] + _stream_named(label, segs, bmp))
    qa._check_int("n_chunks", n_chunks, 0, max_chunks)
    return BH, bmp


def sparse_key_scores_plain(q, k_segs, k_bmp, n_chunks: int, fmt, max_chunks: int):
    """Kernel 10's arithmetic: chunk ci < n_chunks of every head expanded,
    scores q . K in f32; the columns of later chunks exactly 0."""
    BH, g8, D = q.shape
    C = fmt.chunk
    out = torch.zeros((BH, g8, max_chunks * C), dtype=torch.float32, device=q.device)
    qf = q.to(torch.float32)
    for ci in range(n_chunks):
        kd = _head_major_chunk(k_segs, k_bmp.reshape(BH, -1, D), fmt, max_chunks, ci)
        out[:, :, ci * C:(ci + 1) * C] = qf @ kd.transpose(1, 2)
    return out


def sparse_key_scores(q, k_segs, k_bmp, n_chunks: int, fmt: sf.ChunkFormat,
                      max_chunks: int):
    """q [BH, 8, 128] bf16 . every chunk ci < ``n_chunks`` of the head-major
    K pools, expanded -> scores [BH, 8, max_chunks*256] f32 (no scale);
    the columns of chunks at or past ``n_chunks`` are exactly 0.

    CUDA tensors launch the kernel of ``csrc/sp_archive_spmv.cu`` (built at
    first use) on the current stream; CPU tensors run the plain version.  A
    CUDA request the kernel cannot serve raises; nothing falls back."""
    BH, k_bmp = _check_spmv(q, "q", lambda mc: fmt.dim, k_segs, k_bmp, n_chunks, fmt,
                            max_chunks, "k", "sparse_key_scores")
    if q.device.type == "cpu":
        return sparse_key_scores_plain(q, k_segs, k_bmp, n_chunks, fmt, max_chunks)
    stream = qa._stream(q)
    segs, ptrs = _seg_ptrs(k_segs)
    qa._check_aligned((("q", q), ("k_bmp", k_bmp), *(("k_segs", s) for s in segs)))
    fn = qa._library("sp_archive_spmv", "sp_key_scores", 5, 6)
    out = torch.empty((BH, G8, max_chunks * fmt.chunk), dtype=torch.float32,
                      device=q.device)
    rc = fn(q.data_ptr(), *ptrs, k_bmp.data_ptr(), out.data_ptr(), q.device.index or 0,
            BH, max_chunks, n_chunks, *_segs(fmt), stream)
    if rc != 0:
        raise RuntimeError(f"sp_key_scores launch failed: CUDA error {rc}")
    sparse_key_scores.launches += 1
    return out


sparse_key_scores.launches = 0


# ---------------------------------------------------------------------------
# v1, kernel 2: sparse value combine
# ---------------------------------------------------------------------------

def sparse_value_combine_plain(w, v_segs, v_bmp, n_chunks: int, fmt, max_chunks: int):
    """Kernel 11's arithmetic: sum over chunks ci < n_chunks, in order, of
    w's columns of chunk ci (bf16) . the expanded V chunk, in f32."""
    BH, g8, _ = w.shape
    C, D = fmt.chunk, fmt.dim
    out = torch.zeros((BH, g8, D), dtype=torch.float32, device=w.device)
    for ci in range(n_chunks):
        vd = _head_major_chunk(v_segs, v_bmp.reshape(BH, -1, D), fmt, max_chunks, ci)
        out = out + w[:, :, ci * C:(ci + 1) * C].to(torch.float32) @ vd
    return out


def sparse_value_combine(w, v_segs, v_bmp, n_chunks: int, fmt: sf.ChunkFormat,
                         max_chunks: int):
    """w [BH, 8, max_chunks*256] bf16 (softmax weights) . the head-major V
    pools' chunks ci < ``n_chunks``, expanded and summed -> [BH, 8, 128]
    f32; later chunks' columns of w are never read.

    CUDA tensors launch the kernel of ``csrc/sp_archive_spmv.cu`` (built at
    first use) on the current stream; CPU tensors run the plain version.  A
    CUDA request the kernel cannot serve raises; nothing falls back."""
    BH, v_bmp = _check_spmv(w, "w", lambda mc: mc * fmt.chunk, v_segs, v_bmp, n_chunks,
                            fmt, max_chunks, "v", "sparse_value_combine")
    if w.device.type == "cpu":
        return sparse_value_combine_plain(w, v_segs, v_bmp, n_chunks, fmt, max_chunks)
    stream = qa._stream(w)
    segs, ptrs = _seg_ptrs(v_segs)
    qa._check_aligned((("w", w), ("v_bmp", v_bmp), *(("v_segs", s) for s in segs)))
    fn = qa._library("sp_archive_spmv", "sp_value_combine", 5, 6)
    out = torch.empty((BH, G8, fmt.dim), dtype=torch.float32, device=w.device)
    rc = fn(w.data_ptr(), *ptrs, v_bmp.data_ptr(), out.data_ptr(), w.device.index or 0,
            BH, max_chunks, n_chunks, *_segs(fmt), stream)
    if rc != 0:
        raise RuntimeError(f"sp_value_combine launch failed: CUDA error {rc}")
    sparse_value_combine.launches += 1
    return out


sparse_value_combine.launches = 0


# ---------------------------------------------------------------------------
# Decode attention: the checks the three generations share
# ---------------------------------------------------------------------------

def _check_decode(q, k_segs, k_bmp, v_segs, v_bmp, k_win, v_win, kfmt, vfmt, max_chunks,
                  chunk_major, name):
    """Returns (B, Hkv, G, W, k_bmp, v_bmp), the head-major bitmaps as
    [BH, mc*P, 128]; the counts are each caller's to check."""
    _check_format(kfmt, name)
    _check_format(vfmt, name)
    qa._check_int("max_chunks", max_chunks, 1, 1 << 20)
    if q.dim() != 4 or q.shape[1] != 1 or q.shape[3] != 128:
        raise ValueError(f"q must be [B, 1, Hq, 128], got {tuple(q.shape)}")
    B, _, Hq, D = q.shape
    if k_win.dim() != 4 or k_win.shape[0] != B or k_win.shape[3] != D or k_win.shape[1] < 1:
        raise ValueError(f"k_win must be [{B}, W >= 1, Hkv, {D}], got {tuple(k_win.shape)}")
    if v_win.shape != k_win.shape:
        raise ValueError(f"v_win {tuple(v_win.shape)} != k_win {tuple(k_win.shape)}")
    W, Hkv = k_win.shape[1], k_win.shape[2]
    if Hkv < 1 or Hq % Hkv or Hq // Hkv not in qa._GROUPS:
        raise ValueError(f"{Hq} query heads over {Hkv} kv heads: the kernels take "
                         f"groups of {qa._GROUPS}")
    BH = B * Hkv
    k_bmp = _check_pools(k_segs, k_bmp, kfmt, BH, max_chunks, chunk_major, "k")
    v_bmp = _check_pools(v_segs, v_bmp, vfmt, BH, max_chunks, chunk_major, "v")
    if k_win.dtype not in _SEG_DTYPES:
        raise TypeError(f"k_win must be bfloat16 or float32, got {k_win.dtype}")
    qa._check_tensors(q, [("q", q, q.dtype), ("k_win", k_win, k_win.dtype),
                          ("v_win", v_win, k_win.dtype)]
                      + _stream_named("k", k_segs, k_bmp) + _stream_named("v", v_segs, v_bmp))
    return B, Hkv, Hq // Hkv, W, k_bmp, v_bmp


# ---------------------------------------------------------------------------
# v1: the pair, with the softmax between them in plain torch
# ---------------------------------------------------------------------------

def _softmax(x):
    """jax.nn.softmax's steps: exp(x - max) over its sum (NaN on a row of
    -inf, as there)."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _v1(q, k_segs, k_bmp, v_segs, v_bmp, k_win, v_win, n_chunks, win_len, kfmt, vfmt,
        max_chunks, scores, combine):
    """The v1 chain in the JAX package's order, around ``scores`` (kernel
    10) and ``combine`` (kernel 11)."""
    B, _, Hq, D = q.shape
    W, Hkv = k_win.shape[1], k_win.shape[2]
    BH, G = B * Hkv, Hq // Hkv
    S = max_chunks * kfmt.chunk
    f32 = torch.float32
    qpad = torch.cat([q.reshape(BH, G, D),
                      torch.zeros((BH, G8 - G, D), dtype=q.dtype, device=q.device)], dim=1)
    s_comp = scores(qpad.to(torch.bfloat16), k_segs, k_bmp, n_chunks, kfmt,
                    max_chunks) * qa.SM_SCALE
    live = torch.arange(S, device=q.device) < n_chunks * kfmt.chunk
    s_comp = torch.where(live, s_comp, -torch.inf)
    # the window's scores take q in its own dtype (f32 q is not rounded)
    s_win = (qpad.to(f32) @ _heads(k_win).to(f32).transpose(1, 2)) * qa.SM_SCALE
    s_win = torch.where(torch.arange(W, device=q.device) < win_len, s_win, -torch.inf)
    w = _softmax(torch.cat([s_comp, s_win], dim=-1))
    w_comp = torch.where(torch.isfinite(w[..., :S]), w[..., :S], 0.0)
    o_comp = combine(w_comp.to(torch.bfloat16), v_segs, v_bmp, n_chunks, vfmt, max_chunks)
    vw = _heads(v_win)
    o_win = w[..., S:].to(vw.dtype).to(f32) @ vw.to(f32)
    return (o_comp + o_win)[:, :G].reshape(B, 1, Hq, D).to(q.dtype)


def sparse_decode_attention_plain(q, k_segs, k_bmp, v_segs, v_bmp, k_win, v_win,
                                  n_chunks: int, win_len: int, kfmt, vfmt,
                                  max_chunks: int):
    """The v1 chain over the plain versions of kernels 10 and 11."""
    return _v1(q, k_segs, k_bmp, v_segs, v_bmp, k_win, v_win, n_chunks, win_len, kfmt,
               vfmt, max_chunks, sparse_key_scores_plain, sparse_value_combine_plain)


def sparse_decode_attention(q, k_segs, k_bmp, v_segs, v_bmp, k_win, v_win,
                            n_chunks: int, win_len: int, kfmt: sf.ChunkFormat,
                            vfmt: sf.ChunkFormat, max_chunks: int):
    """v1 decode attention over ``n_chunks`` chunks of the head-major split
    pools and the first ``win_len`` rows of the window -> [B, 1, Hq, 128]
    in q's dtype.  Kernel 10 scores the chunks (bf16 q); scaling, the -inf
    masks, the window's scores (q in its own dtype), an f32 softmax over
    chunks ++ window, the zeroing of non-finite chunk weights and the
    window's product run in plain torch between kernel 10 and kernel 11,
    in the JAX package's order.  With nothing to attend the output is NaN,
    as there.

    CUDA tensors launch kernels 10 and 11 (``sparse_key_scores``,
    ``sparse_value_combine``); CPU tensors run their plain versions."""
    _, _, _, W, k_bmp, v_bmp = _check_decode(
        q, k_segs, k_bmp, v_segs, v_bmp, k_win, v_win, kfmt, vfmt, max_chunks, False,
        "sparse_decode_attention")
    qa._check_int("n_chunks", n_chunks, 0, max_chunks)
    qa._check_int("win_len", win_len, 0, W)
    return _v1(q, k_segs, k_bmp, v_segs, v_bmp, k_win, v_win, n_chunks, win_len, kfmt,
               vfmt, max_chunks, sparse_key_scores, sparse_value_combine)


# ---------------------------------------------------------------------------
# v2 and v3: fused expansion, online softmax and combine
# ---------------------------------------------------------------------------

CHUNK_CUT = 4          # softmax steps the kernels cut a chunk into (runs of 64 tokens)
MAX_SPLITS = 2048      # most steps a row of the kernels' grid takes (4 mc + window tiles)


def _fused_plain(q, chunk, k_win, v_win, n_chunks, win_len):
    """v2's and v3's arithmetic: one online-softmax step a chunk
    (``chunk(ci)`` -> expanded K, V [BH, 256, 128] f32), then the whole
    window [0, W) in one step with columns at or past ``win_len`` at -1e30;
    p rounded to bf16 for the value product; out = acc / l."""
    B, _, Hq, D = q.shape
    Hkv = k_win.shape[2]
    BH, G = B * Hkv, Hq // Hkv
    f32 = torch.float32
    qf = q.to(torch.bfloat16).to(f32).reshape(BH, G, D)
    m = torch.full((BH, G, 1), qa.NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((BH, G, 1), dtype=f32, device=q.device)
    acc = torch.zeros((BH, G, D), dtype=f32, device=q.device)
    for ci in range(n_chunks):
        kd, vd = chunk(ci)
        m, l, acc = qa._softmax_step(m, l, acc, (qf @ kd.transpose(1, 2)) * qa.SM_SCALE,
                                     vd, None)
    kw = _heads(k_win).to(torch.bfloat16).to(f32)
    vw = _heads(v_win).to(torch.bfloat16).to(f32)
    s = (qf @ kw.transpose(1, 2)) * qa.SM_SCALE
    s = torch.where(torch.arange(kw.shape[1], device=q.device) < win_len, s, qa.NEG_INF)
    m, l, acc = qa._softmax_step(m, l, acc, s, vw, None)
    return (acc / l).reshape(B, 1, Hq, D).to(q.dtype)


def fused_sparse_decode_attention_plain(q, k_segs, k_bmp, v_segs, v_bmp, k_win, v_win,
                                        n_chunks: int, win_len: int, kfmt, vfmt,
                                        max_chunks: int):
    """v2 (kernel 12) over head-major pools, in PyTorch, in the TPU
    kernel's steps (the CPU path)."""
    BH = k_win.shape[0] * k_win.shape[2]
    k_bmp, v_bmp = k_bmp.reshape(BH, -1, 128), v_bmp.reshape(BH, -1, 128)

    def chunk(ci):
        return (_head_major_chunk(k_segs, k_bmp, kfmt, max_chunks, ci),
                _head_major_chunk(v_segs, v_bmp, vfmt, max_chunks, ci))
    return _fused_plain(q, chunk, k_win, v_win, n_chunks, win_len)


def fused_sparse_decode_attention_v3_plain(q, k_segs, k_bmp, v_segs, v_bmp, k_win,
                                           v_win, n_chunks: int, win_len: int, kfmt,
                                           vfmt, max_chunks: int):
    """v3 (kernel 13) over chunk-major pools, in PyTorch: v2's arithmetic."""
    def chunk(ci):
        return (_chunk_major_chunk(k_segs, k_bmp, kfmt, ci),
                _chunk_major_chunk(v_segs, v_bmp, vfmt, ci))
    return _fused_plain(q, chunk, k_win, v_win, n_chunks, win_len)


def window_mean(v_win):
    """The mean of each head's W window rows [B, W, Hkv, 128] -> [B*Hkv,
    128] f32: the rows (as bf16) summed in row order in f32, then divided
    by W, as kernels 12 and 13 write it where there is nothing to attend."""
    vw = _heads(v_win).to(torch.bfloat16).to(torch.float32)
    acc = torch.zeros_like(vw[:, 0])
    for t in range(vw.shape[1]):
        acc = acc + vw[:, t]
    # a true division (a CUDA tensor over a host scalar is a product by its
    # reciprocal)
    return acc / torch.full_like(acc, float(vw.shape[1]))


def _split_plain(q, chunk, k_win, v_win, n_chunks, win_len, max_chunks):
    """Kernels 12 and 13's arithmetic (``quant_attention.ps_split_steps``
    with every slot at the call's counts): each chunk's ``CHUNK_CUT`` runs
    of 64 tokens and each window tile of live tokens one softmax step from a
    fresh state, merged in step order, the scores summed in the kernels'
    order (``quant_attention._scores``); ``chunk(ci)`` -> expanded K, V
    [BH, 256, 128] f32 of every head.  With nothing to attend the window
    mean (``window_mean``)."""
    B, _, Hq, D = q.shape
    W, Hkv = k_win.shape[1], k_win.shape[2]
    BH = B * Hkv
    nc, wl = qa.host_count(n_chunks, max_chunks), qa.host_count(win_len, W)
    if nc == 0 and wl == 0:
        return (window_mean(v_win)[:, None].expand(BH, Hq // Hkv, D)
                .reshape(B, 1, Hq, D).to(q.dtype))
    chunks = [chunk(ci) for ci in range(nc)]
    qf32 = q.to(torch.bfloat16).to(torch.float32).reshape(BH, Hq // Hkv, D)
    scores = [qa._scores(qf32, kd, True) for kd, _ in chunks]

    def slot_step(hs):
        return lambda _, ci: (scores[ci][hs], chunks[ci][1][hs], None)
    nc_t, wl_t = qa.uniform_counts(B, nc, wl, q.device)
    kw, vw = (_heads(w).to(torch.bfloat16)[None] for w in (k_win, v_win))
    return qa.ps_split_steps(q, BH, nc_t, wl_t, max_chunks, slot_step, kw, vw, 0,
                             cut=CHUNK_CUT, ordered=True)


def fused_sparse_decode_attention_split_plain(q, k_segs, k_bmp, v_segs, v_bmp, k_win,
                                              v_win, n_chunks, win_len, kfmt, vfmt,
                                              max_chunks: int):
    """Kernel 12's arithmetic over head-major pools (``_split_plain``), at
    counts given as host ints or one-element tensors."""
    BH = k_win.shape[0] * k_win.shape[2]
    k_bmp, v_bmp = k_bmp.reshape(BH, -1, 128), v_bmp.reshape(BH, -1, 128)

    def chunk(ci):
        return (_head_major_chunk(k_segs, k_bmp, kfmt, max_chunks, ci),
                _head_major_chunk(v_segs, v_bmp, vfmt, max_chunks, ci))
    return _split_plain(q, chunk, k_win, v_win, n_chunks, win_len, max_chunks)


def fused_sparse_decode_attention_v3_split_plain(q, k_segs, k_bmp, v_segs, v_bmp, k_win,
                                                 v_win, n_chunks, win_len, kfmt, vfmt,
                                                 max_chunks: int):
    """Kernel 13's arithmetic over chunk-major pools: kernel 12's."""
    def chunk(ci):
        return (_chunk_major_chunk(k_segs, k_bmp, kfmt, ci),
                _chunk_major_chunk(v_segs, v_bmp, vfmt, ci))
    return _split_plain(q, chunk, k_win, v_win, n_chunks, win_len, max_chunks)


def split_grid(max_chunks: int, W: int) -> int:
    """Steps a row of kernels 12 and 13's grid takes (``CHUNK_CUT`` a pool
    chunk, then a window tile of ``quant_attention.window_tile(W)``),
    sized from the capacities alone; refused past ``MAX_SPLITS``, and where
    a window tile would exceed 256 tokens (a W over 256 that no multiple of
    8 of at most 96 divides is one tile of W)."""
    wt = qa.window_tile(W)
    if wt > 256:
        raise ValueError(f"a window of {W} rows is one tile of {wt} tokens; the kernels "
                         f"take at most 256 a tile")
    n = qa.uniform_grid(max_chunks, W, CHUNK_CUT)
    if n > MAX_SPLITS:
        raise ValueError(f"{max_chunks} chunks and a window of {W} rows make {n} steps a "
                         f"row; the kernels take at most {MAX_SPLITS}")
    return n


def _fused(entry, fn_self, q, k_segs, k_bmp, v_segs, v_bmp, k_win, v_win, n_chunks,
           win_len, kfmt, vfmt, max_chunks, hpb, chunk_major, plain):
    name = fn_self.__name__
    _check_hpb(hpb)
    B, Hkv, G, W, k_bmp, v_bmp = _check_decode(
        q, k_segs, k_bmp, v_segs, v_bmp, k_win, v_win, kfmt, vfmt, max_chunks, chunk_major,
        name)
    nc_t, wl_t = qa.device_counts(q, n_chunks, win_len, max_chunks, W)
    BH = B * Hkv
    n_splits = split_grid(max_chunks, W)         # the kernels' limits, on every device
    qa.split_scratch_floats(BH, n_splits, G)
    if q.device.type == "cpu":
        return plain(q, k_segs, k_bmp, v_segs, v_bmp, k_win, v_win,
                     qa.host_count(nc_t, max_chunks), qa.host_count(wl_t, W), kfmt, vfmt,
                     max_chunks)
    stream = qa._stream(q)
    ks, kp = _seg_ptrs(k_segs)
    vs, vp = _seg_ptrs(v_segs)
    qb = q.to(torch.bfloat16)
    kw, vw = k_win.to(torch.bfloat16), v_win.to(torch.bfloat16)
    qa._check_aligned((("q", qb), ("k_bmp", k_bmp), ("v_bmp", v_bmp), ("k_win", kw),
                       ("v_win", vw), *(("segs", s) for s in ks + vs)))
    fn = qa._library("sp_archive_fused", entry, 14, 14)
    out = torch.empty_like(q)
    scratch = qa._split_scratch(BH, n_splits, G, q.device, stream)
    counters = qa._split_counters(BH, q.device, stream)
    rc = fn(qb.data_ptr(), *kp, k_bmp.data_ptr(), *vp, v_bmp.data_ptr(), kw.data_ptr(),
            vw.data_ptr(), nc_t.data_ptr(), wl_t.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), counters.data_ptr(), scratch.numel(), counters.numel(),
            int(out.dtype == torch.float32), q.device.index or 0, B, Hkv, G, max_chunks, W,
            qa.window_tile(W), *_segs(kfmt), *_segs(vfmt), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    fn_self.launches += 1
    return out


def fused_sparse_decode_attention(q, k_segs, k_bmp, v_segs, v_bmp, k_win, v_win,
                                  n_chunks, win_len, kfmt: sf.ChunkFormat,
                                  vfmt: sf.ChunkFormat, max_chunks: int, hpb: int = 8):
    """v2: fused decode attention over ``n_chunks`` chunks of the head-major
    split pools and the first ``win_len`` window rows -> [B, 1, Hq, 128] in
    q's dtype (q read as bf16, the window as bf16); with nothing to attend
    the mean of each head's W window rows, as on the TPU.  ``hpb`` is the
    TPU kernel's heads per grid step; it does not change the result.
    ``n_chunks`` and ``win_len`` are the TPU kernel's scalar-prefetch
    counts: host ints (checked, then filled into int32 tensors on q's
    device) or int32 tensors of one element on q's device, which the kernel
    reads with no host sync (clamped into [0, max_chunks] and [0, W]), so a
    CUDA graph of a call replays at any counts
    (``quant_attention.device_counts``).

    CUDA tensors launch the kernel of ``csrc/sp_archive_fused.cu`` (entry
    ``sp_fused_v2``, built at first use) on the current stream: one CTA a
    softmax step of 64 chunk tokens or of a window tile, ``split_grid``
    steps a row (those past the live ones exit), the row's last CTA merging
    with the stream's split scratch and counters
    (``quant_attention._split_scratch``, ``_split_counters``); its
    arithmetic is ``fused_sparse_decode_attention_split_plain``.  Refused
    there: more than ``MAX_SPLITS`` steps a row, a window tile over 256
    tokens (``split_grid``).  CPU tensors run the plain version in the TPU
    kernel's steps.  A CUDA request the kernel cannot serve raises; nothing
    falls back; the limits hold on the CPU too."""
    return _fused("sp_fused_v2", fused_sparse_decode_attention, q, k_segs, k_bmp,
                  v_segs, v_bmp, k_win, v_win, n_chunks, win_len, kfmt, vfmt,
                  max_chunks, hpb, False, fused_sparse_decode_attention_plain)


fused_sparse_decode_attention.launches = 0


def fused_sparse_decode_attention_v3(q, k_segs, k_bmp, v_segs, v_bmp, k_win, v_win,
                                     n_chunks, win_len, kfmt: sf.ChunkFormat,
                                     vfmt: sf.ChunkFormat, max_chunks: int, hpb: int = 8):
    """v3: v2's function over chunk-major split pools (k_segs[i]
    [mc, BH, R_i, 128], k_bmp [mc, BH, P, 128]).
    ``n_chunks`` and ``win_len`` are the TPU kernel's scalar-prefetch
    counts: host ints (checked, then filled into int32 tensors on q's
    device) or int32 tensors of one element on q's device, which the kernel
    reads with no host sync (clamped into [0, max_chunks] and [0, W]), so a
    CUDA graph of a call replays at any counts
    (``quant_attention.device_counts``).

    CUDA tensors launch the kernel of ``csrc/sp_archive_fused.cu`` (entry
    ``sp_fused_v3``: v2's kernel body over this layout) on the current
    stream; its arithmetic is
    ``fused_sparse_decode_attention_v3_split_plain``, its limits v2's.  CPU
    tensors run the plain version in the TPU kernel's steps.  A CUDA
    request the kernel cannot serve raises; nothing falls back."""
    return _fused("sp_fused_v3", fused_sparse_decode_attention_v3, q, k_segs, k_bmp,
                  v_segs, v_bmp, k_win, v_win, n_chunks, win_len, kfmt, vfmt,
                  max_chunks, hpb, True, fused_sparse_decode_attention_v3_plain)


fused_sparse_decode_attention_v3.launches = 0


# ---------------------------------------------------------------------------
# v4-v6: the fused stream pool
# ---------------------------------------------------------------------------

def tpu_hpb(hpb: int, BH: int) -> int:
    """The heads of one TPU grid step of v4-v6: ``hpb`` capped at BH, then
    halved until it divides BH (not the largest divisor: at BH = 12, 8
    becomes 4).  Only v5's nothing-to-attend case reads it."""
    hpb = min(hpb, BH)
    while BH % hpb:
        hpb //= 2
    return hpb


def _check_stream(q, kv_pool, n_chunks, win_len, kfmt, vfmt, max_chunks, window, name):
    """q, the stream pool, the counts and ``window`` of a v4-v6 call;
    returns (B, Hkv, G)."""
    _check_format(kfmt, name)
    _check_format(vfmt, name)
    # JAX documents window >= the window capacity; with window <= 0 and
    # nothing in the window it would attend every masked column of the grid
    # step (p = 1), which no caller means
    if window is not None and (not isinstance(window, int) or isinstance(window, bool)
                               or window < 1):
        raise ValueError(f"window must be None or an int >= 1, got {window!r}")
    qa._check_int("max_chunks", max_chunks, 1, 1 << 20)
    if q.dim() != 4 or q.shape[1] != 1 or q.shape[3] != 128:
        raise ValueError(f"q must be [B, 1, Hq, 128], got {tuple(q.shape)}")
    B, _, Hq, _ = q.shape
    rows = kfmt.stream_rows + vfmt.stream_rows
    if (not torch.is_tensor(kv_pool) or kv_pool.dim() != 4 or kv_pool.shape[0] != max_chunks
            or tuple(kv_pool.shape[2:]) != (rows, 128) or kv_pool.shape[1] % B):
        raise ValueError(f"kv_pool must be [{max_chunks}, B*Hkv, {rows}, 128] with B = {B}, "
                         f"got {tuple(kv_pool.shape) if torch.is_tensor(kv_pool) else kv_pool!r}")
    Hkv = kv_pool.shape[1] // B
    if Hkv < 1 or Hq % Hkv or Hq // Hkv not in qa._GROUPS:
        raise ValueError(f"{Hq} query heads over {Hkv} kv heads: the kernels take "
                         f"groups of {qa._GROUPS}")
    qa._check_tensors(q, [("q", q, q.dtype), ("kv_pool", kv_pool, torch.int16)])
    qa._check_int("n_chunks", n_chunks, 0, max_chunks)
    qa._check_int("win_len", win_len, 0, 1 << 30)
    return B, Hkv, Hq // Hkv


def _check_stream_windows(q, k_win, v_win, Hkv, win_len):
    """The windows [B, W >= win_len, Hkv, 128] of a v4-v6 call; returns W."""
    B, D = q.shape[0], q.shape[3]
    if (not torch.is_tensor(k_win) or k_win.dim() != 4 or k_win.shape[0] != B
            or k_win.shape[2] != Hkv or k_win.shape[3] != D or k_win.shape[1] < 1):
        raise ValueError(f"k_win must be [{B}, W >= 1, {Hkv}, {D}], got "
                         f"{tuple(k_win.shape) if torch.is_tensor(k_win) else k_win!r}")
    if not torch.is_tensor(v_win) or v_win.shape != k_win.shape:
        raise ValueError(f"v_win must be {tuple(k_win.shape)} as k_win")
    if k_win.dtype not in _SEG_DTYPES:
        raise TypeError(f"k_win must be bfloat16 or float32, got {k_win.dtype}")
    qa._check_tensors(q, [("k_win", k_win, k_win.dtype), ("v_win", v_win, k_win.dtype)])
    qa._check_int("win_len", win_len, 0, k_win.shape[1])
    return k_win.shape[1]


def _stream_chunk(kv_pool, kfmt, vfmt):
    """Chunk ``ci`` of every head of the stream pool -> expanded K, V
    [BH, 256, 128] f32 (``decode_stream``, bf16 values)."""
    KR = kfmt.stream_rows

    def chunk(ci):
        rows = kv_pool[ci]
        return (sf.decode_stream(rows[:, :KR], kfmt).to(torch.float32),
                sf.decode_stream(rows[:, KR:], vfmt).to(torch.float32))
    return chunk


def fused_sparse_decode_attention_v4_plain(q, kv_pool, k_win, v_win, n_chunks: int,
                                           win_len: int, kfmt, vfmt, max_chunks: int,
                                           hpb: int = 8):
    """v4 (kernel 14) over the stream pool, in PyTorch: v2's arithmetic."""
    return _fused_plain(q, _stream_chunk(kv_pool, kfmt, vfmt), k_win, v_win, n_chunks,
                        win_len)


def _group_mean(q, v_win, hpb):
    """v5 with nothing to attend: every column of the grid step's hpb*W
    window columns has p = 1, so each query head gets the mean of the V
    window rows of all hpb heads of its step."""
    B, _, Hq, D = q.shape
    W, Hkv = v_win.shape[1], v_win.shape[2]
    BH, G = B * Hkv, Hq // Hkv
    vw = _heads(v_win).to(torch.bfloat16).to(torch.float32)      # [BH, W, D]
    sums = vw.reshape(BH // hpb, hpb * W, D).sum(dim=1) / float(hpb * W)
    out = sums.repeat_interleave(hpb, dim=0)[:, None].expand(BH, G, D)
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def fused_sparse_decode_attention_v5_plain(q, kv_pool, k_win, v_win, n_chunks: int,
                                           win_len: int, kfmt, vfmt, max_chunks: int,
                                           hpb: int = 8):
    """v5 (kernel 15) in PyTorch.  Its block-diagonal masks put the other
    heads' columns at -1e30; once a row has a live column they add exactly
    0, so each head's steps are v4's.  With nothing to attend the result is
    the mean of the grid step's heads' windows (``tpu_hpb``)."""
    if n_chunks == 0 and win_len == 0:
        return _group_mean(q, v_win, tpu_hpb(hpb, k_win.shape[0] * k_win.shape[2]))
    return fused_sparse_decode_attention_v4_plain(q, kv_pool, k_win, v_win, n_chunks,
                                                  win_len, kfmt, vfmt, max_chunks)


_window_low = qa.window_low     # v6's sliding window: the newest masked pool column


def fused_sparse_decode_attention_v6_partials_plain(q, kv_pool, n_chunks: int,
                                                    win_len: int, kfmt, vfmt,
                                                    window=None):
    """Kernel 16's arithmetic: the flash partials over the pools only, acc
    [BH, G, 128], m and l [BH, G, 1] f32 (no chunk: 0, -1e30, 0).  With a
    sliding window, chunks wholly at or below its lower edge are skipped and
    the masked columns of the chunk that straddles it are -1e30.  On the
    TPU the skipped chunks give p = 1 while no column is live, wiped exactly
    by corr = exp(-1e30 - m) = 0 at the first live one; where no chunk
    column is live (window <= win_len) the TPU's partials differ, but the
    merge multiplies them by exp(-1e30 - m_w) = 0 all the same."""
    B, _, Hq, D = q.shape
    BH = kv_pool.shape[1]
    G = Hq // (BH // B)
    C = kfmt.chunk
    f32 = torch.float32
    qf = q.to(torch.bfloat16).to(f32).reshape(BH, G, D)
    m = torch.full((BH, G, 1), qa.NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((BH, G, 1), dtype=f32, device=q.device)
    acc = torch.zeros((BH, G, D), dtype=f32, device=q.device)
    low = _window_low(n_chunks, win_len, window, C)
    chunk = _stream_chunk(kv_pool, kfmt, vfmt)
    for ci in range((low + 1) // C, n_chunks):
        kd, vd = chunk(ci)
        s = (qf @ kd.transpose(1, 2)) * qa.SM_SCALE
        s = torch.where(ci * C + torch.arange(C, device=q.device) > low, s, qa.NEG_INF)
        m, l, acc = qa._softmax_step(m, l, acc, s, vd, None)
    return acc, m, l


def _v6_merge(q, k_win, v_win, win_len, acc, m_c, l_c):
    """v6's window attention and flash merge, in the JAX package's order
    (XLA ops there, torch ops here): scores with q in its own dtype against
    k_win cast to it, masked at -inf past ``win_len``, m_w clamped to
    -1e30, p_w rounded to bf16 for the product with bf16 v_win; then the
    partials (acc, m_c, l_c) and the window's merged.  Nothing to attend
    gives 0/0 = NaN, as there."""
    B, _, Hq, D = q.shape
    W, Hkv = k_win.shape[1], k_win.shape[2]
    BH, G = B * Hkv, Hq // Hkv
    f32 = torch.float32
    qw = q.reshape(B, Hkv, G, D).to(f32)
    kw = k_win.to(q.dtype).to(f32)
    s_w = torch.einsum("bhgd,bwhd->bhgw", qw, kw) * qa.SM_SCALE
    s_w = torch.where(torch.arange(W, device=q.device) < win_len, s_w, -torch.inf)
    m_w = torch.clamp_min(s_w.amax(dim=-1, keepdim=True), qa.NEG_INF)
    p_w = torch.exp(s_w - m_w)
    l_w = p_w.sum(dim=-1, keepdim=True).reshape(BH, G, 1)
    o_w = torch.einsum("bhgw,bwhd->bhgd", p_w.to(torch.bfloat16).to(f32),
                       v_win.to(torch.bfloat16).to(f32)).reshape(BH, G, D)
    m_w = m_w.reshape(BH, G, 1)
    m_tot = torch.maximum(m_c, m_w)
    a_c = torch.exp(m_c - m_tot)
    a_w = torch.exp(m_w - m_tot)
    out = (acc * a_c + o_w * a_w) / (l_c * a_c + l_w * a_w)
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def fused_sparse_decode_attention_v6_plain(q, kv_pool, k_win, v_win, n_chunks: int,
                                           win_len: int, kfmt, vfmt, max_chunks: int,
                                           hpb: int = 8, window=None):
    """v6 in PyTorch: kernel 16's plain partials, then the window and the
    merge."""
    acc, m, l = fused_sparse_decode_attention_v6_partials_plain(q, kv_pool, n_chunks,
                                                                win_len, kfmt, vfmt, window)
    return _v6_merge(q, k_win, v_win, win_len, acc, m, l)


def _stream_launch(entry, fn_self, q, kv_pool, k_win, v_win, n_chunks, win_len, kfmt,
                   vfmt, max_chunks, hpb, plain):
    """v4's and v5's wrapper body: the plain version on the CPU, else the
    kernel (q and the window read as bf16)."""
    _check_hpb(hpb)
    B, Hkv, G = _check_stream(q, kv_pool, n_chunks, win_len, kfmt, vfmt, max_chunks, None,
                              fn_self.__name__)
    W = _check_stream_windows(q, k_win, v_win, Hkv, win_len)
    if q.device.type == "cpu":
        return plain(q, kv_pool, k_win, v_win, n_chunks, win_len, kfmt, vfmt, max_chunks,
                     hpb)
    stream = qa._stream(q)
    qb = q.to(torch.bfloat16)
    kw, vw = k_win.to(torch.bfloat16), v_win.to(torch.bfloat16)
    qa._check_aligned((("q", qb), ("kv_pool", kv_pool), ("k_win", kw), ("v_win", vw)))
    extra = (tpu_hpb(hpb, B * Hkv),) if entry == "sp_fused_v5" else ()
    fn = qa._library("sp_archive_stream", entry, 5, 13 + len(extra))
    out = torch.empty_like(q)
    rc = fn(qb.data_ptr(), kv_pool.data_ptr(), kw.data_ptr(), vw.data_ptr(), out.data_ptr(),
            int(out.dtype == torch.float32), q.device.index or 0, B, Hkv, G, max_chunks, W,
            n_chunks, win_len, *extra, *_segs(kfmt), *_segs(vfmt), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    fn_self.launches += 1
    return out


def fused_sparse_decode_attention_v4(q, kv_pool, k_win, v_win, n_chunks: int,
                                     win_len: int, kfmt: sf.ChunkFormat,
                                     vfmt: sf.ChunkFormat, max_chunks: int, hpb: int = 8):
    """v4: v2's function over ``n_chunks`` chunks of the stream pool
    [max_chunks, B*Hkv, KR + VR, 128] int16 and the window -> [B, 1, Hq, 128]
    in q's dtype (q and the window read as bf16).  ``hpb`` is the TPU
    kernel's heads per grid step and does not change the result.

    CUDA tensors launch the kernel of ``csrc/sp_archive_stream.cu`` (entry
    ``sp_fused_v4``: one cp.async copy a chunk, double-buffered; built at
    first use) on the current stream; CPU tensors run the plain version.  A
    CUDA request the kernel cannot serve raises; nothing falls back."""
    return _stream_launch("sp_fused_v4", fused_sparse_decode_attention_v4, q, kv_pool,
                          k_win, v_win, n_chunks, win_len, kfmt, vfmt, max_chunks, hpb,
                          fused_sparse_decode_attention_v4_plain)


fused_sparse_decode_attention_v4.launches = 0


def fused_sparse_decode_attention_v5(q, kv_pool, k_win, v_win, n_chunks: int,
                                     win_len: int, kfmt: sf.ChunkFormat,
                                     vfmt: sf.ChunkFormat, max_chunks: int, hpb: int = 8):
    """v5: v4's contract, head-batched on the TPU.  It gives v4's result but
    with nothing to attend, where it is the mean of the windows of the
    ``tpu_hpb(hpb, B*Hkv)`` heads of each grid step.

    CUDA tensors launch the kernel of ``csrc/sp_archive_stream.cu`` (entry
    ``sp_fused_v5``: the scores and p.V on the tensor cores) on the current
    stream; CPU tensors run the plain version.  A CUDA request the kernel
    cannot serve raises; nothing falls back."""
    return _stream_launch("sp_fused_v5", fused_sparse_decode_attention_v5, q, kv_pool,
                          k_win, v_win, n_chunks, win_len, kfmt, vfmt, max_chunks, hpb,
                          fused_sparse_decode_attention_v5_plain)


fused_sparse_decode_attention_v5.launches = 0


def fused_sparse_decode_attention_v6_partials(q, kv_pool, n_chunks: int, win_len: int,
                                              kfmt: sf.ChunkFormat, vfmt: sf.ChunkFormat,
                                              max_chunks: int, window=None):
    """Kernel 16 alone: v6's flash partials over the stream pool, (acc
    [BH, G, 128], m [BH, G, 1], l [BH, G, 1]) f32 (q read as bf16;
    ``win_len`` places the newest position for ``window``).

    CUDA tensors launch the kernel of ``csrc/sp_archive_stream.cu`` (entry
    ``sp_fused_v6``), counted on ``fused_sparse_decode_attention_v6``; CPU
    tensors run the plain version.  A CUDA request the kernel cannot serve
    raises; nothing falls back."""
    B, Hkv, G = _check_stream(q, kv_pool, n_chunks, win_len, kfmt, vfmt, max_chunks, window,
                              "fused_sparse_decode_attention_v6")
    if q.device.type == "cpu":
        return fused_sparse_decode_attention_v6_partials_plain(q, kv_pool, n_chunks, win_len,
                                                               kfmt, vfmt, window)
    stream = qa._stream(q)
    qb = q.to(torch.bfloat16)
    qa._check_aligned((("q", qb), ("kv_pool", kv_pool)))
    BH, D = B * Hkv, q.shape[3]
    acc = torch.empty((BH, G, D), dtype=torch.float32, device=q.device)
    m = torch.empty((BH, G, 1), dtype=torch.float32, device=q.device)
    l = torch.empty((BH, G, 1), dtype=torch.float32, device=q.device)
    fn = qa._library("sp_archive_stream", "sp_fused_v6", 5, 11)
    rc = fn(qb.data_ptr(), kv_pool.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
            q.device.index or 0, B, Hkv, G, max_chunks, n_chunks,
            _window_low(n_chunks, win_len, window, kfmt.chunk), *_segs(kfmt), *_segs(vfmt),
            stream)
    if rc != 0:
        raise RuntimeError(f"sp_fused_v6 launch failed: CUDA error {rc}")
    fused_sparse_decode_attention_v6.launches += 1
    return acc, m, l


def fused_sparse_decode_attention_v6(q, kv_pool, k_win, v_win, n_chunks: int,
                                     win_len: int, kfmt: sf.ChunkFormat,
                                     vfmt: sf.ChunkFormat, max_chunks: int, hpb: int = 8,
                                     window=None):
    """v6: kernel 16's partials over the pools (``..._v6_partials``), then
    the window's attention and the flash merge as torch ops, in the JAX
    package's order (``_v6_merge``) -> [B, 1, Hq, 128] in q's dtype.  The
    window's scores take q in its own dtype (an f32 q is not rounded
    there), the pools' bf16 q.  ``window`` (None or an int >= 1; JAX
    documents it >= the window capacity) masks the chunk columns at or
    below n_chunks*256 + win_len - 1 - window; the window's rows are never
    masked.  Nothing to attend gives NaN, as in JAX.

    CUDA tensors launch kernel 16 and run the merge on the card; CPU
    tensors run the plain version.  A CUDA request the kernel cannot serve
    raises; nothing falls back."""
    _check_hpb(hpb)
    _, Hkv, _ = _check_stream(q, kv_pool, n_chunks, win_len, kfmt, vfmt, max_chunks, window,
                              "fused_sparse_decode_attention_v6")
    _check_stream_windows(q, k_win, v_win, Hkv, win_len)
    acc, m, l = fused_sparse_decode_attention_v6_partials(q, kv_pool, n_chunks, win_len,
                                                          kfmt, vfmt, max_chunks, window)
    return _v6_merge(q, k_win, v_win, win_len, acc, m, l)


fused_sparse_decode_attention_v6.launches = 0
