"""Fused quant-codec attention kernels: the CUDA kernels, their plain
PyTorch versions and the wrappers that pick between them by device.

Ports of ``mustafar_tpu/ops/kernels/quant_attention.py`` for the codecs q8
(int8 K, int8 V), q8q4 (int8 K, int4 V) and q4q4 (int4 K, int4 V) at
256-token chunks, with the options the output-aware (Opa) policies read:
the decode kernels' window probabilities (``return_win_probs``) and the
uniform decode's final softmax stats (``return_norm``), and Mistral's
sliding window (``window``) in every kernel:
  fused_q_decode_attention     uniform-batch decode   csrc/q_decode.cu
                               (one CTA a split, the merge fused)
  fused_q_decode_attention_ps  per-slot decode        csrc/q_decode_ps.cu
                               (split-K: a split kernel, then its merge)
  fused_q_segment_attention    chunked-prefill        csrc/q_segment.cu
                               partials over the pools
Each kernel's header note says what it computes, what bounds it and how it
is laid out.  The plain versions below repeat their arithmetic step by step
(same casts, same order of scaling, the same online-softmax steps), so
kernel and plain version agree to f32 rounding.  Both decode kernels split
a row's work (one chunk, or one window tile, a split), each split one
softmax step from a fresh state, and merge the splits' partials:
``fused_q_decode_attention_split_plain`` and
``fused_q_decode_attention_ps_split_plain`` are their arithmetic,
``fused_q_decode_attention_plain`` and ``fused_q_decode_attention_ps_plain``
the TPU's (one running softmax over the same steps; the CPU path).

The sliding window (the TPU kernels' rule): a call at ``n_chunks`` chunks
and ``win_len`` window tokens decodes the token at position n_chunks * 256
+ win_len - 1, and pool column c is live iff c > low = n_chunks * 256 +
win_len - 1 - window (``window_low``; per slot, each slot at its own
counts).  The dense window's columns are never masked: the cache keeps the
window at least its capacity.  The TPU runs every chunk and masks scores
to -1e30 (``decode_steps``: a chunk wholly masked is wiped by the next live
step's correction exp(-1e30 - m) = 0).  The CUDA kernels leave out the
steps wholly at or below low: they are not among the uniform kernel's live
steps (``uniform_splits``), a per-slot split below its slot's edge exits
before it reads anything and the merge skips it; only the columns of the
step that holds the edge are masked.  Their split plain versions take the
same steps.  A segment (chunked prefill) query row of token t sits at
position seg_start + t and sees the pool columns past seg_start + t -
window (``segment_steps``), so the edge moves along the segment's rows;
the CUDA kernel leaves out the chunks dead for the oldest row it holds.

Layouts are the JAX package's stacked ones, indexed at layer ``li``:
  q          [B, 1, Hq, 128]              bf16 or f32 (read as bf16)
  q_seg      [B, Tseg, Hq, 128]           bf16 or f32 (read as bf16)
  kv_pool    [L, mc, B*Hkv, ROWS, 128]    int16   (K rows, then V rows:
                                                   ROWS 256 / 192 / 128 at
                                                   q8 / q8q4 / q4q4)
  kv_scales  [L, mc, B*Hkv, 2, 128]       bf16    (K scale, V scale)
  k_win/v_win [L, B*Hkv, W, 128]          bf16
The cache keeps [L, mc, B, Hkv, ...] and [L, B, Hkv, W, D]; both flatten to
these views for free.

The uniform decode takes its counts (``n_chunks``, ``win_len``) as the TPU
kernel takes them by scalar prefetch: int32 scalars in device memory (a
host int is put there first), read by the kernel, whose grid is sized from
the pool's and the window's capacity alone (``uniform_grid``).  So the
decode step that calls it holds no host value, and a CUDA graph of the step
replays at every position; the CPU's plain versions read the counts from
the tensors they are given.  The segment kernel takes ``n_chunks`` and
``seg_start`` the same way (``segment_device_counts``), on a grid of T, G
and B*Hkv alone, so a graph of a chunked-prefill segment replays at every
segment; its plain version reads nothing on the host (a static loop over
the pool's chunks, masked past n_chunks: ``segment_steps``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mustafar_tpu_torch.device import device_int
from mustafar_tpu_torch.ops import quant_format as qf
from mustafar_tpu_torch.ops.attention import merge_partials
from mustafar_tpu_torch.ops.kernels import build

NEG_INF = -1e30
SM_SCALE = 0.08838834764831845      # 1 / sqrt(128)
WINDOW_TILE = 96                    # most window tokens per softmax step
_GROUPS = (1, 2, 4, 8)              # query heads per kv head the decode kernels take


def _check_codec(codec, name):
    if ((codec.kbits, codec.vbits) not in qf.CODECS.values()
            or (codec.chunk, codec.dim) != (256, 128)):
        raise NotImplementedError(
            f"{name} serves the codecs q8, q8q4 and q4q4 with 256-token chunks, "
            f"got {codec!r}")


def check_window(window):
    if window is not None and (not isinstance(window, int) or window < 1):
        raise ValueError(f"window must be an int >= 1 or None, got {window!r}")


def _check_tensors(q, named):
    """dtype, contiguity and device of each (name, tensor, dtype)."""
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    for name, t, dt in named:
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _check_pool(kv_pool, kv_scales, codec, B):
    """Return (L, mc, BH, Hkv) of the stacked pool."""
    if kv_pool.dim() != 5 or tuple(kv_pool.shape[3:]) != (codec.stream_rows, 128):
        raise ValueError(f"kv_pool must be [L, mc, BH, {codec.stream_rows}, 128], "
                         f"got {tuple(kv_pool.shape)}")
    L, mc, BH = kv_pool.shape[:3]
    if tuple(kv_scales.shape) != (L, mc, BH, 2, 128):
        raise ValueError(f"kv_scales must be {(L, mc, BH, 2, 128)}, "
                         f"got {tuple(kv_scales.shape)}")
    if B < 1 or BH % B:
        raise ValueError(f"pool heads {BH} are not a multiple of batch {B}")
    return L, mc, BH, BH // B


def _check_int(name, val, lo, hi):
    if not isinstance(val, int) or not lo <= val <= hi:
        raise ValueError(f"{name} must be an int in [{lo}, {hi}], got {val!r}")


def _check_decode(q, kv_pool, kv_scales, k_win, v_win, li, codec, name):
    """Shapes, types and devices both decode kernels share; returns
    (BH, G, mc, W)."""
    _check_codec(codec, name)
    if q.dim() != 4 or q.shape[1] != 1 or q.shape[3] != 128:
        raise ValueError(f"q must be [B, 1, Hq, 128], got {tuple(q.shape)}")
    B, _, Hq, _ = q.shape
    L, mc, BH, Hkv = _check_pool(kv_pool, kv_scales, codec, B)
    if k_win.dim() != 4 or tuple(k_win.shape[:2]) != (L, BH) or k_win.shape[3] != 128:
        raise ValueError(f"k_win must be [{L}, {BH}, W, 128], got {tuple(k_win.shape)}")
    if v_win.shape != k_win.shape:
        raise ValueError(f"v_win {tuple(v_win.shape)} != k_win {tuple(k_win.shape)}")
    if Hq % Hkv or Hq // Hkv not in _GROUPS:
        raise ValueError(f"{Hq} query heads over {Hkv} kv heads: the kernel "
                         f"takes groups of {_GROUPS}")
    _check_tensors(q, (("q", q, q.dtype), ("kv_pool", kv_pool, torch.int16),
                       ("kv_scales", kv_scales, torch.bfloat16),
                       ("k_win", k_win, torch.bfloat16),
                       ("v_win", v_win, torch.bfloat16)))
    _check_int("li", li, 0, L - 1)
    return BH, Hq // Hkv, mc, k_win.shape[2]


def _check_aligned(named):
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _stream(t):
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def window_tile(W: int) -> int:
    """Window tokens per online-softmax step: the largest multiple of 8 that
    divides the window capacity W and is at most 96, the TPU kernel's rule
    (``sparse_attention._window_tile``).  Taking the same steps keeps the
    bf16 rounding of p, which depends on the running max, the same too."""
    cands = [d for d in range(8, min(WINDOW_TILE, W) + 1, 8) if W % d == 0]
    return max(cands) if cands else W


def _scores(qf32, k, ordered: bool = False):
    """q . k^T / sqrt(128) in f32 (q [..., R, D], k [..., n, D]): the f32
    product, or with ``ordered`` summed as the uniform CUDA kernels sum:
    each quarter of the channels (32 j .. 32 j + 31) in channel order, one
    f32 rounding a product added, then (s0 + s1) + (s2 + s3).  Every
    product of the decode kernels' operands is exact (bf16 times bf16 or a
    code of 8 or fewer bits: at most 16 significant bits), so the ordered
    scores are the kernels' bit for bit, and so is every bf16(p)."""
    if not ordered:
        return (qf32 @ k.transpose(-1, -2)) * SM_SCALE
    q4 = qf32.reshape(*qf32.shape[:-1], 1, 4, 32)
    k4 = k.reshape(*k.shape[:-2], 1, k.shape[-2], 4, 32)
    s = torch.zeros((*qf32.shape[:-1], k.shape[-2], 4), dtype=torch.float32,
                    device=qf32.device)
    for c in range(32):
        s = s + q4[..., c] * k4[..., c]
    return ((s[..., 0] + s[..., 1]) + (s[..., 2] + s[..., 3])) * SM_SCALE


def _softmax_step(m, l, acc, s, vmat, vscale):
    """One online-softmax step of the kernels: scores s [..., R, n] (f32)
    against values vmat [..., n, D]; p rounded to bf16 for the value
    product, which ``vscale`` [..., D] (a chunk's V scale) multiplies."""
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1, keepdim=True)
    pv = p.to(torch.bfloat16).to(torch.float32) @ vmat
    if vscale is not None:
        pv = pv * vscale[:, None, :]
    return m_new, l, acc * corr + pv


def _chunk(kv_pool, kv_scales, li, ci, codec):
    """Pool chunk ``ci`` of layer ``li`` as f32 codes and scales:
    (K [BH, 256, 128], V [BH, 256, 128], kscale [BH, 128], vscale [BH, 128])."""
    rows = kv_pool[li, ci]                                    # [BH, ROWS, 128]
    KR = codec.k_rows
    kc = qf.unpack_rows(rows[:, :KR], codec.kbits).to(torch.float32)
    vc = qf.unpack_rows(rows[:, KR:], codec.vbits).to(torch.float32)
    return (kc, vc, kv_scales[li, ci, :, 0].to(torch.float32),
            kv_scales[li, ci, :, 1].to(torch.float32))


def win_probs_of(ws, m, l, W: int):
    """Window probabilities from the window's raw scores ws [..., G, n] and
    the final softmax stats m, l [..., G, 1]: per column the sum over the
    G query heads, in head order, of exp(s - m) / max(l, 1e-30); zero past
    the n live columns up to W -> [..., W] f32."""
    p = torch.exp(ws - m) / torch.clamp_min(l, 1e-30)
    out = p[..., 0, :]
    for g in range(1, p.shape[-2]):
        out = out + p[..., g, :]
    return torch.nn.functional.pad(out, (0, W - out.shape[-1]))


def with_options(out, m, l, probs, norm: bool, win_probs: bool):
    """A decode call's result: ``out``, then with ``norm`` the final stats
    m and l [B, Hkv, G, 1] f32, then with ``win_probs`` the window
    probabilities [B, Hkv, W] (the TPU kernels' order)."""
    extras = ((m, l) if norm else ()) + ((probs,) if win_probs else ())
    return (out, *extras) if extras else out


def window_low(n_chunks: int, win_len: int, window, chunk: int = 256) -> int:
    """The newest pool column a sliding ``window`` masks at a call's counts:
    n_chunks * chunk + win_len - 1 - window (a column c is live iff c > it);
    -1 (nothing masked) with no window or one that covers the sequence."""
    return -1 if window is None else max(-1, n_chunks * chunk + win_len - 1 - window)


def masked_steps(n_chunks: int, win_len: int, window, step: int) -> int:
    """Pool steps of ``step`` tokens wholly at or below the window's lower
    edge (``window_low``): the ones the uniform CUDA kernels' grid leaves
    out."""
    return min((window_low(n_chunks, win_len, window) + 1) // step,
               n_chunks * (256 // step))


def _mask_cols(s, c0: int, low: int):
    """Scores s [..., n] of pool columns c0 .. c0 + n - 1 with the columns
    at or below ``low`` set to -1e30."""
    if c0 > low:
        return s
    cols = c0 + torch.arange(s.shape[-1], device=s.device)
    return s.masked_fill(cols <= low, NEG_INF)


def decode_steps(q, BH: int, n_chunks: int, chunk_step, k_win, v_win,
                 win_len: int, li: int, win_probs: bool = False, norm: bool = False,
                 window=None):
    """The decode kernels' softmax steps, shared by every codec's plain
    version.  Per (b, kv head) and query head: ``chunk_step(qf32, ci)``
    gives chunk ci's scores [BH, G, 256], its values [BH, 256, D] (f32) and
    its V scale [BH, D] or None; then window scores q . k / sqrt(128).  One
    online softmax in steps of one chunk or one window tile
    (``window_tile``); p rounded to bf16 for the value product; with a
    sliding ``window`` the pool columns at or below ``window_low`` scored
    -1e30, every chunk run, as on the TPU.  Out is f32 -> q's dtype; with
    ``norm`` also the final (m, l) [B, Hkv, G, 1], with ``win_probs`` the
    window probabilities [B, Hkv, W] (``win_probs_of`` on the final stats),
    in that order (``with_options``)."""
    B, _, Hq, D = q.shape
    G = Hq // (BH // B)
    f32 = torch.float32
    qf32 = q.to(torch.bfloat16).to(f32).reshape(BH, G, D)
    m = torch.full((BH, G, 1), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((BH, G, 1), dtype=f32, device=q.device)
    acc = torch.zeros((BH, G, D), dtype=f32, device=q.device)
    low = window_low(n_chunks, win_len, window)
    for ci in range(n_chunks):
        sc, vc, vs = chunk_step(qf32, ci)
        m, l, acc = _softmax_step(m, l, acc, _mask_cols(sc, ci * 256, low), vc, vs)
    W = k_win.shape[2]
    wt = window_tile(W)
    ws = [torch.zeros((BH, G, 0), dtype=f32, device=q.device)]
    for t0 in range(0, win_len, wt):
        t1 = min(win_len, t0 + wt)
        kw = k_win[li, :, t0:t1].to(f32)
        vw = v_win[li, :, t0:t1].to(f32)
        ws.append((qf32 @ kw.transpose(1, 2)) * SM_SCALE)
        m, l, acc = _softmax_step(m, l, acc, ws[-1], vw, None)
    out = (acc / torch.clamp_min(l, 1e-30)).reshape(B, 1, Hq, D).to(q.dtype)
    probs = (win_probs_of(torch.cat(ws, dim=-1), m, l, W).reshape(B, BH // B, W)
             if win_probs else None)
    Hkv = BH // B
    return with_options(out, m.reshape(B, Hkv, G, 1), l.reshape(B, Hkv, G, 1), probs,
                        norm, win_probs)


def slots(B: int, BH: int, n_chunks, win_len, mc: int, W: int):
    """(slot b, its kv heads' slice, n_chunks, win_len) of each slot of a
    per-slot call, the counts clamped into [0, mc] and [0, W] as the
    kernels clamp them."""
    Hkv = BH // B
    for b, (nc, wl) in enumerate(zip(n_chunks.tolist(), win_len.tolist())):
        yield b, slice(b * Hkv, (b + 1) * Hkv), min(max(nc, 0), mc), min(max(wl, 0), W)


def ps_splits(mc: int, W: int) -> int:
    """Splits a row of a per-slot kernel's grid has: one a pool chunk, then
    one a window tile (``window_tile``)."""
    return mc + (-(-W // window_tile(W)) if W else 0)


def ps_split_steps(q, BH: int, n_chunks, win_len, mc: int, slot_step, k_win, v_win,
                   li: int, cut: int = 1, ordered: bool = False, win_probs: bool = False,
                   norm: bool = False, window=None):
    """The split decode kernels' arithmetic, shared by every codec's split
    plain version: per slot (counts clamped, ``slots``), the partials (acc,
    m, l) of each of its chunks (``slot_step(hs)`` is the chunk step, as in
    ``decode_steps``, of the slot's kv heads ``hs``), each cut into ``cut``
    runs of 256 / cut tokens, and of each window tile, one softmax step each
    from a fresh state, merged in split order (``merge_partials``); the
    window's scores summed in the kernels' order with ``ordered``
    (``_scores``; the chunk step takes its own).  With a sliding ``window``
    the runs wholly at or below the slot's lower edge (``window_low`` at
    its own counts) take no step (``masked_steps``) and the run that holds
    it scores its masked columns -1e30.  A slot with nothing to
    attend comes out 0.  Out is f32 -> q's dtype; with ``norm`` also the
    merge's final (m, l) [B, Hkv, G, 1] (l unclamped; m = -1e30, l = 0 for
    a slot with nothing to attend), with ``win_probs`` the window
    probabilities [B, Hkv, W] on those stats (the kernels' epilogue), in
    that order (``with_options``)."""
    B, _, Hq, D = q.shape
    Hkv = BH // B
    G = Hq // Hkv
    f32 = torch.float32
    W = k_win.shape[2]
    wt = window_tile(W)
    outs, probs, ms, ls = [], [], [], []
    for b, hs, nc, wl in slots(B, BH, n_chunks, win_len, mc, W):
        step = slot_step(hs)
        qf32 = q[b].to(torch.bfloat16).to(f32).reshape(Hkv, G, D)
        fresh = (torch.full((Hkv, G, 1), NEG_INF, dtype=f32, device=q.device),
                 torch.zeros((Hkv, G, 1), dtype=f32, device=q.device),
                 torch.zeros((Hkv, G, D), dtype=f32, device=q.device))
        run = 256 // cut
        low = window_low(nc, wl, window)
        first = masked_steps(nc, wl, window, run)      # runs left out of the grid
        parts = []
        for ci in range(first // cut, nc):
            sc, vc, vs = step(qf32, ci)
            parts.extend(_softmax_step(*fresh, _mask_cols(sc[..., t:t + run], ci * 256 + t, low),
                                       vc[:, t:t + run], vs)
                         for t in range(0, 256, run) if ci * cut + t // run >= first)
        ws = [torch.zeros((Hkv, G, 0), dtype=f32, device=q.device)]
        for t0 in range(0, wl, wt):
            kw = k_win[li, hs, t0:min(wl, t0 + wt)].to(f32)
            vw = v_win[li, hs, t0:min(wl, t0 + wt)].to(f32)
            ws.append(_scores(qf32, kw, ordered))
            parts.append(_softmax_step(*fresh, ws[-1], vw, None))
        if parts:
            out, m, l = merge_partials([(acc, m, l) for m, l, acc in parts],
                                       return_stats=True)
        else:
            out, m, l = fresh[2], fresh[0], fresh[1]
        outs.append(out.reshape(1, 1, Hq, D))
        ms.append(m)
        ls.append(l)
        probs.append(win_probs_of(torch.cat(ws, dim=-1), m, l, W)[None])
    return with_options(torch.cat(outs).to(q.dtype), torch.stack(ms), torch.stack(ls),
                        torch.cat(probs), norm, win_probs)


def segment_row_lows(T: int, G: int, seg_start, window, device=None):
    """The newest pool column a sliding ``window`` masks for each of a kv
    head's T*G segment query rows (row t*G + g sits at position seg_start +
    t and sees the columns past seg_start + t - window) -> [T*G] int64, or
    None without a window.  ``seg_start`` a host int or a one-element
    tensor."""
    if window is None:
        return None
    t = torch.arange(T * G, device=device) // G
    return seg_start + t - window


def segment_first_chunk(seg_start: int, t_first: int, window, n_chunks: int) -> int:
    """The first pool chunk with a live column for segment token ``t_first``
    (and so for every later token): the chunks before it are dead for all
    of them, and a segment kernel's CTA (or cluster) whose oldest token is
    ``t_first`` leaves them out."""
    if window is None:
        return 0
    return min(max(seg_start + t_first - window + 1, 0) // 256, n_chunks)


def segment_steps(q_seg, BH: int, mc: int, n_chunks, chunk_step, seg_start=0,
                  window=None):
    """The segment kernels' steps, shared by every codec's plain version:
    every query row (token t, head of kv head h; row t*G + g) attends the
    first ``n_chunks`` pool chunks of its (b, h), one online-softmax step a
    chunk (``chunk_step`` as in ``decode_steps``), p rounded to bf16; with a
    sliding ``window`` the row's columns at or below seg_start + t - window
    scored -1e30 (``segment_row_lows``), every chunk run, as on the TPU.
    Returns the unnormalised partials (acc [B,T,Hq,D] f32, m [B,T,Hq,1],
    l [B,T,Hq,1]); with no chunk, m = -1e30, l = 0.  A row with no live
    column keeps m = -1e30 (its l and acc are finite sums over masked
    columns, which ``merge_partials`` weighs 0 beside a live partial).

    ``n_chunks`` and ``seg_start`` are the kernels' counts: one-element
    tensors (or host ints), read with no host read, as the kernels read
    them (``segment_counts``: clamped into [0, mc] and to 0 up).  The loop
    runs over all ``mc`` chunks the pool holds, and a chunk at or past
    n_chunks leaves the state as it was (a select, so the result is the
    loop's over n_chunks bit for bit): the static program a CUDA graph of
    the segment holds."""
    B, T, Hq, D = q_seg.shape
    Hkv = BH // B
    G = Hq // Hkv
    f32 = torch.float32
    dev = q_seg.device
    nc, start = segment_counts(n_chunks, seg_start, mc, dev)
    qf32 = (q_seg.to(torch.bfloat16).to(f32).reshape(B, T, Hkv, G, D)
            .permute(0, 2, 1, 3, 4).reshape(BH, T * G, D))
    m = torch.full((BH, T * G, 1), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros((BH, T * G, 1), dtype=f32, device=dev)
    acc = torch.zeros((BH, T * G, D), dtype=f32, device=dev)
    lows = segment_row_lows(T, G, start, window, dev)
    for ci in range(mc):
        sc, vc, vs = chunk_step(qf32, ci)
        if lows is not None:
            cols = ci * 256 + torch.arange(256, device=dev)
            sc = sc.masked_fill(cols[None, :] <= lows[:, None], NEG_INF)
        live = ci < nc
        m, l, acc = (torch.where(live, new, old) for new, old in
                     zip(_softmax_step(m, l, acc, sc, vc, vs), (m, l, acc)))

    def unfold(x):
        return (x.reshape(B, Hkv, T, G, x.shape[-1]).permute(0, 2, 1, 3, 4)
                .reshape(B, T, Hq, x.shape[-1]))

    return unfold(acc), unfold(m), unfold(l)


def scaled_chunk_step(qf32, kc, vc, ks, vs, ordered: bool = False):
    """One chunk of int codes with per-channel scales, as the kernels fold
    them: scores bf16(q * kscale) . K codes / sqrt(128) (in the uniform
    kernels' order with ``ordered``, ``_scores``); the V scale ``vs``
    multiplies the value product (``_softmax_step``).  Shared with the
    bitmap-q8 codec (``sparse_attention``)."""
    qk = (qf32 * ks[:, None, :]).to(torch.bfloat16).to(torch.float32)
    return _scores(qk, kc, ordered), vc, vs


def _q_chunk_step(kv_pool, kv_scales, li, codec, ordered: bool = False):
    """Quant-codec chunk step (``scaled_chunk_step``)."""
    def step(qf32, ci):
        return scaled_chunk_step(qf32, *_chunk(kv_pool, kv_scales, li, ci, codec), ordered)
    return step


def fused_q_decode_attention_plain(q, kv_pool, kv_scales, k_win, v_win,
                                   n_chunks, win_len, li: int,
                                   codec: qf.QuantCodec, win_probs: bool = False,
                                   norm: bool = False, window=None):
    """The uniform decode TPU kernel's arithmetic in PyTorch (``decode_steps``
    with the codec's chunk step), at counts given as the kernel takes them
    (one-element tensors) or as host ints (``host_count``)."""
    return decode_steps(q, kv_pool.shape[2], host_count(n_chunks, kv_pool.shape[1]),
                        _q_chunk_step(kv_pool, kv_scales, li, codec), k_win, v_win,
                        host_count(win_len, k_win.shape[2]), li, win_probs, norm, window)


def uniform_splits(n_chunks: int, win_len: int, W: int, cut: int = 1, window=None):
    """The live splits of a row of a uniform decode kernel at the call's
    counts, as its CTAs count them on the device (``csrc/decode_tile.cuh``
    read_counts): (chunk splits, window splits) = (n_chunks * cut less the
    runs wholly below a sliding window's edge (``masked_steps``),
    ceil(win_len / window_tile(W))).  Every split has tokens: a chunk's
    runs of 256 / cut, a window tile at least one; every chunk split has a
    live column."""
    return (n_chunks * cut - masked_steps(n_chunks, win_len, window, 256 // cut),
            -(-win_len // window_tile(W)) if win_len else 0)


def uniform_grid(mc: int, W: int, cut: int = 1) -> int:
    """Splits a row of a uniform decode kernel's grid, sized from the
    pool's and the window's capacity: every run of 256 / cut tokens of the
    mc chunks, then every window tile of W (``csrc/decode_tile.cuh``
    grid_steps).  The CTAs past a call's live splits (``uniform_splits``)
    exit unread."""
    return mc * cut + (-(-W // window_tile(W)) if W else 0)


def win_probs_out(q, BH: int, W: int, want: bool):
    """The window probabilities' output [B, Hkv, W] f32 of a decode kernel
    call (every column written by the kernel), or None."""
    if not want:
        return None
    return torch.empty((q.shape[0], BH // q.shape[0], W), dtype=torch.float32,
                       device=q.device)


def norm_out(q, BH: int, want: bool):
    """The final stats' output [2, B, Hkv, G, 1] f32 (m, then l) of a uniform
    kernel call (written by the kernel), or None."""
    if not want:
        return None
    B = q.shape[0]
    return torch.empty((2, B, BH // B, q.shape[2] // (BH // B), 1), dtype=torch.float32,
                       device=q.device)


def host_count(n, hi: int) -> int:
    """A count as the plain versions take it: a host int, or the value of
    a one-element tensor (read, which on the CPU costs nothing), clamped
    into [0, hi] as the kernels clamp what they read."""
    return min(max(int(n), 0), hi)


def device_counts(q, n_chunks, win_len, mc: int, W: int):
    """The uniform kernels' counts as they read them: int32 tensors of one
    element on q's device.  A host int is range-checked ([0, mc], [0, W])
    and filled into one; a tensor is taken as it is (the kernel clamps
    it)."""
    out = []
    for name, n, hi in (("n_chunks", n_chunks, mc), ("win_len", win_len, W)):
        if torch.is_tensor(n):
            if n.numel() != 1 or n.dtype != torch.int32 or not n.is_contiguous():
                raise ValueError(f"{name} must be an int or a contiguous int32 tensor of "
                                 f"one element, got {n.dtype} {tuple(n.shape)}")
            if n.device != q.device:
                raise ValueError(f"{name} is on {n.device}, q on {q.device}")
        else:
            _check_int(name, n, 0, hi)
            n = torch.full((1,), n, dtype=torch.int32, device=q.device)
        out.append(n)
    return out


def uniform_result(out, ml, probs, norm: bool, win_probs: bool):
    """A uniform kernel call's result from its outputs (``with_options``;
    ``ml`` from ``norm_out``)."""
    m, l = (None, None) if ml is None else (ml[0], ml[1])
    return with_options(out, m, l, probs, norm, win_probs)


def _ptr(t):
    """A tensor's address for ctypes, None (NULL) for no tensor."""
    return None if t is None else t.data_ptr()


def uniform_counts(B: int, n_chunks, win_len, device):
    """The per-slot count tensors of a uniform call: every slot at
    (n_chunks, win_len) (host ints or one-element tensors)."""
    return (torch.full((B,), int(n_chunks), dtype=torch.int32, device=device),
            torch.full((B,), int(win_len), dtype=torch.int32, device=device))


_SCRATCH: dict = {}
_COUNTERS: dict = {}
INT_MAX = 2 ** 31 - 1


def split_scratch_floats(BH: int, n_splits: int, G: int) -> int:
    """Floats of a split kernel's partials (``csrc/split_merge.cuh``): per
    row, split and query head acc [128], m and l in f32.  Refused past the
    int range, in which the C entries are told the size."""
    n = BH * n_splits * G * 130
    if n > INT_MAX:
        raise ValueError(f"split scratch of {n} floats exceeds the kernels' int sizes")
    return n


def _split_scratch(BH: int, n_splits: int, G: int, device, stream, extra: int = 0):
    """Scratch for a split kernel's partials, ``split_scratch_floats`` of
    them, and ``extra`` floats after them (the uniform kernels' window
    scores); the C entry is given its size and refuses a short one.  One
    buffer per (device, stream), grown when a call needs more and kept, not
    initialised: calls on one stream run in order, and the merge reads only
    the splits that were written.  Pass its ``numel()`` as the size."""
    n = split_scratch_floats(BH, n_splits, G) + extra
    if n > INT_MAX:
        raise ValueError(f"split scratch of {n} floats exceeds the kernels' int sizes")
    key = (device.index or 0, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < n:
        buf = _SCRATCH[key] = torch.empty(n, dtype=torch.float32, device=device)
    return buf


def _split_counters(BH: int, device, stream):
    """Arrival counters of the uniform decode kernels' fused merge, one
    int32 a row: zero when allocated, and every launch leaves them zero
    (the row's last CTA resets its own).  One buffer per (device, stream),
    grown when a call needs more."""
    key = (device.index or 0, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < BH:
        buf = _COUNTERS[key] = torch.zeros(BH, dtype=torch.int32, device=device)
    return buf


def _library(name, fn_name, n_ptr, n_int):
    fn = getattr(build.load(name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fused_q_decode_attention_split_plain(q, kv_pool, kv_scales, k_win, v_win,
                                         n_chunks, win_len, li: int,
                                         codec: qf.QuantCodec, win_probs: bool = False,
                                         norm: bool = False, window=None):
    """The uniform CUDA kernel's arithmetic: each chunk (past the window's
    edge) and each window tile one split from a fresh softmax state, merged
    in split order, the scores summed in the kernel's order (``_scores``):
    the per-slot kernel's split steps (``ps_split_steps``) with every slot
    at the call's counts."""
    nc, wl = uniform_counts(q.shape[0], n_chunks, win_len, q.device)
    return ps_split_steps(
        q, kv_pool.shape[2], nc, wl, kv_pool.shape[1],
        lambda hs: _q_chunk_step(kv_pool[:, :, hs], kv_scales[:, :, hs], li, codec, True),
        k_win, v_win, li, ordered=True, win_probs=win_probs, norm=norm, window=window)


def fused_q_decode_attention(q, kv_pool, kv_scales, k_win, v_win,
                             n_chunks, win_len, li: int,
                             codec: qf.QuantCodec, *, window=None,
                             return_norm: bool = False,
                             return_win_probs: bool = False):
    """Quant-codec flash-decode of layer ``li`` over ``n_chunks`` pool chunks and the
    first ``win_len`` window tokens -> [B, 1, Hq, 128] in q's dtype (q is
    read as bf16, the output is computed in f32, as on the TPU); with a
    sliding ``window`` (an int >= 1) only the pool columns past
    ``window_low`` (module note); with
    ``return_norm`` also the final online-softmax stats m and l, each [B,
    Hkv, G, 1] f32 (the weight of a column of score s is exp(s - m) / l);
    with ``return_win_probs`` the post-softmax weights of the window columns
    summed over each kv head's query heads, [B, Hkv, W] f32, 0 at and past
    ``win_len`` (the Opa policies score V with them); in that order
    (``with_options``).  With nothing to attend (no window token and no
    chunk past the sliding window's edge) the output (and the
    probabilities) are 0, m is -1e30 and l 0 (the TPU kernel would average
    masked columns there; the cache never asks it).

    ``n_chunks`` and ``win_len`` are the TPU kernel's scalar-prefetch
    counts: int32 tensors of one element on q's device, which the kernel
    reads (clamped into [0, mc] and [0, W]), or host ints (checked, and
    filled into such tensors: ``device_counts``).  Nothing here reads them,
    so a call holds no host value and a CUDA graph replays it at any
    counts.

    CUDA tensors launch the kernel of ``csrc/q_decode.cu`` (built at first
    use) on the current stream, one CTA a split of ``uniform_grid`` (the
    pool's and the window's capacity), those past the live splits exiting
    unread, with the stream's split scratch and merge counters
    (``_split_scratch``, ``_split_counters``; the window probabilities' raw
    scores go in the scratch too).  CPU tensors run the plain version.  A
    CUDA request the kernel cannot serve raises; nothing falls back."""
    BH, G, mc, W = _check_decode(q, kv_pool, kv_scales, k_win, v_win, li, codec,
                                 "fused_q_decode_attention")
    check_window(window)
    nc_t, wl_t = device_counts(q, n_chunks, win_len, mc, W)
    if q.device.type == "cpu":
        return fused_q_decode_attention_plain(q, kv_pool, kv_scales, k_win, v_win,
                                              nc_t, wl_t, li, codec,
                                              return_win_probs, return_norm, window)
    n_splits = uniform_grid(mc, W)
    split_scratch_floats(BH, n_splits, G)        # a grid too large: refused up front
    stream = _stream(q)
    _check_aligned((("q", q), ("kv_pool", kv_pool), ("kv_scales", kv_scales),
                    ("k_win", k_win), ("v_win", v_win)))
    fn = _library("q_decode", "q_decode_attention", 12, 13)
    out = torch.empty_like(q)
    probs = win_probs_out(q, BH, W, return_win_probs)
    ml = norm_out(q, BH, return_norm)
    qb = q.to(torch.bfloat16)
    scratch = _split_scratch(BH, n_splits, G, q.device, stream,
                             BH * G * W if return_win_probs else 0)
    counters = _split_counters(BH, q.device, stream)
    rc = fn(qb.data_ptr(), kv_pool.data_ptr(), kv_scales.data_ptr(),
            k_win.data_ptr(), v_win.data_ptr(), nc_t.data_ptr(), wl_t.data_ptr(),
            out.data_ptr(), _ptr(probs), _ptr(ml), scratch.data_ptr(), counters.data_ptr(),
            scratch.numel(), counters.numel(), int(out.dtype == torch.float32),
            q.device.index or 0, codec.kbits, codec.vbits, BH, G, mc, W, window_tile(W), li,
            window or 0, stream)
    if rc != 0:
        raise RuntimeError(f"q_decode_attention launch failed: CUDA error {rc}")
    fused_q_decode_attention.launches += 1
    return uniform_result(out, ml, probs, return_norm, return_win_probs)


fused_q_decode_attention.launches = 0


# ---------------------------------------------------------------------------
# Per-slot decode (continuous batching)
# ---------------------------------------------------------------------------

def per_slot_plain(uniform, q, BH: int, n_chunks, win_len, mc: int, W: int,
                   win_probs: bool):
    """A per-slot plain version from the uniform one: ``uniform(b, hs, nc,
    wl)`` runs slot b (its kv heads ``hs``) at its own clamped counts
    (``slots``) with ``win_probs`` (and a sliding window's edge at those
    counts); the slots' outputs (and window probabilities) concatenated."""
    res = [uniform(b, hs, nc, wl) for b, hs, nc, wl in
           slots(q.shape[0], BH, n_chunks, win_len, mc, W)]
    if not win_probs:
        return torch.cat(res)
    return torch.cat([r[0] for r in res]), torch.cat([r[1] for r in res])


def fused_q_decode_attention_ps_plain(q, kv_pool, kv_scales, k_win, v_win,
                                      n_chunks, win_len, li: int,
                                      codec: qf.QuantCodec, win_probs: bool = False,
                                      window=None):
    """The per-slot kernel's arithmetic: slot b is the uniform computation
    over its own ``n_chunks[b]`` chunks and ``win_len[b]`` window tokens
    (clamped, ``slots``), with a sliding ``window``'s edge at those counts.
    (The TPU kernel loops a block of heads to the largest counts among
    them; the extra steps are fully masked and add exactly zero to a head
    with something to attend, so looping over a slot's own counts is the
    same.)  A slot with nothing to attend comes out 0, and so do its window
    probabilities (``win_probs``)."""
    return per_slot_plain(
        lambda b, hs, nc, wl: fused_q_decode_attention_plain(
            q[b:b + 1], kv_pool[:, :, hs], kv_scales[:, :, hs], k_win[:, hs],
            v_win[:, hs], nc, wl, li, codec, win_probs, window=window),
        q, kv_pool.shape[2], n_chunks, win_len, kv_pool.shape[1], k_win.shape[2],
        win_probs)


def fused_q_decode_attention_ps_split_plain(q, kv_pool, kv_scales, k_win, v_win,
                                            n_chunks, win_len, li: int,
                                            codec: qf.QuantCodec, win_probs: bool = False,
                                            window=None):
    """The per-slot CUDA kernel's arithmetic (``ps_split_steps`` with the
    codec's chunk step): each chunk (past its slot's window edge) and each
    window tile of a slot one split from a fresh softmax state, merged in
    split order; with ``win_probs`` also the window probabilities on the
    merge's stats."""
    return ps_split_steps(
        q, kv_pool.shape[2], n_chunks, win_len, kv_pool.shape[1],
        lambda hs: _q_chunk_step(kv_pool[:, :, hs], kv_scales[:, :, hs], li, codec),
        k_win, v_win, li, win_probs=win_probs, window=window)


def per_slot_probs_scratch(BH: int, G: int, W: int, want: bool) -> int:
    """Floats a per-slot call's window probabilities add to its split
    scratch (``csrc/split_merge.cuh`` ``slot_probs_floats``): the raw window
    scores [BH, G, W] and the merge's final stats [2, BH*G]."""
    return BH * G * W + 2 * BH * G if want else 0


def fused_q_decode_attention_ps(q, kv_pool, kv_scales, k_win, v_win,
                                n_chunks: torch.Tensor, win_len: torch.Tensor,
                                li: int, codec: qf.QuantCodec, *, window=None,
                                return_win_probs: bool = False):
    """Per-slot quant-codec flash-decode of layer ``li``: slot b attends its first
    ``n_chunks[b]`` pool chunks and ``win_len[b]`` window tokens ->
    [B, 1, Hq, 128] in q's dtype.

    ``n_chunks`` and ``win_len`` are int32 tensors [B] on q's device; the
    kernel reads its own slot's counts, so a decode step never syncs with
    the host to size itself.  Counts it cannot check without a sync are
    clamped in the kernel to [0, mc] and [0, W]; an idle slot is passed as
    (0, 0) and comes out 0.  With a sliding ``window`` (an int >= 1) slot b
    attends only the pool columns past its own ``window_low`` (module
    note).  With ``return_win_probs`` also the window probabilities [B,
    Hkv, W] f32 (``fused_q_decode_attention``), each slot's zero at and
    past its own ``win_len``, an idle slot's all zero.

    CUDA tensors launch the kernels of ``csrc/q_decode_ps.cu`` (built at
    first use: the split kernel, then its merge, then with
    ``return_win_probs`` the probabilities from the merge's stats) on the
    current stream, with the stream's split scratch (``_split_scratch``;
    the window scores and stats after the partials); the grid is sized from
    mc and W, and a split below its slot's window edge exits unread.  CPU
    tensors run the plain version.  A CUDA request the kernel cannot serve
    raises; nothing falls back."""
    BH, G, mc, W = _check_decode(q, kv_pool, kv_scales, k_win, v_win, li, codec,
                                 "fused_q_decode_attention_ps")
    check_window(window)
    B = q.shape[0]
    for name, t in (("n_chunks", n_chunks), ("win_len", win_len)):
        if not torch.is_tensor(t) or tuple(t.shape) != (B,):
            raise ValueError(f"{name} must be a tensor [{B}], got {t!r}")
    _check_tensors(q, (("n_chunks", n_chunks, torch.int32),
                       ("win_len", win_len, torch.int32)))
    if q.device.type == "cpu":
        return fused_q_decode_attention_ps_plain(q, kv_pool, kv_scales, k_win, v_win,
                                                 n_chunks, win_len, li, codec,
                                                 return_win_probs, window)
    n_splits = ps_splits(mc, W)
    split_scratch_floats(BH, n_splits, G)        # a grid too large: refused up front
    stream = _stream(q)
    _check_aligned((("q", q), ("kv_pool", kv_pool), ("kv_scales", kv_scales),
                    ("k_win", k_win), ("v_win", v_win)))
    fn = _library("q_decode_ps", "q_decode_attention_ps", 10, 14)
    out = torch.empty_like(q)
    probs = win_probs_out(q, BH, W, return_win_probs)
    qb = q.to(torch.bfloat16)
    scratch = _split_scratch(BH, n_splits, G, q.device, stream,
                             per_slot_probs_scratch(BH, G, W, return_win_probs))
    rc = fn(qb.data_ptr(), kv_pool.data_ptr(), kv_scales.data_ptr(),
            k_win.data_ptr(), v_win.data_ptr(), n_chunks.data_ptr(),
            win_len.data_ptr(), out.data_ptr(), _ptr(probs), scratch.data_ptr(),
            scratch.numel(), int(out.dtype == torch.float32), q.device.index or 0,
            codec.kbits, codec.vbits, BH, BH // B, G, mc, W, window_tile(W), li, n_splits,
            window or 0, stream)
    if rc != 0:
        raise RuntimeError(f"q_decode_attention_ps launch failed: CUDA error {rc}")
    fused_q_decode_attention_ps.launches += 1
    return (out, probs) if return_win_probs else out


fused_q_decode_attention_ps.launches = 0


# ---------------------------------------------------------------------------
# Segment partials over the pools (chunked prefill)
# ---------------------------------------------------------------------------

def segment_counts(n_chunks, seg_start, mc: int, device):
    """A segment's counts as the plain versions read them: int64 tensors
    [1] on ``device``, n_chunks clamped into [0, mc] and seg_start to 0 up,
    as the kernels clamp what they read; no host read."""
    nc, start = (device_int(x, device).reshape(1) for x in (n_chunks, seg_start))
    return nc.clamp(0, mc), start.clamp_min(0)


def segment_device_counts(q_seg, n_chunks, seg_start, mc: int, chunk: int = 256):
    """The segment kernels' counts as they read them: int32 tensors of one
    element on q_seg's device (``device_counts``).  A tensor is taken as it
    is (the kernel clamps it); a host int is checked (n_chunks in [0, mc],
    seg_start at or past the n_chunks packed chunks where both are host
    ints) and filled into one."""
    out = []
    for name, n in (("n_chunks", n_chunks), ("seg_start", seg_start)):
        if torch.is_tensor(n):
            if n.numel() != 1 or n.dtype != torch.int32 or not n.is_contiguous():
                raise ValueError(f"{name} must be an int or a contiguous int32 tensor of "
                                 f"one element, got {n.dtype} {tuple(n.shape)}")
            if n.device != q_seg.device:
                raise ValueError(f"{name} is on {n.device}, q_seg on {q_seg.device}")
        else:
            _check_int(name, n, 0, mc if name == "n_chunks" else INT_MAX)
            n = torch.full((1,), n, dtype=torch.int32, device=q_seg.device)
        out.append(n)
    if not torch.is_tensor(n_chunks) and not torch.is_tensor(seg_start) \
            and seg_start < n_chunks * chunk:
        raise ValueError(f"seg_start must be at or past the {n_chunks} packed chunks, "
                         f"got {seg_start}")
    return out


def fused_q_segment_attention_plain(q_seg, kv_pool, kv_scales, n_chunks, li: int,
                                    codec: qf.QuantCodec, seg_start=0, window=None):
    """The segment kernel's arithmetic (``segment_steps`` with the codec's
    chunk step: scores bf16(bf16(q) * kscale) . codes / sqrt(128), the V
    scale after the value product), over the pool's mc chunks, at counts
    given as the kernel takes them or as host ints."""
    return segment_steps(q_seg, kv_pool.shape[2], kv_pool.shape[1], n_chunks,
                         _q_chunk_step(kv_pool, kv_scales, li, codec), seg_start, window)


def fused_q_segment_attention(q_seg, kv_pool, kv_scales, n_chunks, seg_start, li: int,
                              codec: qf.QuantCodec, *, window=None):
    """Flash partials of a chunked-prefill segment over layer ``li``'s first
    ``n_chunks`` pool chunks: (acc [B,Tseg,Hq,128] f32, m, l [B,Tseg,Hq,1]
    f32), unnormalised; ``ops.attention.merge_partials`` merges them with
    the window and causal-self partials.  ``n_chunks`` is uniform across the
    batch (chunked prefill advances every row in lockstep); ``seg_start`` is
    the segment's first position, at or past the packed chunks.  With a
    sliding ``window`` (an int >= 1) the row of token t sees only the pool
    columns past seg_start + t - window (``segment_steps``); a row with none
    comes out with m = -1e30 and finite l and acc, weighed 0 by the merge.

    ``n_chunks`` and ``seg_start`` are the TPU kernel's scalar-prefetch
    counts: int32 tensors of one element on q_seg's device, which the kernel
    reads (clamped into [0, mc] and to 0 up), or host ints (checked, and
    filled into such tensors: ``segment_device_counts``).  Nothing here
    reads them, so a call holds no host value and a CUDA graph replays it at
    every segment.

    CUDA tensors launch the kernel of ``csrc/q_segment.cu`` (built at first
    use) on the current stream, whose CTAs leave out the chunks dead for
    their oldest row (``segment_first_chunk``); at no chunk it still
    launches.  CPU tensors run the plain version.  A CUDA request the
    kernel cannot serve raises; nothing falls back."""
    _check_codec(codec, "fused_q_segment_attention")
    check_window(window)
    if q_seg.dim() != 4 or q_seg.shape[3] != 128 or q_seg.shape[1] < 1:
        raise ValueError(f"q_seg must be [B, Tseg, Hq, 128], got {tuple(q_seg.shape)}")
    B, T, Hq, _ = q_seg.shape
    L, mc, BH, Hkv = _check_pool(kv_pool, kv_scales, codec, B)
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} kv heads")
    _check_tensors(q_seg, (("q_seg", q_seg, q_seg.dtype),
                           ("kv_pool", kv_pool, torch.int16),
                           ("kv_scales", kv_scales, torch.bfloat16)))
    _check_int("li", li, 0, L - 1)
    nc_t, start_t = segment_device_counts(q_seg, n_chunks, seg_start, mc, codec.chunk)
    if q_seg.device.type == "cpu":
        return fused_q_segment_attention_plain(q_seg, kv_pool, kv_scales, nc_t, li, codec,
                                               start_t, window)
    stream = _stream(q_seg)
    _check_aligned((("q_seg", q_seg), ("kv_pool", kv_pool), ("kv_scales", kv_scales)))
    fn = _library("q_segment", "q_segment_attention", 8, 10)
    dev = q_seg.device
    acc = torch.empty((B, T, Hq, 128), dtype=torch.float32, device=dev)
    m = torch.empty((B, T, Hq, 1), dtype=torch.float32, device=dev)
    l = torch.empty((B, T, Hq, 1), dtype=torch.float32, device=dev)
    qb = q_seg.to(torch.bfloat16)
    rc = fn(qb.data_ptr(), kv_pool.data_ptr(), kv_scales.data_ptr(),
            acc.data_ptr(), m.data_ptr(), l.data_ptr(), nc_t.data_ptr(), start_t.data_ptr(),
            dev.index or 0, codec.kbits, codec.vbits, BH, Hkv, Hq // Hkv, T, mc, li,
            window or 0, stream)
    if rc != 0:
        raise RuntimeError(f"q_segment_attention launch failed: CUDA error {rc}")
    fused_q_segment_attention.launches += 1
    return acc, m, l


fused_q_segment_attention.launches = 0
