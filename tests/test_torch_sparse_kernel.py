"""Port parity, the bitmap kernel module (``ops/kernels/sparse_attention.py``).

(p) The plain versions of ``fused_sparse_decode_attention`` (TPU kernel
    v7), ``fused_sparse_decode_attention_ps`` (v6ps, per-slot counts) and
    ``fused_sparse_segment_attention`` (chunked-prefill partials) against
    the JAX kernels run in Pallas interpret mode, on the same stacked int16
    pools of real packed chunks (random bf16 K and V pruned and encoded by
    the JAX codec) and bf16 windows, at sparsity 0.7 and 0.5 (pads).
(p8) The same at ``qbits=8`` (codec bitmap-q8): pools of int8 codes packed
    by the JAX codec and their bf16 scales, which the kernels fold into q
    and the value product.
(s) The per-slot CUDA kernel's split arithmetic
    (``fused_sparse_decode_attention_ps_split_plain``: partials of single
    chunks and single window tiles from fresh softmax states, merged in
    split order) against the same JAX kernel and against the TPU-order
    plain version, at 16 and 8 bits, groups 1 and 4, f32 and bf16 q, with
    slots that have chunks but no window, a window but no chunks, and none.
(u) The uniform CUDA kernel's split arithmetic
    (``fused_sparse_decode_attention_split_plain``: each chunk cut into
    ``CHUNK_CUT`` runs of 64 tokens and each window tile one step from a
    fresh softmax state, merged in split order, the scores summed in the
    kernels' fixed order) against JAX's v7 and the TPU-order plain version,
    at 16 and 8 bits, groups 1, 2, 4 and 8, f32 and bf16 q, at the
    (n_chunks, win_len) cases of ``chip_smoke.py``'s ``phase_kernel``.
(q) The wrappers refuse what the CUDA kernels cannot serve (the sliding
    window, softmax stats and window probabilities, scales without
    ``qbits=8`` chunks or ``qbits=8`` chunks without scales, bad shapes,
    types and devices) instead of falling back, and on the CPU nothing
    launches.
The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
them against the plain versions there.

Tolerances: the plain versions take the TPU kernels' arithmetic and softmax
steps; f32 sums run in another order, which can move a bf16(p) or the bf16
output by one ulp: 2^-8 of the output's largest magnitude (per slot for
the per-slot kernel); the segment partials m to rtol 1e-6, l to 1e-5.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mustafar_tpu.ops import sparse_format as jsf
from mustafar_tpu.ops.kernels import sparse_attention as jska
from mustafar_tpu_torch.ops import sparse_format as tsf
from mustafar_tpu_torch.ops.kernels import quant_attention as tqa
from mustafar_tpu_torch.ops.kernels import sparse_attention as tska

torch.set_num_threads(2)

W = 288                                   # residual 32 + chunk 256
ULP = 2.0 ** -8


def _fmts(sparsity, qbits=16):
    keep = 128 - int(sparsity * 128) + 1
    return (jsf.ChunkFormat(256, 128, keep, qbits=qbits),
            tsf.ChunkFormat(256, 128, keep, qbits=qbits))


def _inputs(seed, L, mc, B, Hkv, G, sparsity, qbits=16):
    """Stacked bitmap pool of real packed chunks (K stream, then V stream),
    bf16 windows and a bf16 q, as float32 / int16 numpy arrays; with
    ``qbits=8`` also the scales [L, mc, BH, 2, 128] (bf16 values as f32)."""
    jf, _ = _fmts(sparsity, qbits)
    rs = np.random.RandomState(seed)
    BH = B * Hkv
    x = jnp.asarray(rs.randn(L, mc, 2, BH, 256, 128) * 0.5, jnp.bfloat16)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)).astype(np.float32)
    if qbits == 8:
        rows, scales = jax.jit(lambda a: jsf.prune_and_encode_stream_q8(a, jf))(x)
        rows, scales = np.asarray(rows), bf(np.moveaxis(np.asarray(scales), 2, 3))
    else:
        rows = np.asarray(jax.jit(lambda a: jsf.prune_and_encode_stream(a, jf))(x))
    pool = np.concatenate([rows[:, :, 0], rows[:, :, 1]], axis=-2)
    k_win = bf(rs.randn(L, BH, W, 128))
    v_win = bf(rs.randn(L, BH, W, 128))
    q = bf(rs.randn(B, 1, Hkv * G, 128))
    if qbits == 8:
        return q, pool, scales, k_win, v_win
    return q, pool, k_win, v_win


def _jscales(scales):
    """[L, mc, BH, 2, 128] -> the JAX kernels' kscales, vscales (bf16)."""
    return {"kscales": jnp.asarray(scales[..., 0, :], jnp.bfloat16),
            "vscales": jnp.asarray(scales[..., 1, :], jnp.bfloat16)}


def _t(a, dtype=torch.bfloat16):
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("G,sparsity", [(1, 0.7), (4, 0.7), (8, 0.5)])
def test_decode_plain_matches_jax_kernel(G, sparsity):
    """n_chunks 0, 1 and 3 (= mc); window lengths 0 (with chunks), 1, 44 and
    the full 288; layers 0 and 1 of L = 2; nothing to attend gives 0."""
    jf, tf = _fmts(sparsity)
    q, pool, k_win, v_win = _inputs(10 + G, 2, 3, 2, 2, G, sparsity)
    jargs = (jnp.asarray(q, jnp.bfloat16), jnp.asarray(pool),
             jnp.asarray(k_win, jnp.bfloat16), jnp.asarray(v_win, jnp.bfloat16))
    targs = (_t(q), torch.from_numpy(pool), _t(k_win), _t(v_win))
    before = tska.fused_sparse_decode_attention.launches
    for nc, wl, li in [(0, 44, 1), (1, 0, 0), (1, 288, 1), (3, 1, 0), (3, 288, 1)]:
        jo = np.asarray(jska.fused_sparse_decode_attention_v7(
            *jargs, jnp.int32(nc), jnp.int32(wl), jf, jf, 3,
            li=jnp.int32(li))).astype(np.float32)
        to = tska.fused_sparse_decode_attention(*targs, nc, wl, li, tf, tf)
        assert to.dtype == torch.bfloat16 and to.shape == (2, 1, 2 * G, 128)
        np.testing.assert_allclose(to.float().numpy(), jo, rtol=0,
                                   atol=ULP * np.abs(jo).max(),
                                   err_msg=f"nc={nc} wl={wl} li={li}")
    assert (tska.fused_sparse_decode_attention(*targs, 0, 0, 0, tf, tf) == 0).all()
    assert tska.fused_sparse_decode_attention.launches == before   # CPU: no launch


@pytest.mark.parametrize("G,q_dtype,sparsity", [(2, "bfloat16", 0.7),
                                                (4, "float32", 0.7),
                                                (4, "bfloat16", 0.5)])
def test_ps_plain_matches_jax_kernel(G, q_dtype, sparsity):
    """Mixed slots in one call: n_chunks 0/1/3 and win_len 0/1/44/288, and
    an idle slot (0, 0), which must come out exactly 0 while every live slot
    is non-zero; the TPU kernel's block loops every head to the largest
    counts, and parity is owed on slots with something to attend."""
    jf, tf = _fmts(sparsity)
    q, pool, k_win, v_win = _inputs(20 + G, 2, 3, 6, 1, G, sparsity)
    nc = [0, 1, 3, 1, 3, 0]
    wl = [1, 44, 288, 0, 1, 0]
    tq = torch.from_numpy(q) if q_dtype == "float32" else _t(q)
    before = tska.fused_sparse_decode_attention_ps.launches
    for li in (0, 1):
        jo = np.asarray(jska.fused_sparse_decode_attention_v6ps(
            jnp.asarray(q, getattr(jnp, q_dtype)), jnp.asarray(pool),
            jnp.asarray(k_win, jnp.bfloat16), jnp.asarray(v_win, jnp.bfloat16),
            jnp.asarray(nc, jnp.int32), jnp.asarray(wl, jnp.int32), jf, jf, 3,
            li=jnp.int32(li))).astype(np.float32)
        to = tska.fused_sparse_decode_attention_ps(
            tq, torch.from_numpy(pool), _t(k_win), _t(v_win),
            torch.tensor(nc, dtype=torch.int32), torch.tensor(wl, dtype=torch.int32),
            li, tf, tf)
        assert to.dtype == tq.dtype
        to = to.float().numpy()
        for b in range(6):
            if not (nc[b] or wl[b]):
                assert (to[b] == 0).all(), f"idle slot {b}, li={li}"
                continue
            assert np.abs(to[b]).max() > 0, f"live slot {b} written as 0, li={li}"
            np.testing.assert_allclose(to[b], jo[b], rtol=0,
                                       atol=ULP * np.abs(jo[b]).max(),
                                       err_msg=f"slot {b}, li={li}")
    assert tska.fused_sparse_decode_attention_ps.launches == before


SPLIT_NC = [0, 1, 3, 2, 3, 0]
SPLIT_WL = [1, 44, 288, 0, 1, 0]


@functools.lru_cache(maxsize=None)
def _split_case(qbits, G):
    """Per-slot inputs (6 slots of one kv head, mc=3, layer 1) and JAX's
    v6ps output on them (f32 q), once a value width and group."""
    jf, tf = _fmts(0.7, qbits)
    ins = _inputs(70 + qbits + G, 2, 3, 6, 1, G, 0.7, qbits)
    q, pool, k_win, v_win = ins[0], ins[1], ins[-2], ins[-1]
    scales = ins[2] if qbits == 8 else None
    jo = np.asarray(jska.fused_sparse_decode_attention_v6ps(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(k_win, jnp.bfloat16),
        jnp.asarray(v_win, jnp.bfloat16), jnp.asarray(SPLIT_NC, jnp.int32),
        jnp.asarray(SPLIT_WL, jnp.int32), jf, jf, 3, li=jnp.int32(1),
        **(_jscales(scales) if qbits == 8 else {})))
    targs = (torch.from_numpy(pool), _t(k_win), _t(v_win),
             torch.tensor(SPLIT_NC, dtype=torch.int32),
             torch.tensor(SPLIT_WL, dtype=torch.int32), 1, tf, tf,
             None if scales is None else _t(scales))
    return q, targs, jo


@pytest.mark.parametrize("qbits", [16, 8])
@pytest.mark.parametrize("G", [1, 4])
def test_ps_split_plain_matches_jax_kernel(G, qbits):
    """The kernel's splits: one a chunk (3 splits at 3 chunks, 2 at 2, 1 at
    1), one a window tile (3 at 288 tokens, 1 at 44 and at 1); slots with
    chunks and no window, a window and no chunks, both, and none.  Held to
    JAX's v6ps at the file's tolerance and to the TPU-order plain version at
    2 bf16 ulps, slot by slot; the idle slot comes out exactly 0, a bf16 q
    gives the f32 q's output rounded."""
    q, targs, jo = _split_case(qbits, G)
    got = tska.fused_sparse_decode_attention_ps_split_plain(torch.from_numpy(q), *targs)
    assert got.dtype == torch.float32
    tpu = tska.fused_sparse_decode_attention_ps_plain(torch.from_numpy(q), *targs).numpy()
    got = got.numpy()
    for b in range(6):
        if not (SPLIT_NC[b] or SPLIT_WL[b]):
            assert (got[b] == 0).all(), f"idle slot {b}"
            continue
        assert np.abs(got[b]).max() > 0, f"live slot {b} written as 0"
        np.testing.assert_allclose(got[b], jo[b], rtol=0, atol=ULP * np.abs(jo[b]).max(),
                                   err_msg=f"slot {b} against JAX")
        np.testing.assert_allclose(got[b], tpu[b], rtol=0,
                                   atol=2 * ULP * np.abs(tpu[b]).max(),
                                   err_msg=f"slot {b} against the TPU order")
    got16 = tska.fused_sparse_decode_attention_ps_split_plain(_t(q), *targs)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_array_equal(got16.float().numpy(),
                                  torch.from_numpy(got).to(torch.bfloat16).float().numpy())


def test_ps_splits_of_the_grid():
    """A row of the per-slot grid: one split a pool chunk, then one a window
    tile (96 tokens at W=288, 40 at W=40 and at W=200)."""
    assert tska.ps_splits(32, 288) == 32 + 3
    assert tska.ps_splits(5, 40) == 5 + 1
    assert tska.ps_splits(3, 200) == 3 + 5


def test_segment_grid_pads_row_tiles_to_the_cluster():
    """The segment kernel's grid along a kv head's T*G query rows: tiles of
    128 rows in thread block clusters of a power of two up to 8 that
    covers them (Llama-3-8B's T=256, G=4: one cluster of 8), the tiles
    padded to a multiple of the cluster, no cluster wholly padding."""
    assert tska.segment_grid(256, 4) == (8, 8)
    assert tska.segment_grid(256, 1) == (2, 2)
    assert tska.segment_grid(256, 2) == (4, 4)
    assert tska.segment_grid(256, 8) == (8, 16)
    assert tska.segment_grid(96, 4) == (4, 4)        # 3 tiles, one padding
    assert tska.segment_grid(288, 4) == (8, 16)      # 9 tiles, 7 padding
    assert tska.segment_grid(1, 1) == (1, 1)
    for T in range(1, 700, 3):
        for G in (1, 2, 4, 8):
            cluster, tiles = tska.segment_grid(T, G)
            assert cluster in (1, 2, 4, 8) and tiles % cluster == 0, (T, G)
            assert tiles * 128 >= T * G > (tiles - cluster) * 128, (T, G)


def test_ps_plain_equals_uniform_per_slot():
    """Slot b of the per-slot version is the uniform computation over its
    own counts; counts out of range are clamped as the kernel clamps them."""
    _, tf = _fmts(0.7)
    q, pool, k_win, v_win = _inputs(5, 2, 3, 3, 2, 2, 0.7)
    tq, tp, tk, tv = _t(q), torch.from_numpy(pool), _t(k_win), _t(v_win)
    got = tska.fused_sparse_decode_attention_ps(
        tq, tp, tk, tv, torch.tensor([2, 9, 1], dtype=torch.int32),
        torch.tensor([100, 288, -300], dtype=torch.int32), 1, tf, tf)
    for b, (c, w) in enumerate(((2, 100), (3, 288), (1, 0))):
        hs = slice(2 * b, 2 * b + 2)
        want = tska.fused_sparse_decode_attention(
            tq[b:b + 1], tp[:, :, hs].contiguous(), tk[:, hs].contiguous(),
            tv[:, hs].contiguous(), c, w, 1, tf, tf)
        np.testing.assert_array_equal(got[b:b + 1].float().numpy(), want.float().numpy())


@pytest.mark.parametrize("nc,seg_start,sparsity", [(0, 256, 0.7), (1, 512, 0.7),
                                                   (3, 768, 0.7), (3, 1024, 0.5)])
def test_segment_plain_matches_jax_kernel(nc, seg_start, sparsity):
    """acc, m and l of one 256-row segment (B=2, Hkv=2, G=2) over nc chunks
    of layer 1; with no chunk, m is exactly -1e30 and l exactly 0."""
    jf, tf = _fmts(sparsity)
    _, pool, _, _ = _inputs(30 + nc, 2, 3, 2, 2, 2, sparsity)
    qs = np.asarray(jnp.asarray(np.random.RandomState(nc + seg_start)
                                .randn(2, 256, 4, 128), jnp.bfloat16)).astype(np.float32)
    ja, jm, jl = (np.asarray(x) for x in jska.fused_sparse_segment_attention(
        jnp.asarray(qs, jnp.bfloat16), jnp.asarray(pool), jnp.int32(nc),
        jnp.int32(seg_start), jf, jf, 3, li=jnp.int32(1)))
    before = tska.fused_sparse_segment_attention.launches
    ta, tm, tl = (x.numpy() for x in tska.fused_sparse_segment_attention(
        _t(qs), torch.from_numpy(pool), nc, seg_start, 1, tf, tf))
    assert tska.fused_sparse_segment_attention.launches == before
    assert ta.shape == ja.shape == (2, 256, 4, 128) and tm.shape == tl.shape == (2, 256, 4, 1)
    if nc == 0:
        assert (tm == -1e30).all() and (tl == 0).all() and (ta == 0).all()
        assert (jm == -1e30).all() and (jl == 0).all()
        return
    np.testing.assert_allclose(tm, jm, rtol=1e-6, atol=0)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    np.testing.assert_allclose(ta, ja, rtol=0, atol=ULP * np.abs(ja).max())


@pytest.mark.parametrize("G,sparsity", [(4, 0.7), (8, 0.5)])
def test_decode_plain_matches_jax_kernel_q8(G, sparsity):
    """``qbits=8``: the uniform decode's plain version against JAX's v7 with
    kscales / vscales, n_chunks 0, 1 and 3 with windows 0-288."""
    jf, tf = _fmts(sparsity, 8)
    q, pool, scales, k_win, v_win = _inputs(40 + G, 2, 3, 2, 2, G, sparsity, 8)
    jargs = (jnp.asarray(q, jnp.bfloat16), jnp.asarray(pool),
             jnp.asarray(k_win, jnp.bfloat16), jnp.asarray(v_win, jnp.bfloat16))
    targs = (_t(q), torch.from_numpy(pool), _t(k_win), _t(v_win))
    for nc, wl, li in [(0, 44, 1), (1, 0, 0), (3, 1, 0), (3, 288, 1)]:
        jo = np.asarray(jska.fused_sparse_decode_attention_v7(
            *jargs, jnp.int32(nc), jnp.int32(wl), jf, jf, 3, li=jnp.int32(li),
            **_jscales(scales))).astype(np.float32)
        to = tska.fused_sparse_decode_attention(*targs, nc, wl, li, tf, tf,
                                                kv_scales=_t(scales))
        assert to.dtype == torch.bfloat16 and to.shape == (2, 1, 2 * G, 128)
        np.testing.assert_allclose(to.float().numpy(), jo, rtol=0,
                                   atol=ULP * np.abs(jo).max(),
                                   err_msg=f"nc={nc} wl={wl} li={li}")
    assert tska.fused_sparse_decode_attention.launches == 0


def test_ps_plain_matches_jax_kernel_q8():
    """``qbits=8``: per-slot decode against JAX's v6ps with scales, mixed
    slots and an idle one (exactly 0), f32 q."""
    jf, tf = _fmts(0.7, 8)
    q, pool, scales, k_win, v_win = _inputs(50, 2, 3, 6, 1, 2, 0.7, 8)
    nc = [0, 1, 3, 1, 3, 0]
    wl = [1, 44, 288, 0, 1, 0]
    jo = np.asarray(jska.fused_sparse_decode_attention_v6ps(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(k_win, jnp.bfloat16),
        jnp.asarray(v_win, jnp.bfloat16), jnp.asarray(nc, jnp.int32),
        jnp.asarray(wl, jnp.int32), jf, jf, 3, li=jnp.int32(1), **_jscales(scales)))
    to = tska.fused_sparse_decode_attention_ps(
        torch.from_numpy(q), torch.from_numpy(pool), _t(k_win), _t(v_win),
        torch.tensor(nc, dtype=torch.int32), torch.tensor(wl, dtype=torch.int32), 1,
        tf, tf, kv_scales=_t(scales)).numpy()
    for b in range(6):
        if not (nc[b] or wl[b]):
            assert (to[b] == 0).all(), f"idle slot {b}"
            continue
        np.testing.assert_allclose(to[b], jo[b], rtol=0, atol=ULP * np.abs(jo[b]).max(),
                                   err_msg=f"slot {b}")
    assert tska.fused_sparse_decode_attention_ps.launches == 0


@pytest.mark.parametrize("nc,seg_start,sparsity", [(1, 512, 0.7), (3, 1024, 0.5)])
def test_segment_plain_matches_jax_kernel_q8(nc, seg_start, sparsity):
    """``qbits=8``: segment partials against JAX's segment kernel with
    scales (B=2, Hkv=2, G=2, layer 1)."""
    jf, tf = _fmts(sparsity, 8)
    _, pool, scales, _, _ = _inputs(60 + nc, 2, 3, 2, 2, 2, sparsity, 8)
    qs = np.asarray(jnp.asarray(np.random.RandomState(nc).randn(2, 256, 4, 128),
                                jnp.bfloat16)).astype(np.float32)
    ja, jm, jl = (np.asarray(x) for x in jska.fused_sparse_segment_attention(
        jnp.asarray(qs, jnp.bfloat16), jnp.asarray(pool), jnp.int32(nc),
        jnp.int32(seg_start), jf, jf, 3, li=jnp.int32(1), **_jscales(scales)))
    ta, tm, tl = (x.numpy() for x in tska.fused_sparse_segment_attention(
        _t(qs), torch.from_numpy(pool), nc, seg_start, 1, tf, tf, kv_scales=_t(scales)))
    assert tska.fused_sparse_segment_attention.launches == 0
    np.testing.assert_allclose(tm, jm, rtol=1e-6, atol=0)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    np.testing.assert_allclose(ta, ja, rtol=0, atol=ULP * np.abs(ja).max())


def test_wrappers_refuse_what_the_kernels_cannot_serve():
    _, tf = _fmts(0.7)
    _, tf5 = _fmts(0.5)
    q, pool, k_win, v_win = _inputs(4, 1, 2, 2, 2, 4, 0.7)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32)
    dec = dict(q=_t(q), kv_pool=torch.from_numpy(pool), k_win=_t(k_win),
               v_win=_t(v_win), n_chunks=1, win_len=10, li=0, kfmt=tf, vfmt=tf)
    ps = dict(dec, n_chunks=i32([1, 0]), win_len=i32([10, 3]))
    seg = dict(q_seg=_t(np.zeros((2, 256, 8, 128), np.float32)),
               kv_pool=torch.from_numpy(pool), n_chunks=1, seg_start=512, li=0,
               kfmt=tf, vfmt=tf)
    calls = ((tska.fused_sparse_decode_attention, dec),
             (tska.fused_sparse_decode_attention_ps, ps),
             (tska.fused_sparse_segment_attention, seg))
    for fn, ok in calls:
        fn(**ok)
        bad = [dict(kfmt=tf5), dict(kfmt=tsf.ChunkFormat(128, 128, 40)),
               dict(kv_pool=torch.from_numpy(pool).to(torch.int32)), dict(li=1)]
        if fn is tska.fused_sparse_decode_attention:
            bad += [dict(n_chunks=3), dict(win_len=W + 1), dict(n_chunks=1.0),
                    dict(k_win=_t(k_win).float()),
                    dict(q=_t(np.zeros((2, 1, 6, 128), np.float32)))]   # G = 3
        if fn is tska.fused_sparse_decode_attention_ps:
            bad += [dict(n_chunks=1), dict(win_len=i32([10])),
                    dict(n_chunks=torch.tensor([1, 0]))]                 # int64
        if fn is tska.fused_sparse_segment_attention:
            bad += [dict(n_chunks=3), dict(seg_start=128),
                    dict(q_seg=_t(np.zeros((2, 256, 3, 128), np.float32)))]
        for change in bad:
            with pytest.raises((ValueError, TypeError, NotImplementedError)):
                fn(**dict(ok, **change))
        # every kernel serves the sliding window (its CPU path the plain
        # version): 512 (768 at the segment's positions 512-767) covers every
        # column; at the decodes 100 drops 166 of
        # slot 0's (the per-slot call's slot 1 has no chunk), at the segment
        # 300 leaves no pool column to the rows of tokens 43 on
        if fn is tska.fused_sparse_segment_attention:
            assert all(torch.equal(a, b) for a, b in zip(fn(**ok, window=768), fn(**ok)))
            m_win = fn(**ok, window=300)[1]
            assert (m_win[:, 43:] == -1e30).all() and (m_win[:, :43] > -1e30).all()
        else:
            assert torch.equal(fn(**ok, window=512), fn(**ok))
            windowed = fn(**ok, window=100)
            assert torch.isfinite(windowed).all()
            assert not torch.equal(windowed[0], fn(**ok)[0])
            if fn is tska.fused_sparse_decode_attention_ps:
                assert torch.equal(windowed[1], fn(**ok)[1])
        with pytest.raises(ValueError, match="window"):
            fn(**ok, window=0)
        # a device the kernel does not run on is refused, never computed on the CPU
        meta = {k: (v.to("meta") if torch.is_tensor(v) else v) for k, v in ok.items()}
        with pytest.raises(ValueError):
            fn(**meta)
    # the final (m, l) and the window probabilities are served: the output is
    # the call's without them
    out, m, l = tska.fused_sparse_decode_attention(**dec, return_norm=True)
    assert torch.equal(out, tska.fused_sparse_decode_attention(**dec))
    assert m.dtype == l.dtype == torch.float32 and m.shape == l.shape
    out, probs = tska.fused_sparse_decode_attention(**dec, return_win_probs=True)
    assert torch.equal(out, tska.fused_sparse_decode_attention(**dec))
    assert probs.dtype == torch.float32 and probs.shape[-1] == dec["k_win"].shape[2]
    out, probs = tska.fused_sparse_decode_attention_ps(**ps, return_win_probs=True)
    assert torch.equal(out, tska.fused_sparse_decode_attention_ps(**ps))
    assert probs.dtype == torch.float32 and probs.shape[-1] == ps["k_win"].shape[2]
    # bitmap-q8: qbits=8 chunks take the scales, bf16 chunks refuse them
    _, tf8 = _fmts(0.7, 8)
    q8, pool8, scales8, kw8, vw8 = _inputs(4, 1, 2, 2, 2, 4, 0.7, 8)
    dec8 = dict(dec, q=_t(q8), kv_pool=torch.from_numpy(pool8), k_win=_t(kw8),
                v_win=_t(vw8), kfmt=tf8, vfmt=tf8, kv_scales=_t(scales8))
    seg8 = dict(seg, kv_pool=torch.from_numpy(pool8), kfmt=tf8, vfmt=tf8,
                kv_scales=_t(scales8))
    for fn, ok in ((tska.fused_sparse_decode_attention, dec8),
                   (tska.fused_sparse_decode_attention_ps,
                    dict(dec8, n_chunks=i32([1, 0]), win_len=i32([10, 3]))),
                   (tska.fused_sparse_segment_attention, seg8)):
        assert torch.isfinite(torch.as_tensor(fn(**ok)[0])).all()
        for change in (dict(kv_scales=None), dict(vfmt=tf),
                       dict(kv_scales=_t(scales8).float()),
                       dict(kv_scales=_t(scales8)[:, :1])):
            with pytest.raises((ValueError, TypeError)):
                fn(**dict(ok, **change))
    with pytest.raises(ValueError, match="kv_scales"):
        tska.fused_sparse_decode_attention(**dec, kv_scales=_t(scales8))
    assert (tska.fused_sparse_decode_attention.launches,
            tska.fused_sparse_decode_attention_ps.launches,
            tska.fused_sparse_segment_attention.launches) == (0, 0, 0)


def test_module_imports_and_builds_nothing_without_nvcc(tmp_path):
    """Importing the module needs no nvcc and builds nothing; asking for a
    bitmap kernel's library where there is no nvcc raises (no fallback)."""
    code = (
        "import mustafar_tpu_torch.ops.kernels.sparse_attention as ska\n"
        "from mustafar_tpu_torch.ops.kernels import build\n"
        "assert build._LIBS == {}\n"
        "for name in ('sp_decode', 'sp_segment'):\n"
        "    try:\n"
        "        build.load(name)\n"
        "    except RuntimeError as e:\n"
        "        assert 'nvcc' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('built without nvcc')\n")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=os.getcwd(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# chip_smoke.phase_kernel's (n_chunks, win_len, li) cases, at mc = 3 here
UNIFORM_CASES = ((0, 1, 0), (0, 44, 1), (0, 288, 0), (3, 288, 1), (3, 1, 0), (1, 44, 0),
                 (1, 288, 1), (2, 88, 0))


@functools.lru_cache(maxsize=None)
def _uniform_case(qbits, G):
    """Stacked inputs (B=2, one kv head, mc=3, L=2, sparsity 0.7) and JAX's
    v7 output (f32 q) at each of ``UNIFORM_CASES``, once a value width and
    group."""
    jf, tf = _fmts(0.7, qbits)
    ins = _inputs(60 + qbits + G, 2, 3, 2, 1, G, 0.7, qbits)
    q, pool, k_win, v_win = ins[0], ins[1], ins[-2], ins[-1]
    scales = ins[2] if qbits == 8 else None
    jargs = (jnp.asarray(q), jnp.asarray(pool),
             jnp.asarray(k_win, jnp.bfloat16), jnp.asarray(v_win, jnp.bfloat16))
    jos = [np.asarray(jska.fused_sparse_decode_attention_v7(
        *jargs, jnp.int32(nc), jnp.int32(wl), jf, jf, 3, li=jnp.int32(li),
        **(_jscales(scales) if qbits == 8 else {}))).astype(np.float32)
        for nc, wl, li in UNIFORM_CASES]
    return q, (torch.from_numpy(pool), _t(k_win), _t(v_win)), tf, \
        None if scales is None else _t(scales), jos


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("qbits", [16, 8])
def test_uniform_split_plain_matches_jax_kernel(qbits, G, q_dtype):
    """The uniform kernel's splits (four of 64 tokens a chunk, one a window
    tile of 96) at every case of ``phase_kernel``: held to JAX's v7 (f32 q)
    at the tolerance of ``test_ps_split_plain_matches_jax_kernel``
    (twice that for a bf16 output, which may round one ulp the other way)
    and to the TPU-order plain version at 2 bf16 ulps, row by row; a bf16 q
    gives the f32 q's output rounded."""
    q, targs, tf, scales, jos = _uniform_case(qbits, G)
    tq = torch.from_numpy(q).to(getattr(torch, q_dtype))
    jtol = ULP if q_dtype == "float32" else 2 * ULP
    for (nc, wl, li), jo in zip(UNIFORM_CASES, jos):
        args = (*targs, nc, wl, li, tf, tf, scales)
        got = tska.fused_sparse_decode_attention_split_plain(tq, *args)
        assert got.dtype == tq.dtype and got.shape == (2, 1, G, 128)
        got32 = tska.fused_sparse_decode_attention_split_plain(tq.float(), *args)
        np.testing.assert_array_equal(got.float().numpy(),
                                      got32.to(tq.dtype).float().numpy())
        tpu = tska.fused_sparse_decode_attention_plain(tq, *args).float().numpy()
        got = got.float().numpy()
        for b in range(2):
            where = f"row {b}, nc={nc} wl={wl} li={li}"
            np.testing.assert_allclose(got[b], jo[b], rtol=0,
                                       atol=jtol * np.abs(jo[b]).max(),
                                       err_msg=f"{where} against JAX")
            np.testing.assert_allclose(got[b], tpu[b], rtol=0,
                                       atol=2 * ULP * np.abs(tpu[b]).max(),
                                       err_msg=f"{where} against the TPU order")


def test_uniform_split_plain_cuts_only_the_chunks():
    """The bitmap uniform kernel's steps are the quant kernels' but for the
    chunks, cut in ``CHUNK_CUT`` runs: with no chunk its split plain version
    is the per-slot split steps at uniform counts and the kernels' score
    order bit for bit; with chunks the cut moves p's rounding only, within 2
    bf16 ulps of the output."""
    q, targs, tf, scales, _ = _uniform_case(16, 4)
    tq = torch.from_numpy(q)
    pool, k_win, v_win = targs
    for nc, wl, li in UNIFORM_CASES:
        got = tska.fused_sparse_decode_attention_split_plain(tq, *targs, nc, wl, li, tf, tf)
        ncs, wls = (torch.full((2,), x, dtype=torch.int32) for x in (nc, wl))
        whole = tqa.ps_split_steps(
            tq, 2, ncs, wls, 3,
            lambda hs: tska._sp_chunk_step(pool[:, :, hs], None, li, tf, tf, True),
            k_win, v_win, li, ordered=True).numpy()
        if nc == 0:
            np.testing.assert_array_equal(got.numpy(), whole)
        np.testing.assert_allclose(got.numpy(), whole, rtol=0,
                                   atol=2 * ULP * np.abs(whole).max(),
                                   err_msg=f"nc={nc} wl={wl} li={li}")
