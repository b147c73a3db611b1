"""Port parity, the sliding window (Mistral) of the decode kernels the
``Generator`` runs: TPU kernels 1 (quant codecs), 6 (bitmap codecs) and 4
(the dense flash-decode).

(k) Kernels 1 and 6: the plain versions with ``window`` (the TPU's
    arithmetic: every chunk run, masked columns scored -1e30) against the
    JAX kernels in Pallas interpret mode, at every codec, with the
    window's lower edge inside a chunk, on a chunk boundary, on one of
    kernel 6's 64-token step boundaries, with a whole chunk below it, with
    every pool column below it, and vacuous (the window covers the whole
    sequence); ``return_win_probs`` and ``return_norm`` on for one case
    each.  Then the split plain versions (the CUDA kernels' arithmetic:
    the steps wholly below the edge left out of the grid) against the JAX
    kernel and the TPU-order plain version, and the grid rule
    (``uniform_splits`` with ``window``).
(d) Kernel 4: the plain version with ``window`` against the JAX kernel,
    uniform and per slot (an idle slot, a slot whose window covers all its
    rows), and its split plain version (splits wholly below the edge take no
    step) against both.
(r) What was refused until the next slice ported it: the window of
    kernels 2, 3, 7 and 8, and the compressed cache's per-slot decode,
    ``compact_slots`` and chunked prefill on a windowed model, now served.

Tolerances are those of the kernels' own parity tests: one bf16 ulp of the
output's scale against JAX (2 for a bf16 q against an f32 one), 2 between
the two plain versions; probabilities and (m, l) as
``test_torch_opa_kernels.py`` holds them.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mustafar_tpu.ops import quant_format as jqf
from mustafar_tpu.ops import sparse_format as jsf
from mustafar_tpu.ops.kernels import quant_attention as jqa
from mustafar_tpu.ops.kernels import sparse_attention as jska
from mustafar_tpu.ops.kernels.dense_decode import flash_decode_attention as j_flash
from mustafar_tpu_torch import config as tc
from mustafar_tpu_torch.cache import CompressedKVCache
from mustafar_tpu_torch.ops import quant_format as tqf
from mustafar_tpu_torch.ops import sparse_format as tsf
from mustafar_tpu_torch.ops.kernels import dense_decode as tdd
from mustafar_tpu_torch.ops.kernels import quant_attention as tqa
from mustafar_tpu_torch.ops.kernels import sparse_attention as tska

torch.set_num_threads(1)

ULP = 2.0 ** -8
W = 288                      # residual 32 + chunk 256
MC = 3
BITS = {"q8": (8, 8), "q8q4": (8, 4), "q4q4": (4, 4)}

# (n_chunks, win_len, window) -> where the window's lower edge falls; the
# decoded token is at n_chunks * 256 + win_len - 1 (867 at 3 chunks + 100)
EDGES = {
    "inside_chunk": (3, 100, 700),        # low 167: inside chunk 0 (kernel 6: run 2)
    "chunk_boundary": (3, 100, 612),      # low 255: chunk 0 wholly below, 1 live
    "step_boundary": (3, 100, 548),       # low 319: chunk 1's first 64 tokens below
    "whole_chunk_below": (3, 100, 467),   # low 400: chunk 0 below, chunk 1 cut
    "two_chunks_below": (3, 100, 288),    # low 579: chunks 0-1 below, chunk 2 cut
    "every_chunk_below": (3, 100, 100),   # low 767: only the window is live
    "vacuous": (3, 100, 868),             # window = pos + 1: nothing masked
    "one_chunk": (1, 288, 300),           # low 243: chunk 0 cut at 243
}
FEW = ("inside_chunk", "whole_chunk_below", "vacuous")


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _state(codec, G=4, B=2, Hkv=2, seed=3):
    """q, a stacked pool (L=1, MC chunks) of real packed chunks of ``codec``
    (random bf16 K and V pruned to keep 40 of 128, then encoded by the JAX
    codec), scales (quant codecs and bitmap-q8, else None) and windows."""
    rs = np.random.RandomState(seed)
    BH = B * Hkv
    x = jnp.asarray(rs.randn(1, MC, 2, BH, 256, 128) * 0.5, jnp.bfloat16)
    if codec in BITS:
        jc = jqf.QuantCodec(256, 128, *BITS[codec])
        pool = np.zeros((1, MC, BH, jc.stream_rows, 128), np.int16)
        scales = np.zeros((1, MC, BH, 2, 128), np.float32)
        for ci in range(MC):
            rows = []
            for j, kind in enumerate(("k", "v")):
                xi = x[0, ci, j]
                xi = jnp.where(jsf.topk_mask(xi, 40), xi, 0).astype(jnp.bfloat16)
                r, s = jqf.encode_chunk(xi, jc, kind)
                rows.append(np.asarray(r))
                scales[0, ci, :, j] = _bf16(np.asarray(s))
            pool[0, ci] = np.concatenate(rows, axis=1)
    else:
        jf = _fmt(codec)[0]
        if jf.qbits == 8:
            r, s = jax.jit(lambda a: jsf.prune_and_encode_stream_q8(a, jf))(x)
            scales = _bf16(np.moveaxis(np.asarray(s), 2, 3))
        else:
            r, scales = jax.jit(lambda a: jsf.prune_and_encode_stream(a, jf))(x), None
        r = np.asarray(r)
        pool = np.concatenate([r[:, :, 0], r[:, :, 1]], axis=-2)
    k_win, v_win = _bf16(rs.randn(1, BH, W, 128)), _bf16(rs.randn(1, BH, W, 128))
    q = _bf16(rs.randn(B, 1, Hkv * G, 128))
    return q, pool, scales, k_win, v_win


def _fmt(codec):
    qbits = 8 if codec == "bitmap-q8" else 16
    return (jsf.ChunkFormat(256, 128, 40, qbits=qbits),
            tsf.ChunkFormat(256, 128, 40, qbits=qbits))


def _t(a, dtype=torch.bfloat16):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _jax(codec, nc, wl, window, **opts):
    q, pool, scales, kw, vw = _state(codec)
    args = (jnp.asarray(q), jnp.asarray(pool))
    wins = (jnp.asarray(kw, jnp.bfloat16), jnp.asarray(vw, jnp.bfloat16))
    if codec in BITS:
        res = jqa.fused_q_decode_attention(
            *args, jnp.asarray(scales[..., 0, :], jnp.bfloat16),
            jnp.asarray(scales[..., 1, :], jnp.bfloat16), *wins, jnp.int32(nc),
            jnp.int32(wl), jqf.QuantCodec(256, 128, *BITS[codec]), MC, li=jnp.int32(0),
            window=window, **opts)
    else:
        jf = _fmt(codec)[0]
        sc = ({} if scales is None else
              {"kscales": jnp.asarray(scales[..., 0, :], jnp.bfloat16),
               "vscales": jnp.asarray(scales[..., 1, :], jnp.bfloat16)})
        res = jska.fused_sparse_decode_attention_v7(
            *args, *wins, jnp.int32(nc), jnp.int32(wl), jf, jf, MC, li=jnp.int32(0),
            window=window, **sc, **opts)
    return [np.asarray(r).astype(np.float32) for r in (res if opts else (res,))]


def _port(codec, nc, wl, window, q=None, kind="wrapper", **opts):
    """The port's wrapper (the plain version on the CPU), its TPU-order plain
    version or its split plain version ("wrapper", "plain", "split")."""
    q0, pool, scales, kw, vw = _state(codec)
    q = torch.from_numpy(q0) if q is None else q
    pool, sc, kw, vw = torch.from_numpy(pool), _t(scales), _t(kw), _t(vw)
    if codec in BITS:
        cd = tqf.QuantCodec(256, 128, *BITS[codec])
        if kind == "wrapper":
            return tqa.fused_q_decode_attention(q, pool, sc, kw, vw, nc, wl, 0, cd,
                                                window=window, **opts)
        fn = (tqa.fused_q_decode_attention_plain if kind == "plain"
              else tqa.fused_q_decode_attention_split_plain)
        return fn(q, pool, sc, kw, vw, nc, wl, 0, cd, window=window, **opts)
    tf = _fmt(codec)[1]
    if kind == "wrapper":
        return tska.fused_sparse_decode_attention(q, pool, kw, vw, nc, wl, 0, tf, tf,
                                                  kv_scales=sc, window=window, **opts)
    fn = (tska.fused_sparse_decode_attention_plain if kind == "plain"
          else tska.fused_sparse_decode_attention_split_plain)
    return fn(q, pool, kw, vw, nc, wl, 0, tf, tf, sc, window=window, **opts)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max(),
                               err_msg=msg)


CODEC_CASES = ([pytest.param(c, e, id=f"{c}-{e}") for c in ("q8q4", "bitmap") for e in EDGES]
               + [pytest.param(c, e, id=f"{c}-{e}") for c in ("q8", "q4q4", "bitmap-q8")
                  for e in FEW])


@pytest.mark.parametrize("codec,edge", CODEC_CASES)
def test_windowed_plain_matches_jax_kernel(codec, edge):
    """Kernels 1 and 6 with a sliding window: the port's CPU path (the
    TPU-order plain version) against the JAX kernel at one bf16 ulp of the
    output's scale; the split plain version (the CUDA kernel's steps)
    against JAX at one ulp and against the TPU order at two, row by row;
    the window changes the output unless it is vacuous."""
    nc, wl, window = EDGES[edge]
    (jo,) = _jax(codec, nc, wl, window)
    launches = (tqa.fused_q_decode_attention.launches,
                tska.fused_sparse_decode_attention.launches)
    got = _port(codec, nc, wl, window).float().numpy()
    assert launches == (tqa.fused_q_decode_attention.launches,
                        tska.fused_sparse_decode_attention.launches)   # CPU: no launch
    _close(got, jo, ULP, f"{codec} {edge}")
    split = _port(codec, nc, wl, window, kind="split").float().numpy()
    for b in range(2):
        _close(split[b], jo[b], ULP, f"split, row {b}")
        _close(split[b], got[b], 2 * ULP, f"split against the TPU order, row {b}")
    full = _port(codec, nc, wl, None).float().numpy()
    assert np.array_equal(got, full) == (edge == "vacuous")


@pytest.mark.parametrize("codec", ["q8q4", "bitmap"])
def test_windowed_options_match_jax_kernel(codec):
    """``return_win_probs`` (the window columns are never masked: the
    window covers the cache's window capacity) and ``return_norm`` (the
    final m and l, over the live pool columns and the window) with the
    window's edge inside a chunk: the plain version against JAX, the split
    plain version against the TPU order, and the output with each option
    equal to the output without it."""
    nc, wl, window = EDGES["whole_chunk_below"]
    jo, jprobs = _jax(codec, nc, wl, window, return_win_probs=True)
    out, probs = _port(codec, nc, wl, window, return_win_probs=True)
    assert torch.equal(out, _port(codec, nc, wl, window))
    _close(out.float().numpy(), jo, ULP)
    probs = probs.numpy()
    np.testing.assert_allclose(probs, jprobs, rtol=0, atol=1e-6)
    assert (probs[..., wl:] == 0).all() and (probs[..., :wl] > 0).all()
    _, sprobs = _port(codec, nc, wl, window, kind="split", win_probs=True)
    np.testing.assert_allclose(sprobs.numpy(), probs, rtol=0, atol=2e-3)

    nc, wl, window = EDGES["inside_chunk"]
    jo, jm, jl = _jax(codec, nc, wl, window, return_norm=True)
    out, m, l = _port(codec, nc, wl, window, return_norm=True)
    assert torch.equal(out, _port(codec, nc, wl, window))
    np.testing.assert_allclose(m.numpy(), jm, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(l.numpy(), jl, rtol=1e-5, atol=0)
    _, sm, sl = _port(codec, nc, wl, window, kind="split", norm=True)
    np.testing.assert_allclose(sm.numpy(), m.numpy(), rtol=1e-6, atol=1e-6)
    # the splits round p at their own max: l to a few bf16 roundings of p
    np.testing.assert_allclose(sl.numpy(), l.numpy(), rtol=2e-3, atol=0)


def test_windowed_split_plain_bf16_q_is_the_f32_result_rounded():
    """A bf16 q gives the f32 q's split output rounded to bf16, as the
    kernels compute in f32 and cast once."""
    for codec in ("q8q4", "bitmap"):
        q = torch.from_numpy(_state(codec)[0])
        nc, wl, window = EDGES["step_boundary"]
        o16 = _port(codec, nc, wl, window, q=q.to(torch.bfloat16), kind="split")
        o32 = _port(codec, nc, wl, window, q=q, kind="split")
        assert o16.dtype == torch.bfloat16
        np.testing.assert_array_equal(o16.float().numpy(),
                                      o32.to(torch.bfloat16).float().numpy())


def test_uniform_splits_leave_out_the_steps_below_the_window():
    """The grid of the uniform kernels (kernel 1 one step a chunk, kernel 6
    four of 64 tokens): the steps wholly at or below the edge are left out,
    the step that holds it stays; every chunk split has a live column."""
    cases = {  # (nc, wl, window, cut): (chunk splits, window splits)
        (3, 100, 700, 1): (3, 2), (3, 100, 612, 1): (2, 2), (3, 100, 548, 1): (2, 2),
        (3, 100, 467, 1): (2, 2), (3, 100, 288, 1): (1, 2), (3, 100, 868, 1): (3, 2),
        (3, 100, 700, 4): (10, 2), (3, 100, 612, 4): (8, 2), (3, 100, 548, 4): (7, 2),
        (3, 100, 467, 4): (6, 2), (3, 100, 100, 4): (0, 2), (3, 100, 100, 1): (0, 2),
        (1, 288, 300, 4): (1, 3), (1, 288, 4096, 4): (4, 3), (3, 100, None, 4): (12, 2)}
    for (nc, wl, window, cut), want in cases.items():
        assert tqa.uniform_splits(nc, wl, W, cut, window) == want, (nc, wl, window, cut)
        step = 256 // cut
        first = nc * cut - want[0]
        low = tqa.window_low(nc, wl, window)
        assert first * step <= low + 1 or first == 0
        assert want[0] == 0 or (first + 1) * step - 1 > low
    with pytest.raises(ValueError, match="window"):
        _port("q8q4", 1, 10, 0)
    with pytest.raises(ValueError, match="window"):
        _port("bitmap", 1, 10, 512.0)


# -- kernel 4 -----------------------------------------------------------------

DENSE_S = 1312


@functools.lru_cache(maxsize=None)
def _dense_case(mode):
    """Inputs (B=4, Hkv=2, G=4, S=1,312) and pos: uniform at 1,000, or per
    slot (an idle slot; 1,000; 37, whose window covers all its rows; 700)."""
    rs = np.random.RandomState(11)
    q = rs.randn(4, 1, 8, 128).astype(np.float32)
    k = rs.randn(4, DENSE_S, 2, 128).astype(np.float32)
    v = rs.randn(4, DENSE_S, 2, 128).astype(np.float32)
    pos = 1000 if mode == "uniform" else np.array([-1, 1000, 37, 700], np.int32)
    return q, k, v, pos


@pytest.mark.parametrize("window", [300, 361, 257, 1500])
@pytest.mark.parametrize("mode", ["uniform", "per_slot"])
def test_dense_windowed_matches_jax_kernel(mode, window):
    """Kernel 4 with a sliding window at pos 1,000: the first live row 701
    inside a 32-token tile of the TPU and a split of the CUDA kernel
    (window 300), 640 on a tile and split boundary (361), 744 (257), and
    vacuous (1,500): the plain version and the split plain version (at 64
    and 128 tokens a split) against JAX; an idle slot comes out 0; a slot
    whose window covers all its rows (pos 37) as without the window."""
    q, k, v, pos = _dense_case(mode)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(pos, jnp.int32), window))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tpos = torch.from_numpy(pos) if mode == "per_slot" else pos
    got = tdd.flash_decode_attention(tq, tk, tv, tpos, window=window).numpy()
    _close(got, want, 2 * ULP)
    for split in (64, 128):
        sp = tdd.flash_decode_attention_split_plain(tq, tk, tv, tpos, split,
                                                    window=window).numpy()
        _close(sp, want, 2 * ULP, f"split {split}")
    full = tdd.flash_decode_attention(tq, tk, tv, tpos).numpy()
    if mode == "per_slot":
        assert (got[0] == 0).all() and (want[0] == 0).all()
        assert np.array_equal(got[2], full[2])           # its window covers rows 0-37
    assert np.array_equal(got, full) == (window == 1500)
    # the final (m, l) with the window, against JAX's
    _, m, l = tdd.flash_decode_attention(tq, tk, tv, tpos, window=window, return_norm=True)
    _, jm, jl = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(pos, jnp.int32), window, return_norm=True)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=1e-5, atol=0)


def test_dense_split_plain_reads_no_row_below_the_window():
    """The CUDA kernel's arithmetic reads no row at or below the edge: a
    split wholly below it takes no step, and the split that holds it attends
    its rows from the edge on.  So rows below hold what they may (here NaN,
    which a masked step would carry into the merge as NaN * 0) and the split
    plain version's output is the same bits."""
    q, k, v, _ = _dense_case("uniform")
    kn, vn = k.copy(), v.copy()
    kn[:, :701], vn[:, :701] = np.nan, np.nan
    tq = torch.from_numpy(q)
    for split in (64, 128):
        want = tdd.flash_decode_attention_split_plain(
            tq, torch.from_numpy(k), torch.from_numpy(v), 1000, split, window=300)
        got = tdd.flash_decode_attention_split_plain(
            tq, torch.from_numpy(kn), torch.from_numpy(vn), 1000, split, window=300)
        assert torch.equal(got, want)


# -- what was refused ----------------------------------------------------------

def test_per_slot_and_segment_kernels_refuse_the_window():
    """Kernels 2, 3, 7 and 8 and the compressed cache's per-slot decode,
    ``compact_slots`` and chunked prefill, once refused on a windowed model,
    now serve the window (``test_torch_window_ps.py``,
    ``test_torch_window_segment.py`` and ``test_torch_window_engine.py``
    hold them against JAX): a window that covers every position gives the
    unwindowed result bit for bit, a narrower one a finite other one, and
    the cache's steps on a windowed model leave the state the unwindowed
    model's leaves while the window covers every position."""
    i32 = lambda x: torch.tensor(x, dtype=torch.int32)
    for codec in ("q8q4", "bitmap"):
        q, pool, scales, kw, vw = _state(codec)
        pool, sc, kw, vw = torch.from_numpy(pool), _t(scales), _t(kw), _t(vw)
        qs = torch.from_numpy(np.random.RandomState(1).randn(2, 256, 8, 128)
                              .astype(np.float32)).to(torch.bfloat16)
        if codec in BITS:
            cd = tqf.QuantCodec(256, 128, *BITS[codec])
            ps = lambda window: tqa.fused_q_decode_attention_ps(
                _t(q), pool, sc, kw, vw, i32([1, 0]), i32([10, 3]), 0, cd, window=window)
            seg = lambda window: tqa.fused_q_segment_attention(qs, pool, sc, 1, 512, 0, cd,
                                                               window=window)
        else:
            tf = _fmt(codec)[1]
            ps = lambda window: tska.fused_sparse_decode_attention_ps(
                _t(q), pool, kw, vw, i32([1, 0]), i32([10, 3]), 0, tf, tf, window=window)
            seg = lambda window: tska.fused_sparse_segment_attention(
                qs, pool, 1, 512, 0, tf, tf, window=window)
        assert torch.equal(ps(512), ps(None))
        assert torch.isfinite(ps(100)).all() and not torch.equal(ps(100)[0], ps(None)[0])
        assert all(torch.equal(a, b) for a, b in zip(seg(768), seg(None)))
        acc, m, _ = seg(288)
        assert torch.isfinite(acc).all() and (m[:, 31:] == -1e30).all()
    model = dataclasses.replace(tc.TINY_LLAMA, head_dim=128, num_heads=4, num_kv_heads=1,
                                hidden_size=256, num_layers=1, sliding_window=320)
    for codec in ("q8q4", "bitmap"):
        states = []
        for m in (model, dataclasses.replace(model, sliding_window=None)):
            eng = tc.EngineConfig(model=m, cache_mode=tc.CacheMode.COMPRESSED, codec=codec,
                                  max_seq_len=1024, batch_size=2)
            impl = CompressedKVCache(eng, device="cpu")
            st = impl.init(2, torch.float32)
            rs = np.random.RandomState(2)
            seg = [torch.from_numpy(rs.randn(2, 256, h, 128).astype(np.float32))
                   for h in (4, 1, 1)]
            out_seg = impl.segment_attend(st, 0, *seg, 0, 300)
            impl.finalize_segment(st, 0, 300)
            st["nc_host"] = None
            one = [torch.from_numpy(rs.randn(2, 1, h, 128).astype(np.float32))
                   for h in (4, 1, 1)]
            out_one = impl.decode_attend(st, 0, *one, i32([256, -1]))
            impl.compact_slots(st, [True, False])
            states.append((out_seg, out_one, st))
        (s1, d1, st1), (s2, d2, st2) = states
        assert torch.equal(s1, s2) and torch.equal(d1, d2)
        assert all(torch.equal(st1[k], st2[k]) for k in ("kv_pool", "k_win", "n_chunks"))
        assert st1["n_chunks"].tolist() == [[1, 0]]
    # a window narrower than the cache's window capacity is refused, as in JAX
    with pytest.raises(AssertionError, match="sliding window"):
        CompressedKVCache(tc.EngineConfig(
            model=dataclasses.replace(model, sliding_window=200),
            cache_mode=tc.CacheMode.COMPRESSED), device="cpu")
