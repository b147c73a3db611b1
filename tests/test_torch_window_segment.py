"""Port parity, the sliding window (Mistral) of the segment kernels that
chunked prefill over the compressed cache runs: TPU kernels 3 (quant
codecs, ``fused_q_segment_attention``) and 8 (bitmap codecs,
``fused_sparse_segment_attention``).

(s) The plain versions with ``window`` and ``seg_start`` (the TPU's
    arithmetic: query row t*G + g at position seg_start + t sees the pool
    columns past seg_start + t - window, every chunk run, the dead columns
    scored -1e30) against the JAX kernels in Pallas interpret mode, at every
    codec: the windows the cache serves at a test size (288 and 320: the
    edge moves through a chunk, whole chunks dead for every row, rows with
    no live pool column), an edge that crosses a chunk boundary within a
    few rows, a long window (whole chunks dead, every row live) and a
    vacuous one.  The rows with a live column are compared partial by
    partial; every row after ``merge_partials`` with a window partial and a
    causal self partial (a row with no live pool column: m = -1e30 in both,
    its l and acc finite, and weighed 0 by the merge).

Tolerances are those of the segment kernels' own parity tests: m to f32
rounding (rtol 1e-6), l to 1e-5, acc and the merged output to one bf16 ulp
of their scale (a bf16(p) may round the other way).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mustafar_tpu.ops.kernels import quant_attention as jqa
from mustafar_tpu.ops.kernels import sparse_attention as jska
from mustafar_tpu.ops import quant_format as jqf
from mustafar_tpu_torch.ops import quant_format as tqf
from mustafar_tpu_torch.ops.attention import attention_partials, merge_partials
from mustafar_tpu_torch.ops.kernels import quant_attention as tqa
from mustafar_tpu_torch.ops.kernels import sparse_attention as tska
from tests.test_torch_window_ps import BITS, W, _fmt, _t, pool_state

torch.set_num_threads(2)

ULP = 2.0 ** -8
MC = 6
T, G, HKV = 256, 4, 1

# name -> (n_chunks, seg_start, window, batch)
CASES = {
    # chunked prefill's segment 2 at window 288: rows t <= 30 see chunk 0's
    # columns past 224 + t, rows t >= 31 no pool column
    "w288_nc1": (1, 512, 288, 2),
    # segment 5 at window 320: chunks 0-2 dead for every row, the edge moves
    # through chunk 3, rows t >= 63 see no pool column
    "w320_nc4": (4, 1280, 320, 1),
    # the edge crosses chunk 0's end between tokens 3 and 4 (inside one
    # CTA's rows of either kernel)
    "cross": (2, 512, 260, 2),
    # chunks 0-1 dead for every row, the edge through chunk 2, every row live
    "long": (6, 1536, 1000, 1),
    "vacuous": (2, 512, 4096, 1),
}
CODEC_CASES = ([pytest.param(c, k, id=f"{c}-{k}") for c in ("q8q4", "bitmap") for k in CASES]
               + [pytest.param(c, k, id=f"{c}-{k}") for c in ("q8", "q4q4", "bitmap-q8")
                  for k in ("w288_nc1", "w320_nc4")])


def _state(codec, B):
    q, pool, scales, _, _ = pool_state(codec, mc=MC, B=B, Hkv=HKV, G=G, seed=9)
    qs = np.random.RandomState(B).randn(B, T, HKV * G, 128).astype(np.float32)
    return np.asarray(jnp.asarray(qs, jnp.bfloat16)).astype(np.float32), pool, scales


def _jax(codec, nc, seg_start, window, B):
    qs, pool, scales = _state(codec, B)
    args = (jnp.asarray(qs, jnp.bfloat16), jnp.asarray(pool))
    if codec in BITS:
        res = jqa.fused_q_segment_attention(
            *args, jnp.asarray(scales[..., 0, :], jnp.bfloat16),
            jnp.asarray(scales[..., 1, :], jnp.bfloat16), jnp.int32(nc), jnp.int32(seg_start),
            jqf.QuantCodec(256, 128, *BITS[codec]), MC, li=jnp.int32(0), window=window)
    else:
        jf = _fmt(codec)[0]
        sc = ({} if scales is None else
              {"kscales": jnp.asarray(scales[..., 0, :], jnp.bfloat16),
               "vscales": jnp.asarray(scales[..., 1, :], jnp.bfloat16)})
        res = jska.fused_sparse_segment_attention(
            *args, jnp.int32(nc), jnp.int32(seg_start), jf, jf, MC, li=jnp.int32(0),
            window=window, **sc)
    return [np.asarray(r) for r in res]


def _port(codec, nc, seg_start, window, B):
    qs, pool, scales = _state(codec, B)
    q, pool, sc = torch.from_numpy(qs).to(torch.bfloat16), torch.from_numpy(pool), _t(scales)
    if codec in BITS:
        return tqa.fused_q_segment_attention(q, pool, sc, nc, seg_start, 0,
                                             tqf.QuantCodec(256, 128, *BITS[codec]),
                                             window=window)
    tf = _fmt(codec)[1]
    return tska.fused_sparse_segment_attention(q, pool, nc, seg_start, 0, tf, tf,
                                               kv_scales=sc, window=window)


def _other_partials(B, seg_start, window):
    """A window partial (288 window columns at positions seg_start - 256
    onward, 256 of them filled, masked by the sliding window as the cache
    masks them) and a causal self partial, f32, for the merge."""
    rs = np.random.RandomState(21)
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    q = torch.from_numpy(_state("q8q4", B)[0])
    kw, vw, k, v = f(B, W, HKV, 128), f(B, W, HKV, 128), f(B, T, HKV, 128), f(B, T, HKV, 128)
    cols, rows = torch.arange(W), torch.arange(T)
    wmask = (cols < 256)[None, :] & ((seg_start - 256 + cols)[None, :]
                                     > (seg_start + rows)[:, None] - window)
    smask = torch.ones((T, T), dtype=torch.bool).tril()
    return attention_partials(q, kw, vw, wmask), attention_partials(q, k, v, smask)


@pytest.mark.parametrize("codec,case", CODEC_CASES)
def test_windowed_segment_plain_matches_jax_kernel(codec, case):
    nc, seg_start, window, B = CASES[case]
    ja, jm, jl = _jax(codec, nc, seg_start, window, B)
    launches = (tqa.fused_q_segment_attention.launches,
                tska.fused_sparse_segment_attention.launches)
    ta, tm, tl = _port(codec, nc, seg_start, window, B)
    assert launches == (tqa.fused_q_segment_attention.launches,
                        tska.fused_sparse_segment_attention.launches)   # CPU: no launch
    ta, tm, tl = ta.numpy(), tm.numpy(), tl.numpy()
    assert np.isfinite(ta).all() and np.isfinite(tm).all() and np.isfinite(tl).all()
    # a row of token t has a live pool column iff its edge lies below the
    # last packed column
    live_t = seg_start + np.arange(T) - window < nc * 256 - 1
    assert live_t.any()
    if case.startswith("w"):
        assert not live_t.all()                 # rows with no live pool column
        assert (tm[:, ~live_t] == -1e30).all() and (jm[:, ~live_t] == -1e30).all()
    np.testing.assert_allclose(tm[:, live_t], jm[:, live_t], rtol=1e-6, atol=0)
    np.testing.assert_allclose(tl[:, live_t], jl[:, live_t], rtol=1e-5, atol=0)
    np.testing.assert_allclose(ta[:, live_t], ja[:, live_t], rtol=0,
                               atol=ULP * np.abs(ja[:, live_t]).max())
    # every row after the merge with the window and self partials
    p_win, p_self = _other_partials(B, seg_start, window)
    got = merge_partials([tuple(torch.from_numpy(x) for x in (ta, tm, tl)), p_win,
                          p_self]).numpy()
    want = merge_partials([tuple(torch.from_numpy(np.asarray(x)) for x in (ja, jm, jl)),
                           p_win, p_self]).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ULP * np.abs(want).max())
    unwindowed = _port(codec, nc, seg_start, None, B)[0].numpy()
    assert np.array_equal(ta, unwindowed) == (case == "vacuous")


def test_segment_first_chunk_and_row_edges():
    """The chunks a CTA (or cluster) leaves out are dead for its oldest
    row; the per-row edges are the TPU's qpos - window."""
    assert tqa.segment_first_chunk(7936, 0, 4096, 30) == 15
    assert tqa.segment_first_chunk(7936, 255, 4096, 30) == 16
    assert tqa.segment_first_chunk(1280, 0, 320, 4) == 3
    assert tqa.segment_first_chunk(1280, 64, 320, 4) == 4
    assert tqa.segment_first_chunk(512, 0, 260, 2) == 0
    assert tqa.segment_first_chunk(512, 4, 260, 2) == 1
    assert tqa.segment_first_chunk(512, 0, None, 2) == 0
    lows = tqa.segment_row_lows(3, 2, 512, 260)
    assert lows.tolist() == [252, 252, 253, 253, 254, 254]
    assert tqa.segment_row_lows(3, 2, 512, None) is None
    with pytest.raises(ValueError, match="window"):
        _port("q8q4", 1, 512, 0, 1)
