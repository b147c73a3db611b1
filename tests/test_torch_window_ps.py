"""Port parity, the sliding window (Mistral) of the per-slot decode kernels
the continuous-batching engine runs: TPU kernels 2 (quant codecs,
``fused_q_decode_attention_ps``) and 7 (bitmap codecs,
``fused_sparse_decode_attention_v6ps``).

(p) The plain versions with ``window`` (the TPU's arithmetic: each slot at
    its own counts, every chunk run, its masked columns scored -1e30)
    against the JAX kernels in Pallas interpret mode, at every codec, with
    slots of different edges in one call: the edge inside a chunk, on a
    chunk boundary, chunks wholly below it, every chunk below it, a
    vacuous window, an idle slot.  ``return_win_probs`` on for one call a
    codec family.  Then the split plain versions (the CUDA kernels'
    arithmetic: a slot's chunk splits wholly below its edge take no step)
    against JAX and the TPU order, and reading nothing below the edge.
(g) The rule that names a slot's first live chunk split
    (``quant_attention.masked_steps`` at 256 tokens a step, the CUDA
    ``split_merge::first_live_chunk``).

Tolerances are those of the kernels' own parity tests, per slot at the
slot's output scale: one bf16 ulp against JAX, two between the two plain
versions; window probabilities within 1e-6 of JAX's, the split version's
within 2e-3 of the TPU order's (p rounded at each split's own max).
"""

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
from mustafar_tpu_torch.ops import quant_format as tqf
from mustafar_tpu_torch.ops import sparse_format as tsf
from mustafar_tpu_torch.ops.kernels import quant_attention as tqa
from mustafar_tpu_torch.ops.kernels import sparse_attention as tska

torch.set_num_threads(2)

ULP = 2.0 ** -8
W = 288                      # residual 32 + chunk 256
MC = 3
BITS = {"q8": (8, 8), "q8q4": (8, 4), "q4q4": (4, 4)}

# window -> four slots' (n_chunks, win_len); slot b decodes the token at
# n_chunks * 256 + win_len - 1, and its edge low = that - window
SLOTS = {
    # low 319 (chunk 0 below, the edge inside chunk 1); idle; low 219
    # (inside chunk 0); a vacuous window (low < 0)
    548: [(3, 100), (0, 0), (2, 256), (1, 10)],
    # low 511 (chunks 0-1 below, the edge on chunk 2's boundary); 499
    # (inside chunk 1); 567 (inside chunk 2); 243 (inside chunk 0)
    300: [(3, 44), (2, 288), (3, 100), (1, 288)],
    # every chunk below the edge (only the window is live); idle; 131;
    # 255 (chunk 0 below, on its boundary, no chunk left)
    100: [(3, 100), (0, 0), (0, 232), (1, 100)],
}
FEW = (300,)


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16)).astype(np.float32)


def _fmt(codec):
    qbits = 8 if codec == "bitmap-q8" else 16
    return (jsf.ChunkFormat(256, 128, 40, qbits=qbits),
            tsf.ChunkFormat(256, 128, 40, qbits=qbits))


@functools.lru_cache(maxsize=None)
def pool_state(codec, mc=MC, B=4, Hkv=2, G=4, seed=5):
    """q [B, 1, Hkv*G, 128], a stacked pool (L=1, mc chunks) of real packed
    chunks of ``codec`` (random bf16 K and V pruned to keep 40 of 128, then
    encoded by the JAX codec), scales [1, mc, BH, 2, 128] (quant codecs and
    bitmap-q8, else None) and windows [1, BH, W, 128], all float32 or int16
    numpy."""
    rs = np.random.RandomState(seed)
    BH = B * Hkv
    x = jnp.asarray(rs.randn(1, mc, 2, BH, 256, 128) * 0.5, jnp.bfloat16)
    if codec in BITS:
        jc = jqf.QuantCodec(256, 128, *BITS[codec])
        pool = np.zeros((1, mc, BH, jc.stream_rows, 128), np.int16)
        scales = np.zeros((1, mc, BH, 2, 128), np.float32)
        enc = jax.jit(lambda a, kind: jqf.encode_chunk(
            jnp.where(jsf.topk_mask(a, 40), a, 0).astype(jnp.bfloat16), jc, kind),
            static_argnums=1)
        for ci in range(mc):
            rows = []
            for j, kind in enumerate(("k", "v")):
                r, s = enc(x[0, ci, j], kind)
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


def _counts(window):
    nc, wl = zip(*SLOTS[window])
    return np.array(nc, np.int32), np.array(wl, np.int32)


def _jax(codec, window, **opts):
    q, pool, scales, kw, vw = pool_state(codec)
    nc, wl = (jnp.asarray(c) for c in _counts(window))
    wins = (jnp.asarray(kw, jnp.bfloat16), jnp.asarray(vw, jnp.bfloat16))
    if codec in BITS:
        res = jqa.fused_q_decode_attention_ps(
            jnp.asarray(q), jnp.asarray(pool), jnp.asarray(scales[..., 0, :], jnp.bfloat16),
            jnp.asarray(scales[..., 1, :], jnp.bfloat16), *wins, nc, wl,
            jqf.QuantCodec(256, 128, *BITS[codec]), MC, li=jnp.int32(0), window=window,
            **opts)
    else:
        jf = _fmt(codec)[0]
        sc = ({} if scales is None else
              {"kscales": jnp.asarray(scales[..., 0, :], jnp.bfloat16),
               "vscales": jnp.asarray(scales[..., 1, :], jnp.bfloat16)})
        res = jska.fused_sparse_decode_attention_v6ps(
            jnp.asarray(q), jnp.asarray(pool), *wins, nc, wl, jf, jf, MC, li=jnp.int32(0),
            window=window, **sc, **opts)
    return [np.asarray(r).astype(np.float32) for r in (res if opts else (res,))]


def _port(codec, window, kind="wrapper", pool=None, slots=None, **opts):
    """The port's wrapper (the plain version on the CPU), its TPU-order
    plain version or its split plain version ("wrapper", "plain", "split"),
    on ``pool`` in place of the state's if given, at the slots of
    ``SLOTS[slots]`` (default ``window``'s)."""
    q, pool0, scales, kw, vw = pool_state(codec)
    q, kw, vw = torch.from_numpy(q), _t(kw), _t(vw)
    pool = torch.from_numpy(pool0 if pool is None else pool)
    sc = _t(scales)
    nc, wl = (torch.from_numpy(c) for c in _counts(window if slots is None else slots))
    if codec in BITS:
        cd = tqf.QuantCodec(256, 128, *BITS[codec])
        if kind == "wrapper":
            return tqa.fused_q_decode_attention_ps(q, pool, sc, kw, vw, nc, wl, 0, cd,
                                                   window=window, **opts)
        fn = (tqa.fused_q_decode_attention_ps_plain if kind == "plain"
              else tqa.fused_q_decode_attention_ps_split_plain)
        return fn(q, pool, sc, kw, vw, nc, wl, 0, cd, window=window, **opts)
    tf = _fmt(codec)[1]
    if kind == "wrapper":
        return tska.fused_sparse_decode_attention_ps(q, pool, kw, vw, nc, wl, 0, tf, tf,
                                                     kv_scales=sc, window=window, **opts)
    fn = (tska.fused_sparse_decode_attention_ps_plain if kind == "plain"
          else tska.fused_sparse_decode_attention_ps_split_plain)
    return fn(q, pool, kw, vw, nc, wl, 0, tf, tf, sc, window=window, **opts)


def _t(a, dtype=torch.bfloat16):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _close_slots(got, want, tol, window, msg=""):
    """Per slot, within ``tol`` of that slot's output scale.  An idle slot
    (nothing to attend) comes out exactly 0 in the port; the TPU kernel
    averages its masked columns there, which the engine never reads, so
    it is not compared."""
    for b in range(got.shape[0]):
        if SLOTS[window][b] == (0, 0):
            assert (got[b] == 0).all(), f"{msg} slot {b}"
            continue
        scale = np.abs(want[b]).max()
        np.testing.assert_allclose(got[b], want[b], rtol=0, atol=tol * scale,
                                   err_msg=f"{msg} slot {b}")


CASES = ([pytest.param("q8q4", w, id=f"q8q4-w{w}") for w in SLOTS]
         + [pytest.param("bitmap", w, id=f"bitmap-w{w}") for w in (300, 100)]
         + [pytest.param(c, w, id=f"{c}-w{w}") for c in ("q8", "q4q4", "bitmap-q8")
            for w in FEW])


@pytest.mark.parametrize("codec,window", CASES)
def test_per_slot_windowed_plain_matches_jax_kernel(codec, window):
    """Kernels 2 and 7 with a sliding window, slots of different edges in
    one call: the port's CPU path (the TPU-order plain version, no launch)
    against the JAX kernel at one bf16 ulp of each slot's scale; the split
    plain version against JAX at one ulp and the TPU order at two; the
    window changes a slot's output exactly when it masks a column of it."""
    (jo,) = _jax(codec, window)
    launches = (tqa.fused_q_decode_attention_ps.launches,
                tska.fused_sparse_decode_attention_ps.launches)
    got = _port(codec, window).float().numpy()
    assert launches == (tqa.fused_q_decode_attention_ps.launches,
                        tska.fused_sparse_decode_attention_ps.launches)
    _close_slots(got, jo, ULP, window, f"{codec} w{window}")
    split = _port(codec, window, kind="split").float().numpy()
    _close_slots(split, jo, ULP, window, "split")
    _close_slots(split, got, 2 * ULP, window, "split against the TPU order")
    full = _port(codec, None, slots=window).float().numpy()
    for b, (nc, wl) in enumerate(SLOTS[window]):
        masks = tqa.window_low(nc, wl, window) >= 0 and nc > 0
        assert np.array_equal(got[b], full[b]) == (not masks), (window, b)


@pytest.mark.parametrize("codec", ["q8q4", "bitmap"])
def test_per_slot_windowed_probs_match_jax_kernel(codec):
    """``return_win_probs`` with the window (its columns are never masked):
    the plain version's against JAX's, the split version's against the TPU
    order's, each zero past its slot's ``win_len`` (an idle slot all zero),
    and the output with the option equal to the output without it."""
    window = 548
    jo, jprobs = _jax(codec, window, return_win_probs=True)
    out, probs = _port(codec, window, return_win_probs=True)
    assert torch.equal(out, _port(codec, window))
    _close_slots(out.float().numpy(), jo, ULP, window)
    probs = probs.numpy()
    for b, (_, wl) in enumerate(SLOTS[window]):
        assert (probs[b, :, wl:] == 0).all() and (probs[b, :, :wl] > 0).all()
        if wl:                      # the TPU kernel's idle slot is not read
            np.testing.assert_allclose(probs[b], jprobs[b], rtol=0, atol=1e-6)
    sout, sprobs = _port(codec, window, kind="split", win_probs=True)
    assert torch.equal(sout, _port(codec, window, kind="split"))
    np.testing.assert_allclose(sprobs.numpy(), probs, rtol=0, atol=2e-3)


@pytest.mark.parametrize("codec", ["q8q4", "bitmap", "bitmap-q8"])
def test_per_slot_split_plain_reads_nothing_below_the_window(codec):
    """The CUDA kernels' arithmetic reads no chunk wholly at or below a
    slot's edge: those chunks hold noise here (at the bitmap codecs bitmaps
    and values that decode to anything, NaN included), and the split plain
    version's output is the same bits; the TPU order, which runs them
    masked, is not (NaN * 0 is NaN)."""
    window = 300
    _, pool, _, _, _ = pool_state(codec)
    noisy = pool.copy()
    rs = np.random.RandomState(0)
    Hkv = 2
    for b, (nc, wl) in enumerate(SLOTS[window]):
        first = tqa.masked_steps(nc, wl, window, 256)
        hs = slice(b * Hkv, (b + 1) * Hkv)
        noisy[:, :first, hs] = rs.randint(-2 ** 15, 2 ** 15,
                                          size=noisy[:, :first, hs].shape)
    want = _port(codec, window, kind="split")
    got = _port(codec, window, kind="split", pool=noisy)
    assert torch.equal(got, want)


def test_first_live_chunk_split():
    """A slot's first live chunk split: min(n_chunks, (low + 1) // 256), the
    chunks before it wholly at or below the edge, the one at it with a live
    column (the rule ``split_merge::first_live_chunk`` and the kernels'
    early exit share)."""
    cases = {(3, 100, 548): 1, (0, 0, 548): 0, (2, 256, 548): 0, (1, 10, 548): 0,
             (3, 44, 300): 2, (2, 288, 300): 1, (3, 100, 300): 2, (1, 288, 300): 0,
             (3, 100, 100): 3, (0, 232, 100): 0, (1, 100, 100): 1,
             (31, 256, 4096): 16, (31, 255, 4096): 15, (31, 256, None): 0}
    for (nc, wl, window), want in cases.items():
        first = tqa.masked_steps(nc, wl, window, 256)
        assert first == want, (nc, wl, window)
        low = tqa.window_low(nc, wl, window)
        assert first * 256 <= low + 1
        assert first == nc or (first + 1) * 256 - 1 > low
