"""Port parity, numerics primitives: quant_format, topk_mask, RoPE, rms_norm
and the W8 projection, each fed the same numpy inputs as the JAX package.

Integer results (codes, packed int16 rows, keep masks, bf16 scales) must be
bit-exact; floating results match to the tolerance stated at each assert.
The JAX side runs jitted, as its serving path does: XLA turns a division by
a constant into a product with its f32 reciprocal, and the port follows that
path, not eager JAX.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mustafar_tpu.models import llama as jl
from mustafar_tpu.models import quant as jq
from mustafar_tpu.models import rope as jr
from mustafar_tpu.ops import quant_format as jqf
from mustafar_tpu.ops import sparse_format as jsf
from mustafar_tpu_torch.models import llama as tl
from mustafar_tpu_torch.models import quant as tq
from mustafar_tpu_torch.models import rope as tr
from mustafar_tpu_torch.ops import quant_format as tqf
from mustafar_tpu_torch.ops import sparse_format as tsf

torch.set_num_threads(2)

j_quantize_chunk = jax.jit(jqf.quantize_chunk, static_argnums=1)
j_encode_chunk = jax.jit(jqf.encode_chunk, static_argnums=(1, 2))
j_quant_last = jax.jit(jq._quant_last)
j_quant_rows = jax.jit(jq._quant_rows)


def _bf16_np(x):
    """f32 numpy -> the bf16-rounded values, as f32 numpy (both sides)."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16)).astype(np.float32)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


# ---------------------------------------------------------------------------
# (a) quant_format: bit-exact codes, rows and scales
# ---------------------------------------------------------------------------

def _edge_chunk(rs, bits):
    """[3, 256, 128] f32 chunk whose per-channel scale is exactly 1 (each
    channel's max |x| is qmax), holding exact .5 codes (ties to even),
    negative codes and the edge codes +-qmax."""
    qmax = 2 ** (bits - 1) - 1
    x = rs.randint(-qmax, qmax + 1, (3, 256, 128)).astype(np.float32)
    x += rs.choice([0.0, 0.5, -0.5, 0.25], size=x.shape).astype(np.float32)
    x = np.clip(x, -qmax, qmax)
    x[:, 0, :] = qmax
    x[:, 1, :] = -qmax
    x[:, 2, :8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -3.5])
    return x


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_pack_unpack_bit_exact(bits):
    rs = np.random.RandomState(0)
    for x in (_edge_chunk(rs, bits), rs.randn(3, 256, 128).astype(np.float32)):
        jc, js = j_quantize_chunk(jnp.asarray(x), bits)
        tc, ts = tqf.quantize_chunk(_t(x), bits)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        jrows = jqf.pack_codes(jc, bits)
        trows = tqf.pack_codes(tc, bits)
        assert trows.dtype == torch.int16
        np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
        np.testing.assert_array_equal(tqf.unpack_rows(trows, bits).numpy(),
                                      np.asarray(jqf.unpack_rows(jrows, bits)))
        np.testing.assert_array_equal(tqf.unpack_rows(trows, bits).numpy(),
                                      tc.numpy())
    # ties to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -0.5 -> 0, -1.5 -> -2 ...
    edge = tqf.quantize_chunk(_t(_edge_chunk(np.random.RandomState(1), bits)), bits)[0]
    if bits == 8:
        np.testing.assert_array_equal(edge[:, 2, :8].numpy(),
                                      np.tile([0, 2, 2, 0, -2, -2, 4, -4], (3, 1)))
    assert edge.max() == 2 ** (bits - 1) - 1 and edge.min() == -(2 ** (bits - 1) - 1)


@pytest.mark.parametrize("kind,vbits", [("k", 4), ("v", 4), ("v", 8)])
def test_encode_decode_chunk_bit_exact(kind, vbits):
    rs = np.random.RandomState(2)
    x = _bf16_np(rs.randn(4, 256, 128) * 0.3)
    x[:, :, :5] = 0                                   # pruned positions
    jcod = jqf.QuantCodec(256, 128, 8, vbits)
    tcod = tqf.QuantCodec(256, 128, 8, vbits)
    jrows, jsc = j_encode_chunk(jnp.asarray(x, jnp.bfloat16), jcod, kind)
    trows, tsc = tqf.encode_chunk(_t(x, torch.bfloat16), tcod, kind)
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
    assert tsc.dtype == torch.bfloat16
    np.testing.assert_array_equal(tsc.float().numpy(),
                                  np.asarray(jsc).astype(np.float32))
    jd = jqf.decode_chunk(jrows, jsc, jcod, kind)
    td = tqf.decode_chunk(trows, tsc, tcod, kind)
    np.testing.assert_array_equal(td.float().numpy(), np.asarray(jd).astype(np.float32))
    assert (td.float().numpy()[:, :, :5] == 0).all()
    assert tcod.stream_rows == jcod.stream_rows


@pytest.mark.parametrize("codec", ["q8", "q8q4", "q4q4"])
def test_codec_rows_and_k_encode_bit_exact(codec):
    """Each quant codec's row counts (q8 K 128 + V 128 = 256 rows a chunk,
    q8q4 128 + 64, q4q4 64 + 64) are the JAX package's, and its K stream
    (int4 at q4q4) encodes bit-exact."""
    bits = tqf.CODECS[codec]
    jcod, tcod = jqf.QuantCodec(256, 128, *bits), tqf.QuantCodec(256, 128, *bits)
    assert (tcod.k_rows, tcod.v_rows, tcod.stream_rows) == \
        (jcod.k_rows, jcod.v_rows, jcod.stream_rows) == \
        {"q8": (128, 128, 256), "q8q4": (128, 64, 192), "q4q4": (64, 64, 128)}[codec]
    x = _bf16_np(np.random.RandomState(3).randn(2, 256, 128) * 0.3)
    jrows, jsc = j_encode_chunk(jnp.asarray(x, jnp.bfloat16), jcod, "k")
    trows, tsc = tqf.encode_chunk(_t(x, torch.bfloat16), tcod, "k")
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(tsc.float().numpy(), np.asarray(jsc).astype(np.float32))


# ---------------------------------------------------------------------------
# (b) topk_mask: bit-exact keep masks, ties to the lower channel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("keep", [1, 39, 40, 127, 128])
def test_topk_mask_bit_exact_with_ties(dtype, keep):
    rs = np.random.RandomState(3)
    x = rs.randn(64, 128).astype(np.float32)
    # forced ties: rows of few distinct magnitudes with both signs, so the
    # keep boundary cuts through a run of equal |x|
    x[:16] = rs.choice([-1.0, 1.0], (16, 128)) * rs.choice([0.5, 1.0, 2.0], (16, 128))
    x[16:20] = 1.0
    x[20:24] = 0.0
    x[24, :] = -1.0
    if dtype == "bfloat16":
        jx = jnp.asarray(x, jnp.bfloat16)
        tx = _t(x, torch.bfloat16)
    else:
        jx, tx = jnp.asarray(x), _t(x)
    jm = np.asarray(jsf.topk_mask(jx, keep))
    tm = tsf.topk_mask(tx, keep).numpy()
    np.testing.assert_array_equal(tm, jm)
    assert (tm.sum(-1) == min(keep, 128)).all()
    if keep < 128:
        assert tm[16, :keep].all() and not tm[16, keep:].any()   # ties -> low index


# ---------------------------------------------------------------------------
# (c) RoPE, rms_norm, W8 proj
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scaling", [None, {"rope_type": "llama3", "factor": 8.0,
                                            "low_freq_factor": 1.0,
                                            "high_freq_factor": 4.0,
                                            "original_max_position_embeddings": 8192}])
def test_rope_matches(scaling):
    rs = np.random.RandomState(4)
    pos = np.arange(600)
    jc, js = jr.rope_cos_sin(jnp.asarray(pos), 128, 500000.0, scaling)
    tc, ts = tr.rope_cos_sin(_t(pos), 128, 500000.0, scaling)
    np.testing.assert_array_equal(tr._inv_freq(128, 500000.0, scaling).numpy(),
                                  np.asarray(jr._inv_freq(128, 500000.0, scaling)))
    # cos/sin of the same f32 arguments: both libraries are within an ulp
    # or two of the true value
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=2.5e-7)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=2.5e-7)
    x = rs.randn(2, 600, 4, 128).astype(np.float32)
    jo = np.asarray(jr.apply_rope(jnp.asarray(x), jc, js))
    to = tr.apply_rope(_t(x), _t(np.asarray(jc)), _t(np.asarray(js))).numpy()
    np.testing.assert_allclose(to, jo, rtol=0, atol=1e-6)   # f32 x*c + rot*s
    xb = _bf16_np(x)
    jo = np.asarray(jr.apply_rope(jnp.asarray(xb, jnp.bfloat16), jc, js)).astype(np.float32)
    to = tr.apply_rope(_t(xb, torch.bfloat16), _t(np.asarray(jc)),
                       _t(np.asarray(js))).float().numpy()
    # bf16: XLA may keep x*c + rot*s in f32 before the one rounding, torch
    # rounds after each op: a few bf16 ulps (2^-8 relative) apart
    np.testing.assert_allclose(to, jo, rtol=0, atol=4 * 2 ** -8 * np.abs(xb).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches(dtype):
    rs = np.random.RandomState(5)
    x = _bf16_np(rs.randn(2, 7, 256) * 3)
    w = _bf16_np(1 + 0.1 * rs.randn(256))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jo = np.asarray(jl.rms_norm(jnp.asarray(x, jdt), jnp.asarray(w, jdt), 1e-5)).astype(np.float32)
    to = tl.rms_norm(_t(x, tdt), _t(w, tdt), 1e-5).float().numpy()
    # f32: mean reduction order only; bf16: one ulp of the output
    tol = 2e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(to, jo, rtol=tol, atol=tol)


def test_w8_quantize_and_proj_match():
    rs = np.random.RandomState(6)
    w = rs.randn(3, 256, 384).astype(np.float32) * 0.05
    emb = rs.randn(512, 256).astype(np.float32) * 0.02
    jqw, jsw = j_quant_last(jnp.asarray(w))
    tqw, tsw = tq._quant_last(_t(w))
    np.testing.assert_array_equal(tqw.numpy(), np.asarray(jqw))
    np.testing.assert_array_equal(tsw.numpy(), np.asarray(jsw))
    jqe, jse = j_quant_rows(jnp.asarray(emb))
    tqe, tse = tq._quant_rows(_t(emb))
    np.testing.assert_array_equal(tqe.numpy(), np.asarray(jqe))
    np.testing.assert_array_equal(tse.numpy(), np.asarray(jse))
    h = rs.randn(2, 5, 256).astype(np.float32)
    for dt_j, dt_t, tol in ((jnp.float32, torch.float32, 1e-5),
                            (jnp.bfloat16, torch.bfloat16, 2 ** -7)):
        hj = jnp.asarray(h, dt_j)
        ht = _t(np.asarray(hj).astype(np.float32), dt_t)
        jo = np.asarray(jq.proj(hj, {"w": jqw[1], "w_scale": jsw[1]}, "w")).astype(np.float32)
        to = tq.proj(ht, {"w": tqw[1], "w_scale": tsw[1]}, "w").float().numpy()
        # f32: summation order; bf16: the dot and the scale each round once
        np.testing.assert_allclose(to, jo, rtol=tol, atol=tol * np.abs(jo).max())
    toks = rs.randint(0, 512, (2, 9))
    jo = np.asarray(jq.embed_lookup({"embed": jqe, "embed_scale": jse},
                                    jnp.asarray(toks), jnp.float32))
    to = tq.embed_lookup({"embed": tqe, "embed_scale": tse}, _t(toks), torch.float32).numpy()
    np.testing.assert_array_equal(to, jo)
