"""Port parity, the bitmap chunk codec (``ops/sparse_format.py``).

(o) ``encode_stream``, ``decode_stream`` and ``prune_and_encode_stream``
    are bit-exact with the jitted JAX package: the int16 stream rows (value
    segments and bitmap word planes) and the decoded bf16 tile, at sparsity
    0.7 (keep 40 = 32 + 8) and 0.5 (keep 65 stored as 68 = 64 + 4, so rows
    carry zero pads), from bf16 and from f32 input.  The rows hold exact
    zeros (whole rows, most of a row, -0.0) and magnitude ties, where the
    keep rule and the pads must pick the same channels as JAX.
(o8) The bitmap-q8 codec (``qbits=8``): the geometry for every keep; the
    byte pairing of logical rows; ``encode_stream_q8``,
    ``decode_stream_q8`` and ``prune_and_encode_stream_q8`` bit-exact with
    the jitted JAX package (rows, scales and the decoded tile) at sparsity
    0.7 and 0.5 from bf16 and f32 input, with ties, an all-zero channel
    (scale 1e-8, codes 0), +-127 codes and kept values whose code is 0
    (their bits stay set).  The JAX package serves the codec jitted, where
    XLA turns ``amax / 127.0`` into a product with the f32 reciprocal; eager
    JAX divides, and differs from the served path in some scales.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mustafar_tpu.ops import sparse_format as jsf
from mustafar_tpu_torch.ops import sparse_format as tsf

torch.set_num_threads(2)

C, D = 256, 128


def _keep(sparsity):
    return D - int(sparsity * D) + 1


def _chunks(seed):
    """[3, C, D] f32 on the bf16 grid: random rows, then exact zeros (rows
    0-9 of chunk 0, most of row 10, a row of -0.0 in chunk 2), ties (every
    third channel of chunk 1 rounded to an integer, row 7 all ones)."""
    x = np.random.RandomState(seed).randn(3, C, D).astype(np.float32)
    x[0, :10] = 0.0
    x[0, 10, :100] = 0.0
    x[1, :, ::3] = np.round(x[1, :, ::3])
    x[1, 7] = 1.0
    x[2, 5] = -0.0
    return np.asarray(jnp.asarray(x, jnp.bfloat16)).astype(np.float32)


def _np32(a):
    return np.asarray(a).astype(np.float32)


def _both(x, dtype):
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jx, tx


@pytest.mark.parametrize("sparsity", [0.7, 0.5])
def test_format_geometry_matches_jax(sparsity):
    jf = jsf.ChunkFormat(C, D, _keep(sparsity))
    tf = tsf.ChunkFormat(C, D, _keep(sparsity))
    assert (tf.segs, tf.keep_stored, tf.total_rows, tf.stream_rows) == \
        (jf.segs, jf.keep_stored, jf.total_rows, jf.stream_rows)
    assert tf.stream_rows == {0.7: 96, 0.5: 152}[sparsity]
    for keep in range(1, 129):
        assert tsf.decompose_keep(keep, 4) == jsf.decompose_keep(keep, 4)
    # the qbits=8 format (codec bitmap-q8) is served: int8 codes, two
    # logical rows to a stream row
    q8 = tsf.ChunkFormat(C, D, _keep(sparsity), qbits=8)
    assert (q8.segs, q8.stream_rows) == {0.7: ((32, 8), 56), 0.5: ((64, 8), 88)}[sparsity]


def test_q8_format_geometry_matches_jax():
    """Segments, stored count, logical and physical rows of every keep at
    ``qbits=8``: the multiple of the stored count is 16 // gcd(C/128, 16),
    and each segment's rows are half its logical rows."""
    for keep in range(1, 129):
        jf = jsf.ChunkFormat(C, D, keep, qbits=8)
        tf = tsf.ChunkFormat(C, D, keep, qbits=8)
        assert (tf.segs, tf.keep_stored, tf.total_rows, tf.stream_rows) == \
            (jf.segs, jf.keep_stored, jf.total_rows, jf.stream_rows), keep
        for k in tf.segs:
            assert tf.seg_rows(k) == jf.seg_rows(k) == tf.seg_logical_rows(k) // 2
        assert tsf.decompose_keep(keep, 8) == jsf.decompose_keep(keep, 8)
    with pytest.raises(AssertionError):
        tsf.ChunkFormat(C, D, 40, qbits=4)


def test_bytes_rows_round_trip():
    """Logical int8 code rows pack two to an int16 row (row r low, r + R/2
    high) as in JAX, and unpack with each byte sign-extended."""
    codes = np.random.RandomState(6).randint(-128, 128, (2, 64, 128)).astype(np.int32)
    codes[0, 0, :4] = [127, -127, -128, 0]
    codes[0, 32, :4] = [-1, 1, 127, -128]              # the high bytes of row 0
    jrows = np.asarray(jsf._pack_bytes_rows(jnp.asarray(codes)))
    trows = tsf._pack_bytes_rows(torch.from_numpy(codes))
    assert trows.dtype == torch.int16 and trows.shape == (2, 32, 128)
    np.testing.assert_array_equal(trows.numpy(), jrows)
    np.testing.assert_array_equal(tsf._unpack_bytes_rows(trows).numpy(), codes)
    np.testing.assert_array_equal(
        np.asarray(jsf._unpack_bytes_rows(jnp.asarray(jrows))), codes)


def _q8_chunks(seed):
    """``_chunks`` plus the codec's edges: an all-zero channel, and in
    chunk 2 a channel whose largest value is 1000x the rest, so its other
    kept values quantize to code 0."""
    x = _chunks(seed)
    x[:, :, 9] = 0.0
    x[2, :, 17] = np.where(np.arange(C) == 3, 1000.0, x[2, :, 17] * 1e-3)
    x[2, :, 17] = np.asarray(jnp.asarray(x[2, :, 17], jnp.bfloat16)).astype(np.float32)
    return x


@pytest.mark.parametrize("sparsity,dtype", [(0.7, "bfloat16"), (0.7, "float32"),
                                            (0.5, "bfloat16"), (0.5, "float32")])
def test_prune_and_encode_stream_q8_bit_exact(sparsity, dtype):
    x = _q8_chunks(int(sparsity * 10) + 1)
    jf = jsf.ChunkFormat(C, D, _keep(sparsity), qbits=8)
    tf = tsf.ChunkFormat(C, D, _keep(sparsity), qbits=8)
    jx, tx = _both(x, dtype)
    jrows, jscales = (np.asarray(a) for a in
                      jax.jit(lambda a: jsf.prune_and_encode_stream_q8(a, jf))(jx))
    trows, tscales = tsf.prune_and_encode_stream_q8(tx, tf)
    assert trows.dtype == torch.int16 and trows.shape == (3, tf.stream_rows, 128)
    assert tscales.dtype == torch.float32 and tscales.shape == (3, 128)
    np.testing.assert_array_equal(trows.numpy(), jrows)
    np.testing.assert_array_equal(tscales.numpy(), jscales)
    # what the cache stores: the scales rounded to bf16
    np.testing.assert_array_equal(tscales.to(torch.bfloat16).float().numpy(),
                                  _np32(jnp.asarray(jscales).astype(jnp.bfloat16)))
    assert (tscales[:, 9] == 1e-8).all()                         # the all-zero channel
    codes = tsf.decode_stream(trows, tf)                         # int8 codes as f32
    assert (codes.abs() <= 127).all() and (codes.abs() == 127).any()
    assert (codes[:, :, 9] == 0).all()
    # every row stores exactly keep_stored slots, and the kept channels of
    # code 0 (channel 17 of chunk 2 but its largest) keep their bits
    bits = tsf.unpack_bitmap16(trows[:, tf.total_rows:], C)
    assert (bits.sum(-1) == tf.keep_stored).all()
    kept = tsf.topk_mask(tx, tf.keep)
    assert (bits.bool() >= kept).all()
    zero_kept = kept[2, :, 17] & (codes[2, :, 17] == 0)
    assert zero_kept.sum() > 0 and bits[2, :, 17][zero_kept].all()
    # the dequantized tile, bit for bit, against the jitted JAX decode
    jdec = np.asarray(jax.jit(lambda r, s: jsf.decode_stream_q8(r, s, jf))(
        jnp.asarray(jrows), jnp.asarray(jscales).astype(jnp.bfloat16)))
    tdec = tsf.decode_stream_q8(trows, tscales.to(torch.bfloat16), tf)
    assert tdec.dtype == torch.bfloat16
    np.testing.assert_array_equal(tdec.view(torch.int16).numpy(), jdec.view(np.int16))


def test_q8_scale_is_the_jitted_reciprocal_product():
    """The scale is amax * f32(1/127), as the served (jitted) JAX path
    computes it; a true division differs from it in some channels (and is
    what eager JAX gives)."""
    x = np.random.RandomState(12).randn(64, C, D).astype(np.float32)
    tf = tsf.ChunkFormat(C, D, 40, qbits=8)
    _, tscales = tsf.encode_stream_q8(torch.from_numpy(x), tf)
    amax = np.abs(x).max(axis=-2)
    divided = np.maximum(amax / np.float32(127.0), np.float32(1e-8))
    assert (tscales.numpy() != divided).any()
    jf = jsf.ChunkFormat(C, D, 40, qbits=8)
    _, jscales = jax.jit(lambda a: jsf.encode_stream_q8(a, jf))(jnp.asarray(x))
    np.testing.assert_array_equal(tscales.numpy(), np.asarray(jscales))


@pytest.mark.parametrize("sparsity", [0.7, 0.5])
def test_encode_and_decode_stream_q8_bit_exact(sparsity):
    """``encode_stream_q8`` of an already pruned chunk, and the decode of
    arbitrary int16 rows with arbitrary bf16 scales (random words and
    bytes: ranks past the stored count are clamped, as in JAX)."""
    jf = jsf.ChunkFormat(C, D, _keep(sparsity), qbits=8)
    tf = tsf.ChunkFormat(C, D, _keep(sparsity), qbits=8)
    x = _q8_chunks(4)
    keep = tsf.topk_mask(torch.from_numpy(x), tf.keep).numpy()
    pruned = np.where(keep, x, 0).astype(np.float32)
    jx, tx = _both(pruned, "bfloat16")
    jrows, jscales = jax.jit(lambda a: jsf.encode_stream_q8(a, jf))(jx)
    trows, tscales = tsf.encode_stream_q8(tx, tf)
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(tscales.numpy(), np.asarray(jscales))
    rs = np.random.RandomState(5)
    junk = rs.randint(-32768, 32768, (2, tf.stream_rows, 128)).astype(np.int16)
    scales = _np32(jnp.asarray(rs.rand(2, 128) * 0.05, jnp.bfloat16))
    jdec = np.asarray(jax.jit(lambda r, s: jsf.decode_stream_q8(r, s, jf))(
        jnp.asarray(junk), jnp.asarray(scales, jnp.bfloat16)))
    tdec = tsf.decode_stream_q8(torch.from_numpy(junk),
                                torch.from_numpy(scales).to(torch.bfloat16), tf)
    np.testing.assert_array_equal(tdec.view(torch.int16).numpy(), jdec.view(np.int16))


@pytest.mark.parametrize("sparsity,dtype", [(0.7, "bfloat16"), (0.7, "float32"),
                                            (0.5, "bfloat16"), (0.5, "float32")])
def test_prune_and_encode_stream_bit_exact(sparsity, dtype):
    x = _chunks(int(sparsity * 10))
    jf = jsf.ChunkFormat(C, D, _keep(sparsity))
    tf = tsf.ChunkFormat(C, D, _keep(sparsity))
    jx, tx = _both(x, dtype)
    jrows = np.asarray(jax.jit(lambda a: jsf.prune_and_encode_stream(a, jf))(jx))
    trows = tsf.prune_and_encode_stream(tx, tf)
    assert trows.dtype == torch.int16 and trows.shape == (3, tf.stream_rows, 128)
    np.testing.assert_array_equal(trows.numpy(), jrows)
    # every row stores exactly keep_stored slots (pads included)
    bits = tsf.unpack_bitmap16(trows[:, tf.total_rows:], C)
    assert (bits.sum(-1) == tf.keep_stored).all()
    jbits = np.asarray(jsf.unpack_bitmap16(jnp.asarray(jrows[:, jf.total_rows:])
                                           .view(jnp.uint16), C))
    np.testing.assert_array_equal(bits.numpy(), jbits)
    # the decoded tile, bit for bit (bf16 patterns)
    jdec = np.asarray(jax.jit(lambda r: jsf.decode_stream(r, jf))(jnp.asarray(jrows)))
    tdec = tsf.decode_stream(trows, tf)
    assert tdec.dtype == torch.bfloat16
    np.testing.assert_array_equal(tdec.view(torch.int16).numpy(),
                                  jdec.view(np.int16))
    # decode inverts the prune: the kept values at their channels, 0 elsewhere
    kept = tx.to(torch.bfloat16) * tsf.topk_mask(tx, tf.keep)
    np.testing.assert_array_equal(tdec.float().numpy(), kept.float().numpy())


@pytest.mark.parametrize("sparsity", [0.7, 0.5])
def test_encode_and_decode_stream_bit_exact(sparsity):
    """``encode_stream`` of an already pruned chunk, and ``decode_stream`` of
    arbitrary int16 rows (random words and values: ranks past the stored
    count are clamped, as in JAX)."""
    jf = jsf.ChunkFormat(C, D, _keep(sparsity))
    tf = tsf.ChunkFormat(C, D, _keep(sparsity))
    x = _chunks(3)
    keep = tsf.topk_mask(torch.from_numpy(x), tf.keep).numpy()
    pruned = np.where(keep, x, 0).astype(np.float32)
    jx, tx = _both(pruned, "bfloat16")
    jrows = np.asarray(jax.jit(lambda a: jsf.encode_stream(a, jf))(jx))
    np.testing.assert_array_equal(tsf.encode_stream(tx, tf).numpy(), jrows)
    junk = np.random.RandomState(4).randint(-32768, 32768, (2, tf.stream_rows, 128))
    junk = junk.astype(np.int16)
    junk[..., :tf.total_rows, :] &= 0x3FFF             # finite bf16 values
    jdec = np.asarray(jax.jit(lambda r: jsf.decode_stream(r, jf))(jnp.asarray(junk)))
    tdec = tsf.decode_stream(torch.from_numpy(junk), tf)
    np.testing.assert_array_equal(tdec.view(torch.int16).numpy(), jdec.view(np.int16))


def test_bitmap16_words_match_jax():
    """Word planes carry uint16 patterns in int16 (bit 15 set -> negative
    carrier), and unpacking widens before it shifts."""
    bits = (np.random.RandomState(5).rand(2, C, D) < 0.4).astype(np.int32)
    bits[:, 240:] = 1                                   # every word's bit 15
    jw = np.asarray(jsf.bitmap16(jnp.asarray(bits), C)).view(np.int16)
    tw = tsf.bitmap16(torch.from_numpy(bits), C)
    assert tw.dtype == torch.int16 and (tw < 0).any()
    np.testing.assert_array_equal(tw.numpy(), jw)
    np.testing.assert_array_equal(tsf.unpack_bitmap16(tw, C).numpy(), bits)


# ---------------------------------------------------------------------------
# (s) Split pools (the archived kernels' format): value segments in the
# dense dtype and a [C/32, D] uint32 bitmap, carried in int32 by the port.
# ---------------------------------------------------------------------------

def test_split_format_geometry_matches_jax():
    """planes, bytes_per_chunk, dense_bytes and compression_ratio for every
    keep, at both value widths."""
    for qbits in (16, 8):
        for keep in range(1, 129):
            jf = jsf.ChunkFormat(C, D, keep, qbits=qbits)
            tf = tsf.ChunkFormat(C, D, keep, qbits=qbits)
            assert (tf.planes, tf.bytes_per_chunk, tf.dense_bytes, tf.compression_ratio) == \
                (jf.planes, jf.bytes_per_chunk, jf.dense_bytes, jf.compression_ratio), keep
    tf = tsf.ChunkFormat(C, D, 40)
    assert (tf.planes, tf.bytes_per_chunk, tf.dense_bytes) == (8, 24_576, 65_536)
    assert tsf.ChunkFormat(C, D, 65).bytes_per_chunk == 38_912


def _words_i32(jbmp):
    """The JAX bitmap's uint32 words as the port's int32 carriers."""
    return np.asarray(jbmp).view(np.int32)


@pytest.mark.parametrize("sparsity,dtype", [(0.7, "bfloat16"), (0.7, "float32"),
                                            (0.5, "bfloat16"), (0.5, "float32")])
def test_prune_and_encode_chunk_bit_exact(sparsity, dtype):
    """Segments, words, unpacked bits and the decoded chunk, with ties, an
    all-zero row, -0.0 and words whose bit 31 is set (negative carriers)."""
    x = _chunks(int(sparsity * 10) + 5)
    jf = jsf.ChunkFormat(C, D, _keep(sparsity))
    tf = tsf.ChunkFormat(C, D, _keep(sparsity))
    jx, tx = _both(x, dtype)
    jsegs, jbmp = jax.jit(lambda a: jsf.prune_and_encode_chunk(a, jf))(jx)
    tsegs, tbmp = tsf.prune_and_encode_chunk(tx, tf)
    assert len(tsegs) == len(jf.segs)
    for ts, js, k in zip(tsegs, jsegs, jf.segs):
        assert ts.dtype == tx.dtype and ts.shape == (3, jf.seg_rows(k), 128)
        np.testing.assert_array_equal(ts.float().numpy(), _np32(js))
        assert (np.signbit(ts.float().numpy()) == np.signbit(_np32(js))).all()
    assert tbmp.dtype == torch.int32 and tbmp.shape == (3, tf.planes, D)
    np.testing.assert_array_equal(tbmp.numpy(), _words_i32(jbmp))
    assert (tbmp < 0).any()                                    # bit 31 set
    bits = tsf.unpack_bitmap(tbmp, tf)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jsf.unpack_bitmap(jbmp, jf)))
    assert (bits.sum(-1) == tf.keep_stored).all()              # pads included
    jdec = jax.jit(lambda s, b: jsf.decode_chunk(s, b, jf))(jsegs, jbmp)
    tdec = tsf.decode_chunk(tsegs, tbmp, tf)
    assert tdec.dtype == tx.dtype
    np.testing.assert_array_equal(tdec.float().numpy(), _np32(jdec))
    # decode inverts the prune: the kept values at their channels, 0 elsewhere
    kept = tx * tsf.topk_mask(tx, tf.keep)
    np.testing.assert_array_equal(tdec.float().numpy(), kept.float().numpy())


@pytest.mark.parametrize("sparsity", [0.7, 0.5])
def test_encode_and_decode_chunk_bit_exact(sparsity):
    """``encode_chunk`` of an already pruned chunk, and ``decode_chunk`` of
    arbitrary words and values (ranks past the stored count are clamped, as
    in JAX)."""
    jf = jsf.ChunkFormat(C, D, _keep(sparsity))
    tf = tsf.ChunkFormat(C, D, _keep(sparsity))
    x = _chunks(13)
    keep = tsf.topk_mask(torch.from_numpy(x), tf.keep).numpy()
    jx, tx = _both(np.where(keep, x, 0).astype(np.float32), "bfloat16")
    jsegs, jbmp = jax.jit(lambda a: jsf.encode_chunk(a, jf))(jx)
    tsegs, tbmp = tsf.encode_chunk(tx, tf)
    for ts, js in zip(tsegs, jsegs):
        np.testing.assert_array_equal(ts.view(torch.int16).numpy(),
                                      np.asarray(js).view(np.int16))
    np.testing.assert_array_equal(tbmp.numpy(), _words_i32(jbmp))
    rs = np.random.RandomState(14)
    words = rs.randint(-2 ** 31, 2 ** 31, (2, tf.planes, D), dtype=np.int64).astype(np.int32)
    segs = [_np32(jnp.asarray(rs.randn(2, tf.seg_rows(k), 128), jnp.bfloat16))
            for k in tf.segs]
    jdec = np.asarray(jax.jit(lambda s, b: jsf.decode_chunk(s, b, jf))(
        [jnp.asarray(s, jnp.bfloat16) for s in segs], jnp.asarray(words.view(np.uint32))))
    tdec = tsf.decode_chunk([torch.from_numpy(s).to(torch.bfloat16) for s in segs],
                            torch.from_numpy(words), tf)
    np.testing.assert_array_equal(tdec.view(torch.int16).numpy(), jdec.view(np.int16))
