"""Port parity, the bitmap chunk codec (``ops/sparse_format.py``).

(o) ``encode_stream``, ``decode_stream`` and ``prune_and_encode_stream``
    are bit-exact with the jitted JAX package: the int16 stream rows (value
    segments and bitmap word planes) and the decoded bf16 tile, at sparsity
    0.7 (keep 40 = 32 + 8) and 0.5 (keep 65 stored as 68 = 64 + 4, so rows
    carry zero pads), from bf16 and from f32 input.  The rows hold exact
    zeros (whole rows, most of a row, -0.0) and magnitude ties, where the
    keep rule and the pads must pick the same channels as JAX.
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
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 11"):
        tsf.ChunkFormat(C, D, 40, qbits=8)


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
