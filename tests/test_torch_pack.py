"""Port parity, the prune + quantize + pack module (TPU kernel 9).

(t) The plain ``prune_quant_pack`` against the JAX package's
    ``prune_quant_pack`` run in Pallas interpret mode, on the cases and
    inputs of its own test (``tests/test_quant_codec.py``: bits 8 and 4;
    keep 40, 14 and 128; with and without an f32 score; injected ties and an
    all-zero row): scales and keep masks bit-exact, codes equal but for +-1
    where x / scale lies on an exact half step (the JAX test's own allowance
    between its kernel and XLA).
(u) The plain version is the port's chain (``sparse_format.topk_mask``, then
    ``quant_format.encode_chunk``), bit for bit, on [BH, C, 128] and on the
    cache's strided [B, H, C, 128] views written into output views.
(v) The wrapper refuses what the CUDA kernel cannot serve instead of falling
    back.
The CUDA kernel runs only on the card: ``chip_smoke.py`` holds it bit-equal
to the plain version there.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mustafar_tpu.ops import quant_format as jqf
from mustafar_tpu.ops import sparse_format as jsf
from mustafar_tpu.ops.kernels.pack_kernel import prune_quant_pack as j_prune_quant_pack
from mustafar_tpu_torch.ops import quant_format as tqf
from mustafar_tpu_torch.ops import sparse_format as tsf
from mustafar_tpu_torch.ops.kernels import pack_kernel as tpk

torch.set_num_threads(2)

BH, C, D = 4, 256, 128


def _chunk(seed):
    """The JAX test's chunk: 0.3 * randn in bf16, channel 10 tied to channel
    90, token 5 all zero (as numpy f32 holding bf16 values)."""
    rs = np.random.RandomState(seed)
    x = jnp.asarray(rs.randn(BH, C, D) * 0.3, jnp.bfloat16)
    x = x.at[:, :, 10].set(x[:, :, 90])
    x = x.at[:, 5, :].set(0)
    return np.asarray(x).astype(np.float32), rs


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("bits,keep,use_score", [(8, 40, False), (4, 40, False),
                                                 (8, 14, False), (8, 40, True),
                                                 (8, 128, False)])
def test_plain_matches_jax_kernel(bits, keep, use_score):
    x, rs = _chunk(42)
    score = rs.rand(BH, C, D).astype(np.float32) if use_score else None
    j_rows, j_scales = j_prune_quant_pack(
        jnp.asarray(x, jnp.bfloat16), keep, bits,
        score=None if score is None else jnp.asarray(score))
    before = tpk.prune_quant_pack.launches
    t_rows, t_scales = tpk.prune_quant_pack(
        _bf16(x), keep, bits, None if score is None else torch.from_numpy(score))
    assert tpk.prune_quant_pack.launches == before              # CPU: no launch
    assert t_rows.dtype == torch.int16 and t_rows.shape == (BH, C * bits // 16, D)
    assert t_scales.dtype == torch.bfloat16 and t_scales.shape == (BH, D)
    np.testing.assert_array_equal(t_scales.float().numpy(),
                                  np.asarray(j_scales).astype(np.float32))
    j_codes = np.asarray(jqf.unpack_rows(j_rows, bits))
    t_codes = tqf.unpack_rows(t_rows, bits).numpy()
    # the keep mask of each side, from the same selection key
    sel = x if score is None else score
    mask = np.asarray(jsf.topk_mask(jnp.asarray(sel, jnp.bfloat16 if score is None
                                                else jnp.float32), keep))
    np.testing.assert_array_equal(t_codes == 0, j_codes == 0)
    assert (t_codes[~mask] == 0).all()
    # every kept row holds exactly `keep` entries (ties included)
    assert (mask.sum(-1) == min(keep, D)).all()
    diff = np.abs(t_codes - j_codes)
    assert diff.max() <= 1, diff.max()
    # each +-1 sits on an exact half step of x / scale (the f32 scale)
    pruned = np.where(mask, x, 0).astype(np.float32)
    qmax = 2.0 ** (bits - 1) - 1
    sc = np.maximum(np.abs(pruned).max(axis=1) / qmax, 1e-8).astype(np.float32)
    for b, t, d in np.argwhere(diff == 1):
        ratio = np.float32(pruned[b, t, d]) / sc[b, d]
        assert abs(abs(ratio) % 1.0 - 0.5) < 1e-4, (b, t, d, ratio)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("keep", [1, 40, 127, 128])
def test_plain_is_the_ports_chain(bits, keep):
    """Bit-exact with topk_mask + encode_chunk (which test_torch_numerics
    holds bit-exact against jitted JAX), with a score too."""
    x, rs = _chunk(bits + keep)
    tx = _bf16(x)
    tx[:, 7, :] = 0.5                                 # a row of equal magnitudes
    codec = tqf.QuantCodec(C, D, bits, bits)
    want = tqf.encode_chunk(torch.where(tsf.topk_mask(tx, keep), tx, 0), codec, "k")
    got = tpk.prune_quant_pack(tx, keep, bits)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    score = torch.from_numpy(rs.rand(BH, C, D).astype(np.float32))
    want = tqf.encode_chunk(torch.where(tsf.topk_mask(score, keep), tx, 0), codec, "k")
    got = tpk.prune_quant_pack(tx, keep, bits, score)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_strided_views_in_and_out():
    """The cache's layouts: a prompt slice [B, H, C, D] of k [B, T, H, D]
    (transposed), packed into the K rows of a pool slot [B, H, ROWS, D] and
    the K column of its scales [B, H, 2, D]; the rest of the slot is left as
    it was."""
    rs = np.random.RandomState(3)
    B, H, T = 2, 2, 512
    k = _bf16((rs.randn(B, T, H, D) * 0.4).astype(np.float32))
    view = k.transpose(1, 2)[:, :, 256:512]
    assert not view.is_contiguous()
    pool = torch.full((B, H, 192, D), 7, dtype=torch.int16)
    scales = torch.full((B, H, 2, D), 3.0, dtype=torch.bfloat16)
    rows, sc = tpk.prune_quant_pack(view, 40, 8, rows_out=pool[:, :, :128],
                                    scales_out=scales[:, :, 0])
    assert rows.data_ptr() == pool.data_ptr() and sc.data_ptr() == scales.data_ptr()
    want_rows, want_sc = tpk.prune_quant_pack(view.reshape(B * H, 256, D).contiguous(),
                                              40, 8)
    assert torch.equal(pool[:, :, :128].reshape(B * H, 128, D), want_rows)
    assert torch.equal(scales[:, :, 0].reshape(B * H, D), want_sc)
    assert (pool[:, :, 128:] == 7).all() and (scales[:, :, 1] == 3.0).all()


def test_wrapper_refuses_what_the_kernel_cannot_serve():
    x = _bf16(_chunk(5)[0])
    tpk.prune_quant_pack(x, 40, 8)
    rows = torch.empty((BH, 128, D), dtype=torch.int16)
    sc = torch.empty((BH, D), dtype=torch.bfloat16)
    bad = [
        dict(x=x.float()),                                     # not bf16
        dict(x=x.to(torch.float16)),
        dict(x=x[..., :64]),                                   # D != 128
        dict(x=x[:, :18], bits=4),                             # C not a multiple of 16/bits
        dict(x=x[:, :64]),                                     # nor of the kernel's 128
        dict(bits=2), dict(keep=0), dict(keep=40.0),
        dict(score=torch.rand((BH, C, D), dtype=torch.float64)),
        dict(score=torch.rand((BH, C, D)).to("meta")),         # mismatched devices
        dict(rows_out=rows),                                   # scales_out missing
        dict(rows_out=rows.to("meta"), scales_out=sc),
        dict(rows_out=rows[:, :64], scales_out=sc),            # wrong shape
        dict(rows_out=rows.int(), scales_out=sc),
        dict(x=x.to("meta")),                                  # the meta device
    ]
    for change in bad:
        args = dict(dict(x=x, keep=40, bits=8), **change)
        x_, keep, bits = args.pop("x"), args.pop("keep"), args.pop("bits")
        with pytest.raises((ValueError, TypeError)):
            tpk.prune_quant_pack(x_, keep, bits, **args)
