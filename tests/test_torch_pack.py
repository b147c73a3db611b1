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
(w) K and V in one call (``prune_quant_pack_kv``) equal two one-tensor calls
    bit for bit in the cache's layouts: prefill's chunk axis into pool slots,
    a compaction's layer axis into every layer's slot; it refuses mismatched
    K and V, keep < 1 and layouts the kernel's 16-byte copies cannot take.
(x) The grid rule (``pack_grid``, pure): whole carrier rows in every CTA, a
    row group for every warp, the engine's batch-1 pack on at least 132
    CTAs, and clusters halved to fit the card's capacity.
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

torch.set_num_threads(1)

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


# (w) K and V in one launch (``prune_quant_pack_kv``): on the CPU each is the
# plain version, bit for bit two single-tensor calls, in the cache's layouts.
KV_CODECS = [pytest.param(8, 4, 40, 14, id="q8q4"), pytest.param(8, 8, 40, 77, id="q8"),
             pytest.param(4, 4, 14, 40, id="q4q4")]


def _kv_pool(L, mc, B, H, rows):
    """A stacked pool and scales of sentinels, to see what a pack leaves."""
    return (torch.full((L, mc, B, H, rows, D), 7, dtype=torch.int16),
            torch.full((L, mc, B, H, 2, D), 3.0, dtype=torch.bfloat16))


def _assert_kv_slots(pool, scales, KR, want_k, want_v):
    assert torch.equal(pool[..., :KR, :], want_k[0])
    assert torch.equal(pool[..., KR:, :], want_v[0])
    assert torch.equal(scales[..., 0, :], want_k[1])
    assert torch.equal(scales[..., 1, :], want_v[1])


@pytest.mark.parametrize("k_bits,v_bits,k_keep,v_keep", KV_CODECS)
def test_kv_prefill_chunks_into_pool_views(k_bits, v_bits, k_keep, v_keep):
    """Prefill's layout: the prompt's three chunks [3, B, H, C, D], views of
    k and v [B, T, H, D] (transposed), into pool slots 0-2 of layer 1 (K
    rows, then V rows) and the scales' K and V columns, in one call; every
    other slot, layer and row is left as it was."""
    rs = np.random.RandomState(k_bits * 100 + k_keep)
    B, H, T, L, mc = 2, 2, 3 * C + 40, 2, 5
    k, v = (_bf16((rs.randn(B, T, H, D) * 0.4).astype(np.float32)) for _ in range(2))
    kc, vc = (x.transpose(1, 2)[:, :, :3 * C].unflatten(2, (3, C)).movedim(2, 0)
              for x in (k, v))
    assert not kc.is_contiguous() and kc.shape == (3, B, H, C, D)
    KR = C * k_bits // 16
    pool, scales = _kv_pool(L, mc, B, H, KR + C * v_bits // 16)
    before = tpk.prune_quant_pack_kv.launches
    tpk.prune_quant_pack_kv(kc, vc, k_keep, v_keep, k_bits, v_bits,
                            k_out=(pool[1, :3, ..., :KR, :], scales[1, :3, ..., 0, :]),
                            v_out=(pool[1, :3, ..., KR:, :], scales[1, :3, ..., 1, :]))
    assert tpk.prune_quant_pack_kv.launches == before               # CPU: no launch
    for i in range(3):
        _assert_kv_slots(pool[1, i], scales[1, i], KR,
                         tpk.prune_quant_pack(kc[i].contiguous(), k_keep, k_bits),
                         tpk.prune_quant_pack(vc[i].contiguous(), v_keep, v_bits))
    assert (pool[0] == 7).all() and (pool[1, 3:] == 7).all()
    assert (scales[0] == 3.0).all() and (scales[1, 3:] == 3.0).all()


@pytest.mark.parametrize("k_bits,v_bits,k_keep,v_keep", KV_CODECS)
def test_kv_compaction_layers_into_pool_views(k_bits, v_bits, k_keep, v_keep):
    """A compaction's layout: every layer's window [L, B, H, r + C, D], its
    oldest C tokens, into pool slot nc of every layer in one call."""
    rs = np.random.RandomState(k_bits * 100 + v_keep)
    L, B, H, W, mc, nc = 3, 2, 2, 32 + C, 4, 2
    k_win, v_win = (_bf16((rs.randn(L, B, H, W, D) * 0.4).astype(np.float32))
                    for _ in range(2))
    KR = C * k_bits // 16
    pool, scales = _kv_pool(L, mc, B, H, KR + C * v_bits // 16)
    (kr, ks), (vr, vs) = tpk.prune_quant_pack_kv(
        k_win[..., :C, :], v_win[..., :C, :], k_keep, v_keep, k_bits, v_bits,
        k_out=(pool[:, nc, ..., :KR, :], scales[:, nc, ..., 0, :]),
        v_out=(pool[:, nc, ..., KR:, :], scales[:, nc, ..., 1, :]))
    assert kr.data_ptr() == pool[:, nc].data_ptr() and vs.shape == (L, B, H, D)
    for li in range(L):
        _assert_kv_slots(pool[li, nc], scales[li, nc], KR,
                         tpk.prune_quant_pack(k_win[li, :, :, :C], k_keep, k_bits),
                         tpk.prune_quant_pack(v_win[li, :, :, :C], v_keep, v_bits))
    others = [i for i in range(mc) if i != nc]
    assert (pool[:, others] == 7).all() and (scales[:, others] == 3.0).all()


def test_kv_without_outputs_allocates():
    x = _bf16(_chunk(6)[0])
    (kr, ks), (vr, vs) = tpk.prune_quant_pack_kv(x, x.flip(1), 40, 14, 8, 4)
    assert kr.shape == (BH, 128, D) and vr.shape == (BH, 64, D) and vs.shape == (BH, D)
    for got, want in zip((kr, ks, vr, vs), (*tpk.prune_quant_pack(x, 40, 8),
                                            *tpk.prune_quant_pack(x.flip(1), 14, 4))):
        assert torch.equal(got, want)


def _misaligned(shape, dtype):
    """A tensor of ``shape`` whose data starts 8 bytes past a 16-byte line."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + 16, dtype=dtype)
    off = (-buf.data_ptr() % 16 + 8) // buf.element_size()
    return buf[off:off + n].view(shape)


def test_kv_wrapper_refuses_what_the_kernel_cannot_serve():
    """Mismatched K and V, keep < 1, bits, devices, and the layouts the
    kernel's 16-byte copies cannot take: refused on the CPU too."""
    k = _bf16(_chunk(7)[0]).reshape(2, 2, C, D)
    v = k.flip(2)
    rows = torch.empty((2, 2, 128, D), dtype=torch.int16)
    sc = torch.empty((2, 2, D), dtype=torch.bfloat16)
    tpk.prune_quant_pack_kv(k, v, 40, 14, 8, 4)
    bad = [
        dict(v=v[:1]),                                         # shapes differ
        dict(v=v.reshape(4, C, D)),
        dict(v=v.to("meta")),                                  # devices differ
        dict(k_keep=0), dict(v_keep=0), dict(v_keep=-3), dict(k_keep=40.0),
        dict(v_bits=2), dict(k=k.float()),
        dict(k=_misaligned(k.shape, torch.bfloat16)),          # 8-byte aligned x
        dict(v=torch.zeros((2, 2, C, 132), dtype=torch.bfloat16)[..., :D]),  # token stride
        dict(k_out=(_misaligned(rows.shape, torch.int16), sc)),
        dict(k_out=(torch.zeros((2, 2, 128, 132), dtype=torch.int16)[..., :D], sc)),
        dict(k_out=(rows[:, :, :64], sc)),                     # wrong rows
        dict(k_out=(rows, None)),
    ]
    for change in bad:
        args = dict(dict(k=k, v=v, k_keep=40, v_keep=14, k_bits=8, v_bits=4), **change)
        with pytest.raises((ValueError, TypeError)):
            tpk.prune_quant_pack_kv(args.pop("k"), args.pop("v"), args.pop("k_keep"),
                                    args.pop("v_keep"), args.pop("k_bits"),
                                    args.pop("v_bits"), **args)


def test_single_wrapper_refuses_misaligned_layouts():
    x = _bf16(_chunk(8)[0])
    for kw in (dict(x=_misaligned(x.shape, torch.bfloat16)),
               dict(x=torch.zeros((BH, C, 132), dtype=torch.bfloat16)[..., :D]),
               dict(score=_misaligned(x.shape, torch.float32)),
               dict(rows_out=_misaligned((BH, 128, D), torch.int16),
                    scales_out=torch.empty((BH, D), dtype=torch.bfloat16))):
        args = dict(dict(x=x), **kw)
        with pytest.raises(ValueError):
            tpk.prune_quant_pack(args.pop("x"), 40, 8, **args)


# (x) The grid rule (pure, on the host): one thread block cluster a
# head-chunk, every CTA with whole carrier rows and every warp with rows.
# H100_CLUSTERS: how many clusters of (cluster, threads) an NVIDIA H100
# 80GB HBM3 holds at once at C = 256 (cudaOccupancyMaxActiveClusters, as
# chip_smoke.py's kernel_pack phase prints them).
H100_CLUSTERS = {(1, 512): 264, (2, 512): 132, (4, 512): 62, (8, 256): 62, (16, 128): 58}


@pytest.mark.parametrize("n_hc", [1, 8, 16, 64, 128, 4096])
@pytest.mark.parametrize("C", [128, 256, 384, 512])
def test_pack_grid(n_hc, C):
    for score in (False, True):
        cluster, threads = tpk.pack_grid(n_hc, C, score)
        assert 1 <= cluster <= tpk.MAX_CLUSTER and cluster & (cluster - 1) == 0
        tokens = C // cluster
        assert tokens * cluster == C and tokens % 4 == 0 and tokens >= 16
        for bits in (8, 4):                   # whole carrier rows in each CTA
            R = C * bits // 16
            assert R % cluster == 0 and R // cluster >= 1
        warps = threads // 32
        assert threads == 32 * warps and 4 <= warps <= tpk.MAX_WARPS
        assert warps * 4 <= tokens <= 8 * 4 * warps   # every warp 1-8 groups of rows
        if score:
            assert tokens <= tpk.MAX_SCORE_TOKENS
        lo = 2 if score and C > tpk.MAX_SCORE_TOKENS else 1
        # the least cluster that gives every SM a CTA, no more
        assert cluster == lo or n_hc * (cluster // 2) < 132
        assert n_hc * cluster >= 132 or cluster == min(16, C // 16)


def test_pack_grid_at_the_serving_shapes():
    """The engine's batch-1 pack (8 kv heads, K and V: 16 head-chunks) fills
    at least the card's 132 SMs; 64 head-chunks take 2-CTA clusters where
    the 4-CTA ones would not all be resident at once (64 > 62); a
    compaction of 32 layers at B=8 (4,096 head-chunks with K and V) is not
    split; every cluster size is the rule's at some head-chunk count (the
    counts chip_smoke.py's kernel_pack phase checks each size at)."""
    def cap(s, t):
        return H100_CLUSTERS[(s, t)]
    for capacity in (None, cap):
        cluster, threads = tpk.pack_grid(16, 256, capacity=capacity)
        assert 16 * cluster >= 132 and (cluster, threads) == (16, 128)
        assert tpk.pack_grid(32 * 64 * 2, 256, capacity=capacity) == (1, 512)
    assert tpk.pack_grid(64, 256) == (4, 512)
    assert tpk.pack_grid(64, 256, capacity=cap) == (2, 512)
    for n_hc, grid in ((8, (16, 128)), (24, (8, 256)), (32, (8, 256)), (48, (4, 512)),
                       (100, (2, 512)), (130, (2, 512)), (132, (1, 512)),
                       (264, (1, 512))):
        assert tpk.pack_grid(n_hc, 256, capacity=cap) == grid
        assert tpk.pack_grid(n_hc, 256) == grid
