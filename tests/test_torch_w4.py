"""Port parity, W4 weights (int4 codes in int16 nibble carriers, bf16 block
scales) and ``fuse_projections``.

(t) Carriers and scales of ``_quant_block4``, ``pack_w4``, ``_quant_pack_w4``
    and ``quantize_params_w4`` equal jitted JAX's bit for bit (jitted XLA
    takes ``amax / 7`` as a product with the f32 reciprocal), on stacked
    leaves with DIN = 384 and negative top nibbles; ``unpack_w4`` inverts
    ``pack_w4``; ``init_params_w4`` has JAX's keys, shapes and dtypes;
    ``params_from_jax`` carries W4 and fused params unchanged.
(u) Kernel 5's plain version (``ops/kernels/w4_matmul.py``) against the
    JAX kernel in Pallas interpret mode, T in {1, 8, 13}, DOUT in {128,
    384}, stacked carriers at a layer; the wrapper refuses what the CUDA
    kernel cannot take, and ``_w4_dot`` sends at most 128 tokens off the
    CPU to the kernel, more to the dequant route; the kernel's persistent
    grid (``partition``) covers every work unit once, and the wrapper
    refuses a short workspace.
(v) The port's CPU ``proj`` on int16 weights against JAX's ``quant.proj``
    (both the off-TPU dequant route); fused and unfused params give the
    same logits, and the same as JAX's fused params.
(w) Greedy W4 generation against the JAX package, teacher-forced as in
    ``test_torch_generate.py``: the ``Generator`` on the dense cache (plain
    decode and the dense flash-decode kernel, ``use_pallas``), q8q4 and
    bitmap; the continuous-batching engine on q8q4 and bitmap.  The JAX
    compressed caches decode through their kernels in interpret mode.
Tiny geometry: head_dim 128, 4 query heads over 1 kv head, hidden 256,
intermediate 256, 2 layers (every projection's DIN a multiple of 128).
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mustafar_tpu import config as jc
from mustafar_tpu.models import llama as jl
from mustafar_tpu.models import quant as jq
from mustafar_tpu.ops.kernels.w4_matmul import w4_matmul as j_w4_matmul
from mustafar_tpu.runtime.generate import Generator as JGenerator
from mustafar_tpu.runtime.scheduler import ContinuousBatchingEngine as JEngine
from mustafar_tpu_torch import config as tc
from mustafar_tpu_torch.models import llama as tl
from mustafar_tpu_torch.models import quant as tq
from mustafar_tpu_torch.ops.kernels import w4_matmul as tw
from mustafar_tpu_torch.runtime.generate import Generator as TGenerator
from mustafar_tpu_torch.runtime.scheduler import ContinuousBatchingEngine as TEngine
from mustafar_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)

# logit noise allowed at a near-tie (as test_torch_generate.py): the
# compressed kernels round q, the window and p to bf16; dense is f32
# throughout, the flash-decode kernel rounds q, K, V and p to bf16
TIE_TOL = {("DENSE", False): 1e-4, ("DENSE", True): 1e-2, ("COMPRESSED", True): 1e-2}


def _model(mod):
    return dataclasses.replace(mod.TINY_LLAMA, head_dim=128, num_heads=4,
                               num_kv_heads=1, hidden_size=256)


def _flat(p):
    out = {k: v for k, v in p.items() if k != "layers"}
    out.update({"layers/" + k: v for k, v in p["layers"].items()})
    return out


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@functools.cache
def _j_w4_params(seed, fuse=False):
    """JAX W4 params of an f32 model (quantized jitted per leaf; norms f32)
    and the port's copy of them, made once a module for each (seed, fuse)."""
    jp = jq.quantize_params_w4(jl.init_params(_model(jc), jax.random.PRNGKey(seed),
                                              dtype=jnp.float32))
    if fuse:
        jp = jq.fuse_projections(jp)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


# -- (t) quantization and layout -------------------------------------------

def _stacked_weight(seed):
    """[2, 384, 256] f32 weights with some blocks all negative, so that top
    nibbles are negative too."""
    rs = np.random.RandomState(seed)
    w = (rs.randn(2, 384, 256) * 0.05).astype(np.float32)
    w[1, 128:256] = -np.abs(w[1, 128:256])
    return w


@pytest.mark.parametrize("fn", ["_quant_block4", "pack_w4", "_quant_pack_w4"])
def test_quantize_and_pack_bit_exact(fn):
    w = _stacked_weight(0)
    if fn == "_quant_block4":
        want = jax.jit(jq._quant_block4)(jnp.asarray(w))
        got = tq._quant_block4(torch.from_numpy(w))
    elif fn == "pack_w4":
        codes = np.random.RandomState(1).randint(-8, 8, size=w.shape).astype(np.int8)
        want = (jax.jit(jq.pack_w4)(jnp.asarray(codes)),)
        got = (tq.pack_w4(torch.from_numpy(codes)),)
        assert (got[0] < 0).any()
    else:
        want = jax.jit(jq._quant_pack_w4)(jnp.asarray(w))      # lax.map per layer
        got = tq._quant_pack_w4(torch.from_numpy(w))
        assert got[0].dtype == torch.int16 and got[1].dtype == torch.bfloat16
        assert tuple(got[0].shape) == (2, 96, 256) and tuple(got[1].shape) == (2, 3, 256)
        assert (got[0] < 0).any()
    for j, t in zip(want, got):
        np.testing.assert_array_equal(_np(t), np.asarray(j).astype(_np(t).dtype))


def test_unpack_inverts_pack():
    codes = np.random.RandomState(2).randint(-8, 8, size=(3, 256, 128)).astype(np.int8)
    carriers = tq.pack_w4(torch.from_numpy(codes))
    np.testing.assert_array_equal(tq.unpack_w4(carriers).numpy(), codes)
    np.testing.assert_array_equal(tq.unpack_w4(carriers).numpy(),
                                  np.asarray(jq.unpack_w4(jnp.asarray(carriers.numpy()))))


def test_quantize_params_w4_bit_exact():
    """Whole params: carriers, bf16 block scales, the W8 embedding and head,
    norms; idempotent; ``params_from_jax`` carries JAX's W4 params (and
    their fused form) unchanged."""
    jp = jl.init_params(_model(jc), jax.random.PRNGKey(3), dtype=jnp.bfloat16)
    jq4 = jax.tree.map(np.asarray, jq.quantize_params_w4(jp))
    tq4 = tq.quantize_params_w4(params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))
    assert tq.quantize_params_w4(tq4)["layers"]["wq"] is tq4["layers"]["wq"]
    flat_j, flat_t = _flat(jq4), _flat(tq4)
    assert sorted(flat_t) == sorted(flat_j)
    for key, jv in flat_j.items():
        tv = _np(flat_t[key])
        assert str(flat_t[key].dtype).split(".")[-1] == jv.dtype.name, key
        np.testing.assert_array_equal(tv, jv.astype(tv.dtype), err_msg=key)
    assert tq4["layers"]["w_down"].dtype == torch.int16 and tq4["lm_head"].dtype == torch.int8
    fused = jax.tree.map(np.asarray, jq.fuse_projections(jq.quantize_params_w4(jp)))
    assert fused["layers"]["wqkv"].dtype == np.int16
    for tree in (jq4, fused):
        carried = _flat(params_from_jax(tree, device="cpu"))
        assert sorted(carried) == sorted(_flat(tree))
        for key, jv in _flat(tree).items():
            assert str(carried[key].dtype).split(".")[-1] == jv.dtype.name, key
            np.testing.assert_array_equal(_np(carried[key]), jv.astype(_np(carried[key]).dtype),
                                          err_msg=key)


def test_init_params_w4_structure():
    cfg = _model(tc)
    g = torch.Generator(device="cpu")
    g.manual_seed(0)
    tp = tq.init_params_w4(cfg, g, device="cpu")
    jp = jax.eval_shape(lambda: jq.init_params_w4(_model(jc), jax.random.PRNGKey(0)))
    flat_t, flat_j = _flat(tp), _flat(jp)
    assert sorted(flat_t) == sorted(flat_j)
    for key, jv in flat_j.items():
        assert tuple(flat_t[key].shape) == jv.shape, key
        assert str(flat_t[key].dtype).split(".")[-1] == jv.dtype.name, key
    assert tq.weight_bytes(tp) == sum(int(np.prod(v.shape)) * v.dtype.itemsize
                                      for v in jax.tree.leaves(jp))
    # blocked int4: every (block, out channel) reaches +-7
    codes = tq.unpack_w4(tp["layers"]["w_up"][1]).reshape(2, 128, -1)
    assert (codes.abs().amax(1) == 7).all()
    # one seed, the same underlying weights as init_params_w8
    g.manual_seed(0)
    w8 = tq.init_params_w8(cfg, g, device="cpu")
    assert torch.equal(w8["embed"], tp["embed"]) and torch.equal(w8["lm_head"], tp["lm_head"])
    g.manual_seed(0)
    assert torch.equal(tq.init_params_w4(cfg, g, device="cpu")["layers"]["wq"],
                       tp["layers"]["wq"])


# -- (u) kernel 5's plain version and the wrapper ---------------------------

def _w4_inputs(seed, T, din, dout, L=2):
    rs = np.random.RandomState(seed)
    codes = rs.randint(-7, 8, size=(L, din, dout)).astype(np.int8)
    carriers = np.asarray(jq.pack_w4(jnp.asarray(codes)))
    scales = (0.001 + 0.02 * rs.rand(L, din // 128, dout)).astype(np.float32)
    x = rs.randn(T, din).astype(np.float32)
    return x, carriers, scales


@pytest.mark.parametrize("dout", [128, 384])
@pytest.mark.parametrize("T", [1, 8, 13])
def test_w4_matmul_plain_matches_jax_kernel(T, dout):
    """Stacked carriers [2, 96, DOUT] at layer 1 (JAX selects it with ``li``,
    the port takes the layer's view, as its forward pass does), x f32 (read
    as bf16, out f32) and bf16.  Both sum exact bf16 x code products in f32,
    block by block, in another order within a block: f32 output within 1e-6
    of its scale; bf16 output within one bf16 ulp of its scale."""
    x, carriers, scales = _w4_inputs(T * dout, T, 384, dout)
    for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-6),
                         (torch.bfloat16, jnp.bfloat16, 2.0 ** -8)):
        want = np.asarray(j_w4_matmul(jnp.asarray(x, jdt), jnp.asarray(carriers),
                                      jnp.asarray(scales, jnp.bfloat16), li=jnp.int32(1),
                                      interpret=True)).astype(np.float32)
        before = tw.w4_matmul.launches
        got = tw.w4_matmul(torch.from_numpy(x).to(dt), torch.from_numpy(carriers)[1],
                           torch.from_numpy(scales).to(torch.bfloat16)[1])
        assert tw.w4_matmul.launches == before      # the CPU launches nothing
        assert got.dtype == dt and tuple(got.shape) == (T, dout)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=tol * np.abs(want).max())


def test_w4_wrapper_refuses_what_the_kernel_cannot_serve():
    x, carriers, scales = _w4_inputs(5, 4, 256, 128)
    ok = dict(x=torch.from_numpy(x), carriers=torch.from_numpy(carriers[0]),
              scales=torch.from_numpy(scales[0]).to(torch.bfloat16))
    tw.w4_matmul(**ok)
    bad = [
        dict(x=torch.from_numpy(x[:, :200].copy())),                 # DIN % 128
        dict(x=torch.from_numpy(x[:, :128].copy())),                 # carriers' DIN
        dict(carriers=torch.from_numpy(carriers[0]).to(torch.int32)),
        dict(scales=torch.from_numpy(scales[0])),                    # f32 scales
        dict(carriers=torch.from_numpy(carriers[0][:, :64].copy()),
             scales=torch.from_numpy(scales[0][:, :64]).to(torch.bfloat16)),  # DOUT % 128
        dict(carriers=torch.from_numpy(carriers)),                   # stacked
        dict(x=torch.from_numpy(x).to(torch.float16)),
        dict(carriers=torch.from_numpy(carriers[0]).t().contiguous().t()),
    ]
    for change in bad:
        with pytest.raises((ValueError, TypeError)):
            tw.w4_matmul(**dict(ok, **change))
    # a device the kernel does not run on is refused, never computed on the CPU
    with pytest.raises(ValueError, match="unsupported device"):
        tw.w4_matmul(**{k: v.to("meta") for k, v in ok.items()})


def test_w4_dot_takes_the_kernel_up_to_128_tokens():
    """Off the CPU, ``_w4_dot`` hands at most 128 tokens to the kernel's
    wrapper (which refuses a device it cannot launch on: here the meta
    device), a batch-1 prompt of 128 tokens too; at 129 it takes the
    dequant route, which runs on any device."""
    x, carriers, scales = _w4_inputs(6, 1, 256, 128)
    w = torch.from_numpy(carriers[0]).to("meta")
    s = torch.from_numpy(scales[0]).to(torch.bfloat16).to("meta")
    for shape in ((1, 128, 256), (8, 1, 256), (128, 256)):
        with pytest.raises(ValueError, match="unsupported device"):
            tq._w4_dot(torch.empty(shape, device="meta"), w, s)
    out = tq._w4_dot(torch.empty((1, 129, 256), device="meta"), w, s)
    assert tuple(out.shape) == (1, 129, 128)


# every Llama-3-8B projection (DIN, DOUT) and the fused wqkv / w_gateup, as
# chip_smoke.W4_SHAPES
W4_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 6144),
             (4096, 28672))
H100_SMS = 132


@pytest.mark.parametrize("T", [1, 8, 13, 32, 100, 128])
@pytest.mark.parametrize("din,dout", W4_SHAPES)
def test_w4_partition_covers_every_unit_once(din, dout, T):
    """The kernel's persistent grid on an H100 (132 SMs): the CTAs' unit
    ranges follow each other and cover every (token tile, column tile, scale
    block) unit once, in order, each CTA at least one; at most two CTAs an
    SM; a column tile split over CTAs is each one's first or last tile, so
    two workspace slots a CTA hold every partial, and the workspace's floats
    fit the C entry's int."""
    part = tw.partition(T, din, dout, H100_SMS)
    assert part.tok == (8 if T <= 8 else 16 if T <= 16 else 32)
    assert part.token_tiles * part.tok >= T > (part.token_tiles - 1) * part.tok
    assert (part.tiles, part.blocks) == (dout // 128, din // 128)
    assert 1 <= part.ctas <= min(tw.CTAS_PER_SM * H100_SMS, part.units)
    bounds = [part.first(c) for c in range(part.ctas + 1)]
    assert bounds[0] == 0 and bounds[-1] == part.units
    assert all(a < b for a, b in zip(bounds, bounds[1:]))
    seen = [(tt, tile, blk) for u in range(part.units)
            for tt, rem in [divmod(u, part.tiles * part.blocks)]
            for tile, blk in [divmod(rem, part.blocks)]]
    assert seen == [(tt, tile, blk) for tt in range(part.token_tiles)
                    for tile in range(part.tiles) for blk in range(part.blocks)]
    for c in range(part.ctas):
        keys = range(bounds[c] // part.blocks, (bounds[c + 1] - 1) // part.blocks + 1)
        partial = [k for k in keys
                   if not (bounds[c] <= k * part.blocks
                           and (k + 1) * part.blocks <= bounds[c + 1])]
        assert set(partial) <= {keys[0], keys[-1]}
    assert part.ws_floats == part.ctas * tw.SLOTS_PER_CTA * part.tok * 128 < 2 ** 31
    assert part.n_counters == part.token_tiles * part.tiles


def test_w4_wrapper_refuses_a_short_workspace(monkeypatch):
    """Off the CPU the wrapper refuses a workspace or counter array shorter
    than its grid needs before it launches (here on meta tensors, with the
    stream and the card's SM count stood in); the C entry checks the sizes
    too.  Buffers of the right size go on to the launch."""
    x = torch.empty((8, 4096), dtype=torch.bfloat16, device="meta")
    c = torch.empty((1024, 14336), dtype=torch.int16, device="meta")
    s = torch.empty((32, 14336), dtype=torch.bfloat16, device="meta")
    part = tw.partition(8, 4096, 14336, H100_SMS)
    monkeypatch.setattr(tw.qa, "_stream", lambda t: 0)
    monkeypatch.setattr(tw, "_sms", lambda index: H100_SMS)

    def buffers(ws_cut, counters_cut):
        return lambda p, device, stream: (
            torch.empty(p.ws_floats - ws_cut, device="meta"),
            torch.zeros(p.n_counters - counters_cut, dtype=torch.int32, device="meta"))

    for cut in ((1, 0), (0, 1)):
        monkeypatch.setattr(tw, "_workspace", buffers(*cut))
        with pytest.raises(ValueError, match="workspace is short"):
            tw.w4_matmul(x, c, s)
    launched = []
    monkeypatch.setattr(tw, "_workspace", buffers(0, 0))
    monkeypatch.setattr(tw.qa, "_library",
                        lambda *a: lambda *args: launched.append(args) or 1)
    before = tw.w4_matmul.launches
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        tw.w4_matmul(x, c, s)
    assert tw.w4_matmul.launches == before
    assert launched[0][6:8] == (part.ws_floats, part.n_counters)
    assert launched[0][-2] == part.ctas


# -- (v) proj, fused projections --------------------------------------------

def test_proj_int16_matches_jax():
    """CPU ``proj`` on W4 against JAX's (the dequant route on both sides):
    the same f32 products and matmul, so within 1e-6 of the output's
    scale; prefill-sized and decode-sized h."""
    jp, tp = _j_w4_params(4)
    jlp = {k: v[1] for k, v in jp["layers"].items()}
    tlp = {k: v[1] for k, v in tp["layers"].items()}
    rs = np.random.RandomState(4)
    for name, din in (("wq", 256), ("wo", 512), ("w_down", 256)):
        for shape in ((2, 300, din), (8, 1, din)):
            h = rs.randn(*shape).astype(np.float32)
            want = np.asarray(jq.proj(jnp.asarray(h), jlp, name))
            got = tq.proj(torch.from_numpy(h), tlp, name).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def _logits(params, toks):
    cfg = _model(tc)
    eng = tc.EngineConfig(model=cfg, cache_mode=tc.CacheMode.DENSE, max_seq_len=256,
                          prefill_bucket=64)
    from mustafar_tpu_torch.cache import make_cache
    impl = make_cache(eng, device="cpu")
    with torch.inference_mode():
        logits, _ = tl.prefill(cfg, params, toks, impl.init(2, torch.float32), impl, 64)
    return logits.numpy()


@pytest.mark.parametrize("fmt", ["f32", "w8", "w4"])
def test_fused_projections_give_the_same_logits(fmt):
    """``fuse_projections`` is a layout change: the fused params' logits
    equal the unfused ones' within f32 summation order (1e-6 of their
    scale; a wider matmul may block its sums otherwise), and JAX's fused
    logits within 1e-5 (two frameworks' f32 matmuls)."""
    jp = jl.init_params(_model(jc), jax.random.PRNGKey(7), dtype=jnp.float32)
    jp = {"f32": lambda p: p, "w8": jq.quantize_params, "w4": jq.quantize_params_w4}[fmt](jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    fused = tq.fuse_projections(tp)
    assert "wqkv" in fused["layers"] and "wq" not in fused["layers"]
    assert "w_gateup" in fused["layers"] and "w_up" not in fused["layers"]
    assert fused["layers"]["wqkv"].dtype == tp["layers"]["wq"].dtype
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, 512, (2, 64)))
    lf, lg = _logits(tp, toks), _logits(fused, toks)
    np.testing.assert_allclose(lg, lf, rtol=0, atol=1e-6 * np.abs(lf).max())
    jfused = jq.fuse_projections(jp)
    jlog = np.asarray(jl.lm_forward(_model(jc), jfused, jnp.asarray(toks.numpy())))
    np.testing.assert_allclose(lg[:, -1], jlog[:, -1], rtol=0, atol=1e-5 * np.abs(jlog).max())


# -- (w) greedy W4 generation against JAX ------------------------------------

def _engine(mod, mode, codec="q8q4", **kw):
    return mod.EngineConfig(
        model=_model(mod), cache_mode=getattr(mod.CacheMode, mode),
        prune=mod.PruneConfig(method=mod.PruneMethod.KT_MAG_VT_MAG,
                              k_sparsity=0.7, v_sparsity=0.7),
        max_seq_len=kw.pop("max_seq_len", 1024), prefill_bucket=256, chunk_size=256,
        codec=codec, **kw)


def _check_forced(logits, jtoks, ttoks, tol):
    """Teacher-forced picks tie with JAX's tokens within ``tol``; the free
    streams part only after a near-tie."""
    gap = logits.max(-1) - np.take_along_axis(logits, jtoks[..., None], -1)[..., 0]
    assert (gap <= tol).all(), (
        f"port and JAX disagree beyond the tie tolerance at {np.argwhere(gap > tol).tolist()}")
    for row in range(jtoks.shape[0]):
        ties = np.flatnonzero(logits[row].argmax(-1) != jtoks[row])
        parted = np.flatnonzero(ttoks[row] != jtoks[row])
        assert (parted[0] if len(parted) else len(jtoks[row])) >= (
            ties[0] if len(ties) else len(jtoks[row])), f"row {row} parts with no near-tie"


@pytest.mark.parametrize("mode,codec,kernel,fuse", [
    pytest.param("DENSE", "q8q4", False, False, id="dense"),
    pytest.param("DENSE", "q8q4", True, False, id="dense-kernel"),
    pytest.param("COMPRESSED", "q8q4", True, False, id="q8q4"),
    pytest.param("COMPRESSED", "bitmap", True, True, id="bitmap-fused")])
def test_w4_generator_matches_jax(mode, codec, kernel, fuse):
    """Prompt 300, 24 new tokens, f32 activations over W4 weights.  With
    ``kernel`` the caches decode through their kernels on both sides (JAX
    in interpret mode; the port's plain versions)."""
    jeng, teng = _engine(jc, mode, codec), _engine(tc, mode, codec)
    jp, tp = _j_w4_params(5, fuse=fuse)
    prompt = np.random.RandomState(5).randint(0, 512, size=(2, 300))
    jgen = JGenerator(jeng, jp, dtype=jnp.float32)
    jgen.cache_impl.use_pallas = kernel
    jtoks = np.stack([np.asarray(r) for r in jgen.generate(prompt, 24)])
    tgen = TGenerator(teng, tp, dtype=torch.float32, device="cpu")
    tgen.cache_impl.use_pallas = kernel
    ttoks = np.stack(tgen.generate(prompt, 24))
    impl, cfg = tgen.cache_impl, tgen.cfg
    toks = torch.zeros((2, 512), dtype=torch.int64)
    toks[:, :300] = torch.from_numpy(prompt)
    cache = impl.init(2, torch.float32)
    with torch.inference_mode():
        lg, cache = tl.prefill(cfg, tp, toks, cache, impl, 300, last_only=True)
        out = [lg[:, 0]]
        for i in range(1, 24):
            lg, cache = tl.decode_step(cfg, tp, torch.from_numpy(jtoks[:, i - 1:i]).long(),
                                       cache, impl, 300 + i - 1)
            out.append(lg[:, 0])
    _check_forced(torch.stack(out, 1).numpy(), jtoks, ttoks, TIE_TOL[(mode, kernel)])


class _Forced(TEngine):
    """The port's engine fed JAX's token streams; records every pick's logits."""

    def __init__(self, *args, streams, **kw):
        super().__init__(*args, **kw)
        self.streams, self.logits = streams, {}

    def _choose(self, logits2d, reqs):
        picks = []
        for row, req in zip(logits2d, reqs):
            if req is None:
                picks.append(0)
                continue
            self.logits.setdefault(req.uid, []).append(row.float().numpy())
            picks.append(self.streams[req.uid][len(req.out)])
        return np.array(picks)


@pytest.mark.parametrize("codec", ["q8q4", "bitmap"])
def test_w4_engine_matches_jax(codec):
    """Continuous batching over W4 weights: chunked prefill with interleaved
    admission, three requests over two slots (one waits for a slot)."""
    jeng = _engine(jc, "COMPRESSED", codec, max_seq_len=2048, batch_size=2,
                   chunked_prefill=True)
    teng = _engine(tc, "COMPRESSED", codec, max_seq_len=2048, batch_size=2,
                   chunked_prefill=True)
    jp, tp = _j_w4_params(6)
    rs = np.random.RandomState(6)
    reqs = [(rs.randint(0, 512, size=n), m) for n, m in ((100, 10), (600, 6), (280, 12))]
    jcb = JEngine(jeng, jp, dtype=jnp.float32, use_native=False)
    jcb.impl.use_pallas = jcb.prefill_impl.use_pallas = True
    for p, m in reqs:
        jcb.submit(p, m)
    want = jcb.run()
    tcb = TEngine(teng, tp, dtype=torch.float32, device="cpu")
    for p, m in reqs:
        tcb.submit(p, m)
    got = tcb.run()
    forced = _Forced(teng, tp, dtype=torch.float32, device="cpu", streams=want)
    for p, m in reqs:
        forced.submit(p, m)
    forced.run()
    assert sorted(got) == sorted(want) and tcb.segments == 1 + 3 + 2
    for uid, jt in want.items():
        lg = np.stack(forced.logits[uid])[None]
        _check_forced(lg, np.asarray(jt)[None], np.asarray(got[uid])[None],
                      TIE_TOL[("COMPRESSED", True)])
