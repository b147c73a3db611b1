"""Port parity, the quant-codec kernel module.

(d) The plain versions of ``fused_q_decode_attention``,
    ``fused_q_decode_attention_ps`` (per-slot counts) and
    ``fused_q_segment_attention`` (chunked-prefill partials) against the
    JAX kernels run in Pallas interpret mode, on the same stacked int16
    pools, bf16 scales and windows, for the codecs q8, q8q4 and q4q4.
(s) The per-slot CUDA kernel's split arithmetic
    (``fused_q_decode_attention_ps_split_plain``: partials of single chunks
    and single window tiles from fresh softmax states, merged in split
    order) against the same JAX kernel and against the TPU-order plain
    version, for q8, q8q4 and q4q4, groups 1 and 4, f32 and bf16 q, with
    slots that have chunks but no window, a window but no chunks, and none.
(u) The uniform CUDA kernel's split arithmetic
    (``fused_q_decode_attention_split_plain``: each chunk and window tile
    one step from a fresh softmax state, merged in split order, the scores
    summed in the kernels' fixed order) against the same JAX kernel and the
    TPU-order plain version, for q8, q8q4 and q4q4, groups 1, 2, 4 and 8,
    f32 and bf16 q, at the (n_chunks, win_len) cases of ``chip_smoke.py``'s
    ``phase_kernel``; the fixed score order itself; the host's grid rule
    (``uniform_splits``).
(j) The module imports and runs on the CPU with no ``nvcc``; the wrappers
    refuse what the CUDA kernels cannot serve instead of falling back.
The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
them against the plain versions there.
"""

import functools
import inspect
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mustafar_tpu.ops import quant_format as jqf
from mustafar_tpu.ops import sparse_format as jsf
from mustafar_tpu.ops.kernels import quant_attention as jqa
from mustafar_tpu_torch.ops import quant_format as tqf
from mustafar_tpu_torch.ops.kernels import build
from mustafar_tpu_torch.ops.kernels import quant_attention as tqa

torch.set_num_threads(1)

BITS = {"q8": (8, 8), "q8q4": (8, 4), "q4q4": (4, 4)}
JCODECS = {c: jqf.QuantCodec(256, 128, *b) for c, b in BITS.items()}
TCODECS = {c: tqf.QuantCodec(256, 128, *b) for c, b in BITS.items()}
JCODEC, TCODEC = JCODECS["q8q4"], TCODECS["q8q4"]
W = 288                                   # residual 32 + chunk 256

# The JAX kernels, run in Pallas interpret mode as the JAX package's tests
# run them, under one jit each: their interpretation compiles once a shape
# and static argument set (the codec, max_chunks, the options) and then
# runs in milliseconds, where each eager call took ~2 s; the outputs are
# the eager call's bit for bit.
STATIC = ("codec", "max_chunks", "hpb", "wt", "fdepth", "nslots", "window",
          "return_norm", "return_win_probs")


def _jit(fn):
    """``fn`` under ``jax.jit``, the arguments of ``STATIC`` that it takes static."""
    params = inspect.signature(fn).parameters
    return jax.jit(fn, static_argnames=[name for name in STATIC if name in params])


J_DECODE = _jit(jqa.fused_q_decode_attention)
J_DECODE_PS = _jit(jqa.fused_q_decode_attention_ps)
J_SEGMENT = _jit(jqa.fused_q_segment_attention)


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16)).astype(np.float32)


def _inputs(seed, L, mc, B, Hkv, G, codec="q8q4"):
    """Stacked state of ``codec`` from real packed chunks (random bf16 K/V
    pruned to keep 40 of 128, then encoded), plus windows and q."""
    rs = np.random.RandomState(seed)
    BH = B * Hkv
    jcodec = JCODECS[codec]
    pool = np.zeros((L, mc, BH, jcodec.stream_rows, 128), np.int16)
    scales = np.zeros((L, mc, BH, 2, 128), np.float32)
    for li in range(L):
        for ci in range(mc):
            rows, scs = [], []
            for kind in ("k", "v"):
                x = jnp.asarray(rs.randn(BH, 256, 128) * 0.5, jnp.bfloat16)
                x = jnp.where(jsf.topk_mask(x, 40), x, 0).astype(jnp.bfloat16)
                r, s = jqf.encode_chunk(x, jcodec, kind)
                rows.append(np.asarray(r))
                scs.append(np.asarray(s).astype(np.float32))
            pool[li, ci] = np.concatenate(rows, axis=1)
            scales[li, ci] = np.stack(scs, axis=1)
    k_win = _bf16(rs.randn(L, BH, W, 128))
    v_win = _bf16(rs.randn(L, BH, W, 128))
    q = _bf16(rs.randn(B, 1, Hkv * G, 128))
    return q, pool, scales, k_win, v_win


def _run_both(q, pool, scales, k_win, v_win, nc, wl, li, codec="q8q4"):
    mc = pool.shape[1]
    jo = J_DECODE(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(pool),
        jnp.asarray(scales[..., 0, :], jnp.bfloat16),
        jnp.asarray(scales[..., 1, :], jnp.bfloat16),
        jnp.asarray(k_win, jnp.bfloat16), jnp.asarray(v_win, jnp.bfloat16),
        jnp.int32(nc), jnp.int32(wl), JCODECS[codec], mc, li=jnp.int32(li))
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    before = tqa.fused_q_decode_attention.launches
    to = tqa.fused_q_decode_attention(bf(q), torch.from_numpy(pool), bf(scales),
                                      bf(k_win), bf(v_win), nc, wl, li, TCODECS[codec])
    assert tqa.fused_q_decode_attention.launches == before   # CPU: no launch
    return np.asarray(jo).astype(np.float32), to.float().numpy()


def _cases(*cases):
    """pytest params; a q8q4 case keeps the id it had before the codec was a
    parameter, another codec's case adds the codec to it."""
    return [pytest.param(*c, id="-".join(str(x) for x in c if x != "q8q4")) for c in cases]


@pytest.mark.parametrize("G,codec", _cases((1, "q8q4"), (4, "q8q4"), (4, "q8"), (1, "q4q4")))
def test_plain_matches_jax_kernel(G, codec):
    """Cases: n_chunks 0, 1 and mc; window lengths 0 (with chunks), 1, 44,
    200 and the full 288; layer 0 and the last of L = 2."""
    q, pool, scales, k_win, v_win = _inputs(10 + G, 2, 3, 2, 2, G, codec)
    cases = [(0, 1, 0), (0, 44, 1), (1, 44, 0), (1, 0, 1), (3, 288, 1), (3, 200, 0),
             (1, 288, 0)]
    for nc, wl, li in cases:
        jo, to = _run_both(q, pool, scales, k_win, v_win, nc, wl, li, codec)
        # same arithmetic and the same softmax steps; the f32 sums run in
        # another order, which can move a bf16(p) or the bf16 output by one
        # ulp: 2^-8 of the output's magnitude
        np.testing.assert_allclose(to, jo, rtol=0, atol=2 ** -8 * np.abs(jo).max(),
                                   err_msg=f"nc={nc} wl={wl} li={li}")
    jo, to = _run_both(q, pool, scales, k_win, v_win, 0, 0, 0, codec)
    assert (to == 0).all() and (jo == 0).all()               # nothing to attend


def test_plain_output_dtype_follows_q():
    q, pool, scales, k_win, v_win = _inputs(3, 1, 2, 1, 2, 4)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    args = (torch.from_numpy(pool), bf(scales), bf(k_win), bf(v_win), 2, 100, 0, TCODEC)
    o32 = tqa.fused_q_decode_attention(torch.from_numpy(q), *args)
    o16 = tqa.fused_q_decode_attention(bf(q), *args)
    assert o32.dtype == torch.float32 and o16.dtype == torch.bfloat16
    np.testing.assert_array_equal(o16.float().numpy(), o32.to(torch.bfloat16).float().numpy())


def test_window_tile_is_the_tpu_rule():
    from mustafar_tpu.ops.kernels.sparse_attention import _window_tile
    for w in (160, 288, 544, 100, 8):
        assert tqa.window_tile(w) == _window_tile(w, 96)


def test_wrapper_refuses_what_the_kernel_cannot_serve():
    q, pool, scales, k_win, v_win = _inputs(4, 1, 2, 1, 2, 4)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    ok = dict(q=bf(q), kv_pool=torch.from_numpy(pool), kv_scales=bf(scales),
              k_win=bf(k_win), v_win=bf(v_win), n_chunks=1, win_len=10, li=0,
              codec=TCODEC)
    tqa.fused_q_decode_attention(**ok)
    bad = [
        dict(codec=tqf.QuantCodec(128, 128, 8, 4)),          # 128-token chunks
        dict(k_win=bf(k_win).float()),                       # f32 window
        dict(kv_pool=torch.from_numpy(pool).to(torch.int32)),
        dict(k_win=bf(k_win).transpose(2, 3).contiguous().transpose(2, 3)),
        dict(n_chunks=3), dict(win_len=W + 1), dict(li=1), dict(n_chunks=1.0),
        dict(q=bf(np.zeros((1, 1, 6, 128), np.float32))),    # G = 3
    ]
    for change in bad:
        with pytest.raises((ValueError, TypeError, NotImplementedError)):
            tqa.fused_q_decode_attention(**dict(ok, **change))
    # the sliding window is served: 100 keeps columns 166-265 of the 266, so
    # the chunk's first 166 drop out; 512 covers them all
    windowed = tqa.fused_q_decode_attention(**ok, window=100)
    assert torch.equal(windowed, tqa.fused_q_decode_attention_plain(
        *(ok[k] for k in ("q", "kv_pool", "kv_scales", "k_win", "v_win", "n_chunks",
                          "win_len", "li", "codec")), window=100))
    assert not torch.equal(windowed, tqa.fused_q_decode_attention(**ok))
    assert torch.equal(tqa.fused_q_decode_attention(**ok, window=512),
                       tqa.fused_q_decode_attention(**ok))
    for window in (0, 100.0):
        with pytest.raises(ValueError, match="window"):
            tqa.fused_q_decode_attention(**ok, window=window)
    # the window probabilities and the final (m, l) are served: the output is
    # the call's without them
    out, probs = tqa.fused_q_decode_attention(**ok, return_win_probs=True)
    assert torch.equal(out, tqa.fused_q_decode_attention(**ok))
    assert probs.shape == (1, 2, W) and (probs[..., 10:] == 0).all() and (probs[..., :10] > 0).all()
    out, m, l, both = tqa.fused_q_decode_attention(**ok, return_norm=True,
                                                   return_win_probs=True)
    assert torch.equal(out, tqa.fused_q_decode_attention(**ok)) and torch.equal(both, probs)
    assert m.shape == l.shape == (1, 2, 4, 1) and (l >= 1).all()
    # a device the kernel does not run on is refused, never computed on the CPU
    meta = {k: (v.to("meta") if torch.is_tensor(v) else v) for k, v in ok.items()}
    with pytest.raises(ValueError):
        tqa.fused_q_decode_attention(**meta)


def test_module_imports_and_builds_nothing_without_nvcc(tmp_path):
    """Importing the kernel module needs no nvcc and builds nothing; asking
    for the library where there is no nvcc raises (no fallback)."""
    code = (
        "import mustafar_tpu_torch.ops.kernels.quant_attention as qa\n"
        "import mustafar_tpu_torch.ops.kernels.w4_matmul\n"
        "import mustafar_tpu_torch.ops.kernels.dense_decode\n"
        "import mustafar_tpu_torch.ops.kernels.pack_kernel\n"
        "from mustafar_tpu_torch.ops.kernels import build\n"
        "assert build._LIBS == {}\n"
        "for name in ('q_decode', 'q_decode_ps', 'q_segment', 'w4_matmul', 'dense_decode',\n"
        "             'prune_quant_pack'):\n"
        "    try:\n"
        "        build.load(name)\n"
        "    except RuntimeError as e:\n"
        "        assert 'nvcc' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('built without nvcc')\n")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    build_dir_before = build.BUILD_DIR.exists()
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=os.getcwd(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    if not build_dir_before:
        assert not build.BUILD_DIR.exists() or not any(build.BUILD_DIR.iterdir())


# -- per-slot decode (kernel 2) ---------------------------------------------

PS_NC = [0, 1, 3, 1, 3, 0]
PS_WL = [1, 44, 288, 0, 1, 0]


@functools.lru_cache(maxsize=None)
def _ps_case(G, codec):
    """Per-slot inputs (6 slots of one kv head, mc=3, L=2) and the JAX
    kernel's output on them at layers 0 and 1 (f32 q), once a group and
    codec.  The kernel reads q as bf16 and casts only its f32 result to q's
    dtype, so a bf16 q's output is this one cast to bf16, bit for bit."""
    q, pool, scales, k_win, v_win = _inputs(20 + G, 2, 3, 6, 1, G, codec)
    jos = [np.asarray(J_DECODE_PS(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(scales[..., 0, :], jnp.bfloat16),
        jnp.asarray(scales[..., 1, :], jnp.bfloat16), jnp.asarray(k_win, jnp.bfloat16),
        jnp.asarray(v_win, jnp.bfloat16), jnp.asarray(PS_NC, jnp.int32),
        jnp.asarray(PS_WL, jnp.int32), JCODECS[codec], pool.shape[1], li=jnp.int32(li)))
        for li in (0, 1)]
    return (q, pool, scales, k_win, v_win), jos


def _run_both_ps(G, li, q_dtype, codec="q8q4"):
    (q, pool, scales, k_win, v_win), jos = _ps_case(G, codec)
    nc, wl = PS_NC, PS_WL
    jo = jos[li].astype(q_dtype)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    tq = torch.from_numpy(q) if q_dtype == jnp.float32 else bf(q)
    before = tqa.fused_q_decode_attention_ps.launches
    to = tqa.fused_q_decode_attention_ps(
        tq, torch.from_numpy(pool), bf(scales), bf(k_win), bf(v_win),
        torch.tensor(nc, dtype=torch.int32), torch.tensor(wl, dtype=torch.int32),
        li, TCODECS[codec])
    assert tqa.fused_q_decode_attention_ps.launches == before   # CPU: no launch
    assert to.dtype == tq.dtype
    return np.asarray(jo).astype(np.float32), to.float().numpy()


@pytest.mark.parametrize("G,q_dtype,codec", _cases(
    (1, "bfloat16", "q8q4"), (4, "bfloat16", "q8q4"), (4, "float32", "q8q4"),
    (4, "bfloat16", "q8"), (2, "bfloat16", "q4q4")))
def test_ps_plain_matches_jax_kernel(G, q_dtype, codec):
    """Mixed slots in one call: n_chunks 0/1/3 and win_len 0/1/44/288, and an
    idle slot (0, 0), which the port writes as 0; the TPU kernel's block
    loops every head to the largest counts, and parity is owed on slots with
    something to attend."""
    nc, wl = PS_NC, PS_WL
    for li in (0, 1):
        jo, to = _run_both_ps(G, li, getattr(jnp, q_dtype), codec)
        for b in range(6):
            if not (nc[b] or wl[b]):
                assert (to[b] == 0).all(), f"idle slot {b}, li={li}"
                continue
            # same arithmetic and softmax steps: one bf16 ulp of this slot's
            # own output scale, so a slot with small outputs is held as tightly
            assert np.abs(to[b]).max() > 0, f"live slot {b} written as 0, li={li}"
            np.testing.assert_allclose(to[b], jo[b], rtol=0,
                                       atol=2 ** -8 * np.abs(jo[b]).max(),
                                       err_msg=f"slot {b}, li={li}")


def test_ps_plain_equals_uniform_per_slot():
    """Slot b of the per-slot version is the uniform computation over its
    own counts; counts out of range are clamped as the kernel clamps them."""
    q, pool, scales, k_win, v_win = _inputs(5, 2, 3, 3, 2, 2)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    tq, tp, ts, tk, tv = bf(q), torch.from_numpy(pool), bf(scales), bf(k_win), bf(v_win)
    nc, wl = [2, 9, 1], [100, 288, -300]
    got = tqa.fused_q_decode_attention_ps(tq, tp, ts, tk, tv,
                                          torch.tensor(nc, dtype=torch.int32),
                                          torch.tensor(wl, dtype=torch.int32), 1, TCODEC)
    for b, (c, w) in enumerate(((2, 100), (3, 288), (1, 0))):
        hs = slice(2 * b, 2 * b + 2)
        want = tqa.fused_q_decode_attention(tq[b:b + 1], tp[:, :, hs].contiguous(),
                                            ts[:, :, hs].contiguous(),
                                            tk[:, hs].contiguous(), tv[:, hs].contiguous(),
                                            c, w, 1, TCODEC)
        np.testing.assert_array_equal(got[b:b + 1].float().numpy(), want.float().numpy())


SPLIT_NC = [0, 1, 3, 2, 3, 0]
SPLIT_WL = [1, 44, 288, 0, 1, 0]
ULP = 2.0 ** -8


@functools.lru_cache(maxsize=None)
def _split_case(codec, G, q_dtype):
    """Per-slot inputs (6 slots of one kv head, mc=3, layer 1) and the JAX
    kernel's output on them, once a codec, group and q dtype.  The kernel
    reads q as bf16 and casts only its f32 result to q's dtype, so with a
    bf16 q its output is the f32 q's (q on the bf16 grid) cast to bf16, bit
    for bit: one JAX program serves both dtypes."""
    if q_dtype == "bfloat16":
        tq, targs, jo = _split_case(codec, G, "float32")
        return (tq.to(torch.bfloat16), targs,
                np.asarray(jnp.asarray(jo).astype(jnp.bfloat16)).astype(np.float32))
    q, pool, scales, k_win, v_win = _inputs(80 + G, 2, 3, 6, 1, G, codec)
    jo = J_DECODE_PS(
        jnp.asarray(q, getattr(jnp, q_dtype)), jnp.asarray(pool),
        jnp.asarray(scales[..., 0, :], jnp.bfloat16),
        jnp.asarray(scales[..., 1, :], jnp.bfloat16),
        jnp.asarray(k_win, jnp.bfloat16), jnp.asarray(v_win, jnp.bfloat16),
        jnp.asarray(SPLIT_NC, jnp.int32), jnp.asarray(SPLIT_WL, jnp.int32),
        JCODECS[codec], 3, li=jnp.int32(1))
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    targs = (torch.from_numpy(pool), bf(scales), bf(k_win), bf(v_win),
             torch.tensor(SPLIT_NC, dtype=torch.int32),
             torch.tensor(SPLIT_WL, dtype=torch.int32), 1, TCODECS[codec])
    tq = torch.from_numpy(q).to(getattr(torch, q_dtype))
    return tq, targs, np.asarray(jo).astype(np.float32)


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("codec", ["q8", "q8q4", "q4q4"])
def test_ps_split_plain_matches_jax_kernel(codec, G, q_dtype):
    """The kernel's splits: one a chunk (3 splits at 3 chunks, 2 at 2, 1 at
    1), one a window tile (3 at 288 tokens, 1 at 44 and at 1); slots with
    chunks and no window, a window and no chunks, both, and none.  Held to
    the JAX kernel at the file's tolerance (f32 q; a bf16 output may also
    round one ulp the other way: twice that) and to the TPU-order plain
    version at 2 bf16 ulps, slot by slot; the idle slot comes out exactly
    0, a bf16 q gives the f32 q's output rounded."""
    tq, targs, jo = _split_case(codec, G, q_dtype)
    got = tqa.fused_q_decode_attention_ps_split_plain(tq, *targs)
    assert got.dtype == tq.dtype
    tpu = tqa.fused_q_decode_attention_ps_plain(tq, *targs).float().numpy()
    got32 = tqa.fused_q_decode_attention_ps_split_plain(tq.float(), *targs)
    np.testing.assert_array_equal(got.float().numpy(),
                                  got32.to(tq.dtype).float().numpy())
    got = got.float().numpy()
    jtol = ULP if q_dtype == "float32" else 2 * ULP
    for b in range(6):
        if not (SPLIT_NC[b] or SPLIT_WL[b]):
            assert (got[b] == 0).all(), f"idle slot {b}"
            continue
        assert np.abs(got[b]).max() > 0, f"live slot {b} written as 0"
        np.testing.assert_allclose(got[b], jo[b], rtol=0,
                                   atol=jtol * np.abs(jo[b]).max(),
                                   err_msg=f"slot {b} against JAX")
        np.testing.assert_allclose(got[b], tpu[b], rtol=0,
                                   atol=2 * ULP * np.abs(tpu[b]).max(),
                                   err_msg=f"slot {b} against the TPU order")


def test_ps_splits_of_the_grid():
    """A row of the per-slot grid, one split a pool chunk, then one a window
    tile (96 tokens at W=288, 40 at W=40 and at W=200, none at W=0): the
    same for both codec families."""
    from mustafar_tpu_torch.ops.kernels import sparse_attention as tska
    for (mc, W), n in (((32, 288), 35), ((5, 40), 6), ((3, 200), 8), ((0, 288), 3),
                       ((4, 0), 4), ((1, 1), 2)):
        assert tqa.ps_splits(mc, W) == tska.ps_splits(mc, W) == n, (mc, W)


def test_ps_wrapper_refuses_scratch_past_the_int_range():
    """The C entry takes its scratch size as an int: a grid whose partials
    would need more floats is refused before anything is allocated or
    launched (here on meta tensors, which allocate nothing); at the
    engine's shape the same call goes on to the device check."""
    B, Hkv, G, W = 64, 8, 8, 288

    def call(mc):
        meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
        return tqa.fused_q_decode_attention_ps(
            meta((B, 1, Hkv * G, 128), torch.bfloat16),
            meta((1, mc, B * Hkv, TCODEC.stream_rows, 128), torch.int16),
            meta((1, mc, B * Hkv, 2, 128), torch.bfloat16),
            meta((1, B * Hkv, W, 128), torch.bfloat16),
            meta((1, B * Hkv, W, 128), torch.bfloat16),
            meta((B,), torch.int32), meta((B,), torch.int32), 0, TCODEC)

    # 512 rows x 4,099 splits x 8 heads x 130 floats > 2^31 - 1
    with pytest.raises(ValueError, match="int sizes"):
        call(4096)
    with pytest.raises(ValueError, match="unsupported device"):
        call(32)


def test_ps_wrapper_refuses_what_the_kernel_cannot_serve():
    q, pool, scales, k_win, v_win = _inputs(6, 1, 2, 2, 2, 4)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32)
    ok = dict(q=bf(q), kv_pool=torch.from_numpy(pool), kv_scales=bf(scales),
              k_win=bf(k_win), v_win=bf(v_win), n_chunks=i32([1, 0]),
              win_len=i32([10, 3]), li=0, codec=TCODEC)
    tqa.fused_q_decode_attention_ps(**ok)
    bad = [
        dict(codec=tqf.QuantCodec(128, 128, 4, 4)),          # 128-token chunks
        dict(codec=tqf.QuantCodec(256, 128, 4, 8)),          # no codec has these widths
        dict(n_chunks=1), dict(win_len=i32([10])),           # host int, wrong shape
        dict(n_chunks=torch.tensor([1, 0])),                 # int64 counts
        dict(v_win=bf(v_win).float()), dict(li=1), dict(li=-1),
        dict(q=bf(np.zeros((2, 1, 6, 128), np.float32))),    # G = 3
    ]
    for change in bad:
        with pytest.raises((ValueError, TypeError, NotImplementedError)):
            tqa.fused_q_decode_attention_ps(**dict(ok, **change))
    # the sliding window is served: 512 covers both slots' positions (265 and
    # 2), 100 cuts slot 0's chunk at column 165 and leaves slot 1 (no chunk)
    assert torch.equal(tqa.fused_q_decode_attention_ps(**ok, window=512),
                       tqa.fused_q_decode_attention_ps(**ok))
    windowed = tqa.fused_q_decode_attention_ps(**ok, window=100)
    full = tqa.fused_q_decode_attention_ps(**ok)
    assert torch.isfinite(windowed).all() and not torch.equal(windowed[0], full[0])
    assert torch.equal(windowed[1], full[1])
    for bad_window in (0, 512.0):
        with pytest.raises(ValueError, match="window"):
            tqa.fused_q_decode_attention_ps(**ok, window=bad_window)
    # the window probabilities are served: the output is the call's without them
    out, probs = tqa.fused_q_decode_attention_ps(**ok, return_win_probs=True)
    assert torch.equal(out, tqa.fused_q_decode_attention_ps(**ok))
    assert probs.shape == (2, 2, W) and (probs[0, :, 10:] == 0).all()
    assert (probs[1, :, 3:] == 0).all() and (probs[:, :, :3] > 0).all()
    meta = {k: (v.to("meta") if torch.is_tensor(v) else v) for k, v in ok.items()}
    with pytest.raises(ValueError):
        tqa.fused_q_decode_attention_ps(**meta)


# -- segment partials (kernel 3) ----------------------------------------------

@pytest.mark.parametrize("nc,seg_start,codec", _cases(
    (0, 0, "q8q4"), (0, 256, "q8q4"), (1, 512, "q8q4"), (3, 768, "q8q4"), (3, 1024, "q8q4"),
    (3, 768, "q8"), (1, 512, "q4q4"), (3, 1024, "q4q4")))
def test_segment_plain_matches_jax_kernel(nc, seg_start, codec):
    """acc, m and l of one 256-row segment (B=2, Hkv=2, G=2) over nc chunks of
    layer 1; with no chunk, m is exactly -1e30 and l exactly 0."""
    _, pool, scales, _, _ = _inputs(30 + nc, 2, 3, 2, 2, 2, codec)
    qs = _bf16(np.random.RandomState(nc + seg_start).randn(2, 256, 4, 128))
    ja, jm, jl = (np.asarray(x) for x in J_SEGMENT(
        jnp.asarray(qs, jnp.bfloat16), jnp.asarray(pool),
        jnp.asarray(scales[..., 0, :], jnp.bfloat16),
        jnp.asarray(scales[..., 1, :], jnp.bfloat16), jnp.int32(nc),
        jnp.int32(seg_start), JCODECS[codec], 3, li=jnp.int32(1)))
    before = tqa.fused_q_segment_attention.launches
    ta, tm, tl = (x.numpy() for x in tqa.fused_q_segment_attention(
        torch.from_numpy(qs).to(torch.bfloat16), torch.from_numpy(pool),
        torch.from_numpy(scales).to(torch.bfloat16), nc, seg_start, 1, TCODECS[codec]))
    assert tqa.fused_q_segment_attention.launches == before
    assert ta.shape == ja.shape == (2, 256, 4, 128) and tm.shape == tl.shape == (2, 256, 4, 1)
    if nc == 0:
        assert (tm == -1e30).all() and (tl == 0).all() and (ta == 0).all()
        assert (jm == -1e30).all() and (jl == 0).all()
        return
    # f32 sums in another order: m and l to f32 rounding; acc to one bf16 ulp
    # of its scale (a bf16(p) may round the other way)
    np.testing.assert_allclose(tm, jm, rtol=1e-6, atol=0)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    np.testing.assert_allclose(ta, ja, rtol=0, atol=2 ** -8 * np.abs(ja).max())


def test_segment_wrapper_refuses_what_the_kernel_cannot_serve():
    _, pool, scales, _, _ = _inputs(7, 1, 2, 1, 2, 2)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    ok = dict(q_seg=bf(np.zeros((1, 256, 4, 128), np.float32)),
              kv_pool=torch.from_numpy(pool), kv_scales=bf(scales), n_chunks=1,
              seg_start=512, li=0, codec=TCODEC)
    tqa.fused_q_segment_attention(**ok)
    bad = [
        dict(codec=tqf.QuantCodec(128, 128, 8, 4)), dict(n_chunks=3),
        dict(n_chunks=torch.tensor(1)), dict(seg_start=128), dict(li=1),
        dict(kv_scales=bf(scales).float()),
        dict(q_seg=bf(np.zeros((1, 256, 3, 128), np.float32))),   # 3 heads over 2
        dict(q_seg=bf(np.zeros((1, 256, 4, 64), np.float32))),
    ]
    for change in bad:
        with pytest.raises((ValueError, TypeError, NotImplementedError)):
            tqa.fused_q_segment_attention(**dict(ok, **change))
    # the sliding window is served: 768 covers the pool's 256 columns from
    # every row (positions 512-767), 300 leaves none from row 43 on
    assert all(torch.equal(a, b) for a, b in zip(
        tqa.fused_q_segment_attention(**ok, window=768), tqa.fused_q_segment_attention(**ok)))
    m_win = tqa.fused_q_segment_attention(**ok, window=300)[1]
    assert (m_win[:, 43:] == -1e30).all() and (m_win[:, :43] > -1e30).all()
    with pytest.raises(ValueError, match="window"):
        tqa.fused_q_segment_attention(**ok, window=0)
    meta = {k: (v.to("meta") if torch.is_tensor(v) else v) for k, v in ok.items()}
    with pytest.raises(ValueError):
        tqa.fused_q_segment_attention(**meta)


# chip_smoke.phase_kernel's (n_chunks, win_len, li) cases, at mc = 3 here
UNIFORM_CASES = ((0, 1, 0), (0, 44, 1), (0, 288, 0), (3, 288, 1), (3, 1, 0), (1, 44, 0),
                 (1, 288, 1), (2, 88, 0))


@functools.lru_cache(maxsize=None)
def _uniform_case(codec, G):
    """Stacked inputs (B=2, one kv head, mc=3, L=2) and the JAX kernel's
    output (f32 q) at each of ``UNIFORM_CASES``, once a codec and group."""
    q, pool, scales, k_win, v_win = _inputs(90 + G, 2, 3, 2, 1, G, codec)
    jos = [np.asarray(J_DECODE(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(scales[..., 0, :], jnp.bfloat16),
        jnp.asarray(scales[..., 1, :], jnp.bfloat16), jnp.asarray(k_win, jnp.bfloat16),
        jnp.asarray(v_win, jnp.bfloat16), jnp.int32(nc), jnp.int32(wl), JCODECS[codec], 3,
        li=jnp.int32(li))).astype(np.float32) for nc, wl, li in UNIFORM_CASES]
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    return q, (torch.from_numpy(pool), bf(scales), bf(k_win), bf(v_win)), jos


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("codec", ["q8", "q8q4", "q4q4"])
def test_uniform_split_plain_matches_jax_kernel(codec, G, q_dtype):
    """The uniform kernel's splits (one a chunk, one a window tile of 96
    tokens) at every case of ``phase_kernel``: held to the JAX kernel (f32
    q) at the tolerance of ``test_ps_split_plain_matches_jax_kernel`` (a
    bf16 output may also round one ulp the other way: twice that) and to the
    TPU-order plain version at 2 bf16 ulps, row by row; a bf16 q gives the
    f32 q's output rounded."""
    q, targs, jos = _uniform_case(codec, G)
    tq = torch.from_numpy(q).to(getattr(torch, q_dtype))
    jtol = ULP if q_dtype == "float32" else 2 * ULP
    for (nc, wl, li), jo in zip(UNIFORM_CASES, jos):
        args = (*targs, nc, wl, li, TCODECS[codec])
        got = tqa.fused_q_decode_attention_split_plain(tq, *args)
        assert got.dtype == tq.dtype and got.shape == (2, 1, G, 128)
        got32 = tqa.fused_q_decode_attention_split_plain(tq.float(), *args)
        np.testing.assert_array_equal(got.float().numpy(),
                                      got32.to(tq.dtype).float().numpy())
        tpu = tqa.fused_q_decode_attention_plain(tq, *args).float().numpy()
        got = got.float().numpy()
        for b in range(2):
            where = f"row {b}, nc={nc} wl={wl} li={li}"
            np.testing.assert_allclose(got[b], jo[b], rtol=0,
                                       atol=jtol * np.abs(jo[b]).max(),
                                       err_msg=f"{where} against JAX")
            np.testing.assert_allclose(got[b], tpu[b], rtol=0,
                                       atol=2 * ULP * np.abs(tpu[b]).max(),
                                       err_msg=f"{where} against the TPU order")


def test_uniform_split_plain_is_the_per_slot_steps_at_uniform_counts():
    """The uniform kernel takes the per-slot kernel's steps: its split plain
    version is ``ps_split_steps`` at count tensors of the call's counts, bit
    for bit; with the scores as one f32 product (the per-slot kernel's split
    plain version, ``fused_q_decode_attention_ps_split_plain``) only the
    scores' rounding differs, within 2 bf16 ulps of the output."""
    q, targs, _ = _uniform_case("q8q4", 4)
    tq = torch.from_numpy(q)
    pool, scales, k_win, v_win = targs
    for nc, wl, li in UNIFORM_CASES:
        got = tqa.fused_q_decode_attention_split_plain(tq, *targs, nc, wl, li, TCODEC)
        ncs, wls = (torch.full((2,), x, dtype=torch.int32) for x in (nc, wl))
        steps = tqa.ps_split_steps(
            tq, 2, ncs, wls, 3, lambda hs: tqa._q_chunk_step(
                pool[:, :, hs], scales[:, :, hs], li, TCODEC, True),
            k_win, v_win, li, ordered=True)
        np.testing.assert_array_equal(got.numpy(), steps.numpy())
        per_slot = tqa.fused_q_decode_attention_ps_split_plain(tq, *targs[:4], ncs, wls,
                                                               li, TCODEC).numpy()
        np.testing.assert_allclose(got.numpy(), per_slot, rtol=0,
                                   atol=2 * ULP * np.abs(per_slot).max(),
                                   err_msg=f"nc={nc} wl={wl} li={li}")


@pytest.mark.parametrize("codes", [False, True])
def test_ordered_scores_are_the_documented_sum(codes):
    """``_scores(..., ordered=True)`` is each quarter of the channels summed
    in channel order with one f32 rounding a product, then (s0 + s1) + (s2 +
    s3), times 1/sqrt(128): here against that sum written out in numpy f32,
    for bf16 keys and for integer codes; it differs from the f32 product by
    f32 rounding only."""
    rs = np.random.RandomState(7)
    q = _bf16(rs.randn(3, 4, 128))
    k = (rs.randint(-128, 128, size=(3, 40, 128)).astype(np.float32) if codes
         else _bf16(rs.randn(3, 40, 128)))
    got = tqa._scores(torch.from_numpy(q), torch.from_numpy(k), ordered=True).numpy()
    quarters = np.zeros((3, 4, 40, 4), np.float32)
    for c in range(32):
        quarters += (q[:, :, None, c::32] * k[:, None, :, c::32]).astype(np.float32)
    want = (((quarters[..., 0] + quarters[..., 1]) + (quarters[..., 2] + quarters[..., 3]))
            * np.float32(tqa.SM_SCALE))
    np.testing.assert_array_equal(got, want)
    flat = tqa._scores(torch.from_numpy(q), torch.from_numpy(k)).numpy()
    np.testing.assert_allclose(got, flat, rtol=1e-5, atol=1e-5 * np.abs(flat).max())


def test_uniform_splits_of_the_grid():
    """The uniform kernels' grid, sized from the call's counts: one split a
    chunk (cut in ``cut`` runs for the bitmap kernel), one a window tile
    (96 tokens at W=288, 40 at W=40 and W=200); no split is empty, and
    n_chunks = 0 takes no chunk split."""
    from mustafar_tpu_torch.ops.kernels import sparse_attention as tska
    cases = {(1, 288, 288, 1): (1, 3), (0, 1, 288, 1): (0, 1), (5, 288, 288, 1): (5, 3),
             (5, 1, 288, 1): (5, 1), (0, 44, 288, 1): (0, 1), (2, 88, 288, 1): (2, 1),
             (1, 97, 288, 1): (1, 2), (3, 200, 200, 1): (3, 5), (2, 41, 40, 1): (2, 2),
             (1, 288, 288, 4): (4, 3), (0, 1, 288, 4): (0, 1), (5, 288, 288, 4): (20, 3),
             (0, 0, 288, 1): (0, 0), (4, 0, 0, 4): (16, 0)}
    for (nc, wl, W, cut), want in cases.items():
        assert tqa.uniform_splits(nc, wl, W, cut) == want, (nc, wl, W, cut)
        chunks, tiles = want
        wt = tqa.window_tile(W) if W else 1
        assert chunks == nc * cut and (tiles == 0 or 1 <= wl - (tiles - 1) * wt <= wt)
    assert tska.CHUNK_CUT == 4 and 256 % tska.CHUNK_CUT == 0


def test_uniform_wrapper_sizes_its_grid_before_the_device():
    """On a device other than the CPU the wrapper sizes the grid from the
    pool's and the window's capacity (``uniform_grid``), never from the
    counts, which the kernel reads on the device, before anything is
    allocated or launched (meta tensors here, which allocate nothing): a
    grid whose partials would pass the int range is refused whatever the
    counts; else every call goes on to the device check, nothing to attend
    included (decided by the kernel now), and so do counts given as device
    tensors."""
    B, Hkv, G, W = 8, 8, 4, 288

    def call(nc, wl, mc=5, Bq=B):
        meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
        return tqa.fused_q_decode_attention(
            meta((Bq, 1, Hkv * G, 128), torch.bfloat16),
            meta((1, mc, Bq * Hkv, TCODEC.stream_rows, 128), torch.int16),
            meta((1, mc, Bq * Hkv, 2, 128), torch.bfloat16),
            meta((1, Bq * Hkv, W, 128), torch.bfloat16),
            meta((1, Bq * Hkv, W, 128), torch.bfloat16), nc, wl, 0, TCODEC)

    before = tqa.fused_q_decode_attention.launches
    # 4,096 rows x 5,003 splits x 4 heads x 130 floats > 2^31 - 1
    with pytest.raises(ValueError, match="int sizes"):
        call(0, 0, mc=5000, Bq=512)
    count = lambda x: torch.full((1,), x, dtype=torch.int32, device="meta")
    for nc, wl in ((0, 0), (1, 288), (count(1), count(288))):
        with pytest.raises(ValueError, match="unsupported device"):
            call(nc, wl)
    assert tqa.fused_q_decode_attention.launches == before
    assert tqa.uniform_grid(5, 288) == 8 and tqa.uniform_grid(5, 288, 4) == 23
    for bad in (torch.zeros(2, dtype=torch.int32, device="meta"), count(1).long()):
        with pytest.raises(ValueError, match="n_chunks"):
            call(bad, 288)


def test_jitted_jax_kernels_are_the_eager_calls():
    """The JAX kernels under ``jax.jit`` (``_jit``, as every test here calls
    them) give the eager calls' outputs bit for bit: kernel 1 with chunks
    and a full window, kernel 2 at two slots' counts."""
    q, pool, scales, k_win, v_win = _inputs(94, 2, 3, 2, 1, 4)
    args = (jnp.asarray(q), jnp.asarray(pool), jnp.asarray(scales[..., 0, :], jnp.bfloat16),
            jnp.asarray(scales[..., 1, :], jnp.bfloat16), jnp.asarray(k_win, jnp.bfloat16),
            jnp.asarray(v_win, jnp.bfloat16))
    for eager, jitted, nc, wl in (
            (jqa.fused_q_decode_attention, J_DECODE, jnp.int32(3), jnp.int32(288)),
            (jqa.fused_q_decode_attention_ps, J_DECODE_PS, jnp.asarray([1, 3], jnp.int32),
             jnp.asarray([44, 288], jnp.int32))):
        want = np.asarray(eager(*args, nc, wl, JCODEC, 3, li=jnp.int32(1)))
        got = np.asarray(jitted(*args, nc, wl, JCODEC, 3, li=jnp.int32(1)))
        np.testing.assert_array_equal(got, want)
