"""Port parity, the archived decode generations v1-v3
(``ops/kernels/sparse_attention_archive.py``).

(a) The plain versions of the v1 pair, ``sparse_key_scores`` (TPU kernel
    10) and ``sparse_value_combine`` (kernel 11), against the JAX kernels
    run in Pallas interpret mode on the same split pools (random K and V
    pruned and encoded by the jitted JAX codec ``prune_and_encode_chunk``)
    at sparsity 0.7 and 0.5 (zero pads), G = 1, 4 and 8 live query rows of
    the 8, and n_chunks < mc: the columns of later chunks are exactly 0.
(b) ``sparse_decode_attention`` (v1), ``fused_sparse_decode_attention``
    (v2, kernel 12) and ``fused_sparse_decode_attention_v3`` (v3, kernel 13,
    chunk-major pools) against JAX: bf16 and f32 q, n_chunks 0 and > 0,
    win_len 0 with chunks, and nothing to attend (0, 0), where the
    generations disagree and the port follows each: v1 is NaN (its softmax
    runs over -inf alone), v2 and v3 give the mean of the W-row window
    (every column at -1e30 has p = exp(0) = 1).
(c) The wrappers refuse what the CUDA kernels cannot serve (bad formats,
    shapes, dtypes, devices, counts, count tensors, windows and pools past
    the split grid's limits) instead of falling back, and on the CPU
    nothing launches; importing the module builds nothing.
(d) The split plain versions of v2 and v3 (kernels 12 and 13's own
    arithmetic: a chunk in four softmax steps of 64 tokens, the window in
    tiles, merged in step order) against the JAX kernels and against the
    TPU-order plain versions, at n_chunks 0, 1 and mc, win_len 0, 1, 44 and
    288, sparsity 0.7 and 0.5, G 1, 4 and 8; exactly: the window mean with
    nothing to attend, v3's on the chunk-major copy equal to v2's, a bf16 q
    giving the f32 q's output rounded.  The JAX runs are made once a case
    and shared with (b).
The CUDA kernels run only on the card: ``chip_smoke.py`` (phase
``kernel_archive``) holds them against the plain versions there.

Tolerances, each with its reason:
  scores   2e-6 of their largest magnitude: f32 sums of 128 exact bf16
           products, in another order than XLA's;
  combine  1e-6 of its largest magnitude: f32 sums over 256 tokens a chunk,
           in another order;
  decode   one bf16 ulp (2^-8) of the output's largest magnitude: the same
           f32 arithmetic in another order can move the bf16 output (or a
           bf16 p) by one ulp.
  split    against JAX one bf16 ulp of the output's largest magnitude for
           an f32 q, two for a bf16 q (the output's own rounding); against
           the TPU-order plain version 2 bf16 ulps of each head's scale: a
           step of 64 tokens or a window tile rounds each p to bf16 at its
           own max, where the TPU's step rounds it at the chunk's or the
           whole window's.
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

from mustafar_tpu.ops import sparse_format as jsf
from mustafar_tpu.ops.kernels import sparse_attention_archive as jar
from mustafar_tpu_torch.ops import sparse_format as tsf
from mustafar_tpu_torch.ops.kernels import sparse_attention_archive as tar

torch.set_num_threads(1)

# The JAX kernels, run in Pallas interpret mode as the JAX package's tests
# run them, under ``jax.jit`` (as ``tests/test_torch_kernel.py`` calls
# them): their interpretation compiles once a shape and static argument set
# (the codec or formats, max_chunks, the window, the options) and then runs
# in milliseconds, where each eager call took seconds.
JIT_STATIC = ("codec", "fmt", "kfmt", "vfmt", "max_chunks", "hpb", "ts", "window",
              "return_norm", "return_win_probs")


@functools.cache
def _jit(fn):
    """``fn`` under ``jax.jit``, the arguments of ``JIT_STATIC`` that it takes
    static."""
    params = inspect.signature(fn).parameters
    return jax.jit(fn, static_argnames=[name for name in JIT_STATIC if name in params])

W = 288                                   # residual 32 + chunk 256
ULP = 2.0 ** -8
SCORES_RTOL = 2e-6
COMBINE_RTOL = 1e-6


def _fmts(sparsity):
    keep = 128 - int(sparsity * 128) + 1
    return jsf.ChunkFormat(256, 128, keep), tsf.ChunkFormat(256, 128, keep)


def _bf(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16)).astype(np.float32)


def _pools(seed, BH, mc, sparsity, dtype="bfloat16"):
    """K and V split pools, head-major, packed by the jitted JAX codec from
    random chunks: (JAX (segs, bmp) per stream, torch likewise)."""
    jf, _ = _fmts(sparsity)
    x = np.random.RandomState(seed).randn(2, BH, mc, 256, 128).astype(np.float32)
    segs, bmp = jax.jit(lambda a: jsf.prune_and_encode_chunk(a, jf))(
        jnp.asarray(x, getattr(jnp, dtype)))
    out_j, out_t = [], []
    for st in range(2):
        js = [np.asarray(s[st]).reshape(BH, mc * jf.seg_rows(k), 128)
              for s, k in zip(segs, jf.segs)]
        jb = np.asarray(bmp[st]).reshape(BH, mc * jf.planes, 128)
        out_j.append(([jnp.asarray(s) for s in js], jnp.asarray(jb)))
        out_t.append(([torch.from_numpy(s.astype(np.float32)).to(getattr(torch, dtype))
                       for s in js], torch.from_numpy(jb.view(np.int32).copy())))
    return out_j, out_t


def _chunk_major(segs, bmp, fmt, mc):
    """Head-major pools -> chunk-major [mc, BH, ...] (JAX or torch arrays)."""
    BH = bmp.shape[0]
    swap = ((lambda a: jnp.swapaxes(a, 0, 1)) if isinstance(bmp, jax.Array)
            else (lambda a: a.transpose(0, 1).contiguous()))
    return ([swap(s.reshape(BH, mc, fmt.seg_rows(k), 128)) for s, k in zip(segs, fmt.segs)],
            swap(bmp.reshape(BH, mc, fmt.planes, 128)))


def _rows(rs, BH, G, cols):
    """[BH, 8, cols] on the bf16 grid, rows past G zero (the padded rows)."""
    x = np.zeros((BH, 8, cols), np.float32)
    x[:, :G] = _bf(rs.randn(BH, G, cols))
    return x


@pytest.mark.parametrize("G,sparsity", [(1, 0.7), (4, 0.5), (8, 0.7)])
def test_key_scores_plain_matches_jax_kernel(G, sparsity):
    jf, tf = _fmts(sparsity)
    BH, mc, nc = 2, 3, 2
    (jk, _), (tk, _) = _pools(G, BH, mc, sparsity)
    q = _rows(np.random.RandomState(100 + G), BH, G, 128)
    js = np.asarray(_jit(jar.sparse_key_scores)(jnp.asarray(q, jnp.bfloat16), *jk, jnp.int32(nc),
                                          jf, mc))
    ts = tar.sparse_key_scores(torch.from_numpy(q).to(torch.bfloat16), *tk, nc, tf, mc)
    assert ts.dtype == torch.float32 and ts.shape == (BH, 8, mc * 256)
    ts = ts.numpy()
    assert (ts[:, :, nc * 256:] == 0).all() and (js[:, :, nc * 256:] == 0).all()
    assert (ts[:, G:] == 0).all()                # the zero padded rows
    np.testing.assert_allclose(ts, js, rtol=0, atol=SCORES_RTOL * np.abs(js).max())
    assert tar.sparse_key_scores.launches == 0


@pytest.mark.parametrize("G,sparsity", [(1, 0.5), (4, 0.7), (8, 0.7)])
def test_value_combine_plain_matches_jax_kernel(G, sparsity):
    jf, tf = _fmts(sparsity)
    BH, mc, nc = 2, 3, 2
    (_, jv), (_, tv) = _pools(10 + G, BH, mc, sparsity)
    w = np.abs(_rows(np.random.RandomState(200 + G), BH, G, mc * 256)) * 0.01
    w[:, :, nc * 256:] = 0                   # zeros past n_chunks, as v1 feeds it
    jo = np.asarray(_jit(jar.sparse_value_combine)(jnp.asarray(w, jnp.bfloat16), *jv,
                                             jnp.int32(nc), jf, mc))
    to = tar.sparse_value_combine(torch.from_numpy(w).to(torch.bfloat16), *tv, nc, tf, mc)
    assert to.dtype == torch.float32 and to.shape == (BH, 8, 128)
    np.testing.assert_allclose(to.numpy(), jo, rtol=0, atol=COMBINE_RTOL * np.abs(jo).max())
    # no chunk: exactly 0
    assert (tar.sparse_value_combine(torch.from_numpy(w).to(torch.bfloat16), *tv, 0, tf,
                                     mc) == 0).all()
    assert tar.sparse_value_combine.launches == 0


@functools.lru_cache(maxsize=None)
def _decode_inputs(seed, B, Hkv, G, mc, sparsity, seg_dtype="bfloat16"):
    """Inputs of a decode case, made once a case (the tests only read them)."""
    rs = np.random.RandomState(seed)
    jpools, tpools = _pools(seed, B * Hkv, mc, sparsity, seg_dtype)
    q = _bf(rs.randn(B, 1, Hkv * G, 128))
    k_win = _bf(rs.randn(B, W, Hkv, 128))
    v_win = _bf(rs.randn(B, W, Hkv, 128))
    return jpools, tpools, q, k_win, v_win


@functools.lru_cache(maxsize=None)
def _jax_decode(gen, case, nc, wl, q_dtype):
    """JAX's generation ``gen`` (1, 2 or 3) on ``_decode_inputs(*case)``, in
    interpret mode; run once a case and shared by every test of the file.
    v2 and v3 read q as bf16 and cast only their f32 result to q's dtype, so
    with a bf16 q their output is the f32 q's (q on the bf16 grid) cast to
    bf16, bit for bit: one JAX program serves both dtypes.  v1's window
    scores take q in its own dtype: it runs in each."""
    if gen != 1 and q_dtype == "bfloat16":
        out = _jax_decode(gen, case, nc, wl, "float32")
        return np.asarray(jnp.asarray(out).astype(jnp.bfloat16)).astype(np.float32)
    (jk, jv), _, q, k_win, v_win = _decode_inputs(*case)
    mc, (jf, _) = case[4], _fmts(case[5])
    if gen == 3:
        jk, jv = _chunk_major(*jk, jf, mc), _chunk_major(*jv, jf, mc)
    jfn = {1: jar.sparse_decode_attention, 2: jar.fused_sparse_decode_attention,
           3: jar.fused_sparse_decode_attention_v3}[gen]
    return np.asarray(_jit(jfn)(jnp.asarray(q, getattr(jnp, q_dtype)), *jk, *jv,
                                jnp.asarray(k_win, jnp.bfloat16),
                                jnp.asarray(v_win, jnp.bfloat16), jnp.int32(nc),
                                jnp.int32(wl), jf, jf, mc)).astype(np.float32)


def _port_args(gen, case, q_dtype):
    """The port's arguments of generation ``gen`` on ``_decode_inputs(*case)``
    up to the counts: (q, pools..., k_win, v_win), and the format."""
    _, (tk, tv), q, k_win, v_win = _decode_inputs(*case)
    mc, (_, tf) = case[4], _fmts(case[5])
    if gen == 3:
        tk, tv = _chunk_major(*tk, tf, mc), _chunk_major(*tv, tf, mc)
    return ((torch.from_numpy(q).to(getattr(torch, q_dtype)), *tk, *tv,
             torch.from_numpy(k_win).to(torch.bfloat16),
             torch.from_numpy(v_win).to(torch.bfloat16)), tf)


def _run_both(gen, case, nc, wl, q_dtype):
    """One generation (1, 2 or 3) on the same inputs in JAX and in the port."""
    tfn = {1: tar.sparse_decode_attention, 2: tar.fused_sparse_decode_attention,
           3: tar.fused_sparse_decode_attention_v3}[gen]
    args, tf = _port_args(gen, case, q_dtype)
    to = tfn(*args, nc, wl, tf, tf, case[4])
    assert to.dtype == getattr(torch, q_dtype) and to.shape == args[0].shape
    return _jax_decode(gen, case, nc, wl, q_dtype), to.float().numpy()


@pytest.mark.parametrize("q_dtype,G,nc,wl,sparsity", [
    ("bfloat16", 4, 2, 90, 0.7), ("float32", 4, 2, 90, 0.7),
    ("float32", 2, 0, 17, 0.5), ("bfloat16", 8, 3, 0, 0.7)])
def test_v1_plain_matches_jax(q_dtype, G, nc, wl, sparsity):
    """v1 with bf16 and f32 q: the window's scores take q in its own dtype,
    the chunks' bf16 q, so an f32 q moves the output, as in JAX."""
    case = (300 + nc + G, 2, 2, G, 3, sparsity)
    jo, to = _run_both(1, case, nc, wl, q_dtype)
    np.testing.assert_allclose(to, jo, rtol=0, atol=ULP * np.abs(jo).max())
    if q_dtype == "float32" and wl:
        jb, _ = _run_both(1, case, nc, wl, "bfloat16")
        assert np.abs(jo - jb).max() > 0        # the window saw f32 q
    assert (tar.sparse_key_scores.launches, tar.sparse_value_combine.launches) == (0, 0)


@pytest.mark.parametrize("gen", [2, 3])
@pytest.mark.parametrize("nc,wl,sparsity,q_dtype", [
    (2, 90, 0.7, "bfloat16"), (0, 17, 0.7, "float32"), (3, 0, 0.5, "bfloat16"),
    (1, 288, 0.5, "float32")])
def test_fused_plain_matches_jax(gen, nc, wl, sparsity, q_dtype):
    """v2 (head-major) and v3 (chunk-major): chunks then the whole window
    in one softmax step; q read as bf16."""
    jo, to = _run_both(gen, (400 + nc + wl, 2, 2, 4, 3, sparsity), nc, wl, q_dtype)
    np.testing.assert_allclose(to, jo, rtol=0, atol=ULP * np.abs(jo).max())
    fn = (tar.fused_sparse_decode_attention if gen == 2
          else tar.fused_sparse_decode_attention_v3)
    assert fn.launches == 0


@pytest.mark.parametrize("gen", [1, 2, 3])
def test_nothing_to_attend_per_generation(gen):
    """n_chunks = win_len = 0, which no serving path reaches: v1 gives NaN,
    v2 and v3 the mean of the whole window buffer, in JAX and in the port."""
    case = (7, 1, 2, 2, 2, 0.7)
    v_win = _decode_inputs(*case)[4]
    jo, to = _run_both(gen, case, 0, 0, "bfloat16")
    if gen == 1:
        assert np.isnan(jo).all() and np.isnan(to).all()
        return
    mean = v_win.mean(axis=1).reshape(1, 1, 2, 1, 128)
    mean = np.broadcast_to(mean, (1, 1, 2, 2, 128)).reshape(1, 1, 4, 128)
    np.testing.assert_allclose(jo, mean, rtol=0, atol=ULP * np.abs(mean).max())
    np.testing.assert_allclose(to, jo, rtol=0, atol=ULP * np.abs(jo).max())


def test_f32_segments_round_as_the_expansion_rounds():
    """Segments packed from f32 chunks stay f32; the expansion rounds them
    to bf16, in JAX and in the port (v1 and v2)."""
    case = (8, 1, 2, 4, 2, 0.7, "float32")
    assert _decode_inputs(*case)[1][0][0][0].dtype == torch.float32
    for gen in (1, 2):
        jo, to = _run_both(gen, case, 2, 40, "bfloat16")
        np.testing.assert_allclose(to, jo, rtol=0, atol=ULP * np.abs(jo).max())


def test_v3_plain_is_v2_on_the_chunk_major_copy():
    _, tf = _fmts(0.5)
    _, ((ks, kb), (vs, vb)), q, k_win, v_win = _decode_inputs(9, 2, 2, 8, 3, 0.5)
    args = (torch.from_numpy(k_win).to(torch.bfloat16),
            torch.from_numpy(v_win).to(torch.bfloat16))
    tq = torch.from_numpy(q).to(torch.bfloat16)
    for nc, wl in ((3, 288), (1, 5), (0, 0)):
        v2 = tar.fused_sparse_decode_attention(tq, ks, kb, vs, vb, *args, nc, wl, tf, tf, 3)
        v3 = tar.fused_sparse_decode_attention_v3(
            tq, *_chunk_major(ks, kb, tf, 3), *_chunk_major(vs, vb, tf, 3), *args, nc, wl,
            tf, tf, 3)
        np.testing.assert_array_equal(v3.float().numpy(), v2.float().numpy())


# (G, n_chunks, win_len, sparsity, q dtype) of the split plain versions'
# cases over mc = 3 chunks; the G = 4 ones are test_fused_plain_matches_jax's
# (its seeds, its JAX runs)
SPLIT_CASES = [(4, 2, 90, 0.7, "bfloat16"), (4, 0, 17, 0.7, "float32"),
               (4, 3, 0, 0.5, "bfloat16"), (4, 1, 288, 0.5, "float32"),
               (1, 0, 1, 0.7, "float32"), (1, 3, 44, 0.7, "float32"),
               (1, 1, 1, 0.7, "float32"), (8, 1, 44, 0.5, "bfloat16"),
               (8, 3, 288, 0.5, "bfloat16"), (8, 0, 0, 0.5, "bfloat16")]
SPLIT_PLAINS = {2: tar.fused_sparse_decode_attention_split_plain,
                3: tar.fused_sparse_decode_attention_v3_split_plain}
TPU_PLAINS = {2: tar.fused_sparse_decode_attention_plain,
              3: tar.fused_sparse_decode_attention_v3_plain}


def _split_case(G, nc, wl, sparsity):
    seed = 400 + nc + wl if G == 4 else 500 + 10 * G + nc + wl
    return (seed, 2, 2, G, 3, sparsity)


@pytest.mark.parametrize("gen", [2, 3])
@pytest.mark.parametrize("G,nc,wl,sparsity,q_dtype", SPLIT_CASES)
def test_split_plain_matches_jax_and_the_tpu_order(gen, G, nc, wl, sparsity, q_dtype):
    """Kernels 12 and 13's arithmetic (steps of 64 chunk tokens and window
    tiles, merged in step order) against the JAX kernel and against the
    TPU-order plain version on the same inputs."""
    case = _split_case(G, nc, wl, sparsity)
    args, tf = _port_args(gen, case, q_dtype)
    got = SPLIT_PLAINS[gen](*args, nc, wl, tf, tf, 3)
    assert got.dtype == args[0].dtype and got.shape == args[0].shape
    got = got.float().numpy()
    jo = _jax_decode(gen, case, nc, wl, q_dtype)
    ulps = 1 if q_dtype == "float32" else 2
    np.testing.assert_allclose(got, jo, rtol=0, atol=ulps * ULP * np.abs(jo).max())
    tpu = TPU_PLAINS[gen](*args, nc, wl, tf, tf, 3).float().numpy()
    head = np.abs(tpu).max(axis=-1, keepdims=True)
    assert (np.abs(got - tpu) <= 2 * ULP * head).all()
    # the wrapper's count tensors (0-d int32 on q's device) read as the ints
    fn = (tar.fused_sparse_decode_attention if gen == 2
          else tar.fused_sparse_decode_attention_v3)
    np.testing.assert_array_equal(
        fn(*args, torch.tensor(nc, dtype=torch.int32), torch.tensor(wl, dtype=torch.int32),
           tf, tf, 3).float().numpy(), tpu)
    assert fn.launches == 0


def test_split_plain_exact_properties():
    """Exactly: with nothing to attend each head's window mean (the rows
    summed in order in f32, then divided by W); v3's split plain on the
    chunk-major copy is v2's bit for bit; a bf16 q gives the f32 q's output
    rounded to bf16."""
    case = (9, 2, 2, 8, 3, 0.5)
    (q, *pools, k_win, v_win), tf = _port_args(2, case, "bfloat16")
    (_, *cpools, _, _), _ = _port_args(3, case, "bfloat16")
    vw = v_win.float().numpy()                              # [B, W, Hkv, 128]
    acc = np.zeros((2, 2, 128), np.float32)
    for t in range(vw.shape[1]):
        acc = acc + vw[:, t]
    mean = np.repeat((acc / np.float32(vw.shape[1]))[:, None, :, None], 8, axis=3)
    for gen, ps in ((2, pools), (3, cpools)):
        got = SPLIT_PLAINS[gen](q.float(), *ps, k_win, v_win, 0, 0, tf, tf, 3)
        np.testing.assert_array_equal(got.numpy(), mean.reshape(2, 1, 16, 128))
    for nc, wl in ((3, 288), (1, 5), (0, 44), (2, 0), (0, 0)):
        v2 = SPLIT_PLAINS[2](q.float(), *pools, k_win, v_win, nc, wl, tf, tf, 3)
        v3 = SPLIT_PLAINS[3](q.float(), *cpools, k_win, v_win, nc, wl, tf, tf, 3)
        np.testing.assert_array_equal(v3.numpy(), v2.numpy())
        bf = SPLIT_PLAINS[2](q, *pools, k_win, v_win, nc, wl, tf, tf, 3)
        assert bf.dtype == torch.bfloat16
        np.testing.assert_array_equal(bf.float().numpy(),
                                      v2.to(torch.bfloat16).float().numpy())


def test_wrappers_refuse_what_the_kernels_cannot_serve():
    _, tf = _fmts(0.7)
    _, tf5 = _fmts(0.5)
    _, ((ks, kb), (vs, vb)), q, k_win, v_win = _decode_inputs(11, 1, 2, 4, 2, 0.7)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    qs = bf(_rows(np.random.RandomState(1), 2, 4, 128))
    w = bf(_rows(np.random.RandomState(2), 2, 4, 512))
    scores = dict(q=qs, k_segs=ks, k_bmp=kb, n_chunks=1, fmt=tf, max_chunks=2)
    combine = dict(w=w, v_segs=vs, v_bmp=vb, n_chunks=1, fmt=tf, max_chunks=2)
    dec = dict(q=bf(q), k_segs=ks, k_bmp=kb, v_segs=vs, v_bmp=vb, k_win=bf(k_win),
               v_win=bf(v_win), n_chunks=1, win_len=10, kfmt=tf, vfmt=tf, max_chunks=2)
    ck, cb = _chunk_major(ks, kb, tf, 2)
    cvs, cvb = _chunk_major(vs, vb, tf, 2)
    dec3 = dict(dec, k_segs=ck, k_bmp=cb, v_segs=cvs, v_bmp=cvb)
    common = [dict(n_chunks=3), dict(n_chunks=-1), dict(n_chunks=1.0), dict(max_chunks=3)]
    # v2 and v3 take 0-d int32 count tensors on q's device, and no others;
    # a window tile over 256 tokens (a W of 300) is refused
    i32 = torch.tensor(1, dtype=torch.int32)
    counts = [dict(n_chunks=i32.long()), dict(win_len=torch.tensor(10.0)),
              dict(n_chunks=torch.ones(2, dtype=torch.int32)), dict(win_len=i32.to("meta")),
              dict(k_win=bf(k_win)[:, :1].expand(-1, 300, -1, -1).contiguous(),
                   v_win=bf(v_win)[:, :1].expand(-1, 300, -1, -1).contiguous())]
    cases = (
        (tar.sparse_key_scores, scores,
         [dict(fmt=tf5), dict(fmt=tsf.ChunkFormat(256, 128, 40, qbits=8)),
          dict(q=qs.float()), dict(q=qs[:, :4]), dict(k_bmp=kb.to(torch.int64)),
          dict(k_segs=ks[:1]), dict(k_segs=[ks[0], ks[1].float()]),
          dict(k_bmp=kb[:, :8])]),
        (tar.sparse_value_combine, combine,
         [dict(fmt=tf5), dict(w=w.float()), dict(w=w[:, :, :256]),
          dict(v_segs=[vs[0].transpose(1, 2).contiguous().transpose(1, 2), vs[1]])]),
        (tar.sparse_decode_attention, dec,
         [dict(kfmt=tf5), dict(win_len=W + 1), dict(k_win=bf(k_win)[:, :, :1]),
          dict(q=bf(q).to(torch.float16)), dict(q=bf(q)[:, :, :3]),
          dict(v_win=bf(v_win)[:, :10]), dict(k_segs=ck), dict(k_bmp=kb.to(torch.int16))]),
        (tar.fused_sparse_decode_attention, dec,
         [dict(vfmt=tf5), dict(win_len=-1), dict(k_segs=ck), dict(hpb=0)] + counts),
        (tar.fused_sparse_decode_attention_v3, dec3,
         [dict(kfmt=tf5), dict(k_segs=ks), dict(v_bmp=vb), dict(win_len=W + 1)] + counts),
    )
    for fn, ok, bad in cases:
        fn(**ok)
        for change in bad + common:
            with pytest.raises((ValueError, TypeError, NotImplementedError)):
                fn(**dict(ok, **change))
        # a device the kernels do not run on is refused, never computed on the CPU
        meta = {k: (v.to("meta") if torch.is_tensor(v)
                    else [x.to("meta") for x in v] if isinstance(v, list) else v)
                for k, v in ok.items()}
        with pytest.raises(ValueError):
            fn(**meta)
    # a grid of more than MAX_SPLITS steps a row: 512 chunks (2,051 steps)
    big = 512
    many = dict(dec, max_chunks=big, n_chunks=0,
                k_segs=[torch.zeros((2, big * tf.seg_rows(k), 128), dtype=torch.bfloat16)
                        for k in tf.segs],
                k_bmp=torch.zeros((2, big * tf.planes, 128), dtype=torch.int32))
    many.update(v_segs=many["k_segs"], v_bmp=many["k_bmp"])
    with pytest.raises(ValueError, match="steps a row"):
        tar.fused_sparse_decode_attention(**many)
    assert (tar.sparse_key_scores.launches, tar.sparse_value_combine.launches,
            tar.fused_sparse_decode_attention.launches,
            tar.fused_sparse_decode_attention_v3.launches) == (0, 0, 0, 0)


def test_module_imports_and_builds_nothing_without_nvcc(tmp_path):
    """Importing the module needs no nvcc and builds nothing; asking for an
    archive kernel's library where there is no nvcc raises (no fallback)."""
    code = (
        "import mustafar_tpu_torch.ops.kernels.sparse_attention_archive as sar\n"
        "from mustafar_tpu_torch.ops.kernels import build\n"
        "assert build._LIBS == {}\n"
        "for name in ('sp_archive_spmv', 'sp_archive_fused'):\n"
        "    assert (build.CSRC_DIR / f'{name}.cu').exists()\n"
        "    try:\n"
        "        build.load(name)\n"
        "    except RuntimeError as e:\n"
        "        assert 'nvcc' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('built without nvcc')\n")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=os.getcwd(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
