"""Port parity, the archived decode generations v4-v6 over the fused stream
pool (``ops/kernels/sparse_attention_archive.py``, TPU kernels 14-16).

(a) The plain versions of ``fused_sparse_decode_attention_v4`` (kernel 14),
    ``_v5`` (kernel 15) and ``_v6`` (kernel 16 and the window merge) against
    the JAX kernels run in Pallas interpret mode on the same stream pool
    [mc, B*Hkv, KR + VR, 128], encoded once per sparsity by the jitted JAX
    codec (``prune_and_encode_stream``, which calls ``encode_stream``) from
    random chunks: sparsity 0.7 and 0.5 (zero pads), G 1/2/4/8, (n_chunks,
    win_len) with chunks and a window, chunks alone, the window alone;
    bf16 and f32 q (v6's window scores take q in its own dtype); v6's
    ``window`` cutting inside a chunk, at chunk edges and below every chunk
    column; v5 at two ``hpb``.
(b) Nothing to attend (n_chunks = win_len = 0), where the generations
    disagree and the port follows each: v4 gives the mean of the head's W
    window rows, v5 the mean of the windows of all heads of its TPU grid
    step (hpb halved until it divides B*Hkv: at B*Hkv = 12, 8 becomes 4),
    v6 NaN.
(c) The production plain versions held against the archive's, as
    ``tests/test_kernels.py`` holds the JAX production kernels: kernel 7's
    (per slot) against v4 per sequence, kernel 6's against v6.
(d) The wrappers refuse what the CUDA kernels cannot serve (formats,
    shapes, dtypes, hpb, window, devices, counts) instead of falling back;
    on the CPU nothing launches; a layer of a stacked pool passes as a
    view; importing the module builds nothing.
The CUDA kernels run only on the card: ``chip_smoke.py`` (phases
``kernel_archive`` and ``kernel_archive_cache``) holds them against the
plain versions there.

Tolerances, each with its reason:
  parity      one bf16 ulp (2^-8) of the output's largest magnitude: the
              same f32 arithmetic in another order can move the bf16 output
              (or a bf16 p) by one ulp;
  production  rtol = atol = 2e-2, the JAX tests' own
              (tests/test_kernels.py): kernels 6 and 7 take the window's
              live rows in tiles of up to 96, v4 the whole window in one
              step and v6 in a softmax of its own merged with the pools',
              so bf16(p) rounds at other places.
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
from mustafar_tpu_torch.ops.kernels import sparse_attention as tska
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

B, HKV, MC, W = 2, 2, 3, 288              # W: residual 32 + chunk 256
ULP = 2.0 ** -8
PROD_TOL = 2e-2
GENS = ("v4", "v5", "v6")


def _fmts(sparsity):
    keep = 128 - int(sparsity * 128) + 1
    return jsf.ChunkFormat(256, 128, keep), tsf.ChunkFormat(256, 128, keep)


def _bf(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16)).astype(np.float32)


def _stream_pool(seed, BH, mc, sparsity):
    """Random K and V chunks pruned and packed by the jitted JAX codec into
    the stream pool [mc, BH, KR + VR, 128] int16 (numpy)."""
    jf, _ = _fmts(sparsity)
    x = np.random.RandomState(seed).randn(2, BH, mc, 256, 128).astype(np.float32)
    rows = np.asarray(jax.jit(lambda a: jsf.prune_and_encode_stream(a, jf))(
        jnp.asarray(x, jnp.bfloat16)))                       # [2, BH, mc, SR, 128]
    return np.ascontiguousarray(np.concatenate([rows[0], rows[1]], axis=-2).swapaxes(0, 1))


@pytest.fixture(scope="module")
def pools():
    """One stream pool per sparsity, encoded once."""
    return {sp: _stream_pool(int(sp * 10), B * HKV, MC, sp) for sp in (0.7, 0.5)}


def _inputs(G, seed=None):
    """q [B, 1, Hkv*G, 128], k_win and v_win [B, W, Hkv, 128] on the bf16
    grid (numpy f32); by default the inputs of every call at this G."""
    rs = np.random.RandomState(100 + G if seed is None else seed)
    return (_bf(rs.randn(B, 1, HKV * G, 128)), _bf(rs.randn(B, W, HKV, 128)),
            _bf(rs.randn(B, W, HKV, 128)))


@pytest.fixture(scope="module")
def port(pools):
    """``port(gen, sparsity, G, nc, wl, q_dtype, **opts)`` -> the port's
    plain output (the wrapper on CPU tensors) as f32 numpy."""
    def call(gen, sparsity, G, nc, wl, q_dtype="bfloat16", **opts):
        _, tf = _fmts(sparsity)
        q, k_win, v_win = _inputs(G)
        fn = getattr(tar, f"fused_sparse_decode_attention_{gen}")
        to = fn(torch.from_numpy(q).to(getattr(torch, q_dtype)),
                torch.from_numpy(pools[sparsity]), torch.from_numpy(k_win).to(torch.bfloat16),
                torch.from_numpy(v_win).to(torch.bfloat16), nc, wl, tf, tf, MC, **opts)
        assert to.dtype == getattr(torch, q_dtype) and to.shape == q.shape
        return to.float().numpy()
    return call


@pytest.fixture(scope="module")
def run(pools, port):
    """``run(gen, sparsity, G, nc, wl, q_dtype, **opts)`` -> (JAX output in
    interpret mode, the port's) as f32 numpy; each JAX call is made once."""
    cache = {}

    def call(gen, sparsity, G, nc, wl, q_dtype="bfloat16", **opts):
        key = (gen, sparsity, G, nc, wl, q_dtype, tuple(sorted(opts.items())))
        if key not in cache:
            jf, _ = _fmts(sparsity)
            q, k_win, v_win = _inputs(G)
            jfn = getattr(jar, f"fused_sparse_decode_attention_{gen}")
            cache[key] = np.asarray(_jit(jfn)(
                jnp.asarray(q, getattr(jnp, q_dtype)), jnp.asarray(pools[sparsity]),
                jnp.asarray(k_win, jnp.bfloat16), jnp.asarray(v_win, jnp.bfloat16),
                jnp.int32(nc), jnp.int32(wl), jf, jf, MC, **opts)).astype(np.float32)
        return cache[key], port(gen, sparsity, G, nc, wl, q_dtype, **opts)
    return call


def _close(to, jo):
    np.testing.assert_allclose(to, jo, rtol=0, atol=ULP * np.abs(jo).max())


def _no_launches():
    return all(getattr(tar, f"fused_sparse_decode_attention_{g}").launches == 0
               for g in GENS)


@pytest.mark.parametrize("nc,wl,G,sparsity,q_dtype", [
    (2, 90, 4, 0.7, "bfloat16"), (3, 0, 8, 0.5, "bfloat16"), (0, 30, 1, 0.7, "float32"),
    (1, 288, 2, 0.5, "float32")])
def test_v4_plain_matches_jax(run, nc, wl, G, sparsity, q_dtype):
    """v4: chunks one step each, then the whole window in one step masked
    at -1e30; q and the window read as bf16."""
    jo, to = run("v4", sparsity, G, nc, wl, q_dtype)
    _close(to, jo)
    assert _no_launches()


@pytest.mark.parametrize("nc,wl,G,sparsity,hpb", [
    (2, 90, 4, 0.7, 8), (3, 0, 1, 0.5, 2), (0, 30, 8, 0.7, 8)])
def test_v5_plain_matches_jax(run, port, nc, wl, G, sparsity, hpb):
    """v5: the other heads' columns at -1e30 add exactly 0 once a row has a
    live column, so its result is v4's, whatever hpb."""
    jo, to = run("v5", sparsity, G, nc, wl, hpb=hpb)
    _close(to, jo)
    np.testing.assert_array_equal(to, port("v4", sparsity, G, nc, wl))
    assert _no_launches()


@pytest.mark.parametrize("nc,wl,G,sparsity,q_dtype", [
    (2, 90, 4, 0.7, "bfloat16"), (2, 90, 4, 0.7, "float32"), (3, 0, 8, 0.5, "bfloat16"),
    (0, 30, 1, 0.7, "float32")])
def test_v6_plain_matches_jax(run, port, nc, wl, G, sparsity, q_dtype):
    """v6: the pools' partials, then the window in torch ops in JAX's order
    (scores with q in its own dtype, -inf masks, m_w clamped to -1e30,
    bf16 p_w) and the flash merge."""
    jo, to = run("v6", sparsity, G, nc, wl, q_dtype)
    _close(to, jo)
    if q_dtype == "float32":                    # the window saw f32 q, the pools bf16 q
        assert np.abs(to - port("v6", sparsity, G, nc, wl)).max() > 0
    assert _no_launches()


@pytest.mark.parametrize("nc,wl,window,G,sparsity", [
    (3, 200, 512, 4, 0.7),      # tests/test_kernels.py's case: most of chunk 0 masked
    (2, 120, 512, 4, 0.5),      # the v7 test's: chunk 0's first 95 columns
    (3, 0, 300, 8, 0.7),        # no window rows: chunks 0-1 skipped, chunk 2 cut
    (2, 90, 600, 1, 0.7),       # two columns of chunk 0 masked
    (3, 200, 100, 2, 0.5)])     # window <= win_len: every chunk column masked
def test_v6_sliding_window_matches_jax(run, port, nc, wl, window, G, sparsity):
    """``window`` masks the chunk columns at or below nc*256 + win_len - 1 -
    window; chunks wholly below are skipped in the port, where on the TPU
    their p = 1 is wiped by the first live column's corr = 0 (or, with no
    live chunk column, by the merge's exp(-1e30 - m_w) = 0)."""
    jo, to = run("v6", sparsity, G, nc, wl, window=window)
    _close(to, jo)
    assert np.abs(to - port("v6", sparsity, G, nc, wl)).max() > 0   # it masked something
    low = tar._window_low(nc, wl, window)
    assert low == nc * 256 + wl - 1 - window
    assert _no_launches()


def test_nothing_to_attend_per_generation(run):
    """n_chunks = win_len = 0: v4 the mean of the head's W window rows, v5
    the mean over its grid step's heads (hpb 8 -> all 4 heads; hpb 2 ->
    pairs: two different answers), v6 NaN; JAX and the port alike."""
    _, _, v_win = _inputs(4)
    vw = v_win.transpose(0, 2, 1, 3).reshape(B * HKV, W, 128)             # [BH, W, D]
    jo, to = run("v4", 0.7, 4, 0, 0)
    head = np.repeat(vw.mean(axis=1), 4, axis=0).reshape(B, 1, HKV * 4, 128)
    _close(jo, head)
    _close(to, jo)
    outs = {}
    for hpb in (8, 2):
        jo, to = run("v5", 0.7, 4, 0, 0, hpb=hpb)
        hp = tar.tpu_hpb(hpb, B * HKV)
        grp = vw.reshape(B * HKV // hp, hp * W, 128).mean(axis=1)
        want = np.repeat(np.repeat(grp, hp, axis=0), 4, axis=0).reshape(B, 1, HKV * 4, 128)
        _close(jo, want)
        _close(to, jo)
        outs[hpb] = to
    assert np.abs(outs[8] - outs[2]).max() > 1e-3
    jo, to = run("v6", 0.7, 4, 0, 0)
    assert np.isnan(jo).all() and np.isnan(to).all()
    assert _no_launches()


def test_v5_nothing_to_attend_halves_hpb():
    """At B*Hkv = 12 the JAX package's hpb 8 becomes 4 (halved until it
    divides 12), not 6, the largest divisor: v5's window mean runs over
    groups of 4 heads."""
    assert [tar.tpu_hpb(h, bh) for h, bh in ((8, 12), (8, 4), (2, 4), (3, 4), (8, 6),
                                             (8, 64))] == [4, 4, 2, 1, 6, 8]
    Bb, Hk, G = 2, 6, 1
    jf, tf = _fmts(0.7)
    rs = np.random.RandomState(5)
    q = _bf(rs.randn(Bb, 1, Hk * G, 128))
    v_win = _bf(rs.randn(Bb, 16, Hk, 128))
    k_win = _bf(rs.randn(Bb, 16, Hk, 128))
    pool = np.zeros((1, Bb * Hk, 2 * jf.stream_rows, 128), np.int16)
    jo = np.asarray(_jit(jar.fused_sparse_decode_attention_v5)(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(pool), jnp.asarray(k_win, jnp.bfloat16),
        jnp.asarray(v_win, jnp.bfloat16), jnp.int32(0), jnp.int32(0), jf, jf, 1)
    ).astype(np.float32)
    to = tar.fused_sparse_decode_attention_v5(
        torch.from_numpy(q).to(torch.bfloat16), torch.from_numpy(pool),
        torch.from_numpy(k_win).to(torch.bfloat16), torch.from_numpy(v_win).to(torch.bfloat16),
        0, 0, tf, tf, 1).float().numpy()
    grp = v_win.transpose(0, 2, 1, 3).reshape(3, 4 * 16, 128).mean(axis=1)
    want = np.repeat(grp, 4, axis=0).reshape(Bb, 1, Hk, 128)
    _close(jo, want)
    _close(to, jo)


def _torch_case(G, sparsity, seed):
    _, tf = _fmts(sparsity)
    q, k_win, v_win = _inputs(G, seed)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    return tf, bf(q), bf(k_win), bf(v_win)


def test_v6_partials_plain(pools):
    """Kernel 16's partials: (0, -1e30, 0) exactly with no chunk or no live
    chunk column; with chunks, the merge of the partials and the window is
    v6's output."""
    tf, q, k_win, v_win = _torch_case(4, 0.7, 7)
    pool = torch.from_numpy(pools[0.7])
    for nc, wl, window in ((0, 30, None), (3, 200, 100), (2, 0, None)):
        acc, m, l = tar.fused_sparse_decode_attention_v6_partials(q, pool, nc, wl, tf, tf, MC,
                                                                  window=window)
        assert acc.shape == (B * HKV, 4, 128) and m.shape == l.shape == (B * HKV, 4, 1)
        assert acc.dtype == m.dtype == l.dtype == torch.float32
        if nc == 0 or window is not None:
            assert (acc == 0).all() and (m == -1e30).all() and (l == 0).all()
        else:
            assert (l > 0).all() and torch.isfinite(acc).all()
        out = tar.fused_sparse_decode_attention_v6(q, pool, k_win, v_win, nc, wl, tf, tf, MC,
                                                   window=window)
        np.testing.assert_array_equal(out.float().numpy(),
                                      tar._v6_merge(q, k_win, v_win, wl, acc, m, l)
                                      .float().numpy())
    assert _no_launches()


def test_layer_view_of_a_stacked_pool(pools):
    """A layer kv_pool[li] of the cache's stacked pool [L, mc, BH, rows, 128]
    is the stream pool's layout and passes as a view, no copy needed."""
    tf, q, k_win, v_win = _torch_case(2, 0.7, 8)
    one = torch.from_numpy(pools[0.7])
    stacked = torch.stack([torch.zeros_like(one), one, torch.zeros_like(one)])
    view = stacked[1]
    assert view.is_contiguous() and view.data_ptr() != one.data_ptr()
    for gen in GENS:
        fn = getattr(tar, f"fused_sparse_decode_attention_{gen}")
        np.testing.assert_array_equal(fn(q, view, k_win, v_win, 2, 50, tf, tf, MC).float(),
                                      fn(q, one, k_win, v_win, 2, 50, tf, tf, MC).float())


def test_production_per_slot_plain_is_v4_per_sequence(pools):
    """Kernel 7's plain version (per slot) against v4's per sequence, as the
    JAX package holds v6ps against v4 (tests/test_kernels.py)."""
    tf, q, k_win, v_win = _torch_case(4, 0.7, 12)
    pool = torch.from_numpy(pools[0.7])
    ncs, wls = torch.tensor([1, 3], dtype=torch.int32), torch.tensor([40, 90], dtype=torch.int32)
    hm = lambda w: w.permute(0, 2, 1, 3).reshape(1, B * HKV, W, 128).contiguous()
    got = tska.fused_sparse_decode_attention_ps_plain(q, pool[None], hm(k_win), hm(v_win),
                                                      ncs, wls, 0, tf, tf).float().numpy()
    for b in range(B):
        hs = slice(b * HKV, (b + 1) * HKV)
        ref = tar.fused_sparse_decode_attention_v4_plain(
            q[b:b + 1], pool[:, hs], k_win[b:b + 1], v_win[b:b + 1], int(ncs[b]),
            int(wls[b]), tf, tf, MC).float().numpy()
        np.testing.assert_allclose(got[b:b + 1], ref, rtol=PROD_TOL, atol=PROD_TOL)


@pytest.mark.parametrize("nc,wl", [(0, 30), (1, 90), (3, 288), (2, 0)])
def test_production_decode_plain_is_v6(pools, nc, wl):
    """Kernel 6's plain version against v6's (no window), at the JAX v7
    test's cases (tests/test_kernels.py)."""
    tf, q, k_win, v_win = _torch_case(4, 0.5, 13 + nc)
    pool = torch.from_numpy(pools[0.5])
    hm = lambda w: w.permute(0, 2, 1, 3).reshape(1, B * HKV, W, 128).contiguous()
    got = tska.fused_sparse_decode_attention_plain(q, pool[None], hm(k_win), hm(v_win), nc,
                                                   wl, 0, tf, tf).float().numpy()
    ref = tar.fused_sparse_decode_attention_v6_plain(q, pool, k_win, v_win, nc, wl, tf, tf,
                                                     MC).float().numpy()
    np.testing.assert_allclose(got, ref, rtol=PROD_TOL, atol=PROD_TOL)


def test_wrappers_refuse_what_the_kernels_cannot_serve(pools):
    tf, q, k_win, v_win = _torch_case(4, 0.7, 11)
    _, tf5 = _fmts(0.5)
    pool = torch.from_numpy(pools[0.7])
    ok = dict(q=q, kv_pool=pool, k_win=k_win, v_win=v_win, n_chunks=1, win_len=10, kfmt=tf,
              vfmt=tf, max_chunks=MC)
    bad = [dict(kfmt=tsf.ChunkFormat(256, 128, 40, qbits=8)), dict(vfmt=tf5),
           dict(kfmt=tsf.ChunkFormat(128, 128, 40)), dict(kv_pool=pool[:2]),
           dict(kv_pool=pool[:, :, :100]), dict(kv_pool=pool[None]),
           dict(kv_pool=pool.to(torch.int32)), dict(kv_pool=pool.transpose(2, 3)),
           dict(kv_pool=pool[:, :3]), dict(q=q.to(torch.float16)), dict(q=q[:, :, :3]),
           dict(q=q[:, :, :, :64]), dict(k_win=k_win[:, :, :1]), dict(v_win=v_win[:, :10]),
           dict(k_win=k_win.to(torch.float16), v_win=v_win.to(torch.float16)),
           dict(v_win=v_win.float()), dict(n_chunks=MC + 1), dict(n_chunks=-1),
           dict(n_chunks=1.0), dict(win_len=W + 1), dict(win_len=-1), dict(max_chunks=2),
           dict(hpb=0), dict(hpb=-8), dict(hpb=2.0), dict(hpb=True)]
    for gen in GENS:
        fn = getattr(tar, f"fused_sparse_decode_attention_{gen}")
        fn(**ok)
        for change in bad + ([dict(window=0), dict(window=-5), dict(window=1.5),
                              dict(window=True)] if gen == "v6" else []):
            with pytest.raises((ValueError, TypeError, NotImplementedError)):
                fn(**dict(ok, **change))
        # a device the kernels do not run on is refused, never computed on the CPU
        with pytest.raises(ValueError):
            fn(**{k: (v.to("meta") if torch.is_tensor(v) else v) for k, v in ok.items()})
    tar.fused_sparse_decode_attention_v6(**ok, window=1)
    with pytest.raises(TypeError):                       # v4 and v5 take no window
        tar.fused_sparse_decode_attention_v4(**ok, window=512)
    with pytest.raises(ValueError):
        tar.fused_sparse_decode_attention_v6_partials(q.to("meta"), pool.to("meta"), 1, 10,
                                                      tf, tf, MC)
    assert _no_launches()


def test_module_imports_and_builds_nothing_without_nvcc(tmp_path):
    """Importing the module needs no nvcc and builds nothing; asking for the
    stream kernels' library where there is no nvcc raises (no fallback)."""
    code = (
        "import mustafar_tpu_torch.ops.kernels.sparse_attention_archive as sar\n"
        "from mustafar_tpu_torch.ops.kernels import build\n"
        "assert build._LIBS == {}\n"
        "assert (build.CSRC_DIR / 'sp_archive_stream.cu').exists()\n"
        "try:\n"
        "    build.load('sp_archive_stream')\n"
        "except RuntimeError as e:\n"
        "    assert 'nvcc' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('built without nvcc')\n")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=os.getcwd(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
