"""Port parity, the KV caches on identical inputs.

(e) After ``prefill_attend`` on the same k/v, the compressed cache state
    (int16 pool, bf16 scales, windows, n_chunks) equals the JAX package's
    exactly; so does the state after ``compact``.  Decode outputs on the
    same state match the JAX kernel (interpret mode).  The dense cache's
    prefill and decode match the JAX dense cache.  Every codec the port
    serves: the quant codecs q8, q8q4 and q4q4, bitmap (whose state has no
    scales) and bitmap-q8 (int8 codes in the bitmap streams, bf16 scales).
Tiny geometry: head_dim 128 (the compressed format's row width), 4 query
heads over 2 kv heads, 2 layers.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mustafar_tpu import config as jc
from mustafar_tpu.cache import make_cache as j_make_cache
from mustafar_tpu_torch import config as tc
from mustafar_tpu_torch.cache import make_cache as t_make_cache

torch.set_num_threads(2)


def _engine(mod, mode, max_seq=1024, codec="q8q4"):
    model = dataclasses.replace(mod.TINY_LLAMA, head_dim=128, num_heads=4,
                                num_kv_heads=2, hidden_size=256)
    return mod.EngineConfig(
        model=model, cache_mode=getattr(mod.CacheMode, mode),
        prune=mod.PruneConfig(method=mod.PruneMethod.KT_MAG_VT_MAG,
                              k_sparsity=0.7, v_sparsity=0.7),
        max_seq_len=max_seq, prefill_bucket=256, chunk_size=256, codec=codec)


def _state_keys(timpl):
    return timpl.pool_keys + ("k_win", "v_win", "n_chunks")


def _np(x):
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _assert_state_equal(t_state, j_lc, li, keys):
    for key in keys:
        t = t_state[key][li]
        t = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        np.testing.assert_array_equal(t, _np(j_lc[key]), err_msg=key)


def _qkv(rs, B, T, dtype):
    q = rs.randn(B, T, 4, 128).astype(np.float32) * 0.5
    k = rs.randn(B, T, 2, 128).astype(np.float32) * 0.5
    v = rs.randn(B, T, 2, 128).astype(np.float32) * 0.5
    if dtype == "bfloat16":
        q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16)).astype(np.float32)
                   for x in (q, k, v))
    return q, k, v


def _to(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


_PREFILL_CASES = [("bfloat16", 300, 512), ("float32", 600, 768), ("bfloat16", 20, 256)]


@pytest.mark.parametrize("dtype,true_len,T,codec", [
    *(pytest.param(*c, "q8q4", id="-".join(map(str, c))) for c in _PREFILL_CASES),
    *(pytest.param(*c, "bitmap", id="-".join(map(str, c)) + "-bitmap")
      for c in _PREFILL_CASES[:2]),
    *(pytest.param(*c, "bitmap-q8", id="-".join(map(str, c)) + "-bitmap-q8")
      for c in _PREFILL_CASES[:2]),
    pytest.param(*_PREFILL_CASES[0], "q8", id="bfloat16-300-512-q8"),
    pytest.param(*_PREFILL_CASES[1], "q4q4", id="float32-600-768-q4q4")])
def test_compressed_prefill_state_bit_exact(dtype, true_len, T, codec):
    jimpl = j_make_cache(_engine(jc, "COMPRESSED", codec=codec))
    timpl = t_make_cache(_engine(tc, "COMPRESSED", codec=codec), device="cpu")
    B = 2
    q, k, v = _qkv(np.random.RandomState(true_len), B, T, dtype)
    jdt = getattr(jnp, dtype)
    jstate = jimpl.init(B, jdt)
    tstate = timpl.init(B, getattr(torch, dtype))
    lc = {key: val[1] for key, val in jstate.items()}
    jout, lc = jimpl.prefill_attend(lc, jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                    jnp.asarray(v, jdt), jnp.int32(true_len))
    tout = timpl.prefill_attend(tstate, 1, _to(q, dtype), _to(k, dtype),
                                _to(v, dtype), true_len)
    assert set(tstate) - {"nc_host"} == set(lc)
    _assert_state_equal(tstate, lc, 1, _state_keys(timpl))
    n_pre = max(true_len - 32, 0) // 256
    assert tstate["nc_host"] == n_pre and int(np.asarray(lc["n_chunks"])[0]) == n_pre
    assert (tstate["kv_pool"][0] == 0).all()                 # layer 0 untouched
    # prefill attention output: f32 products, another summation order
    jo, to = _np(jout)[:, :true_len], tout.float().numpy()[:, :true_len]
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(to, jo, rtol=0, atol=tol * np.abs(jo).max())


def test_compressed_decode_and_compact_match():
    """Decode steps over the same state agree with the JAX kernel (interpret
    mode); a compaction of a full window leaves bit-identical state."""
    _decode_and_compact("q8q4")


def test_compressed_decode_and_compact_match_bitmap():
    """As above for the bitmap codec (TPU kernel v7 in interpret mode)."""
    _decode_and_compact("bitmap")


def test_compressed_decode_and_compact_match_bitmap_q8():
    """As above for the bitmap-q8 codec (TPU kernel v7 with its scales in
    interpret mode): pool rows and scales bit-exact after the compaction."""
    _decode_and_compact("bitmap-q8")


@pytest.mark.parametrize("codec", ["q8", "q4q4"])
def test_compressed_decode_and_compact_match_quant(codec):
    """As above for the other quant codecs (int8 K and V; int4 K and V)."""
    _decode_and_compact(codec)


def _decode_and_compact(codec):
    jimpl = j_make_cache(_engine(jc, "COMPRESSED", codec=codec))
    jimpl.use_pallas = True
    timpl = t_make_cache(_engine(tc, "COMPRESSED", codec=codec), device="cpu")
    B, true_len = 2, 300
    rs = np.random.RandomState(7)
    q, k, v = _qkv(rs, B, 512, "bfloat16")
    jstate = jimpl.init(B, jnp.bfloat16)
    tstate = timpl.init(B, torch.bfloat16)
    lc = {key: val[0] for key, val in jstate.items()}
    _, lc = jimpl.prefill_attend(lc, jnp.asarray(q, jnp.bfloat16),
                                 jnp.asarray(k, jnp.bfloat16),
                                 jnp.asarray(v, jnp.bfloat16), jnp.int32(true_len))
    timpl.prefill_attend(tstate, 0, _to(q, "bfloat16"), _to(k, "bfloat16"),
                         _to(v, "bfloat16"), true_len)
    jdecode = jax.jit(jimpl.decode_attend)
    pos = true_len
    while not timpl.window_full(tstate, pos):
        qd, kd, vd = _qkv(rs, B, 1, "bfloat16")
        jo, lc = jdecode(lc, jnp.asarray(qd, jnp.bfloat16),
                         jnp.asarray(kd, jnp.bfloat16),
                         jnp.asarray(vd, jnp.bfloat16), jnp.int32(pos))
        to = timpl.decode_attend(tstate, 0, _to(qd, "bfloat16"), _to(kd, "bfloat16"),
                                 _to(vd, "bfloat16"), pos)
        if pos % 61 == 0 or pos == true_len:
            jo = _np(jo)
            # same arithmetic and softmax steps: one bf16 ulp of the output
            np.testing.assert_allclose(to.float().numpy(), jo, rtol=0,
                                       atol=2 ** -8 * np.abs(jo).max())
        pos += 1
    assert pos == 256 + 32 + 256 and timpl.needs_compact(pos)
    _assert_state_equal(tstate, lc, 0, ("k_win", "v_win"))
    jfull = {key: val[None] for key, val in lc.items()}
    jfull = jimpl.compact(jfull, True)
    timpl.compact(tstate)              # layer 1 holds an all-zero window
    _assert_state_equal(tstate, {key: val[0] for key, val in jfull.items()}, 0,
                        _state_keys(timpl))
    assert tstate["nc_host"] == 2


def test_dense_cache_matches():
    jimpl = j_make_cache(_engine(jc, "DENSE", max_seq=640))
    timpl = t_make_cache(_engine(tc, "DENSE", max_seq=640), device="cpu")
    B, true_len = 2, 100
    rs = np.random.RandomState(8)
    q, k, v = _qkv(rs, B, 256, "float32")
    jstate = jimpl.init(B, jnp.float32)
    tstate = timpl.init(B, torch.float32)
    lc = {key: val[0] for key, val in jstate.items()}
    _, lc = jimpl.prefill_attend(lc, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.int32(true_len))
    timpl.prefill_attend(tstate, 0, _to(q, "float32"), _to(k, "float32"),
                         _to(v, "float32"), true_len)
    _assert_state_equal(tstate, lc, 0, ("k", "v"))
    full = {key: val[None] for key, val in lc.items()}
    for pos in range(true_len, true_len + 5):
        qd, kd, vd = _qkv(rs, B, 1, "float32")
        jo, _, upd = jimpl.decode_attend({}, jnp.asarray(qd), jnp.asarray(kd),
                                         jnp.asarray(vd), jnp.int32(pos), full,
                                         jnp.int32(0))
        full = dict(full, **upd)
        to = timpl.decode_attend(tstate, 0, _to(qd, "float32"), _to(kd, "float32"),
                                 _to(vd, "float32"), pos)
        # f32 throughout: summation order only
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-5)
    _assert_state_equal(tstate, {key: val[0] for key, val in full.items()}, 0,
                        ("k", "v"))


def test_make_cache_modes():
    # the masked cache (the EngineConfig default) is served: its state has
    # the JAX package's keys and shapes
    masked = dataclasses.replace(_engine(tc, "DENSE"), cache_mode=tc.CacheMode.MASKED)
    impl = t_make_cache(masked, device="cpu")
    jmasked = dataclasses.replace(_engine(jc, "DENSE"), cache_mode=jc.CacheMode.MASKED)
    assert type(impl).__name__ == type(j_make_cache(jmasked)).__name__ == "MaskedKVCache"
    assert {k: tuple(v.shape) for k, v in impl.init(2).items()} == \
        {k: tuple(v.shape) for k, v in j_make_cache(jmasked).init(2).items()}
    rows = {"q8": 256, "q8q4": 192, "q4q4": 128, "bitmap": 192, "bitmap-q8": 112}
    for codec in ("q8", "q8q4", "q4q4", "bitmap", "bitmap-q8"):
        impl = t_make_cache(_engine(tc, "COMPRESSED", codec=codec), device="cpu")
        jimpl = j_make_cache(_engine(jc, "COMPRESSED", codec=codec))
        assert (impl.max_chunks, impl.wcap, impl.k_keep, impl.v_keep) == \
            (jimpl.max_chunks, jimpl.wcap, jimpl.k_keep, jimpl.v_keep) == (3, 288, 40, 40)
        shapes = {k: tuple(v.shape) for k, v in impl.init(2).items() if torch.is_tensor(v)}
        jshapes = {k: tuple(v.shape) for k, v in jimpl.init(2).items()}
        assert shapes == jshapes
        # int16 rows a chunk and head: q8 256, q8q4 192, q4q4 128, and 192
        # for bitmap and 112 for bitmap-q8 at sparsity 0.7
        assert shapes["kv_pool"] == (2, 3, 2, 2, rows[codec], 128)
        assert ("kv_scales" in shapes) == (codec != "bitmap")


@pytest.mark.parametrize("codec", ["q8q4", "q4q4", "bitmap", "bitmap-q8"])
def test_compressed_prefill_chunks_then_compact_bit_exact(codec):
    """A prompt of three chunks prefilled into both layers (the port packs a
    layer's chunks, K and V, in one call), then a compaction of both layers
    (one call for every layer; the bitmap codecs' eager packs likewise take
    every chunk or layer at once): pool, scales, windows and counts equal the
    JAX cache's bit for bit after each.  The windows are filled to r + C
    with the same tokens on both sides before the compaction."""
    jimpl = j_make_cache(_engine(jc, "COMPRESSED", max_seq=1312, codec=codec))
    timpl = t_make_cache(_engine(tc, "COMPRESSED", max_seq=1312, codec=codec),
                         device="cpu")
    B, true_len, T = 2, 3 * 256 + 32 + 50, 1024
    rs = np.random.RandomState(31)
    jstate, tstate = jimpl.init(B, jnp.bfloat16), timpl.init(B, torch.bfloat16)
    prefill = jax.jit(jimpl.prefill_attend)
    for li in range(2):
        q, k, v = _qkv(rs, B, T, "bfloat16")
        lc = {key: val[li] for key, val in jstate.items()}
        _, lc = prefill(lc, jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                        jnp.asarray(v, jnp.bfloat16), jnp.int32(true_len))
        jstate = {key: jstate[key].at[li].set(lc[key]) for key in jstate}
        timpl.prefill_attend(tstate, li, _to(q, "bfloat16"), _to(k, "bfloat16"),
                             _to(v, "bfloat16"), true_len)
    assert tstate["nc_host"] == 3
    for li in range(2):
        _assert_state_equal(tstate, {key: val[li] for key, val in jstate.items()}, li,
                            _state_keys(timpl))
    for key in ("k_win", "v_win"):
        win = np.asarray(jnp.asarray(rs.randn(*tstate[key].shape).astype(np.float32),
                                     jnp.bfloat16))
        jstate[key] = jnp.asarray(win)
        tstate[key].copy_(torch.from_numpy(win.astype(np.float32)))
    jstate = jax.jit(jimpl.compact)(jstate, True)
    timpl.compact(tstate)
    assert tstate["nc_host"] == 4
    for li in range(2):
        _assert_state_equal(tstate, {key: val[li] for key, val in jstate.items()}, li,
                            _state_keys(timpl))
