"""Port parity, the caches' chunked-prefill and continuous-batching steps.

(e) After every chunked-prefill segment (``segment_attend`` of each layer,
    then ``finalize_segment``) the compressed cache state equals the JAX
    package's exactly: int16 rows and bf16 scales bit for bit, windows and
    n_chunks equal.  The port packs a segment's chunk in place inside the
    layer where JAX stages it until after the layer scan; the states agree
    after the segment.  The segment outputs agree with JAX's (its segment
    kernel in Pallas interpret mode) within a bf16 rounding.
(f) ``insert_slot``, per-slot decode (windows written and attended at each
    slot's own position; an idle slot at pos -1 written nowhere) and
    ``compact_slots`` against the JAX package's, for the compressed cache
    and, where it applies, the dense one.
The codecs q8q4, bitmap (whose state has no scales) and bitmap-q8 (its
int8 streams with bf16 scales), and q4q4 for the segments.
The JAX side runs jitted, as it serves: jitted XLA rounds the quantisation
scale as the port does (``quant_format.recip_f32``).  Tiny geometry:
head_dim 128, 4 query heads over 2 kv heads, 2 layers, chunk 256, residual
32.
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

L, HQ, HKV, D = 2, 4, 2, 128
STATE_KEYS = ("kv_pool", "kv_scales", "k_win", "v_win", "n_chunks")


def _state_keys(codec):
    return tuple(k for k in STATE_KEYS if codec != "bitmap" or k != "kv_scales")


def _engine(mod, mode, max_seq=1024, codec="q8q4"):
    model = dataclasses.replace(mod.TINY_LLAMA, head_dim=128, num_heads=HQ,
                                num_kv_heads=HKV, hidden_size=256)
    return mod.EngineConfig(
        model=model, cache_mode=getattr(mod.CacheMode, mode),
        prune=mod.PruneConfig(method=mod.PruneMethod.KT_MAG_VT_MAG,
                              k_sparsity=0.7, v_sparsity=0.7),
        max_seq_len=max_seq, prefill_bucket=256, chunk_size=256, codec=codec)


def _np(x):
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _tnp(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _assert_equal(tstate, jstate, keys=STATE_KEYS, slots=None):
    for key in keys:
        t, j = _tnp(tstate[key]), _np(jstate[key])
        if slots is not None:                   # batch axis: 2 of the pool, 1 else
            axis = 2 if key.startswith("kv_") else 1
            t, j = t.take(slots, axis), j.take(slots, axis)
        np.testing.assert_array_equal(t, j, err_msg=key)


def _qkv(rs, B, T, dtype):
    """Per-layer q [L,B,T,HQ,D], k/v [L,B,T,HKV,D], on the dtype's grid."""
    q = rs.randn(L, B, T, HQ, D).astype(np.float32) * 0.5
    k = rs.randn(L, B, T, HKV, D).astype(np.float32) * 0.5
    v = rs.randn(L, B, T, HKV, D).astype(np.float32) * 0.5
    if dtype == "bfloat16":
        q, k, v = (_np(jnp.asarray(x, jnp.bfloat16)) for x in (q, k, v))
    return q, k, v


def _t(x, dtype):
    return torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))


def _j_segment(jimpl):
    """One segment over every layer through the JAX package's stacked
    protocol (what its ``models/llama.forward`` does around
    ``segment_attend``), then ``finalize_segment``; jitted."""
    pools = [key for key in ("kv_pool", "kv_scales") if key in jimpl.decode_stacked_ro]

    def seg(cache, qs, ks, vs, seg_start, true_len):
        full = {key: cache[key] for key in (*pools, "k_win", "v_win")}
        outs, lcs = [], []
        for li in range(L):
            out, lc, upd = jimpl.segment_attend(
                {"n_chunks": cache["n_chunks"][li]}, qs[li], ks[li], vs[li],
                seg_start, true_len, full, jnp.int32(li))
            full = dict(full, **upd)
            outs.append(out)
            lcs.append(lc)
        new = {key: jnp.stack([lc[key] for lc in lcs]) for key in lcs[0]}
        new.update(k_win=full["k_win"], v_win=full["v_win"],
                   **{key: cache[key] for key in pools})
        return jnp.stack(outs), jimpl.finalize_segment(cache, new)
    return jax.jit(seg)


@pytest.mark.parametrize("dtype,true_len,codec", [
    *(pytest.param("float32", n, "q8q4", id=f"float32-{n}") for n in (700, 530, 200)),
    *(pytest.param("float32", n, "bitmap", id=f"float32-{n}-bitmap") for n in (700, 200)),
    pytest.param("float32", 700, "q4q4", id="float32-700-q4q4"),
    pytest.param("float32", 700, "bitmap-q8", id="float32-700-bitmap-q8")])
def test_segments_state_bit_exact(dtype, true_len, codec):
    """Every segment of a chunked prefill at B=2: 700 tokens (3 segments, a
    chunk packed at segments 1 and 2, the last one partial), 530 (3
    segments; the last packs nothing, as 530 - 32 < 2 x 256) and 200 (one
    segment, no chunk).  In float32: the JAX package's CPU runtime has no
    bf16 x bf16 -> f32 dot for the window and self partials."""
    jimpl = j_make_cache(_engine(jc, "COMPRESSED", codec=codec))
    jimpl.use_pallas = True
    timpl = t_make_cache(_engine(tc, "COMPRESSED", codec=codec), device="cpu")
    B, C = 2, 256
    n_seg = -(-true_len // C)
    jdt = getattr(jnp, dtype)
    jstate, tstate = jimpl.init(B, jdt), timpl.init(B, getattr(torch, dtype))
    rs = np.random.RandomState(true_len)
    jseg = _j_segment(jimpl)
    for s in range(n_seg):
        q, k, v = _qkv(rs, B, C, dtype)
        jout, jstate = jseg(jstate, jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                            jnp.asarray(v, jdt), jnp.int32(s * C), jnp.int32(true_len))
        touts = [timpl.segment_attend(tstate, li, _t(q[li], dtype), _t(k[li], dtype),
                                      _t(v[li], dtype), s * C, true_len)
                 for li in range(L)]
        timpl.finalize_segment(tstate, s * C, true_len)
        _assert_equal(tstate, jstate, _state_keys(codec))
        nc = max(min(true_len, (s + 1) * C) - 32, 0) // C
        assert tstate["nc_host"] == nc == int(np.asarray(jstate["n_chunks"])[0, 0])
        valid = min(true_len - s * C, C)
        jo = _np(jout)[:, :, :valid]
        to = np.stack([_tnp(o) for o in touts])[:, :, :valid]
        # the same roundings on both sides (the pools' kernel rounds q*kscale
        # and p to bf16); f32 sums in another order may move one of them
        np.testing.assert_allclose(to, jo, rtol=0, atol=2 ** -7 * np.abs(jo).max(),
                                   err_msg=f"segment {s}")
    # the last segment leaves the window monolithic prefill leaves
    comp_len = max(true_len - 32, 0) // C * C
    wl = true_len - comp_len
    assert (tstate["k_win"][:, :, :, wl:] == 0).all()
    assert (tstate["k_win"][:, :, :, wl - 1] != 0).any()


def _j_decode_per_slot(jimpl):
    pools = [key for key in ("kv_pool", "kv_scales") if key in jimpl.decode_stacked_ro]

    def step(cache, qs, ks, vs, pos):
        full = {key: cache[key] for key in (*pools, "k_win", "v_win")}
        outs = []
        for li in range(L):
            out, _, upd = jimpl.decode_attend({"n_chunks": cache["n_chunks"][li]},
                                              qs[li], ks[li], vs[li], pos, full,
                                              jnp.int32(li))
            full = dict(full, **upd)
            outs.append(out)
        return jnp.stack(outs), dict(cache, k_win=full["k_win"], v_win=full["v_win"])
    return jax.jit(step)


def test_insert_decode_compact_per_slot():
    """Two requests prefilled alone (280 tokens: no chunk; 530: one chunk)
    and inserted into slots 0 and 2 of a 3-slot cache, slot 1 idle; per-slot
    decode until slot 0's window fills (8 steps), then ``compact_slots`` of
    slot 0, then 4 steps more.  State after insert and compaction and the
    active slots' windows after every step equal JAX's; outputs agree
    (JAX's per-slot kernel in Pallas interpret mode)."""
    _insert_decode_compact("q8q4")


def test_insert_decode_compact_per_slot_bitmap():
    """As above for the bitmap codec (JAX's v6ps kernel in interpret mode)."""
    _insert_decode_compact("bitmap")


def test_insert_decode_compact_per_slot_bitmap_q8():
    """As above for the bitmap-q8 codec: its scales inserted and compacted
    with the pool, and folded into the per-slot kernel."""
    _insert_decode_compact("bitmap-q8")


def _insert_decode_compact(codec):
    keys = _state_keys(codec)
    jimpl = j_make_cache(_engine(jc, "COMPRESSED", codec=codec))
    jimpl.use_pallas = True
    timpl = t_make_cache(_engine(tc, "COMPRESSED", codec=codec), device="cpu")
    rs = np.random.RandomState(11)
    jstate, tstate = jimpl.init(3, jnp.bfloat16), timpl.init(3, torch.bfloat16)
    jinsert = jax.jit(jimpl.insert_slot)
    for slot, true_len, T in ((0, 280, 512), (2, 530, 768)):
        q, k, v = _qkv(rs, 1, T, "bfloat16")
        jsub, tsub = jimpl.init(1, jnp.bfloat16), timpl.init(1, torch.bfloat16)
        prefill = jax.jit(jimpl.prefill_attend)
        for li in range(L):
            lc = {key: val[li] for key, val in jsub.items()}
            _, lc = prefill(lc, jnp.asarray(q[li], jnp.bfloat16),
                            jnp.asarray(k[li], jnp.bfloat16),
                            jnp.asarray(v[li], jnp.bfloat16), jnp.int32(true_len))
            jsub = {key: jsub[key].at[li].set(lc[key]) for key in jsub}
            timpl.prefill_attend(tsub, li, _t(q[li], "bfloat16"), _t(k[li], "bfloat16"),
                                 _t(v[li], "bfloat16"), true_len)
        jstate = jinsert(jstate, jsub, jnp.int32(slot))
        timpl.insert_slot(tstate, tsub, slot)
        _assert_equal(tstate, jstate, keys)
    assert tstate["nc_host"] is None
    with pytest.raises(ValueError):          # uniform decode refuses per-slot state
        timpl.decode_attend(tstate, 0, *(_t(x[0], "bfloat16") for x in _qkv(rs, 3, 1, "bfloat16")), 600)

    jdecode = _j_decode_per_slot(jimpl)
    jcompact = jax.jit(jimpl.compact_slots)
    pos = np.array([280, -1, 530])
    idle_win = tstate["k_win"][:, 1].clone()
    for step in range(12):
        q, k, v = _qkv(rs, 3, 1, "bfloat16")
        jout, jstate = jdecode(jstate, jnp.asarray(q, jnp.bfloat16),
                               jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
                               jnp.asarray(pos, jnp.int32))
        tpos = torch.from_numpy(pos)
        touts = [timpl.decode_attend(tstate, li, _t(q[li], "bfloat16"), _t(k[li], "bfloat16"),
                                     _t(v[li], "bfloat16"), tpos) for li in range(L)]
        jo = _np(jout)[:, [0, 2]]
        to = np.stack([_tnp(o) for o in touts])[:, [0, 2]]
        np.testing.assert_allclose(to, jo, rtol=0, atol=2 ** -8 * np.abs(jo).max(),
                                   err_msg=f"step {step}")
        _assert_equal(tstate, jstate, ("k_win", "v_win", "n_chunks"), slots=[0, 2])
        pos[[0, 2]] += 1
        do = [bool(timpl.needs_compact(int(p))) if p >= 0 else False for p in pos]
        if any(do):
            assert step == 7 and do == [True, False, False]
            jstate = jcompact(jstate, jnp.asarray(do))
            timpl.compact_slots(tstate, do)
            _assert_equal(tstate, jstate, keys, slots=[0, 2])
            assert tstate["n_chunks"][:, 0].tolist() == [1, 1]
    assert torch.equal(tstate["k_win"][:, 1], idle_win)     # idle slot never written
    assert (tstate["kv_pool"][:, :, 1] == 0).all()


def test_compact_slots_refuses_a_full_pool():
    """A slot whose pool is full is refused, as the uniform ``compact`` refuses
    it, and nothing is written; a slot with room compacts."""
    timpl = t_make_cache(_engine(tc, "COMPRESSED", max_seq=768), device="cpu")
    state = timpl.init(2, torch.bfloat16)
    state["k_win"].normal_(generator=torch.Generator().manual_seed(0))
    state["n_chunks"][:, 0] = timpl.max_chunks
    before = {key: state[key].clone() for key in STATE_KEYS}
    with pytest.raises(ValueError, match="pool full"):
        timpl.compact_slots(state, [True, True])
    for key in STATE_KEYS:
        assert torch.equal(state[key], before[key]), key
    timpl.compact_slots(state, [False, True])
    assert state["n_chunks"][:, 1].tolist() == [1, 1]
    assert (state["kv_pool"][:, 0, 1] != 0).any()


def test_dense_insert_and_per_slot_decode():
    """Dense twin: ``insert_slot`` and per-slot decode (slot 1 idle) against
    the JAX dense cache's stacked per-slot decode; f32 throughout."""
    jimpl = j_make_cache(_engine(jc, "DENSE", max_seq=512))
    timpl = t_make_cache(_engine(tc, "DENSE", max_seq=512), device="cpu")
    rs = np.random.RandomState(12)
    jstate, tstate = jimpl.init(3, jnp.float32), timpl.init(3, torch.float32)
    for slot, true_len in ((0, 40), (2, 100)):
        q, k, v = _qkv(rs, 1, 256, "float32")
        jsub, tsub = jimpl.init(1, jnp.float32), timpl.init(1, torch.float32)
        for li in range(L):
            lc = {key: val[li] for key, val in jsub.items()}
            _, lc = jimpl.prefill_attend(lc, jnp.asarray(q[li]), jnp.asarray(k[li]),
                                         jnp.asarray(v[li]), jnp.int32(true_len))
            jsub = {key: jsub[key].at[li].set(lc[key]) for key in jsub}
            timpl.prefill_attend(tsub, li, _t(q[li], "float32"), _t(k[li], "float32"),
                                 _t(v[li], "float32"), true_len)
        jstate = jimpl.insert_slot(jstate, jsub, jnp.int32(slot))
        timpl.insert_slot(tstate, tsub, slot)
        _assert_equal(tstate, jstate, ("k", "v"))
    pos = np.array([40, -1, 100])
    for _ in range(4):
        q, k, v = _qkv(rs, 3, 1, "float32")
        for li in range(L):
            jo, _, upd = jimpl.decode_attend({}, jnp.asarray(q[li]), jnp.asarray(k[li]),
                                             jnp.asarray(v[li]), jnp.asarray(pos, jnp.int32),
                                             jstate, jnp.int32(li))
            jstate = dict(jstate, **upd)
            to = timpl.decode_attend(tstate, li, _t(q[li], "float32"), _t(k[li], "float32"),
                                     _t(v[li], "float32"), torch.from_numpy(pos))
            np.testing.assert_allclose(to.numpy()[[0, 2]], np.asarray(jo)[[0, 2]],
                                       rtol=0, atol=1e-5)
        _assert_equal(tstate, jstate, ("k", "v"), slots=[0, 2])
        pos[[0, 2]] += 1
    assert (tstate["k"][:, 1] == 0).all()
