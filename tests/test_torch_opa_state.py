"""Port parity, the compressed cache's steps under output-aware (Opa)
pruning that the engine and chunked prefill take
(``test_torch_opa_engine.py`` and ``test_torch_opa_chunked.py`` hold the
end-to-end runs).

(c) After every segment of a chunked prefill of 543 tokens (three segments:
    the second packs the window's oldest chunk by the streamed scores, the
    last is partial) the state equals the JAX package's: windows bit for
    bit, the score buffers within 1e-5 relative, the pool bit for bit given
    the same scores (the port's pack is fed the scores JAX packed with,
    which ``jax.debug.callback`` hands out of its jitted segment: float
    order alone could flip a near-tie of the two packages' own scores); the
    scores the port packed with agree with JAX's within 1e-5.
(s) Two requests prefilled alone (280 tokens: no chunk; 543: one chunk
    packed by its prefill scores) and inserted into slots 0 and 2 of a
    3-slot cache, slot 1 idle; 9 per-slot decode steps (kernels 2 and 7 with
    their window probabilities, JAX's in interpret mode), each slot's
    scores added at its own live columns; ``compact_slots`` of slot 2 after
    the first step and of slot 0 after the eighth.  After each step the
    active slots' windows equal JAX's and their scores agree within 1e-5
    relative; each compaction, fed JAX's scores, leaves pools, windows and
    scores bit for bit JAX's; the idle slot is never written or scored.
Both methods, KT_OPA_VT_MAG and KT_MAG_VT_OPA, at the codecs q8q4 and
bitmap; f32 (the JAX package's CPU runtime has no bf16 x bf16 -> f32 dot
for its prefill scores and the window and self partials).  Tiny geometry:
head_dim 128, 4 query heads over 2 kv heads, 2 layers, chunk 256, residual
32, sparsity 0.7.
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

torch.set_num_threads(1)

L, C, TRUE_LEN = 2, 256, 543
METHODS = ("KT_OPA_VT_MAG", "KT_MAG_VT_OPA")


def _engine(mod, method, codec):
    model = dataclasses.replace(mod.TINY_LLAMA, head_dim=128, num_heads=4,
                                num_kv_heads=2, hidden_size=256, num_layers=L)
    return mod.EngineConfig(
        model=model, cache_mode=mod.CacheMode.COMPRESSED,
        prune=mod.PruneConfig(method=getattr(mod.PruneMethod, method), k_sparsity=0.7,
                              v_sparsity=0.7),
        max_seq_len=1024, prefill_bucket=256, chunk_size=C, codec=codec)


def _np(x):
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _tnp(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _assert_equal(tstate, jstate, keys, slots=None, rtol=None, tag=""):
    for key in keys:
        t, j = _tnp(tstate[key]), _np(jstate[key])
        if slots is not None:                   # batch axis: 2 of the pool, 1 else
            axis = 2 if key.startswith("kv_") else 1
            t, j = t.take(slots, axis), j.take(slots, axis)
        if rtol is None:
            np.testing.assert_array_equal(t, j, err_msg=f"{tag} {key}")
        else:
            np.testing.assert_allclose(t, j, rtol=rtol, atol=1e-7, err_msg=f"{tag} {key}")


def _j_segment(jimpl, captured):
    """One segment over every layer through the JAX package's stacked
    protocol, then ``finalize_segment``; jitted.  The scores each layer's
    segment packs its chunk with (staged in every segment, applied when it
    packs) are appended to ``captured`` as (layer, key, array)."""
    pools = [key for key in ("kv_pool", "kv_scales") if key in jimpl.decode_stacked_ro]
    rw = ("k_win", "v_win") + jimpl.score_keys
    pack = jimpl._pack_rows_scales
    layer = [0]

    def spy(k_chunk, v_chunk, k_score=None, v_score=None):
        for key, x in (("k_score", k_score), ("v_score", v_score)):
            if x is not None:
                jax.debug.callback(lambda a, tag=(layer[0], key): captured.append(
                    (*tag, np.asarray(a))), x, ordered=True)
        return pack(k_chunk, v_chunk, k_score, v_score)

    jimpl._pack_rows_scales = spy

    def seg(cache, qs, ks, vs, seg_start, true_len):
        full = {key: cache[key] for key in (*pools, *rw)}
        lcs = []
        for li in range(L):
            layer[0] = li
            _, lc, upd = jimpl.segment_attend(
                {"n_chunks": cache["n_chunks"][li]}, qs[li], ks[li], vs[li],
                seg_start, true_len, full, jnp.int32(li))
            full = dict(full, **upd)
            lcs.append(lc)
        new = {key: jnp.stack([lc[key] for lc in lcs]) for key in lcs[0]}
        new.update({key: full[key] for key in rw}, **{key: cache[key] for key in pools})
        return jimpl.finalize_segment(cache, new)
    return jax.jit(seg)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("codec", ["q8q4", "bitmap"])
def test_opa_segments_state_matches_jax(method, codec):
    jimpl = j_make_cache(_engine(jc, method, codec))
    jimpl.use_pallas = True
    timpl = t_make_cache(_engine(tc, method, codec), device="cpu")
    keys = jimpl.score_keys
    assert keys == timpl.score_keys and len(keys) == 1
    B = 2
    jstate, tstate = jimpl.init(B, jnp.float32), timpl.init(B, torch.float32)
    captured, fed, packed_with = [], {}, []
    jseg = _j_segment(jimpl, captured)
    append = timpl._append

    def fed_append(state, at, k_chunk, v_chunk, k_score=None, v_score=None):
        packed_with.append((at[0], k_score, v_score))
        return append(state, at, k_chunk, v_chunk, *(
            None if s is None else torch.from_numpy(fed[(at[0], key)])
            for key, s in (("k_score", k_score), ("v_score", v_score))))

    timpl._append = fed_append
    rs = np.random.RandomState(18)
    packs = 0
    for s in range(-(-TRUE_LEN // C)):
        q = rs.randn(L, B, C, 4, 128).astype(np.float32) * 0.5
        k, v = (rs.randn(L, B, C, 2, 128).astype(np.float32) * 0.5 for _ in range(2))
        captured.clear()
        jstate = jseg(jstate, *(jnp.asarray(x) for x in (q, k, v)), jnp.int32(s * C),
                      jnp.int32(TRUE_LEN))
        jax.effects_barrier()
        fed.clear()
        fed.update({(li, key): a for li, key, a in captured})
        assert len(fed) == L
        packed_with.clear()
        for li in range(L):
            timpl.segment_attend(tstate, li, *(torch.from_numpy(x[li]) for x in (q, k, v)),
                                 s * C, TRUE_LEN)
        timpl.finalize_segment(tstate, s * C, TRUE_LEN)
        _assert_equal(tstate, jstate, ("k_win", "v_win", "n_chunks",
                                       *jimpl.decode_stacked_ro), tag=f"segment {s}")
        _assert_equal(tstate, jstate, keys, rtol=1e-5, tag=f"segment {s}")
        # the port's own packing scores against JAX's
        for li, ks, vs in packed_with:
            for key, sc in (("k_score", ks), ("v_score", vs)):
                if sc is not None:
                    np.testing.assert_allclose(sc.numpy(), fed[(li, key)], rtol=1e-5,
                                               atol=1e-7, err_msg=f"segment {s} pack")
        packs += len(packed_with)
    # every segment stages its pack, as the JAX package's does (its spy saw
    # L packs a segment too); segment 1's is the one written (nc_host 1)
    assert packs == L * -(-TRUE_LEN // C) and tstate["nc_host"] == 1
    wl = TRUE_LEN - C
    sc = tstate[keys[0]]
    assert (sc[:, :, :, :wl] > 0).any(dim=-1).all() and (sc[:, :, :, wl:] == 0).all()


def _j_decode_per_slot(jimpl):
    """One per-slot decode step over every layer through the JAX package's
    stacked protocol (windows and score buffers carried); jitted."""
    pools = [key for key in ("kv_pool", "kv_scales") if key in jimpl.decode_stacked_ro]
    rw = ("k_win", "v_win") + jimpl.score_keys

    def step(cache, qs, ks, vs, pos):
        full = {key: cache[key] for key in (*pools, *rw)}
        for li in range(L):
            _, _, upd = jimpl.decode_attend({"n_chunks": cache["n_chunks"][li]}, qs[li],
                                            ks[li], vs[li], pos, full, jnp.int32(li))
            full = dict(full, **upd)
        return dict(cache, **{key: full[key] for key in rw})
    return jax.jit(step)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("codec", ["q8q4", "bitmap"])
def test_opa_per_slot_decode_and_compact_match_jax(method, codec):
    jimpl = j_make_cache(_engine(jc, method, codec))
    jimpl.use_pallas = True
    timpl = t_make_cache(_engine(tc, method, codec), device="cpu")
    keys = timpl.score_keys
    state_keys = ("kv_pool", *(("kv_scales",) if codec == "q8q4" else ()), "k_win",
                  "v_win", "n_chunks")
    rs = np.random.RandomState(21)
    jstate, tstate = jimpl.init(3, jnp.float32), timpl.init(3, torch.float32)
    jinsert, jprefill = jax.jit(jimpl.insert_slot), jax.jit(jimpl.prefill_attend)
    for slot, true_len, T in ((0, 280, 512), (2, TRUE_LEN, 768)):
        q = rs.randn(L, 1, T, 4, 128).astype(np.float32) * 0.5
        k, v = (rs.randn(L, 1, T, 2, 128).astype(np.float32) * 0.5 for _ in range(2))
        jsub, tsub = jimpl.init(1, jnp.float32), timpl.init(1, torch.float32)
        for li in range(L):
            lc = {key: val[li] for key, val in jsub.items()}
            _, lc = jprefill(lc, *(jnp.asarray(x[li]) for x in (q, k, v)),
                             jnp.int32(true_len))
            jsub = {key: jsub[key].at[li].set(lc[key]) for key in jsub}
            timpl.prefill_attend(tsub, li, *(torch.from_numpy(x[li]) for x in (q, k, v)),
                                 true_len)
        jstate = jinsert(jstate, jsub, jnp.int32(slot))
        timpl.insert_slot(tstate, tsub, slot)
        _assert_equal(tstate, jstate, state_keys + keys, tag=f"insert {slot}")
    jdecode, jcompact = _j_decode_per_slot(jimpl), jax.jit(jimpl.compact_slots)
    pos = np.array([280, -1, TRUE_LEN])
    idle = {key: tstate[key][:, 1].clone() for key in ("k_win",) + keys}
    compactions = []
    for step in range(9):
        q = rs.randn(L, 3, 1, 4, 128).astype(np.float32) * 0.5
        k, v = (rs.randn(L, 3, 1, 2, 128).astype(np.float32) * 0.5 for _ in range(2))
        jstate = jdecode(jstate, *(jnp.asarray(x) for x in (q, k, v)),
                         jnp.asarray(pos, jnp.int32))
        for li in range(L):
            timpl.decode_attend(tstate, li, *(torch.from_numpy(x[li]) for x in (q, k, v)),
                                torch.from_numpy(pos))
        tag = f"step {step}"
        _assert_equal(tstate, jstate, ("k_win", "v_win", "n_chunks"), slots=[0, 2], tag=tag)
        _assert_equal(tstate, jstate, keys, slots=[0, 2], rtol=1e-5, tag=tag)
        pos[[0, 2]] += 1
        do = [bool(timpl.needs_compact(int(p))) if p >= 0 else False for p in pos]
        if any(do):
            compactions.append((step, do))
            for key in keys:                            # JAX's own scores on both sides
                tstate[key][:, [0, 2]] = torch.from_numpy(np.array(jstate[key])[:, [0, 2]])
            jstate = jcompact(jstate, jnp.asarray(do))
            timpl.compact_slots(tstate, do)
            _assert_equal(tstate, jstate, state_keys + keys, slots=[0, 2], tag=tag)
    assert compactions == [(0, [False, False, True]), (7, [True, False, False])]
    assert tstate["n_chunks"][:, [0, 2]].tolist() == [[1, 2]] * L
    for key, val in idle.items():                       # the idle slot: never touched
        assert torch.equal(tstate[key][:, 1], val), key
    sc = tstate[keys[0]]
    for slot, wl in ((0, 33), (2, 40)):          # each slot's live columns scored
        assert (sc[:, slot, :, :wl] > 0).any(dim=-1).all() and (sc[:, slot, :, wl:] == 0).all()
