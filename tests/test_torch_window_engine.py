"""Port parity, Mistral's sliding window through the continuous-batching
engine and chunked prefill over the compressed cache, against the JAX
package's (its kernels in Pallas interpret mode), in float32.

(e) The ``ContinuousBatchingEngine`` (chunked prefill, interleaved
    admission, two slots) on a windowed model at every codec:
    window 320 on ``tests/test_scheduler.py``'s own case (prompts 280 and
    400, 20 new tokens: a decode that crosses a compaction, a prompt whose
    packed chunk lies partly below the window), and the Opa method
    KT_MAG_VT_OPA (window probabilities, a compaction and a streamed chunk
    by score) there at q8q4 and at window 288 at bitmap, on a mix whose
    700-token prompt runs a segment over a chunk the window cuts (rows with
    no live pool column) and whose third request reuses a slot.  Tokens are checked by
    teacher forcing (``test_torch_scheduler.py``): each of the port's
    picks is JAX's token or ties with it within ``TIE_TOL``, and the free
    streams part only after such a near-tie.
(g) The chunked ``Generator`` (B=2, prompt 700) at q8q4 (window 320) and
    bitmap (288), held the same way.
(c) The cache's steps on the same inputs, port against JAX: every segment
    of a chunked prefill of 700 tokens at window 288 (segment 3's rows see
    chunk 0 past their own edge, some none of it; the window and self
    partials masked) with the state bit for bit after each (int16 rows,
    bf16 scales, windows, counts) and the outputs within two bf16 ulps; the
    streamed Opa scores of that prefill within 1e-5 relative; and per-slot
    decode at window 320 with ``compact_slots`` (an idle slot, a slot whose
    chunk lies partly below its window), the state after the compaction bit
    for bit.

Tiny geometry: head_dim 128, 4 query heads over 1 kv head (2 kv heads in
(c)), 2 layers, chunk 256, residual 32.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mustafar_tpu import config as jc
from mustafar_tpu.cache import make_cache as j_make_cache
from mustafar_tpu.models.llama import init_params as j_init_params
from mustafar_tpu.runtime.generate import Generator as JGenerator
from mustafar_tpu.runtime.scheduler import ContinuousBatchingEngine as JEngine
from mustafar_tpu_torch import config as tc
from mustafar_tpu_torch.cache import make_cache as t_make_cache
from mustafar_tpu_torch.runtime.generate import Generator as TGenerator
from mustafar_tpu_torch.runtime.scheduler import ContinuousBatchingEngine as TEngine
from mustafar_tpu_torch.weights import params_from_jax
from tests.test_torch_opa_chunked import _teacher_forced
from tests.test_torch_opa_state import _assert_equal as _assert_close
from tests.test_torch_opa_state import _j_segment as _j_opa_segment
from tests.test_torch_scheduler import TIE_TOL, _check_streams, _Forced
from tests.test_torch_segment import (HKV, HQ, L, _assert_equal, _j_decode_per_slot,
                                      _j_segment, _np, _qkv, _state_keys, _t, _tnp)

torch.set_num_threads(1)

CODECS = ("q8", "q8q4", "q4q4", "bitmap", "bitmap-q8")
# window -> (the prompts' RandomState seed, [(prompt length, new tokens)])
MIXES = {320: (6, [(280, 20), (400, 20)]),
         288: (4, [(280, 12), (700, 10), (100, 6)])}


def _engine(mod, codec, window, method="KT_MAG_VT_MAG", Hkv=1, **kw):
    model = dataclasses.replace(mod.TINY_LLAMA, head_dim=128, num_heads=4,
                                num_kv_heads=Hkv, hidden_size=256, sliding_window=window)
    return mod.EngineConfig(
        model=model, cache_mode=mod.CacheMode.COMPRESSED,
        prune=mod.PruneConfig(method=getattr(mod.PruneMethod, method), k_sparsity=0.5,
                              v_sparsity=0.5),
        max_seq_len=1024, prefill_bucket=256, chunk_size=256, codec=codec,
        chunked_prefill=True, **kw)


@pytest.fixture(scope="module")
def params():
    """The tiny model's weights for both packages, made once for the module
    (the window does not change the weights)."""
    jp = j_init_params(_engine(jc, "q8q4", 320).model, jax.random.PRNGKey(3),
                       dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


ENGINE_CASES = ([pytest.param(c, 320, "KT_MAG_VT_MAG", id=f"{c}-w320") for c in CODECS]
                + [pytest.param("q8q4", 320, "KT_MAG_VT_OPA", id="q8q4-w320-opa"),
                   pytest.param("bitmap", 288, "KT_MAG_VT_OPA", id="bitmap-w288-opa")])


@pytest.mark.parametrize("codec,window,method", ENGINE_CASES)
def test_windowed_engine_matches_jax(codec, window, method, params):
    jeng = _engine(jc, codec, window, method, batch_size=2)
    teng = _engine(tc, codec, window, method, batch_size=2)
    jp, tp = params
    seed, mix = MIXES[window]
    rs = np.random.RandomState(seed)
    reqs = [(rs.randint(0, 512, size=n), m) for n, m in mix]
    jcb = JEngine(jeng, jp, dtype=jnp.float32, use_native=False)
    jcb.impl.use_pallas = jcb.prefill_impl.use_pallas = True
    juids = [jcb.submit(p, m) for p, m in reqs]
    want = jcb.run()
    tcb = TEngine(teng, tp, dtype=torch.float32, device="cpu")
    tuids = [tcb.submit(p, m) for p, m in reqs]
    got = tcb.run()
    assert juids == tuids and sorted(got) == sorted(want)
    assert tcb.interleave and not tcb.busy()
    assert tcb.segments == sum(-(-len(p) // 256) for p, _ in reqs)
    assert [len(got[u]) for u in tuids] == [m for _, m in mix]
    forced = _Forced(teng, tp, dtype=torch.float32, device="cpu", streams=want)
    for p, m in reqs:
        forced.submit(p, m)
    assert forced.run().keys() == want.keys()
    if method == "KT_MAG_VT_OPA":
        assert forced.cache["v_score"].abs().sum() > 0
    _check_streams(want, got, forced.logits, TIE_TOL["COMPRESSED"])


@pytest.mark.parametrize("codec,window", [("q8q4", 320), ("bitmap", 288)])
def test_windowed_chunked_generator_matches_jax(codec, window, params):
    """B=2, prompt 700 (3 segments; prefill leaves 2 chunks, chunk 0 below
    the window from the first step on), 16 new tokens."""
    jeng, teng = _engine(jc, codec, window), _engine(tc, codec, window)
    jp, tp = params
    prompt = np.random.RandomState(5).randint(0, 512, size=(2, 700))
    jgen = JGenerator(jeng, jp, dtype=jnp.float32)
    jgen.cache_impl.use_pallas = True
    want = np.stack([np.asarray(r) for r in jgen.generate(prompt, 16)])
    tgen = TGenerator(teng, tp, dtype=torch.float32, device="cpu")
    got = np.stack(tgen.generate(prompt, 16))
    assert tgen.last_cache["nc_host"] == 2
    logits, compacted = _teacher_forced(tgen, prompt, want)
    assert compacted == []
    _check_streams({0: want[0], 1: want[1]}, {0: got[0], 1: got[1]},
                   {0: list(logits[0]), 1: list(logits[1])}, TIE_TOL["COMPRESSED"])


# -- the cache's steps ----------------------------------------------------------

def _state_engine(mod, codec, window, method="KT_MAG_VT_MAG"):
    model = dataclasses.replace(mod.TINY_LLAMA, head_dim=128, num_heads=HQ,
                                num_kv_heads=HKV, hidden_size=256, sliding_window=window)
    return mod.EngineConfig(
        model=model, cache_mode=mod.CacheMode.COMPRESSED,
        prune=mod.PruneConfig(method=getattr(mod.PruneMethod, method), k_sparsity=0.7,
                              v_sparsity=0.7),
        max_seq_len=1024, prefill_bucket=256, chunk_size=256, codec=codec)


@pytest.mark.parametrize("codec", ["q8q4", "bitmap"])
def test_windowed_segments_state_bit_exact(codec):
    """Every segment of a 700-token chunked prefill at window 288, B=2:
    segment 3 attends chunk 0, whose columns its row t sees past 224 + t
    (none from t = 31 on), a window and itself, each masked by the
    window."""
    window, true_len, B, C = 288, 700, 2, 256
    jimpl = j_make_cache(_state_engine(jc, codec, window))
    jimpl.use_pallas = True
    timpl = t_make_cache(_state_engine(tc, codec, window), device="cpu")
    jstate, tstate = jimpl.init(B, jnp.float32), timpl.init(B, torch.float32)
    rs = np.random.RandomState(true_len)
    jseg = _j_segment(jimpl)
    keys = _state_keys(codec)
    for s in range(-(-true_len // C)):
        q, k, v = _qkv(rs, B, C, "float32")
        jout, jstate = jseg(jstate, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.int32(s * C), jnp.int32(true_len))
        touts = [timpl.segment_attend(tstate, li, _t(q[li], "float32"), _t(k[li], "float32"),
                                      _t(v[li], "float32"), s * C, true_len)
                 for li in range(L)]
        timpl.finalize_segment(tstate, s * C, true_len)
        _assert_equal(tstate, jstate, keys)
        valid = min(true_len - s * C, C)
        jo = _np(jout)[:, :, :valid]
        to = np.stack([_tnp(o) for o in touts])[:, :, :valid]
        np.testing.assert_allclose(to, jo, rtol=0, atol=2 ** -7 * np.abs(jo).max(),
                                   err_msg=f"segment {s}")
    assert tstate["nc_host"] == 2


def test_windowed_opa_segments_state_matches_jax():
    """The streamed Opa scores (KT_MAG_VT_OPA, q8q4) of the same prefill at
    window 288: each key scored only by the queries whose window holds it.
    As ``test_torch_opa_state.py`` holds them: the score buffers within
    1e-5 relative after every segment, the windows, counts and pool bit for
    bit given the scores JAX packed with (f32 sums in another order could
    flip a near-tie of the two packages' own scores)."""
    window, true_len, B, C = 288, 700, 2, 256
    jimpl = j_make_cache(_state_engine(jc, "q8q4", window, "KT_MAG_VT_OPA"))
    jimpl.use_pallas = True
    timpl = t_make_cache(_state_engine(tc, "q8q4", window, "KT_MAG_VT_OPA"), device="cpu")
    jstate, tstate = jimpl.init(B, jnp.float32), timpl.init(B, torch.float32)
    captured, fed = [], {}
    jseg = _j_opa_segment(jimpl, captured)
    append = timpl._append

    def fed_append(state, at, k_chunk, v_chunk, k_score=None, v_score=None):
        np.testing.assert_allclose(v_score.numpy(), fed[(at[0], "v_score")], rtol=1e-5,
                                   atol=1e-7)
        return append(state, at, k_chunk, v_chunk, None,
                      torch.from_numpy(fed[(at[0], "v_score")]))

    timpl._append = fed_append
    rs = np.random.RandomState(true_len)
    for s in range(-(-true_len // C)):
        q, k, v = _qkv(rs, B, C, "float32")
        captured.clear()
        jstate = jseg(jstate, *(jnp.asarray(x) for x in (q, k, v)), jnp.int32(s * C),
                      jnp.int32(true_len))
        jax.effects_barrier()
        fed.clear()
        fed.update({(li, key): a for li, key, a in captured})
        for li in range(L):
            timpl.segment_attend(tstate, li, *(torch.from_numpy(x[li]) for x in (q, k, v)),
                                 s * C, true_len)
        timpl.finalize_segment(tstate, s * C, true_len)
        _assert_close(tstate, jstate, ("k_win", "v_win", "n_chunks", "kv_pool", "kv_scales"),
                      tag=f"segment {s}")
        _assert_close(tstate, jstate, ("v_score",), rtol=1e-5, tag=f"segment {s}")
    assert tstate["nc_host"] == 2


@pytest.mark.parametrize("codec", ["q8q4"])
def test_windowed_per_slot_decode_and_compact_slots(codec):
    """Two requests prefilled alone (280 tokens: no chunk; 530: one chunk,
    which the window cuts at position 530 - 320 = 210) inserted into slots 0
    and 2 of three, slot 1 idle; per-slot decode at window 320 until slot
    0's window fills (8 steps), ``compact_slots`` of slot 0, then 4 steps
    more: outputs within one bf16 ulp of JAX's, the state after the
    compaction bit for bit."""
    window = 320
    keys = _state_keys(codec)
    jimpl = j_make_cache(_state_engine(jc, codec, window))
    jimpl.use_pallas = True
    timpl = t_make_cache(_state_engine(tc, codec, window), device="cpu")
    rs = np.random.RandomState(11)
    jstate, tstate = jimpl.init(3, jnp.bfloat16), timpl.init(3, torch.bfloat16)
    jinsert = jax.jit(jimpl.insert_slot)
    prefill = jax.jit(jimpl.prefill_attend)
    for slot, true_len, T in ((0, 280, 512), (2, 530, 768)):
        q, k, v = _qkv(rs, 1, T, "bfloat16")
        jsub, tsub = jimpl.init(1, jnp.bfloat16), timpl.init(1, torch.bfloat16)
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
    jdecode = _j_decode_per_slot(jimpl)
    jcompact = jax.jit(jimpl.compact_slots)
    pos = np.array([280, -1, 530])
    compacted = []
    for step in range(12):
        q, k, v = _qkv(rs, 3, 1, "bfloat16")
        jout, jstate = jdecode(jstate, jnp.asarray(q, jnp.bfloat16),
                               jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
                               jnp.asarray(pos, jnp.int32))
        touts = [timpl.decode_attend(tstate, li, _t(q[li], "bfloat16"), _t(k[li], "bfloat16"),
                                     _t(v[li], "bfloat16"), torch.from_numpy(pos))
                 for li in range(L)]
        jo = _np(jout)[:, [0, 2]]
        to = np.stack([_tnp(o) for o in touts])[:, [0, 2]]
        np.testing.assert_allclose(to, jo, rtol=0, atol=2 ** -8 * np.abs(jo).max(),
                                   err_msg=f"step {step}")
        _assert_equal(tstate, jstate, ("k_win", "v_win", "n_chunks"), slots=[0, 2])
        pos[[0, 2]] += 1
        do = [bool(timpl.needs_compact(int(p))) if p >= 0 else False for p in pos]
        if any(do):
            jstate = jcompact(jstate, jnp.asarray(do))
            timpl.compact_slots(tstate, do)
            _assert_equal(tstate, jstate, keys, slots=[0, 2])
            compacted.append(step)
    assert compacted == [7] and tstate["n_chunks"][:, [0, 2]].tolist() == [[1, 1], [1, 1]]
