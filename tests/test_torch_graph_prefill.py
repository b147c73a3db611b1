"""The compiled chunked prefill (``runtime/generate.StaticSegment``) on the
CPU: one whole-model segment from static buffers (tokens [B, C], 0-d
``seg_start`` and ``true_len``, the cache with ``n_chunks`` on the device)
to its last-position logits, the program a CUDA graph replays for every
segment on the card, rerun here on the same buffers as a replay would
(``graph=True``; ``chip_smoke.py`` holds the card's capture and replays
against the eager path).

(a) Kernels 3 and 8's plain versions with their counts as device tensors
    (a static loop over the pool's mc chunks, masked past n_chunks) equal,
    bit for bit, the loop over the host count's chunks alone, at n_chunks 0,
    1 and mc - 1, with and without a sliding window, for q8q4, bitmap and
    bitmap-q8; the wrappers give the same bits from host ints and from
    device counts, and clamp counts past the pool as the kernels do.
(b) ``Generator(graph=True)`` with chunked prefill against the eager path
    and the JAX package's chunked ``Generator`` (its kernels in interpret
    mode), for q8q4, bitmap, bitmap-q8, an Opa method (KT_MAG_VT_OPA) and a
    sliding window (300): greedy tokens exact; after prefill the pool's live
    chunks, the scales, the windows, the Opa scores and ``n_chunks``
    bit-equal to the eager path's, and the pool slots past ``n_chunks``
    untouched (zero); a second ``generate`` on the key replays every
    segment.
(c) ``ContinuousBatchingEngine(graph=True)`` with chunked admission,
    interleaved and blocking, against the eager engine and the JAX engine:
    tokens exact.
(h) No host read: the segment program, run under a dispatch mode that fails
    on ``aten._local_scalar_dense`` and ``aten.nonzero``, reads nothing on
    the host.
One JAX run per case, shared by the module's tests (``functools.cache``).
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mustafar_tpu import config as jc
from mustafar_tpu.models.llama import init_params as j_init_params
from mustafar_tpu.runtime.generate import Generator as JGenerator
from mustafar_tpu.runtime.scheduler import ContinuousBatchingEngine as JEngine
from mustafar_tpu_torch import config as tc
from mustafar_tpu_torch.ops import quant_format as tqf
from mustafar_tpu_torch.ops import sparse_format as tsf
from mustafar_tpu_torch.ops.kernels import quant_attention as tqa
from mustafar_tpu_torch.ops.kernels import sparse_attention as tska
from mustafar_tpu_torch.ops.kernels.pack_kernel import prune_quant_pack_kv
from mustafar_tpu_torch.models import llama as tl
from mustafar_tpu_torch.runtime.generate import Generator as TGenerator
from mustafar_tpu_torch.runtime.scheduler import ContinuousBatchingEngine as TEngine
from mustafar_tpu_torch.weights import params_from_jax
from test_torch_graph_decode import _NoHostRead

torch.set_num_threads(1)

PROMPT, NEW = 600, 12          # 3 segments, 2 chunks packed by the last
CASES = {                      # id: (codec, method, sliding window)
    "q8q4": ("q8q4", "KT_MAG_VT_MAG", None),
    "bitmap": ("bitmap", "KT_MAG_VT_MAG", None),
    "bitmap-q8": ("bitmap-q8", "KT_MAG_VT_MAG", None),
    "opa": ("q8q4", "KT_MAG_VT_OPA", None),
    "window": ("q8q4", "KT_MAG_VT_MAG", 300),
}


def _engine(mod, case, **kw):
    codec, method, window = CASES[case]
    model = dataclasses.replace(mod.TINY_LLAMA, head_dim=128, num_heads=4,
                                num_kv_heads=1, hidden_size=256, sliding_window=window)
    return mod.EngineConfig(
        model=model, cache_mode=mod.CacheMode.COMPRESSED,
        prune=mod.PruneConfig(method=getattr(mod.PruneMethod, method),
                              k_sparsity=0.7, v_sparsity=0.7),
        max_seq_len=1024, prefill_bucket=256, chunk_size=256, codec=codec,
        chunked_prefill=True, **kw)


@functools.cache
def _params(seed=0):
    jp = j_init_params(_engine(jc, "q8q4").model, jax.random.PRNGKey(seed),
                       dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _prompt():
    return np.random.RandomState(0).randint(0, 512, size=(2, PROMPT))


@functools.cache
def _jax_tokens(case):
    jp, _ = _params()
    gen = JGenerator(_engine(jc, case), jp, dtype=jnp.float32)
    gen.cache_impl.use_pallas = True
    return np.stack([np.asarray(r) for r in gen.generate(_prompt(), NEW)])


# -- (a) kernels 3 and 8: device counts, a static loop --------------------------

MC, BH, T, HQ = 3, 2, 256, 4           # B = 1, Hkv = 2, G = 2


@functools.cache
def _seg_state(codec):
    """q_seg [1, T, HQ, 128] bf16 and a pool (L=1, MC chunks, B*Hkv = 2) of
    real packed chunks of ``codec``, with its scales (None at bitmap)."""
    g = torch.Generator().manual_seed(11)
    x = (torch.randn((MC, 2, BH, 256, 128), generator=g) * 0.5).to(torch.bfloat16)
    q = torch.randn((1, T, HQ, 128), generator=g).to(torch.bfloat16)
    if codec == "q8q4":
        qc = tqf.QuantCodec(256, 128, 8, 4)
        pool = torch.empty((1, MC, BH, qc.stream_rows, 128), dtype=torch.int16)
        scales = torch.empty((1, MC, BH, 2, 128), dtype=torch.bfloat16)
        (kr, ks), (vr, vs) = prune_quant_pack_kv(x[:, 0], x[:, 1], 40, 40, 8, 4)
        pool[0] = torch.cat([kr, vr], dim=-2)
        scales[0] = torch.stack([ks, vs], dim=-2)
        return q, pool, scales, qc
    fmt = tsf.ChunkFormat(256, 128, 40, qbits=8 if codec == "bitmap-q8" else 16)
    if fmt.qbits == 8:
        rows, sc = tsf.prune_and_encode_stream_q8(x, fmt)
        scales = sc.to(torch.bfloat16).transpose(1, 2)[None].contiguous()   # [1, MC, BH, 2, D]
    else:
        rows, scales = tsf.prune_and_encode_stream(x, fmt), None
    return q, torch.cat([rows[:, 0], rows[:, 1]], dim=-2)[None], scales, fmt


def _plain(codec, nc, seg_start, window):
    q, pool, scales, fmt = _seg_state(codec)
    if codec == "q8q4":
        return tqa.fused_q_segment_attention_plain(q, pool, scales, nc, 0, fmt, seg_start,
                                                   window)
    return tska.fused_sparse_segment_attention_plain(q, pool, nc, 0, fmt, fmt, scales,
                                                     seg_start, window)


def _wrapper(codec, nc, seg_start, window):
    q, pool, scales, fmt = _seg_state(codec)
    if codec == "q8q4":
        return tqa.fused_q_segment_attention(q, pool, scales, nc, seg_start, 0, fmt,
                                             window=window)
    return tska.fused_sparse_segment_attention(q, pool, nc, seg_start, 0, fmt, fmt,
                                               kv_scales=scales, window=window)


def _host_count_loop(codec, nc, seg_start, window):
    """The segment program at a host count: one online-softmax step for each
    of the first ``nc`` chunks alone (the loop the plain versions ran before
    their counts moved to the device), through the same chunk steps."""
    q, pool, scales, fmt = _seg_state(codec)
    step = (tqa._q_chunk_step(pool, scales, 0, fmt) if codec == "q8q4"
            else tska._sp_chunk_step(pool, scales, 0, fmt, fmt))
    B, _, Hq, D = q.shape
    G = Hq // (BH // B)
    f32 = torch.float32
    qf32 = (q.to(f32).reshape(B, T, BH // B, G, D).permute(0, 2, 1, 3, 4)
            .reshape(BH, T * G, D))
    m = torch.full((BH, T * G, 1), tqa.NEG_INF)
    l, acc = torch.zeros((BH, T * G, 1)), torch.zeros((BH, T * G, D))
    lows = tqa.segment_row_lows(T, G, seg_start, window)
    for ci in range(nc):
        sc, vc, vs = step(qf32, ci)
        if lows is not None:
            cols = ci * 256 + torch.arange(256)
            sc = sc.masked_fill(cols[None, :] <= lows[:, None], tqa.NEG_INF)
        m, l, acc = tqa._softmax_step(m, l, acc, sc, vc, vs)

    def unfold(x):
        return (x.reshape(B, BH // B, T, G, x.shape[-1]).permute(0, 2, 1, 3, 4)
                .reshape(B, T, Hq, x.shape[-1]))
    return unfold(acc), unfold(m), unfold(l)


@pytest.mark.parametrize("codec", ["q8q4", "bitmap", "bitmap-q8"])
def test_device_count_segment_plain_is_the_host_count_loop(codec):
    i32 = lambda n: torch.full((1,), n, dtype=torch.int32)
    # (n_chunks, seg_start, window): nothing packed; one chunk; mc - 1; the
    # window's edge inside chunk 0 (rows past token 43 see no pool column);
    # chunk 0 dead for every row and the edge through chunk 1
    for nc, start, window in ((0, 0, None), (1, 256, None), (MC - 1, 512, None),
                              (1, 512, 300), (MC - 1, 768, 500)):
        want = _host_count_loop(codec, nc, start, window)
        for got in (_plain(codec, i32(nc), i32(start), window),
                    _plain(codec, nc, start, window),
                    _wrapper(codec, i32(nc), i32(start), window),
                    _wrapper(codec, nc, start, window)):
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (codec, nc, window)
        if nc == 0:
            assert (want[1] == -1e30).all() and not want[0].any() and not want[2].any()
    # counts past the pool are clamped into it, as the kernels clamp them
    over = _wrapper(codec, i32(MC + 5), i32(MC * 256), None)
    assert all(torch.equal(a, b) for a, b in zip(over, _host_count_loop(codec, MC, MC * 256,
                                                                          None)))
    with pytest.raises(ValueError):
        _wrapper(codec, torch.full((1,), 1, dtype=torch.int64), i32(256), None)


# -- (b) the Generator --------------------------------------------------------------

def _gen(case, graph):
    return TGenerator(_engine(tc, case), _params()[1], dtype=torch.float32, device="cpu",
                      graph=graph)


@functools.cache
def _prefilled(case, graph):
    """The tokens of one ``generate`` and the cache state right after its
    chunked prefill (the decode loop then writes the windows): with
    ``graph`` the static segment program's, else the eager
    ``llama.prefill_chunked``'s on a new cache."""
    gen = _gen(case, graph)
    seen = {}
    if graph:
        gen.generate(_prompt()[:, :40], 2)                    # builds the key's state
        (static,) = gen._static.values()
        prefill = static.segment.prefill

        def recorded(toks, true_len):
            logits = prefill(toks, true_len)
            seen.update({k: (v.clone() if torch.is_tensor(v) else v)
                         for k, v in static.cache.items()})
            return logits

        static.segment.prefill = recorded
    else:
        toks = torch.zeros((2, 768), dtype=torch.int64)
        toks[:, :PROMPT] = torch.from_numpy(_prompt())
        with torch.inference_mode():
            _, seen = tl.prefill_chunked(gen.cfg, gen.params, toks,
                                         gen.cache_impl.init(2, torch.float32),
                                         gen.cache_impl, PROMPT)
    return gen, np.stack(gen.generate(_prompt(), NEW)), seen


@pytest.mark.parametrize("case", list(CASES))
def test_static_chunked_prefill_matches_eager_and_jax(case):
    gen, got, state = _prefilled(case, True)
    _, want, eager_state = _prefilled(case, False)
    assert gen.last_path == "static" and gen.last_prefill_replays == 3
    assert gen.last_replays == NEW - 1
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _jax_tokens(case))
    nc = state["nc_host"]
    assert nc == 2 and (state["n_chunks"] == nc).all()
    assert state.keys() == eager_state.keys()
    for key, val in eager_state.items():
        if torch.is_tensor(val):
            assert torch.equal(state[key], val), key
        else:
            assert state[key] == val, key
    for key in ("kv_pool", "kv_scales"):
        if key in state:
            assert state[key][:, nc:].eq(0).all(), key         # slots past n_chunks
            assert state[key][:, :nc].ne(0).any(), key
    # a second generate on the key: every segment a replay, the same tokens
    np.testing.assert_array_equal(np.stack(gen.generate(_prompt(), NEW)), want)
    assert gen.last_prefill_replays == 3 and len(gen._static) == 1


# -- (c) the engine's admission ------------------------------------------------------

ENGINE_MIX = [(600, 8), (280, 12), (100, 5)]


@functools.cache
def _engine_requests():
    rs = np.random.RandomState(3)
    return [(rs.randint(0, 512, size=n), m) for n, m in ENGINE_MIX]


@functools.cache
def _jax_engine_tokens():
    jp, _ = _params()
    jcb = JEngine(_engine(jc, "q8q4", batch_size=2), jp, dtype=jnp.float32,
                  use_native=False)
    jcb.impl.use_pallas = jcb.prefill_impl.use_pallas = True
    uids = [jcb.submit(p, m) for p, m in _engine_requests()]
    res = jcb.run()
    return [np.asarray(res[u]) for u in uids]


@pytest.mark.parametrize("interleave", [True, False], ids=["interleaved", "blocking"])
def test_graphed_admission_matches_eager_and_jax(interleave):
    outs = {}
    for graph in (False, True):
        cb = TEngine(_engine(tc, "q8q4", batch_size=2), _params()[1], dtype=torch.float32,
                     device="cpu", graph=graph, interleave=interleave)
        uids = [cb.submit(p, m) for p, m in _engine_requests()]
        res = cb.run()
        outs[graph] = [np.asarray(res[u]) for u in uids]
        assert cb.segments == 3 + 2 + 1
        # one static segment program for every admission, on both paths: the
        # eager engine reruns it (and reports no replays)
        assert cb._segment.graph.replays == cb.segments - 1
        assert cb.segment_replays == (cb.segments - 1 if graph else 0)
    for eager, static, jax_ in zip(outs[False], outs[True], _jax_engine_tokens()):
        np.testing.assert_array_equal(static, eager)
        np.testing.assert_array_equal(static, jax_)


# -- (h) no host read ------------------------------------------------------------------

@pytest.mark.parametrize("case", ["opa", "bitmap", "window"])
def test_segment_program_reads_nothing_on_the_host(case):
    gen = _gen(case, True)
    gen.generate(_prompt(), 2)
    (static,) = gen._static.values()
    with torch.inference_mode(), _NoHostRead() as mode:
        static.segment.seg_start.fill_(256)
        logits = static.segment.graph.fn()
    assert not mode.hits and logits.shape[:2] == (2, 1)
