"""The compiled decode (``runtime/graphs.py``) on the CPU: the static decode
step that a CUDA graph replays on the card, rerun here on the same buffers
after their in-place updates, as a replay would (``graph=True``; the CPU
has no graphs, and the card's capture and replay are held against the eager
loop by ``chip_smoke.py``).

(t) Tokens: ``Generator(graph=True)`` equals the eager loop and the JAX
    package's ``Generator`` across one compaction (prompt 300, 260 new
    tokens, max_seq_len 1024: the window fills after step 244), for the
    compressed cache at q8q4, bitmap and bitmap-q8, the dense cache plain
    and with ``use_pallas`` (kernel 4's plain version) and the masked
    cache; a second ``generate`` on the same key (q8q4) reuses the state in
    place and gives the same tokens.  One JAX run per case, through the JAX kernel
    where the port's runs one (the compressed cache, the dense cache with
    ``use_pallas``).
(e) The engine: the static per-slot tick equals the eager tick and the JAX
    engine on a mixed stream that crosses a compaction (280 + 30) and
    leaves a slot idle while the other decodes.
(k) Kernels 1 and 6 with their counts as device tensors: the plain
    versions equal the host-int calls bit for bit and the JAX kernels
    (Pallas interpret mode) within one bf16 ulp of the output's scale, at
    several (n_chunks, win_len), with and without a sliding window and the
    window probabilities.
(a) Buffer addresses: every cache tensor's and static buffer's data_ptr is
    the same at every step, across prefill and compaction and a second
    ``generate`` call.
(h) No host read: the step, run under a dispatch mode that fails on
    ``aten._local_scalar_dense`` and ``aten.nonzero`` (and ``tolist``, which
    no dispatch mode sees), reads nothing on the host, for every cache and
    the engine's per-slot step.  A kernel's plain version (a function named
    ``*_plain``, which only the CPU runs: the card's kernels read the same
    counts in device memory) may read its counts.
"""

import dataclasses
import functools
import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mustafar_tpu import config as jc
from mustafar_tpu.models.llama import init_params as j_init_params
from mustafar_tpu.ops import quant_format as jqf
from mustafar_tpu.ops import sparse_format as jsf
from mustafar_tpu.ops.kernels import quant_attention as jqa
from mustafar_tpu.ops.kernels import sparse_attention as jska
from mustafar_tpu.runtime.generate import Generator as JGenerator
from mustafar_tpu.runtime.scheduler import ContinuousBatchingEngine as JEngine
from mustafar_tpu_torch import config as tc
from mustafar_tpu_torch.ops import quant_format as tqf
from mustafar_tpu_torch.ops import sparse_format as tsf
from mustafar_tpu_torch.ops.kernels import quant_attention as tqa
from mustafar_tpu_torch.ops.kernels import sparse_attention as tska
from mustafar_tpu_torch.runtime.generate import Generator as TGenerator
from mustafar_tpu_torch.runtime.scheduler import ContinuousBatchingEngine as TEngine
from mustafar_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)

PROMPT, NEW = 300, 260


def _engine(mod, mode, codec="q8q4", method="KT_MAG_VT_MAG", window=None, **kw):
    model = dataclasses.replace(mod.TINY_LLAMA, head_dim=128, num_heads=4,
                                num_kv_heads=1, hidden_size=256, sliding_window=window)
    return mod.EngineConfig(
        model=model, cache_mode=getattr(mod.CacheMode, mode),
        prune=mod.PruneConfig(method=getattr(mod.PruneMethod, method),
                              k_sparsity=0.7, v_sparsity=0.7),
        max_seq_len=kw.pop("max_seq_len", 1024), prefill_bucket=256, chunk_size=256,
        codec=codec, **kw)


@functools.lru_cache(maxsize=None)
def _params(seed=0):
    jp = j_init_params(_engine(jc, "DENSE").model, jax.random.PRNGKey(seed),
                       dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _prompt():
    return np.random.RandomState(0).randint(0, 512, size=(2, PROMPT))


@functools.lru_cache(maxsize=None)
def _jax_tokens(mode, codec, use_pallas):
    """One JAX run per case: the compressed cache through its kernels in
    interpret mode (the arithmetic the port's kernels repeat), the dense
    cache through its kernel with ``use_pallas`` (else XLA), the masked cache
    through XLA."""
    jp, _ = _params()
    gen = JGenerator(_engine(jc, mode, codec), jp, dtype=jnp.float32)
    if mode == "COMPRESSED" or use_pallas:
        gen.cache_impl.use_pallas = True
    return np.stack([np.asarray(r) for r in gen.generate(_prompt(), NEW)])


def _port(mode, codec, graph, use_pallas=False):
    gen = TGenerator(_engine(tc, mode, codec), _params()[1], dtype=torch.float32,
                     device="cpu", graph=graph)
    gen.cache_impl.use_pallas = use_pallas
    return gen


@pytest.mark.parametrize("mode,codec,use_pallas", [
    pytest.param("COMPRESSED", "q8q4", False, id="q8q4"),
    pytest.param("COMPRESSED", "bitmap", False, id="bitmap"),
    pytest.param("COMPRESSED", "bitmap-q8", False, id="bitmap-q8"),
    pytest.param("DENSE", "q8q4", False, id="dense"),
    pytest.param("DENSE", "q8q4", True, id="dense-kernel"),
    pytest.param("MASKED", "q8q4", False, id="masked")])
def test_static_decode_tokens_match_eager_and_jax(mode, codec, use_pallas):
    prompt = _prompt()
    eager = _port(mode, codec, False, use_pallas)
    want = np.stack(eager.generate(prompt, NEW))
    assert eager.last_path == "eager"
    static = _port(mode, codec, True, use_pallas)
    got = np.stack(static.generate(prompt, NEW))
    # the first step of a key runs the step once before it is "captured"
    assert static.last_path == "static" and static.last_replays == NEW - 2
    np.testing.assert_array_equal(got, want)
    if mode == "COMPRESSED":
        assert static.last_cache["nc_host"] == 2 and (static.last_cache["n_chunks"] == 2).all()
    if codec == "q8q4" and mode == "COMPRESSED":
        again = np.stack(static.generate(prompt, NEW))
        assert static.last_replays == NEW - 1 and len(static._static) == 1
        np.testing.assert_array_equal(again, want)
    np.testing.assert_array_equal(got, _jax_tokens(mode, codec, use_pallas))


ENGINE_MIX = [(280, 30), (120, 6), (200, 10)]


def test_static_engine_tick_matches_eager_and_jax():
    """Two slots: request 1 crosses the r + C = 288 boundary (a compaction
    of its slot), request 2 retires and its slot takes request 3, which
    retires first and leaves its slot idle while request 1 decodes."""
    jp, tp = _params()
    rs = np.random.RandomState(3)
    reqs = [(rs.randint(0, 512, size=n), m) for n, m in ENGINE_MIX]
    outs = {}
    for graph in (False, True):
        cb = TEngine(_engine(tc, "COMPRESSED", batch_size=2), tp, dtype=torch.float32,
                     device="cpu", graph=graph)
        compacted = []
        keep = cb.impl.compact_slots
        cb.impl.compact_slots = lambda state, do: compacted.append(list(do)) or keep(state, do)
        idle = []
        step = cb._decode_step

        def counted():
            idle.append(int((~cb.active_mask).sum()))
            step()

        cb._decode_step = counted
        uids = [cb.submit(p, m) for p, m in reqs]
        res = cb.run()
        outs[graph] = [np.asarray(res[u]) for u in uids]
        assert cb.decode_path == ("static" if graph else "eager")
        assert compacted and max(idle) == 1
    assert cb.replays == cb.decode_steps - 1
    jcb = JEngine(_engine(jc, "COMPRESSED", batch_size=2), jp, dtype=jnp.float32,
                  use_native=False)
    jcb.impl.use_pallas = jcb.prefill_impl.use_pallas = True
    juids = [jcb.submit(p, m) for p, m in reqs]
    jres = jcb.run()
    for e, s, u in zip(outs[False], outs[True], juids):
        np.testing.assert_array_equal(s, e)
        np.testing.assert_array_equal(s, np.asarray(jres[u]))


# -- kernels 1 and 6 with device counts ---------------------------------------

MC, W, B, HKV, G = 3, 288, 2, 2, 4
ULP = 2.0 ** -8
# (n_chunks, win_len, window): nothing to attend, the window alone, a chunk
# and part of the window, the window's edge inside chunk 0, chunk 0 wholly
# below it
KERNEL_CASES = ((0, 0, None), (0, 44, None), (1, 100, None), (3, 100, 700),
                (3, 100, 467))


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _kernel_state(codec, seed=5):
    """q, a pool (L=1, MC chunks) of real packed chunks of ``codec`` (random
    bf16 K and V pruned to keep 40 of 128, encoded by the JAX codec), the
    scales (q8q4) and the windows."""
    rs = np.random.RandomState(seed)
    BH = B * HKV
    x = jnp.asarray(rs.randn(1, MC, 2, BH, 256, 128) * 0.5, jnp.bfloat16)
    scales = None
    if codec == "q8q4":
        jcod = jqf.QuantCodec(256, 128, 8, 4)
        pool = np.zeros((1, MC, BH, jcod.stream_rows, 128), np.int16)
        scales = np.zeros((1, MC, BH, 2, 128), np.float32)
        for ci in range(MC):
            rows = []
            for j, kind in enumerate(("k", "v")):
                xi = x[0, ci, j]
                xi = jnp.where(jsf.topk_mask(xi, 40), xi, 0).astype(jnp.bfloat16)
                r, s = jqf.encode_chunk(xi, jcod, kind)
                rows.append(np.asarray(r))
                scales[0, ci, :, j] = _bf16(np.asarray(s))
            pool[0, ci] = np.concatenate(rows, axis=1)
    else:
        jf = jsf.ChunkFormat(256, 128, 40)
        r = np.asarray(jax.jit(lambda a: jsf.prune_and_encode_stream(a, jf))(x))
        pool = np.concatenate([r[:, :, 0], r[:, :, 1]], axis=-2)
    k_win, v_win = _bf16(rs.randn(1, BH, W, 128)), _bf16(rs.randn(1, BH, W, 128))
    q = _bf16(rs.randn(B, 1, HKV * G, 128))
    return q, pool, scales, k_win, v_win


def _port_kernel(codec, nc, wl, window, probs, fn="wrapper"):
    q, pool, scales, kw, vw = _kernel_state(codec)
    bf = lambda a: None if a is None else torch.from_numpy(a).to(torch.bfloat16)
    args = (torch.from_numpy(q), torch.from_numpy(pool))
    if codec == "q8q4":
        call = (tqa.fused_q_decode_attention if fn == "wrapper"
                else tqa.fused_q_decode_attention_plain)
        opts = ({"return_win_probs": probs} if fn == "wrapper" else {"win_probs": probs})
        return call(*args, bf(scales), bf(kw), bf(vw), nc, wl, 0,
                    tqf.QuantCodec(256, 128, 8, 4), window=window, **opts)
    tf = tsf.ChunkFormat(256, 128, 40)
    if fn == "wrapper":
        return tska.fused_sparse_decode_attention(*args, bf(kw), bf(vw), nc, wl, 0, tf, tf,
                                                  window=window, return_win_probs=probs)
    return tska.fused_sparse_decode_attention_plain(*args, bf(kw), bf(vw), nc, wl, 0, tf,
                                                    tf, window=window, win_probs=probs)


@functools.lru_cache(maxsize=None)
def _jax_fn(codec, window, probs):
    """The JAX kernel, jitted with its static options (the counts traced,
    so the calls of one option set share one compile)."""
    opts = {"return_win_probs": True} if probs else {}
    if codec == "q8q4":
        return jax.jit(functools.partial(
            jqa.fused_q_decode_attention, codec=jqf.QuantCodec(256, 128, 8, 4),
            max_chunks=MC, window=window, **opts))
    jf = jsf.ChunkFormat(256, 128, 40)
    return jax.jit(functools.partial(jska.fused_sparse_decode_attention_v7, kfmt=jf,
                                     vfmt=jf, max_chunks=MC, window=window, **opts))


def _jax_kernel(codec, nc, wl, window, probs):
    q, pool, scales, kw, vw = _kernel_state(codec)
    args = (jnp.asarray(q), jnp.asarray(pool))
    wins = (jnp.asarray(kw, jnp.bfloat16), jnp.asarray(vw, jnp.bfloat16))
    counts = dict(n_chunks=jnp.int32(nc), win_len=jnp.int32(wl), li=jnp.int32(0))
    fn = _jax_fn(codec, window, probs)
    if codec == "q8q4":
        res = fn(*args, jnp.asarray(scales[..., 0, :], jnp.bfloat16),
                 jnp.asarray(scales[..., 1, :], jnp.bfloat16), *wins, **counts)
    else:
        res = fn(*args, *wins, **counts)
    return [np.asarray(r).astype(np.float32) for r in (res if probs else (res,))]


@pytest.mark.parametrize("codec", ["q8q4", "bitmap"])
def test_device_count_kernels_match_host_ints_and_jax(codec):
    for i, (nc, wl, window) in enumerate(KERNEL_CASES):
        probs = i % 2 == 1
        counts = [torch.full((1,), n, dtype=torch.int32) for n in (nc, wl)]
        dev = _port_kernel(codec, *counts, window, probs)
        host = _port_kernel(codec, nc, wl, window, probs)
        plain = _port_kernel(codec, *counts, window, probs, fn="plain")
        dev, host, plain = ([t] if torch.is_tensor(t) else list(t) for t in (dev, host, plain))
        for a, b, c in zip(dev, host, plain):
            assert torch.equal(a, b) and torch.equal(a, c), (nc, wl, window)
        if nc == wl == 0:
            assert not dev[0].any() and all(not p.any() for p in dev[1:])
            continue
        for got, want in zip(dev, _jax_kernel(codec, nc, wl, window, probs)):
            np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                       atol=ULP * np.abs(want).max(),
                                       err_msg=f"{codec} nc={nc} wl={wl} window={window}")
    # counts past the pool or the window are clamped, as the kernels clamp them
    over = [torch.full((1,), n, dtype=torch.int32) for n in (MC + 4, W + 9)]
    assert torch.equal(_port_kernel(codec, *over, None, False),
                       _port_kernel(codec, MC, W, None, False))


# -- buffer addresses and host reads --------------------------------------------

def _ptrs(state: dict) -> dict:
    return {k: v.data_ptr() for k, v in state.items() if torch.is_tensor(v)}


def test_cache_buffers_keep_their_addresses():
    gen = _port("COMPRESSED", "q8q4", True)
    prompt = _prompt()
    gen.generate(prompt[:, :40], 2)                 # builds the key's state
    (static,) = gen._static.values()
    want = dict(_ptrs(static.cache), tok=static.tok.data_ptr(), pos=static.pos.data_ptr())
    seen = []
    fn = static.graph.fn

    def checked():
        seen.append(dict(_ptrs(static.cache), tok=static.tok.data_ptr(),
                         pos=static.pos.data_ptr()) == want)
        return fn()

    static.graph.fn = checked
    compact = gen.cache_impl.compact
    compactions = []

    def compact_checked(state):
        out = compact(state)
        compactions.append(_ptrs(state) == _ptrs(static.cache) and
                           all(_ptrs(state)[k] == want[k] for k in _ptrs(state)))
        return out

    gen.cache_impl.compact = compact_checked
    for _ in range(2):
        gen.generate(prompt, NEW)
        assert gen.last_cache is static.cache
    assert len(seen) == 2 * (NEW - 1) and all(seen)
    assert compactions == [True, True]


class _NoHostRead(TorchDispatchMode):
    """Fails on an op that reads a tensor's value on the host, or whose
    output's shape depends on its values, unless a kernel's plain version
    (which only the CPU runs) is on the stack."""

    BANNED = ("aten::_local_scalar_dense", "aten::nonzero", "aten::masked_select")

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.name().split(".")[0] in self.BANNED and not _in_plain():
            self.hits.append(func.name())
            raise AssertionError(f"host read in the decode step: {func.name()}")
        return func(*args, **(kwargs or {}))


def _in_plain() -> bool:
    return any(f.function.endswith("_plain") for f in inspect.stack()[2:])


@pytest.mark.parametrize("mode,codec,method,window,use_pallas", [
    pytest.param("COMPRESSED", "q8q4", "KT_MAG_VT_OPA", None, False, id="q8q4-opa"),
    pytest.param("COMPRESSED", "bitmap", "KT_OPA_VT_MAG", 320, False, id="bitmap-window"),
    pytest.param("DENSE", "q8q4", "KT_MAG_VT_MAG", None, False, id="dense"),
    pytest.param("DENSE", "q8q4", "KT_MAG_VT_MAG", 320, True, id="dense-kernel"),
    pytest.param("MASKED", "q8q4", "KT_MAG_VC_OPA", None, True, id="masked-opa")])
def test_static_step_reads_nothing_on_the_host(monkeypatch, mode, codec, method, window,
                                               use_pallas):
    eng = _engine(tc, mode, codec, method, window)
    gen = TGenerator(eng, _params()[1], dtype=torch.float32, device="cpu", graph=True)
    gen.cache_impl.use_pallas = use_pallas
    gen.generate(_prompt(), 3)
    (static,) = gen._static.values()
    tolist = torch.Tensor.tolist

    def guarded(t):
        if not _in_plain():
            raise AssertionError("tolist in the decode step")
        return tolist(t)

    monkeypatch.setattr(torch.Tensor, "tolist", guarded)
    with torch.inference_mode(), _NoHostRead() as mode_:
        logits = static.graph.fn()
    assert not mode_.hits and logits.shape[:2] == (2, 1)
    # the engine's per-slot step
    monkeypatch.setattr(torch.Tensor, "tolist", tolist)
    cb = TEngine(dataclasses.replace(eng, batch_size=2, max_seq_len=1024), _params()[1],
                 dtype=torch.float32, device="cpu", graph=True)
    cb.impl.use_pallas = use_pallas
    cb.submit(_prompt()[0, :200], 3)
    cb.run()
    monkeypatch.setattr(torch.Tensor, "tolist", guarded)
    with torch.inference_mode(), _NoHostRead() as mode_:
        cb._step_graph.fn()
    assert not mode_.hits
