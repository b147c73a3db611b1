"""Port parity, continuous batching and chunked prefill end to end.

(k) The port's ``ContinuousBatchingEngine`` (q8q4 at sparsity 0.5, chunked
    prefill, interleaved admission) against the JAX engine with its Python
    slot bookkeeping (``use_native=False``) and its kernels in Pallas
    interpret mode (``use_pallas = True`` after construction), on the same
    weights and requests: the request mixes of the JAX package's own
    scheduler tests (a decode that crosses a compaction; a short request
    decoding while a long one is admitted segment by segment), each with a
    third request that waits for a slot: a request retires while the other
    runs (its slot idles with its old chunk count) and the slot is reused.
(l) The dense twin of the engine against the JAX dense engine.
(m) The chunked ``Generator`` against the JAX chunked ``Generator``, across
    one compaction.
(n) Entry points raise without a card unless given ``device="cpu"``, and
    refuse sampled decoding.
(k) and (m) run for the bitmap codec too (the JAX kernels v6ps, v7 and the
    segment kernel in interpret mode), (k) on the request mix of the verify
    recipe, for the bitmap-q8 codec (the same kernels with their scales),
    (k) on the compaction mix, and for the q4q4 codec (int4 K and V), (k)
    on the interleaved mix.
(s) At a prompt bucket past the chunk (ROADMAP Queue C fault 1) the engine
    runs each prompt's segments only and gives the bucket-C tokens, for
    both codecs.

Tokens are checked by teacher forcing, as ``test_torch_generate.py`` does:
the port is fed the JAX stream, its pick at every step must be JAX's token
or tie with it within the logit noise the q8q4 kernels' bf16 roundings
allow (f32 runs), and the free-running streams must agree up to the first
such near-tie.  Tiny geometry: head_dim 128, 4 query heads over 1 kv head,
2 layers, chunk 256, residual 32.
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
from mustafar_tpu_torch.models import llama as tl
from mustafar_tpu_torch.runtime.generate import (Generator as TGenerator,
                                                 SamplingParams, filter_logits)
from mustafar_tpu_torch.runtime.scheduler import ContinuousBatchingEngine as TEngine
from mustafar_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)

TIE_TOL = {"COMPRESSED": 1e-2, "DENSE": 1e-4}
MIXES = {
    # tests/test_scheduler.py: decode crosses the r + C = 288 boundary (280),
    # and a prompt with a chunk at prefill that crosses too (530)
    "compaction": [(280, 30), (530, 30), (120, 20)],
    # tests/test_scheduler.py: a short request decodes while a long prompt
    # (4 segments) is admitted one segment per tick
    "interleaved": [(100, 12), (1000, 6), (300, 24)],
    # the continuous-batching mix of the repository's verification recipe
    "verify": [(100, 12), (1000, 6), (280, 30)],
}


def _engine(mod, mode, chunked=True, max_seq=2048, B=2, codec="q8q4", bucket=256):
    model = dataclasses.replace(mod.TINY_LLAMA, head_dim=128, num_heads=4,
                                num_kv_heads=1, hidden_size=256)
    return mod.EngineConfig(
        model=model, cache_mode=getattr(mod.CacheMode, mode),
        prune=mod.PruneConfig(method=mod.PruneMethod.KT_MAG_VT_MAG,
                              k_sparsity=0.5, v_sparsity=0.5),
        max_seq_len=max_seq, prefill_bucket=bucket, chunk_size=256, codec=codec,
        batch_size=B, chunked_prefill=chunked)


def _params(jeng, seed):
    return _model_params(jeng.model, seed)


@functools.cache
def _model_params(model, seed):
    """A model's weights from ``seed``, made once a module for every case
    that uses them (JAX's eager init takes seconds)."""
    jp = j_init_params(model, jax.random.PRNGKey(seed), dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


class _Forced(TEngine):
    """The port's engine fed a given token stream per request (teacher
    forcing); records the logits of every pick."""

    def __init__(self, *args, streams, **kw):
        super().__init__(*args, **kw)
        self.streams = streams
        self.logits = {}
        self.idle_with_chunks = 0      # decode steps with a stale idle slot

    def _decode_step(self):
        idle = torch.from_numpy(~self.active_mask)
        if "kv_pool" in self.cache and idle.any() and not idle.all():
            self.idle_with_chunks += int((self.cache["n_chunks"][0][idle] > 0).any())
        super()._decode_step()

    def _choose(self, logits2d, reqs):
        picks = []
        for row, req in zip(logits2d, reqs):
            if req is None:
                picks.append(0)
                continue
            self.logits.setdefault(req.uid, []).append(row.float().numpy())
            picks.append(self.streams[req.uid][len(req.out)])
        return np.array(picks)


def _check_streams(want, got, logits, tol):
    """Teacher-forced picks tie with JAX's tokens; free streams part only
    after a near-tie."""
    for uid, jtoks in want.items():
        lg = np.stack(logits[uid])
        assert lg.shape[0] == len(jtoks) == len(got[uid])
        gap = lg.max(-1) - lg[np.arange(len(jtoks)), jtoks]
        assert (gap <= tol).all(), (
            f"request {uid}: port and JAX disagree beyond the tie tolerance at "
            f"steps {np.flatnonzero(gap > tol).tolist()}")
        ties = np.flatnonzero(lg.argmax(-1) != jtoks)
        parted = np.flatnonzero(got[uid] != jtoks)
        first_tie = ties[0] if len(ties) else len(jtoks)
        assert (parted[0] if len(parted) else len(jtoks)) >= first_tie, (
            f"request {uid}: streams part with no near-tie before")


def _run_pair(mode, chunked, mix, seed, codec="q8q4"):
    jeng = _engine(jc, mode, chunked, codec=codec)
    teng = _engine(tc, mode, chunked, codec=codec)
    jp, tp = _params(jeng, seed)
    rs = np.random.RandomState(seed)
    reqs = [(rs.randint(0, 512, size=n), m) for n, m in mix]
    jcb = JEngine(jeng, jp, dtype=jnp.float32, use_native=False)
    if mode == "COMPRESSED":
        jcb.impl.use_pallas = jcb.prefill_impl.use_pallas = True
    juids = [jcb.submit(p, m) for p, m in reqs]
    want = jcb.run()
    tcb = TEngine(teng, tp, dtype=torch.float32, device="cpu")
    tuids = [tcb.submit(p, m) for p, m in reqs]
    got = tcb.run()
    assert juids == tuids and sorted(got) == sorted(want)
    forced = _Forced(teng, tp, dtype=torch.float32, device="cpu", streams=want)
    for p, m in reqs:
        forced.submit(p, m)
    assert forced.run().keys() == want.keys()
    _check_streams(want, got, forced.logits, TIE_TOL[mode])
    return tcb, forced, reqs, got


@pytest.mark.parametrize("mix,codec", [
    pytest.param("compaction", "q8q4", id="compaction"),
    pytest.param("interleaved", "q8q4", id="interleaved"),
    pytest.param("verify", "bitmap", id="verify-bitmap"),
    pytest.param("interleaved", "q4q4", id="interleaved-q4q4"),
    pytest.param("compaction", "bitmap-q8", id="compaction-bitmap-q8")])
def test_compressed_engine_matches_jax(mix, codec):
    tcb, forced, reqs, got = _run_pair("COMPRESSED", True, MIXES[mix], 3, codec)
    # a retired request's slot idled with its old chunk count while the
    # other slot decoded: the idle-slot hazard was exercised
    assert forced.idle_with_chunks > 0
    assert tcb.interleave and not tcb.busy()
    assert [len(got[u]) for u in sorted(got)] == [m for _, m in reqs]
    # one segment per tick: every prompt's segments ran, one tick each
    assert tcb.segments == sum(-(-len(p) // 256) for p, _ in reqs)
    # the retired slot was reused, and the cache holds per-slot counts
    assert len(tcb.finished) == 3 and tcb.cache["nc_host"] is None


def test_dense_engine_matches_jax():
    """Dense twin, monolithic prefill per request, five requests over two
    slots."""
    tcb, _, _, _ = _run_pair("DENSE", False, [(40, 8), (100, 12), (70, 6),
                                              (250, 10), (9, 5)], 4)
    assert tcb.segments == 0 and not tcb.interleave


def test_dense_engine_eos_matches_jax():
    """EOS retires a request (and is dropped from its output) in both
    engines: an EOS id taken from a free-running stream."""
    jeng, teng = _engine(jc, "DENSE", False), _engine(tc, "DENSE", False)
    jp, tp = _params(jeng, 4)
    rs = np.random.RandomState(4)
    reqs = [(rs.randint(0, 512, size=n), m) for n, m in ((40, 8), (100, 12), (70, 6))]
    free = TEngine(teng, tp, dtype=torch.float32, device="cpu")
    for p, m in reqs:
        free.submit(p, m)
    eos = int(free.run()[2][4])
    outs = []
    for cb in (JEngine(jeng, jp, dtype=jnp.float32, eos_id=eos, use_native=False),
               TEngine(teng, tp, dtype=torch.float32, eos_id=eos, device="cpu")):
        uids = [cb.submit(p, m) for p, m in reqs]
        res = cb.run()
        outs.append([np.asarray(res[u]) for u in uids])
    for want, got in zip(*outs):
        np.testing.assert_array_equal(got, want)
    assert len(outs[1][1]) == 4 and eos not in outs[1][1]


def test_decode_continues_during_admission():
    """Interleaved admission: the short request emits tokens while the long
    prompt is still streaming in (the blocking path would emit nothing)."""
    teng = _engine(tc, "COMPRESSED")
    _, tp = _params(_engine(jc, "COMPRESSED"), 5)
    rs = np.random.RandomState(5)
    cb = TEngine(teng, tp, dtype=torch.float32, device="cpu")
    short = cb.submit(rs.randint(0, 512, size=100), 12)
    cb.submit(rs.randint(0, 512, size=1000), 6)
    progress = []
    while cb.busy():
        cb.tick()
        if cb._admissions:
            progress.append(len(cb.requests[short].out))
    assert progress and progress[-1] > progress[0], progress
    blocking = TEngine(teng, tp, dtype=torch.float32, device="cpu", interleave=False)
    blocking.submit(cb.requests[1].tokens, 12)
    blocking.submit(cb.requests[2].tokens, 6)
    outs = blocking.run()
    for uid in (1, 2):
        np.testing.assert_array_equal(outs[uid], np.asarray(cb.requests[uid].out))


def _teacher_forced_chunked(gen, prompt, stream):
    impl, cfg, params = gen.cache_impl, gen.cfg, gen.params
    B, T = prompt.shape
    toks = torch.zeros((B, gen._bucket(T)), dtype=torch.int64)
    toks[:, :T] = torch.from_numpy(prompt)
    cache = impl.init(B, gen.dtype)
    with torch.inference_mode():
        logits, cache = tl.prefill_chunked(cfg, params, toks, cache, impl, T)
        out, compacted_after = [logits[:, 0]], []
        for i in range(1, stream.shape[1]):
            logits, cache = tl.decode_step(cfg, params,
                                           torch.from_numpy(stream[:, i - 1:i]).long(),
                                           cache, impl, T + i - 1)
            out.append(logits[:, 0])
            if impl.window_full(cache, T + i):
                impl.compact(cache)
                compacted_after.append(i)
    return torch.stack(out, 1).numpy(), compacted_after


def test_chunked_generator_matches_jax():
    """Chunked prefill of 600 tokens (3 segments, 2 chunks packed), then 220
    greedy steps across one compaction (the window fills at total 800)."""
    _chunked_generator("q8q4")


def test_chunked_generator_matches_jax_bitmap():
    """As above for the bitmap codec."""
    _chunked_generator("bitmap")


def test_chunked_generator_matches_jax_q4q4():
    """As above for the q4q4 codec."""
    _chunked_generator("q4q4")


def test_chunked_generator_matches_jax_bitmap_q8():
    """As above for the bitmap-q8 codec."""
    _chunked_generator("bitmap-q8")


def _chunked_generator(codec):
    jeng = _engine(jc, "COMPRESSED", max_seq=1024, codec=codec)
    teng = _engine(tc, "COMPRESSED", max_seq=1024, codec=codec)
    jp, tp = _params(jeng, 6)
    prompt = np.random.RandomState(6).randint(0, 512, size=(2, 600))
    jgen = JGenerator(jeng, jp, dtype=jnp.float32)
    jgen.cache_impl.use_pallas = True
    want = np.stack([np.asarray(r) for r in jgen.generate(prompt, 220)])
    tgen = TGenerator(teng, tp, dtype=torch.float32, device="cpu")
    got = np.stack(tgen.generate(prompt, 220))
    assert tgen.last_cache["nc_host"] == 3
    logits, compacted_after = _teacher_forced_chunked(tgen, prompt, want)
    assert compacted_after == [200]
    _check_streams({0: want[0], 1: want[1]}, {0: got[0], 1: got[1]},
                   {0: list(logits[0]), 1: list(logits[1])}, TIE_TOL["COMPRESSED"])


def test_entry_points_need_a_device_and_greedy():
    """Without a card the engine raises unless asked for the CPU; sampled
    decoding, once refused by both entry points, is served
    (``test_torch_sampling.py`` holds it against JAX's filter)."""
    teng = _engine(tc, "COMPRESSED")
    params = {"final_norm": torch.ones(256)}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TEngine(teng, params)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TGenerator(teng, params)
    hot = SamplingParams(temperature=0.9, top_p=0.95, seed=7)
    hot_cb = TEngine(teng, params, device="cpu", sampling=hot)
    assert hot_cb.sampling == hot and hot_cb._pick_step == 0
    logits = torch.from_numpy(np.random.RandomState(0).randn(3, 512).astype(np.float32))
    kept = torch.isfinite(filter_logits(logits, hot))
    picks = hot_cb._choose(logits, [None] * 3)
    assert hot_cb._pick_step == 1 and kept[torch.arange(3), picks].all()
    cb = TEngine(teng, params, device="cpu")
    assert cb.device.type == "cpu" and cb.cache["kv_pool"].device.type == "cpu"
    with pytest.raises(ValueError):
        cb.submit(np.zeros(2000, np.int64), 100)          # past max_seq_len
    with pytest.raises(AssertionError):                   # dense + chunked
        _engine(tc, "DENSE", chunked=True)


@pytest.mark.parametrize("codec", ["q8q4", "bitmap"])
def test_engine_bucket_past_chunk(codec):
    """Buckets 512 and 768 over chunks of 256: interleaved admission runs
    ceil(n / 256) segments a prompt, not the bucket's, and every request's
    tokens equal the bucket-256 run's."""
    _, tp = _params(_engine(jc, "COMPRESSED"), 9)
    rs = np.random.RandomState(9)
    reqs = [(rs.randint(0, 512, size=n), m) for n, m in ((100, 8), (300, 10), (600, 6))]
    runs = {}
    for bucket in (256, 512, 768):
        cb = TEngine(_engine(tc, "COMPRESSED", codec=codec, bucket=bucket), tp,
                     dtype=torch.float32, device="cpu")
        uids = [cb.submit(p, m) for p, m in reqs]
        out = cb.run()
        assert cb.segments == 1 + 2 + 3, (bucket, cb.segments)
        runs[bucket] = [np.asarray(out[u]) for u in uids]
    for bucket in (512, 768):
        for want, got in zip(runs[256], runs[bucket]):
            np.testing.assert_array_equal(got, want, err_msg=f"bucket {bucket}")
