"""Port parity, greedy generation (g): the port's ``Generator`` against the
JAX package's, in float32, on the same weights and prompts, across one
compaction boundary (prompt 300, 260 new tokens, max_seq_len 1024: the
window fills at total length 544, after decode step 244).

The JAX compressed cache decodes through its kernel in Pallas interpret
mode (``cache_impl.use_pallas = True``), the path whose arithmetic the
port's kernel repeats: the quant kernel (codecs q8q4, q8 and q4q4), or v7
for the bitmap codecs (bitmap, and bitmap-q8 with its scales); its dense cache decodes through XLA, as in
production.

Where the two streams may part: the kernels read q and the window as bf16
and round p to bf16, and packing rounds the window to bf16 (and, for q8q4,
to int8/int4 codes), so last-bit differences of the f32 activations
(summation order in the two frameworks' matmuls) can flip a rounding and
move a logit by up to a few 1e-3 (measured below 3e-3 over these 260 steps
with q8q4).  Greedy
picks are therefore checked by teacher forcing on the JAX stream: at every
step the port's pick must be JAX's token or tie with it within that noise;
and the free-running streams must agree up to the first such near-tie
(measured on these seeds: there is none, and all 260 tokens agree).

(r) Chunked prefill at a prompt bucket past the chunk (ROADMAP Queue C
    fault 1): at buckets 2C and 3C the chunked ``Generator``'s tokens and
    cache state equal the bucket-C run's, and a prompt that packs no chunk
    decodes as monolithic prefill does, for both codecs.
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
from mustafar_tpu_torch import config as tc
from mustafar_tpu_torch.models import llama as tl
from mustafar_tpu_torch.models.llama import init_params as t_init_params
from mustafar_tpu_torch.runtime.generate import Generator as TGenerator
from mustafar_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)

PROMPT, NEW, MAX_SEQ = 300, 260, 1024
# logit noise allowed at a near-tie: compressed, the bf16 roundings above;
# dense, f32 throughout (summation order only)
TIE_TOL = {"COMPRESSED": 1e-2, "DENSE": 1e-4}


def _engine(mod, mode, codec="q8q4"):
    model = dataclasses.replace(mod.TINY_LLAMA, head_dim=128, num_heads=4,
                                num_kv_heads=1, hidden_size=256)
    return mod.EngineConfig(
        model=model, cache_mode=getattr(mod.CacheMode, mode),
        prune=mod.PruneConfig(method=mod.PruneMethod.KT_MAG_VT_MAG,
                              k_sparsity=0.7, v_sparsity=0.7),
        max_seq_len=MAX_SEQ, prefill_bucket=256, chunk_size=256, codec=codec)


@functools.cache
def _params(model, seed):
    """A model's weights from ``seed``, made once a module for every case
    that uses them (JAX's eager init takes seconds)."""
    jp = j_init_params(model, jax.random.PRNGKey(seed), dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _teacher_forced_logits(gen, prompt, stream):
    """The port's logits at every step when fed ``stream`` (the JAX tokens),
    with prefill, decode and compaction exactly as ``Generator.generate``."""
    impl, cfg, params = gen.cache_impl, gen.cfg, gen.params
    B, T = prompt.shape
    toks = torch.zeros((B, gen._bucket(T)), dtype=torch.int64)
    toks[:, :T] = torch.from_numpy(prompt)
    cache = impl.init(B, gen.dtype)
    with torch.inference_mode():
        logits, cache = tl.prefill(cfg, params, toks, cache, impl, T, last_only=True)
        out = [logits[:, 0]]
        compacted_after = []
        for i in range(1, stream.shape[1]):
            logits, cache = tl.decode_step(cfg, params,
                                           torch.from_numpy(stream[:, i - 1:i]).long(),
                                           cache, impl, T + i - 1)
            out.append(logits[:, 0])
            if hasattr(impl, "compact") and impl.window_full(cache, T + i):
                impl.compact(cache)
                compacted_after.append(i)
    return torch.stack(out, 1).numpy(), compacted_after, cache


@pytest.mark.parametrize("mode,codec", [
    pytest.param("COMPRESSED", "q8q4", id="COMPRESSED"),
    pytest.param("DENSE", "q8q4", id="DENSE"),
    pytest.param("COMPRESSED", "bitmap", id="COMPRESSED-bitmap"),
    pytest.param("COMPRESSED", "q8", id="COMPRESSED-q8"),
    pytest.param("COMPRESSED", "q4q4", id="COMPRESSED-q4q4"),
    pytest.param("COMPRESSED", "bitmap-q8", id="COMPRESSED-bitmap-q8")])
def test_greedy_tokens_match_jax_across_compaction(mode, codec):
    jeng, teng = _engine(jc, mode, codec), _engine(tc, mode, codec)
    jp, tp = _params(jeng.model, 0)
    prompt = np.random.RandomState(0).randint(0, 512, size=(2, PROMPT))

    jgen = JGenerator(jeng, jp, dtype=jnp.float32)
    if mode == "COMPRESSED":
        jgen.cache_impl.use_pallas = True
    jtoks = np.stack([np.asarray(r) for r in jgen.generate(prompt, NEW)])
    tgen = TGenerator(teng, tp, dtype=torch.float32, device="cpu")
    ttoks = np.stack(tgen.generate(prompt, NEW))
    assert jtoks.shape == ttoks.shape == (2, NEW)

    logits, compacted_after, cache = _teacher_forced_logits(tgen, prompt, jtoks)
    if mode == "COMPRESSED":
        # one compaction, after step 244 (total 544 = 2 chunks of 256 + 32)
        assert compacted_after == [244] and cache["nc_host"] == 2
        assert (cache["n_chunks"] == 2).all()
    picked = logits.argmax(-1)
    at_jax = np.take_along_axis(logits, jtoks[..., None], -1)[..., 0]
    gap = logits.max(-1) - at_jax                    # 0 where the picks agree
    assert (gap <= TIE_TOL[mode]).all(), (
        f"port and JAX disagree beyond the tie tolerance at steps "
        f"{np.argwhere(gap > TIE_TOL[mode]).tolist()}")
    for row in range(2):
        ties = np.flatnonzero(picked[row] != jtoks[row])
        parted = np.flatnonzero(ttoks[row] != jtoks[row])
        first_tie = ties[0] if len(ties) else NEW
        first_part = parted[0] if len(parted) else NEW
        assert first_part >= first_tie, (
            f"row {row}: streams part at step {first_part} with no near-tie "
            f"before step {first_tie}")


def test_eos_and_min_new_tokens_match_jax():
    """EOS ends a row (and is suppressed for the first ``min_new_tokens``),
    as in the JAX Generator; dense cache, 40 new tokens."""
    jeng, teng = _engine(jc, "DENSE"), _engine(tc, "DENSE")
    jp, tp = _params(jeng.model, 1)
    prompt = np.random.RandomState(2).randint(0, 512, size=(2, 40))
    jgen = JGenerator(jeng, jp, dtype=jnp.float32)
    tgen = TGenerator(teng, tp, dtype=torch.float32, device="cpu")
    free = np.stack([np.asarray(r) for r in jgen.generate(prompt, 40)])
    # EOS ids that occur in the free-running stream: row 0's token at step 3
    # (suppressed below step 6, so it is skipped there) and row 1's at 20
    eos = (int(free[0, 3]), int(free[1, 20]))
    for min_new in (0, 6):
        want = jgen.generate(prompt, 40, eos_id=eos, min_new_tokens=min_new)
        got = tgen.generate(prompt, 40, eos_id=eos, min_new_tokens=min_new)
        assert [len(r) for r in got] == [len(r) for r in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
        assert min(len(r) for r in got) < 40


@pytest.mark.parametrize("codec", ["q8q4", "bitmap"])
def test_chunked_prefill_bucket_past_chunk(codec):
    """Buckets 512 and 768 over chunks of 256: a 300-token prompt runs its two
    segments only (not the bucket's 2 or 3), so tokens and the whole cache
    state equal the bucket-256 run's; a 100-token prompt (no chunk packed)
    gives monolithic prefill's tokens at every bucket."""
    teng = _engine(tc, "COMPRESSED", codec)
    params = t_init_params(teng.model, device="cpu", dtype=torch.float32, seed=3)
    rs = np.random.RandomState(8)
    long, short = rs.randint(0, 512, size=(2, PROMPT)), rs.randint(0, 512, size=(2, 100))
    runs = {}
    for bucket in (256, 512, 768):
        eng = dataclasses.replace(teng, chunked_prefill=True, prefill_bucket=bucket)
        gen = TGenerator(eng, params, dtype=torch.float32, device="cpu")
        runs[bucket] = (np.stack(gen.generate(long, 12)), gen.last_cache)
        mono = TGenerator(dataclasses.replace(teng, prefill_bucket=bucket), params,
                          dtype=torch.float32, device="cpu")
        np.testing.assert_array_equal(np.stack(gen.generate(short, 8)),
                                      np.stack(mono.generate(short, 8)),
                                      err_msg=f"bucket {bucket}")
    want_toks, want_state = runs[256]
    assert want_state["nc_host"] == 1
    for bucket in (512, 768):
        toks, state = runs[bucket]
        np.testing.assert_array_equal(toks, want_toks, err_msg=f"bucket {bucket}")
        assert state.keys() == want_state.keys()
        for key, val in want_state.items():
            assert (torch.equal(state[key], val) if torch.is_tensor(val)
                    else state[key] == val), (bucket, key)
    with pytest.raises(AssertionError, match="multiple of chunk_size"):
        dataclasses.replace(teng, chunked_prefill=True, prefill_bucket=384)
