"""Port parity, greedy generation (g): the port's ``Generator`` against the
JAX package's, in float32, on the same weights and prompts, across one
compaction boundary (prompt 300, 260 new tokens, max_seq_len 1024: the
window fills at total length 544, after decode step 244).

The JAX compressed cache decodes through its q8q4 kernel in Pallas
interpret mode (``cache_impl.use_pallas = True``), the path whose arithmetic
the port's kernel repeats; its dense cache decodes through XLA, as in
production.

Where the two streams may part: the q8q4 kernel reads q and the window as
bf16 and rounds p to bf16, and packing rounds the window to bf16 and to
int8/int4 codes, so last-bit differences of the f32 activations (summation
order in the two frameworks' matmuls) can flip a rounding and move a logit
by up to a few 1e-3 (measured below 3e-3 over these 260 steps).  Greedy
picks are therefore checked by teacher forcing on the JAX stream: at every
step the port's pick must be JAX's token or tie with it within that noise;
and the free-running streams must agree up to the first such near-tie
(measured on these seeds: there is none, and all 260 tokens agree).
"""

import dataclasses

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
from mustafar_tpu_torch.runtime.generate import Generator as TGenerator
from mustafar_tpu_torch.weights import params_from_jax

torch.set_num_threads(2)

PROMPT, NEW, MAX_SEQ = 300, 260, 1024
# logit noise allowed at a near-tie: compressed, the bf16 roundings above;
# dense, f32 throughout (summation order only)
TIE_TOL = {"COMPRESSED": 1e-2, "DENSE": 1e-4}


def _engine(mod, mode):
    model = dataclasses.replace(mod.TINY_LLAMA, head_dim=128, num_heads=4,
                                num_kv_heads=1, hidden_size=256)
    return mod.EngineConfig(
        model=model, cache_mode=getattr(mod.CacheMode, mode),
        prune=mod.PruneConfig(method=mod.PruneMethod.KT_MAG_VT_MAG,
                              k_sparsity=0.7, v_sparsity=0.7),
        max_seq_len=MAX_SEQ, prefill_bucket=256, chunk_size=256, codec="q8q4")


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


@pytest.mark.parametrize("mode", ["COMPRESSED", "DENSE"])
def test_greedy_tokens_match_jax_across_compaction(mode):
    jeng, teng = _engine(jc, mode), _engine(tc, mode)
    jp = j_init_params(jeng.model, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
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
    jp = j_init_params(jeng.model, jax.random.PRNGKey(1), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
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
