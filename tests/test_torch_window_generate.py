"""Port parity, Mistral's sliding window end to end: the ``Generator`` (and
the engine over the dense and masked caches) on a windowed model, against
the JAX package's, on the same weights and prompts in float32.

The model: TINY_LLAMA at head_dim 128 (4 query heads, 1 kv head, hidden
256, 2 layers) with ``sliding_window`` 320.  Prompt 600 (bucket 768, past
the window: prefill is banded), 210 new tokens, chunk 256, residual 32:
prefill packs 2 chunks and leaves 88 window tokens; from the first decode
step (position 600, low edge 280) chunk 0 lies wholly below the window and
chunk 1 partly; the window fills at total length 800, so one compaction
(after decode step 200) packs a third chunk.

(d) The dense cache on its plain route and through kernel 4
    (``use_pallas``, the plain version here; JAX's kernel in interpret
    mode), and the masked cache at the ``EngineConfig`` defaults (MASKED,
    KT_MAG_VT_MAG at 0.5): greedy tokens equal to JAX's.
(e) The continuous-batching engine over the dense cache (plain and kernel
    4 per slot) and the masked cache, on a windowed model: requests longer
    than the window, one waiting for a retired slot; tokens equal to JAX's.
(c) The compressed cache at every codec (kernels 1 and 6's plain versions
    with the window; JAX's kernels in interpret mode) and the Opa method
    KT_MAG_VT_OPA at q8q4: tokens equal to JAX's; the cache's counts show
    the compaction.
(l) The lossless invariant, port only: the compressed cache at sparsity 0
    (bitmap, every value kept) gives the dense cache's tokens, in bf16.
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
from mustafar_tpu_torch.models.llama import init_params as t_init_params
from mustafar_tpu_torch.runtime.generate import Generator as TGenerator
from mustafar_tpu_torch.runtime.scheduler import ContinuousBatchingEngine as TEngine
from mustafar_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)

WINDOW, PROMPT, NEW, MAX_SEQ = 320, 600, 210, 1024


def _engine(mod, mode="COMPRESSED", codec="bitmap", method="KT_MAG_VT_MAG", sparsity=0.7,
            **kw):
    model = dataclasses.replace(mod.TINY_LLAMA, head_dim=128, num_heads=4,
                                num_kv_heads=1, hidden_size=256, sliding_window=WINDOW)
    if mode == "MASKED":       # the EngineConfig defaults: masked, KT_MAG_VT_MAG at 0.5
        return mod.EngineConfig(model=model, max_seq_len=MAX_SEQ, **kw)
    return mod.EngineConfig(
        model=model, cache_mode=getattr(mod.CacheMode, mode),
        prune=mod.PruneConfig(method=getattr(mod.PruneMethod, method),
                              k_sparsity=sparsity, v_sparsity=sparsity),
        max_seq_len=MAX_SEQ, prefill_bucket=256, chunk_size=256, codec=codec, **kw)


def _params(jeng, seed=0):
    return _model_params(jeng.model, seed)


@functools.cache
def _model_params(model, seed):
    """A model's weights from ``seed``, made once a module for every case
    that uses them (JAX's eager init takes seconds)."""
    jp = j_init_params(model, jax.random.PRNGKey(seed), dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _prompt(seed=0):
    return np.random.RandomState(seed).randint(0, 512, size=(2, PROMPT))


def run_generators(mode, codec="bitmap", method="KT_MAG_VT_MAG", use_pallas=False,
                   new=NEW):
    """(JAX tokens, port tokens, the port's Generator) on one engine."""
    jeng, teng = _engine(jc, mode, codec, method), _engine(tc, mode, codec, method)
    jp, tp = _params(jeng)
    prompt = _prompt()
    jgen = JGenerator(jeng, jp, dtype=jnp.float32)
    jgen.cache_impl.use_pallas = use_pallas or mode == "COMPRESSED"
    want = np.stack([np.asarray(r) for r in jgen.generate(prompt, new)])
    tgen = TGenerator(teng, tp, dtype=torch.float32, device="cpu")
    tgen.cache_impl.use_pallas = use_pallas
    got = np.stack(tgen.generate(prompt, new))
    assert got.shape == want.shape == (2, new)
    return want, got, tgen


@pytest.mark.parametrize("mode,use_pallas", [("DENSE", False), ("DENSE", True),
                                             ("MASKED", False)],
                         ids=["dense", "dense-kernel4", "masked-default"])
def test_generator_dense_and_masked_match_jax(mode, use_pallas):
    want, got, tgen = run_generators(mode, use_pallas=use_pallas)
    assert tgen.cache_impl.window == WINDOW
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["DENSE", "MASKED"])
def test_engine_dense_and_masked_match_jax(mode):
    """Three requests over two slots: prompts of 500 and 420 (past the
    window) and 100 (admitted when the first retires), 40, 30 and 20 new
    tokens, per-slot decode with the window (the dense cache also through
    kernel 4's per-slot plain version)."""
    jeng = _engine(jc, mode, batch_size=2, **({"prefill_bucket": 128} if mode == "MASKED"
                                              else {}))
    teng = _engine(tc, mode, batch_size=2, **({"prefill_bucket": 128} if mode == "MASKED"
                                              else {}))
    jp, tp = _params(jeng, 3)
    rs = np.random.RandomState(4)
    reqs = [(rs.randint(0, 512, size=n), m) for n, m in ((500, 40), (420, 30), (100, 20))]
    for use_pallas in ((False, True) if mode == "DENSE" else (False,)):
        jcb = JEngine(jeng, jp, dtype=jnp.float32, use_native=False)
        jcb.impl.use_pallas = jcb.prefill_impl.use_pallas = use_pallas
        for p, m in reqs:
            jcb.submit(p, m)
        want = jcb.run()
        tcb = TEngine(teng, tp, dtype=torch.float32, device="cpu")
        tcb.impl.use_pallas = use_pallas
        for p, m in reqs:
            tcb.submit(p, m)
        got = tcb.run()
        assert sorted(got) == sorted(want)
        for uid in want:
            np.testing.assert_array_equal(got[uid], np.asarray(want[uid]),
                                          err_msg=f"{uid}, use_pallas={use_pallas}")


def test_compressed_lossless_matches_dense():
    """Sparsity 0 (bitmap keeps every value): the compressed cache with the
    window, whose decode masks chunk 0 whole and chunk 1 in part, gives the
    dense cache's tokens, bf16 weights, 30 new tokens (the JAX package's
    ``test_compressed_sliding_window_lossless_matches_dense``)."""
    dense_eng = _engine(tc, "DENSE")
    comp_eng = _engine(tc, "COMPRESSED", "bitmap", sparsity=0.0)
    params = t_init_params(dense_eng.model, device="cpu", dtype=torch.bfloat16, seed=3)
    prompt = np.random.RandomState(6).randint(0, 512, size=(1, PROMPT))
    dense = TGenerator(dense_eng, params, dtype=torch.bfloat16, device="cpu")
    comp = TGenerator(comp_eng, params, dtype=torch.bfloat16, device="cpu")
    assert comp.cache_impl.kfmt.keep == 128
    np.testing.assert_array_equal(comp.generate(prompt, 30)[0], dense.generate(prompt, 30)[0])
    assert comp.last_cache["nc_host"] == 2
