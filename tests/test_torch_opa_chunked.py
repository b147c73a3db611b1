"""Port parity, output-aware (Opa) pruning through the chunked ``Generator``
(``test_torch_opa_state.py`` holds the cache's segment and per-slot steps,
``test_torch_opa_engine.py`` the engine).

(g) The chunked ``Generator`` under both Opa methods on all five codecs,
    prompt 543 and 10 new tokens (a compaction by score after the first
    step), against the JAX chunked ``Generator`` with its kernels in Pallas
    interpret mode: the port's picks, fed JAX's stream, are JAX's tokens or
    tie with them within the kernels' bf16 noise, and the free streams part
    only after such a near-tie.

Tiny geometry, f32: head_dim 128, 4 query heads over 1 kv head, 2 layers,
chunk 256, residual 32, sparsity 0.7.
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
from tests.test_torch_scheduler import TIE_TOL, _check_streams

torch.set_num_threads(1)

TRUE_LEN, NEW = 543, 10
CODECS = ("q8", "q8q4", "q4q4", "bitmap", "bitmap-q8")
METHODS = ("KT_OPA_VT_MAG", "KT_MAG_VT_OPA")


def _engine(mod, method, codec):
    model = dataclasses.replace(mod.TINY_LLAMA, head_dim=128, num_heads=4,
                                num_kv_heads=1, hidden_size=256, num_layers=2)
    return mod.EngineConfig(
        model=model, cache_mode=mod.CacheMode.COMPRESSED,
        prune=mod.PruneConfig(method=getattr(mod.PruneMethod, method), k_sparsity=0.7,
                              v_sparsity=0.7),
        max_seq_len=1024, prefill_bucket=256, chunk_size=256, codec=codec,
        chunked_prefill=True)


@pytest.fixture(scope="module")
def params():
    """The tiny model's weights for both packages, made once for the module
    (every case has the same model)."""
    jp = j_init_params(_engine(jc, "KT_MAG_VT_OPA", "q8q4").model, jax.random.PRNGKey(8),
                       dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _teacher_forced(gen, prompt, stream):
    impl, cfg, params = gen.cache_impl, gen.cfg, gen.params
    toks = torch.zeros((prompt.shape[0], gen._bucket(prompt.shape[1])), dtype=torch.int64)
    toks[:, :prompt.shape[1]] = torch.from_numpy(prompt)
    T = prompt.shape[1]
    cache = impl.init(prompt.shape[0], gen.dtype)
    compacted = []
    with torch.inference_mode():
        logits, cache = tl.prefill_chunked(cfg, params, toks, cache, impl, T)
        out = [logits[:, 0]]
        for i in range(1, stream.shape[1]):
            logits, cache = tl.decode_step(cfg, params,
                                           torch.from_numpy(stream[:, i - 1:i]).long(),
                                           cache, impl, T + i - 1)
            out.append(logits[:, 0])
            if impl.window_full(cache, T + i):
                impl.compact(cache)
                compacted.append(i)
    return torch.stack(out, 1).numpy(), compacted


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("codec", CODECS)
def test_opa_chunked_generator_matches_jax(method, codec, params):
    jeng, teng = _engine(jc, method, codec), _engine(tc, method, codec)
    jp, tp = params
    prompt = np.random.RandomState(8).randint(0, 512, size=(2, TRUE_LEN))
    jgen = JGenerator(jeng, jp, dtype=jnp.float32)
    jgen.cache_impl.use_pallas = True
    want = np.stack([np.asarray(r) for r in jgen.generate(prompt, NEW)])
    tgen = TGenerator(teng, tp, dtype=torch.float32, device="cpu")
    got = np.stack(tgen.generate(prompt, NEW))
    assert tgen.last_cache["nc_host"] == 2
    logits, compacted = _teacher_forced(tgen, prompt, want)
    assert compacted == [1]
    _check_streams({0: want[0], 1: want[1]}, {0: got[0], 1: got[1]},
                   {0: list(logits[0]), 1: list(logits[1])}, TIE_TOL["COMPRESSED"])
