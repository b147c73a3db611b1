"""Port parity, output-aware (Opa) pruning through the continuous-batching
engine (``test_torch_opa_state.py`` holds the cache steps, ``test_torch_opa_chunked.py``
the chunked ``Generator``).

(e) The port's ``ContinuousBatchingEngine`` (chunked prefill, interleaved
    admission, two slots) under KT_OPA_VT_MAG and KT_MAG_VT_OPA on all five
    codecs, against the JAX engine with its Python slot bookkeeping
    (``use_native=False``) and its kernels in Pallas interpret mode, on the
    same weights and requests: a request whose decode crosses a compaction
    by score (``compact_slots``), one of 543 tokens admitted segment by
    segment while the first decodes (a chunk packed by its streamed scores,
    a partial last segment, a compaction right after its first step), and a
    third that waits for a slot and reuses it.  Tokens are checked by
    teacher forcing, as ``test_torch_scheduler.py`` checks them: each of
    the port's picks is JAX's token or ties with it within the logit noise
    of the kernels' bf16 roundings, and the free streams part only after
    such a near-tie.

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
from mustafar_tpu.runtime.scheduler import ContinuousBatchingEngine as JEngine
from mustafar_tpu_torch import config as tc
from mustafar_tpu_torch.runtime.scheduler import ContinuousBatchingEngine as TEngine
from mustafar_tpu_torch.weights import params_from_jax
from tests.test_torch_scheduler import TIE_TOL, _check_streams, _Forced

torch.set_num_threads(2)

CODECS = ("q8", "q8q4", "q4q4", "bitmap", "bitmap-q8")
MIX = [(280, 14), (543, 8), (100, 6)]


def _engine(mod, method, codec):
    model = dataclasses.replace(mod.TINY_LLAMA, head_dim=128, num_heads=4, num_kv_heads=1,
                                hidden_size=256)
    return mod.EngineConfig(
        model=model, cache_mode=mod.CacheMode.COMPRESSED,
        prune=mod.PruneConfig(method=getattr(mod.PruneMethod, method), k_sparsity=0.7,
                              v_sparsity=0.7),
        max_seq_len=1024, prefill_bucket=256, chunk_size=256, codec=codec, batch_size=2,
        chunked_prefill=True)


@pytest.fixture(scope="module")
def params():
    """The tiny model's weights for both packages, made once for the module
    (every case has the same model)."""
    jp = j_init_params(_engine(jc, "KT_MAG_VT_OPA", "q8q4").model, jax.random.PRNGKey(7),
                       dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


class _Compactions(_Forced):
    """The forced engine, counting the slots each ``compact_slots`` packs."""

    def _maybe_compact(self):
        self.compacted = getattr(self, "compacted", 0)
        before = self.cache["n_chunks"][0].clone()
        super()._maybe_compact()
        self.compacted += int((self.cache["n_chunks"][0] > before).sum())


@pytest.mark.parametrize("method", ["KT_OPA_VT_MAG", "KT_MAG_VT_OPA"])
@pytest.mark.parametrize("codec", CODECS)
def test_opa_engine_matches_jax(method, codec, params):
    jeng, teng = _engine(jc, method, codec), _engine(tc, method, codec)
    jp, tp = params
    rs = np.random.RandomState(7)
    reqs = [(rs.randint(0, 512, size=n), m) for n, m in MIX]
    jcb = JEngine(jeng, jp, dtype=jnp.float32, use_native=False)
    jcb.impl.use_pallas = jcb.prefill_impl.use_pallas = True
    juids = [jcb.submit(p, m) for p, m in reqs]
    want = jcb.run()
    tcb = TEngine(teng, tp, dtype=torch.float32, device="cpu")
    tuids = [tcb.submit(p, m) for p, m in reqs]
    got = tcb.run()
    assert juids == tuids and sorted(got) == sorted(want)
    assert tcb.interleave and tcb.segments == 2 + 3 + 1
    assert [len(got[u]) for u in tuids] == [m for _, m in MIX]
    forced = _Compactions(teng, tp, dtype=torch.float32, device="cpu", streams=want)
    for p, m in reqs:
        forced.submit(p, m)
    assert forced.run().keys() == want.keys()
    # the first request's window filled at 288, the second's after one step
    assert forced.compacted == 2
    key = "k_score" if method == "KT_OPA_VT_MAG" else "v_score"
    assert forced.cache[key].abs().sum() > 0
    _check_streams(want, got, forced.logits, TIE_TOL["COMPRESSED"])
