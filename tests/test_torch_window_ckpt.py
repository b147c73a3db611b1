"""Port parity on trained weights with a sliding window: the checkpoint
``ckpt/tiny-acc-sw512`` (4 layers, hidden 256, head_dim 128, 4 query heads
over 2 kv heads, window 512; trained by the JAX package's harness, so
attention is far from uniform), read by the port's ``load_ckpt``.

The prompt is the first 800 bytes of the JAX package's ``tinylm.py`` (text
of the kind the model was trained on; the file never changes), padded to
the 1,024 bucket: prefill is banded (800 > 512), and from the first decode
step (position 800, first live row 289) the compressed cache's chunk 0 lies
wholly below the window.

(a) The dense cache: every prompt position's prefill logits and 16
    teacher-forced decode steps' logits, port against JAX, f32, within
    1e-5 of the logits' range (summation order only, as
    ``test_torch_model.py`` holds the dense f32 model).
(b) q8q4 (kernel 1 with the window; JAX's in interpret mode): 40 greedy
    tokens equal.

``ckpt/`` is left out of the copy the card's runs get, so this test is for
the CPU only.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mustafar_tpu import config as jc
from mustafar_tpu.cache import make_cache as j_make_cache
from mustafar_tpu.harness import tinylm as jtl
from mustafar_tpu.models import llama as jl
from mustafar_tpu.runtime.generate import Generator as JGenerator
from mustafar_tpu_torch import config as tc
from mustafar_tpu_torch.cache import make_cache as t_make_cache
from mustafar_tpu_torch.models import llama as tl
from mustafar_tpu_torch.runtime.generate import Generator as TGenerator
from mustafar_tpu_torch.weights import load_ckpt

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "ckpt", "tiny-acc-sw512")
T, BUCKET, STEPS = 800, 1024, 16


def _prompt():
    with open(os.path.join(ROOT, "mustafar_tpu", "harness", "tinylm.py"), "rb") as f:
        return np.frombuffer(f.read(T), np.uint8).astype(np.int64)[None]


def _engine(mod, cfg, mode, codec="q8q4"):
    return mod.EngineConfig(
        model=cfg, cache_mode=getattr(mod.CacheMode, mode), codec=codec,
        prune=mod.PruneConfig(method=mod.PruneMethod.KT_MAG_VT_MAG, k_sparsity=0.7,
                              v_sparsity=0.7),
        max_seq_len=BUCKET + 64, prefill_bucket=256, chunk_size=256)


@pytest.fixture(scope="module")
def ckpt():
    if not os.path.isdir(CKPT):
        pytest.fail(f"{CKPT} is missing: the repository's checkpoints are its data")
    jcfg, jp = jtl.load_ckpt(CKPT)
    tcfg, tp = load_ckpt(CKPT, device="cpu")
    assert tcfg.sliding_window == jcfg.sliding_window == 512 and tcfg.head_dim == 128
    return jcfg, jp, tcfg, tp


def test_dense_logits_match_jax(ckpt):
    jcfg, jp, tcfg, tp = ckpt
    jimpl = j_make_cache(_engine(jc, jcfg, "DENSE"))
    timpl = t_make_cache(_engine(tc, tcfg, "DENSE"), device="cpu")
    toks = np.zeros((1, BUCKET), np.int64)
    toks[:, :T] = _prompt()
    jlog, jcache = jl.prefill(jcfg, jp, jnp.asarray(toks, jnp.int32),
                              jimpl.init(1, jnp.float32), jimpl, jnp.int32(T))
    with torch.inference_mode():
        tlog, tcache = tl.prefill(tcfg, tp, torch.from_numpy(toks),
                                  timpl.init(1, torch.float32), timpl, T)
    logs = [(np.asarray(jlog)[:, :T], tlog.numpy()[:, :T])]
    jstep = jax.jit(lambda p, t, c, pos: jl.decode_step(jcfg, p, t, c, jimpl, pos))
    tok = np.asarray(jlog)[:, T - 1].argmax(-1)
    for pos in range(T, T + STEPS):
        jlog, jcache = jstep(jp, jnp.asarray(tok[:, None], jnp.int32), jcache,
                             jnp.int32(pos))
        with torch.inference_mode():
            tlog, tcache = tl.decode_step(tcfg, tp, torch.from_numpy(tok[:, None]), tcache,
                                          timpl, pos)
        logs.append((np.asarray(jlog), tlog.numpy()))
        tok = np.asarray(jlog)[:, 0].argmax(-1)
    for jo, to in logs:
        assert to.shape == jo.shape
        np.testing.assert_allclose(to, jo, rtol=0, atol=1e-5 * (jo.max() - jo.min()))


def test_q8q4_tokens_match_jax(ckpt):
    jcfg, jp, tcfg, tp = ckpt
    jgen = JGenerator(_engine(jc, jcfg, "COMPRESSED"), jp, dtype=jnp.float32)
    jgen.cache_impl.use_pallas = True
    want = np.asarray(jgen.generate(_prompt(), 40)[0])
    tgen = TGenerator(_engine(tc, tcfg, "COMPRESSED"), tp, dtype=torch.float32, device="cpu")
    got = tgen.generate(_prompt(), 40)[0]
    assert tgen.last_cache["nc_host"] == 3
    np.testing.assert_array_equal(got, want)
