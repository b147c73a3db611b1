"""Port parity, output-aware (Opa) pruning in the compressed cache
(``test_torch_opa_kernels.py`` holds the kernel options it reads).

(c) The compressed cache under KT_OPA_VT_MAG and KT_MAG_VT_OPA, all five
    codecs, against the JAX package's with its kernels in interpret mode:
    the pool after prefill bit for bit, the decode step's scores within
    1e-5, the pool after a compaction bit for bit given JAX's own scores
    (float order alone could flip a near-tie of the accumulated scores),
    the scores shifted with the window; greedy tokens of the ``Generator``
    across a compaction equal JAX's (teacher forcing, as
    ``test_torch_generate.py``).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mustafar_tpu import config as jc
from mustafar_tpu.cache.compressed import CompressedKVCache as JCompressed
from mustafar_tpu.models.llama import init_params as j_init_params
from mustafar_tpu.runtime.generate import Generator as JGenerator
from mustafar_tpu_torch import config as tc
from mustafar_tpu_torch.cache.compressed import CompressedKVCache as TCompressed
from mustafar_tpu_torch.models import llama as tl
from mustafar_tpu_torch.runtime.generate import Generator as TGenerator
from mustafar_tpu_torch.weights import params_from_jax

torch.set_num_threads(2)

W = 288
CODECS = ("q8", "q8q4", "q4q4", "bitmap", "bitmap-q8")
NEW = 10            # new tokens of the Generator runs


def _engine(mod, method, codec, layers=1, max_seq=1024):
    model = dataclasses.replace(mod.TINY_LLAMA, head_dim=128, num_heads=4, num_kv_heads=1,
                                hidden_size=256, num_layers=layers)
    return mod.EngineConfig(
        model=model, cache_mode=mod.CacheMode.COMPRESSED,
        prune=mod.PruneConfig(method=getattr(mod.PruneMethod, method), k_sparsity=0.7,
                              v_sparsity=0.7),
        max_seq_len=max_seq, prefill_bucket=256, chunk_size=256, codec=codec)


def _np(x):
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _assert_state(tstate, lc, keys, tag, rtol=None):
    for key in keys:
        t = tstate[key][0]
        t = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        if rtol is None:
            np.testing.assert_array_equal(t, _np(lc[key]), err_msg=f"{tag} {key}")
        else:
            np.testing.assert_allclose(t, _np(lc[key]), rtol=rtol, atol=1e-7,
                                       err_msg=f"{tag} {key}")


@pytest.mark.parametrize("method", ["KT_OPA_VT_MAG", "KT_MAG_VT_OPA"])
@pytest.mark.parametrize("codec", CODECS)
def test_compressed_opa_state_matches_jax(method, codec):
    """Prefill of 543 tokens (one chunk packed by its prefill scores, a
    window of 287), one decode step (the window full, scores added), a
    compaction (the scores' first C columns pack the chunk, the rest shift):
    f32, one layer."""
    jimpl = JCompressed(_engine(jc, method, codec), use_pallas=True)
    timpl = TCompressed(_engine(tc, method, codec), device="cpu")
    score_keys = tuple(key for key in ("k_score", "v_score") if key in timpl.score_keys)
    assert score_keys == jimpl.score_keys and len(score_keys) == 1
    rs = np.random.RandomState(0)
    B, T, true_len = 2, 768, 543
    q = rs.randn(B, T, 4, 128).astype(np.float32) * 0.5
    k, v = (rs.randn(B, T, 1, 128).astype(np.float32) * 0.5 for _ in range(2))
    lc = {key: val[0] for key, val in jimpl.init(B, jnp.float32).items()}
    _, lc = jimpl.prefill_attend(lc, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.int32(true_len))
    st = timpl.init(B, torch.float32)
    timpl.prefill_attend(st, 0, torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                         true_len)
    keys = tuple(key for key in lc if key != "n_chunks")
    _assert_state(st, lc, keys, "prefill")
    qd = rs.randn(B, 1, 4, 128).astype(np.float32) * 0.5
    kd, vd = (rs.randn(B, 1, 1, 128).astype(np.float32) * 0.5 for _ in range(2))
    jo, lc = jimpl.decode_attend(lc, jnp.asarray(qd), jnp.asarray(kd), jnp.asarray(vd),
                                 jnp.int32(true_len))
    to = timpl.decode_attend(st, 0, torch.from_numpy(qd), torch.from_numpy(kd),
                             torch.from_numpy(vd), true_len)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-5)
    _assert_state(st, lc, score_keys, "decode", rtol=1e-5)
    sc = np.asarray(lc[score_keys[0]])
    assert (sc[:, :, :W] > 0).any() and (sc[:, :, W:] == 0).all()
    assert jimpl.needs_compact(true_len + 1) and timpl.window_full(st, true_len + 1)
    for key in score_keys:                          # JAX's own scores on both sides
        st[key][0] = torch.from_numpy(np.array(lc[key]))
    lc = jax.jit(jimpl.compact_layer)(lc)
    timpl.compact(st)
    _assert_state(st, lc, keys, "compaction")
    assert (st[score_keys[0]][0, :, :, W - 256:] == 0).all()


@pytest.mark.parametrize("method", ["KT_OPA_VT_MAG", "KT_MAG_VT_OPA"])
@pytest.mark.parametrize("codec", CODECS)
def test_compressed_opa_generator_matches_jax(method, codec):
    """Prompt 543 (a window of 287 after prefill), 10 new tokens: a
    compaction after the first decode step, two layers, f32; the JAX cache
    decodes through its kernels in interpret mode.  The port's picks, fed
    JAX's stream, equal JAX's tokens or tie with them within the bf16
    roundings' noise (1e-2), and the free streams part only after such a
    near-tie (on these seeds they agree throughout)."""
    jeng, teng = _engine(jc, method, codec, 2), _engine(tc, method, codec, 2)
    jp = j_init_params(jeng.model, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    prompt = np.random.RandomState(0).randint(0, 512, size=(2, 543))
    jgen = JGenerator(jeng, jp, dtype=jnp.float32)
    jgen.cache_impl.use_pallas = True
    want = np.stack([np.asarray(r) for r in jgen.generate(prompt, NEW)])
    gen = TGenerator(teng, tp, dtype=torch.float32, device="cpu")
    got = np.stack(gen.generate(prompt, NEW))
    assert gen.last_cache["nc_host"] == 2
    # teacher forcing on JAX's stream
    impl = gen.cache_impl
    toks = torch.zeros((2, 768), dtype=torch.int64)
    toks[:, :543] = torch.from_numpy(prompt)
    cache = impl.init(2, torch.float32)
    with torch.inference_mode():
        logits, cache = tl.prefill(teng.model, tp, toks, cache, impl, 543, last_only=True)
        out = [logits[:, 0]]
        for i in range(1, NEW):
            logits, cache = tl.decode_step(teng.model, tp,
                                           torch.from_numpy(want[:, i - 1:i]).long(), cache,
                                           impl, 543 + i - 1)
            out.append(logits[:, 0])
            if impl.window_full(cache, 543 + i):
                impl.compact(cache)
    lg = torch.stack(out, 1).numpy()
    gap = lg.max(-1) - np.take_along_axis(lg, want[..., None], -1)[..., 0]
    assert (gap <= 1e-2).all(), np.argwhere(gap > 1e-2).tolist()
    for row in range(2):
        ties = np.flatnonzero(lg[row].argmax(-1) != want[row])
        parted = np.flatnonzero(got[row] != want[row])
        assert (parted[0] if len(parted) else NEW) >= (ties[0] if len(ties) else NEW)
