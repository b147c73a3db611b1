"""Port parity, the masked cache (``mustafar_tpu_torch/cache/dense.py``
``MaskedKVCache``, the ``EngineConfig`` default) and the pruning matrix.

(a) ``make_cache`` with the default cache mode gives the masked cache.
(b) Prefill and decode state against the JAX package's ``MaskedKVCache``
    (per-layer protocol) for all eight ``PruneMethod`` s, uniform and per
    slot (an idle slot at -1 in some steps), in f32 so that only summation
    order differs: K and V (the keep masks) bit for bit, the Opa score
    rings within 1e-5 relative, the outputs within 1e-5.
(c) Kernel 4's final (m, l) (``return_norm``): the plain versions (TPU order
    and the CUDA kernel's split order) against the JAX kernel in interpret
    mode, and the probabilities they rebuild against a softmax.
(d) The Opa methods' kernel route (``use_pallas``: kernel 4 with
    ``return_norm``, then ``_window_probs``) against the JAX package's in
    interpret mode: outputs within the bf16 tolerance of the kernel, masks
    bit for bit, rings within 1e-5.
(e) Greedy tokens of ``Generator`` and of ``ContinuousBatchingEngine`` (f32)
    equal the JAX package's for all eight methods.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mustafar_tpu import config as jc
from mustafar_tpu.cache.dense import MaskedKVCache as JMasked
from mustafar_tpu.models.llama import init_params as j_init_params
from mustafar_tpu.ops.kernels.dense_decode import flash_decode_attention as j_flash
from mustafar_tpu.runtime.generate import Generator as JGenerator
from mustafar_tpu.runtime.scheduler import ContinuousBatchingEngine as JEngine
from mustafar_tpu_torch import config as tc
from mustafar_tpu_torch.cache import MaskedKVCache, make_cache
from mustafar_tpu_torch.ops.kernels import dense_decode as tdd
from mustafar_tpu_torch.runtime.generate import Generator as TGenerator
from mustafar_tpu_torch.runtime.scheduler import ContinuousBatchingEngine as TEngine
from mustafar_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)

METHODS = ["DENSE", "KT_MAG_VT_MAG", "KT_MAG_VC_MAG", "KT_MAG_VT_OPA", "KT_OPA_VT_MAG",
           "KT_MAG_VC_OPA", "THINK", "THINV"]


def _cache_engine(mod, method, head_dim=32, r=8, gs=8):
    model = dataclasses.replace(mod.TINY_LLAMA, head_dim=head_dim, num_heads=4,
                                num_kv_heads=2, hidden_size=128, num_layers=1)
    return mod.EngineConfig(
        model=model, prune=mod.PruneConfig(method=getattr(mod.PruneMethod, method),
                                           k_sparsity=0.5, v_sparsity=0.5,
                                           residual_length=r, group_size=gs),
        max_seq_len=96)


def test_make_cache_default_is_masked():
    eng = tc.EngineConfig()
    assert eng.cache_mode == tc.CacheMode.MASKED
    impl = make_cache(eng, device="cpu")
    assert isinstance(impl, MaskedKVCache)
    # the Opa methods carry score rings of the residual window, as in JAX
    for method in METHODS:
        jeng, teng = _cache_engine(jc, method), _cache_engine(tc, method)
        shapes = {k: tuple(v.shape) for k, v in
                  make_cache(teng, device="cpu").init(2, torch.float32).items()}
        jshapes = {k: tuple(v.shape) for k, v in JMasked(jeng).init(2, jnp.float32).items()}
        assert shapes == jshapes, method


def _qkv(rs, B, T, D, scale=(1.0, 1.0, 1.0)):
    return (rs.randn(B, T, 4, D).astype(np.float32) * scale[0],
            rs.randn(B, T, 2, D).astype(np.float32) * scale[1],
            rs.randn(B, T, 2, D).astype(np.float32) * scale[2])


def _assert_state(tstate, lc, live, tag, rtol=1e-5):
    for key, jv in lc.items():
        a, b = np.asarray(jv)[live], tstate[key][0].numpy()[live]
        if key in ("k", "v"):
            # an idle slot's write goes nowhere here; JAX wraps it to row S-1
            a, b = a[:, :-1], b[:, :-1]
            np.testing.assert_array_equal(b, a, err_msg=f"{tag} {key}")
        else:
            np.testing.assert_allclose(b, a, rtol=rtol, atol=1e-7, err_msg=f"{tag} {key}")


def _drive(method, per_slot, use_pallas, head_dim, steps, scale=(1.0, 1.0, 1.0)):
    jimpl = JMasked(_cache_engine(jc, method, head_dim), use_pallas=use_pallas,
                    stacked_decode=False)
    timpl = MaskedKVCache(_cache_engine(tc, method, head_dim), use_pallas=use_pallas,
                          device="cpu")
    rs = np.random.RandomState(0)
    B, T, true_len = 2, 48, 37
    q, k, v = _qkv(rs, B, T, head_dim, scale)
    lc = {key: val[0] for key, val in jimpl.init(B, jnp.float32).items()}
    # the JAX cache's steps under jit: each compiles once (its kernel's
    # interpretation with it), where an eager call interprets op by op
    prefill_attend, decode_attend = (jax.jit(fn) for fn in (jimpl.prefill_attend,
                                                            jimpl.decode_attend))
    _, lc = prefill_attend(lc, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.int32(true_len))
    st = timpl.init(B, torch.float32)
    timpl.prefill_attend(st, 0, torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), true_len)
    _assert_state(st, lc, np.ones(B, bool), f"{method} prefill")
    tol = 2e-2 if use_pallas else 1e-5
    for step in range(steps):
        pos = true_len + step
        qd, kd, vd = _qkv(rs, B, 1, head_dim, scale)
        if per_slot:
            pv = np.array([pos, pos - 3 if step % 4 else -1], np.int32)
            jo, lc = decode_attend(lc, jnp.asarray(qd), jnp.asarray(kd), jnp.asarray(vd),
                                   jnp.asarray(pv))
            to = timpl.decode_attend(st, 0, torch.from_numpy(qd), torch.from_numpy(kd),
                                     torch.from_numpy(vd), torch.from_numpy(pv).long())
            live = pv >= 0
        else:
            jo, lc = decode_attend(lc, jnp.asarray(qd), jnp.asarray(kd), jnp.asarray(vd),
                                   jnp.int32(pos))
            to = timpl.decode_attend(st, 0, torch.from_numpy(qd), torch.from_numpy(kd),
                                     torch.from_numpy(vd), pos)
            live = np.ones(B, bool)
        np.testing.assert_allclose(to.numpy()[live], np.asarray(jo)[live], rtol=0,
                                   atol=tol, err_msg=f"{method} step {step}")
        _assert_state(st, lc, live, f"{method} step {step}")


@pytest.mark.parametrize("per_slot", [False, True], ids=["uniform", "per_slot"])
@pytest.mark.parametrize("method", METHODS)
def test_state_matches_jax(method, per_slot):
    """20 decode steps from a 37-token prompt at r = group = 8: the window's
    exits cross two group boundaries (channel policies) and every ring slot
    turns over."""
    _drive(method, per_slot, False, 32, 20)


def test_kernel4_plain_norm_matches_jax():
    """(m, l) of the plain versions against the JAX kernel's return_norm, and
    exp(s - m) / l against a softmax (tests/test_dense_decode.py's case)."""
    rs = np.random.RandomState(2)
    B, S, Hkv, G, D = 2, 256, 2, 2, 128
    k = rs.randn(B, S, Hkv, D).astype(np.float32)
    v = rs.randn(B, S, Hkv, D).astype(np.float32)
    q = rs.randn(B, 1, Hkv * G, D).astype(np.float32)
    for pos in ([200, 130], [255, -1], 77):
        jpos = jnp.asarray(pos, jnp.int32)
        jo, jm, jl = j_flash(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k), jnp.asarray(v),
                             jpos, return_norm=True)
        tq = torch.from_numpy(q).to(torch.bfloat16)
        tpos = torch.tensor(pos, dtype=torch.int32) if isinstance(pos, list) else pos
        to, tm, tl = tdd.flash_decode_attention(tq, torch.from_numpy(k), torch.from_numpy(v),
                                                tpos, return_norm=True)
        assert tm.shape == tl.shape == (B, Hkv, G, 1)
        pv = np.broadcast_to(np.asarray(pos), (B,))
        live = pv >= 0
        # the TPU's steps: the largest score (f32 dot products summed in
        # another order: within an ulp or two), l its f32 sum
        np.testing.assert_allclose(tm.numpy()[live], np.asarray(jm)[live], rtol=1e-6)
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], rtol=1e-5)
        # the split order: the same max, l summed split by split
        _, sm, sl = tdd.flash_decode_attention_split_plain(tq, torch.from_numpy(k),
                                                           torch.from_numpy(v), tpos,
                                                           return_norm=True)
        np.testing.assert_allclose(sm.numpy(), tm.numpy(), rtol=1e-6)
        np.testing.assert_allclose(sl.numpy(), tl.numpy(), rtol=1e-5)
        assert (tm.numpy()[~live] == -1e30).all() and (tl.numpy()[~live] == 0).all()
        # the kernel reads q and K as bf16
        qg, kb = (np.asarray(jnp.asarray(x, jnp.bfloat16)).astype(np.float32) for x in (q, k))
        s = np.einsum("bhgd,bshd->bhgs", qg[:, 0].reshape(B, Hkv, G, D), kb) / np.sqrt(D)
        for b in np.flatnonzero(live):
            cols = np.arange(pv[b] + 1)
            w = np.exp(s[b][..., cols] - s[b][..., cols].max(-1, keepdims=True))
            w /= w.sum(-1, keepdims=True)
            got = np.exp(s[b][..., cols] - tm.numpy()[b]) / tl.numpy()[b]
            np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("method,per_slot", [
    ("KT_MAG_VT_OPA", False), ("KT_MAG_VT_OPA", True), ("KT_MAG_VC_OPA", True),
    ("KT_OPA_VT_MAG", False)])
def test_opa_kernel_route_matches_jax(method, per_slot):
    """use_pallas: the JAX flash kernel in interpret mode with its (m, l),
    the port's kernel 4 plain version with return_norm; 10 steps."""
    _drive(method, per_slot, True, 128, 10, scale=(0.25, 0.25, 1.0))


def _gen_engine(mod, method, B=1, bucket=128):
    model = dataclasses.replace(mod.TINY_LLAMA, head_dim=128, num_heads=4,
                                num_kv_heads=1, hidden_size=256)
    return mod.EngineConfig(
        model=model, prune=mod.PruneConfig(method=getattr(mod.PruneMethod, method),
                                           k_sparsity=0.5, v_sparsity=0.5),
        max_seq_len=512, prefill_bucket=bucket, batch_size=B)


def _params(jeng, seed):
    return _model_params(jeng.model, seed)


@functools.cache
def _model_params(model, seed):
    """A model's weights from ``seed``, made once a module for every case
    that uses them (JAX's eager init takes seconds)."""
    jp = j_init_params(model, jax.random.PRNGKey(seed), dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("method", METHODS)
def test_generator_tokens_match_jax(method):
    """Prompt 100 (bucket 128), 40 new tokens: exits from index 68 on, a
    channel group boundary at 95 and at 127."""
    jeng, teng = _gen_engine(jc, method), _gen_engine(tc, method)
    assert teng.cache_mode == tc.CacheMode.MASKED
    jp, tp = _params(jeng, 0)
    prompt = np.random.RandomState(1).randint(0, 512, size=(2, 100))
    want = np.stack([np.asarray(r) for r in
                     JGenerator(jeng, jp, dtype=jnp.float32).generate(prompt, 40)])
    gen = TGenerator(teng, tp, dtype=torch.float32, device="cpu")
    got = np.stack(gen.generate(prompt, 40))
    assert isinstance(gen.cache_impl, MaskedKVCache)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", METHODS)
def test_engine_tokens_match_jax(method):
    """Three requests over two slots (one waits for a retired slot, which
    idles at -1 meanwhile), each prompt prefilled alone (blocking
    admission), per-slot decode over the masked cache and its rings."""
    jeng, teng = _gen_engine(jc, method, B=2), _gen_engine(tc, method, B=2)
    jp, tp = _params(jeng, 3)
    rs = np.random.RandomState(4)
    reqs = [(rs.randint(0, 512, size=n), m) for n, m in ((60, 30), (100, 8), (40, 20))]
    jcb = JEngine(jeng, jp, dtype=jnp.float32, use_native=False)
    for p, m in reqs:
        jcb.submit(p, m)
    want = jcb.run()
    tcb = TEngine(teng, tp, dtype=torch.float32, device="cpu")
    for p, m in reqs:
        tcb.submit(p, m)
    got = tcb.run()
    assert isinstance(tcb.impl, MaskedKVCache) and not tcb.interleave
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]), err_msg=str(uid))
