"""Port parity, sequence-parallel (ring) prefill (``parallel/ring.py``)
against the JAX package's ``parallel/ring.py`` on the CPU.

One spawn of four ranks over gloo (a ("data", "model") mesh of 2 x 2) runs
every port case while the JAX references compile:

(r) The ring primitive over all four ranks (a sequence-only ring, Ts = T/4)
    against JAX's ``ring_prefill_attention`` on the 4 x 2 host mesh: causal
    at true_len 256 and 193, a sliding window of 96, and T = 512 against
    the 8-way sequence-only mesh; 2e-5, the tolerance of
    ``tests/test_ring.py``.
(s) ``sp_prefill`` then 3 greedy decode steps (the handed-over cache) at
    sp=2 x tp=2 and at sp=2 (heads whole, each "model" index a replica)
    against JAX's ``sp_prefill`` flow on the 2 x 2 host mesh, 5e-4: the
    masked cache under KT_MAG_VT_MAG, ThinK (the last rows of the bucket and
    mean(k**2) over every block), KT_MAG_VC_MAG (groups of 32 inside a
    block), KT_MAG_VC_OPA (the last queries' softmax over every block) and
    KT_OPA_VT_MAG (mean |q| over every block), at a partial true_len too;
    the dense cache with a sliding window of 128.  Every rank holds the
    same logits.
(o) One rank without a mesh: every position's logits and the cache equal
    ``llama.prefill``'s (2e-5).
(c) The compressed cache and a MoE model are refused.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mustafar_tpu import config as jc
from mustafar_tpu.cache import make_cache as j_make_cache
from mustafar_tpu.models import llama as jl
from mustafar_tpu.parallel import ring as jring
from mustafar_tpu.parallel import sharding as jsh
from mustafar_tpu_torch import config as tc
from mustafar_tpu_torch.cache import make_cache as t_make_cache
from mustafar_tpu_torch.parallel import distributed as dist_rt
from mustafar_tpu_torch.parallel import ring

torch.set_num_threads(1)
SPAWN_TIMEOUT_S = 240
RING_TOL = 2e-5
SP_TOL = 5e-4

MODEL = dict(name="ring-test", vocab_size=256, hidden_size=128, intermediate_size=256,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
             max_position_embeddings=1024)

# name: (T, true_len, window, mesh (dp, tp) of JAX's reference)
RING_CASES = {"causal_256": (256, 256, None, (4, 2)), "causal_193": (256, 193, None, (4, 2)),
              "window_96": (256, 256, 96, (4, 2)), "seq_only_512": (512, 512, None, (8, 1))}
# name: (cache mode, method, true_len, window, use_tp)
SP_CASES = {
    "mag": ("MASKED", "KT_MAG_VT_MAG", 256, None, True),
    "think": ("MASKED", "THINK", 256, None, True),
    "vc_mag": ("MASKED", "KT_MAG_VC_MAG", 256, None, True),
    "vc_opa": ("MASKED", "KT_MAG_VC_OPA", 256, None, True),
    "vc_opa_partial": ("MASKED", "KT_MAG_VC_OPA", 200, None, False),
    "k_opa_partial": ("MASKED", "KT_OPA_VT_MAG", 200, None, True),
    "dense_window": ("DENSE", "KT_MAG_VT_MAG", 256, 128, True),
}


def _qkv(seed, T):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return [np.asarray(jax.random.normal(kk, (2, T, h, 32), jnp.float32))
            for kk, h in zip(ks, (4, 2, 2))]


def _jax_ring(name):
    T, true_len, window, (dp, tp) = RING_CASES[name]
    q, k, v = _qkv(T, T)
    mesh = jsh.make_mesh(dp=dp, tp=tp)
    fn = jax.jit(lambda q, k, v, tl: jring.ring_prefill_attention(q, k, v, tl, mesh,
                                                                  window=window))
    return np.asarray(fn(q, k, v, jnp.int32(true_len)))


def _engines(name):
    mode, method, _, window, _ = SP_CASES[name]
    out = []
    for mod in (jc, tc):
        cfg = mod.ModelConfig(**dict(MODEL, sliding_window=window))
        sparsity = 0.0 if mode == "DENSE" else 0.5
        out.append(mod.EngineConfig(
            model=cfg, cache_mode=getattr(mod.CacheMode, mode),
            prune=mod.PruneConfig(method=getattr(mod.PruneMethod, method),
                                  k_sparsity=sparsity, v_sparsity=sparsity),
            max_seq_len=320))
    return out


def _tokens(name):
    return np.random.RandomState(len(name)).randint(0, 256, (4, 256))


def _params_np(name):
    """The case's f32 weights: numpy's draw in the JAX package's structure
    and scales (``distributed.init_params_np``; JAX's eager init costs
    seconds a model)."""
    return dist_rt.init_params_np(_engines(name)[1].model, 3)


def _jax_sp(name, steps=3):
    """JAX's flow of ``tests/test_ring.py``: ``sp_prefill`` on the 2 x 2
    mesh, then greedy ``decode_step``s on the handed-over cache (each a jit
    of its own: the decode step compiles once)."""
    jeng, _ = _engines(name)
    cfg = jeng.model
    true_len = SP_CASES[name][2]
    impl = j_make_cache(jeng)
    mesh = jsh.make_mesh(dp=2, tp=2)
    params = jax.tree.map(jnp.asarray, _params_np(name))
    params = jsh.shard_pytree(params, jsh.filter_specs_for(params, jsh.param_specs(cfg)),
                              mesh)
    tokens = jnp.asarray(_tokens(name))
    prefill = jax.jit(lambda p, t, c: jring.sp_prefill(cfg, p, t, c, impl,
                                                       jnp.int32(true_len), mesh,
                                                       last_only=True))
    decode = jax.jit(lambda p, t, c, pos: jl.decode_step(cfg, p, t, c, impl, pos))
    logits, cache = prefill(params, tokens, impl.init(4, jnp.float32))
    outs = [np.asarray(logits[:, -1])]
    for i in range(steps):
        tok = jnp.argmax(jnp.asarray(outs[-1]), -1).astype(jnp.int32)[:, None]
        logits, cache = decode(params, tok, cache, jnp.int32(true_len + i))
        outs.append(np.asarray(logits[:, 0]))
    return outs


@pytest.fixture(scope="module")
def runs():
    """JAX's references (four threads) while one spawn of four ranks runs
    every port case."""
    cases = []
    for name in RING_CASES:
        T, true_len, window, _ = RING_CASES[name]
        q, k, v = _qkv(T, T)
        cases.append({"ring": dict(q=q, k=k, v=v, true_len=true_len, window=window)})
    for name, (_, _, true_len, _, use_tp) in SP_CASES.items():
        cases.append(dict(engine=_engines(name)[1], params=_params_np(name),
                          tokens=_tokens(name), true_len=true_len, device="cpu",
                          use_tp=use_tp))
    with ThreadPoolExecutor(4) as ex:
        spawned = ex.submit(dist_rt.spawn, "mustafar_tpu_torch.parallel.ring:sp_cases",
                            2, 2, {"cases": cases}, device="cpu",
                            timeout_s=SPAWN_TIMEOUT_S)
        want = {name: ex.submit(_jax_ring, name) for name in RING_CASES}
        want.update({name: ex.submit(_jax_sp, name) for name in SP_CASES})
        want = {name: f.result() for name, f in want.items()}
        got = spawned.result()
    names = list(RING_CASES) + list(SP_CASES)
    return want, {name: [r[i] for r in got] for i, name in enumerate(names)}


@pytest.mark.parametrize("name", list(RING_CASES))
def test_ring_attention_matches_jax(runs, name):
    want, got = runs
    true_len = RING_CASES[name][1]
    for rank, out in enumerate(got[name]):
        np.testing.assert_allclose(out[:, :true_len], want[name][:, :true_len],
                                   rtol=RING_TOL, atol=RING_TOL,
                                   err_msg=f"{name} rank {rank}")


@pytest.mark.parametrize("name", list(SP_CASES))
def test_sp_prefill_then_decode_matches_jax(runs, name):
    want, got = runs
    for rank, out in enumerate(got[name]):
        port = [out["prefill"]] + out["decode"]
        assert len(port) == len(want[name])
        for step, (p, w) in enumerate(zip(port, want[name])):
            np.testing.assert_allclose(p, w, rtol=SP_TOL, atol=SP_TOL,
                                       err_msg=f"{name} rank {rank} step {step}")
        np.testing.assert_array_equal(out["prefill"], got[name][0]["prefill"])


def test_sp_prefill_refuses_compressed_cache_and_moe():
    _, teng = _engines("mag")
    comp = dataclasses.replace(teng, cache_mode=tc.CacheMode.COMPRESSED,
                               model=dataclasses.replace(teng.model, head_dim=128))
    impl = t_make_cache(comp, device="cpu")
    tokens = np.zeros((2, 256), np.int64)
    one = ring.seq_shard(None)
    with pytest.raises(ValueError, match="compressed cache"):
        ring.sp_prefill(comp.model, {}, tokens, {}, impl, 256, one)
    moe = dataclasses.replace(teng, model=dataclasses.replace(teng.model, num_experts=4))
    with pytest.raises(ValueError, match="MoE"):
        ring.sp_prefill(moe.model, {}, tokens, {}, t_make_cache(moe, device="cpu"), 256, one)


def test_sp_prefill_one_rank_full_logits_match_prefill():
    """One rank (no mesh): ``sp_prefill`` without ``last_only`` gives every
    position's logits and the cache of ``llama.prefill`` (ThinK: the
    statistics over the whole prompt)."""
    from mustafar_tpu_torch.models import llama as tl
    _, teng = _engines("think")
    cfg = teng.model
    params = dist_rt.carry_params(_params_np("think"), "cpu")
    tokens = _tokens("think")[:, :128]
    got, want = (t_make_cache(teng, device="cpu") for _ in range(2))
    cg, cw = got.init(4, torch.float32), want.init(4, torch.float32)
    with torch.inference_mode():
        lg, cg = ring.sp_prefill(cfg, params, tokens, cg, got, 120, ring.seq_shard(None))
        lw, cw = tl.prefill(cfg, params, torch.as_tensor(tokens), cw, want, 120)
    assert lg.shape == (4, 128, cfg.vocab_size)
    np.testing.assert_allclose(lg.numpy(), lw.numpy(), rtol=RING_TOL, atol=RING_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(cg[key].numpy(), cw[key].numpy(), rtol=RING_TOL,
                                   atol=RING_TOL)
