"""Port parity, pipeline parallelism (``parallel/pipeline.py``) against the
JAX package's GPipe schedule (``pp_prefill`` / ``pp_decode_step``) on the
CPU, within 2e-4 (the tolerance of ``tests/test_pipeline.py``).

One spawn of four ranks over gloo (a ("stage", "model") mesh of 2 x 2) runs
every port case while JAX's references compile (each a prefill jit and a
decode jit on its stage mesh):

  * the dense cache at 4 stages (every rank a stage) and 1, 2 and 4
    microbatches;
  * the masked cache (KT_MAG_VT_MAG 0.5) at 4 stages, 2 microbatches;
  * PP x TP at (2, 2): each stage's layers cut over "model";
  * a partial true_len (70 of 96) at 2 stages, 0.7 (each "model" index a
    pipeline of its own);
  * Mixtral's MLP (4 experts, top-2, capacity factor 1) at 2 stages and 2
    microbatches: each microbatch's 128 prompt tokens are routed alone and
    overflow their experts' 64 slots, as JAX's schedule routes them; the
    whole batch routed at once (the port on one device) differs.
Every rank holds the same logits.
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
from mustafar_tpu.parallel import pipeline as jpp
from mustafar_tpu_torch import config as tc
from mustafar_tpu_torch.cache import make_cache as t_make_cache
from mustafar_tpu_torch.models import llama as tl
from mustafar_tpu_torch.parallel import distributed as dist_rt
from mustafar_tpu_torch.parallel import pipeline as pp

torch.set_num_threads(1)
SPAWN_TIMEOUT_S = 240
TOL = 2e-4

MODEL = dict(name="pp-test", vocab_size=256, hidden_size=128, intermediate_size=256,
             num_layers=4, num_heads=4, num_kv_heads=2, head_dim=32,
             max_position_embeddings=512)
MOE = dict(MODEL, name="pp-moe", num_experts=4, num_experts_per_tok=2,
           expert_capacity_factor=1.0)

# name: (model, cache mode, sparsity, B, true_len, decode steps, stages, tp,
#        microbatches)
CASES = {
    "dense_m1": (MODEL, "DENSE", 0.0, 4, 96, 3, 4, 1, 1),
    "dense_m2": (MODEL, "DENSE", 0.0, 4, 96, 3, 4, 1, 2),
    "dense_m4": (MODEL, "DENSE", 0.0, 4, 96, 3, 4, 1, 4),
    "masked": (MODEL, "MASKED", 0.5, 4, 96, 4, 4, 1, 2),
    "pp_x_tp": (MODEL, "MASKED", 0.5, 4, 96, 3, 2, 2, 2),
    "partial": (MODEL, "MASKED", 0.7, 2, 70, 2, 2, 1, 2),
    "moe": (MOE, "DENSE", 0.0, 4, 64, 3, 2, 1, 2),
}


def _engines(name):
    model, mode, sparsity = CASES[name][:3]
    return [mod.EngineConfig(
        model=mod.ModelConfig(**model), cache_mode=getattr(mod.CacheMode, mode),
        prune=mod.PruneConfig(method=mod.PruneMethod.KT_MAG_VT_MAG, k_sparsity=sparsity,
                              v_sparsity=sparsity),
        max_seq_len=160) for mod in (jc, tc)]


def _tokens(name):
    B, T = CASES[name][3], 96 if CASES[name][4] != 64 else 64
    return np.random.RandomState(len(name)).randint(0, 256, (B, T))


def _params_np(name):
    """numpy's draw in the JAX package's structure and scales
    (``distributed.init_params_np``; JAX's eager init costs seconds)."""
    return dist_rt.init_params_np(_engines(name)[1].model, 11)


def _jax_pp(name):
    """JAX's schedule: ``pp_prefill`` then greedy ``pp_decode_step``s on the
    case's stage mesh (a prefill jit and a decode jit)."""
    jeng, _ = _engines(name)
    cfg = jeng.model
    *_, true_len, steps, S, tp, M = CASES[name]
    impl = j_make_cache(jeng)
    mesh = jpp.stage_mesh(S, tp=tp)
    tokens = _tokens(name)
    params = jax.tree.map(jnp.asarray, _params_np(name))
    cache = impl.init(tokens.shape[0], jnp.float32)
    params, cache = (jpp.shard_pp(params, cache, mesh, cfg=cfg, engine=jeng) if tp > 1
                     else jpp.shard_pp(params, cache, mesh))
    prefill = jax.jit(lambda p, t, c: jpp.pp_prefill(cfg, p, t, c, impl, jnp.int32(true_len),
                                                     mesh, n_micro=M))
    decode = jax.jit(lambda p, t, c, pos: jpp.pp_decode_step(cfg, p, t, c, impl, pos, mesh,
                                                             n_micro=M))
    logits, cache = prefill(params, jnp.asarray(tokens), cache)
    outs = [np.asarray(logits[:, 0])]
    for i in range(steps):
        tok = jnp.argmax(jnp.asarray(outs[-1]), -1).astype(jnp.int32)[:, None]
        logits, cache = decode(params, tok, cache, jnp.int32(true_len + i))
        outs.append(np.asarray(logits[:, 0]))
    return outs


def _port_case(name):
    _, teng = _engines(name)
    *_, true_len, steps, S, tp, M = CASES[name]
    return dict(engine=teng, params=_params_np(name), tokens=_tokens(name),
                true_len=true_len, decode_steps=steps, n_micro=M, device="cpu",
                use_tp=tp > 1, world_stages=S == 4)


def _one_device(name):
    """The port on one device (``llama.prefill`` / ``decode_step``)."""
    _, teng = _engines(name)
    cfg = teng.model
    *_, true_len, steps, _, _, _ = CASES[name]
    params = dist_rt.carry_params(_params_np(name), "cpu")
    tokens = torch.as_tensor(_tokens(name))
    impl = t_make_cache(teng, device="cpu")
    cache = impl.init(tokens.shape[0], torch.float32)
    with torch.inference_mode():
        logits, cache = tl.prefill(cfg, params, tokens, cache, impl, true_len, last_only=True)
        outs = [logits[:, 0].numpy()]
        for i in range(steps):
            tok = logits[:, 0].argmax(-1)[:, None]
            logits, cache = tl.decode_step(cfg, params, tok, cache, impl, true_len + i)
            outs.append(logits[:, 0].numpy())
    return outs


@pytest.fixture(scope="module")
def runs():
    with ThreadPoolExecutor(4) as ex:
        spawned = ex.submit(dist_rt.spawn, "mustafar_tpu_torch.parallel.pipeline:pp_cases",
                            2, 2, {"cases": [_port_case(n) for n in CASES]}, device="cpu",
                            timeout_s=SPAWN_TIMEOUT_S, axes=pp.STAGE_AXES)
        want = {name: ex.submit(_jax_pp, name) for name in CASES}
        want = {name: f.result() for name, f in want.items()}
        got = spawned.result()
    return want, {name: [r[i] for r in got] for i, name in enumerate(CASES)}


@pytest.mark.parametrize("name", list(CASES))
def test_pp_matches_jax_schedule(runs, name):
    want, got = runs
    stages = {out["stage"] for out in got[name]}
    assert stages == set(range(CASES[name][6])), stages
    for rank, out in enumerate(got[name]):
        port = [out["prefill"]] + out["decode"]
        assert len(port) == len(want[name])
        for step, (p, w) in enumerate(zip(port, want[name])):
            np.testing.assert_allclose(p, w, rtol=TOL, atol=TOL,
                                       err_msg=f"{name} rank {rank} step {step}")
        np.testing.assert_array_equal(out["prefill"], got[name][0]["prefill"])
    if name == "moe":
        # the microbatches dropped tokens that the whole batch has room for
        one = _one_device(name)
        assert not np.allclose(one[0], want[name][0], atol=1e-3)


def test_stage_plan_splits_layers_and_refuses_uneven():
    cfg = tc.ModelConfig(**MODEL)
    params = dist_rt.carry_params(dist_rt.init_params_np(cfg, 0), "cpu")
    parts = [pp.stage_params(cfg, params, 2, s) for s in range(2)]
    for name, leaf in params["layers"].items():
        assert torch.equal(torch.cat([p["layers"][name] for p in parts]), leaf), name
    assert "embed" in parts[0] and "embed" not in parts[1]
    assert "lm_head" in parts[1] and "lm_head" not in parts[0]
    _, teng = _engines("dense_m1")
    assert pp.stage_engine(teng, 2, 2).model.num_layers == 2
    assert pp.stage_engine(teng, 2, 2).model.num_kv_heads == 1
    with pytest.raises(ValueError, match="divide the 4 layers"):
        pp.stage_bounds(4, 3, 0)
    tied = dataclasses.replace(cfg, tie_word_embeddings=True)
    assert "embed" in pp.stage_params(tied, {k: v for k, v in params.items()
                                             if k != "lm_head"}, 2, 1)
