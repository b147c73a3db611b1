"""Port parity, tensor and data parallelism (``parallel/sharding.py``)
against the JAX package's single-device model, on the CPU.

(f) Forward: prefill logits at the last position and greedy decode steps'
    logits of the port at dp=2 x tp=2 (four processes over gloo, one spawn
    for every case) against the JAX package's single-device ``prefill`` /
    ``decode_step`` on the same weights (``params_from_jax``), within 2e-4,
    the tolerance of ``tests/test_sharding.py``: the masked cache with f32,
    W8 and W4 weights, the compressed cache with the bitmap and q8q4 codecs
    (the port's plain kernel versions; JAX's plain decode), both Opa
    methods at q8q4 (the prompt packed by its prefill scores), and
    Mixtral's MLP (4 experts, top-2, capacity factor 1, f32 and W8 experts)
    with its experts over "model" (EP) and the batch over "data": the
    prefill drops tokens (JAX's logits with room for every token differ),
    so each rank must route the whole batch, as one device does.  The
    compressed cache's decode steps carry the port's own distance from JAX
    on one device: the port's kernels (and their plain versions) read q and
    the window as bf16 and round p to bf16 where JAX's plain decode keeps
    f32, and last-bit differences of the f32 activations flip bf16
    roundings (``tests/test_torch_model.py``): up to 6e-3 here (3.3e-3
    against JAX's kernels in interpret mode, which cost twice the compile
    time).  There the sharded run is held within 2e-4 of the single-device
    port's distance from JAX, which is itself held to the suite's tie
    tolerance for the compressed cache (1e-2 of the logits' range).  W8A8 is chaotic in the last bit
    (``tests/test_torch_w8a8.py`` (l)): the port on one device already parts
    from JAX by up to 3x JAX's own spread (JAX against JAX with every weight
    scale one ulp up), so the sharded run is held to that bound, and to the
    port's single-device run bit for bit (the row amax and the int32 sums
    are reduced exactly).  Every other sharded run is held to the port's
    single-device run within 2e-5 (the row-parallel sums reduce in another
    order), a compressed decode step within 2e-4 (the bf16 flips again; up to
    5.3e-5 here).
(c) The JAX ``cache_specs``, restated here (``_cache_plan``), covers every
    key of each cache's state, and a rank's local cache (B/dp slots, Hkv/tp
    kv heads, from ``local_engine``) has the shapes of its slice of the full
    one.
(p) The params plan: every rank's shards put back together are the full
    leaves; a fused layout shards as its parts do; what the JAX plan cannot
    cut evenly is refused.
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
from mustafar_tpu.cache.compressed import CompressedKVCache as JCompressed
from mustafar_tpu.models import llama as jl
from mustafar_tpu.models import quant as jq
from mustafar_tpu_torch import config as tc
from mustafar_tpu_torch.cache import make_cache as t_make_cache
from mustafar_tpu_torch.models import quant as tq
from mustafar_tpu_torch.parallel import distributed as dist_rt
from mustafar_tpu_torch.parallel import sharding as sh
from mustafar_tpu_torch.weights import params_from_jax
from tests.test_torch_scheduler import TIE_TOL

torch.set_num_threads(1)
TOL = 2e-4
SPAWN_TIMEOUT_S = 240

SMALL = dict(name="shard-test", vocab_size=256, hidden_size=128, intermediate_size=256,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
             max_position_embeddings=512)
# W4 cuts wo and w_down on 128-row block edges: 128 rows a rank at tp=2
W4_MODEL = dict(SMALL, name="shard-w4", num_heads=8)
WIDE = dict(SMALL, name="shard-comp", head_dim=128, hidden_size=512,
            intermediate_size=1024)
# Mixtral's MLP, 4 experts over "model": a capacity factor of 1 makes the
# prefill (the whole batch's 256 tokens, 128 slots an expert) drop tokens
MOE = dict(SMALL, name="shard-moe", num_experts=4, num_experts_per_tok=2,
           expert_capacity_factor=1.0)


def _cfgs(model: dict, mode: str, codec="bitmap", method="KT_MAG_VT_MAG", **eng):
    out = []
    for mod in (jc, tc):
        cfg = mod.ModelConfig(**model)
        out.append(mod.EngineConfig(
            model=cfg, cache_mode=getattr(mod.CacheMode, mode),
            prune=mod.PruneConfig(method=getattr(mod.PruneMethod, method),
                                  k_sparsity=0.5, v_sparsity=0.5),
            codec=codec, **eng))
    return out


def _masked(model=SMALL):
    return _cfgs(model, "MASKED", max_seq_len=128)


def _compressed(codec, method="KT_MAG_VT_MAG"):
    return _cfgs(WIDE, "COMPRESSED", codec, method, max_seq_len=1056,
                 prefill_bucket=512, chunk_size=256)


# name: (engines, weight format, prompt [B, T] seed and length, decode steps)
CASES = {
    "masked": (_masked(), None, (0, 64), 1),
    "w8": (_masked(), "w8", (0, 64), 1),
    "w4": (_masked(W4_MODEL), "w4", (0, 64), 1),
    "w8a8": (_masked(), "w8a8", (0, 64), 1),
    "bitmap": (_compressed("bitmap"), None, (1, 400), 1),
    "q8q4": (_compressed("q8q4"), None, (1, 400), 1),
    "opa_k": (_compressed("q8q4", "KT_OPA_VT_MAG"), None, (2, 400), 1),
    "opa_v": (_compressed("q8q4", "KT_MAG_VT_OPA"), None, (2, 400), 1),
    "moe": (_masked(MOE), None, (3, 64), 1),
    "moe_w8": (_masked(MOE), "w8", (3, 64), 1),
}
SEEDS = {"masked": 0, "w8": 0, "w4": 0, "w8a8": 0, "bitmap": 1, "q8q4": 1,
         "opa_k": 2, "opa_v": 2, "moe": 5, "moe_w8": 5}


def _jax_params(name, jeng):
    p = jl.init_params(jeng.model, jax.random.PRNGKey(SEEDS[name]), dtype=jnp.float32)
    fmt = CASES[name][1]
    if fmt == "w8":
        p = jq.quantize_params(p)
    elif fmt == "w4":
        p = jq.quantize_params_w4(p)
    elif fmt == "w8a8":
        p = jq.enable_act_quant(jq.quantize_params(p))
    return p


def _jax_run(jeng, params, tokens, steps):
    """JAX single-device prefill + greedy decode steps (plain attention)."""
    cfg = jeng.model
    impl = (JCompressed(jeng, use_pallas=False)
            if jeng.cache_mode == jc.CacheMode.COMPRESSED else j_make_cache(jeng))
    T = tokens.shape[1]

    def fn(params, tokens, cache):
        logits, cache = jl.prefill(cfg, params, tokens, cache, impl, jnp.int32(T))
        outs = [logits[:, T - 1]]
        tok = jnp.argmax(logits[:, T - 1], -1).astype(jnp.int32)[:, None]
        for i in range(steps):
            lg, cache = jl.decode_step(cfg, params, tok, cache, impl, jnp.int32(T + i))
            outs.append(lg[:, 0])
            tok = jnp.argmax(lg[:, 0], -1).astype(jnp.int32)[:, None]
        return outs

    out = jax.jit(fn)(params, jnp.asarray(tokens), impl.init(tokens.shape[0], jnp.float32))
    return [np.asarray(o) for o in out]


def _jax_case(name):
    """JAX's logits of a case (and, for W8A8, with every scale one ulp up;
    for a MoE, with room for every token)."""
    (jeng, _), fmt, (seed, T), steps = CASES[name]
    jp = _jax_params(name, jeng)
    tokens = np.random.RandomState(seed).randint(0, 256, (4, T))
    out = {name: _jax_run(jeng, jp, tokens, steps)}
    if fmt == "w8a8":
        out[name + "_ulp"] = _jax_run(jeng, _ulp_up(jp), tokens, steps)
    if jeng.model.num_experts:
        roomy = dataclasses.replace(jeng, model=dataclasses.replace(
            jeng.model, expert_capacity_factor=8.0))
        out[name + "_roomy"] = _jax_run(roomy, jp, tokens, steps)
    return out


@pytest.fixture(scope="module")
def runs():
    """Every case: JAX's single-device logits (compiled four at a time), the
    port's at dp=2 x tp=2 (one spawn of four ranks for all cases, running
    meanwhile) and the port's on one device."""
    cases, single = [], {}
    for name, ((jeng, teng), _, (seed, T), steps) in CASES.items():
        jp = _jax_params(name, jeng)
        tokens = np.random.RandomState(seed).randint(0, 256, (4, T))
        cases.append(dict(cfg=teng.model, engine=teng, params_np=jax.tree.map(np.asarray, jp),
                          tokens=tokens, decode_steps=steps, device="cpu"))
    with ThreadPoolExecutor(5) as ex:
        spawned = ex.submit(dist_rt.spawn, "mustafar_tpu_torch.parallel.distributed:"
                            "forward_cases", 2, 2, {"cases": cases}, device="cpu",
                            timeout_s=SPAWN_TIMEOUT_S)
        refs = [ex.submit(_jax_case, name) for name in CASES]
        for name, kw in zip(CASES, cases):
            single[name] = dist_rt.forward_case(None, **kw)
        want = {}
        for f in refs:
            want.update(f.result())
        got = spawned.result()
    return want, single, {name: [r[i] for r in got] for i, name in enumerate(CASES)}


def _ulp_up(jp):
    def up(leaves):
        return {k: jnp.nextafter(v, jnp.inf) if k.endswith("_scale") else v
                for k, v in leaves.items()}
    return dict(up({k: v for k, v in jp.items() if k != "layers"}), layers=up(jp["layers"]))


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("name", list(CASES))
def test_dp2_tp2_logits_match_jax(runs, name):
    want, single, got = runs
    if name + "_roomy" in want:
        # the prefill dropped tokens: without drops the logits differ
        assert not np.allclose(want[name + "_roomy"][0], want[name][0], atol=1e-3)
    for rank, out in enumerate(got[name]):
        port = [out["prefill"]] + out["decode"]
        assert len(port) == len(want[name])
        for step, (p, w) in enumerate(zip(port, want[name])):
            if name == "w8a8":
                spread = _rel(want[name + "_ulp"][step], w)
                assert 0 < spread < 5e-2
                assert _rel(p, w) <= 3 * spread, (step, _rel(p, w), spread)
            elif step and CASES[name][0][1].cache_mode == tc.CacheMode.COMPRESSED:
                own = np.abs(([single[name]["prefill"]] + single[name]["decode"])[step] - w)
                assert own.max() <= TIE_TOL["COMPRESSED"] * np.abs(w).max(), own.max()
                assert (np.abs(p - w) <= own + TOL).all(), (
                    f"{name} rank {rank} step {step}: "
                    f"{(np.abs(p - w) - own).max()} past the port's own distance")
            else:
                np.testing.assert_allclose(p, w, rtol=TOL, atol=TOL,
                                           err_msg=f"{name} rank {rank} step {step}")


@pytest.mark.parametrize("name", list(CASES))
def test_dp2_tp2_matches_one_device(runs, name):
    _, single, got = runs
    ref = [single[name]["prefill"]] + single[name]["decode"]
    compressed = CASES[name][0][1].cache_mode == tc.CacheMode.COMPRESSED
    for out in got[name]:
        for step, (p, w) in enumerate(zip([out["prefill"]] + out["decode"], ref)):
            if name == "w8a8":
                np.testing.assert_array_equal(p, w, err_msg=name)
            else:
                # a compressed decode step also carries bf16 flips (module note)
                tol = TOL if compressed and step else 2e-5
                np.testing.assert_allclose(p, w, rtol=tol, atol=tol, err_msg=name)
    # every rank holds the same whole batch
    for out in got[name][1:]:
        np.testing.assert_array_equal(out["prefill"], got[name][0]["prefill"])


# -- the cache plan -----------------------------------------------------------

def _cache_plan(key: str, engine) -> tuple:
    """(batch axis over "data", kv-head axis over "model") of a cache state
    key (None: not cut), the JAX package's ``cache_specs``.  Masked and
    dense caches: k, v and the Opa score rings [L, B, S, Hkv, D].
    Compressed: windows and Opa scores [L, B, Hkv, W, D], the pool and the
    scales [L, mc, B, Hkv, ...], chunk counts [L, B]; ``nc_host`` is a host
    int, the same on every rank."""
    compressed = engine.cache_mode == tc.CacheMode.COMPRESSED
    if key == "nc_host":
        return None, None
    if key == "n_chunks":
        return 1, None
    if compressed and key in ("k_win", "v_win", "k_score", "v_score"):
        return 1, 2
    if compressed and key in ("kv_pool", "kv_scales"):
        return 2, 3
    if not compressed and key in ("k", "v", "k_score", "v_score"):
        return 1, 3
    raise ValueError(f"no sharding rule for cache key {key!r}")


def _shard_cache(engine, state: dict, dp: int, tp: int, data_rank: int,
                 model_rank: int) -> dict:
    """A rank's slice of a full cache state, per ``_cache_plan`` (views)."""
    out = {}
    for key, val in state.items():
        b_ax, h_ax = _cache_plan(key, engine)
        if torch.is_tensor(val):
            if b_ax is not None:
                n = val.shape[b_ax] // dp
                val = val.narrow(b_ax, data_rank * n, n)
            if h_ax is not None:
                n = val.shape[h_ax] // tp
                val = val.narrow(h_ax, model_rank * n, n)
        out[key] = val
    return out


CACHES = [("DENSE", "bitmap", "KT_MAG_VT_MAG"), ("MASKED", "bitmap", "KT_MAG_VT_MAG"),
          ("MASKED", "bitmap", "KT_OPA_VT_MAG"), ("MASKED", "bitmap", "KT_MAG_VT_OPA"),
          ("COMPRESSED", "bitmap", "KT_MAG_VT_MAG"),
          ("COMPRESSED", "bitmap-q8", "KT_MAG_VT_MAG"),
          ("COMPRESSED", "q8q4", "KT_MAG_VT_MAG"), ("COMPRESSED", "q4q4", "KT_OPA_VT_MAG"),
          ("COMPRESSED", "q8q4", "KT_MAG_VT_OPA")]


@pytest.mark.parametrize("mode,codec,method", CACHES)
def test_cache_plan_covers_state_and_sizes_local_cache(mode, codec, method):
    model = dict(WIDE, num_kv_heads=4, num_heads=8)
    _, teng = _cfgs(model, mode, codec, method, max_seq_len=544, chunk_size=256,
                    batch_size=4)
    full = t_make_cache(teng, device="cpu").init(4, torch.float32)
    dp, tp = 2, 2
    local_eng = sh.local_engine(teng, dp, tp)
    local = t_make_cache(local_eng, device="cpu").init(local_eng.batch_size, torch.float32)
    assert set(local) == set(full)
    for d in range(dp):
        for t in range(tp):
            part = _shard_cache(teng, full, dp, tp, d, t)
            for key, val in local.items():
                if torch.is_tensor(val):
                    assert part[key].shape == val.shape, (key, part[key].shape, val.shape)
                    assert part[key].dtype == val.dtype
                else:
                    assert part[key] == val
    # the head axis of every per-head key is cut, the batch axis of every key
    # but the host count
    for key, val in full.items():
        b_ax, h_ax = _cache_plan(key, teng)
        if torch.is_tensor(val):
            assert b_ax is not None and val.shape[b_ax] == 4, key
            if key != "n_chunks":
                assert val.shape[h_ax] == 4, key


def test_cache_plan_refuses_unknown_key():
    _, teng = _masked()
    with pytest.raises(ValueError, match="no sharding rule"):
        _cache_plan("k_extra", teng)


# -- the params plan ----------------------------------------------------------

def _tparams(fmt, model=SMALL, moe=False):
    cfg = tc.ModelConfig(**model)
    if moe:
        cfg = dataclasses.replace(cfg, num_experts=4, num_experts_per_tok=2)
    p = params_from_jax(dist_rt.init_params_np(cfg, 3), device="cpu")
    if fmt == "w8":
        p = tq.quantize_params(p)
    elif fmt == "w4":
        p = tq.quantize_params_w4(p)
    elif fmt == "w8a8":
        p = tq.enable_act_quant(tq.quantize_params(p))
    return cfg, p


@pytest.mark.parametrize("fmt,model,moe", [(None, SMALL, False), ("w8", SMALL, False),
                                           ("w4", W4_MODEL, False), ("w8a8", SMALL, False),
                                           ("w8", SMALL, True)])
def test_shards_put_back_together_are_the_params(fmt, model, moe):
    cfg, p = _tparams(fmt, model, moe)
    tp = 2
    shards = [sh.shard_params(cfg, p, tp, r) for r in range(tp)]
    for name, leaf in p["layers"].items():
        axis = sh.param_plan(name, leaf, layer=True)
        parts = [s["layers"][name] for s in shards]
        whole = parts[0] if axis is None else torch.cat(parts, dim=axis)
        assert torch.equal(whole, leaf), name
        if axis is not None:
            # a column-major int8 weight stays column-major (W8A8)
            assert all(sh._col_major(q) == sh._col_major(leaf) for q in parts), name
    for name in ("lm_head", "lm_head_scale")[:1 + ("lm_head_scale" in p)]:
        assert torch.equal(torch.cat([s[name] for s in shards], dim=-1), p[name])
    assert shards[1]["embed"] is p["embed"]          # replicated: shared
    lcfg = sh.local_model(cfg, tp)
    if moe:
        assert shards[0]["layers"]["we_gate"].shape[1] == cfg.num_experts // tp
        assert lcfg.intermediate_size == cfg.intermediate_size
    else:
        assert lcfg.intermediate_size == cfg.intermediate_size // tp
    assert (lcfg.num_heads, lcfg.num_kv_heads, lcfg.head_dim) == (
        cfg.num_heads // tp, cfg.num_kv_heads // tp, cfg.head_dim)


@pytest.mark.parametrize("fmt", [None, "w8", "w8a8"])
def test_fused_projections_shard_as_their_parts(fmt):
    cfg, p = _tparams(fmt)
    for r in range(2):
        fused_then_cut = sh.shard_params(cfg, tq.fuse_projections(p), 2, r)
        cut_then_fused = tq.fuse_projections(sh.shard_params(cfg, p, 2, r))
        assert set(fused_then_cut["layers"]) == set(cut_then_fused["layers"])
        for k, v in cut_then_fused["layers"].items():
            assert torch.equal(fused_then_cut["layers"][k], v), k


def test_plan_refuses_uneven_cuts():
    cfg = tc.ModelConfig(**SMALL)
    with pytest.raises(ValueError, match="num_kv_heads"):
        sh.local_model(cfg, 4)
    _, teng = _cfgs(SMALL, "MASKED", max_seq_len=128, batch_size=3)
    with pytest.raises(ValueError, match="slots"):
        sh.local_engine(teng, 2, 1)
    # W4 at 64 input rows a rank: not on a 128-row block edge
    cfg, p = _tparams("w4", dict(SMALL, intermediate_size=256, num_heads=4, hidden_size=128))
    with pytest.raises(ValueError, match="block edge"):
        sh.shard_params(cfg, p, 2, 0)


def test_model_shard_of_no_mesh_is_one_device():
    assert sh.model_shard(None) is None
    assert sh.mesh_dims(None) == (1, 1)
    assert [sh.shard_bounds(258, 2, r) for r in range(2)] == [(0, 129), (129, 258)]
    assert [sh.shard_bounds(7, 3, r) for r in range(3)] == [(0, 3), (3, 5), (5, 7)]
