"""Port parity, the continuous-batching engine over a ("data", "model")
mesh (``ContinuousBatchingEngine(..., mesh=...)``), on the CPU.

The port's counterpart of ``tests/test_scheduler_sharded.py``: the trained
``ckpt/tiny-acc`` (f32; real logit margins, so greedy decoding does not hang
on reduction-order rounding) drives the engine at dp=2 x tp=2, four
processes over gloo (one spawn for every case), and every request's tokens
must equal the port's single-rank run's:

(e) the requests (120, 10), (280, 30), (530, 25), (64, 12), (300, 20) of
    ``RandomState(3)`` on the q8q4 compressed, masked (bitmap) and bitmap-q8
    compressed caches; the compaction-crossing mix of ``RandomState(11)``
    at q8q4; and, past the JAX test, the q8q4 engine with chunked prefill
    (admission interleaved a segment a tick, each segment run by the slot's
    owners) and with sampled decoding (the pick step advancing alike on
    every rank).  Every rank ends with the same tokens and the same native
    core stats.
(j) The q8q4 run against the JAX package's ``mesh=None`` engine, as
    ``tests/test_torch_scheduler.py`` holds the single-rank port to it: the
    port's engine fed JAX's streams picks JAX's token at every step, or one
    within the compressed cache's tie tolerance, and the sharded run's free
    streams part from JAX's only after such a near-tie (request 1's do, at
    its fourth token, on one rank as on four).
(m) Mixtral's MoE MLP with its experts over "model" (EP) at dp=1 x tp=2,
    two processes, on a tiny MoE (4 experts, top-2, capacity factor 1, so a
    prefill drops tokens): tokens equal the single-rank run's.  And the
    same MoE at dp=2 x tp=2 (in the four ranks' spawn) with 32 slots and 20
    requests, so that a decode step's 32 rows overflow an expert's 16 slots
    and drop rows: every data group routes the whole batch, as one device
    does (a group's 16 rows alone would have 8 slots an expert).  Its
    tokens equal the single-rank run's, and hold to the JAX package's
    ``mesh=None`` engine by teacher forcing as (j).
"""

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from mustafar_tpu_torch import config as tc
from mustafar_tpu_torch.parallel import distributed as dist_rt
from mustafar_tpu_torch.runtime.generate import SamplingParams
from tests.test_torch_scheduler import TIE_TOL, _check_streams, _Forced

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "ckpt", "tiny-acc")
SPAWN_TIMEOUT_S = 300
REQS = [(120, 10), (280, 30), (530, 25), (64, 12), (300, 20)]
# 240+40 and 500+30 cross compaction mid-decode; 250+10 ends just past a
# boundary; 32+8 and 700+20 bracket the lengths
CROSSING = [(240, 40), (32, 8), (500, 30), (250, 10), (700, 20)]
SAMPLED = SamplingParams(temperature=0.9, top_k=50, top_p=0.95, seed=7)


def _model():
    import json
    with open(os.path.join(CKPT, "config.json")) as f:
        return tc.ModelConfig(**json.load(f))


def _engine(mode, codec, chunked=False, model=None, batch_size=4, mod=tc):
    return mod.EngineConfig(model=model or _model(), cache_mode=getattr(mod.CacheMode, mode),
                            prune=mod.PruneConfig(method=mod.PruneMethod.KT_MAG_VT_MAG,
                                                  k_sparsity=0.5, v_sparsity=0.5),
                            max_seq_len=1024, prefill_bucket=256, chunk_size=256,
                            codec=codec, batch_size=batch_size, chunked_prefill=chunked)


def _requests(mix, seed):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, 256, size=n), m) for n, m in mix]


# name: (engine, requests, sampling)
CASES = {
    "q8q4": (_engine("COMPRESSED", "q8q4"), _requests(REQS, 3), None),
    "masked": (_engine("MASKED", "bitmap"), _requests(REQS, 3), None),
    "bitmap_q8": (_engine("COMPRESSED", "bitmap-q8"), _requests(REQS, 3), None),
    "crossing": (_engine("COMPRESSED", "q8q4"), _requests(CROSSING, 11), None),
    "chunked": (_engine("COMPRESSED", "q8q4", chunked=True), _requests(REQS, 3), None),
    "sampled": (_engine("COMPRESSED", "q8q4"), _requests(REQS, 3), SAMPLED),
}
MOE = dataclasses.replace(tc.TINY_LLAMA, head_dim=128, num_heads=4, num_kv_heads=2,
                          hidden_size=256, num_experts=4, num_experts_per_tok=2,
                          expert_capacity_factor=1.0)
MOE_DP_SLOTS = 32
MOE_DP_MIX = [(30 + 11 * i, 6 + i % 3) for i in range(20)]


def _jax_q8q4(reqs):
    import jax.numpy as jnp
    from mustafar_tpu.config import CacheMode, EngineConfig, PruneConfig, PruneMethod
    from mustafar_tpu.harness.tinylm import load_ckpt
    from mustafar_tpu.runtime.scheduler import ContinuousBatchingEngine
    cfg, params = load_ckpt(CKPT)
    eng = EngineConfig(model=cfg, cache_mode=CacheMode.COMPRESSED,
                       prune=PruneConfig(method=PruneMethod.KT_MAG_VT_MAG,
                                         k_sparsity=0.5, v_sparsity=0.5),
                       max_seq_len=1024, prefill_bucket=256, chunk_size=256,
                       codec="q8q4", batch_size=4)
    cb = ContinuousBatchingEngine(eng, params, dtype=jnp.float32)
    uids = [cb.submit(p, m) for p, m in reqs]
    outs = cb.run()
    return {uid: np.asarray(outs[uid]).tolist() for uid in uids}


def _jax_moe_dp(params_np, reqs):
    """The JAX package's ``mesh=None`` engine on the MoE of 32 slots."""
    import jax
    import jax.numpy as jnp
    from mustafar_tpu import config as jc
    from mustafar_tpu.runtime.scheduler import ContinuousBatchingEngine
    model = jc.ModelConfig(**dataclasses.asdict(MOE))
    cb = ContinuousBatchingEngine(
        _engine("COMPRESSED", "q8q4", model=model, batch_size=MOE_DP_SLOTS, mod=jc),
        jax.tree.map(jnp.asarray, params_np), dtype=jnp.float32)
    uids = [cb.submit(p, m) for p, m in reqs]
    outs = cb.run()
    return {uid: np.asarray(outs[uid]).tolist() for uid in uids}


@pytest.fixture(scope="module")
def runs():
    params = dist_rt.load_params_npz(os.path.join(CKPT, "params.npz"))
    cases = [dict(engine=eng, params=params, requests=reqs, sampling=sp, device="cpu")
             for eng, reqs, sp in CASES.values()]
    moe_params = dist_rt.init_params_np(MOE, 5)
    moe_case = dict(engine=_engine("COMPRESSED", "q8q4", model=MOE), params=moe_params,
                    requests=_requests([(300, 12), (90, 16), (530, 8)], 4), device="cpu")
    moe_dp_case = dict(moe_case, requests=_requests(MOE_DP_MIX, 8),
                       engine=_engine("COMPRESSED", "q8q4", model=MOE,
                                      batch_size=MOE_DP_SLOTS))
    with ThreadPoolExecutor(4) as ex:
        sharded = ex.submit(dist_rt.spawn, "mustafar_tpu_torch.parallel.distributed:"
                            "engine_cases", 2, 2, {"cases": cases + [moe_dp_case]},
                            device="cpu", timeout_s=SPAWN_TIMEOUT_S)
        moe = ex.submit(dist_rt.spawn, "mustafar_tpu_torch.parallel.distributed:"
                        "engine_case", 1, 2, moe_case, device="cpu",
                        timeout_s=SPAWN_TIMEOUT_S)
        jax_q8q4 = ex.submit(_jax_q8q4, CASES["q8q4"][1])
        jax_moe_dp = ex.submit(_jax_moe_dp, moe_params, moe_dp_case["requests"])
        single = {name: dist_rt.engine_case(None, **c) for name, c in zip(CASES, cases)}
        moe_single = dist_rt.engine_case(None, **moe_case)
        moe_dp_single = dist_rt.engine_case(None, **moe_dp_case)
        got = sharded.result()
        return (single, {name: [r[i] for r in got] for i, name in enumerate(CASES)},
                jax_q8q4.result(), moe_single, moe.result(),
                (moe_dp_case, moe_dp_single, [r[-1] for r in got], jax_moe_dp.result()))


@pytest.mark.parametrize("name", list(CASES))
def test_dp2_tp2_engine_tokens_equal_one_rank(runs, name):
    single, sharded, *_ = runs
    want = single[name]
    _, reqs, _ = CASES[name]
    assert [len(want["outs"][u]) for u in sorted(want["outs"])] == [m for _, m in reqs]
    for rank, got in enumerate(sharded[name]):
        assert got["outs"] == want["outs"], f"{name}: rank {rank}"
        assert got["native_core"] == want["native_core"], f"{name}: rank {rank}"
        # the data group that owns no slot of a tick skips its decode step
        assert 0 < got["decode_steps"] <= want["decode_steps"]


def test_dp2_tp2_q8q4_matches_jax_engine(runs):
    single, sharded, jax_q8q4, *_ = runs
    eng, reqs, _ = CASES["q8q4"]
    params = dist_rt.carry_params(dist_rt.load_params_npz(os.path.join(CKPT, "params.npz")),
                                 "cpu")
    forced = _Forced(eng, params, dtype=torch.float32, device="cpu",
                     streams={u: np.asarray(t) for u, t in jax_q8q4.items()})
    for p, m in reqs:
        forced.submit(p, m)
    forced.run()
    for rank_run in sharded["q8q4"]:
        _check_streams({u: np.asarray(t) for u, t in jax_q8q4.items()},
                       {u: np.asarray(t) for u, t in rank_run["outs"].items()},
                       forced.logits, TIE_TOL["COMPRESSED"])


def test_data_groups_split_the_work(runs):
    """Each data group runs the prefills of its own slots only: the chunked
    run's segments split between the two groups and sum to one rank's."""
    single, sharded, *_ = runs
    segs = [r["segments"] for r in sharded["chunked"]]
    assert segs[0] == segs[1] and segs[2] == segs[3]     # the tp ranks of a group
    assert segs[0] + segs[2] == single["chunked"]["segments"] and min(segs) > 0


def test_moe_expert_parallel_tokens_equal_one_rank(runs):
    *_, moe_single, moe, _ = runs
    assert [len(v) for v in moe_single["outs"].values()] == [12, 16, 8]
    for rank, got in enumerate(moe):
        assert got["outs"] == moe_single["outs"], f"rank {rank}"
        assert got["decode_steps"] == moe_single["decode_steps"]


def test_moe_dp2_tp2_engine_routes_the_whole_batch(runs):
    case, single, ranks, jax_outs = runs[-1]
    assert [len(v) for v in single["outs"].values()] == [m for _, m in MOE_DP_MIX]
    for rank, got in enumerate(ranks):
        assert got["outs"] == single["outs"], f"rank {rank}"
        # every data group steps whenever a slot is active (the routing
        # all-reduce spans the groups)
        assert got["decode_steps"] == single["decode_steps"]
    params = dist_rt.carry_params(case["params"], "cpu")
    forced = _Forced(case["engine"], params, dtype=torch.float32, device="cpu",
                     streams={u: np.asarray(t) for u, t in jax_outs.items()})
    for p, m in case["requests"]:
        forced.submit(p, m)
    forced.run()
    for got in ranks:
        _check_streams({u: np.asarray(t) for u, t in jax_outs.items()},
                       {u: np.asarray(t) for u, t in got["outs"].items()},
                       forced.logits, TIE_TOL["COMPRESSED"])
