"""Pipeline parallelism, GPipe stages over the dense and masked caches: port
of ``mustafar_tpu/parallel/pipeline.py``.

The JAX package shards the layer-stacked leaves [L, ...] over a "stage"
mesh axis and runs a GPipe schedule inside one ``shard_map``; "model"
stays a GSPMD axis, so PP x TP is the same program.  Here each rank of a
("stage", "model") ``DeviceMesh`` (``stage_mesh``) is a process:

  * rank (s, m) holds layers [s L/S, (s + 1) L/S) (``stage_params``), cut
    over "model" by ``sharding.shard_params`` under TP, and those layers'
    cache (a cache impl of the stage's local config, ``stage_engine``);
    only the first stage holds the embedding, only the last the head (and
    the embedding again for a tied head);
  * the batch splits into M microbatches of B/M rows; S + M - 1 ticks, and
    at tick t stage s runs microbatch t - s through its layers
    (``llama.run_layers``), its cache rows as views ``state[k][:, lo:hi]``
    written in place by the caches' per-layer attend protocol, so every
    pruning variant runs unchanged.  A rank skips the ticks where it has no
    microbatch (the JAX program computes them and throws the results away);
  * the activations [B/M, T, H] pass to stage s + 1 point to point
    (``p2p.post``: nccl with one card a rank, through the host over gloo);
  * the last stage's logits reach every rank by one SUM over "stage" (the
    other stages add zeros), as JAX's ``psum``.

JAX's names: ``shard_pp`` with ``pp_param_specs`` / ``pp_cache_specs`` /
``pp_placement_specs`` (PP x TP) are ``stage_params`` and
``stage_engine``'s cache; ``_stage_layers`` is ``llama.run_layers`` on
the microbatch's cache views; ``_pp_apply`` keeps its name.

A MoE MLP routes each microbatch alone (capacity from B/M rows), as JAX's
schedule feeds ``moe_mlp`` one microbatch at a time: under PP the "model"
shard carries no "data" group (``sharding.model_shard(..., whole_batch=
False)``).  The compressed cache is refused, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import datetime
import time

import torch
import torch.distributed as dist

from mustafar_tpu_torch.config import CacheMode
from mustafar_tpu_torch.models import llama
from mustafar_tpu_torch.models.quant import embed_lookup
from mustafar_tpu_torch.models.rope import rope_cos_sin
from mustafar_tpu_torch.parallel import p2p, sharding

STAGE_AXES = ("stage", "model")


@dataclasses.dataclass(frozen=True)
class StageShard:
    """The "stage" axis as one rank sees it: its group (None: one stage),
    its stage index and the number of stages."""
    group: object
    rank: int
    size: int


def stage_mesh(pp: int, tp: int = 1, device_type: str = "cuda",
               timeout: datetime.timedelta = sharding.GROUP_TIMEOUT):
    """A ("stage", "model") ``DeviceMesh`` of pp x tp over the initialized
    default group (rank r: stage r // tp, model index r % tp)."""
    return sharding.make_mesh(pp, tp, device_type, timeout, STAGE_AXES)


def stage_shard(mesh) -> StageShard:
    """The rank's ``StageShard`` of a ("stage", "model") mesh (None: one)."""
    if mesh is None:
        return StageShard(None, 0, 1)
    return StageShard(mesh.get_group("stage"), mesh.get_local_rank("stage"), mesh.size(0))


def stage_bounds(num_layers: int, S: int, s: int) -> tuple[int, int]:
    """[lo, hi) of stage s's layers; S must divide the layers (JAX asserts
    the same)."""
    if num_layers % S:
        raise ValueError(f"{S} stages must divide the {num_layers} layers")
    n = num_layers // S
    return s * n, (s + 1) * n


def stage_engine(engine, S: int, tp: int = 1):
    """The engine config of a stage's rank: its L/S layers
    (``sharding.local_model`` of them under TP), every batch row."""
    model = dataclasses.replace(engine.model, num_layers=engine.model.num_layers // S)
    return dataclasses.replace(engine, model=sharding.local_model(model, tp))


def stage_params(cfg, params: dict, S: int, s: int, tp: int = 1, tp_rank: int = 0) -> dict:
    """Stage s's params of the full ``params``: its layers' leaves (views),
    the embedding on the first stage, the head on the last (the embedding
    too where the head is tied), the final norm and the W8A8 marker on
    every stage; then rank ``tp_rank``'s cut over "model"."""
    lo, hi = stage_bounds(cfg.num_layers, S, s)
    out = {"layers": {k: v[lo:hi] for k, v in params["layers"].items()}}
    keep = {"final_norm", "act_quant"}
    if s == 0 or cfg.tie_word_embeddings:
        keep |= {"embed", "embed_scale"}
    if s == S - 1:
        keep |= {"lm_head", "lm_head_scale"}
    out.update({k: v for k, v in params.items() if k in keep})
    return out if tp == 1 else sharding.shard_params(cfg, out, tp, tp_rank)


def _pp_apply(cfg, params, tokens, cache, cache_impl, aux, mode: str, stage: StageShard,
              tp, n_micro: int | None, clock: dict | None):
    """The GPipe schedule on this rank (module note).  ``cfg`` is the
    stage's local config; tokens [B, T] the whole batch's (the first stage
    embeds them); returns the f32 logits [B, 1, V] on every rank."""
    if cache_impl.engine.cache_mode == CacheMode.COMPRESSED:
        raise ValueError("pipeline parallelism covers the dense and masked caches")
    S, s = stage.size, stage.rank
    B, T = tokens.shape
    M = n_micro or min(B, S)
    if B % M:
        raise ValueError(f"{M} microbatches must divide the batch of {B}")
    mbB = B // M
    dev = cache_impl.device
    dtype = params["final_norm"].dtype
    if mode == "prefill":
        positions = torch.arange(T, device=dev)
        attend = cache_impl.prefill_attend
        last = max(aux - 1, 0)
    else:
        positions = torch.full((1,), aux, dtype=torch.int64, device=dev)
        attend = cache_impl.decode_attend
        last = 0
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    logits = torch.zeros((B, 1, cfg.vocab_size), dtype=torch.float32, device=dev)
    sends = []
    for t in range(M + S - 1):
        m = t - s
        if not 0 <= m < M:
            continue
        rows = slice(m * mbB, (m + 1) * mbB)
        if s == 0:
            tok = torch.as_tensor(tokens[rows], device=dev).to(torch.int64)
            x = embed_lookup(params, tok, dtype)
        else:
            x = torch.empty((mbB, T, cfg.hidden_size), dtype=dtype, device=dev)
            p2p.post([], [(s - 1, x)], stage.group, clock).wait()
        sub = {k: v[:, rows] for k, v in cache.items()}

        def attend_at(li, sub=sub):
            return lambda q, k, v: attend(sub, li, q, k, v, aux)

        x = llama.run_layers(cfg, params["layers"], x, cos, sin, attend_at, tp)
        if s + 1 < S:
            sends.append(p2p.post([(s + 1, x)], [], stage.group, clock))
        else:
            xl = llama.rms_norm(x[:, last:last + 1], params["final_norm"], cfg.rms_norm_eps)
            logits[rows] = llama._lm_head(cfg, params, xl, tp)
    for send in sends:
        send.wait()
    if S > 1:
        dist.all_reduce(logits, group=stage.group)
    return logits, cache


def pp_prefill(cfg, params, tokens, cache: dict, cache_impl, true_len: int,
               stage: StageShard, tp=None, n_micro: int | None = None,
               clock: dict | None = None):
    """Pipeline-parallel prefill of ``tokens`` [B, T] (the whole batch, the
    same on every rank): (the last-token logits [B, 1, V] f32 on every
    rank, this stage's cache filled in place).  ``cfg``, ``params``,
    ``cache`` and ``cache_impl`` are the stage's (``stage_engine``,
    ``stage_params``); ``tp`` its ``ModelShard`` of "model" (None: heads
    whole); ``n_micro`` microbatches (default min(B, stages)); ``clock``
    times the activations' hops (``p2p``)."""
    return _pp_apply(cfg, params, tokens, cache, cache_impl, true_len, "prefill", stage,
                     tp, n_micro, clock)


def pp_decode_step(cfg, params, token, cache: dict, cache_impl, pos: int,
                   stage: StageShard, tp=None, n_micro: int | None = None,
                   clock: dict | None = None):
    """Pipeline-parallel decode step: token [B, 1] at position ``pos`` ->
    (logits [B, 1, V] f32 on every rank, the stage's cache)."""
    return _pp_apply(cfg, params, token, cache, cache_impl, pos, "decode", stage, tp,
                     n_micro, clock)


# -- spawned rank bodies (``distributed.spawn`` with ``axes=STAGE_AXES``) ----------

def pp_case(mesh, engine, params, tokens, true_len: int | None = None,
            decode_steps: int = 3, n_micro: int | None = None, dtype=torch.float32,
            device=None, use_pallas: bool = False, use_tp: bool = True,
            world_stages: bool = False, time_hops: bool = False) -> dict:
    """``pp_prefill`` of ``tokens`` [B, T] then greedy ``pp_decode_step``s on
    a ("stage", "model") mesh.  ``params``: a numpy tree
    (``distributed.carry_params``) or a zero-argument callable that makes
    the full params on the device.  ``use_tp`` False leaves "model" out
    (each model index its own pipeline, heads whole); ``world_stages``
    makes every rank of the default group a stage (heads whole).  Returns
    the prefill's logits and each step's, [B, V] f32 (the whole batch, on
    every rank); the wall seconds of the prefill (with ``time_hops`` a
    second's, after one that warms up, and a third's hop seconds, ``p2p``
    clock) and of each decode step (with ``time_hops`` the odd steps' hop
    seconds, the even ones' wall time untimed); this rank's kernel launches in the timed
    decode steps, its stage and its peak device bytes."""
    from mustafar_tpu_torch.cache import make_cache
    from mustafar_tpu_torch.parallel import distributed as dr

    if world_stages:
        stage = StageShard(dist.group.WORLD, dist.get_rank(), dist.get_world_size())
        tp_n, ms = 1, None
    else:
        stage = stage_shard(mesh)
        tp_n = mesh.size(1) if use_tp else 1
        ms = sharding.model_shard(mesh, whole_batch=False) if use_tp else None
    S, s = stage.size, stage.rank
    B, T = tokens.shape
    true_len = T if true_len is None else true_len
    full = params() if callable(params) else dr.carry_params(params, device)
    mine = stage_params(engine.model, full, S, s, tp_n, 0 if ms is None else ms.rank)
    del full
    local = stage_engine(engine, S, tp_n)
    cfg = local.model
    impl = make_cache(local, device=device)
    impl.use_pallas = use_pallas
    cache = impl.init(B, dtype)
    out = {"decode": [], "stage": s, "decode_s": []}
    kw = dict(stage=stage, tp=ms, n_micro=n_micro)
    if impl.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        for run in range(3 if time_hops else 1):
            clock = {"s": 0.0, "n": 0} if run == 2 else None
            dr._sync(impl.device)
            t = time.perf_counter()
            logits, cache = pp_prefill(cfg, mine, tokens, cache, impl, true_len,
                                       clock=clock, **kw)
            dr._sync(impl.device)
            if run < 2:
                out["prefill_s"] = time.perf_counter() - t
            else:
                out.update(prefill_hop_s=clock["s"], prefill_hops=clock["n"])
        out["prefill"] = logits[:, 0].cpu().numpy()
        tok = torch.argmax(logits[:, 0], -1)
        dr._reset_launches()
        hops = {"s": 0.0, "n": 0}
        for i in range(decode_steps):
            # odd steps time their hops (synchronize-bracketed); even ones
            # give the wall time
            clock = hops if time_hops and i % 2 else None
            dr._sync(impl.device)
            t = time.perf_counter()
            logits, cache = pp_decode_step(cfg, mine, tok[:, None], cache, impl,
                                           true_len + i, clock=clock, **kw)
            dr._sync(impl.device)
            out["decode_s"].append(time.perf_counter() - t)
            out["decode"].append(logits[:, 0].cpu().numpy())
            tok = torch.argmax(logits[:, 0], -1)
        out.update(decode_hop_s=hops["s"], decode_hops=hops["n"])
    out["launches"] = {k: v for k, v in dr.kernel_launches().items() if v}
    if impl.device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def pp_cases(mesh, cases: list) -> list:
    """``pp_case`` for each keyword dict of ``cases``, on one mesh."""
    return [pp_case(mesh, **c) for c in cases]
