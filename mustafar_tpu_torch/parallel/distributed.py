"""The multi-process runtime on ``torch.distributed``: port of
``mustafar_tpu/parallel/distributed.py``.

The JAX package joins processes through ``jax.distributed`` into one global
mesh and runs one SPMD program over it.  Here each process is one rank of a
("data", "model") ``DeviceMesh`` (``sharding.make_mesh``) over a process
group whose backend the caller names: ``nccl`` with one card a rank,
``gloo`` on the CPU or for ranks that share one card.  Nothing picks a
backend or a device on its own.

  * ``run_sharded_step``: the tiny prefill + one decode step of
    ``_step_program`` ("masked", or "q8q4": the serving path, compressed
    pools and their kernels on the card), tokens over "data", heads over
    "model"; returns the prefill and decode checksums and the tokens, the
    same on every rank.
  * ``run_timed_decode``: a timed multi-step decode with an atomic
    request-state snapshot each step (``_write_snapshot``) and, with
    ``die_after``, a health barrier before each step (``_barrier``): rank 1
    exits abruptly after that many steps and the survivor raises a clean
    error within ``barrier_ms`` instead of hanging in a collective.
  * ``run_recovery``: re-admission from a snapshot on another mesh
    (prefill, then a checked replay of the emitted tokens, then the rest),
    token for token the uninterrupted run.
  * ``spawn``: run a rank body (``"module:function"``) in dp x tp processes
    over one mesh, ("data", "model") or the pipeline's ("stage", "model");
    the rank bodies (``forward_case``, ``engine_case``; the ring's and the
    pipeline's beside their code) are imported by name in each process.

Weights come from a seed through numpy (``init_params_np``: the JAX
package's structure and scales), or from an ``.npz`` of params (``--params``,
``harness/tinylm.py``'s layout), so the JAX program's params can be fed in.

One process of a two-process sharded step on the CPU:

    python -m mustafar_tpu_torch.parallel.distributed \\
        --coordinator localhost:29511 --num-processes 2 --process-id 0 \\
        --backend gloo --device cpu --dp 1 --tp 2 --out /tmp/dist0.json
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import importlib
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback
from contextlib import contextmanager, nullcontext

import numpy as np
import torch
import torch.distributed as dist

from mustafar_tpu_torch.device import resolve_device
from mustafar_tpu_torch.parallel import sharding
from mustafar_tpu_torch.runtime import graphs

PROGRAM_TOKENS = 8           # the step program's batch
DEFAULT_TIMEOUT_S = 600


def initialize(coordinator: str, num_processes: int, process_id: int,
               backend: str, timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join the default process group: ``coordinator`` is ``host:port``
    (a TCP store that process 0 serves) or an ``init_method`` URL such as
    ``file:///path``; ``backend`` is ``nccl`` or ``gloo``."""
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


# -- the step program ---------------------------------------------------------

def step_config(program: str = "masked"):
    """(ModelConfig, EngineConfig, prompt length) of the step program: the
    JAX package's ``_step_program`` configs."""
    from mustafar_tpu_torch.config import (CacheMode, EngineConfig, ModelConfig,
                                           PruneConfig, PruneMethod)
    prune = PruneConfig(method=PruneMethod.KT_MAG_VT_MAG, k_sparsity=0.5, v_sparsity=0.5)
    if program == "masked":
        cfg = ModelConfig(name="dist-step", vocab_size=256, hidden_size=128,
                          intermediate_size=256, num_layers=2, num_heads=4,
                          num_kv_heads=2, head_dim=32, max_position_embeddings=512)
        return cfg, EngineConfig(model=cfg, cache_mode=CacheMode.MASKED, prune=prune,
                                 max_seq_len=256, batch_size=PROGRAM_TOKENS), 64
    if program != "q8q4":
        raise ValueError(f"unknown step program {program!r}")
    cfg = ModelConfig(name="dist-q8q4", vocab_size=256, hidden_size=256,
                      intermediate_size=512, num_layers=2, num_heads=4,
                      num_kv_heads=2, head_dim=128, max_position_embeddings=2048)
    # 400 prompt tokens pack one compressed chunk during prefill
    return cfg, EngineConfig(model=cfg, cache_mode=CacheMode.COMPRESSED, prune=prune,
                             max_seq_len=1056, prefill_bucket=512, chunk_size=256,
                             codec="q8q4", batch_size=PROGRAM_TOKENS), 400


def init_params_np(cfg, seed: int = 0) -> dict:
    """Random f32 params as numpy arrays, the JAX package's ``init_params``
    structure and scales (embedding and LM head 0.02, projections
    1/sqrt(in), norms 1); the random bits are numpy's."""
    rs = np.random.RandomState(seed)
    H, Dq, Dkv, I, L = (cfg.hidden_size, cfg.q_dim, cfg.kv_dim,
                        cfg.intermediate_size, cfg.num_layers)

    def w(*shape, scale=None):
        scale = scale or 1.0 / np.sqrt(shape[-2])
        return (rs.standard_normal(shape) * scale).astype(np.float32)

    layers = {"attn_norm": np.ones((L, H), np.float32), "wq": w(L, H, Dq),
              "wk": w(L, H, Dkv), "wv": w(L, H, Dkv), "wo": w(L, Dq, H),
              "mlp_norm": np.ones((L, H), np.float32)}
    if cfg.num_experts:
        E = cfg.num_experts
        layers.update(w_router=w(L, H, E, scale=0.02), we_gate=w(L, E, H, I),
                      we_up=w(L, E, H, I), we_down=w(L, E, I, H))
    else:
        layers.update(w_gate=w(L, H, I), w_up=w(L, H, I), w_down=w(L, I, H))
    params = {"embed": w(cfg.vocab_size, H, scale=0.02), "layers": layers,
              "final_norm": np.ones((H,), np.float32)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w(H, cfg.vocab_size, scale=0.02)
    return params


def load_params_npz(path: str) -> dict:
    """Params from an ``.npz`` with ``harness/tinylm.py``'s keys
    (``layers/wq``, ``embed``, ...), numpy arrays of their stored dtypes."""
    params: dict = {"layers": {}}
    with np.load(path) as data:
        for key in data.files:
            parts = [p for p in key.split("/") if p]
            if len(parts) == 1:
                params[parts[0]] = data[key]
            else:
                params.setdefault(parts[0], {})[parts[1]] = data[key]
    return params


def _program_tokens(P_len: int) -> np.ndarray:
    return np.random.RandomState(0).randint(0, 256, (PROGRAM_TOKENS, P_len))


@dataclasses.dataclass
class _Rank:
    """One rank's share of a uniform-batch program: its config, params,
    cache and prompt rows."""
    cfg: object
    impl: object
    params: dict
    cache: dict
    tokens: torch.Tensor          # [B/dp, T] this rank's rows
    tp: object
    data_group: object
    lo: int
    B: int


def carry_params(params_np: dict, device) -> dict:
    """A numpy params tree on ``device`` (``weights.params_from_jax``); one
    marked for W8A8 (``act_quant``) is marked again by the port's
    ``enable_act_quant``, which stores its int8 weights column-major."""
    from mustafar_tpu_torch.models.quant import enable_act_quant
    from mustafar_tpu_torch.weights import params_from_jax

    params = params_from_jax(params_np, device=device)
    return enable_act_quant(params) if "act_quant" in params else params


def _setup(mesh, cfg, engine, params_np: dict, tokens: np.ndarray, device) -> _Rank:
    from mustafar_tpu_torch.cache import make_cache

    dp, tp = sharding.mesh_dims(mesh)
    B = tokens.shape[0]
    local = sharding.local_engine(dataclasses.replace(engine, batch_size=B), dp, tp)
    ms = sharding.model_shard(mesh)
    params = carry_params(params_np, device)
    if mesh is not None:
        params = sharding.shard_params(cfg, params, tp, ms.rank)
    Bl = local.batch_size
    lo = 0 if mesh is None else mesh.get_local_rank("data") * Bl
    impl = make_cache(local, device=device)
    rows = torch.as_tensor(np.asarray(tokens[lo:lo + Bl]), dtype=torch.int64).to(impl.device)
    return _Rank(local.model, impl, params, impl.init(Bl, torch.float32), rows, ms,
                 None if mesh is None else mesh.get_group("data"), lo, B)


def _gather_rows(r: _Rank, local: torch.Tensor) -> torch.Tensor:
    """This rank's rows [B/dp, ...] -> the whole batch [B, ...] on every
    rank (``sharding.gather`` over "data")."""
    if r.data_group is None:
        return local
    return sharding.gather(local, r.B, r.lo, 0, r.data_group)


def _abs_sum(r: _Rank, logits: torch.Tensor) -> float:
    """sum |logits| over the whole batch (f64 partial sums over "data")."""
    total = logits.abs().to(torch.float64).sum().reshape(1)
    if r.data_group is not None:
        dist.all_reduce(total, group=r.data_group)
    return float(total)


def run_sharded_step(mesh, program: str = "masked", params_np: dict | None = None,
                     device=None):
    """The sharded step on ``mesh`` (None: one device): prefill, the greedy
    token, one decode step.  Returns (checksum of the prefill logits at the
    last position, checksum of the decode logits, tokens [B]), the same on
    every rank."""
    with torch.inference_mode():
        prefill, dec, P_len, _ = _step_fns(program, mesh, params_np, device)
        tok, s1 = prefill()
        _, s2 = dec(tok, P_len)
    return s1, s2, tok.cpu().numpy()


# -- health, snapshots, timed decode, recovery ---------------------------------

def _barrier(name: str, timeout_ms: int):
    """Cross-process health barrier: raises if a peer does not arrive within
    ``timeout_ms`` (the clean failure surface: a dead peer is found before
    the next collective, instead of hanging inside it).  ``gloo`` has
    ``monitored_barrier``; other backends wait on the store's keys."""
    timeout = datetime.timedelta(milliseconds=timeout_ms)
    if dist.get_backend() == "gloo":
        dist.monitored_barrier(timeout=timeout)
        return
    store = dist.distributed_c10d._get_default_store()
    store.set(f"{name}/{dist.get_rank()}", "1")
    store.wait([f"{name}/{r}" for r in range(dist.get_world_size())], timeout)


def _write_snapshot(path: str, payload: dict):
    """Atomic request-state snapshot (the persistence half of recovery)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _step_fns(program: str, mesh, params_np, device):
    """Prefill and greedy decode of the step program on ``mesh``: each
    returns the greedy tokens, whole on every rank, and the checksum of
    the logits they were picked from."""
    from mustafar_tpu_torch.models import llama

    cfg, engine, P_len = step_config(program)
    params_np = params_np if params_np is not None else init_params_np(cfg, 0)
    r = _setup(mesh, cfg, engine, params_np, _program_tokens(P_len), device)

    def prefill():
        logits, r.cache = llama.prefill(r.cfg, r.params, r.tokens, r.cache, r.impl,
                                        P_len, tp=r.tp)
        last = logits[:, P_len - 1]
        return _gather_rows(r, torch.argmax(last, -1)), _abs_sum(r, last)

    def dec(tok_full, pos):
        tok = tok_full[r.lo:r.lo + r.tokens.shape[0], None]
        logits, r.cache = llama.decode_step(r.cfg, r.params, tok, r.cache, r.impl,
                                            pos, tp=r.tp)
        return (_gather_rows(r, torch.argmax(logits[:, -1], -1)),
                _abs_sum(r, logits))

    return prefill, dec, P_len, r


def run_timed_decode(mesh, program: str = "q8q4", steps: int = 32,
                     die_after: int | None = None, barrier_ms: int = 15000,
                     snapshot_path: str | None = None, params_np: dict | None = None,
                     device=None) -> dict:
    """Timed multi-step sharded greedy decode: one prefill, then ``steps``
    decode steps, each synchronized and wall-timed.  Rank 0 writes the
    request state (the emitted token streams) to ``snapshot_path`` after
    prefill and after every step.  With ``die_after`` every step is
    preceded by a health barrier and rank 1 exits abruptly at step
    ``die_after``: the survivor must report ``peer_loss_detected`` with the
    barrier's error, not hang.  Returns per-step ms, checksums and the
    streams."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    dp, tp = sharding.mesh_dims(mesh)
    t0 = time.perf_counter()
    with torch.inference_mode():
        prefill, dec, P_len, r = _step_fns(program, mesh, params_np, device)
        tok, _ = prefill()
        _sync(r.impl.device)
    result = {"program": program, "dp": dp, "tp": tp, "steps_requested": steps,
              "prefill_s_incl_setup": time.perf_counter() - t0}
    stream = [tok.cpu().tolist()]

    def snap(i):
        # request state: the prompts are the program's (a seeded draw); the
        # KV cache is not persisted: recovery re-admits by prefill + replay
        if snapshot_path and rank == 0:
            _write_snapshot(snapshot_path, {"program": program, "steps_done": i,
                                            "steps_requested": steps, "stream": stream})

    snap(0)
    step_ms, csum = [], 0.0
    try:
        with torch.inference_mode():
            for i in range(steps):
                if die_after is not None:
                    t = time.perf_counter()
                    _barrier(f"dist-step-{i}", barrier_ms)
                    if rank == 1 and i == die_after:
                        os._exit(17)         # abrupt death, no shutdown handshake
                t = time.perf_counter()
                tok, csum = dec(tok, P_len + i)
                _sync(r.impl.device)
                step_ms.append((time.perf_counter() - t) * 1e3)
                stream.append(tok.cpu().tolist())
                snap(i + 1)
    except Exception as e:                                # noqa: BLE001
        # t: when the failing barrier (or step) was entered
        result.update(peer_loss_detected=True, error_type=type(e).__name__,
                      error=str(e)[:400], detected_after_s=time.perf_counter() - t)
    arr = np.asarray(step_ms[1:] or step_ms)
    result.update(stream=stream, steps_done=len(step_ms), decode_checksum=csum,
                  step_ms={"mean": float(arr.mean()) if len(arr) else None,
                           "p50": float(np.percentile(arr, 50)) if len(arr) else None,
                           "all": step_ms})
    return result


def run_recovery(snapshot_path: str, mesh, params_np: dict | None = None,
                 device=None) -> dict:
    """Resume from a request-state snapshot on ``mesh`` (another shape than
    the one that wrote it, or None): the KV cache died with the old world,
    so the requests are re-admitted by prefill, the emitted tokens replayed
    by teacher-forced decode steps (each step's own pick checked against
    the snapshot), and decoding continues to the original target.  Greedy,
    so the stream is the uninterrupted run's token for token."""
    t0 = time.perf_counter()
    with open(snapshot_path) as f:
        snap = json.load(f)
    done, stream = snap["steps_done"], [list(s) for s in snap["stream"]]
    if len(stream) != done + 1:
        raise ValueError(f"snapshot holds {len(stream)} token rows for {done} steps")
    steps = snap["steps_requested"]
    with torch.inference_mode():
        prefill, dec, P_len, r = _step_fns(snap["program"], mesh, params_np, device)
        tok, _ = prefill()
        if tok.cpu().tolist() != stream[0]:
            raise AssertionError(f"recovery: prefill tokens {tok.tolist()} differ from "
                                 f"the snapshot's {stream[0]}")
        t_prefill = time.perf_counter() - t0
        t = time.perf_counter()
        for i in range(done):
            forced = torch.tensor(stream[i], dtype=torch.int64, device=tok.device)
            tok, _ = dec(forced, P_len + i)
            if tok.cpu().tolist() != stream[i + 1]:
                raise AssertionError(f"recovery: replay diverges at step {i}")
        t_replay = time.perf_counter() - t
        t = time.perf_counter()
        for i in range(done, steps):
            tok, _ = dec(tok, P_len + i)
            stream.append(tok.cpu().tolist())
        _sync(r.impl.device)
    dp, tp = sharding.mesh_dims(mesh)
    return {"program": snap["program"], "recovered_from_step": done,
            "steps_total": steps, "dp": dp, "tp": tp, "replay_steps_checked": done,
            "prefill_s_incl_setup": t_prefill, "replay_s": t_replay,
            "continuation_s": time.perf_counter() - t, "stream": stream}


# -- spawned rank bodies ------------------------------------------------------

def kernel_launches() -> dict:
    """The launch count of each serving kernel's wrapper in this process,
    CUDA graph replays included (``runtime.graphs.launches``)."""
    return graphs.launches()


def _reset_launches():
    graphs.REPLAYED.clear()
    for fn in graphs.kernel_wrappers().values():
        fn.launches = 0


@contextmanager
def _timed_all_reduce(clock: dict, device):
    """Within: every ``dist.all_reduce`` bracketed by device synchronizes,
    so its wall time is the collective's own and not the queued work it
    waits for; appends the sum of their seconds to ``clock["s"]`` and
    their number to ``clock["n"]``."""
    real, spent = dist.all_reduce, [0.0, 0]

    def timed(*args, **kwargs):
        _sync(device)
        t = time.perf_counter()
        out = real(*args, **kwargs)
        _sync(device)
        spent[0] += time.perf_counter() - t
        spent[1] += 1
        return out

    dist.all_reduce = timed
    try:
        yield
    finally:
        dist.all_reduce = real
        clock["s"].append(spent[0])
        clock["n"].append(spent[1])


def forward_case(mesh, cfg, engine, params_np: dict, tokens: np.ndarray,
                 decode_steps: int = 1, device=None) -> dict:
    """Prefill ``tokens`` [B, T] (all valid) and greedy decode steps on
    ``mesh`` (None: one device) with the carried params (``carry_params``)
    on ``device`` (default ``cuda``): the last position's prefill logits
    and each step's logits, [B, V], the whole batch on every rank (f32
    throughout)."""
    from mustafar_tpu_torch.models import llama

    T = tokens.shape[1]
    r = _setup(mesh, cfg, engine, params_np, tokens, device)
    out = {"decode": []}
    with torch.inference_mode():
        logits, r.cache = llama.prefill(r.cfg, r.params, r.tokens, r.cache, r.impl, T,
                                        tp=r.tp)
        out["prefill"] = _gather_rows(r, logits[:, T - 1]).cpu().numpy()
        tok = torch.argmax(logits[:, T - 1], -1)
        for i in range(decode_steps):
            logits, r.cache = llama.decode_step(r.cfg, r.params, tok[:, None], r.cache,
                                                r.impl, T + i, tp=r.tp)
            out["decode"].append(_gather_rows(r, logits[:, 0]).cpu().numpy())
            tok = torch.argmax(logits[:, 0], -1)
    return out


def forward_cases(mesh, cases: list) -> list:
    """``forward_case`` for each keyword dict of ``cases``, on one mesh."""
    return [forward_case(mesh, **c) for c in cases]


def engine_cases(mesh, cases: list) -> list:
    """``engine_case`` for each keyword dict of ``cases``, on one mesh."""
    return [engine_case(mesh, **c) for c in cases]


def engine_case(mesh, engine, params, requests, dtype=torch.float32, device=None,
                sampling=None, time_collectives: bool = False,
                record_steps: int = 0) -> dict:
    """Drive ``ContinuousBatchingEngine`` on ``mesh`` and ``device``
    (default ``cuda``) through ``requests`` [(prompt, max_new_tokens)]:
    ``params`` a numpy tree (``carry_params``) or a zero-argument callable
    that makes them on the device (a ``functools.partial`` of an init).
    Returns every request's tokens, the counters, this rank's kernel
    launches during the run and the wall time of each tick, the
    compactions that packed, and with ``record_steps`` the logits of the
    first that many decode steps (f32, [B, V], the rows of idle slots 0).
    ``time_collectives``: every odd tick's all-reduces are timed, each
    bracketed by device synchronizes (``_timed_all_reduce``); ``timed``
    marks those ticks, so the even ticks' wall times are the untimed
    run's."""
    from mustafar_tpu_torch.runtime.generate import GREEDY
    from mustafar_tpu_torch.runtime.scheduler import ContinuousBatchingEngine

    full = params() if callable(params) else carry_params(params, device)
    cb = ContinuousBatchingEngine(engine, full, dtype=dtype, device=device, mesh=mesh,
                                  sampling=sampling or GREEDY)
    del full
    compactions, logits = [0], []
    if hasattr(cb.impl, "compact_slots"):
        compact_slots = cb.impl.compact_slots

        def counted(state, do):
            compactions[0] += any(do)
            return compact_slots(state, do)

        cb.impl.compact_slots = counted
    choose = cb._choose

    def recording(logits2d, reqs):
        if len(logits) < record_steps and logits2d.shape[0] == cb.B:
            live = torch.tensor([r is not None for r in reqs], device=logits2d.device)
            logits.append((logits2d.float() * live[:, None]).cpu().numpy())
        return choose(logits2d, reqs)

    cb._choose = recording
    uids = [cb.submit(np.asarray(p), m) for p, m in requests]
    _reset_launches()
    ticks, timed, clock = [], [], {"s": [], "n": []}
    with torch.inference_mode():
        while cb.busy():
            timed.append(time_collectives and len(ticks) % 2 == 1)
            with _timed_all_reduce(clock, cb.device) if timed[-1] else nullcontext():
                t = time.perf_counter()
                cb.tick()
                _sync(cb.device)
                ticks.append(time.perf_counter() - t)
    outs = {uid: np.asarray(cb.finished[uid].out).tolist() for uid in uids}
    res = {"outs": outs, "decode_steps": cb.decode_steps, "segments": cb.segments,
           "ticks": cb.ticks, "tick_s": ticks, "launches": kernel_launches(),
           "compactions": compactions[0], "logits": logits, "timed": timed,
           "collective_s": clock["s"], "collective_n": clock["n"]}
    if hasattr(cb.core, "stats"):
        res["native_core"] = cb.core.stats()
    return res


# -- spawning ----------------------------------------------------------------

def _rank_main(job_path: str):
    """A spawned rank: join the group, build the mesh, run the body, write
    its result (or its traceback) beside the job."""
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    out = job["out"]
    try:
        dev = torch.device(job["device"].format(rank=job["rank"]))
        if dev.index is not None:
            torch.cuda.set_device(dev)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        initialize(job["init"], job["dp"] * job["tp"], job["rank"], job["backend"],
                   job["timeout_s"])
        mesh = sharding.make_mesh(job["dp"], job["tp"], dev.type,
                                  datetime.timedelta(seconds=job["timeout_s"]),
                                  job["axes"])
        mod, name = job["target"].split(":")
        result = getattr(importlib.import_module(mod), name)(mesh, **job["kwargs"])
        payload = {"ok": result}
    except BaseException:                                 # noqa: BLE001
        payload = {"error": traceback.format_exc()}
    with open(out + ".tmp", "wb") as f:
        pickle.dump(payload, f)
    os.replace(out + ".tmp", out)
    if "error" in payload:
        sys.exit(1)
    dist.destroy_process_group()


def spawn(target: str, dp: int, tp: int, kwargs: dict, backend: str = "gloo",
          device: str | None = None, workdir: str | None = None,
          timeout_s: float = 300, axes: tuple = sharding.MESH_AXES) -> list:
    """Run ``target`` (``"module:function"``, called as ``fn(mesh,
    **kwargs)``) in dp x tp new processes, one rank each, over a
    ``file://`` store in ``workdir`` (a fresh temporary directory when
    None).  The mesh is dp x tp named ``axes``: ("data", "model"), or
    ("stage", "model") for a pipeline of dp stages.  ``device``: ``cuda``
    (None; every rank on the current card, as
    ranks that share one card over gloo; raises without a card), a pattern
    such as ``cuda:{rank}`` (a card a rank, for nccl), or ``cpu``.  The
    ``device`` of ``kwargs`` is the rank body's own.  On the CPU each rank runs
    one thread (ranks that each take every core crowd one another out, 5x
    slower at four ranks on eight cores).  Returns the ranks' results in rank order; raises if a rank
    fails, with its traceback, or if the ranks are not done within
    ``timeout_s`` (every process is then killed)."""
    device = device or "cuda"
    resolve_device(device.format(rank=0))
    workdir = workdir or tempfile.mkdtemp(prefix="mustafar_spawn_")
    os.makedirs(workdir, exist_ok=True)
    world = dp * tp
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    procs, outs = [], []
    store = os.path.join(workdir, "store")
    for rank in range(world):
        job = os.path.join(workdir, f"rank{rank}.job")
        outs.append(os.path.join(workdir, f"rank{rank}.result"))
        with open(job, "wb") as f:
            pickle.dump({"target": target, "rank": rank, "dp": dp, "tp": tp, "axes": axes,
                         "backend": backend, "device": device, "init": f"file://{store}",
                         "timeout_s": timeout_s, "kwargs": kwargs, "out": outs[-1]}, f)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", "import sys; from mustafar_tpu_torch.parallel."
             "distributed import _rank_main; _rank_main(sys.argv[1])", job], env=env))
    deadline = time.monotonic() + timeout_s
    try:
        # a rank that fails ends the run at once: its peers would wait in a
        # collective until the group's timeout
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{target}: ranks not done within {timeout_s} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if not os.path.exists(out):
            raise RuntimeError(f"{target}: rank {rank} exited {p.returncode} "
                               f"without a result")
        with open(out, "rb") as f:
            payload = pickle.load(f)
        if "error" in payload:
            raise RuntimeError(f"{target}: rank {rank} failed:\n{payload['error']}")
        results.append(payload["ok"])
    return results


# -- command line -------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(
        description="One rank of the sharded step, the timed decode with its "
                    "snapshot and failure drill, or recovery from a snapshot.")
    ap.add_argument("--coordinator", help="host:port (process 0 serves the store) "
                                          "or an init_method URL (file:///path)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="required with more than one process")
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda / cuda:N (default cuda)")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--program", default="masked", choices=["masked", "q8q4"])
    ap.add_argument("--params", default=None,
                    help=".npz of the program's params (default: numpy, seed 0)")
    ap.add_argument("--steps", type=int, default=0,
                    help="timed decode steps (0 = the single checksum step)")
    ap.add_argument("--die-after", type=int, default=None,
                    help="failure drill: process 1 exits abruptly at step N; the "
                         "survivor must report the loss within --barrier-ms")
    ap.add_argument("--barrier-ms", type=int, default=15000)
    ap.add_argument("--timeout-s", type=float, default=DEFAULT_TIMEOUT_S)
    ap.add_argument("--snapshot", default=None,
                    help="persist the request state (token streams) here every step")
    ap.add_argument("--recover-from", default=None,
                    help="resume from a snapshot on this --dp x --tp mesh")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    dev = torch.device(args.device or "cuda")
    if dev.index is not None:
        torch.cuda.set_device(dev)
    world = args.dp * args.tp
    if world != args.num_processes:
        raise SystemExit(f"--dp {args.dp} x --tp {args.tp} needs {world} processes, "
                         f"got --num-processes {args.num_processes}")
    mesh = None
    if world > 1:
        if not (args.coordinator and args.backend):
            raise SystemExit("--coordinator and --backend are required with more "
                             "than one process")
        initialize(args.coordinator, world, args.process_id, args.backend, args.timeout_s)
        mesh = sharding.make_mesh(args.dp, args.tp, dev.type,
                                  datetime.timedelta(seconds=args.timeout_s))
    params_np = load_params_npz(args.params) if args.params else None
    if args.recover_from:
        res = run_recovery(args.recover_from, mesh, params_np, dev)
        msg = (f"recovered from step {res['recovered_from_step']}: replayed "
               f"{res['replay_steps_checked']}, total {res['steps_total']} steps")
    elif args.steps:
        res = run_timed_decode(mesh, args.program, args.steps, args.die_after,
                               args.barrier_ms, args.snapshot, params_np, dev)
        msg = (f"{res['steps_done']} steps, mean {res['step_ms']['mean']} ms"
               + (f", peer loss: {res['error_type']}" if res.get("peer_loss_detected")
                  else ""))
    else:
        s1, s2, tok = run_sharded_step(mesh, args.program, params_np, dev)
        res = {"prefill_sum": s1, "decode_sum": s2, "tokens": tok.tolist()}
        msg = f"prefill_sum={s1:.6f} decode_sum={s2:.6f}"
    res.update(process=args.process_id, n_processes=world, backend=args.backend,
               device=str(dev), launches=kernel_launches())
    with open(args.out, "w") as f:
        json.dump(res, f)
    print(f"process {args.process_id}: {msg}", flush=True)
    if res.get("peer_loss_detected"):
        # the group has lost a peer: leave without its shutdown handshake
        sys.stdout.flush()
        os._exit(0)
    if mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
