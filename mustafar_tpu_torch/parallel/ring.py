"""Sequence-parallel (ring) prefill over the dense and masked caches: port of
``mustafar_tpu/parallel/ring.py``.

The JAX package shards one prompt's tokens over the mesh's "data" axis
inside one SPMD program: GSPMD runs the token-local ops on T/n tokens a
chip, attention rides a ``shard_map`` ring and one resharding hands the
cache over to the decode layout.  Here each rank of the ("data", "model")
mesh (``sharding.make_mesh``) is a process and does explicitly what GSPMD
inserts there:

  * rank ``idx`` of the sequence axis ("data", n ranks) holds the token
    block [idx Ts, (idx + 1) Ts) of every prompt row, Ts = T / n, and runs
    the model's projections, norms and MLP on it (heads over "model" as
    ``sharding.ModelShard`` cuts them; RoPE at the global positions);
  * attention is the ring (``ring_attention``): n steps; step i computes
    flash partials of the local queries against the K/V block that rank
    (idx - i) mod n owned (``ops.attention.attention_partials`` and
    ``causal_mask`` at global positions, queries tiled by 512 rows),
    merged by the online-softmax rule and finished by acc / max(l, 1e-30).
    The blocks move one hop a step (``p2p.post``), the next hop posted
    before the block's compute.  A block no local query sees (from the
    future, past true_len or below the sliding window) is not computed:
    its partials (0, -1e30, 0) would merge away exactly;
  * the masked cache's prefill prune (``MaskedKVCache.prefill_prune``) is
    computed per rank, with the statistics that cross token blocks reduced
    over "data" (``SeqShard``): the global row index against true_len - r
    for the prefix, the SUM of |q| over the valid rows (Opa K), the last
    rows of the padded bucket broadcast and the SUM of k**2 (ThinK) or
    v**2 (ThinV) over all T rows, and for the Opa value scores the last
    ``group_size`` queries broadcast with the softmax's MAX and SUM over
    all keys.  The channel policies prune groups of ``group_size`` tokens,
    which must not straddle two blocks (Ts % group_size == 0);
  * the handoff (``_handoff``): a rank ends the prefill with Ts rows of
    every batch row and must end with B/n whole rows, the decode layout of
    ``sharding.local_engine`` that ``llama.decode_step`` and the engine
    take; one exchange sends each peer its rows of the local block.

JAX's names: ``_ring_attend`` with ``_block_partials`` and
``ring_prefill_attention`` are ``ring_attention``; ``_merge_into`` is
``merge_into``; the ``_SPPrefillImpl`` proxy is ``sp_prefill``'s per-layer
attention; ``reshard_cache`` at the handoff is ``_handoff``.

As in the JAX package the compressed cache is refused (its pool is
written chunk by chunk in token order).  A MoE MLP is refused too: the
JAX program routes the whole prompt's tokens together, capacity and
ranks included, which a rank holding one block cannot.
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch
import torch.distributed as dist

from mustafar_tpu_torch.config import CacheMode, PruneMethod
from mustafar_tpu_torch.models import llama
from mustafar_tpu_torch.models.quant import embed_lookup
from mustafar_tpu_torch.models.rope import rope_cos_sin
from mustafar_tpu_torch.ops import pruning
from mustafar_tpu_torch.ops.attention import NEG_INF, attention_partials, causal_mask
from mustafar_tpu_torch.parallel import p2p, sharding

Q_TILE = 512      # query rows a step's partials take at once (JAX's _Q_TILE)


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """The sequence axis as one rank sees it: its group (None: one rank),
    its index and the number of blocks."""
    group: object
    rank: int
    size: int

    def sum_(self, x: torch.Tensor) -> torch.Tensor:
        if self.size > 1:
            dist.all_reduce(x, group=self.group)
        return x

    def max_(self, x: torch.Tensor) -> torch.Tensor:
        if self.size > 1:
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
        return x

    def rows(self, x: torch.Tensor, lo: int, n: int) -> torch.Tensor:
        """Global rows [lo, lo + n) of axis 1 of the blocks x [B, Ts, ...]
        -> every rank (a zero-padded SUM in f32, exact), in x's dtype."""
        Ts = x.shape[1]
        out = x.new_zeros((x.shape[0], n, *x.shape[2:]), dtype=torch.float32)
        a, b = max(lo, self.rank * Ts), min(lo + n, (self.rank + 1) * Ts)
        if a < b:
            out[:, a - lo:b - lo] = x[:, a - self.rank * Ts:b - self.rank * Ts]
        return self.sum_(out).to(x.dtype)


def seq_shard(mesh) -> SeqShard:
    """The rank's ``SeqShard`` of ``mesh``'s "data" axis (None: one rank)."""
    if mesh is None:
        return SeqShard(None, 0, 1)
    return SeqShard(mesh.get_group("data"), mesh.get_local_rank("data"), mesh.size(0))


def merge_into(acc, m, l, a2, m2, l2):
    """Online-softmax merge of running (acc, m, l) with new partials."""
    M = torch.maximum(m, m2)
    s1 = torch.exp(m - M)
    s2 = torch.exp(m2 - M)
    return acc * s1 + a2 * s2, M, l * s1 + l2 * s2


def _sees(q0: int, q1: int, k0: int, k1: int, true_len: int, window) -> bool:
    """Whether any query at [q0, q1] sees any key at [k0, k1] (causal, below
    true_len, inside the window)."""
    if k0 > q1 or k0 >= true_len:
        return False
    return window is None or k1 > q0 - window


def ring_attention(q, k, v, true_len: int, seq: SeqShard, window=None,
                   clock: dict | None = None) -> torch.Tensor:
    """Causal attention of this rank's token block q [B, Ts, Hq, D] over
    every block's k / v [B, Ts, Hkv, D] (the ring; module note) ->
    [B, Ts, Hq, D] in q's dtype.  ``clock`` times the hops (``p2p``)."""
    B, Ts, Hq, D = q.shape
    n, idx = seq.size, seq.rank
    dev = q.device
    q_pos = idx * Ts + torch.arange(Ts, device=dev)
    acc = torch.zeros((B, Ts, Hq, D), dtype=torch.float32, device=dev)
    m = torch.full((B, Ts, Hq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Ts, Hq, 1), dtype=torch.float32, device=dev)
    kv = torch.stack([k, v])
    tile = Ts if Ts <= Q_TILE or Ts % Q_TILE else Q_TILE
    for i in range(n):
        if i + 1 < n:
            nxt = torch.empty_like(kv)
            hop = p2p.post([((idx + 1) % n, kv)], [((idx - 1) % n, nxt)], seq.group, clock)
        src = (idx - i) % n
        k0 = src * Ts
        k_pos = k0 + torch.arange(Ts, device=dev)
        for lo in range(0, Ts, tile):
            q0 = idx * Ts + lo
            if not _sees(q0, q0 + tile - 1, k0, k0 + Ts - 1, true_len, window):
                continue
            mask = causal_mask(q_pos[lo:lo + tile], k_pos, true_len, window)
            part = attention_partials(q[:, lo:lo + tile], kv[0], kv[1], mask)
            s = slice(lo, lo + tile)
            acc[:, s], m[:, s], l[:, s] = merge_into(acc[:, s], m[:, s], l[:, s], *part)
        if i + 1 < n:
            hop.wait()
            kv = nxt
    return (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)


# -- the prefill prune with cross-block statistics ------------------------------

def _drop_channels(x, score, sparsity: float):
    """ThinK / ThinV: zero the int(sparsity D) lowest-score channels of every
    row; x [B, Ts, H, D], score [B, H, D] (``pruning.think_prune_key``)."""
    D = x.shape[-1]
    n_prune = int(sparsity * D) if sparsity > 0 else 0
    if n_prune == 0:
        return x
    drop = pruning._bottom_mask(score, n_prune)
    return torch.where(drop[:, None], torch.zeros_like(x), x)


def _v_opa_score(impl, q, k, v, true_len: int, T: int, seq: SeqShard):
    """``dense.prefill_v_opa_score`` over the whole prompt: the last
    ``group_size`` queries (broadcast) against this block's keys, the
    softmax's max and sum over every block's -> [B, Ts, Hkv, D] f32."""
    B, Ts, Hq, D = q.shape
    Hkv = k.shape[2]
    gs = impl.p.group_size
    start = min(max(true_len - gs, 0), T - gs)
    dev = q.device
    qg = seq.rows(q, start, gs).to(torch.float32).reshape(B, gs, Hkv, Hq // Hkv, D)
    s = torch.einsum("bthgd,bshd->bthgs", qg, k.to(torch.float32)) * (1.0 / math.sqrt(D))
    mask = causal_mask(start + torch.arange(gs, device=dev),
                       seq.rank * Ts + torch.arange(Ts, device=dev), true_len, impl.window)
    s = s.masked_fill(~mask[None, :, None, None, :], NEG_INF)
    M = seq.max_(s.amax(dim=-1, keepdim=True))
    e = torch.exp(s - M)
    w = e / seq.sum_(e.sum(dim=-1, keepdim=True))
    w_kv = w.sum(dim=(1, 3))                                          # [B, Hkv, Ts]
    return (w_kv[..., None] * v.transpose(1, 2).to(torch.float32)).abs().transpose(1, 2)


def _v_channel(impl, v, true_len: int, score, gpos):
    """``MaskedKVCache._prefill_prune_v_channel`` on a block whose groups of
    ``group_size`` tokens are the global ones."""
    gs, r = impl.p.group_size, impl.p.residual_length
    if v.shape[1] % gs:
        raise ValueError(f"a block of {v.shape[1]} tokens splits the channel policy's "
                         f"groups of {gs}")
    vt = v.transpose(1, 2)
    if score is None:
        pruned = pruning.prune_channel_mag(vt, impl.p.v_sparsity, gs)
    else:
        pruned = pruning.prune_channel_by_score(vt, score.transpose(1, 2),
                                                impl.p.v_sparsity, gs)
    grp_end = gpos // gs * gs + (gs - 1)
    return torch.where((grp_end < true_len - r)[None, :, None, None],
                       pruned.transpose(1, 2), v)


def _prefill_prune(impl, q, k, v, true_len: int, T: int, seq: SeqShard):
    """``MaskedKVCache.prefill_prune`` of this rank's block (module note);
    the dense cache stores K and V as they are."""
    if impl.engine.cache_mode == CacheMode.DENSE:
        return k, v
    p, method = impl.p, impl.method
    B, Ts, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    gpos = seq.rank * Ts + torch.arange(Ts, device=q.device)
    if method in (PruneMethod.THINK, PruneMethod.THINV):
        n_last = min(32, T)
        ql = seq.rows(q, T - n_last, n_last).to(torch.float32)
        q_score = (ql ** 2).reshape(B, n_last, Hkv, G, D).mean(dim=(1, 3))
        k_score = seq.sum_((k.to(torch.float32) ** 2).sum(dim=1)) / T
        k_store = _drop_channels(k, q_score * k_score, p.k_sparsity)
        if method == PruneMethod.THINK:
            return k_store, v
        v_score = seq.sum_((v.to(torch.float32) ** 2).sum(dim=1)) / T
        return k_store, _drop_channels(v, v_score, p.v_sparsity)
    in_prefix = (gpos < true_len - p.residual_length)[None, :, None, None]

    if method.k_policy == "token_mag":
        k_store = torch.where(in_prefix, pruning.prune_token_mag(k, p.k_sparsity), k)
    elif method.k_policy == "token_opa":
        valid = (gpos < true_len)[None, :, None, None]
        qa = torch.where(valid, q.to(torch.float32).abs(), 0.0)
        q_mean = seq.sum_(qa.reshape(B, Ts, Hkv, G, D).sum(dim=(1, 3))) / float(
            max(true_len, 1))
        score = (q_mean[:, None] * k.to(torch.float32)).abs()
        k_store = torch.where(in_prefix,
                              pruning.prune_by_score_lastdim(k, score, p.k_sparsity), k)
    else:
        k_store = k

    if method.v_policy == "token_mag":
        v_store = torch.where(in_prefix, pruning.prune_token_mag(v, p.v_sparsity), v)
    elif method.v_policy == "channel_mag":
        v_store = _v_channel(impl, v, true_len, None, gpos)
    elif method.v_policy == "token_opa":
        score = _v_opa_score(impl, q, k, v, true_len, T, seq)
        v_store = torch.where(in_prefix,
                              pruning.prune_by_score_lastdim(v, score, p.v_sparsity), v)
    elif method.v_policy == "channel_opa":
        v_store = _v_channel(impl, v, true_len, _v_opa_score(impl, q, k, v, true_len, T, seq),
                             gpos)
    else:
        v_store = v
    return k_store, v_store


# -- the prefill ------------------------------------------------------------------

def _handoff(pre: dict, cache: dict, seq: SeqShard, clock):
    """pre[key] [L, B, Ts, ...] (this rank's block of every row) -> rows
    [idx Ts, (idx + 1) Ts) ... of cache[key] [L, B/n, S, ...] for every
    block: this rank's batch rows [idx B/n, (idx + 1) B/n)."""
    n, idx = seq.size, seq.rank
    keys = sorted(pre)
    Ts = pre[keys[0]].shape[2]
    Bn = cache[keys[0]].shape[1]
    rows = lambda j: slice(j * Bn, (j + 1) * Bn)          # noqa: E731
    block = lambda j: slice(j * Ts, (j + 1) * Ts)         # noqa: E731
    for key in keys:
        cache[key][:, :, block(idx)] = pre[key][:, rows(idx)]
    if n == 1:
        return
    sends = [(j, torch.stack([pre[key][:, rows(j)] for key in keys])) for j in range(n)
             if j != idx]
    landed = {j: torch.empty_like(sends[0][1]) for j in range(n) if j != idx}
    p2p.post(sends, list(landed.items()), seq.group, clock).wait()
    for j, buf in landed.items():
        for key, part in zip(keys, buf):
            cache[key][:, :, block(j)] = part


def sp_prefill(cfg, params, tokens, cache: dict, cache_impl, true_len: int,
               seq: SeqShard, tp=None, last_only: bool = False, clock: dict | None = None):
    """Sequence-parallel prefill of the whole prompt ``tokens`` [B, T] (the
    same on every rank; T % n == 0 for n ranks on "data") into this rank's
    decode-layout ``cache``: B/n batch rows (the rank's "data" index's),
    its kv heads on "model" (``cache_impl`` built from
    ``sharding.local_engine(engine, n, tp)``).  ``cfg`` is the rank's local
    config (``sharding.local_model``) and ``params`` its shard
    (``sharding.shard_params``); ``seq`` the sequence axis (``seq_shard``
    of the mesh) and ``tp`` the rank's ``sharding.ModelShard`` (None: heads
    not cut).  Returns (the f32 logits, the whole batch on every rank:
    [B, 1, V] at position true_len - 1 with ``last_only``, else [B, T, V];
    the cache, filled in place with the prompt's rows).  ``clock`` times
    the hops and the handoff (``p2p``)."""
    if cache_impl.engine.cache_mode == CacheMode.COMPRESSED:
        raise ValueError("sequence-parallel prefill covers the dense and masked caches; "
                         "the compressed cache's pool is written chunk by chunk in token "
                         "order and cannot take a block of the sequence")
    if cfg.num_experts:
        raise ValueError("sequence-parallel prefill of a MoE model: its routing takes the "
                         "whole prompt's tokens together")
    n, idx = seq.size, seq.rank
    B, T = tokens.shape
    if T % n or B % n:
        raise ValueError(f"{n} sequence ranks need T ({T}) and B ({B}) divisible by {n}")
    Ts = T // n
    dev = cache_impl.device
    mine = torch.as_tensor(tokens[:, idx * Ts:(idx + 1) * Ts], device=dev).to(torch.int64)
    keys = ("k", "v")
    pre = {key: cache[key].new_empty((cfg.num_layers, B, Ts, *cache[key].shape[3:]))
           for key in keys}

    def attend_at(li):
        def attend(q, k, v):
            out = ring_attention(q, k, v, true_len, seq, cache_impl.window, clock)
            k_store, v_store = _prefill_prune(cache_impl, q, k, v, true_len, T, seq)
            pre["k"][li] = k_store
            pre["v"][li] = v_store
            return out
        return attend

    x = embed_lookup(params, mine, params["final_norm"].dtype)
    cos, sin = rope_cos_sin(idx * Ts + torch.arange(Ts, device=dev), cfg.head_dim,
                            cfg.rope_theta, cfg.rope_scaling)
    x = llama.run_layers(cfg, params["layers"], x, cos, sin, attend_at, tp)
    x = llama.rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    if last_only:
        row = max(true_len - 1, 0)
        if row // Ts == idx:
            logits = llama._lm_head(cfg, params, x[:, row - idx * Ts:row - idx * Ts + 1], tp)
        else:          # (a "model" group shares its block: none of it owns the row)
            logits = torch.zeros((B, 1, cfg.vocab_size), dtype=torch.float32, device=dev)
        logits = seq.sum_(logits)
    else:
        logits = llama._lm_head(cfg, params, x, tp)
        if n > 1:
            logits = sharding.gather(logits, T, idx * Ts, 1, seq.group)
    _handoff(pre, cache, seq, clock)
    return logits, cache


# -- spawned rank bodies (``distributed.spawn``) ---------------------------------

def ring_attention_case(mesh, q, k, v, true_len: int, window=None, device="cpu"):
    """``ring_attention`` over the whole default group (a sequence-only
    ring of every rank), this rank's block of the global q / k / v numpy
    arrays [B, T, H, D] -> the whole output [B, T, Hq, D] on every rank."""
    n, idx = dist.get_world_size(), dist.get_rank()
    seq = SeqShard(dist.group.WORLD, idx, n)
    Ts = q.shape[1] // n
    blk = lambda a: torch.as_tensor(a[:, idx * Ts:(idx + 1) * Ts]).to(device)  # noqa: E731
    out = ring_attention(blk(q), blk(k), blk(v), true_len, seq, window)
    return sharding.gather(out, q.shape[1], idx * Ts, 1, seq.group).cpu().numpy()


def sp_case(mesh, engine, params, tokens, true_len: int | None = None,
            decode_steps: int = 3, dtype=torch.float32, device=None,
            use_pallas: bool = False, time_hops: bool = False,
            use_tp: bool = True) -> dict:
    """``sp_prefill`` of ``tokens`` [B, T] on ``mesh`` (None: one rank), then
    greedy decode steps on the handed-over cache (``llama.decode_step``,
    this rank's B/n rows, ``use_pallas``: kernel 4).  ``params``: a numpy
    tree (``distributed.carry_params``) or a zero-argument callable that
    makes the full params on the device.  ``use_tp`` False leaves the
    "model" axis out: each "model" index runs the whole heads, its own
    replica over its "data" group.  Returns the prefill's last-
    position logits and each step's, [B, V] f32, the whole batch on every
    rank; the prefill's wall seconds (a second prefill after a first that
    warms up) and, with ``time_hops``, a third's hop and handoff seconds
    (``p2p`` clock); this rank's kernel launches in the decode, and its
    peak device bytes."""
    from mustafar_tpu_torch.cache import make_cache
    from mustafar_tpu_torch.parallel import distributed as dr

    n, tp = sharding.mesh_dims(mesh)
    tp = tp if use_tp else 1
    B, T = tokens.shape
    true_len = T if true_len is None else true_len
    local = sharding.local_engine(dataclasses.replace(engine, batch_size=B), n, tp)
    full = params() if callable(params) else dr.carry_params(params, device)
    ms = sharding.model_shard(mesh, whole_batch=False) if use_tp else None
    mine = full if ms is None else sharding.shard_params(engine.model, full, tp, ms.rank)
    del full
    impl = make_cache(local, device=device)
    impl.use_pallas = use_pallas
    seq = seq_shard(mesh)
    Bn, lo = local.batch_size, seq.rank * local.batch_size
    cache = impl.init(Bn, dtype)
    out = {"decode": []}
    if impl.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        runs = 3 if time_hops else 1
        for run in range(runs):
            clock = {"s": 0.0, "n": 0} if run == 2 else None
            dr._sync(impl.device)
            t = time.perf_counter()
            logits, cache = sp_prefill(local.model, mine, tokens, cache, impl, true_len,
                                       seq, ms, last_only=True, clock=clock)
            dr._sync(impl.device)
            if run == 1 or runs == 1:
                out["prefill_s"] = time.perf_counter() - t
            if clock is not None:
                out.update(hop_s=clock["s"], hops=clock["n"])
        out["prefill"] = logits[:, 0].cpu().numpy()
        tok = torch.argmax(logits[:, 0], -1)
        dr._reset_launches()
        for i in range(decode_steps):
            lg, cache = llama.decode_step(local.model, mine, tok[lo:lo + Bn, None], cache,
                                          impl, true_len + i, tp=ms)
            whole = lg[:, 0] if n == 1 else sharding.gather(lg[:, 0], B, lo, 0, seq.group)
            out["decode"].append(whole.cpu().numpy())
            tok = torch.argmax(whole, -1)
        dr._sync(impl.device)
    out["launches"] = {k: v for k, v in dr.kernel_launches().items() if v}
    if impl.device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def sp_cases(mesh, cases: list) -> list:
    """``sp_case`` or, with ``"ring"`` in a case, ``ring_attention_case`` for
    each keyword dict of ``cases``, on one mesh."""
    return [ring_attention_case(mesh, **c["ring"]) if "ring" in c else sp_case(mesh, **c)
            for c in cases]
