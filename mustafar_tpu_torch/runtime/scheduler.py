"""Continuous-batching decode scheduler (slot-based): port of
``ContinuousBatchingEngine`` in ``mustafar_tpu/runtime/scheduler.py``,
greedy or sampled, on one device.

  * a fixed pool of B slots (``EngineConfig.batch_size``); the KV cache is
    allocated once for B sequences and updated in place;
  * each request is prefilled alone, into a batch-1 cache, which
    ``insert_slot`` copies into its slot;
  * one decode step advances every slot at its own position (per-slot RoPE,
    window writes, chunk counts: the per-slot kernel in compressed mode);
    an idle slot rides along at position -1 and is neither written nor
    attended; a finished request frees its slot for the next;
  * compressed caches compact, between steps, the slots whose window just
    filled (``compact_slots``);
  * sampled token choice (``SamplingParams``; ``generate.sample``) draws at
    a pick step that every choice advances, a request's first token and
    every decode step, as the JAX package's ``_next_pick_step``;
  * with ``chunked_prefill`` the prompt goes in one C-token segment at a
    time; with ``interleave`` (the default then) each engine tick advances
    the admitting prompt by ONE segment and then runs the decode step, so
    the other slots keep emitting tokens while a long prompt comes in.  The
    tokens are those of the blocking path: the segments are the same, and
    the decode slots do not read the admission's cache until it is
    inserted.

The decode step runs as a CUDA graph on the card (``graph``, the default
there with no mesh: ``runtime.graphs.StepGraph``, as the JAX package jits
its ``step``): each tick copies the slots' last tokens and positions (an
idle slot's -1, which is the active mask) into one static buffer on the
device, replays the captured per-slot step (kernels 2 and 7, the dense
cache's per-slot attention or kernel 4) and reads the tokens back once;
``_choose`` runs eagerly on the graph's logits.  A chunked admission's
segments (interleaved or blocking) run one whole-model segment program
(``generate.StaticSegment``) over the engine's one static batch-1
sub-cache, which is reset in place when an admission starts (admissions
advance one at a time, at the head): with ``graph`` on the card it is
captured once and replayed, otherwise (the CPU, ``graph=False``, a mesh)
the same program reruns eagerly.  The monolithic
batch-1 prefill, the slot insert, the first token's pick and compaction
stay eager between replays, writing the cache in place.  On the CPU
``graph=True`` reruns the same static step and segment (what the CPU tests
hold against the eager engine); with a mesh the engine stays eager.
``decode_path``, ``replays`` and ``segment_replays`` say which ran.

The slot bookkeeping lives in the native C++ core (``native/``, built with
g++ at the engine's first use), as in the JAX package: it refuses a request
with no prompt, no new tokens or more than ``max_seq_len`` tokens in all
(``submit`` raises ValueError, the request's uid spent), hands queued
requests to free slots (``fill``: a slot is held from then until its
request retires, across a multi-tick admission) and decides each
retirement (``commit``: on EOS, an exhausted budget or a full sequence).
Where the core cannot be built, ``native.PySlotScheduler`` keeps the same
rule in Python behind the same calls.  The positions live on the host in
numpy too, as in the JAX package.  The device runs the model; the host
reads back one token per slot per step.

With a ``mesh`` (``parallel.sharding.make_mesh``, one process a rank) the
slots go over "data" and the heads over "model": each rank holds B/dp
slots of Hkv/tp kv heads and its shard of the params (cut here from the
full params), and runs the same scheduler on the same ``submit`` calls, so
the core's bookkeeping is the same on every rank.  A request's prefill
runs on the data group that owns its slot (its tp ranks together) and is
inserted into that group's local cache; each decode step runs every group
that holds an active slot on its own slots (under a MoE every group, whose
routing is the whole batch's: ``models/moe.py``).  Every token, a first token or a decode step's, is
handed to every rank by a zero-padded ``all_reduce`` over "data" before it
is committed, and the pick step advances alike on every rank (a sampled
decode draw sees the whole batch's shape, so a slot's draw is one
device's).  Decode, segments, packing and compaction run on the local
slots and heads unchanged.  ``mesh=None`` is one device.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from mustafar_tpu_torch.cache import make_cache
from mustafar_tpu_torch.config import EngineConfig
from mustafar_tpu_torch.device import resolve_device
from mustafar_tpu_torch.models import llama
from mustafar_tpu_torch.native import slot_scheduler
from mustafar_tpu_torch.parallel import sharding
from mustafar_tpu_torch.runtime.generate import GREEDY, SamplingParams, StaticSegment, choose
from mustafar_tpu_torch.runtime.graphs import StepGraph


@dataclasses.dataclass
class Request:
    uid: int
    tokens: np.ndarray           # prompt token ids [T]
    max_new_tokens: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class _Admission:
    """A request whose chunked prefill is streaming into a reserved slot."""
    req: Request
    slot: int
    toks: Optional[torch.Tensor]  # [1, Tpad] padded prompt, on the device
    true_len: int
    n_seg: int
    s: int = 0                   # next segment index
    sub: Optional[dict] = None   # batch-1 cache being filled
    logits: Optional[torch.Tensor] = None   # last segment's logits [1, 1, V]


class ContinuousBatchingEngine:
    """FCFS slot scheduler over a batched decode step, on ``device``
    (default ``cuda``; params must already live there).  ``core`` keeps the
    queue and the slots (``native.slot_scheduler``).  ``mesh``: a
    ("data", "model") ``DeviceMesh`` this process is one rank of (module
    note); ``params`` are then the full params, which the engine cuts.
    ``graph``: the decode tick as a CUDA graph (module note); None takes it
    on the card without a mesh, else the eager tick."""

    def __init__(self, engine: EngineConfig, params: dict, dtype=torch.bfloat16,
                 eos_id: Optional[int] = None, sampling: SamplingParams = GREEDY,
                 interleave: bool = True, device=None, mesh=None,
                 graph: Optional[bool] = None):
        self.device = resolve_device(device)
        if graph and mesh is not None:
            raise ValueError("the decode tick of a mesh stays eager: pass graph=False")
        self.graph = (self.device.type == "cuda" and mesh is None) if graph is None \
            else graph
        self.engine = engine
        self.mesh = mesh
        dp, tp = sharding.mesh_dims(mesh)
        # a prefill runs on the slot's data group alone; a decode step on
        # every group together, each on its own slots of the one batch
        self.tp = sharding.model_shard(mesh, whole_batch=False)
        self.tp_batch = sharding.model_shard(mesh)
        # a MoE routes the whole batch (models/moe.py): every group steps
        self._groups_step_together = bool(dp > 1 and engine.model.num_experts)
        local = engine if mesh is None else sharding.local_engine(engine, dp, tp)
        self.cfg = local.model
        self.B = engine.batch_size
        self.Bl = local.batch_size          # the slots this rank holds
        if mesh is None:
            self.lo = 0
            self.params = params
        else:
            self.lo = mesh.get_local_rank("data") * self.Bl
            self._data_group = mesh.get_group("data")
            self.params = sharding.shard_params(engine.model, params, tp, self.tp.rank)
        self.dtype = dtype
        self.eos_id = eos_id
        self.sampling = sampling
        self._pick_step = 0          # the draw's step: advanced by every choice
        # interleaved admission needs segment-streamed prefill state
        self.interleave = bool(interleave and engine.chunked_prefill)
        self.impl = make_cache(local, device=self.device)
        self.cache = self.impl.init(self.Bl, dtype)
        self.core = slot_scheduler(self.B, engine.max_seq_len)
        self.slot_req: list[Optional[Request]] = [None] * self.B
        self.slot_pos = np.zeros(self.B, np.int64)      # next write index
        self.slot_last = np.zeros(self.B, np.int64)
        self.requests: dict[int, Request] = {}
        self.finished: dict[int, Request] = {}
        self._admissions: deque[_Admission] = deque()
        self._uid = 0
        self.ticks = 0               # engine ticks run (admission + decode)
        self.decode_steps = 0        # batched decode steps run on this rank
        self.segments = 0            # chunked-prefill segments run on this rank
        self._step_graph = None      # the static decode step (graph), built at first use
        self._step_io = None         # its input buffer [2, Bl]: last tokens, positions
        self._segment = None         # the static admission segment, made at first use

    # -- public API -------------------------------------------------------
    def submit(self, tokens, max_new_tokens: int) -> int:
        """Queue a request; returns its uid.  A request with no prompt, no
        new tokens or more than ``max_seq_len`` tokens in all raises
        ValueError, and its uid stays spent (the next request's is one
        higher), as in the JAX package."""
        tokens = np.asarray(tokens, np.int64)
        self._uid += 1
        self.requests[self._uid] = Request(self._uid, tokens, max_new_tokens)
        if not self.core.submit(self._uid, len(tokens), max_new_tokens):
            raise ValueError(f"request {self._uid} refused: a prompt of {len(tokens)} "
                             f"tokens and {max_new_tokens} new ones (each must be at "
                             f"least 1) in max_seq_len {self.engine.max_seq_len}")
        return self._uid

    def run(self, max_steps: int = 100000) -> dict[int, np.ndarray]:
        """Drain the queue; returns {uid: generated token ids}."""
        with torch.inference_mode():
            while self.busy() and self.ticks < max_steps:
                self.tick()
        return {uid: np.asarray(r.out) for uid, r in self.finished.items()}

    def busy(self) -> bool:
        return bool(self.core.num_queued or self._admissions
                    or any(r is not None for r in self.slot_req))

    @torch.inference_mode()
    def tick(self):
        """One engine tick: admit (one segment, when interleaved), then one
        batched decode step."""
        self._fill_slots()
        self._decode_step()
        self.ticks += 1

    @property
    def active_mask(self) -> np.ndarray:
        return np.array([r is not None for r in self.slot_req])

    # -- token choice -------------------------------------------------------
    def _next_pick_step(self) -> int:
        self._pick_step += 1
        return self._pick_step

    def _choose(self, logits2d: torch.Tensor, reqs: list) -> np.ndarray:
        """Token choice (``generate.choose``, at the next pick step) for the
        rows of ``logits2d`` [n, V]; ``reqs`` names the request of each row
        (None for an idle slot, whose token is dropped).  One device read."""
        return choose(logits2d, self.sampling, self._next_pick_step()).cpu().numpy()

    # -- data parallelism -----------------------------------------------------
    def _owns(self, slot: int) -> bool:
        return self.lo <= slot < self.lo + self.Bl

    def _share(self, toks: np.ndarray) -> np.ndarray:
        """Tokens known on their owners' ranks (0 elsewhere) -> on every
        rank: a SUM over "data", one owner a slot."""
        if self.mesh is None:
            return toks
        t = torch.from_numpy(np.ascontiguousarray(toks, np.int64)).to(self.device)
        return sharding.all_reduce(t, self._data_group).cpu().numpy()

    @property
    def decode_path(self) -> str:
        """"graph" (CUDA graph replays), "static" (the CPU's reruns of the
        static step) or "eager"."""
        if not self.graph:
            return "eager"
        return "graph" if self.device.type == "cuda" else "static"

    @property
    def replays(self) -> int:
        """Decode ticks run by replaying the captured step (after its first,
        which captures)."""
        return 0 if self._step_graph is None else self._step_graph.replays

    @property
    def segment_replays(self) -> int:
        """Admission segments run by replaying the captured segment (after
        its first, which captures); 0 on the eager path."""
        return 0 if self._segment is None or not self.graph else self._segment.graph.replays

    # -- internals --------------------------------------------------------
    def _static_step(self, last: np.ndarray, pos: np.ndarray) -> torch.Tensor:
        """The per-slot decode step through the static buffer and the
        ``StepGraph``: this tick's last tokens and positions copied in (one
        host-to-device copy), the step replayed -> logits [Bl, 1, V]."""
        if self._step_graph is None:
            self._step_io = torch.zeros((2, self.Bl), dtype=torch.int64, device=self.device)
            tok, slot_pos = self._step_io[0][:, None], self._step_io[1]
            cfg, params, cache, impl = self.cfg, self.params, self.cache, self.impl

            def step():
                return llama.decode_step(cfg, params, tok, cache, impl, slot_pos)[0]

            self._step_graph = StepGraph(step, self.device, self.device.type == "cuda")
        self._step_io.copy_(torch.from_numpy(np.stack([last, pos])))
        return self._step_graph.run()

    def _bucket(self, n: int) -> int:
        b = self.engine.prefill_bucket
        return max(b, (n + b - 1) // b * b)

    def _padded(self, req: Request, slot: int):
        """The padded prompt on the device (None on a rank that does not
        own ``slot``) and its length."""
        T = len(req.tokens)
        if not self._owns(slot):
            return None, T
        Tpad = self._bucket(T)
        toks = torch.zeros((1, Tpad), dtype=torch.int64)
        toks[0, :T] = torch.from_numpy(req.tokens)
        return toks.to(self.device), T

    def _start_slot(self, req: Request, slot: int, true_len: int, logits, sub):
        """Pick the first token from prefill logits, insert the request's
        cache into its slot and commit the token.  A rank that does not own
        the slot has no logits: it advances the pick step and is handed the
        token."""
        if self._owns(slot):
            nxt = self._choose(logits[:, 0], [req])
            self.impl.insert_slot(self.cache, sub, slot - self.lo)
        else:
            self._next_pick_step()
            nxt = np.zeros(1, np.int64)
        nxt = int(self._share(nxt)[0])
        self.slot_req[slot] = req
        self.slot_pos[slot] = true_len + 1
        self.slot_last[slot] = nxt
        req.out.append(nxt)
        if self._commit(slot, nxt):
            self._retire(slot)

    def _admission_segment(self) -> StaticSegment:
        """The static segment of the next chunked admission, over the
        engine's one batch-1 sub-cache (admissions advance one at a time, at
        the head), reset in place: with ``graph`` on the card its graph
        replays, else its program reruns eagerly (with the mesh's ``tp``)."""
        if self._segment is None:
            self._segment = StaticSegment(self.cfg, self.params,
                                          self.impl.init(1, self.dtype), self.impl, 1,
                                          self.device,
                                          self.graph and self.device.type == "cuda",
                                          tp=self.tp)
        self.impl.reset(self._segment.cache)
        return self._segment

    def _prefill_into_slot(self, req: Request, slot: int):
        """Blocking admission: the whole prefill (monolithic, or every
        segment of the static segment when chunked) runs now."""
        toks, T = self._padded(req, slot)
        logits = sub = None
        if toks is not None:
            if self.engine.chunked_prefill:
                seg = self._admission_segment()
                logits, sub = seg.prefill(toks, T), seg.cache
                self.segments += llama.n_segments(T, self.impl.C)
            else:
                sub = self.impl.init(1, self.dtype)
                logits, sub = llama.prefill(self.cfg, self.params, toks, sub, self.impl,
                                            T, last_only=True, tp=self.tp)
        self._start_slot(req, slot, T, logits, sub)

    def _fill_slots(self):
        admit = self._start_admission if self.interleave else self._prefill_into_slot
        # the core marks a slot busy at fill(), so a multi-tick admission
        # holds it until its request retires
        for slot, uid, _, _ in self.core.fill():
            admit(self.requests[uid], slot)
        if self._admissions:
            self._admission_tick()

    # -- interleaved (segment-per-tick) admission ---------------------------
    def _start_admission(self, req: Request, slot: int):
        """Reserve ``slot`` for ``req``; its prompt's segments (those that
        hold prompt tokens, ``llama.n_segments``) then run one a tick."""
        toks, T = self._padded(req, slot)
        self._admissions.append(_Admission(
            req=req, slot=slot, toks=toks, true_len=T,
            n_seg=llama.n_segments(T, self.impl.C)))

    def _admission_tick(self):
        """Advance the head admission by one C-token segment (one run of the
        static segment, ``_admission_segment``, taken when it starts); once
        its prompt is absorbed, hand the slot to decode.  The decode step
        that follows in the same tick keeps every active slot emitting."""
        adm = self._admissions[0]
        C = self.impl.C
        s = adm.s
        if adm.toks is not None:
            if s == 0:
                adm.sub = self._admission_segment().cache
            adm.logits = self._segment.step(adm.toks[:, s * C:(s + 1) * C], s * C,
                                            adm.true_len)
            self.segments += 1
        adm.s += 1
        if adm.s < adm.n_seg:
            return
        self._admissions.popleft()
        self._start_slot(adm.req, adm.slot, adm.true_len, adm.logits, adm.sub)

    def _decode_step(self):
        active = self.active_mask
        if not active.any():
            return
        lo, hi = self.lo, self.lo + self.Bl
        nxt = np.zeros(self.B, np.int64)
        if active[lo:hi].any() or self._groups_step_together:
            # idle slots ride along at position -1 (slot_pos 0) and keep
            # their last token; the caches neither write nor attend them
            if self.graph:
                logits = self._static_step(self.slot_last[lo:hi], self.slot_pos[lo:hi] - 1)
            else:
                tok = torch.from_numpy(self.slot_last[lo:hi, None]).to(self.device)
                pos = torch.from_numpy(self.slot_pos[lo:hi] - 1).to(self.device)
                logits, self.cache = llama.decode_step(self.cfg, self.params, tok,
                                                       self.cache, self.impl, pos,
                                                       tp=self.tp_batch)
            logits = logits[:, 0]
            reqs = list(self.slot_req)
            if self.mesh is not None:
                # the whole batch's shape, this rank's rows in place
                logits = torch.cat([logits.new_zeros((lo, logits.shape[-1])), logits,
                                    logits.new_zeros((self.B - hi, logits.shape[-1]))])
                reqs = [r if self._owns(b) else None for b, r in enumerate(reqs)]
            nxt[lo:hi] = self._choose(logits, reqs)[lo:hi]
            self.decode_steps += 1
        else:
            # no slot of this rank's: its data group skips the model
            self._next_pick_step()
        nxt = self._share(nxt)
        for slot in range(self.B):
            req = self.slot_req[slot]
            if req is None:
                continue
            t = int(nxt[slot])
            req.out.append(t)
            self.slot_last[slot] = t
            self.slot_pos[slot] += 1
            if self._commit(slot, t):
                self._retire(slot)
        self._maybe_compact()

    def _commit(self, slot: int, tok: int) -> bool:
        """Retire on EOS, an exhausted budget or a full sequence, as the core
        decides."""
        return self.core.commit(slot, self.eos_id is not None and tok == self.eos_id) == 1

    def _maybe_compact(self):
        """Compressed caches: compact the active slots (of this rank) whose
        window just filled.  The cache holds slot_pos - 1 tokens here
        (slot_pos already counts the token the step just committed)."""
        if not hasattr(self.impl, "compact_slots"):
            return
        flags = [self.slot_req[b] is not None
                 and self.impl.needs_compact(int(self.slot_pos[b]) - 1)
                 for b in range(self.lo, self.lo + self.Bl)]
        if any(flags):
            self.impl.compact_slots(self.cache, flags)

    def _retire(self, slot: int):
        req = self.slot_req[slot]
        if self.eos_id is not None and req.out and req.out[-1] == self.eos_id:
            req.out.pop()
        req.done = True
        self.finished[req.uid] = req
        self.slot_req[slot] = None
        self.slot_pos[slot] = 0
