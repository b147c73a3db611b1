"""Continuous-batching decode scheduler (slot-based): port of
``ContinuousBatchingEngine`` in ``mustafar_tpu/runtime/scheduler.py``,
greedy or sampled, on one device, with the slot bookkeeping in Python.

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

The JAX package keeps the slot bookkeeping in a native C++ core when it
can load one and in Python otherwise; the port has the Python rule only
(retire on EOS, on an exhausted budget or at full capacity).  The device
runs the model; the host reads back one token per slot per step.
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
from mustafar_tpu_torch.runtime.generate import GREEDY, SamplingParams, choose


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
    toks: torch.Tensor           # [1, Tpad] padded prompt, on the device
    true_len: int
    n_seg: int
    s: int = 0                   # next segment index
    sub: Optional[dict] = None   # batch-1 cache being filled
    logits: Optional[torch.Tensor] = None   # last segment's logits [1, 1, V]


class ContinuousBatchingEngine:
    """FCFS slot scheduler over a batched decode step, on ``device``
    (default ``cuda``; params must already live there)."""

    def __init__(self, engine: EngineConfig, params: dict, dtype=torch.bfloat16,
                 eos_id: Optional[int] = None, sampling: SamplingParams = GREEDY,
                 interleave: bool = True, device=None):
        self.device = resolve_device(device)
        self.engine = engine
        self.cfg = engine.model
        self.params = params
        self.dtype = dtype
        self.eos_id = eos_id
        self.sampling = sampling
        self._pick_step = 0          # the draw's step: advanced by every choice
        # interleaved admission needs segment-streamed prefill state
        self.interleave = bool(interleave and engine.chunked_prefill)
        self.B = engine.batch_size
        self.impl = make_cache(engine, device=self.device)
        self.cache = self.impl.init(self.B, dtype)
        self.slot_req: list[Optional[Request]] = [None] * self.B
        self.slot_pos = np.zeros(self.B, np.int64)      # next write index
        self.slot_budget = np.zeros(self.B, np.int64)
        self.slot_last = np.zeros(self.B, np.int64)
        self.queue: deque[Request] = deque()
        self.requests: dict[int, Request] = {}
        self.finished: dict[int, Request] = {}
        self._admissions: deque[_Admission] = deque()
        self._uid = 0
        self.ticks = 0               # engine ticks run (admission + decode)
        self.decode_steps = 0        # batched decode steps run
        self.segments = 0            # chunked-prefill segments run

    # -- public API -------------------------------------------------------
    def submit(self, tokens, max_new_tokens: int) -> int:
        tokens = np.asarray(tokens, np.int64)
        if len(tokens) + max_new_tokens > self.engine.max_seq_len:
            raise ValueError(f"request of {len(tokens)} + {max_new_tokens} tokens "
                             f"exceeds max_seq_len {self.engine.max_seq_len}")
        self._uid += 1
        req = Request(self._uid, tokens, max_new_tokens)
        self.requests[self._uid] = req
        self.queue.append(req)
        return self._uid

    def run(self, max_steps: int = 100000) -> dict[int, np.ndarray]:
        """Drain the queue; returns {uid: generated token ids}."""
        with torch.inference_mode():
            while self.busy() and self.ticks < max_steps:
                self.tick()
        return {uid: np.asarray(r.out) for uid, r in self.finished.items()}

    def busy(self) -> bool:
        return bool(self.queue or self._admissions
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

    # -- internals --------------------------------------------------------
    def _bucket(self, n: int) -> int:
        b = self.engine.prefill_bucket
        return max(b, (n + b - 1) // b * b)

    def _padded(self, req: Request):
        T = len(req.tokens)
        Tpad = self._bucket(T)
        toks = torch.zeros((1, Tpad), dtype=torch.int64)
        toks[0, :T] = torch.from_numpy(req.tokens)
        return toks.to(self.device), T

    def _start_slot(self, req: Request, slot: int, true_len: int, logits, sub):
        """Pick the first token from prefill logits, insert the request's
        cache into its slot and commit the token."""
        nxt = int(self._choose(logits[:, 0], [req])[0])
        self.impl.insert_slot(self.cache, sub, slot)
        self.slot_req[slot] = req
        self.slot_pos[slot] = true_len + 1
        self.slot_budget[slot] = req.max_new_tokens - 1
        self.slot_last[slot] = nxt
        req.out.append(nxt)
        if self._commit(slot, nxt):
            self._retire(slot)

    def _prefill_into_slot(self, req: Request, slot: int):
        """Blocking admission: the whole prefill (monolithic, or every
        segment when chunked) runs now."""
        toks, T = self._padded(req)
        sub = self.impl.init(1, self.dtype)
        if self.engine.chunked_prefill:
            logits, sub = llama.prefill_chunked(self.cfg, self.params, toks, sub,
                                                self.impl, T)
            self.segments += llama.n_segments(T, self.impl.C)
        else:
            logits, sub = llama.prefill(self.cfg, self.params, toks, sub, self.impl,
                                        T, last_only=True)
        self._start_slot(req, slot, T, logits, sub)

    def _fill_slots(self):
        admit = self._start_admission if self.interleave else self._prefill_into_slot
        reserved = {a.slot for a in self._admissions}
        for slot in range(self.B):
            if self.slot_req[slot] is None and slot not in reserved and self.queue:
                admit(self.queue.popleft(), slot)
                reserved.add(slot)
        if self._admissions:
            self._admission_tick()

    # -- interleaved (segment-per-tick) admission ---------------------------
    def _start_admission(self, req: Request, slot: int):
        """Reserve ``slot`` for ``req``; its prompt's segments (those that
        hold prompt tokens, ``llama.n_segments``) then run one a tick."""
        toks, T = self._padded(req)
        self._admissions.append(_Admission(
            req=req, slot=slot, toks=toks, true_len=T,
            n_seg=llama.n_segments(T, self.impl.C), sub=self.impl.init(1, self.dtype)))

    def _admission_tick(self):
        """Advance the head admission by one C-token segment; once its
        prompt is absorbed, hand the slot to decode.  The decode step that
        follows in the same tick keeps every active slot emitting."""
        adm = self._admissions[0]
        C = self.impl.C
        s = adm.s
        adm.logits, adm.sub = llama.prefill_segment(
            self.cfg, self.params, adm.toks[:, s * C:(s + 1) * C], adm.sub,
            self.impl, s * C, adm.true_len)
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
        # idle slots ride along at position -1 (slot_pos 0) and keep their
        # last token; the caches neither write nor attend them
        tok = torch.from_numpy(self.slot_last[:, None]).to(self.device)
        pos = torch.from_numpy(self.slot_pos - 1).to(self.device)
        logits, self.cache = llama.decode_step(self.cfg, self.params, tok, self.cache,
                                               self.impl, pos)
        nxt = self._choose(logits[:, 0], list(self.slot_req))
        self.decode_steps += 1
        for slot in range(self.B):
            req = self.slot_req[slot]
            if req is None:
                continue
            t = int(nxt[slot])
            req.out.append(t)
            self.slot_last[slot] = t
            self.slot_pos[slot] += 1
            self.slot_budget[slot] -= 1
            if self._commit(slot, t):
                self._retire(slot)
        self._maybe_compact()

    def _commit(self, slot: int, tok: int) -> bool:
        """Retire on EOS, an exhausted budget or a full sequence."""
        is_eos = self.eos_id is not None and tok == self.eos_id
        return bool(is_eos or self.slot_budget[slot] <= 0
                    or self.slot_pos[slot] >= self.engine.max_seq_len)

    def _maybe_compact(self):
        """Compressed caches: compact the active slots whose window just
        filled.  The cache holds slot_pos - 1 tokens here (slot_pos already
        counts the token the step just committed)."""
        if not hasattr(self.impl, "compact_slots"):
            return
        flags = [self.slot_req[b] is not None
                 and self.impl.needs_compact(int(self.slot_pos[b]) - 1)
                 for b in range(self.B)]
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
