"""Generation: port of ``mustafar_tpu/runtime/generate.py``, with
monolithic or chunked prefill, greedy or sampled token choice.

The JAX package runs prefill and the decode loop on the device in one jit.
Here a host loop steps the decode (and the chunked prefill's segments), in
one of two ways (``Generator(graph=...)``, chosen from the device before
anything is captured, never from an error):
  * the compiled decode (the default on the card): one decode step, from a
    static token buffer and a 0-d device position to the logits, runs as a
    ``runtime.graphs.StepGraph``: captured once as a CUDA graph and
    replayed every step.  The step reads every count on the device (the
    position, each layer's ``n_chunks`` and window length; kernels 1 and 6
    take them as the TPU kernels take their scalar prefetch), and the dense
    and masked caches attend all max_seq_len rows masked by the position, as
    the JAX package's static-shape loop does.  The cache state, the buffers
    and the graph are kept per (batch size, cache settings), as JAX keeps
    one compile per key, and the state is zeroed in place for the next
    ``generate``: the graph holds its addresses.  What the key holds: the
    cache at max_seq_len for the batch, and the graph's pool of one step's
    intermediates.  With ``EngineConfig.chunked_prefill`` the key also
    holds the compiled chunked prefill (``StaticSegment``): one whole-model
    segment, from a static token buffer [B, C] and 0-d ``seg_start`` and
    ``true_len`` to the last-position logits, writing the same static
    cache, captured once and replayed for every segment (kernels 3 and 8
    read ``n_chunks`` and ``seg_start`` on the device; the segment's pack is
    staged and written under a device predicate); ``last_prefill_replays``
    says how many segments replayed it.  On the CPU ``graph=True`` runs the
    same static programs, the same callables rerun on the same buffers,
    which is what the CPU tests hold against the eager loop and the JAX
    package;
  * the eager loop (the default on the CPU, ``graph=False`` on the card):
    every op of every step enqueued from Python at the host's position;
    the segments run the same segment program (host counts put on the
    device once a segment), op by op.
The token choice, the EOS bookkeeping and the output write run eagerly on
the step's logits in both, so greedy and sampled decoding share either
path.  ``last_path`` ("graph", "static" or "eager") and ``last_replays``
say what the last ``generate`` ran.  Compaction happens between steps,
eagerly, never inside one: after exactly the step at which the JAX loop's
``window_full`` fires (the window holds ``total - n_chunks*C`` tokens and
is full at r + C); it updates the device counts and the host copy in
place.  EOS handling follows HF greedy: a finished row keeps
emitting its EOS and the loop stops once every row is done; EOS is
suppressed for the first ``min_new_tokens`` tokens.  With
``EngineConfig.chunked_prefill`` the prompt goes in one C-token segment at a
time (a host loop over the ``llama.n_segments(true_len, C)`` segments, as
the JAX package drives it), then the same decode loop runs.

Sampling (``SamplingParams`` with a temperature above 0) is the JAX
package's ``_sample``: the logits over the temperature, then top-k (the
tokens below the k-th largest logit dropped, so ties at the k-th are kept),
then top-p (sorted, a token kept while the probability before it sums
below p: so at p > 0 the first is kept, its sum being 0, and at p <= 0
none is, every logit is -inf and the draw returns token 0, as JAX's
categorical does), then one categorical draw.  The draw is
a Gumbel-max over uniforms from a ``torch.Generator`` on the logits'
device seeded from (seed, pick step), as the JAX package folds the step
into its key: the same (seed, step, logits) give the same tokens on one
device.  The tokens are not the JAX package's (its PRNG is threefry), but
the kept set is.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mustafar_tpu_torch.cache import make_cache
from mustafar_tpu_torch.config import EngineConfig
from mustafar_tpu_torch.device import resolve_device
from mustafar_tpu_torch.models import llama
from mustafar_tpu_torch.runtime.graphs import StepGraph


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """The JAX package's token-choice settings.  temperature == 0 is greedy
    argmax (top_k and top_p ignored); top_k == 0 no top-k cutoff; top_p ==
    1.0 no nucleus cutoff."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


GREEDY = SamplingParams()


def filter_logits(logits2d: torch.Tensor, sp: SamplingParams) -> torch.Tensor:
    """The JAX package's sampling filter on logits [B, V]: f32 logits over
    the temperature, -inf outside the kept set (top-k, then top-p; module
    note)."""
    l = logits2d.to(torch.float32) / sp.temperature
    if sp.top_k and sp.top_k < l.shape[-1]:
        kth = torch.topk(l, sp.top_k, dim=-1).values[:, -1:]
        l = torch.where(l < kth, float("-inf"), l)
    if sp.top_p < 1.0:
        srt = torch.sort(l, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < sp.top_p
        cutoff = torch.where(keep, srt, float("inf")).amin(dim=-1, keepdim=True)
        l = torch.where(l < cutoff, float("-inf"), l)
    return l


_MASK64 = (1 << 64) - 1


def pick_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one pick: on ``device``, seeded with splitmix64 of
    (seed, step), so that every bit of the seed depends on both (the CPU
    generator reads only the low 32)."""
    z = ((((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF))
         + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    g = torch.Generator(device=device)
    g.manual_seed((z ^ (z >> 31)) >> 1)             # a non-negative int64
    return g


def sample(logits2d: torch.Tensor, sp: SamplingParams, step: int) -> torch.Tensor:
    """One filtered categorical draw a row of logits [B, V] -> [B] int64
    (``filter_logits``, then the Gumbel-max of ``pick_generator(sp.seed,
    step)``'s uniforms)."""
    l = filter_logits(logits2d, sp)
    u = torch.rand(l.shape, generator=pick_generator(sp.seed, step, l.device),
                   device=l.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(l + gumbel, dim=-1)


def choose(logits2d: torch.Tensor, sp: SamplingParams, step: int) -> torch.Tensor:
    """Token choice per ``sp``: greedy argmax, or ``sample`` at pick ``step``."""
    if sp.greedy:
        return torch.argmax(logits2d, dim=-1)
    return sample(logits2d, sp, step)


class StaticSegment:
    """The compiled chunked prefill over one cache: the static segment
    buffers (tokens [B, C], 0-d int64 ``seg_start`` and ``true_len``) and
    the ``StepGraph`` of one whole-model segment between them, the cache
    (written in place, ``n_chunks`` read on the device) and the
    last-position logits [B, 1, V].  ``prefill`` runs a prompt's segments
    through it, one replay a segment, as the JAX package replays its one
    jitted segment program from a host loop.  Without ``graph`` the same
    program reruns eagerly; ``tp``: the rank's ``ModelShard`` (an engine's
    on a mesh, which stays eager)."""

    def __init__(self, cfg, params, cache: dict, impl, B: int, device, graph: bool,
                 tp=None):
        self.cache, self.impl = cache, impl
        self.tok = torch.zeros((B, impl.C), dtype=torch.int64, device=device)
        self.seg_start = torch.zeros((), dtype=torch.int64, device=device)
        self.true_len = torch.zeros((), dtype=torch.int64, device=device)
        tok, seg_start, true_len = self.tok, self.seg_start, self.true_len

        def segment():
            return llama.prefill_segment(cfg, params, tok, cache, impl, seg_start, true_len,
                                         tp)[0]

        self.graph = StepGraph(segment, device, graph)

    def step(self, seg_tokens: torch.Tensor, seg_start: int, true_len: int) -> torch.Tensor:
        """One segment: seg_tokens [B, C] (on the device), its start and the
        prompt's length copied into the buffers, the graph replayed; the
        cache's host count follows on the host (``segment_host_count``).
        Returns the logits [B, 1, V] (the graph's static output, which the
        next replay overwrites)."""
        self.tok.copy_(seg_tokens)
        self.seg_start.fill_(seg_start)
        self.true_len.fill_(true_len)
        logits = self.graph.run()
        self.cache["nc_host"] = self.impl.segment_host_count(self.cache["nc_host"],
                                                             seg_start, true_len)
        return logits

    def prefill(self, toks: torch.Tensor, true_len: int) -> torch.Tensor:
        """``llama.prefill_chunked`` of toks [B, T] (on the device) into the
        cache, one ``step`` a segment, over the host count of segments
        ``llama.n_segments(true_len, C)``.  Returns the last segment's
        logits [B, 1, V]."""
        C = self.impl.C
        llama.check_chunked(toks.shape[1], true_len, C)
        for seg_start in range(0, llama.n_segments(true_len, C) * C, C):
            logits = self.step(toks[:, seg_start:seg_start + C], seg_start, true_len)
        return logits


class _StaticDecode:
    """The compiled decode's state for one key: the cache, the static token
    buffer [B, 1] and position (0-d), and the ``StepGraph`` of the step
    between them and the logits [B, 1, V]; with chunked prefill also the
    ``StaticSegment`` over the same cache."""

    def __init__(self, gen, B: int, graph: bool):
        cfg, params, impl = gen.cfg, gen.params, gen.cache_impl
        self.cache = impl.init(B, gen.dtype)
        self.tok = torch.zeros((B, 1), dtype=torch.int64, device=gen.device)
        self.pos = torch.zeros((), dtype=torch.int64, device=gen.device)
        cache, tok, pos = self.cache, self.tok, self.pos

        def step():
            return llama.decode_step(cfg, params, tok, cache, impl, pos)[0]

        self.graph = StepGraph(step, gen.device, graph)
        self.segment = (StaticSegment(cfg, params, cache, impl, B, gen.device, graph)
                        if gen.engine.chunked_prefill else None)


class Generator:
    """Decode engine for a fixed EngineConfig, on ``device`` (default
    ``cuda``; params must already live there).  ``graph``: the compiled
    decode (module note); None takes it on the card and the eager loop on
    the CPU."""

    def __init__(self, engine: EngineConfig, params: dict, dtype=torch.bfloat16,
                 device=None, graph: bool | None = None):
        self.device = resolve_device(device)
        self.engine = engine
        self.cfg = engine.model
        self.params = params
        self.dtype = dtype
        self.cache_impl = make_cache(engine, device=self.device)
        self.graph = self.device.type == "cuda" if graph is None else graph
        self._static: dict = {}     # (B, cache settings) -> _StaticDecode
        self.last_cache = None      # the cache state the last generate left
        self.last_path = None       # "graph", "static" or "eager"
        self.last_replays = 0
        self.last_captured = {}     # the step graph's launches a replay, by wrapper
        self.last_prefill_replays = 0     # the segment graph's (chunked prefill)

    def _bucket(self, n: int) -> int:
        b = self.engine.prefill_bucket
        return max(b, (n + b - 1) // b * b)

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: int, eos_id=None,
                 min_new_tokens: int = 0, sampling: SamplingParams = GREEDY):
        """input_ids [B, T] ints (uniform length, left-aligned, no padding).

        eos_id: an int or a sequence of ints, any of which ends a row.
        Returns a list of B 1-D numpy arrays of generated ids (EOS excluded).
        ``sampling``: greedy by default; otherwise pick ``step`` (1 for the
        first token, i + 1 for token i) seeds the draw (module note).
        """
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.int64)
        B, T = ids.shape
        Tpad = self._bucket(T)
        if Tpad + max_new_tokens > self.engine.max_seq_len:
            raise ValueError(f"prompt {T} (padded {Tpad}) + {max_new_tokens} "
                             f"exceeds max_seq_len {self.engine.max_seq_len}")
        if eos_id is None:
            eos_ids = ()
        elif isinstance(eos_id, (int, np.integer)):
            eos_ids = (int(eos_id),)
        else:
            eos_ids = tuple(int(e) for e in eos_id)
        toks = torch.zeros((B, Tpad), dtype=torch.int64)
        toks[:, :T] = ids
        toks = toks.to(self.device)

        impl, cfg, params = self.cache_impl, self.cfg, self.params
        self.last_cache = None
        static = None
        if self.graph:
            key = (B, getattr(impl, "use_pallas", None))
            static = self._static.get(key)
            if static is None:
                static = self._static[key] = _StaticDecode(
                    self, B, self.device.type == "cuda")
            cache = impl.reset(static.cache)
            replays0 = static.graph.replays
            seg_replays0 = static.segment.graph.replays if static.segment else 0
        else:
            cache = impl.init(B, self.dtype)
        if static is not None and static.segment is not None:
            logits = static.segment.prefill(toks, T)
        elif self.engine.chunked_prefill:
            logits, cache = llama.prefill_chunked(cfg, params, toks, cache, impl, T)
        else:
            logits, cache = llama.prefill(cfg, params, toks, cache, impl, T,
                                          last_only=True)

        def pick(logits2d, step):
            if eos_ids and min_new_tokens > 0 and step <= min_new_tokens:
                logits2d = logits2d.clone()
                logits2d[:, list(eos_ids)] = float("-inf")
            return choose(logits2d, sampling, step)

        def is_eos(tok):
            hit = torch.zeros_like(tok, dtype=torch.bool)
            for e in eos_ids:
                hit |= tok == e
            return hit

        tok = pick(logits[:, 0], 1)
        out = torch.zeros((B, max_new_tokens), dtype=torch.int64, device=self.device)
        out[:, 0] = tok
        done = is_eos(tok)
        has_compact = hasattr(impl, "compact")
        i = 1
        # with EOS ids the loop reads `done` from the device once a step
        while i < max_new_tokens and not (eos_ids and bool(done.all())):
            pos = T + i - 1
            if static is not None:
                static.tok.copy_(tok[:, None])
                static.pos.fill_(pos)
                logits = static.graph.run()
            else:
                logits, cache = llama.decode_step(cfg, params, tok[:, None], cache,
                                                  impl, pos)
            nxt = pick(logits[:, 0], i + 1)
            if eos_ids:
                nxt = torch.where(done, torch.full_like(nxt, eos_ids[0]), nxt)
                done = done | is_eos(nxt)
            out[:, i] = nxt
            tok = nxt
            i += 1
            if has_compact and impl.window_full(cache, T + i - 1):
                impl.compact(cache)
        self.last_cache = cache
        self.last_prefill_replays = 0
        if static is None:
            self.last_path, self.last_replays, self.last_captured = "eager", 0, {}
        else:
            self.last_path = "graph" if static.graph.graph else "static"
            self.last_replays = static.graph.replays - replays0
            self.last_captured = dict(static.graph.captured)
            if static.segment is not None:
                self.last_prefill_replays = static.segment.graph.replays - seg_replays0
        result = []
        for row in out.cpu().numpy():
            if eos_ids:
                stop = np.where(np.isin(row, eos_ids))[0]
                row = row[: stop[0]] if len(stop) else row
            result.append(row)
        return result
