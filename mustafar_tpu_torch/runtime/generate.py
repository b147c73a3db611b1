"""Generation: port of ``mustafar_tpu/runtime/generate.py``, with
monolithic or chunked prefill, greedy or sampled token choice.

The JAX package runs prefill and the decode loop on the device in one jit;
here a host loop drives one decode step at a time.  Compaction happens
between steps, never inside one: after exactly the step at which the JAX
loop's ``window_full`` fires (the window holds ``total - n_chunks*C`` tokens
and is full at r + C).  EOS handling follows HF greedy: a finished row keeps
emitting its EOS and the loop stops once every row is done; EOS is
suppressed for the first ``min_new_tokens`` tokens.  With
``EngineConfig.chunked_prefill`` the prompt goes in one C-token segment at a
time (a host loop over segments, as the JAX package drives it), then the
same decode loop runs.

Sampling (``SamplingParams`` with a temperature above 0) is the JAX
package's ``_sample``: the logits over the temperature, then top-k (the
tokens below the k-th largest logit dropped, so ties at the k-th are kept),
then top-p (sorted, a token kept while the probability before it sums
below p; the first always kept), then one categorical draw.  The draw is
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
        keep[:, 0] = True
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


class Generator:
    """Decode engine for a fixed EngineConfig, on ``device`` (default
    ``cuda``; params must already live there)."""

    def __init__(self, engine: EngineConfig, params: dict, dtype=torch.bfloat16,
                 device=None):
        self.device = resolve_device(device)
        self.engine = engine
        self.cfg = engine.model
        self.params = params
        self.dtype = dtype
        self.cache_impl = make_cache(engine, device=self.device)
        self.last_cache = None      # the cache state the last generate left

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
        cache = impl.init(B, self.dtype)
        if self.engine.chunked_prefill:
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
        result = []
        for row in out.cpu().numpy():
            if eos_ids:
                stop = np.where(np.isin(row, eos_ids))[0]
                row = row[: stop[0]] if len(stop) else row
            result.append(row)
        return result
