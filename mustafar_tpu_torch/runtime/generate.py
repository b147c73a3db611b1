"""Greedy generation: port of the greedy, monolithic-prefill path of
``mustafar_tpu/runtime/generate.py``.

The JAX package runs prefill and the decode loop on the device in one jit;
here a host loop drives one decode step at a time.  Compaction happens
between steps, never inside one: after exactly the step at which the JAX
loop's ``window_full`` fires (the window holds ``total - n_chunks*C`` tokens
and is full at r + C).  EOS handling follows HF greedy: a finished row keeps
emitting its EOS and the loop stops once every row is done; EOS is
suppressed for the first ``min_new_tokens`` tokens.
"""

from __future__ import annotations

import numpy as np
import torch

from mustafar_tpu_torch.cache import make_cache
from mustafar_tpu_torch.config import EngineConfig
from mustafar_tpu_torch.device import resolve_device
from mustafar_tpu_torch.models import llama


class Generator:
    """Greedy-decode engine for a fixed EngineConfig, on ``device``
    (default ``cuda``; params must already live there)."""

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
                 min_new_tokens: int = 0):
        """input_ids [B, T] ints (uniform length, left-aligned, no padding).

        eos_id: an int or a sequence of ints, any of which ends a row.
        Returns a list of B 1-D numpy arrays of generated ids (EOS excluded).
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
        logits, cache = llama.prefill(cfg, params, toks, cache, impl, T,
                                      last_only=True)

        def pick(logits2d, step):
            if eos_ids and min_new_tokens > 0 and step <= min_new_tokens:
                logits2d = logits2d.clone()
                logits2d[:, list(eos_ids)] = float("-inf")
            return torch.argmax(logits2d, dim=-1)

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
