"""Llama-2/3, Mistral and Mixtral forward pass, port of
``mustafar_tpu/models/llama.py``.

Params are a plain dict with the JAX package's layout: per-layer leaves
stacked on axis 0 ([L, in, out] weights, [L, H] norms).  The JAX package
scans over layers; here a Python loop takes layer ``li``'s leaves as views
(no copy).  Attention and the KV cache are delegated to a cache impl
(``mustafar_tpu_torch.cache``), which takes Mistral's sliding window from
the model's ``sliding_window`` in prefill and decode, as the JAX package's
caches do, and updates its state dict IN PLACE: one
cache buffer lives for the whole generation, where JAX threads immutable
state through the scan.  A layer whose leaves hold ``w_router`` runs
Mixtral's sparse-MoE MLP (``models/moe.py``) in place of the dense one.

Under tensor parallelism (``tp``, a ``parallel.sharding.ModelShard``) the
params are one rank's shard and ``cfg`` its local config: ``wo`` and
``w_down`` reduce their partial products over the "model" group
(``quant.proj``), the MoE sums its experts' partial combine, and a
vocabulary-parallel LM head gathers the full logits, where GSPMD inserts
the same collectives in the JAX package.  ``tp=None`` is one device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from mustafar_tpu_torch.config import ModelConfig
from mustafar_tpu_torch.device import device_int, resolve_device
from mustafar_tpu_torch.models.moe import init_moe_params, moe_mlp
from mustafar_tpu_torch.models.quant import embed_lookup, proj, w8a8_dot
from mustafar_tpu_torch.models.rope import apply_rope, rope_cos_sin


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None, dtype=torch.bfloat16, seed: int = 0) -> dict:
    """Random params in ``dtype`` on ``device`` (default ``cuda``), drawn one
    layer at a time from ``generator``.  Same structure and scales as the
    JAX package's ``init_params``; the random bits differ (parity tests carry
    JAX weights across with ``weights.params_from_jax``).  With
    ``num_experts`` the dense MLP's leaves give way to the MoE leaves
    (``moe.init_moe_params``)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    H, Dq, Dkv, I, L = (cfg.hidden_size, cfg.q_dim, cfg.kv_dim,
                        cfg.intermediate_size, cfg.num_layers)

    def w(*shape, scale=None, stacked=False):
        din = shape[-2] if len(shape) > 1 else shape[-1]
        scale = scale or 1.0 / math.sqrt(din)
        if stacked:
            out = torch.empty((L, *shape), dtype=dtype, device=dev)
            for li in range(L):
                out[li] = torch.randn(shape, generator=generator, device=dev,
                                      dtype=torch.float32) * scale
            return out
        return (torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * scale).to(dtype)

    params = {
        "embed": w(cfg.vocab_size, H, scale=0.02),
        "layers": {
            "attn_norm": torch.ones((L, H), dtype=dtype, device=dev),
            "wq": w(H, Dq, stacked=True),
            "wk": w(H, Dkv, stacked=True),
            "wv": w(H, Dkv, stacked=True),
            "wo": w(Dq, H, stacked=True),
            "mlp_norm": torch.ones((L, H), dtype=dtype, device=dev),
        },
        "final_norm": torch.ones((H,), dtype=dtype, device=dev),
    }
    if cfg.num_experts:
        params["layers"].update(init_moe_params(cfg, generator, dev, dtype))
    else:
        params["layers"].update(w_gate=w(H, I, stacked=True), w_up=w(H, I, stacked=True),
                                w_down=w(I, H, stacked=True))
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w(H, cfg.vocab_size, scale=0.02)
    return params


def _mlp(lp: dict, h: torch.Tensor, tp=None) -> torch.Tensor:
    """SwiGLU MLP, on the fused ``w_gateup`` when ``quant.fuse_projections``
    made one.  (The JAX package cuts long prefills into 512-token segments
    to bound XLA temporaries; the math is per token, so one pass gives the
    same values.)"""
    if "w_gateup" in lp:
        gate, up = proj(h, lp, "w_gateup").chunk(2, dim=-1)
    else:
        gate, up = proj(h, lp, "w_gate"), proj(h, lp, "w_up")
    return proj(F.silu(gate) * up, lp, "w_down", tp)


def _layer(cfg: ModelConfig, lp: dict, x: torch.Tensor, cos, sin, attend, tp=None):
    """One decoder layer.  x [B, T, H]; attend(q, k, v) -> out [B, T, Hq, D]."""
    B, T, _ = x.shape
    h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
    if "wqkv" in lp:                # fused layout (quant.fuse_projections)
        q, k, v = proj(h, lp, "wqkv").split([cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1)
    else:
        q, k, v = proj(h, lp, "wq"), proj(h, lp, "wk"), proj(h, lp, "wv")
    q = q.reshape(B, T, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = attend(q, k, v)
    x = x + proj(attn.reshape(B, T, cfg.q_dim), lp, "wo", tp)
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
    if "w_router" in lp:
        return x + moe_mlp(cfg, lp, h, tp)
    return x + _mlp(lp, h, tp)


def _lm_head(cfg: ModelConfig, params: dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    """f32 logits; an int8 head is scaled per vocab column after the dot, or
    with the ``act_quant`` marker goes through ``w8a8_dot``.  A head cut on
    the vocabulary (``tp``, untied) gathers the whole row."""
    if cfg.tie_word_embeddings:
        head, scale = params["embed"].T, params.get("embed_scale")
    else:
        head, scale = params["lm_head"], params.get("lm_head_scale")
    if head.dtype == torch.int8 and "act_quant" in params:
        logits = w8a8_dot(x, head, scale, out_dtype=torch.float32)
    else:
        logits = (x @ head.to(x.dtype)).to(torch.float32)
        if head.dtype == torch.int8:
            logits = logits * scale
    if tp is not None and not cfg.tie_word_embeddings:
        logits = tp.gather_last(logits, cfg.vocab_size)
    return logits


def run_layers(cfg: ModelConfig, layers: dict, x: torch.Tensor, cos, sin, attend_at,
               tp=None) -> torch.Tensor:
    """The decoder stack over x [B, T, H]: layer ``li`` of the stacked
    ``layers`` leaves (views, no copy) with ``attend_at(li)`` as its
    attention, for the ``cfg.num_layers`` layers.  A pipeline stage passes
    its own config and its layers' leaves."""
    for li in range(cfg.num_layers):
        lp = {name: leaf[li] for name, leaf in layers.items()}
        x = _layer(cfg, lp, x, cos, sin, attend_at(li), tp)
    return x


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, cache: dict,
            cache_impl, positions: torch.Tensor, mode: str, aux,
            last_only: bool = False, tp=None):
    """Shared forward, ``mode`` in {"prefill", "prefill_segment", "decode"}.

    tokens [B, T] int64; positions [T] (or [B, 1], per-slot decode).
    ``aux`` is the host int ``true_len`` (prefill), ``(seg_start,
    true_len)`` (a chunked-prefill segment: host ints, or 0-d int64 device
    tensors, as the graphed segment reads them) or ``pos`` (decode: a host
    int, a 0-d device tensor, or a [B] device tensor of per-slot
    positions).  ``last_only`` computes the LM head at the prompt's last
    position only ([B, 1, V]): ``true_len - 1``, or ``true_len - 1 -
    seg_start`` within a segment (clipped into it; a device index there).
    The cache is updated in place and returned with the f32 logits.
    ``tp``: the rank's ``ModelShard`` under tensor parallelism (module
    note)."""
    if mode == "prefill":
        def attend_at(li):
            return lambda q, k, v: cache_impl.prefill_attend(cache, li, q, k, v, aux)
    elif mode == "prefill_segment":
        # one segment program: host counts go to the device once, and every
        # layer reads them there
        seg_start, true_len = (device_int(x, tokens.device) for x in aux)
        # and what no layer changes (counts, masks) is made once a segment
        ctx = cache_impl.segment_context(cache, seg_start, true_len)

        def attend_at(li):
            return lambda q, k, v: cache_impl.segment_attend(
                cache, li, q, k, v, seg_start, true_len, ctx=ctx)
    elif mode == "decode":
        def attend_at(li):
            return lambda q, k, v: cache_impl.decode_attend(cache, li, q, k, v, aux)
    else:
        raise ValueError(f"unsupported forward mode {mode!r}")
    x = embed_lookup(params, tokens, params["final_norm"].dtype)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling)
    x = run_layers(cfg, params["layers"], x, cos, sin, attend_at, tp)
    if mode == "prefill_segment":
        cache_impl.finalize_segment(cache, *aux, ctx=ctx)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    if last_only:
        if mode == "prefill_segment":
            idx = (true_len - 1 - seg_start).clamp(0, tokens.shape[1] - 1)
            x = x.index_select(1, idx.reshape(1))
        else:
            idx = max(aux - 1, 0)
            x = x[:, idx:idx + 1]
    return _lm_head(cfg, params, x, tp), cache


def lm_forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, true_len=None,
               remat: bool = False) -> torch.Tensor:
    """Cache-free causal LM forward, the training entry point: tokens [B, T]
    -> f32 logits [B, T, V], differentiable end to end.  Attention is the
    plain causal ``prefill_attention`` (Mistral's ``sliding_window`` from
    ``cfg``, banded past it; keys at or past ``true_len`` masked): no
    kernel, as the JAX package's training reaches none of its own.
    ``remat`` recomputes each layer on the backward pass
    (``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint`` over
    the layer body), keeping one [B, T, H] residual a layer."""
    from torch.utils.checkpoint import checkpoint

    from mustafar_tpu_torch.ops.attention import prefill_attention

    T = tokens.shape[1]
    x = embed_lookup(params, tokens, params["final_norm"].dtype)
    cos, sin = rope_cos_sin(torch.arange(T, device=tokens.device), cfg.head_dim,
                            cfg.rope_theta, cfg.rope_scaling)
    tl = T if true_len is None else true_len
    layers = params["layers"]

    def attend(q, k, v):
        return prefill_attention(q, k, v, tl, cfg.sliding_window)

    def layer(x, li):
        return _layer(cfg, {name: leaf[li] for name, leaf in layers.items()}, x, cos, sin,
                      attend)

    for li in range(cfg.num_layers):
        x = checkpoint(layer, x, li, use_reentrant=False) if remat else layer(x, li)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _lm_head(cfg, params, x)


def prefill(cfg: ModelConfig, params, tokens, cache, cache_impl, true_len: int,
            last_only: bool = False, tp=None):
    """tokens [B, Tpad]; true_len the uniform valid length (left-aligned)."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    return forward(cfg, params, tokens, cache, cache_impl, positions, "prefill",
                   true_len, last_only=last_only, tp=tp)


def prefill_segment(cfg: ModelConfig, params, seg_tokens, cache, cache_impl,
                    seg_start, true_len, tp=None):
    """One chunked-prefill segment: seg_tokens [B, C] at positions
    [seg_start, seg_start + C) -> (logits at the prompt's last position
    within the segment [B, 1, V], cache).  ``seg_start`` and ``true_len``:
    host ints (the cache's host count follows), or 0-d int64 device tensors
    (the static segment a CUDA graph replays: nothing is read on the host,
    and the caller moves the host count, ``segment_host_count``)."""
    positions = seg_start + torch.arange(seg_tokens.shape[1], device=seg_tokens.device)
    return forward(cfg, params, seg_tokens, cache, cache_impl, positions,
                   "prefill_segment", (seg_start, true_len), last_only=True, tp=tp)


def n_segments(true_len: int, C: int) -> int:
    """Chunked-prefill segments of a prompt of ``true_len`` tokens."""
    return -(-true_len // C)


def check_chunked(T: int, true_len: int, C: int):
    """Refuses a chunked prefill of ``true_len`` of T padded tokens that is
    not made of C-token segments."""
    if T % C:
        raise ValueError(f"chunked prefill takes a multiple of {C} tokens, got {T}")
    if not 1 <= true_len <= T:
        raise ValueError(f"true_len {true_len} outside the {T} prompt tokens")


def prefill_chunked(cfg: ModelConfig, params, tokens, cache, cache_impl,
                    true_len: int, tp=None):
    """Chunked (segment-streamed) prefill over the compressed cache.

    tokens [B, T] with T a multiple of the cache chunk C: the prompt goes
    through the whole stack C tokens at a time, each segment attending the
    packed pools, the window and itself (``segment_attend``), so activation
    memory is O(B*C), not O(B*T).  Only the ``ceil(true_len / C)`` segments
    that hold prompt tokens run: the last of them holds position
    true_len - 1, whose logits it returns ([B, 1, V], with the cache).  A
    segment of padding only would take its logits from a pad and leave a
    window longer than the cache's.  (The JAX package runs every segment of
    the bucket, and so differs from this at a bucket past C.)"""
    C = cache_impl.C
    check_chunked(tokens.shape[1], true_len, C)
    logits = None
    for seg_start in range(0, n_segments(true_len, C) * C, C):
        logits, cache = prefill_segment(cfg, params, tokens[:, seg_start:seg_start + C],
                                        cache, cache_impl, seg_start, true_len, tp)
    return logits, cache


def decode_step(cfg: ModelConfig, params, token, cache, cache_impl, pos, tp=None):
    """token [B, 1]; pos the index of this token: a host int (uniform batch,
    the eager loop), a 0-d int64 device tensor (uniform batch, the static
    step: the position and every count the caches and kernels take are read
    on the device, so one CUDA graph of the step replays at every position)
    or a [B] device tensor of per-slot indices (continuous batching: RoPE
    then rotates each row at its own position)."""
    if torch.is_tensor(pos):
        positions = pos.reshape(1) if pos.dim() == 0 else pos[:, None]
    else:
        positions = torch.full((1,), pos, dtype=torch.int64, device=token.device)
    return forward(cfg, params, token, cache, cache_impl, positions, "decode", pos, tp=tp)
