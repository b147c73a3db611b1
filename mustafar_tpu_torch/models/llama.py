"""Llama-2/3 forward pass, port of ``mustafar_tpu/models/llama.py``.

Params are a plain dict with the JAX package's layout: per-layer leaves
stacked on axis 0 ([L, in, out] weights, [L, H] norms).  The JAX package
scans over layers; here a Python loop takes layer ``li``'s leaves as views
(no copy).  Attention and the KV cache are delegated to a cache impl
(``mustafar_tpu_torch.cache``), which updates its state dict IN PLACE: one
cache buffer lives for the whole generation, where JAX threads immutable
state through the scan.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from mustafar_tpu_torch.config import ModelConfig
from mustafar_tpu_torch.device import resolve_device
from mustafar_tpu_torch.models.quant import embed_lookup, proj
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
    JAX weights across with ``weights.params_from_jax``)."""
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
            "w_gate": w(H, I, stacked=True),
            "w_up": w(H, I, stacked=True),
            "w_down": w(I, H, stacked=True),
        },
        "final_norm": torch.ones((H,), dtype=dtype, device=dev),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w(H, cfg.vocab_size, scale=0.02)
    return params


def _mlp(lp: dict, h: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP.  (The JAX package cuts long prefills into 512-token
    segments to bound XLA temporaries; the math is per token, so one pass
    gives the same values.)"""
    return proj(F.silu(proj(h, lp, "w_gate")) * proj(h, lp, "w_up"), lp, "w_down")


def _layer(cfg: ModelConfig, lp: dict, x: torch.Tensor, cos, sin, attend):
    """One decoder layer.  x [B, T, H]; attend(q, k, v) -> out [B, T, Hq, D]."""
    B, T, _ = x.shape
    h = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
    q = proj(h, lp, "wq").reshape(B, T, cfg.num_heads, cfg.head_dim)
    k = proj(h, lp, "wk").reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    v = proj(h, lp, "wv").reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn = attend(q, k, v)
    x = x + proj(attn.reshape(B, T, cfg.q_dim), lp, "wo")
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
    return x + _mlp(lp, h)


def _lm_head(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """f32 logits; an int8 head is scaled per vocab column after the dot."""
    if cfg.tie_word_embeddings:
        head, scale = params["embed"].T, params.get("embed_scale")
    else:
        head, scale = params["lm_head"], params.get("lm_head_scale")
    logits = (x @ head.to(x.dtype)).to(torch.float32)
    if head.dtype == torch.int8:
        logits = logits * scale
    return logits


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, cache: dict,
            cache_impl, positions: torch.Tensor, mode: str, aux: int,
            last_only: bool = False):
    """Shared forward, ``mode`` in {"prefill", "decode"}.

    tokens [B, T] int64; positions [T]; ``aux`` is the host int ``true_len``
    (prefill) or ``pos`` (decode).  ``last_only`` computes the LM head at
    position ``aux - 1`` only (prefill's [B, 1, V]).  The cache is updated in
    place and returned with the f32 logits."""
    if mode not in ("prefill", "decode"):
        raise ValueError(f"unsupported forward mode {mode!r}")
    x = embed_lookup(params, tokens, params["final_norm"].dtype)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling)
    layers = params["layers"]
    for li in range(cfg.num_layers):
        lp = {name: leaf[li] for name, leaf in layers.items()}
        if mode == "prefill":
            def attend(q, k, v, li=li):
                return cache_impl.prefill_attend(cache, li, q, k, v, aux)
        else:
            def attend(q, k, v, li=li):
                return cache_impl.decode_attend(cache, li, q, k, v, aux)
        x = _layer(cfg, lp, x, cos, sin, attend)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    if last_only:
        idx = max(aux - 1, 0)
        x = x[:, idx:idx + 1]
    return _lm_head(cfg, params, x), cache


def prefill(cfg: ModelConfig, params, tokens, cache, cache_impl, true_len: int,
            last_only: bool = False):
    """tokens [B, Tpad]; true_len the uniform valid length (left-aligned)."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    return forward(cfg, params, tokens, cache, cache_impl, positions, "prefill",
                   true_len, last_only=last_only)


def decode_step(cfg: ModelConfig, params, token, cache, cache_impl, pos: int):
    """token [B, 1]; pos the host int index of this token (uniform batch)."""
    positions = torch.full((1,), pos, dtype=torch.int64, device=token.device)
    return forward(cfg, params, token, cache, cache_impl, positions, "decode", pos)
