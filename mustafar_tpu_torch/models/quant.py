"""Weight-only int8 (W8) serving, port of the W8 parts of
``mustafar_tpu/models/quant.py``.

Each 2-D weight w [in, out] (stacked: [L, in, out]) becomes
  w_q  int8   same shape            round(w / s), clipped to +-127
  s    f32    [out] ([L, out])      max|w| per output channel / 127
and is used as ``(x @ w_q.to(x.dtype)) * s``.  The embedding table is
quantized per row (gather, then scale); the LM head per vocab column.
The int8 -> bf16 widen is a plain copy here (XLA fuses it into the dot on
the TPU); a W8 GEMM kernel is later work.
"""

from __future__ import annotations

import math

import torch

from mustafar_tpu_torch.device import resolve_device
from mustafar_tpu_torch.ops.quant_format import recip_f32

_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _quant_last(w: torch.Tensor):
    """Symmetric int8 over the ``in`` axis; one scale per out-channel."""
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=-2, keepdim=True)
    s = torch.clamp_min(amax * recip_f32(127.0), 1e-12)
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return q, s.squeeze(-2)


def _quant_rows(w: torch.Tensor):
    """Symmetric int8 per row (embedding table [V, H] -> scale [V])."""
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp_min(amax * recip_f32(127.0), 1e-12)
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return q, s[..., 0]


def quantize_params(params: dict) -> dict:
    """Quantize a llama params dict to W8 (idempotent on int8 leaves).
    Norm weights keep their dtype."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in _LAYER_KEYS:
        w = layers.get(name)
        if w is None or w.dtype == torch.int8:
            continue
        layers[name], layers[name + "_scale"] = _quant_last(w)
    out["layers"] = layers
    if params["embed"].dtype != torch.int8:
        out["embed"], out["embed_scale"] = _quant_rows(params["embed"])
    if "lm_head" in params and params["lm_head"].dtype != torch.int8:
        out["lm_head"], out["lm_head_scale"] = _quant_last(params["lm_head"])
    return out


def proj(h: torch.Tensor, lp: dict, name: str) -> torch.Tensor:
    """h @ lp[name], dequantizing int8 weights with their per-out scale."""
    w = lp[name]
    if w.dtype == torch.int8:
        return (h @ w.to(h.dtype)) * lp[name + "_scale"].to(h.dtype)
    return h @ w


def embed_lookup(params: dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    emb = params["embed"]
    if emb.dtype == torch.int8:
        return (emb[tokens].to(dtype)
                * params["embed_scale"][tokens][..., None].to(dtype))
    return emb[tokens]


def weight_bytes(params: dict) -> int:
    total = 0
    for v in params.values():
        if isinstance(v, dict):
            total += weight_bytes(v)
        else:
            total += v.numel() * v.element_size()
    return total


_ROW_BLOCK = 16384   # rows (or columns) generated at once for embed / head


def init_params_w8(cfg, generator: torch.Generator | None = None,
                   device=None, seed: int = 0) -> dict:
    """Random params made directly in W8, on ``device`` (default ``cuda``).

    Every stacked leaf is drawn one layer at a time from ``generator`` (a
    ``torch.Generator`` on that device; one seeded with ``seed`` when None)
    and quantized at once into a preallocated int8 stack, so no
    whole-model f32 or bf16 copy ever exists.  The embedding and LM head are
    drawn in blocks of rows (columns for the head).  Same structure and
    scales of randomness as the JAX package's ``init_params_w8``; the random
    bits differ."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    H, Dq, Dkv, I, L, V = (cfg.hidden_size, cfg.q_dim, cfg.kv_dim,
                           cfg.intermediate_size, cfg.num_layers,
                           cfg.vocab_size)

    def randn(*shape, scale):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32) * scale

    layers = {"attn_norm": torch.ones((L, H), dtype=torch.bfloat16, device=dev),
              "mlp_norm": torch.ones((L, H), dtype=torch.bfloat16, device=dev)}
    for name, din, dout in [("wq", H, Dq), ("wk", H, Dkv), ("wv", H, Dkv),
                            ("wo", Dq, H), ("w_gate", H, I), ("w_up", H, I),
                            ("w_down", I, H)]:
        q = torch.empty((L, din, dout), dtype=torch.int8, device=dev)
        s = torch.empty((L, dout), dtype=torch.float32, device=dev)
        for li in range(L):
            q[li], s[li] = _quant_last(randn(din, dout, scale=1.0 / math.sqrt(din)))
        layers[name] = q
        layers[name + "_scale"] = s

    emb = torch.empty((V, H), dtype=torch.int8, device=dev)
    emb_s = torch.empty((V,), dtype=torch.float32, device=dev)
    for r0 in range(0, V, _ROW_BLOCK):
        r1 = min(V, r0 + _ROW_BLOCK)
        emb[r0:r1], emb_s[r0:r1] = _quant_rows(randn(r1 - r0, H, scale=0.02))
    params = {"embed": emb, "embed_scale": emb_s, "layers": layers,
              "final_norm": torch.ones((H,), dtype=torch.bfloat16, device=dev)}
    if not cfg.tie_word_embeddings:
        head = torch.empty((H, V), dtype=torch.int8, device=dev)
        head_s = torch.empty((V,), dtype=torch.float32, device=dev)
        for c0 in range(0, V, _ROW_BLOCK):
            c1 = min(V, c0 + _ROW_BLOCK)
            head[:, c0:c1], head_s[c0:c1] = _quant_last(
                randn(H, c1 - c0, scale=0.02))
        params["lm_head"] = head
        params["lm_head_scale"] = head_s
    return params
