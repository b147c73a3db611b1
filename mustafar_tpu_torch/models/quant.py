"""Weight-only int8 (W8) and int4 (W4) serving, port of
``mustafar_tpu/models/quant.py`` (``fuse_projections`` included).

W8: each 2-D weight w [in, out] (stacked: [L, in, out]) becomes
  w_q  int8   same shape            round(w / s), clipped to +-127
  s    f32    [out] ([L, out])      max|w| per output channel / 127
and is used as ``(x @ w_q.to(x.dtype)) * s``.  The embedding table is
quantized per row (gather, then scale); the LM head per vocab column.
The int8 -> bf16 widen is a plain copy here (XLA fuses it into the dot on
the TPU); a W8 GEMM kernel is later work.

W4: the layer projections become int4 codes in [-7, 7] with one scale per
(128-row block of ``in``, out channel), stored as the JAX package stores
them, byte for byte:
  carriers  int16  [in/4, out] ([L, in/4, out])   block-local nibbles: within
            128-row block b, carrier row b*32 + r holds in-rows
            b*128 + 32 j + r in nibble j (j = 0..3, two's complement)
  scales    bf16   [in/128, out] ([L, in/128, out])
The embedding and the LM head stay W8.  ``proj`` sends an int16 weight to
``_w4_dot``: on the card, at most 128 tokens go through the hand-written
kernel (``ops/kernels/w4_matmul.py``), which unpacks the nibbles in
registers; more tokens, and everything on the CPU, take the JAX package's
off-TPU route (unpack, widen, scale by block, then ``torch.matmul``).  The
TPU needs its stacked ``_li`` scalar prefetch because XLA copies a layer
slice that feeds a kernel; the port's ``forward`` passes ``leaf[li]``, a
view, and the kernel reads the view's pointer, so no copy is made and no
layer index is needed.
"""

from __future__ import annotations

import math

import torch

from mustafar_tpu_torch.device import resolve_device
from mustafar_tpu_torch.ops.kernels.w4_matmul import MAX_TOKENS, unpack_w4, w4_matmul
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


def _quant_block4(w: torch.Tensor, block: int = 128):
    """Symmetric int4 with one scale per (``block`` rows of ``in``, out
    channel): w [..., in, out] -> (codes int8 in [-7, 7], same shape;
    scales f32 [..., in/block, out])."""
    wf = w.to(torch.float32)
    *lead, din, dout = wf.shape
    wb = wf.reshape(*lead, din // block, block, dout)
    amax = wb.abs().amax(dim=-2, keepdim=True)
    s = torch.clamp_min(amax * recip_f32(7.0), 1e-12)
    q = torch.clamp(torch.round(wb / s), -7, 7).to(torch.int8)
    return q.reshape(*lead, din, dout), s.squeeze(-2)


def pack_w4(codes: torch.Tensor) -> torch.Tensor:
    """int4 codes [..., in, out] -> int16 carriers [..., in/4, out] in the
    block-local nibble layout (module note)."""
    *lead, din, dout = codes.shape
    c = codes.to(torch.int32).reshape(*lead, din // 128, 4, 32, dout)
    v = torch.zeros((*lead, din // 128, 32, dout), dtype=torch.int32,
                    device=codes.device)
    for j in range(4):
        v |= (c[..., j, :, :] & 15) << (4 * j)
    v = torch.where(v >= 1 << 15, v - (1 << 16), v)      # the int16 bit pattern
    return v.to(torch.int16).reshape(*lead, din // 4, dout)


def _quant_pack_w4(w: torch.Tensor):
    """A weight [in, out] or stacked [L, in, out] -> (carriers int16, scales
    bf16); a stacked leaf one layer at a time (as ``lax.map`` does), so the
    f32 temporaries hold one layer."""
    if w.dim() == 2:
        q, s = _quant_block4(w, 128)
        return pack_w4(q), s.to(torch.bfloat16)
    L, din, dout = w.shape
    q = torch.empty((L, din // 4, dout), dtype=torch.int16, device=w.device)
    s = torch.empty((L, din // 128, dout), dtype=torch.bfloat16, device=w.device)
    for li in range(L):
        q[li], s[li] = _quant_pack_w4(w[li])
    return q, s


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


def quantize_params_w4(params: dict) -> dict:
    """Quantize a llama params dict to W4 (idempotent on int16 and int8
    leaves): the layer projections to int16 carriers with bf16 block scales,
    the embedding and the LM head to W8.  Every projection's ``in`` must be
    a multiple of 128.  Norm weights keep their dtype."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in _LAYER_KEYS:
        w = layers.get(name)
        if w is None or w.dtype in (torch.int16, torch.int8):
            continue
        if w.shape[-2] % 128:
            raise ValueError(f"W4 needs {name}'s in-dim to be a multiple of 128, "
                             f"got {tuple(w.shape)}")
        layers[name], layers[name + "_scale"] = _quant_pack_w4(w)
    out["layers"] = layers
    if params["embed"].dtype != torch.int8:
        out["embed"], out["embed_scale"] = _quant_rows(params["embed"])
    if "lm_head" in params and params["lm_head"].dtype not in (torch.int16, torch.int8):
        out["lm_head"], out["lm_head_scale"] = _quant_last(params["lm_head"])
    return out


def fuse_projections(params: dict) -> dict:
    """Concatenate wq, wk, wv into ``wqkv`` and w_gate, w_up into
    ``w_gateup`` along the out-channel axis, with their scales (bf16, W8 and
    W4 alike: every format keeps out-channels last).  A layout change only:
    ``models/llama.py`` splits the fused products, and the logits are those
    of the unfused params."""
    out = dict(params)
    layers = dict(params["layers"])

    def cat(names, fused):
        if not all(n in layers for n in names):
            return
        ws = [layers.pop(n) for n in names]
        if len({w.dtype for w in ws}) != 1:
            raise ValueError(f"{fused}: mixed dtypes {[w.dtype for w in ws]}")
        layers[fused] = torch.cat(ws, dim=-1)
        scales = [layers.pop(n + "_scale", None) for n in names]
        if scales[0] is not None:
            layers[fused + "_scale"] = torch.cat(scales, dim=-1)

    cat(("wq", "wk", "wv"), "wqkv")
    cat(("w_gate", "w_up"), "w_gateup")
    out["layers"] = layers
    return out


def proj(h: torch.Tensor, lp: dict, name: str) -> torch.Tensor:
    """h @ lp[name]: int8 weights dequantized with their per-out scale, int16
    (W4) carriers through ``_w4_dot``."""
    w = lp[name]
    if w.dtype == torch.int16:
        return _w4_dot(h, w, lp[name + "_scale"])
    if w.dtype == torch.int8:
        return (h @ w.to(h.dtype)) * lp[name + "_scale"].to(h.dtype)
    return h @ w


def _w4_dot(h: torch.Tensor, w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """h [..., in] @ W4 (carriers w [in/4, out], scales s [in/128, out]).

    Off the CPU, at most ``MAX_TOKENS`` (128) tokens go to the kernel, which
    scales each block's bf16 x code partial in f32.  Otherwise the JAX
    package's off-TPU route: the codes widened to h's dtype and scaled by
    block (a transient weight-sized copy), then one matmul."""
    din, dout = w.shape[-2] * 4, w.shape[-1]
    tokens = h.numel() // din
    if h.device.type != "cpu" and tokens <= MAX_TOKENS:
        return w4_matmul(h.reshape(tokens, din), w, s).reshape(*h.shape[:-1], dout)
    wf = (unpack_w4(w).to(h.dtype).reshape(din // 128, 128, dout)
          * s.to(h.dtype)[:, None, :]).reshape(din, dout)
    return h @ wf


def embed_lookup(params: dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    emb = params["embed"]
    if emb.dtype == torch.int8:
        return (emb[tokens].to(dtype)
                * params["embed_scale"][tokens][..., None].to(dtype))
    return emb[tokens]


def weight_bytes(params: dict) -> int:
    """Bytes of every leaf.  W4 carriers are int16 holding four codes each,
    so their size is already the 0.5 byte a weight they take."""
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
    return _init_params_quantized(cfg, generator, device, seed, w4=False)


def init_params_w4(cfg, generator: torch.Generator | None = None,
                   device=None, seed: int = 0) -> dict:
    """Random params made directly in W4 (int16 carriers, bf16 block scales;
    the embedding and the LM head in W8), drawn as ``init_params_w8`` draws
    them: one layer at a time, from the same stream of random numbers, so a
    seed gives the same underlying weights in both formats.  Same structure
    as the JAX package's ``init_params_w4``; the random bits differ."""
    return _init_params_quantized(cfg, generator, device, seed, w4=True)


def _init_params_quantized(cfg, generator, device, seed: int, w4: bool) -> dict:
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
        if w4:
            q = torch.empty((L, din // 4, dout), dtype=torch.int16, device=dev)
            s = torch.empty((L, din // 128, dout), dtype=torch.bfloat16, device=dev)
        else:
            q = torch.empty((L, din, dout), dtype=torch.int8, device=dev)
            s = torch.empty((L, dout), dtype=torch.float32, device=dev)
        quant = _quant_pack_w4 if w4 else _quant_last
        for li in range(L):
            q[li], s[li] = quant(randn(din, dout, scale=1.0 / math.sqrt(din)))
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
