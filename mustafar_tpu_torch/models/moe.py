"""Mixtral's sparse-MoE MLP, port of ``mustafar_tpu/models/moe.py``.

Per token a linear router scores E experts and the top K are taken (on equal
logits the lower index first, as ``jax.lax.top_k`` orders them); their
SwiGLU outputs are summed, weighted by the softmax over the K selected f32
logits.  An expert takes at most C = ``expert_capacity`` tokens of a group,
ranked in the group's order (the flattened [B, T] rows, padding included);
a token ranked C or later is dropped from that expert (its contribution is
0; the residual passes).  A group is the whole batch, or 1,024 tokens
(``_MOE_GROUP``) when that divides a larger batch; each group has its own
capacity.  At decode (N <= 8 tokens) C >= N, so nothing is dropped.

The JAX package dispatches through one-hot tensors [N, E, C] and einsums,
static shapes for XLA.  Here dispatch is by index: each kept (token, choice)
pair is copied into its slot of [E, C, H], the experts run as batched
products over the slots, and each token gathers its K slots back.  The
values are JAX's: a slot holds its token exactly, and the combine sums the
same f32 products.

Leaves, stacked on the layer axis like every layer leaf: w_router [L, H, E];
we_gate, we_up [L, E, H, I]; we_down [L, E, I, H].  W8 experts (int8 with
``<name>_scale`` [L, E, out], ``quant.quantize_params``) widen to the
activations' dtype and scale per (expert, out-channel) after the product.
With the ``"a8"`` marker (``quant.enable_act_quant``) each slot row is
quantized to int8 over the contraction axis (an empty slot to 0) and the
products run int8 x int8 -> int32 (``quant.int8_matmul``), both scales
applied after.

Expert parallelism (``tp``, a ``parallel.sharding.ModelShard``): a rank
holds experts [rank E/tp, (rank + 1) E/tp) of every layer.  Routing, the
capacity (from the global E) and each pair's rank are computed from the
replicated router on every rank alike; a rank fills and runs only its
experts' slots, and the f32 partial combines are summed over "model" (the
other ranks' terms are 0, so with K = 2 the sum is one device's).  Where
the batch is spread over "data" (``tp.data``) the groups, capacities and
ranks are the whole batch's, as on one device: every rank routes the
gathered batch and keeps its own rows' combine.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from mustafar_tpu_torch.config import ModelConfig
from mustafar_tpu_torch.models.quant import act_quant, int8_matmul

# tokens a dispatch group takes at most (the JAX package's GShard-style
# grouping: it bounds its [G, E, C] dispatch tensor, O(G^2))
_MOE_GROUP = 1024


def expert_capacity(n_tokens: int, num_experts: int, top_k: int,
                    factor: float) -> int:
    """Slots an expert has in a group of ``n_tokens``: ceil(N K / E x
    factor), rounded up to a multiple of 8, at least 8."""
    c = math.ceil(n_tokens * top_k / num_experts * factor)
    return max(8, -(-c // 8) * 8)


def moe_mlp(cfg: ModelConfig, lp: dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    """x [B, T, H] -> [B, T, H]; ``lp`` holds one layer's MoE leaves (a
    rank's experts under ``tp``)."""
    B, T, H = x.shape
    xf = x.reshape(B * T, H)
    lo = 0
    if tp is not None:
        xf, lo = tp.batch_rows(xf)
    N = xf.shape[0]
    if N > _MOE_GROUP and N % _MOE_GROUP == 0:
        out = torch.cat([_moe_group(cfg, lp, g, tp) for g in xf.split(_MOE_GROUP)])
    else:
        out = _moe_group(cfg, lp, xf, tp)
    out = out[lo:lo + B * T]
    if tp is not None:
        tp.sum_(out)
    return out.to(x.dtype).reshape(B, T, H)


def _moe_group(cfg: ModelConfig, lp: dict, xf: torch.Tensor, tp=None) -> torch.Tensor:
    """Route, dispatch, expert SwiGLU and the f32 combine of the experts
    held here for one group [N, H]."""
    N, H = xf.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    El = lp["we_gate"].shape[0]                  # the experts held here
    e0 = 0 if tp is None else tp.rank * El
    logits = (xf @ lp["w_router"].to(xf.dtype)).to(torch.float32)      # [N, E]
    top, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(top[:, :K], dim=-1)                            # [N, K]
    idx = idx[:, :K]
    C = expert_capacity(N, E, K, cfg.expert_capacity_factor)
    sel = torch.zeros((N, E), dtype=torch.int64, device=xf.device).scatter_(1, idx, 1)
    rank = (torch.cumsum(sel, dim=0) - sel).gather(1, idx)              # [N, K]
    # a kept pair's slot (e - e0)*C + rank among the experts held here; a
    # dropped pair's, or another rank's, the spare row El*C
    mine = (rank < C) & (idx >= e0) & (idx < e0 + El)
    slot = torch.where(mine, (idx - e0) * C + rank, El * C).reshape(N * K)
    xe = xf.new_zeros((El * C + 1, H))
    xe.index_copy_(0, slot, xf.repeat_interleave(K, dim=0))
    xe = xe[:El * C].view(El, C, H)
    hg = F.silu(_edot(lp, "we_gate", xe))
    hu = _edot(lp, "we_up", xe)
    ye = _edot(lp, "we_down", hg * hu).reshape(El * C, H).to(torch.float32)
    ye = torch.cat([ye, ye.new_zeros((1, H))])                           # the spare row: 0
    return (ye[slot].view(N, K, H) * gates[..., None]).sum(dim=1)


def _edot(lp: dict, name: str, v: torch.Tensor) -> torch.Tensor:
    """v [E, C, in] @ lp[name] [E, in, out] -> [E, C, out] in v's dtype."""
    w = lp[name]
    if w.dtype == torch.int8 and "a8" in lp:
        vq, sv = act_quant(v)
        acc = torch.stack([int8_matmul(vq[e], w[e]) for e in range(w.shape[0])])
        return (acc.to(torch.float32) * sv
                * lp[name + "_scale"].to(torch.float32)[:, None, :]).to(v.dtype)
    y = torch.bmm(v, w.to(v.dtype))
    if w.dtype == torch.int8:
        y = y * lp[name + "_scale"].to(v.dtype)[:, None, :]
    return y


def init_moe_params(cfg: ModelConfig, generator: torch.Generator, device,
                    dtype=torch.bfloat16) -> dict:
    """The MoE leaves, stacked [L, ...], in ``dtype`` on ``device``, drawn one
    (layer, expert) at a time from ``generator``: the JAX package's
    structure and scales (router 0.02, the experts 1/sqrt(in)); the random
    bits differ."""
    L, H, I, E = (cfg.num_layers, cfg.hidden_size, cfg.intermediate_size,
                  cfg.num_experts)

    def randn(*shape, scale):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32) * scale

    router = torch.empty((L, H, E), dtype=dtype, device=device)
    for li in range(L):
        router[li] = randn(H, E, scale=0.02)
    out = {"w_router": router}
    for name, din, dout in (("we_gate", H, I), ("we_up", H, I), ("we_down", I, H)):
        w = torch.empty((L, E, din, dout), dtype=dtype, device=device)
        for li in range(L):
            for e in range(E):
                w[li, e] = randn(din, dout, scale=1.0 / math.sqrt(din))
        out[name] = w
    return out
