"""HF checkpoints to the port's params, port of
``mustafar_tpu/models/weights.py``.

A local HF directory (``config.json`` with safetensors, or torch ``.bin``
files) or an in-memory HF torch model becomes a ``ModelConfig`` and a params
dict on ``device``.  Llama and Mistral map their dense MLP; Mixtral's
``block_sparse_moe`` (router ``gate`` [E, H], experts ``w1`` = gate, ``w3`` =
up [I, H], ``w2`` = down [H, I]) maps to the layer-stacked MoE leaves of
``models/moe.py``.  HF linear weights are [out, in]; the port's are [in,
out].  Nothing is downloaded, and ``transformers`` is not imported: an HF
config is read as a dict or as an object's attributes.
"""

from __future__ import annotations

import json
import os

import torch

from mustafar_tpu_torch.config import ModelConfig
from mustafar_tpu_torch.device import resolve_device


def config_from_hf(hf_cfg) -> ModelConfig:
    """An HF Llama / Mistral / Mixtral config (a dict or a config object) as
    a ``ModelConfig``."""
    def get(key, default=None):
        if isinstance(hf_cfg, dict):
            return hf_cfg.get(key, default)
        return getattr(hf_cfg, key, default)

    head_dim = get("head_dim") or get("hidden_size") // get("num_attention_heads")
    rope_scaling = get("rope_scaling")
    if rope_scaling is not None and not isinstance(rope_scaling, dict):
        rope_scaling = dict(rope_scaling)
    return ModelConfig(
        name=str(get("model_type", "llama")),
        num_experts=get("num_local_experts", 0) or 0,
        num_experts_per_tok=get("num_experts_per_tok", 2) or 2,
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        intermediate_size=get("intermediate_size"),
        num_layers=get("num_hidden_layers"),
        num_heads=get("num_attention_heads"),
        num_kv_heads=get("num_key_value_heads", get("num_attention_heads")),
        head_dim=head_dim,
        rms_norm_eps=get("rms_norm_eps", 1e-5),
        rope_theta=get("rope_theta", 10000.0),
        rope_scaling=rope_scaling,
        max_position_embeddings=get("max_position_embeddings", 4096),
        sliding_window=get("sliding_window"),
        tie_word_embeddings=bool(get("tie_word_embeddings", False)),
    )


def params_from_state_dict(cfg: ModelConfig, sd: dict, dtype=torch.bfloat16,
                           device=None) -> dict:
    """An HF Llama / Mistral / Mixtral state dict (torch tensors or numpy
    arrays) as the port's params, in ``dtype`` on ``device`` (default
    ``cuda``).  Each leaf goes through f32, as the JAX package converts it."""
    dev = resolve_device(device)

    def get(key, transpose=False):
        t = torch.as_tensor(sd[key]).to(torch.float32)
        return t.T if transpose else t

    def stack(ts):
        return torch.stack(ts).to(device=dev, dtype=dtype)

    pre = "model."
    moe = f"{pre}layers.0.block_sparse_moe.gate.weight" in sd
    names = {"attn_norm": ("input_layernorm.weight", False),
             "wq": ("self_attn.q_proj.weight", True),
             "wk": ("self_attn.k_proj.weight", True),
             "wv": ("self_attn.v_proj.weight", True),
             "wo": ("self_attn.o_proj.weight", True),
             "mlp_norm": ("post_attention_layernorm.weight", False)}
    if moe:
        names["w_router"] = ("block_sparse_moe.gate.weight", True)
    else:
        names.update(w_gate=("mlp.gate_proj.weight", True), w_up=("mlp.up_proj.weight", True),
                     w_down=("mlp.down_proj.weight", True))
    layers = {}
    for name, (key, transpose) in names.items():
        layers[name] = stack([get(f"{pre}layers.{i}.{key}", transpose)
                              for i in range(cfg.num_layers)])
    if moe:
        for name, hf in (("we_gate", "w1"), ("we_up", "w3"), ("we_down", "w2")):
            layers[name] = stack([
                torch.stack([get(f"{pre}layers.{i}.block_sparse_moe.experts.{e}.{hf}.weight",
                                 True) for e in range(cfg.num_experts)])
                for i in range(cfg.num_layers)])
    params = {"embed": get(pre + "embed_tokens.weight").to(device=dev, dtype=dtype),
              "layers": layers,
              "final_norm": get(pre + "norm.weight").to(device=dev, dtype=dtype)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = get("lm_head.weight", True).contiguous().to(device=dev,
                                                                       dtype=dtype)
    return params


def load_hf_dir(path: str, dtype=torch.bfloat16, device=None) -> tuple[ModelConfig, dict]:
    """(config, params) of a local HF checkpoint directory: its
    ``*.safetensors`` files, or else its torch ``*.bin`` files, read on the
    CPU and converted onto ``device`` (default ``cuda``).  A checkpoint too
    big for the card in ``dtype`` loads on ``device="cpu"``, is quantized
    there (``models/quant.py``) and then moved."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    sd = {}
    st_files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if st_files:
        from safetensors.torch import load_file
        for f in st_files:
            sd.update(load_file(os.path.join(path, f), device="cpu"))
    else:
        bins = sorted(f for f in os.listdir(path) if f.endswith(".bin"))
        if not bins:
            raise FileNotFoundError(f"no weights in {path}")
        for f in bins:
            sd.update(torch.load(os.path.join(path, f), map_location="cpu",
                                 weights_only=True))
    return cfg, params_from_state_dict(cfg, sd, dtype, device)


def load_hf_model(hf_model, dtype=torch.float32, device=None) -> tuple[ModelConfig, dict]:
    """(config, params) of an in-memory HF torch model."""
    cfg = config_from_hf(hf_model.config)
    return cfg, params_from_state_dict(cfg, dict(hf_model.state_dict()), dtype, device)
