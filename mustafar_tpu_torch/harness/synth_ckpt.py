"""Synthetic full-layout HF checkpoint writer (the real-checkpoint path's
proof): the port's copy of the JAX package's ``harness/synth_ckpt.py``.

A SYNTHETIC checkpoint with the on-disk layout of meta-llama/Meta-Llama-3.1-
8B-Instruct: sharded bf16 ``model-XXXXX-of-YYYYY.safetensors`` + index json,
``config.json`` with the llama3 rope_scaling recipe, and a fast tokenizer
(byte-level BPE trained on local text) that ``AutoTokenizer`` and the
port's ``harness.tokenizer.LocalTokenizer`` load.  The flow it proves
(reference: pred_long_bench.py:159-166 -> eval_long_bench.py):

    python -m mustafar_tpu_torch synth-ckpt --out /tmp/llama3-synth --rows 4
    python -m mustafar_tpu_torch predict --model /tmp/llama3-synth \
        --datasets passkey --data_dir /tmp/llama3-synth/rows \
        --mode kt_mag_vt_mag --codec q8q4 --k_sparsity 0.7 --v_sparsity 0.7 \
        --max_length 2048 --limit 2
    python -m mustafar_tpu_torch eval --pred_dir pred/<run>

Weights are random (accuracy is chance): the same ``default_rng(seed)``
draws as the JAX writer, rounded to bf16 by torch (round to nearest even,
as ml_dtypes rounds), so the tensors are bit-equal to the JAX package's.
"""

from __future__ import annotations

import json
import os

import numpy as np


LLAMA31_8B_HF_CONFIG = {
    "architectures": ["LlamaForCausalLM"],
    "model_type": "llama",
    "vocab_size": 128256,
    "hidden_size": 4096,
    "intermediate_size": 14336,
    "num_hidden_layers": 32,
    "num_attention_heads": 32,
    "num_key_value_heads": 8,
    "head_dim": 128,
    "rms_norm_eps": 1e-5,
    "rope_theta": 500000.0,
    "rope_scaling": {
        "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
        "original_max_position_embeddings": 8192, "rope_type": "llama3",
    },
    "max_position_embeddings": 131072,
    "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
}


def _small_config() -> dict:
    cfg = dict(LLAMA31_8B_HF_CONFIG)
    cfg.update(vocab_size=4096, hidden_size=256, intermediate_size=512,
               num_hidden_layers=2, num_attention_heads=2,
               num_key_value_heads=2, head_dim=128,
               max_position_embeddings=8192)
    return cfg


def _tensor_shapes(cfg: dict) -> dict:
    H = cfg["hidden_size"]
    V = cfg["vocab_size"]
    I = cfg["intermediate_size"]
    D = cfg["head_dim"]
    Hq = cfg["num_attention_heads"] * D
    Hkv = cfg["num_key_value_heads"] * D
    shapes = {"model.embed_tokens.weight": (V, H),
              "model.norm.weight": (H,),
              "lm_head.weight": (V, H)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        shapes.update({
            p + "input_layernorm.weight": (H,),
            p + "self_attn.q_proj.weight": (Hq, H),
            p + "self_attn.k_proj.weight": (Hkv, H),
            p + "self_attn.v_proj.weight": (Hkv, H),
            p + "self_attn.o_proj.weight": (H, Hq),
            p + "post_attention_layernorm.weight": (H,),
            p + "mlp.gate_proj.weight": (I, H),
            p + "mlp.up_proj.weight": (I, H),
            p + "mlp.down_proj.weight": (H, I),
        })
    return shapes


def _write_tokenizer(out: str, vocab_size: int = 2048, seed: int = 0):
    """Train a small byte-level BPE on local text and write the HF fast-
    tokenizer files AutoTokenizer.from_pretrained expects."""
    from tokenizers import Tokenizer, models, pre_tokenizers, decoders, trainers

    from mustafar_tpu_torch.harness.tinylm import load_corpus

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=vocab_size, special_tokens=["<|begin_of_text|>",
                                               "<|end_of_text|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    corpus = load_corpus(max_bytes=2_000_000, seed=seed)
    tok.train_from_iterator([corpus[i:i + 4096]
                             for i in range(0, len(corpus), 4096)], trainer)
    tok.save(os.path.join(out, "tokenizer.json"))
    with open(os.path.join(out, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "bos_token": "<|begin_of_text|>",
                   "eos_token": "<|end_of_text|>",
                   "model_max_length": 131072}, f, indent=1)


def write_checkpoint(out: str, small: bool = False, seed: int = 0,
                     shard_gib: float = 4.0, rows: int = 0,
                     ctx_bytes: int = 4000, log=print) -> str:
    """Write the synthetic HF checkpoint dir; returns ``out``.

    ``rows``: also write <out>/rows/passkey.jsonl needle-retrieval rows
    (LongBench schema) for the predict step.
    """
    import torch
    from safetensors.torch import save_file

    os.makedirs(out, exist_ok=True)
    cfg = _small_config() if small else dict(LLAMA31_8B_HF_CONFIG)
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    _write_tokenizer(out, seed=seed)

    shapes = _tensor_shapes(cfg)
    rng = np.random.default_rng(seed)
    limit = int(shard_gib * 2**30)
    shard, shard_bytes, shards, weight_map = {}, 0, [], {}

    def flush():
        nonlocal shard, shard_bytes
        if shard:
            shards.append(dict(shard))
            shard, shard_bytes = {}, 0

    total = 0
    for name, shp in shapes.items():
        if "norm" in name:
            t = torch.ones(shp, dtype=torch.bfloat16)
        else:
            t = torch.from_numpy(rng.standard_normal(shp, dtype=np.float32) *
                                 0.02).to(torch.bfloat16)
        nbytes = t.nbytes
        if shard_bytes + nbytes > limit:
            flush()
        shard[name] = t
        shard_bytes += nbytes
        total += nbytes
    flush()

    n = len(shards)
    for i, sd in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{n:05d}.safetensors"
        save_file(sd, os.path.join(out, fname))
        for name in sd:
            weight_map[name] = fname
        log(f"wrote {fname} ({sum(t.nbytes for t in sd.values()) / 2**30:.2f} GiB)")
    with open(os.path.join(out, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=1)
    log(f"checkpoint: {total / 2**30:.2f} GiB in {n} shards -> {out}")

    if rows:
        from mustafar_tpu_torch.harness.tinylm import load_corpus, make_passkey_row
        rows_dir = os.path.join(out, "rows")
        os.makedirs(rows_dir, exist_ok=True)
        corpus = load_corpus(max_bytes=2_000_000, seed=seed + 1)
        rs = np.random.RandomState(seed + 2)
        with open(os.path.join(rows_dir, "passkey.jsonl"), "w") as f:
            for _ in range(rows):
                f.write(json.dumps(make_passkey_row(corpus, rs, ctx_bytes))
                        + "\n")
        log(f"passkey rows -> {rows_dir}/passkey.jsonl")
    return out
