"""Carry the JAX package's params across to the port.

``params_from_jax`` takes the JAX params as a nested dict of numpy arrays
(for example ``jax.tree.map(numpy.asarray, params)``) and returns the port's
params dict on ``device``: bf16 leaves go through f32 (numpy has no bf16 of
its own; the JAX side hands over ml_dtypes' bfloat16), every other dtype is
kept.  The layouts are the same in both packages, so nothing is transposed.

``load_ckpt`` reads a checkpoint directory that the JAX package's harness
wrote (``harness/tinylm.py`` ``save_ckpt``): ``config.json`` (the model
config's fields) and ``params.npz`` (the stacked params, one array a leaf,
keys like ``layers/wq``), with numpy alone.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from mustafar_tpu_torch.config import ModelConfig
from mustafar_tpu_torch.device import resolve_device

# config.json keys of the JAX config's MoE MLP, which the port has not got yet
_MOE_KEYS = ("num_experts", "num_experts_per_tok", "expert_capacity_factor")


def _leaf(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(a.copy()).to(device)


def params_from_jax(np_tree: dict, device=None) -> dict:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``
    (default ``cuda``)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _leaf(node, dev)

    return conv(np_tree)


def load_ckpt(ckpt_dir: str, device=None):
    """(ModelConfig, params) of a checkpoint directory, the params f32 (as
    ``params.npz`` holds them) on ``device`` (default ``cuda``).  A config with MoE experts
    is refused (the port has no MoE MLP yet); the MoE keys of a dense
    model's config are dropped."""
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        raw = json.load(f)
    if raw.get("num_experts", 0):
        raise NotImplementedError(f"{ckpt_dir}: a MoE model ({raw['num_experts']} experts); "
                                  f"the port's MoE MLP is ROADMAP Queue A item 14")
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = set(raw) - fields - set(_MOE_KEYS)
    if unknown:
        raise ValueError(f"{ckpt_dir}: unknown config keys {sorted(unknown)}")
    cfg = ModelConfig(**{k: v for k, v in raw.items() if k in fields})
    dev = resolve_device(device)
    params: dict = {"layers": {}}
    with np.load(os.path.join(ckpt_dir, "params.npz")) as data:
        for key in data.files:
            parts = [p for p in key.split("/") if p]
            leaf = torch.from_numpy(np.asarray(data[key], np.float32)).to(dev)
            if len(parts) == 1:
                params[parts[0]] = leaf
            else:
                params.setdefault(parts[0], {})[parts[1]] = leaf
    if "embed" not in params:
        raise ValueError(f"{ckpt_dir}: params.npz has no embed")
    return cfg, params
