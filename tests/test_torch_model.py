"""Port parity, the model: full-model logits against the JAX package for bf16
and for W8 weights (f), the W8 initialiser, and the device rule of the
entry points (i).  JAX weights reach the port through ``params_from_jax``.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mustafar_tpu import config as jc
from mustafar_tpu.cache import make_cache as j_make_cache
from mustafar_tpu.models import llama as jl
from mustafar_tpu.models.quant import quantize_params as j_quantize_params
from mustafar_tpu_torch import config as tc
from mustafar_tpu_torch.cache import make_cache as t_make_cache
from mustafar_tpu_torch.models import llama as tl
from mustafar_tpu_torch.models import quant as tq
from mustafar_tpu_torch.runtime.generate import Generator as TGenerator
from mustafar_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)


def _model(mod):
    return dataclasses.replace(mod.TINY_LLAMA, head_dim=128, num_heads=4,
                               num_kv_heads=2, hidden_size=256)


def _engine(mod, mode):
    return mod.EngineConfig(
        model=_model(mod), cache_mode=getattr(mod.CacheMode, mode),
        prune=mod.PruneConfig(method=mod.PruneMethod.KT_MAG_VT_MAG,
                              k_sparsity=0.7, v_sparsity=0.7),
        max_seq_len=1024, prefill_bucket=256, chunk_size=256, codec="q8q4")


@functools.cache
def _params(dtype, w8):
    """The model's weights (seed 0) in ``dtype``, W8 or not, made once a
    module for every case that uses them."""
    jp = jl.init_params(_model(jc), jax.random.PRNGKey(0), dtype=dtype)
    if w8:
        jp = j_quantize_params(jp)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("dtype,w8", [("float32", False), ("bfloat16", False),
                                      ("bfloat16", True), ("float32", True)])
@pytest.mark.parametrize("mode", ["DENSE", "COMPRESSED"])
def test_prefill_and_decode_logits_match(dtype, w8, mode):
    """Prefill logits (last position) and two decode steps' logits."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp, tp = _params(jdt, w8)
    if w8:
        assert tp["layers"]["wq"].dtype == torch.int8
        assert tp["embed_scale"].dtype == torch.float32
    jimpl = j_make_cache(_engine(jc, mode))
    jimpl.use_pallas = mode == "COMPRESSED"        # JAX kernel, interpret mode
    timpl = t_make_cache(_engine(tc, mode), device="cpu")
    B, T, true_len = 2, 512, 300
    toks = np.zeros((B, T), np.int32)
    toks[:, :true_len] = np.random.RandomState(1).randint(0, 512, (B, true_len))
    jcache = jimpl.init(B, jdt)
    tcache = timpl.init(B, tdt)
    # the JAX prefill under jit: one compile, where an eager call
    # dispatches (and interprets the kernel) op by op
    jprefill = jax.jit(lambda p, t, c, n: jl.prefill(_model(jc), p, t, c, jimpl, n,
                                                     last_only=True))
    jlog, jcache = jprefill(jp, jnp.asarray(toks), jcache, jnp.int32(true_len))
    tlog, tcache = tl.prefill(_model(tc), tp, torch.from_numpy(toks).long(), tcache,
                              timpl, true_len, last_only=True)
    logs = [(np.asarray(jlog), tlog.numpy())]
    jstep = jax.jit(lambda p, t, c, pos: jl.decode_step(_model(jc), p, t, c, jimpl, pos))
    tok = np.asarray(jlog)[:, 0].argmax(-1)
    for pos in (true_len, true_len + 1):
        jlog, jcache = jstep(jp, jnp.asarray(tok[:, None]), jcache, jnp.int32(pos))
        tlog, tcache = tl.decode_step(_model(tc), tp, torch.from_numpy(tok[:, None]).long(),
                                      tcache, timpl, pos)
        logs.append((np.asarray(jlog), tlog.numpy()))
        tok = np.asarray(jlog)[:, 0].argmax(-1)
    for jo, to in logs:
        assert to.dtype == np.float32 and to.shape == jo.shape == (B, 1, 512)
        scale = np.abs(jo).max()
        if dtype == "float32":
            # f32 model; the q8q4 kernel reads q and the window as bf16 and
            # rounds p to bf16, which turns last-bit differences of the f32
            # inputs into rare bf16 flips: 1e-3 of the logits' range
            tol = 1e-5 if mode == "DENSE" else 1e-3
        else:
            # bf16 model: XLA may keep fused elementwise chains in f32, torch
            # rounds after each op, so activations differ by a few bf16 ulps
            # and the logits by a few percent of their range
            tol = 6e-2
        np.testing.assert_allclose(to, jo, rtol=0, atol=tol * scale)


def test_quantize_params_bit_exact():
    """The port's W8 quantization of carried-over bf16 weights equals the
    JAX package's (jitted per leaf) bit for bit."""
    jp = jl.init_params(_model(jc), jax.random.PRNGKey(3), dtype=jnp.bfloat16)
    jq8 = jax.tree.map(np.asarray, j_quantize_params(jp))
    tq8 = tq.quantize_params(params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))
    assert tq.quantize_params(tq8)["layers"]["wq"] is tq8["layers"]["wq"]   # idempotent
    flat_j = dict(jq8, **{"layers/" + k: v for k, v in jq8.pop("layers").items()})
    flat_t = dict(tq8, **{"layers/" + k: v for k, v in tq8.pop("layers").items()})
    assert sorted(flat_t) == sorted(flat_j)
    for key, jv in flat_j.items():
        tv = flat_t[key]
        tv = tv.float().numpy() if tv.dtype == torch.bfloat16 else tv.numpy()
        np.testing.assert_array_equal(tv, jv.astype(tv.dtype), err_msg=key)


def test_init_params_w8_structure():
    cfg = _model(tc)
    g = torch.Generator(device="cpu")
    g.manual_seed(0)
    tp = tq.init_params_w8(cfg, g, device="cpu")
    jp = jax.eval_shape(lambda: j_quantize_params(
        jl.init_params(_model(jc), jax.random.PRNGKey(0))))
    flat_t = {k: v for k, v in tp.items() if k != "layers"}
    flat_t.update({"layers/" + k: v for k, v in tp["layers"].items()})
    flat_j = {k: v for k, v in jp.items() if k != "layers"}
    flat_j.update({"layers/" + k: v for k, v in jp["layers"].items()})
    assert sorted(flat_t) == sorted(flat_j)
    for key, jv in flat_j.items():
        assert tuple(flat_t[key].shape) == jv.shape, key
        assert str(flat_t[key].dtype).split(".")[-1] == jv.dtype.name, key
    assert tq.weight_bytes(tp) == sum(int(np.prod(v.shape)) * v.dtype.itemsize
                                      for v in jax.tree.leaves(jp))
    # per-out-channel int8: every column reaches +-127
    w = tp["layers"]["w_gate"][1].float()
    assert (w.abs().amax(0) == 127).all()
    g.manual_seed(0)
    again = tq.init_params_w8(cfg, g, device="cpu")
    assert torch.equal(again["layers"]["wq"], tp["layers"]["wq"])
    assert torch.equal(again["lm_head"], tp["lm_head"])


def test_entry_points_need_a_device_when_no_card():
    """With no CUDA, every entry point raises unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the rule is checked where none is")
    eng = _engine(tc, "COMPRESSED")
    params = {"final_norm": torch.ones(256)}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TGenerator(eng, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_make_cache(eng)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tq.init_params_w8(_model(tc))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax({"x": np.zeros(3, np.float32)})
    gen = TGenerator(eng, params, device="cpu")
    assert gen.device.type == "cpu"
