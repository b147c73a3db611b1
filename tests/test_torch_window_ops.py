"""Port parity, the sliding window's plain parts: the mask, banded prefill,
the named configs and the checkpoint reader.

(m) ``causal_mask`` with ``window`` equals the JAX package's, bit for bit.
(b) ``banded_window_prefill`` against JAX's at a few (T, W, block) with
    ``true_len`` below T (pad rows masked), in f32; and against the plain
    quadratic masked attention (the same function); the block rule is
    JAX's.
(p) ``prefill_attention``'s routing: a prompt longer than the window goes
    banded; a window that covers the prompt is vacuous and gives the causal
    output bit for bit; no window is causal.
(c) ``MODEL_REGISTRY`` and its configs hold the JAX package's values in
    every field the port has (MoE, which the port has not got, aside).
(l) ``load_ckpt`` reads a checkpoint directory (config and stacked params)
    as the JAX harness's ``load_ckpt`` does, and refuses a MoE one.
"""

import dataclasses
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mustafar_tpu import config as jc
from mustafar_tpu.harness import tinylm as jtl
from mustafar_tpu.ops import attention as ja
from mustafar_tpu_torch import config as tc
from mustafar_tpu_torch.ops import attention as ta
from mustafar_tpu_torch.weights import load_ckpt

torch.set_num_threads(2)


@pytest.mark.parametrize("window", [None, 1, 5, 64])
def test_causal_mask_matches_jax(window):
    qp, kp = np.arange(20, 90), np.arange(0, 100)
    for valid in (100, 77):
        want = np.asarray(ja.causal_mask(jnp.asarray(qp), jnp.asarray(kp), valid, window))
        got = ta.causal_mask(torch.from_numpy(qp), torch.from_numpy(kp), valid, window)
        np.testing.assert_array_equal(got.numpy(), want)
        if window is not None:       # exactly `window` keys for a query past it
            assert (got.numpy()[-1].sum() == min(window, valid - (kp[0]))
                    or qp[-1] >= valid)


def _qkv(seed, B, T, Hq=4, Hkv=2, D=32):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, T, Hq, D).astype(np.float32),
            rs.randn(B, T, Hkv, D).astype(np.float32),
            rs.randn(B, T, Hkv, D).astype(np.float32))


@pytest.mark.parametrize("T,W,block,true_len", [
    (300, 64, 128, 300), (300, 64, 128, 250), (513, 100, 256, 500), (130, 128, 128, 129),
    (700, 200, None, 640)])
def test_banded_window_prefill_matches_jax(T, W, block, true_len):
    """The banded prefill (query blocks of ``block`` rows against their
    W + block key band) against JAX's in f32, on the rows below
    ``true_len`` (the rows past it are garbage no caller reads), within f32
    rounding; and against plain masked attention over the whole prompt."""
    q, k, v = _qkv(T + W, 2, T)
    want = np.asarray(ja.banded_window_prefill(jnp.asarray(q), jnp.asarray(k),
                                               jnp.asarray(v), true_len, W, block))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = ta.banded_window_prefill(tq, tk, tv, true_len, W, block).numpy()
    assert got.shape == want.shape == q.shape
    np.testing.assert_allclose(got[:, :true_len], want[:, :true_len], rtol=1e-5, atol=1e-5)
    pos = torch.arange(T)
    full = ta.mha(tq, tk, tv, ta.causal_mask(pos, pos, true_len, W)).numpy()
    np.testing.assert_allclose(got[:, :true_len], full[:, :true_len], rtol=1e-5, atol=1e-5)


def test_band_block_is_the_jax_rule():
    """The largest of 512 and 256 whose f32 band logits fit 256 MiB, else
    128 (also where 128 does not fit: 277 MB at B=4, Hq=32, W=4,096)."""
    def jax_rule(B, Hq, W):
        for cand in (512, 256):
            if B * cand * Hq * (W + cand) * 4 <= 256 * 2 ** 20:
                return cand
        return 128
    for B, Hq, W in ((1, 4, 64), (4, 32, 4096), (1, 32, 4096), (2, 32, 4096),
                     (8, 32, 512), (1, 4, 100000)):
        assert ta.band_block(B, Hq, W) == jax_rule(B, Hq, W), (B, Hq, W)
    assert ta.band_block(4, 32, 4096) == 128 and 4 * 128 * 32 * (4096 + 128) * 4 > 256 * 2 ** 20


def test_prefill_attention_routes_as_jax():
    """T > window: banded, the same values as JAX's dispatch; T <= window:
    the window is vacuous and the output is the causal one bit for bit."""
    q, k, v = _qkv(5, 1, 200)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    causal = ta.prefill_attention(tq, tk, tv, 190)
    assert torch.equal(ta.prefill_attention(tq, tk, tv, 190, 200), causal)
    assert torch.equal(ta.prefill_attention(tq, tk, tv, 190, 4096), causal)
    banded = ta.prefill_attention(tq, tk, tv, 190, 50)
    assert torch.equal(banded, ta.banded_window_prefill(tq, tk, tv, 190, 50))
    want = np.asarray(ja.prefill_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           190, 50))
    np.testing.assert_allclose(banded.numpy()[:, :190], want[:, :190], rtol=1e-5, atol=1e-5)
    assert not torch.allclose(banded[:, 60:190], causal[:, 60:190])


def test_registry_matches_jax():
    """Every named config and every field the port's ModelConfig has."""
    assert tc.MODEL_REGISTRY.keys() == jc.MODEL_REGISTRY.keys()
    fields = [f.name for f in dataclasses.fields(tc.ModelConfig)]
    assert set(fields) <= {f.name for f in dataclasses.fields(jc.ModelConfig)}
    for name, tm in tc.MODEL_REGISTRY.items():
        jm = jc.MODEL_REGISTRY[name]
        assert {f: getattr(tm, f) for f in fields} == {f: getattr(jm, f) for f in fields}, name
        assert jm.num_experts == 0
    for name in ("LLAMA2_7B", "LLAMA3_8B", "MISTRAL_7B", "MISTRAL_7B_SWA", "TINY_LLAMA"):
        assert getattr(tc, name) == tc.MODEL_REGISTRY[getattr(tc, name).name]
    assert tc.MISTRAL_7B_SWA.sliding_window == 4096 and tc.MISTRAL_7B.sliding_window is None
    assert (tc.MISTRAL_7B_SWA.num_kv_heads, tc.MISTRAL_7B_SWA.q_dim) == (8, 4096)


def test_load_ckpt_matches_the_jax_reader(tmp_path):
    """A small checkpoint written by the JAX harness's ``save_ckpt`` reads
    back with the same config and the same arrays; the MoE keys of a dense
    config are dropped; a MoE config is refused."""
    from mustafar_tpu.models.llama import init_params
    import jax
    cfg = dataclasses.replace(jc.TINY_LLAMA, sliding_window=96, num_layers=1)
    params = init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    jtl.save_ckpt(str(tmp_path), cfg, params)
    jcfg, jparams = jtl.load_ckpt(str(tmp_path))
    tcfg, tparams = load_ckpt(str(tmp_path), device="cpu")
    assert tcfg == dataclasses.replace(tc.TINY_LLAMA, sliding_window=96, num_layers=1)
    assert tparams.keys() == jparams.keys()
    assert tparams["layers"].keys() == jparams["layers"].keys()
    for key, val in jparams["layers"].items():
        np.testing.assert_array_equal(tparams["layers"][key].numpy(), np.asarray(val))
    np.testing.assert_array_equal(tparams["embed"].numpy(), np.asarray(jparams["embed"]))
    assert tparams["embed"].dtype == torch.float32
    raw = json.loads((tmp_path / "config.json").read_text())
    (tmp_path / "config.json").write_text(json.dumps(dict(raw, num_experts=8)))
    with pytest.raises(NotImplementedError, match="MoE"):
        load_ckpt(str(tmp_path), device="cpu")
    (tmp_path / "config.json").write_text(json.dumps(dict(raw, bogus=1)))
    with pytest.raises(ValueError, match="bogus"):
        load_ckpt(str(tmp_path), device="cpu")
