"""Port parity, W8A8 (int8 weights and int8 activations) against the JAX
package's ``enable_act_quant`` path, on the CPU.

(a) ``act_quant``: codes and scales bit for bit with JAX's jitted
    ``act_quant`` (which multiplies by the f32 reciprocal of 127, as the
    port does), f32 and bf16 rows, a row of zeros among them.
(d) ``w8a8_dot``: the int32 accumulators (``int8_matmul``) bit for bit with
    JAX's int8 ``dot_general``, and the outputs bit for bit (f32 and bf16).
(f) ``fuse_projections`` composes with the W8A8 markers: the fused params'
    logits bit for bit those of the unfused ones (one act_quant a row, the
    same int32 columns).
(s) ``enable_act_quant(init_params_w8(cfg))`` has the structure of JAX's
    ``enable_act_quant(quantize_params(init_params(cfg)))``; the int8
    weights it multiplies go column-major, their values unchanged.
(l) Prefill and two decode steps' logits of a tiny f32 Llama in W8A8 on
    the dense and q8q4 caches.  W8A8 is chaotic in the last bit: the port's
    f32 activations differ from XLA's in their last bits, and act_quant
    turns such a difference into one int8 step of an input (1/127 of its
    row's largest value) wherever a value sits at a rounding edge (and the
    q8q4 cache into a step of a 4-bit V code).  So the bound is JAX's own
    spread: the port's logits lie within 3x the distance between JAX's and
    JAX's with every weight scale moved one ulp up (1.1e-2 to 1.9e-2 of the
    logits' range here; the port 1.1e-2 to 3.6e-2, at most 2.6x; under W8
    alone the port is within 2.3e-6 of JAX).
(g) Greedy tokens through the ``Generator`` on the dense, masked and q8q4
    caches against JAX's, by teacher forcing (each of the port's picks is
    JAX's token or ties with it within the suite's ``TIE_TOL``).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mustafar_tpu import config as jc
from mustafar_tpu.cache import make_cache as j_make_cache
from mustafar_tpu.models import llama as jl
from mustafar_tpu.models import quant as jq
from mustafar_tpu.runtime.generate import Generator as JGenerator
from mustafar_tpu_torch import config as tc
from mustafar_tpu_torch.cache import make_cache as t_make_cache
from mustafar_tpu_torch.models import llama as tl
from mustafar_tpu_torch.models import quant as tq
from mustafar_tpu_torch.runtime.generate import Generator as TGenerator
from mustafar_tpu_torch.weights import params_from_jax
from tests.test_torch_scheduler import TIE_TOL

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


@pytest.fixture(scope="module")
def params():
    """A tiny f32 Llama in W8A8 for both packages (JAX's quantize_params,
    carried across, then each package's enable_act_quant)."""
    jp = jq.quantize_params(jl.init_params(_model(jc), jax.random.PRNGKey(0),
                                           dtype=jnp.float32))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jq.enable_act_quant(jp), tq.enable_act_quant(tp), tp


def _rows(dtype):
    x = np.random.RandomState(0).randn(64, 256).astype(np.float32)
    x *= np.random.RandomState(1).rand(64, 1).astype(np.float32) * 8
    x[5] = 0.0
    x[7] = 0.0
    x[7, 3] = 1e-3                                   # a row of one tiny value
    j = jnp.asarray(x, dtype)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_act_quant_bit_exact(dtype):
    jx, tx = _rows(dtype)
    jqx, jsx = map(np.asarray, jax.jit(jq.act_quant)(jx))
    tqx, tsx = tq.act_quant(tx)
    assert tqx.dtype == torch.int8 and tsx.dtype == torch.float32
    np.testing.assert_array_equal(tqx.numpy(), jqx)
    np.testing.assert_array_equal(tsx.numpy(), jsx)
    assert (tqx[5] == 0).all() and tqx[7, 3] == 127


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a8_dot_bit_exact(dtype):
    jx, tx = _rows(dtype)
    w = np.random.RandomState(2).randn(256, 384).astype(np.float32) * 0.05
    jw, js = jax.jit(jq._quant_last)(jnp.asarray(w))
    tw, ts = torch.from_numpy(np.asarray(jw)), torch.from_numpy(np.asarray(js))
    jxq, _ = jax.jit(jq.act_quant)(jx)
    jacc = np.asarray(jax.lax.dot_general(jxq, jw, (((1,), (0,)), ((), ())),
                                          preferred_element_type=jnp.int32))
    txq, _ = tq.act_quant(tx)
    for w_t in (tw, tq._col_major(tw)):
        acc = tq.int8_matmul(txq, w_t)
        assert acc.dtype == torch.int32
        np.testing.assert_array_equal(acc.numpy(), jacc)
    want = jax.jit(jq.w8a8_dot)(jx, jw, js)
    got = tq.w8a8_dot(tx, tw, ts)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    head = jax.jit(lambda x, w, s: jq.w8a8_dot(x, w, s, out_dtype=jnp.float32))(jx, jw, js)
    np.testing.assert_array_equal(tq.w8a8_dot(tx, tw, ts, out_dtype=torch.float32).numpy(),
                                  np.asarray(head))


def test_fused_projections_under_a8_bit_exact(params):
    _, tp, _ = params
    fused = tq.fuse_projections(tp)
    assert "wqkv" in fused["layers"] and "a8" in fused["layers"]
    eng = _engine(tc, "DENSE")
    toks = torch.from_numpy(np.random.RandomState(3).randint(0, 512, (2, 256))).long()
    logs = []
    for p in (tp, fused):
        impl = t_make_cache(eng, device="cpu")
        logit, _ = tl.prefill(eng.model, p, toks, impl.init(2, torch.float32), impl, 200)
        logs.append(logit)
    assert torch.equal(logs[0], logs[1])


def _flat(p):
    flat = {k: v for k, v in p.items() if k != "layers"}
    flat.update({"layers/" + k: v for k, v in p["layers"].items()})
    return flat


def test_enable_act_quant_structure():
    cfg = _model(tc)
    tp = tq.init_params_w8(cfg, device="cpu", seed=0)
    ta = tq.enable_act_quant(tp)
    jp = jax.eval_shape(lambda: jq.enable_act_quant(jq.quantize_params(
        jl.init_params(_model(jc), jax.random.PRNGKey(0)))))
    flat_t, flat_j = _flat(ta), _flat(jp)
    assert sorted(flat_t) == sorted(flat_j)
    for key, jv in flat_j.items():
        assert tuple(flat_t[key].shape) == jv.shape, key
        assert str(flat_t[key].dtype).split(".")[-1] == jv.dtype.name, key
    for name in ("wq", "w_down"):
        w = ta["layers"][name]
        assert w.stride(-2) == 1 and torch.equal(w, tp["layers"][name])
    assert ta["lm_head"].stride(0) == 1 and torch.equal(ta["lm_head"], tp["lm_head"])
    assert ta["layers"]["attn_norm"] is tp["layers"]["attn_norm"]


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("mode", ["DENSE", "COMPRESSED"])
def test_w8a8_prefill_and_decode_logits_match(mode, params):
    """Prefill (last position) and two decode steps.  Each step's bound is
    3x the distance between JAX's logits and JAX's own with every weight
    scale one ulp up (module note (l))."""
    jp, tp, _ = params

    def up(leaves):
        return {k: jnp.nextafter(v, jnp.inf) if k.endswith("_scale") else v
                for k, v in leaves.items()}

    jp_ulp = dict(up({k: v for k, v in jp.items() if k != "layers"}), layers=up(jp["layers"]))
    jimpl = j_make_cache(_engine(jc, mode))
    timpl = t_make_cache(_engine(tc, mode), device="cpu")
    B, T, true_len = 2, 512, 300
    toks = np.zeros((B, T), np.int32)
    toks[:, :true_len] = np.random.RandomState(1).randint(0, 512, (B, true_len))
    jpre = jax.jit(lambda p, t, c: jl.prefill(_model(jc), p, t, c, jimpl,
                                              jnp.int32(true_len), last_only=True))
    jstep = jax.jit(lambda p, t, c, pos: jl.decode_step(_model(jc), p, t, c, jimpl, pos))
    jruns = [list(jpre(p, jnp.asarray(toks), jimpl.init(B, jnp.float32)))
             for p in (jp, jp_ulp)]
    tlog, tcache = tl.prefill(_model(tc), tp, torch.from_numpy(toks).long(),
                              timpl.init(B, torch.float32), timpl, true_len, last_only=True)
    logs = [(np.asarray(jruns[0][0]), np.asarray(jruns[1][0]), tlog.numpy())]
    tok = logs[0][0][:, 0].argmax(-1)
    for pos in (true_len, true_len + 1):
        for run, p in zip(jruns, (jp, jp_ulp)):
            run[:] = jstep(p, jnp.asarray(tok[:, None]), run[1], jnp.int32(pos))
        tlog, tcache = tl.decode_step(_model(tc), tp, torch.from_numpy(tok[:, None]).long(),
                                      tcache, timpl, pos)
        logs.append((np.asarray(jruns[0][0]), np.asarray(jruns[1][0]), tlog.numpy()))
        tok = logs[-1][0][:, 0].argmax(-1)
    for jo, jo_ulp, to in logs:
        assert to.dtype == np.float32 and to.shape == jo.shape == (B, 1, 512)
        assert 0 < _rel(jo_ulp, jo) < 5e-2
        assert _rel(to, jo) <= 3 * _rel(jo_ulp, jo), (_rel(to, jo), _rel(jo_ulp, jo))


def _forced_logits(gen, prompt, stream):
    """The port's logits of every pick when fed JAX's tokens."""
    impl, cfg, params = gen.cache_impl, gen.cfg, gen.params
    T = prompt.shape[1]
    toks = torch.zeros((prompt.shape[0], gen._bucket(T)), dtype=torch.int64)
    toks[:, :T] = torch.from_numpy(prompt)
    cache = impl.init(prompt.shape[0], gen.dtype)
    with torch.inference_mode():
        logits, cache = tl.prefill(cfg, params, toks, cache, impl, T, last_only=True)
        out = [logits[:, 0]]
        for i in range(1, stream.shape[1]):
            logits, cache = tl.decode_step(cfg, params,
                                           torch.from_numpy(stream[:, i - 1:i]).long(),
                                           cache, impl, T + i - 1)
            out.append(logits[:, 0])
            if hasattr(impl, "compact") and impl.window_full(cache, T + i):
                impl.compact(cache)
    return torch.stack(out, 1).numpy()


@pytest.mark.parametrize("mode", ["DENSE", "MASKED", "COMPRESSED"])
def test_w8a8_generator_matches_jax(mode, params):
    jp, tp, _ = params
    prompt = np.random.RandomState(4).randint(0, 512, size=(2, 280))
    want = np.stack([np.asarray(r) for r in
                     JGenerator(_engine(jc, mode), jp, dtype=jnp.float32).generate(prompt, 16)])
    tgen = TGenerator(_engine(tc, mode), tp, dtype=torch.float32, device="cpu")
    got = np.stack(tgen.generate(prompt, 16))
    lg = _forced_logits(tgen, prompt, want)
    gap = lg.max(-1) - np.take_along_axis(lg, want[..., None], -1)[..., 0]
    assert (gap <= TIE_TOL["COMPRESSED"]).all(), np.argwhere(gap > TIE_TOL["COMPRESSED"])
    # the free streams part only at or after a near-tie
    for b in range(2):
        ties = np.flatnonzero(lg[b].argmax(-1) != want[b])
        parted = np.flatnonzero(got[b] != want[b])
        assert (parted[0] if len(parted) else 16) >= (ties[0] if len(ties) else 16)
