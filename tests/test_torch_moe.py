"""Port parity, Mixtral's sparse-MoE MLP (``models/moe.py``), its W8 and W8A8
experts, the MoE model through the caches, the ``Generator`` and the engine,
the quantized initialisers' MoE structure and the HF Mixtral loader, against
the JAX package on the CPU (its compressed cache's decode through its
kernel in interpret mode for the logits, its plain path for the tokens).

(c) ``expert_capacity`` equals JAX's on a grid of token counts, expert
    counts, top-k and factors.
(m) ``moe_mlp`` on one layer's leaves (f32, hidden 64, 4 experts, top-2)
    against JAX's jitted ``moe_mlp`` within 1e-5 of the output's largest
    value: no drops (factor 8); drops (factor 0.5: the same pairs dropped,
    some of them); a router whose columns 1 and 3 are equal (every token's
    two logits tie; where the tie straddles the top-2 edge the lower index
    wins, as ``jax.lax.top_k`` orders it); N = 2,048 (two groups of 1,024,
    each its own capacity) and N = 1,536 (one group); W8 experts; W8A8
    experts.  W8A8 puts the down projection's input (silu(gate) * up)
    through act_quant, where torch's silu and XLA's differ in the last bit
    of 0.35 % of values and can move an int8 code a step; its cases run
    with JAX's silu in the port's place, so that they hold the dispatch,
    the quantization and the int8 products at 1e-5.
(s) ``init_params_w8`` / ``init_params_w4`` for a MoE config have the
    structure (keys, shapes, dtypes) of JAX's ``quantize_params(init_params)``
    / ``quantize_params_w4(init_params)``; ``init_params`` JAX's.
(l) A 2-layer MoE model (head_dim 128, factor 1: prefill drops tokens):
    prefill and two decode steps' logits on the dense and q8q4 caches, as
    ``test_torch_model.py`` holds the dense model's (1e-5 of the range
    dense; 2e-3 q8q4, where that file has 1e-3: a bf16 flip in the
    kernel's reads puts one logit at 1.004e-3 here).
(g) Greedy tokens through the ``Generator`` (q8q4, bitmap; B=2, 300 + 12)
    and the engine (q8q4, two slots, prompts 40 and 90 as JAX's own
    ``test_moe_hf.py`` runs them), against JAX's ``Generator`` by teacher
    forcing (each pick JAX's token or tied within ``TIE_TOL``).
(h) HF Mixtral built in the test from a ``MixtralConfig`` (random weights):
    ``load_hf_model``'s logits within 2e-3 of HF's, and ``load_hf_dir`` of
    its ``save_pretrained`` directory gives the same params.
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
from mustafar_tpu.models import moe as jm
from mustafar_tpu.models import quant as jq
from mustafar_tpu.runtime.generate import Generator as JGenerator
from mustafar_tpu_torch import config as tc
from mustafar_tpu_torch.cache import make_cache as t_make_cache
from mustafar_tpu_torch.models import llama as tl
from mustafar_tpu_torch.models import moe as tm
from mustafar_tpu_torch.models import quant as tq
from mustafar_tpu_torch.models import weights as tw
from mustafar_tpu_torch.runtime.generate import Generator as TGenerator
from mustafar_tpu_torch.runtime.scheduler import ContinuousBatchingEngine as TEngine
from mustafar_tpu_torch.weights import params_from_jax
from tests.test_torch_scheduler import TIE_TOL, _check_streams, _Forced
from tests.test_torch_w8a8 import _forced_logits

torch.set_num_threads(1)

LAYER = dict(name="moe-test", vocab_size=256, hidden_size=64, intermediate_size=128,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
             max_position_embeddings=512, num_experts=4, num_experts_per_tok=2)
MODEL = dict(name="moe-model", vocab_size=512, hidden_size=128, intermediate_size=256,
             num_layers=2, num_heads=2, num_kv_heads=1, head_dim=128,
             max_position_embeddings=1024, num_experts=4, num_experts_per_tok=2,
             expert_capacity_factor=1.0)


def test_expert_capacity_matches_jax():
    for n in (1, 2, 7, 8, 9, 40, 256, 512, 1000, 1024, 1536, 4096):
        for e, k in ((4, 2), (8, 2), (8, 1), (3, 3)):
            for f in (0.5, 1.0, 1.25, 2.0, 8.0):
                assert tm.expert_capacity(n, e, k, f) == jm.expert_capacity(n, e, k, f)


@pytest.fixture(scope="module")
def layer():
    """Layer 0's MoE leaves for both packages in f32, W8 and W8A8."""
    jp = jl.init_params(jc.ModelConfig(**LAYER), jax.random.PRNGKey(0), dtype=jnp.float32)
    out = {}
    for fmt, fn in (("f32", lambda p: p), ("w8", jq.quantize_params),
                    ("w8a8", lambda p: jq.enable_act_quant(jq.quantize_params(p)))):
        jlp = jax.tree.map(lambda a: a[0], fn(jp)["layers"])
        out[fmt] = (jlp, params_from_jax(jax.tree.map(np.asarray, jlp), device="cpu"))
    return out


def _dropped(jlp, x, cfg):
    """Pairs JAX's dispatch drops, from its router logits (per group)."""
    n = 0
    xf = x.reshape(-1, x.shape[-1])
    G = 1024 if xf.shape[0] > 1024 and xf.shape[0] % 1024 == 0 else xf.shape[0]
    for g in range(0, xf.shape[0], G):
        logits = np.asarray(xf[g:g + G] @ np.asarray(jlp["w_router"]), np.float32)
        idx = np.asarray(jax.lax.top_k(jnp.asarray(logits), cfg.num_experts_per_tok)[1])
        C = jm.expert_capacity(G, cfg.num_experts, cfg.num_experts_per_tok,
                               cfg.expert_capacity_factor)
        counts = np.stack([(idx == e).any(-1) for e in range(cfg.num_experts)], 1).sum(0)
        n += int(np.maximum(counts - C, 0).sum())
    return n


def _jax_silu(t):
    return torch.from_numpy(np.array(jax.jit(jax.nn.silu)(t.numpy())))


MOE_CASES = {
    # case: (format, capacity factor, x shape)
    "no_drops": ("f32", 8.0, (2, 40, 64)),
    "drops": ("f32", 0.5, (2, 40, 64)),
    "router_tie": ("f32", 0.5, (2, 40, 64)),
    "two_groups": ("f32", 0.5, (2, 1024, 64)),
    "one_group": ("f32", 0.5, (3, 512, 64)),
    "w8": ("w8", 0.5, (2, 40, 64)),
    "w8a8": ("w8a8", 0.5, (2, 40, 64)),
    "w8a8_two_groups": ("w8a8", 0.5, (2, 1024, 64)),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_mlp_matches_jax(case, layer, monkeypatch):
    fmt, factor, shape = MOE_CASES[case]
    jcfg = jc.ModelConfig(**LAYER, expert_capacity_factor=factor)
    tcfg = tc.ModelConfig(**LAYER, expert_capacity_factor=factor)
    jlp, tlp = layer[fmt]
    if case == "router_tie":
        wr = np.array(jlp["w_router"])
        wr[:, 3] = wr[:, 1]
        jlp = dict(jlp, w_router=jnp.asarray(wr))
        tlp = dict(tlp, w_router=torch.from_numpy(wr))
    if fmt == "w8a8":
        monkeypatch.setattr(tm.F, "silu", _jax_silu)
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: jm.moe_mlp(jcfg, jlp, x))(jnp.asarray(x)))
    got = tm.moe_mlp(tcfg, tlp, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    dropped = _dropped(jlp, x, jcfg)
    assert (dropped == 0) == (factor == 8.0), dropped
    if case == "router_tie":
        # ties at the top-2 edge: experts 1 and 3 second and third
        logits = x.reshape(-1, 64) @ np.asarray(jlp["w_router"])
        second = np.sort(logits, -1)[:, -2]
        edge = (logits[:, 1] == second) & (np.sort(logits, -1)[:, -3] == second)
        assert edge.sum() > 5, edge.sum()
    if case == "two_groups":
        # one group of 2,048 would drop other pairs
        monkeypatch.setattr(tm, "_MOE_GROUP", 4096)
        assert not torch.allclose(tm.moe_mlp(tcfg, tlp, torch.from_numpy(x)), got)


def _flat(p):
    flat = {k: v for k, v in p.items() if k != "layers"}
    flat.update({"layers/" + k: v for k, v in p["layers"].items()})
    return flat


@pytest.mark.parametrize("fmt", ["bf16", "w8", "w4"])
def test_moe_init_structure(fmt):
    cfg = dict(LAYER, hidden_size=128, intermediate_size=256, head_dim=32)
    jcfg, tcfg = jc.ModelConfig(**cfg), tc.ModelConfig(**cfg)
    jfn = {"bf16": lambda p: p, "w8": jq.quantize_params, "w4": jq.quantize_params_w4}[fmt]
    jp = jax.eval_shape(lambda: jfn(jl.init_params(jcfg, jax.random.PRNGKey(0))))
    tp = {"bf16": lambda: tl.init_params(tcfg, device="cpu"),
          "w8": lambda: tq.init_params_w8(tcfg, device="cpu"),
          "w4": lambda: tq.init_params_w4(tcfg, device="cpu")}[fmt]()
    flat_t, flat_j = _flat(tp), _flat(jp)
    assert sorted(flat_t) == sorted(flat_j)
    for key, jv in flat_j.items():
        assert tuple(flat_t[key].shape) == jv.shape, key
        assert str(flat_t[key].dtype).split(".")[-1] == jv.dtype.name, key
    if fmt != "bf16":
        # per (expert, out-channel) int8: every column of every expert reaches 127
        w = tp["layers"]["we_up"][1].float()
        assert (w.abs().amax(1) == 127).all()


def _engine(mod, codec="q8q4", mode="COMPRESSED", **kw):
    return mod.EngineConfig(
        model=mod.ModelConfig(**MODEL), cache_mode=getattr(mod.CacheMode, mode),
        prune=mod.PruneConfig(method=mod.PruneMethod.KT_MAG_VT_MAG,
                              k_sparsity=0.5, v_sparsity=0.5),
        max_seq_len=1024, prefill_bucket=256, chunk_size=256, codec=codec, **kw)


@pytest.fixture(scope="module")
def model():
    jp = jl.init_params(jc.ModelConfig(**MODEL), jax.random.PRNGKey(5), dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("mode", ["DENSE", "COMPRESSED"])
def test_moe_prefill_and_decode_logits_match(mode, model):
    jp, tp = model
    jcfg, tcfg = jc.ModelConfig(**MODEL), tc.ModelConfig(**MODEL)
    jimpl = j_make_cache(_engine(jc, mode=mode))
    jimpl.use_pallas = mode == "COMPRESSED"        # JAX kernel, interpret mode
    timpl = t_make_cache(_engine(tc, mode=mode), device="cpu")
    B, T, true_len = 2, 512, 300
    toks = np.zeros((B, T), np.int32)
    toks[:, :true_len] = np.random.RandomState(1).randint(0, 512, (B, true_len))
    jpre = jax.jit(lambda p, t, c: jl.prefill(jcfg, p, t, c, jimpl, jnp.int32(true_len),
                                              last_only=True))
    jlog, jcache = jpre(jp, jnp.asarray(toks), jimpl.init(B, jnp.float32))
    tlog, tcache = tl.prefill(tcfg, tp, torch.from_numpy(toks).long(),
                              timpl.init(B, torch.float32), timpl, true_len, last_only=True)
    logs = [(np.asarray(jlog), tlog.numpy())]
    jstep = jax.jit(lambda p, t, c, pos: jl.decode_step(jcfg, p, t, c, jimpl, pos))
    tok = np.asarray(jlog)[:, 0].argmax(-1)
    for pos in (true_len, true_len + 1):
        jlog, jcache = jstep(jp, jnp.asarray(tok[:, None]), jcache, jnp.int32(pos))
        tlog, tcache = tl.decode_step(tcfg, tp, torch.from_numpy(tok[:, None]).long(),
                                      tcache, timpl, pos)
        logs.append((np.asarray(jlog), tlog.numpy()))
        tok = np.asarray(jlog)[:, 0].argmax(-1)
    # prefill dropped tokens: without drops (factor 8) the logits differ
    roomy = dataclasses.replace(tcfg, expert_capacity_factor=8.0)
    nodrop, _ = tl.prefill(roomy, tp, torch.from_numpy(toks).long(),
                           timpl.init(B, torch.float32), timpl, true_len, last_only=True)
    assert not np.allclose(nodrop.numpy(), logs[0][1], atol=1e-3)
    for jo, to in logs:
        assert to.dtype == np.float32 and to.shape == jo.shape == (B, 1, 512)
        # as test_torch_model.py: the q8q4 kernel reads q and the window as
        # bf16 and rounds p to bf16 (rare bf16 flips of f32 noise), 2e-3
        # here (one logit of 1,024 at 1.004e-3 of the range)
        tol = 1e-5 if mode == "DENSE" else 2e-3
        np.testing.assert_allclose(to, jo, rtol=0, atol=tol * np.abs(jo).max())


@pytest.mark.parametrize("codec", ["q8q4", "bitmap"])
def test_moe_generator_matches_jax(codec, model):
    jp, tp = model
    prompt = np.random.RandomState(6).randint(0, 512, size=(2, 300))
    want = np.stack([np.asarray(r) for r in
                     JGenerator(_engine(jc, codec), jp, dtype=jnp.float32).generate(prompt, 12)])
    tgen = TGenerator(_engine(tc, codec), tp, dtype=torch.float32, device="cpu")
    got = np.stack(tgen.generate(prompt, 12))
    lg = _forced_logits(tgen, prompt, want)
    _check_streams({0: want[0], 1: want[1]}, {0: got[0], 1: got[1]},
                   {0: list(lg[0]), 1: list(lg[1])}, TIE_TOL["COMPRESSED"])


def test_moe_engine_matches_jax(model):
    """JAX's own MoE engine test's case (``test_moe_hf.py``): the engine's
    tokens are its batch-1 Generator's."""
    jp, tp = model
    rs = np.random.RandomState(6)
    prompts = [rs.randint(0, 512, size=n) for n in (40, 90)]
    teng = _engine(tc, batch_size=2)
    tcb = TEngine(teng, tp, dtype=torch.float32, device="cpu")
    uids = [tcb.submit(p, 8) for p in prompts]
    got = tcb.run()
    assert sorted(got) == uids
    jgen = JGenerator(_engine(jc), jp, dtype=jnp.float32)
    want = {u: np.asarray(jgen.generate(p[None], 8)[0]) for u, p in zip(uids, prompts)}
    forced = _Forced(teng, tp, dtype=torch.float32, device="cpu", streams=want)
    for p in prompts:
        forced.submit(p, 8)
    forced.run()
    _check_streams(want, got, forced.logits, TIE_TOL["COMPRESSED"])


def _hf_mixtral():
    from transformers import MixtralConfig, MixtralForCausalLM
    torch.manual_seed(2)
    cfg = MixtralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512,
        rms_norm_eps=1e-5, rope_theta=10000.0, num_local_experts=4,
        num_experts_per_tok=2, sliding_window=None, tie_word_embeddings=False,
        attn_implementation="eager")
    return MixtralForCausalLM(cfg).eval()


def _prefill_logits(cfg, params, ids):
    # HF routes each token alone: a capacity of E/K x drops nothing
    cfg = dataclasses.replace(cfg, expert_capacity_factor=cfg.num_experts
                              / cfg.num_experts_per_tok)
    eng = tc.EngineConfig(model=cfg, cache_mode=tc.CacheMode.DENSE, max_seq_len=512)
    impl = t_make_cache(eng, device="cpu")
    with torch.inference_mode():
        logits, _ = tl.prefill(cfg, params, torch.as_tensor(ids), impl.init(len(ids),
                               torch.float32), impl, len(ids[0]))
    return logits.numpy()


def test_hf_mixtral_logits_and_dir(tmp_path):
    hf = _hf_mixtral()
    cfg, params = tw.load_hf_model(hf, device="cpu")
    assert (cfg.num_experts, cfg.num_experts_per_tok) == (4, 2)
    lp = params["layers"]
    assert "w_gate" not in lp and lp["w_router"].shape == (2, 64, 4)
    assert lp["we_gate"].shape == (2, 4, 64, 128) and lp["we_down"].shape == (2, 4, 128, 64)
    ids = np.random.RandomState(0).randint(1, 256, (2, 33))
    with torch.no_grad():
        ref = hf(torch.as_tensor(ids)).logits.float().numpy()
    np.testing.assert_allclose(_prefill_logits(cfg, params, ids), ref, rtol=2e-3, atol=2e-3)
    hf.save_pretrained(tmp_path, safe_serialization=True)
    cfg_d, params_d = tw.load_hf_dir(str(tmp_path), dtype=torch.float32, device="cpu")
    assert cfg_d == cfg
    flat_d, flat = _flat(params_d), _flat(params)
    assert sorted(flat_d) == sorted(flat)
    for key, v in flat.items():
        assert torch.equal(flat_d[key], v), key
