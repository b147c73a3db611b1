"""Port parity, tiny-model training (``harness/tinylm.py`` ``train``,
``models/llama.py`` ``lm_forward``) against the JAX package's on the CPU.

(b) ``make_training_batch``: the same tokens and weights, bit for bit, and
    the same ``RandomState`` after, for the same draws.
(g) One step's loss and every gradient of the port's ``training_loss`` (a
    backward pass through ``lm_forward``) against ``jax.value_and_grad`` of
    the JAX package's training loss (its ``train``'s ``loss_fn``, restated
    here: weighted next-token cross-entropy of ``llama.lm_forward``), on
    the same f32 weights and batch: within 1e-5 of each leaf's largest
    gradient, the loss within 1e-5 relative; without and with ``remat``, and
    with a sliding window of 48 (the banded path at T = 128).
(o) The optimiser: the schedule against optax's
    ``warmup_cosine_decay_schedule`` (the first update's rate 0), and three
    ``make_optimizer`` steps on the same gradients against
    ``optax.adamw(schedule, b1=0.9, b2=0.95, weight_decay=0.01)``: every
    leaf within 1e-5 of its scale (every leaf decayed, as optax does).
(c) ``python -m mustafar_tpu_torch train-tiny --steps 2`` (``cli.main``,
    ``MUSTAFAR_CPU=1``, a small corpus) writes a checkpoint that the port's
    and the JAX package's ``load_ckpt`` read, whose ``config.json`` and
    ``params.npz`` keys are those the JAX package's ``save_ckpt`` writes
    for the same params.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mustafar_tpu import config as jc
from mustafar_tpu.harness import tinylm as jtiny
from mustafar_tpu.models import llama as jl
from mustafar_tpu_torch import cli
from mustafar_tpu_torch.harness import tinylm as ttiny
from mustafar_tpu_torch.parallel.distributed import init_params_np
from mustafar_tpu_torch.weights import load_ckpt

torch.set_num_threads(1)
TOL = 1e-5
SEQ = 128
CORPUS_ROOT = os.path.dirname(np.__file__)


@pytest.fixture(scope="module")
def corpus():
    return "".join(open(os.path.join(CORPUS_ROOT, name), encoding="utf-8").read()
                   for name in ("__init__.py", "_globals.py", "version.py", "matlib.py"))


def _cfgs(window=None):
    tcfg = ttiny.train_config(SEQ, hidden=64, layers=2, window=window)
    return jc.ModelConfig(**dataclasses.asdict(tcfg)), tcfg


def test_train_config_follows_the_jax_rules():
    cfg = ttiny.train_config(4096, hidden=64, layers=2, window=48, rope_theta=5e5)
    assert (cfg.hidden_size, cfg.intermediate_size, cfg.num_layers) == (64, 192, 2)
    assert (cfg.max_position_embeddings, cfg.rope_theta, cfg.sliding_window) == (
        8192, 5e5, 48)
    assert cfg.name == "tiny-acc-h64L2-sw48"
    assert ttiny.train_config(2048) == ttiny.TINY_ACC


def test_make_training_batch_bit_equal(corpus):
    rj, rt = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(3):
        jt, jw = jtiny.make_training_batch(corpus, rj, 4, SEQ)
        tt, tw = ttiny.make_training_batch(corpus, rt, 4, SEQ)
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tw, jw)
        assert tt.dtype == jt.dtype and tw.dtype == jw.dtype
    assert rj.rand() == rt.rand()
    assert (jw == 8.0).any()          # a passkey span was drawn


def _jax_loss_fn(cfg, remat):
    def loss_fn(params, toks, wts):
        logits = jl.lm_forward(cfg, params, toks, remat=remat)
        ls = optax.softmax_cross_entropy_with_integer_labels(logits[:, :-1], toks[:, 1:])
        w = wts[:, 1:]
        return (ls * w).sum() / w.sum()
    return jax.jit(jax.value_and_grad(loss_fn))


def _torch_params(params_np):
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return torch.tensor(node, requires_grad=True)
    return conv(params_np)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("remat,window", [(False, None), (True, None), (True, 48)])
def test_loss_and_gradients_match_jax(corpus, remat, window):
    jcfg, tcfg = _cfgs(window)
    params_np = init_params_np(tcfg, 7)
    toks, wts = jtiny.make_training_batch(corpus, np.random.RandomState(1), 2, SEQ)
    loss, grads = _jax_loss_fn(jcfg, remat)(jax.tree.map(jnp.asarray, params_np),
                                            jnp.asarray(toks), jnp.asarray(wts))
    params = _torch_params(params_np)
    got = ttiny.training_loss(tcfg, params, torch.as_tensor(toks).long(),
                              torch.as_tensor(wts), remat=remat)
    got.backward()
    assert abs(float(got.detach()) - float(loss)) <= TOL * abs(float(loss))
    want = _flat(jax.tree.map(np.asarray, grads))
    tgrads = {k: v.grad.numpy() for k, v in _flat(params).items()}
    assert set(tgrads) == set(want)
    for k, w in want.items():
        err = np.abs(tgrads[k] - w).max()
        assert err <= TOL * np.abs(w).max(), (k, err, np.abs(w).max())


@pytest.mark.parametrize("steps", [3, 20, 3000])
def test_schedule_matches_optax(steps):
    lr = 1e-3
    warmup = min(100, max(1, steps // 10))
    want = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps, warmup + 1),
                                              lr * 0.05)
    rate = ttiny.lr_schedule(lr, steps)
    assert rate(0) == 0.0
    for k in sorted({0, 1, warmup - 1, warmup, warmup + 1, steps // 2, steps - 1, steps,
                     steps + 5}):
        assert abs(rate(k) - float(want(k))) <= 1e-6 * lr, k


def test_three_adamw_steps_match_optax():
    _, tcfg = _cfgs()
    params_np = init_params_np(tcfg, 2)
    rs = np.random.RandomState(4)
    grads = [jax.tree.map(lambda a: (rs.standard_normal(a.shape) * 0.01).astype(np.float32),
                          params_np) for _ in range(3)]
    steps, lr = 3, 1e-3
    warmup = min(100, max(1, steps // 10))
    opt = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, lr, warmup,
                                                         max(steps, warmup + 1), lr * 0.05),
                      b1=0.9, b2=0.95, weight_decay=0.01)
    jp = jax.tree.map(jnp.asarray, params_np)
    state = opt.init(jp)
    params = _torch_params(params_np)
    leaves = _flat(params)
    topt, sched = ttiny.make_optimizer(list(leaves.values()), lr, steps)
    step = jax.jit(lambda g, state, p: (lambda u, s: (optax.apply_updates(p, u), s))(
        *opt.update(g, state, p)))
    for g in grads:
        jp, state = step(jax.tree.map(jnp.asarray, g), state, jp)
        for k, v in _flat(g).items():
            leaves[k].grad = torch.as_tensor(v)
        topt.step()
        sched.step()
    for k, w in _flat(jax.tree.map(np.asarray, jp)).items():
        err = np.abs(leaves[k].detach().numpy() - w).max()
        assert err <= TOL * np.abs(w).max(), (k, err)
    # the first update's rate is 0: only the later two moved the weights
    assert not np.array_equal(_flat(jax.tree.map(np.asarray, jp))["embed"],
                              params_np["embed"])


def test_train_tiny_cli_checkpoint_reads_in_both_packages(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("MUSTAFAR_CPU", "1")
    monkeypatch.setattr(ttiny, "_CORPUS_ROOTS", [CORPUS_ROOT])
    out = tmp_path / "ck"
    cli.main(["train-tiny", "--out", str(out), "--steps", "2", "--batch", "2",
              "--seq", str(SEQ), "--hidden", "64", "--layers", "2"])
    logged = capsys.readouterr().out
    assert "step 2/2" in logged and "nan" not in logged, logged
    tcfg, tparams = load_ckpt(str(out), device="cpu")
    jcfg, jparams = jtiny.load_ckpt(str(out))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg == ttiny.train_config(SEQ, hidden=64, layers=2)
    flat_t, flat_j = _flat(tparams), _flat(jax.tree.map(np.asarray, jparams))
    assert set(flat_t) == set(flat_j)
    for k, v in flat_j.items():
        np.testing.assert_array_equal(flat_t[k].numpy(), v)
    # the JAX package's save_ckpt of the same params writes the same files
    again = tmp_path / "jax"
    jtiny.save_ckpt(str(again), jcfg, jparams)
    assert (out / "config.json").read_text() == (again / "config.json").read_text()
    with np.load(out / "params.npz") as a, np.load(again / "params.npz") as b:
        assert a.files == b.files
    assert json.loads((out / "config.json").read_text())["num_layers"] == 2
