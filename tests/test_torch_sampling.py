"""Port parity, sampled decoding: the port's filter (``generate.filter_logits``:
temperature, top-k, top-p) against the JAX package's ``_sample``, and the
draws the ``Generator`` and the engine make with it.

(f) 4,000 JAX draws (``_sample`` vmapped over the pick step) on a
    vocabulary of 64, at several settings: every draw lies in the port's
    kept set, and every kept token of probability at least 1/200 under the
    filtered softmax appears among them (a miss has probability
    (1 - 1/200)^4000 < 3e-9).  Top-k keeps the ties at the k-th logit
    (JAX's rule, ``l < kth`` dropped); top-p keeps the first token at any
    p > 0 and no token at p <= 0, where both packages draw token 0.
(d) The port's draws: reproducible per (seed, step), in the kept set, spread
    over it; top-k 1 is greedy.  The ``Generator`` and the engine sample
    with it (dense cache, CPU): the same seed gives the same tokens, top-k 1
    gives the greedy tokens, and the engine's draws follow its pick steps.

The tokens drawn are not the JAX package's (its PRNG is threefry): the kept
set is compared, exactly (the filters agree on every token here; the
logits are spaced so that no cumulative sum sits within f32 noise of p).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mustafar_tpu.runtime.generate import SamplingParams as JSampling
from mustafar_tpu.runtime.generate import _sample
from mustafar_tpu_torch import config as tc
from mustafar_tpu_torch.models.llama import init_params
from mustafar_tpu_torch.runtime import generate as tg
from mustafar_tpu_torch.runtime.scheduler import ContinuousBatchingEngine as TEngine

torch.set_num_threads(1)

V, DRAWS = 64, 4000
SETTINGS = {
    "temperature": dict(temperature=0.7),
    "top_k": dict(temperature=1.0, top_k=8),
    "top_p": dict(temperature=0.9, top_p=0.8),
    "all": dict(temperature=0.9, top_k=50, top_p=0.95, seed=7),
    "k_and_p": dict(temperature=1.3, top_k=12, top_p=0.6, seed=3),
}


def _logits(seed=0, B=3):
    """[B, V] f32 logits, each row a shuffle of 64 distinct values 3/16
    apart (so sums of their softmax keep clear of p), but for ties: row 0
    holds three equal values at its 7th-9th largest (ties at top-k 8)."""
    rs = np.random.RandomState(seed)
    l = np.stack([rs.permutation(V) for _ in range(B)]) * 0.1875 - 6.0
    order = np.argsort(-l[0])
    l[0, order[6:9]] = l[0, order[6]]
    return l.astype(np.float32)


def _jax_draws(logits, sp):
    key = jax.random.PRNGKey(sp.get("seed", 0))
    jsp = JSampling(**sp)
    fn = jax.jit(jax.vmap(lambda s: _sample(jnp.asarray(logits), key, s, jsp)))
    return np.asarray(fn(jnp.arange(1, DRAWS + 1)))                   # [DRAWS, B]


@pytest.mark.parametrize("name", list(SETTINGS))
def test_filter_keeps_jax_draws(name):
    sp = SETTINGS[name]
    logits = _logits()
    kept_l = tg.filter_logits(torch.from_numpy(logits), tg.SamplingParams(**sp))
    kept = torch.isfinite(kept_l).numpy()
    draws = _jax_draws(logits, sp)
    probs = torch.softmax(kept_l, dim=-1).numpy()
    for b in range(logits.shape[0]):
        drawn = np.unique(draws[:, b])
        assert kept[b, drawn].all(), f"row {b}: JAX drew {drawn[~kept[b, drawn]]}"
        likely = np.flatnonzero(kept[b] & (probs[b] >= 1 / 200))
        assert np.isin(likely, drawn).all(), \
            f"row {b}: never drawn {np.setdiff1d(likely, drawn)}"
        # the port's own draws lie in the same set
        mine = [int(tg.sample(torch.from_numpy(logits), tg.SamplingParams(**sp), s)[b])
                for s in range(1, 200)]
        assert kept[b, mine].all()


def test_top_k_keeps_ties_at_the_kth():
    logits = _logits()
    kept = torch.isfinite(tg.filter_logits(torch.from_numpy(logits),
                                           tg.SamplingParams(temperature=1.0, top_k=8)))
    assert kept[0].sum() == 9                      # three tied at the 7th-9th largest
    assert (kept[1:].sum(-1) == 8).all()
    kth = np.sort(logits[0])[::-1][7]
    assert kept[0].numpy()[logits[0] == kth].all()
    draws = _jax_draws(logits, dict(temperature=1.0, top_k=8))
    assert np.isin(np.flatnonzero(logits[0] == kth), draws[:, 0]).all()


def test_top_p_keeps_the_first_token():
    """A nucleus smaller than the top token's probability keeps the top
    token alone, in both packages; top-k 1 likewise."""
    logits = _logits()
    for sp in (dict(temperature=1.0, top_p=1e-6), dict(temperature=1.0, top_k=1)):
        kept = torch.isfinite(tg.filter_logits(torch.from_numpy(logits),
                                               tg.SamplingParams(**sp))).numpy()
        assert (kept.sum(-1) == 1).all() and (kept.argmax(-1) == logits.argmax(-1)).all()
        draws = _jax_draws(logits, sp)
        assert (draws == logits.argmax(-1)[None]).all()
        got = tg.sample(torch.from_numpy(logits), tg.SamplingParams(**sp), 5)
        assert (got.numpy() == logits.argmax(-1)).all()


@pytest.mark.parametrize("top_p", [0.0, -0.5])
def test_top_p_at_or_below_zero_draws_token_0(top_p):
    """At top_p <= 0 JAX's filter keeps no token: every logit is -inf and
    its categorical draw returns index 0 in every row.  The port keeps none
    either, and its Gumbel-max draw returns 0 too (the Generator's draws
    included)."""
    logits = _logits()
    sp = dict(temperature=1.0, top_p=top_p)
    assert (_jax_draws(logits, sp)[:50] == 0).all()
    kept = tg.filter_logits(torch.from_numpy(logits), tg.SamplingParams(**sp))
    assert torch.isneginf(kept).all()
    for step in range(1, 20):
        assert (tg.sample(torch.from_numpy(logits), tg.SamplingParams(**sp), step) == 0).all()


def test_draws_reproducible_per_seed_and_step():
    logits = torch.from_numpy(_logits(B=16))
    sp = tg.SamplingParams(temperature=1.0, seed=11)
    a, b = tg.sample(logits, sp, 3), tg.sample(logits, sp, 3)
    assert torch.equal(a, b)
    assert not torch.equal(a, tg.sample(logits, sp, 4))
    assert not torch.equal(a, tg.sample(logits, dataclasses.replace(sp, seed=12), 3))
    # the draws spread over the kept set: 400 steps of row 0 hit most of its
    # likely tokens
    steps = torch.stack([tg.sample(logits, sp, s) for s in range(400)])[:, 0].numpy()
    probs = torch.softmax(logits[0], -1).numpy()
    assert np.isin(np.flatnonzero(probs >= 0.05), steps).all()
    assert torch.equal(tg.choose(logits, tg.GREEDY, 1), logits.argmax(-1))


def _dense_engine(**kw):
    model = dataclasses.replace(tc.TINY_LLAMA, num_layers=1)
    return tc.EngineConfig(model=model, cache_mode=tc.CacheMode.DENSE, max_seq_len=256,
                           prefill_bucket=32, **kw)


def test_generator_and_engine_sample():
    eng = _dense_engine(batch_size=2)
    params = init_params(eng.model, device="cpu", dtype=torch.float32, seed=0)
    prompt = np.random.RandomState(1).randint(0, 512, size=(2, 20))
    gen = tg.Generator(eng, params, dtype=torch.float32, device="cpu")
    hot = tg.SamplingParams(temperature=0.9, top_k=50, top_p=0.95, seed=7)
    a = np.stack(gen.generate(prompt, 12, sampling=hot))
    assert np.array_equal(a, np.stack(gen.generate(prompt, 12, sampling=hot)))
    assert not np.array_equal(a, np.stack(gen.generate(
        prompt, 12, sampling=dataclasses.replace(hot, seed=8))))
    greedy = np.stack(gen.generate(prompt, 12))
    assert not np.array_equal(a, greedy)
    one = np.stack(gen.generate(prompt, 12, sampling=dataclasses.replace(hot, top_k=1)))
    assert np.array_equal(one, greedy)

    def run(sp):
        cb = TEngine(eng, params, dtype=torch.float32, device="cpu", sampling=sp)
        uids = [cb.submit(p, 10) for p in prompt]
        out = cb.run()
        return np.stack([out[u] for u in uids]), cb
    s1, cb = run(hot)
    assert cb._pick_step == 2 + cb.decode_steps      # one pick a request, one a step
    assert np.array_equal(s1, run(hot)[0])
    assert np.array_equal(run(dataclasses.replace(hot, top_k=1))[0], run(tg.GREEDY)[0])
    assert not np.array_equal(s1, run(tg.GREEDY)[0])
