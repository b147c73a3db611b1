"""Port parity, the pruning policies (``mustafar_tpu_torch/ops/pruning.py``).

Every function against the JAX package's, jitted, on the same numpy inputs:
the keep masks equal bit for bit, ties included (the threshold rule keeps
every tie; ``exact`` and ThinK / ThinV break ties to the lower index, as
``jax.lax.top_k`` does).  Inputs carry exact ties (a channel copied onto
another, a row of equal magnitudes) and an all-zero channel.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mustafar_tpu.ops import pruning as jp
from mustafar_tpu_torch.ops import pruning as tp

torch.set_num_threads(2)


def _x(seed, *shape, dtype=np.float32):
    """Random values with exact ties: channel 3 = channel 7 (up to sign), a
    row of equal magnitudes and an all-zero channel."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    x[..., 7] = -x[..., 3]
    x[..., 0, :] = np.where(np.arange(shape[-1]) % 2 == 0, 0.5, -0.5)
    x[..., 11] = 0.0
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16)).astype(np.float32)
    return x


def _both(x, dtype):
    if dtype == "bfloat16":
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _eq(t, j):
    j = np.asarray(j)
    t = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    j = j.astype(np.float32) if j.dtype.name == "bfloat16" else j
    np.testing.assert_array_equal(t, j)


def test_keep_count():
    for n in (1, 7, 32, 128):
        for s in (0.0, 0.3, 0.5, 0.7, 0.99):
            assert tp.keep_count(n, s) == jp.keep_count(n, s)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.7])
def test_token_mag(dtype, exact, sparsity):
    x = _x(1, 2, 3, 9, 128, dtype=dtype)
    jx, tx = _both(x, dtype)
    fn = jax.jit(functools.partial(jp.magnitude_mask_lastdim, sparsity=sparsity,
                                   exact=exact))
    _eq(tp.magnitude_mask_lastdim(tx, sparsity, exact), fn(jx))
    fn = jax.jit(functools.partial(jp.prune_token_mag, sparsity=sparsity, exact=exact))
    _eq(tp.prune_token_mag(tx, sparsity, exact), fn(jx))


def test_threshold_keeps_every_tie():
    """A row of equal magnitudes keeps all of them under the threshold rule,
    and exactly keep_count (the lowest channels) with ``exact``."""
    x = torch.full((1, 128), 0.5)
    assert int(tp.magnitude_mask_lastdim(x, 0.7).sum()) == 128
    m = tp.magnitude_mask_lastdim(x, 0.7, exact=True)
    assert m[0, :40].all() and not m[0, 40:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("gs", [8, 32])
def test_channel_mag(dtype, exact, gs):
    x = _x(2, 2, 2, 64, 16, dtype=dtype)
    jx, tx = _both(x, dtype)
    fn = jax.jit(functools.partial(jp.prune_channel_mag, sparsity=0.7, group_size=gs,
                                   exact=exact))
    _eq(tp.prune_channel_mag(tx, 0.7, gs, exact), fn(jx))


def test_opa_scores():
    rs = np.random.RandomState(3)
    qm, k = rs.rand(2, 3, 128).astype(np.float32), _x(4, 2, 3, 9, 128)
    w, v = rs.rand(2, 3, 9).astype(np.float32), _x(5, 2, 3, 9, 128)
    _eq(tp.key_opa_score(torch.from_numpy(qm), torch.from_numpy(k)),
        jax.jit(jp.key_opa_score)(qm, k))
    _eq(tp.value_opa_score(torch.from_numpy(w), torch.from_numpy(v)),
        jax.jit(jp.value_opa_score)(w, v))


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.7])
def test_prune_by_score(exact, sparsity):
    x = _x(6, 2, 5, 128)
    score = np.abs(_x(7, 2, 5, 128))            # ties and zeros in the score too
    fn = jax.jit(functools.partial(jp.prune_by_score_lastdim, sparsity=sparsity,
                                   exact=exact))
    _eq(tp.prune_by_score_lastdim(torch.from_numpy(x), torch.from_numpy(score), sparsity,
                                  exact), fn(x, score))


@pytest.mark.parametrize("exact", [False, True])
def test_channel_by_score(exact):
    x, score = _x(8, 2, 2, 64, 16), np.abs(_x(9, 2, 2, 64, 16))
    fn = jax.jit(functools.partial(jp.prune_channel_by_score, sparsity=0.5, group_size=32,
                                   exact=exact))
    _eq(tp.prune_channel_by_score(torch.from_numpy(x), torch.from_numpy(score), 0.5, 32,
                                  exact), fn(x, score))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sparsity", [0.0, 0.3, 0.5])
def test_think(dtype, sparsity):
    """ThinK over a padded bucket (its query mean reads the last 32 rows,
    pad rows included), with tied and all-zero channels: the all-zero K
    channel scores 0 and goes first, ties to the lower channel."""
    k = _x(10, 1, 2, 48, 32, dtype=dtype)
    q = _x(11, 1, 4, 48, 32, dtype=dtype)
    q[..., 40:, :] = 0.0                                      # pad rows
    (jk, tk), (jq, tq) = _both(k, dtype), _both(q, dtype)
    fn = jax.jit(functools.partial(jp.think_prune_key, sparsity=sparsity))
    _eq(tp.think_prune_key(tk, tq, sparsity), fn(jk, jq))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_thinv(dtype):
    v = _x(12, 2, 2, 40, 32, dtype=dtype)
    v[..., 5] = v[..., 9]                                     # an exact tie
    jv, tv = _both(v, dtype)
    for s in (0.0, 0.5, 0.7):
        _eq(tp.thinv_prune_value(tv, s),
            jax.jit(functools.partial(jp.thinv_prune_value, sparsity=s))(jv))


def test_sparsity_of():
    x = _x(13, 4, 128)
    np.testing.assert_allclose(float(tp.sparsity_of(torch.from_numpy(x))),
                               float(jp.sparsity_of(jnp.asarray(x))), rtol=0, atol=1e-7)
