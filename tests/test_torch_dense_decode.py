"""Port parity, the dense cache's flash-decode (TPU kernel 4,
``ops/kernels/dense_decode.py``) and ``DenseKVCache(use_pallas=True)``.

(x) The kernel's plain version against the JAX kernel in Pallas interpret
    mode: scalar and per-slot pos (an idle slot at -1 comes out 0), query
    groups 1 and 4, S = 1,312 (not a multiple of 512: the TPU tiling falls
    to 32-token tiles, which the port takes too); its tile rule is the TPU
    kernel's; the wrapper refuses the options and what the CUDA kernel
    cannot take.
(s) The CUDA kernel's split arithmetic (``flash_decode_attention_split_plain``:
    per-split partials from fresh softmax states, merged in split order)
    against the same JAX kernel and against the TPU-order plain version, at
    the kernel's split lengths (64, 128 and the wrapper's rule): one split,
    two, and lengths that do not divide the tokens; bf16 and f32 q; an idle
    slot comes out 0.
(y) ``DenseKVCache(use_pallas=True)`` on the CPU against the JAX dense
    cache's stacked decode with ``use_pallas``: outputs and cache state,
    uniform and per slot.
(z) The dense continuous-batching engine with ``use_pallas`` on both sides
    (per-slot ticks through the kernel), teacher-forced as in
    ``test_torch_scheduler.py``.

Tolerances: both sides read q, K and V as bf16, take the same online-softmax
steps and round p to bf16; their f32 sums run in another order, which can
move a bf16 rounding of p by one ulp now and then, so outputs are held to
2 bf16 ulps of their scale (the card's gate for every kernel).
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mustafar_tpu import config as jc
from mustafar_tpu.cache.dense import DenseKVCache as JDense
from mustafar_tpu.models.llama import init_params as j_init_params
from mustafar_tpu.ops.kernels.dense_decode import flash_decode_attention as j_flash
from mustafar_tpu.runtime.scheduler import ContinuousBatchingEngine as JEngine
from mustafar_tpu_torch import config as tc
from mustafar_tpu_torch.cache.dense import DenseKVCache as TDense
from mustafar_tpu_torch.ops.kernels import dense_decode as tdd
from mustafar_tpu_torch.ops.kernels import quant_attention as qa
from mustafar_tpu_torch.runtime.scheduler import ContinuousBatchingEngine as TEngine
from mustafar_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)

TOL = 2 * 2.0 ** -8          # 2 bf16 ulps of the output's scale
S = 1312


def _inputs(seed, B, Hkv, G, S=S, D=128):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, 1, Hkv * G, D).astype(np.float32)
    k = rs.randn(B, S, Hkv, D).astype(np.float32)
    v = rs.randn(B, S, Hkv, D).astype(np.float32)
    return q, k, v


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar", "per_slot"])
@pytest.mark.parametrize("G", [1, 4])
def test_plain_matches_jax_kernel(G, per_slot):
    B, Hkv = 3, 2
    q, k, v = _inputs(G + 2 * per_slot, B, Hkv, G)
    pos = np.array([-1, 1000, 37], np.int32) if per_slot else 599
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(pos, jnp.int32)))
    tpos = torch.from_numpy(pos) if per_slot else pos
    before = tdd.flash_decode_attention.launches
    got = tdd.flash_decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), tpos)
    assert tdd.flash_decode_attention.launches == before   # the CPU launches nothing
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    _close(got.numpy(), want)
    if per_slot:
        assert (got[0] == 0).all() and (want[0] == 0).all()
    # bf16 q: the output in bf16, as the TPU kernel casts it
    got16 = tdd.flash_decode_attention(torch.from_numpy(q).to(torch.bfloat16),
                                       torch.from_numpy(k), torch.from_numpy(v), tpos)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_array_equal(got16.float().numpy(),
                                  got.to(torch.bfloat16).float().numpy())


SPLIT_CASES = {"scalar": 599, "short": 127, "per_slot": [-1, 1000, 37, 200]}


@functools.lru_cache(maxsize=None)
def _jax_case(mode):
    """Inputs (Hkv=2, G=4) and the JAX kernel's output, once a mode."""
    pos = SPLIT_CASES[mode]
    per_slot = isinstance(pos, list)
    q, k, v = _inputs(40 + len(mode), len(pos) if per_slot else 3, 2, 4)
    pos = np.array(pos, np.int32) if per_slot else pos
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(pos, jnp.int32)))
    return q, k, v, pos, want


@pytest.mark.parametrize("mode", list(SPLIT_CASES))
@pytest.mark.parametrize("split", [None, 64, 128], ids=["rule", "64", "128"])
def test_split_plain_matches_jax_kernel(split, mode):
    """The kernel's split lengths, 64 and 128, and the rule's own (64 at
    these B * Hkv <= 8 rows): 600 tokens as 5 splits of 128 (4 x 128 + 88)
    or 10 of 64 (9 x 64 + 24); 128 tokens as one split of 128 or two of 64;
    per slot also 1,001, 38 (one split) and 201 tokens (two splits of 128)
    and an idle slot, which comes out exactly 0.  Held to the JAX kernel at
    the file's tolerance and to the TPU-order plain version at 2 bf16 ulps
    of each slot's scale; a bf16 q gives the f32 q's output rounded."""
    q, k, v, pos, want = _jax_case(mode)
    per_slot = mode == "per_slot"
    tpos = torch.from_numpy(pos) if per_slot else pos
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    got = tdd.flash_decode_attention_split_plain(torch.from_numpy(q), tk, tv, tpos, split)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    _close(got.numpy(), want)
    tpu = tdd.flash_decode_attention_plain(torch.from_numpy(q), tk, tv, tpos).numpy()
    for b in range(q.shape[0]):
        _close(got[b].numpy(), tpu[b])
    if per_slot:
        assert (got[0] == 0).all()
    got16 = tdd.flash_decode_attention_split_plain(torch.from_numpy(q).to(torch.bfloat16),
                                                   tk, tv, tpos, split)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_array_equal(got16.float().numpy(),
                                  got.to(torch.bfloat16).float().numpy())


def test_split_rule():
    """128 tokens a split where the grid then holds at least four blocks an
    SM (132 on an H100), else 64: 600 tokens at 64 rows would give 5 x 64 =
    320 blocks of 128, so 64; 8,448 (a per-slot grid sized from S) 66 x 64
    of 128.  The split plain version refuses a length the kernel cannot
    take."""
    assert tdd.split_len(600, 64) == 64 and tdd.split_len(8448, 64) == 128
    assert tdd.split_len(600, 8) == 64 and tdd.split_len(0, 64) == 64
    assert tdd.split_len(1024, 64) == 64 and tdd.split_len(1025, 64) == 128
    assert tdd.split_len(1100, 64, sms=200) == 64
    q, k, v = (torch.from_numpy(a) for a in _inputs(0, 1, 1, 1, S=256))
    for split in (32, 63, 129, 256):
        with pytest.raises(ValueError, match="tokens a split"):
            tdd.flash_decode_attention_split_plain(q, k, v, 200, split)


def test_tile_is_the_tpu_rule():
    """The TPU wrapper's tile: 512 halved until it divides S (32 at 1,312,
    256 at 8,448), S itself below 512."""
    def tpu_rule(S, ts=512):
        ts = min(ts, S)
        while S % ts:
            ts //= 2
        return ts
    for s_ in (1312, 8448, 1024, 300, 200, 1000, 2304):
        assert tdd.decode_tile(s_) == tpu_rule(s_)
    assert tdd.decode_tile(1312) == 32 and tdd.decode_tile(8448) == 256


def test_wrapper_refuses_what_the_kernel_cannot_serve():
    q, k, v = _inputs(5, 2, 2, 4, S=64)
    ok = dict(q=torch.from_numpy(q), k_cache=torch.from_numpy(k),
              v_cache=torch.from_numpy(v), pos=10)
    tdd.flash_decode_attention(**ok)
    # the sliding window is served: 8 keeps rows 3-10 of the 11
    windowed = tdd.flash_decode_attention(**ok, window=8)
    assert torch.equal(windowed, tdd.flash_decode_attention_plain(
        ok["q"], ok["k_cache"], ok["v_cache"], 10, window=8))
    assert not torch.equal(windowed, tdd.flash_decode_attention(**ok))
    assert torch.equal(tdd.flash_decode_attention(**ok, window=32),
                       tdd.flash_decode_attention(**ok))
    for window in (0, 8.0):
        with pytest.raises(ValueError, match="window"):
            tdd.flash_decode_attention(**ok, window=window)
    # the final (m, l) are served: the output is the call's without them
    out, m, l = tdd.flash_decode_attention(**ok, return_norm=True)
    assert torch.equal(out, tdd.flash_decode_attention(**ok))
    assert m.shape == l.shape == (q.shape[0], k.shape[2], q.shape[2] // k.shape[2], 1)
    assert (l >= 1).all()
    bad = [
        dict(pos=64), dict(pos=-2), dict(pos=3.0),
        dict(pos=torch.tensor([1, 2])),                          # int64
        dict(pos=torch.tensor([1, 2, 3], dtype=torch.int32)),    # not [B]
        dict(q=torch.from_numpy(q[:, :, :7].copy())),            # 7 heads over 2
        dict(v_cache=torch.from_numpy(v[:, :32].copy())),
        dict(q=torch.from_numpy(q[..., :64].copy())),            # D 64
        dict(q=torch.from_numpy(q).to(torch.float16)),
    ]
    for change in bad:
        with pytest.raises((ValueError, TypeError)):
            tdd.flash_decode_attention(**dict(ok, **change))
    # a device the kernel does not run on is refused, never computed on the CPU
    with pytest.raises(ValueError, match="unsupported device"):
        tdd.flash_decode_attention(**{k_: (t.to("meta") if torch.is_tensor(t) else t)
                                      for k_, t in ok.items()})
    # split scratch the C entries could not be told the size of (int floats)
    with pytest.raises(ValueError, match="int sizes"):
        qa._split_scratch(2048, 2048, 8, torch.device("meta"), 0)


def _engine(mod, B=2, max_seq=1024):
    model = dataclasses.replace(mod.TINY_LLAMA, head_dim=128, num_heads=4,
                                num_kv_heads=1, hidden_size=256)
    return mod.EngineConfig(model=model, cache_mode=mod.CacheMode.DENSE,
                            max_seq_len=max_seq, prefill_bucket=64, batch_size=B)


@pytest.mark.parametrize("per_slot", [False, True], ids=["uniform", "per_slot"])
def test_dense_cache_use_pallas_matches_jax(per_slot):
    """One decode step of layer 1 of a 2-layer f32 cache: the port writes the
    row, then runs the kernel's plain version; JAX's stacked decode with
    ``use_pallas`` does the same in interpret mode.  The caches agree but at
    an idle slot's last row, where JAX wraps its index -1 and the port
    writes nothing (``insert_slot`` overwrites that row before the slot is
    used again)."""
    B, L, Smax = 3, 2, 1024
    jimpl = JDense(_engine(jc, B, Smax), use_pallas=True)
    timpl = TDense(_engine(tc, B, Smax), use_pallas=True, device="cpu")
    assert TDense(_engine(tc, B, Smax), device="cpu").use_pallas is False
    rs = np.random.RandomState(7 + per_slot)
    kf = rs.randn(L, B, Smax, 1, 128).astype(np.float32)
    vf = rs.randn(L, B, Smax, 1, 128).astype(np.float32)
    q = rs.randn(B, 1, 4, 128).astype(np.float32)
    k = rs.randn(B, 1, 1, 128).astype(np.float32)
    v = rs.randn(B, 1, 1, 128).astype(np.float32)
    pos = np.array([400, -1, 17], np.int32) if per_slot else 300
    out_j, _, bufs = jimpl.decode_attend({}, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(pos, jnp.int32),
                                         full={"k": jnp.asarray(kf), "v": jnp.asarray(vf)},
                                         li=1)
    state = {"k": torch.from_numpy(kf.copy()), "v": torch.from_numpy(vf.copy())}
    tpos = torch.from_numpy(pos).long() if per_slot else pos   # the engine's int64
    out_t = timpl.decode_attend(state, 1, torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), tpos)
    _close(out_t.numpy(), np.asarray(out_j))
    for key in ("k", "v"):
        want = np.asarray(bufs[key]).copy()
        got = state[key].numpy()
        if per_slot:
            np.testing.assert_array_equal(got[1, 1, -1], kf[1, 1, -1] if key == "k"
                                          else vf[1, 1, -1])    # untouched
            want[1, 1, -1] = got[1, 1, -1]
            assert (out_t[1] == 0).all()
        np.testing.assert_array_equal(got, want, err_msg=key)


def test_dense_engine_use_pallas_matches_jax():
    """The dense engine's per-slot ticks through the kernel: five requests
    over two slots (slots retire, idle at -1 and are reused), f32 model;
    tokens teacher-forced on JAX's streams, near-ties within the logit noise
    of the bf16 roundings (1e-2, as the compressed kernels)."""
    jeng, teng = _engine(jc), _engine(tc)
    jp = j_init_params(jeng.model, jax.random.PRNGKey(11), dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rs = np.random.RandomState(11)
    reqs = [(rs.randint(0, 512, size=n), m)
            for n, m in ((40, 8), (100, 12), (70, 6), (250, 10), (9, 5))]
    jcb = JEngine(jeng, jp, dtype=jnp.float32, use_native=False)
    jcb.impl.use_pallas = jcb.prefill_impl.use_pallas = True
    for p, m in reqs:
        jcb.submit(p, m)
    want = jcb.run()

    class Forced(TEngine):
        logits = {}

        def _choose(self, logits2d, reqs_):
            picks = []
            for row, req in zip(logits2d, reqs_):
                if req is None:
                    picks.append(0)
                    continue
                self.logits.setdefault(req.uid, []).append(row.numpy())
                picks.append(want[req.uid][len(req.out)])
            return np.array(picks)

    free = TEngine(teng, tp, dtype=torch.float32, device="cpu")
    forced = Forced(teng, tp, dtype=torch.float32, device="cpu")
    for cb in (free, forced):
        cb.impl.use_pallas = True
        for p, m in reqs:
            cb.submit(p, m)
    got, _ = free.run(), forced.run()
    assert sorted(got) == sorted(want)
    for uid, jt in want.items():
        lg = np.stack(Forced.logits[uid])
        jt = np.asarray(jt)
        gap = lg.max(-1) - lg[np.arange(len(jt)), jt]
        assert (gap <= 1e-2).all(), (uid, np.flatnonzero(gap > 1e-2))
        ties = np.flatnonzero(lg.argmax(-1) != jt)
        parted = np.flatnonzero(np.asarray(got[uid]) != jt)
        assert (parted[0] if len(parted) else len(jt)) >= (ties[0] if len(ties) else len(jt))
