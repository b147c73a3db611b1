"""Port parity, the kernel options that output-aware (Opa) pruning in the
compressed cache reads (``test_torch_opa.py`` holds the cache).

(w) Window probabilities (``return_win_probs``) of the uniform decode
    kernels, kernel 1 (codecs q8, q8q4, q4q4) and kernel 6 (bitmap,
    bitmap-q8): the plain version in the TPU's order and the split plain
    version (the CUDA kernels' arithmetic) against the JAX kernels in Pallas
    interpret mode, within 1e-4 absolute, at window lengths short of the
    capacity, with no pool chunk, and zero past the window length; the
    output is the same with the option on.
(s) The same for the per-slot kernels, kernel 2 (quant codecs) and kernel 7
    (bitmap codecs): slots with their own chunk counts and window lengths,
    one with no chunk, one idle (all zero).
(n) The final (m, l) (``return_norm``) of kernels 1 and 6, both plain
    versions against the JAX kernels': m within 1e-6 relative, l 1e-5.
(r) The options and paths that once were refused now run (the per-slot
    probabilities, (m, l), Opa in the per-slot decode, ``compact_slots``
    and ``segment_attend``); the sliding window stays refused (ROADMAP item
    14), and so do the channel policies in the compressed cache.
(p) Packing by score: kernel 9's K+V entry with a score on one operand (the
    other keyed by |x|) equals its plain version on each, and sizes its grid
    from any operand's score (ROADMAP Queue C: the grid once read only the
    first operand's); the bitmap streams' ``score=`` keep the top scores
    as JAX's do.
"""

import dataclasses
import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mustafar_tpu.ops import sparse_format as jsf
from mustafar_tpu.ops.kernels import quant_attention as jqa
from mustafar_tpu.ops.kernels import sparse_attention as jska
from mustafar_tpu_torch import config as tc
from mustafar_tpu_torch.cache.compressed import CompressedKVCache as TCompressed
from mustafar_tpu_torch.ops import quant_format as tqf
from mustafar_tpu_torch.ops import sparse_format as tsf
from mustafar_tpu_torch.ops.kernels import pack_kernel as pk
from mustafar_tpu_torch.ops.kernels import quant_attention as tqa
from mustafar_tpu_torch.ops.kernels import sparse_attention as tska

torch.set_num_threads(1)

W = 288
CODECS = ("q8", "q8q4", "q4q4", "bitmap", "bitmap-q8")
BITS = {"q8": (8, 8), "q8q4": (8, 4), "q4q4": (4, 4)}
PROBS_TOL = 1e-4

# The JAX kernels, run in Pallas interpret mode as the JAX package's tests
# run them, under one jit each (as tests/test_torch_kernel.py calls them):
# their interpretation compiles once a shape and static argument set (the
# codec or formats, max_chunks, the options) and then runs in milliseconds,
# where each eager call took seconds.
STATIC = ("codec", "kfmt", "vfmt", "max_chunks", "return_norm", "return_win_probs")


def _jit(fn):
    """``fn`` under ``jax.jit``, the arguments of ``STATIC`` that it takes static."""
    params = inspect.signature(fn).parameters
    return jax.jit(fn, static_argnames=[name for name in STATIC if name in params])


J_DECODE = _jit(jqa.fused_q_decode_attention)
J_DECODE_PS = _jit(jqa.fused_q_decode_attention_ps)
J_V7 = _jit(jska.fused_sparse_decode_attention_v7)
J_V6PS = _jit(jska.fused_sparse_decode_attention_v6ps)


def _bf(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _engine(mod, method, codec):
    model = dataclasses.replace(mod.TINY_LLAMA, head_dim=128, num_heads=4, num_kv_heads=1,
                                hidden_size=256, num_layers=1)
    return mod.EngineConfig(
        model=model, cache_mode=mod.CacheMode.COMPRESSED,
        prune=mod.PruneConfig(method=getattr(mod.PruneMethod, method), k_sparsity=0.7,
                              v_sparsity=0.7),
        max_seq_len=1024, prefill_bucket=256, chunk_size=256, codec=codec)


class _Decode:
    """One codec's decode over a random stacked state (L=2, mc=3, B=2 and
    Hkv=2 unless given): the JAX kernels, the port's wrappers (the TPU-order
    plain versions on the CPU) and their split plain versions, uniform and
    per slot (``jax_ps``, ``port_ps``)."""

    def __init__(self, codec, G, seed, B=2, Hkv=2):
        rs = np.random.RandomState(seed)
        L, mc = 2, 3
        BH = B * Hkv
        self.q = _bf(rs.randn(B, 1, Hkv * G, 128))
        self.k_win, self.v_win = (_bf(rs.randn(L, BH, W, 128)) for _ in range(2))
        self.mc = mc
        if codec in BITS:
            self.jcodec = jqa.QuantCodec(256, 128, *BITS[codec])
            self.tcodec = tqf.QuantCodec(256, 128, *BITS[codec])
            # every int16 pattern is a valid set of codes
            self.pool = rs.randint(-32768, 32768, (L, mc, BH, self.tcodec.stream_rows, 128)
                                   ).astype(np.int16)
            self.scales = _bf(0.002 + 0.018 * rs.rand(L, mc, BH, 2, 128))
            return
        qbits = 8 if codec == "bitmap-q8" else 16
        self.jfmt = jsf.ChunkFormat(256, 128, 40, qbits=qbits)
        self.tfmt = tsf.ChunkFormat(256, 128, 40, qbits=qbits)
        x = jnp.asarray(rs.randn(L, mc, 2, BH, 256, 128) * 0.5, jnp.bfloat16)
        if qbits == 8:
            rows, sc = jax.jit(lambda a: jsf.prune_and_encode_stream_q8(a, self.jfmt))(x)
            self.scales = _bf(np.moveaxis(np.asarray(sc), 2, 3))
        else:
            rows = jax.jit(lambda a: jsf.prune_and_encode_stream(a, self.jfmt))(x)
            self.scales = None
        rows = np.asarray(rows)
        self.pool = np.concatenate([rows[:, :, 0], rows[:, :, 1]], axis=-2)

    def _jcall(self, nc, wl, li, per_slot, **opts):
        q, kw, vw = (jnp.asarray(a, jnp.bfloat16) for a in (self.q, self.k_win, self.v_win))
        args = ((jnp.asarray(nc, jnp.int32), jnp.asarray(wl, jnp.int32)) if per_slot
                else (jnp.int32(nc), jnp.int32(wl)))
        if hasattr(self, "jcodec"):
            fn = J_DECODE_PS if per_slot else J_DECODE
            res = fn(q, jnp.asarray(self.pool),
                     jnp.asarray(self.scales[..., 0, :], jnp.bfloat16),
                     jnp.asarray(self.scales[..., 1, :], jnp.bfloat16), kw, vw, *args,
                     self.jcodec, self.mc, li=jnp.int32(li), **opts)
        else:
            sc = {} if self.scales is None else {
                "kscales": jnp.asarray(self.scales[..., 0, :], jnp.bfloat16),
                "vscales": jnp.asarray(self.scales[..., 1, :], jnp.bfloat16)}
            fn = J_V6PS if per_slot else J_V7
            res = fn(q, jnp.asarray(self.pool), kw, vw, *args, self.jfmt, self.jfmt,
                     self.mc, li=jnp.int32(li), **opts, **sc)
        return [np.asarray(x) for x in res[1:]]

    def jax(self, nc, wl, li):
        return self._jcall(nc, wl, li, False, return_win_probs=True)[0]

    def jax_norm(self, nc, wl, li):
        return self._jcall(nc, wl, li, False, return_norm=True)

    def jax_ps(self, nc, wl, li):
        return self._jcall(nc, wl, li, True, return_win_probs=True)[0]

    def port_ps(self, nc, wl, li, fn="wrapper", **kw):
        nc, wl = (torch.tensor(x, dtype=torch.int32) for x in (nc, wl))
        args = (_t(self.q), torch.from_numpy(self.pool))
        if hasattr(self, "tcodec"):
            call = {"wrapper": tqa.fused_q_decode_attention_ps,
                    "split": tqa.fused_q_decode_attention_ps_split_plain}[fn]
            return call(*args, _t(self.scales), _t(self.k_win), _t(self.v_win), nc, wl, li,
                        self.tcodec, **kw)
        call = {"wrapper": tska.fused_sparse_decode_attention_ps,
                "split": tska.fused_sparse_decode_attention_ps_split_plain}[fn]
        sc = None if self.scales is None else _t(self.scales)
        if fn == "wrapper":
            return call(*args, _t(self.k_win), _t(self.v_win), nc, wl, li, self.tfmt,
                        self.tfmt, kv_scales=sc, **kw)
        return call(*args, _t(self.k_win), _t(self.v_win), nc, wl, li, self.tfmt, self.tfmt,
                    sc, **kw)

    def port(self, nc, wl, li, fn="wrapper", **kw):
        args = (_t(self.q), torch.from_numpy(self.pool))
        if hasattr(self, "tcodec"):
            call = {"wrapper": tqa.fused_q_decode_attention,
                    "split": tqa.fused_q_decode_attention_split_plain}[fn]
            return call(*args, _t(self.scales), _t(self.k_win), _t(self.v_win), nc, wl, li,
                        self.tcodec, **kw)
        call = {"wrapper": tska.fused_sparse_decode_attention,
                "split": tska.fused_sparse_decode_attention_split_plain}[fn]
        sc = None if self.scales is None else _t(self.scales)
        if fn == "wrapper":
            return call(*args, _t(self.k_win), _t(self.v_win), nc, wl, li, self.tfmt,
                        self.tfmt, kv_scales=sc, **kw)
        return call(*args, _t(self.k_win), _t(self.v_win), nc, wl, li, self.tfmt, self.tfmt,
                    sc, **kw)


# per-slot cases: (n_chunks, win_len) of slots with no chunk, a full window,
# one window token, an idle slot
SLOTS = ((0, 44), (2, W), (1, 1), (0, 0))


@pytest.mark.parametrize("codec", ["q8q4", "q4q4", "bitmap", "bitmap-q8"])
def test_per_slot_window_probs_match_jax(codec):
    """Kernels 2 and 7: each live slot's window probabilities against the
    JAX per-slot kernel's (interpret mode), from both plain versions;
    zero past each slot's window length, an idle slot all zero; the output
    the same with the option on."""
    dec = _Decode(codec, 4, 40, B=len(SLOTS), Hkv=1)
    nc, wl = ([s[i] for s in SLOTS] for i in (0, 1))
    before = (tqa.fused_q_decode_attention_ps.launches,
              tska.fused_sparse_decode_attention_ps.launches)
    want = dec.jax_ps(nc, wl, 1)                                      # [B, Hkv, W]
    out, got = dec.port_ps(nc, wl, 1, return_win_probs=True)
    split_out, split = dec.port_ps(nc, wl, 1, fn="split", win_probs=True)
    assert got.dtype == split.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(out, dec.port_ps(nc, wl, 1))                   # the option adds only
    assert torch.equal(split_out, dec.port_ps(nc, wl, 1, fn="split"))
    for b, (n, w) in enumerate(SLOTS):
        for p in (got, split):
            np.testing.assert_allclose(p.numpy()[b, :, :w], want[b, :, :w], rtol=0,
                                       atol=PROBS_TOL, err_msg=f"{codec} slot {b}")
            assert (p.numpy()[b, :, w:] == 0).all()
    assert (out[3] == 0).all() and (got[3] == 0).all() and (split[3] == 0).all()
    assert (got.numpy().sum(-1) <= 4 + 1e-4).all()
    assert before == (tqa.fused_q_decode_attention_ps.launches,
                      tska.fused_sparse_decode_attention_ps.launches)   # CPU: no launch


@pytest.mark.parametrize("codec", ["q8q4", "bitmap"])
def test_uniform_norm_matches_jax(codec):
    """Kernels 1 and 6's final (m, l): both plain versions against the JAX
    kernels' (interpret mode); the output the same with the option on, and
    the probabilities beside the stats the option's alone."""
    dec = _Decode(codec, 4, 50)
    for nc, wl, li in ((0, 44, 1), (2, 200, 0), (3, W, 1)):
        jm, jl = dec.jax_norm(nc, wl, li)                             # [B, Hkv, G, 1]
        out, m, l = dec.port(nc, wl, li, return_norm=True)
        assert torch.equal(out, dec.port(nc, wl, li))
        _, sm, sl = dec.port(nc, wl, li, fn="split", norm=True)
        for tm, tl in ((m, l), (sm, sl)):
            assert tm.shape == tl.shape == jm.shape == (2, 2, 4, 1)
            np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-6, atol=0)
            np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-5, atol=0)
        _, m2, l2, probs = dec.port(nc, wl, li, return_norm=True, return_win_probs=True)
        assert torch.equal(m2, m) and torch.equal(l2, l)
        assert torch.equal(probs, dec.port(nc, wl, li, return_win_probs=True)[1])


@pytest.mark.parametrize("codec,G", [(c, 4) for c in CODECS] + [("q8q4", 1), ("bitmap", 1)])
def test_window_probs_match_jax(codec, G):
    dec = _Decode(codec, G, 30 + G)
    before = (tqa.fused_q_decode_attention.launches,
              tska.fused_sparse_decode_attention.launches)
    for nc, wl, li in ((0, 44, 1), (1, 200, 0), (3, W, 1), (2, 1, 0)):
        want = dec.jax(nc, wl, li)                                  # [B, Hkv, W]
        out, got = dec.port(nc, wl, li, return_win_probs=True)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy()[..., :wl], want[..., :wl], rtol=0,
                                   atol=PROBS_TOL, err_msg=f"{codec} nc={nc} wl={wl}")
        assert (got.numpy()[..., wl:] == 0).all()
        assert torch.equal(out, dec.port(nc, wl, li))               # the option adds only
        split_out, split = dec.port(nc, wl, li, fn="split", win_probs=True)
        np.testing.assert_allclose(split.numpy()[..., :wl], want[..., :wl], rtol=0,
                                   atol=PROBS_TOL)
        assert (split.numpy()[..., wl:] == 0).all()
        # each kv head's probabilities over the window sum to at most G
        assert (got.numpy().sum(-1) <= G + 1e-4).all()
    # nothing to attend: zeros (the TPU kernel leaves its scratch undefined there)
    out, got = dec.port(0, 0, 0, return_win_probs=True)
    assert (out == 0).all() and (got == 0).all()
    assert before == (tqa.fused_q_decode_attention.launches,
                      tska.fused_sparse_decode_attention.launches)   # CPU: no launch


def test_options_still_out_are_refused():
    """What ROADMAP item 12 held back now runs: kernels 1 and 6's (m, l),
    kernels 2 and 7's window probabilities, and Opa in the compressed
    cache's per-slot decode, ``compact_slots`` and ``segment_attend``; the
    sliding window (item 14) runs with the options in every decode kernel.
    The channel policies and ThinK stay refused in the compressed cache, as
    in JAX."""
    dec = _Decode("q8q4", 4, 1)
    bdec = _Decode("bitmap", 4, 2)
    for d in (dec, bdec):
        out, m, l = d.port(1, 10, 0, return_norm=True)
        assert torch.equal(out, d.port(1, 10, 0)) and (l >= 1).all()
        out, probs = d.port_ps([1, 0], [10, 3], 0, return_win_probs=True)
        assert torch.equal(out, d.port_ps([1, 0], [10, 3], 0))
        assert (probs[0, :, 10:] == 0).all() and (probs[1, :, 3:] == 0).all()
        # the uniform and per-slot kernels serve the sliding window with the
        # window probabilities
        out, probs = d.port(1, 10, 0, window=100, return_win_probs=True)
        assert torch.isfinite(out).all() and (probs[..., 10:] == 0).all()
        assert not torch.equal(out, d.port(1, 10, 0))
        out, probs = d.port_ps([1, 0], [10, 3], 0, window=100, return_win_probs=True)
        assert torch.isfinite(out).all() and (probs[0, :, 10:] == 0).all()
        assert (probs[1, :, 3:] == 0).all() and (probs[:, :, :3] > 0).all()
        assert not torch.equal(out[0], d.port_ps([1, 0], [10, 3], 0)[0])
        assert torch.equal(out, d.port_ps([1, 0], [10, 3], 0, window=100))
    rs = np.random.RandomState(3)
    for codec in ("q8q4", "bitmap"):
        teng = dataclasses.replace(_engine(tc, "KT_MAG_VT_OPA", codec), batch_size=2)
        impl = TCompressed(teng, device="cpu")
        st = impl.init(2, torch.float32)
        seg = [torch.from_numpy(rs.randn(2, 256, h, 128).astype(np.float32))
               for h in (4, 1, 1)]
        impl.segment_attend(st, 0, *seg, 0, 256)             # a full segment: 256 scored
        impl.finalize_segment(st, 0, 256)
        assert (st["v_score"][0, :, :, :256] > 0).all() and (st["v_score"][0, :, :, 256:] == 0).all()
        q = torch.from_numpy(rs.randn(2, 1, 4, 128).astype(np.float32))
        kv = torch.from_numpy(rs.randn(2, 1, 1, 128).astype(np.float32))
        before = st["v_score"].clone()
        impl.decode_attend(st, 0, q, kv, kv, torch.tensor([256, -1]))   # slot 1 idle
        assert (st["v_score"][0, 0, :, :257] > before[0, 0, :, :257]).any()
        assert torch.equal(st["v_score"][:, 1], before[:, 1])
        before = st["v_score"].clone()
        impl.compact_slots(st, [True, False])
        assert torch.equal(st["v_score"][0, 0, :, :W - 256], before[0, 0, :, 256:W])
        assert (st["v_score"][0, 0, :, W - 256:] == 0).all()
        assert torch.equal(st["v_score"][:, 1], before[:, 1])
    # the channel policies and ThinK stay in the masked cache, as in JAX
    with pytest.raises(ValueError):
        TCompressed(_engine(tc, "KT_MAG_VC_OPA", "q8q4"), device="cpu")


@pytest.mark.parametrize("scored", [(False, True), (True, False), (True, True)])
def test_pack_kv_with_one_score(scored):
    rs = np.random.RandomState(4)
    k, v = (_t(rs.randn(3, 2, 2, 256, 128)) for _ in range(2))
    sk, sv = (torch.from_numpy(rs.rand(3, 2, 2, 256, 128).astype(np.float32)) if on else None
              for on in scored)
    (kr, ks), (vr, vs) = pk.prune_quant_pack_kv(k, v, 40, 14, 8, 4, k_score=sk, v_score=sv)
    for got, x, keep, bits, sc in (((kr, ks), k, 40, 8, sk), ((vr, vs), v, 14, 4, sv)):
        want = pk.prune_quant_pack_plain(x, keep, bits, sc)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if sv is not None:       # the score ranks: not the magnitude's keep
        assert not torch.equal(vr, pk.prune_quant_pack_plain(v, 14, 4)[0])


def test_pack_grid_reads_every_operands_score(monkeypatch):
    """A K+V launch whose V alone has a score (KT_MAG_VT_OPA) takes the
    score instance's grid: at most MAX_SCORE_TOKENS rows a CTA."""
    seen = []
    monkeypatch.setattr(pk, "_grid", lambda index, n_hc, C, score: (
        seen.append(score) or pk.pack_grid(n_hc, C, score)))
    monkeypatch.setattr(pk.qa, "_stream", lambda t: 0)

    class _Lib:
        prune_quant_pack_ops = staticmethod(lambda *a: 0)

    _Lib.prune_quant_pack_ops.argtypes = None
    monkeypatch.setattr(pk.build, "load", lambda name: _Lib)
    x = _t(np.zeros((2, 512, 128)))
    rows = torch.zeros((2, 256, 128), dtype=torch.int16)
    sc = torch.zeros((2, 128), dtype=torch.bfloat16)
    score = torch.zeros((2, 512, 128))
    pk._launch([(x, 40, 8, None, rows, sc), (x, 40, 4, score, rows[:, :128], sc)])
    pk._launch([(x, 40, 8, score, rows, sc), (x, 40, 4, None, rows[:, :128], sc)])
    pk._launch([(x, 40, 8, None, rows, sc), (x, 40, 4, None, rows[:, :128], sc)])
    assert seen == [True, True, False]
    cluster, _ = pk.pack_grid(4, 512, True)
    assert 512 // cluster <= pk.MAX_SCORE_TOKENS


@pytest.mark.parametrize("qbits", [16, 8])
def test_stream_encode_by_score_matches_jax(qbits):
    """The bitmap streams keep the top scores, ties to the lower channel, as
    JAX's do (an adversarial score: the smallest |x| rank first)."""
    rs = np.random.RandomState(5)
    x = _bf(rs.randn(2, 256, 128))
    score = (1.0 / (np.abs(x) + 1e-3)).astype(np.float32)
    score[:, :, 9] = score[:, :, 3]                               # ties
    jf, tf = (m.ChunkFormat(256, 128, 40, qbits=qbits) for m in (jsf, tsf))
    if qbits == 16:
        want = jax.jit(lambda a, s: jsf.prune_and_encode_stream(a, jf, s))(
            jnp.asarray(x, jnp.bfloat16), score)
        got = tsf.prune_and_encode_stream(_t(x), tf, torch.from_numpy(score))
    else:
        want, wsc = jax.jit(lambda a, s: jsf.prune_and_encode_stream_q8(a, jf, s))(
            jnp.asarray(x, jnp.bfloat16), score)
        got, gsc = tsf.prune_and_encode_stream_q8(_t(x), tf, torch.from_numpy(score))
        np.testing.assert_array_equal(gsc.numpy(), np.asarray(wsc))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), tsf.prune_and_encode_stream(
        _t(x), tsf.ChunkFormat(256, 128, 40)).numpy() if qbits == 16 else
        tsf.prune_and_encode_stream_q8(_t(x), tf)[0].numpy())
