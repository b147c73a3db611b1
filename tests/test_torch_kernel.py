"""Port parity, the q8q4 decode kernel module.

(d) The plain version of ``fused_q_decode_attention`` against the JAX
    kernel run in Pallas interpret mode, on the same stacked int16 pools,
    bf16 scales and windows.
(j) The module imports and runs on the CPU with no ``nvcc``; the wrapper
    refuses what the CUDA kernel cannot serve instead of falling back.
The CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against the plain version there.
"""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mustafar_tpu.ops import quant_format as jqf
from mustafar_tpu.ops import sparse_format as jsf
from mustafar_tpu.ops.kernels import quant_attention as jqa
from mustafar_tpu_torch.ops import quant_format as tqf
from mustafar_tpu_torch.ops.kernels import build
from mustafar_tpu_torch.ops.kernels import quant_attention as tqa

torch.set_num_threads(2)

JCODEC = jqf.QuantCodec(256, 128, 8, 4)
TCODEC = tqf.QuantCodec(256, 128, 8, 4)
W = 288                                   # residual 32 + chunk 256


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16)).astype(np.float32)


def _inputs(seed, L, mc, B, Hkv, G):
    """Stacked q8q4 state from real packed chunks (random bf16 K/V pruned to
    keep 40 of 128, then encoded), plus windows and q."""
    rs = np.random.RandomState(seed)
    BH = B * Hkv
    pool = np.zeros((L, mc, BH, 192, 128), np.int16)
    scales = np.zeros((L, mc, BH, 2, 128), np.float32)
    for li in range(L):
        for ci in range(mc):
            rows, scs = [], []
            for kind in ("k", "v"):
                x = jnp.asarray(rs.randn(BH, 256, 128) * 0.5, jnp.bfloat16)
                x = jnp.where(jsf.topk_mask(x, 40), x, 0).astype(jnp.bfloat16)
                r, s = jqf.encode_chunk(x, JCODEC, kind)
                rows.append(np.asarray(r))
                scs.append(np.asarray(s).astype(np.float32))
            pool[li, ci] = np.concatenate(rows, axis=1)
            scales[li, ci] = np.stack(scs, axis=1)
    k_win = _bf16(rs.randn(L, BH, W, 128))
    v_win = _bf16(rs.randn(L, BH, W, 128))
    q = _bf16(rs.randn(B, 1, Hkv * G, 128))
    return q, pool, scales, k_win, v_win


def _run_both(q, pool, scales, k_win, v_win, nc, wl, li):
    mc = pool.shape[1]
    jo = jqa.fused_q_decode_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(pool),
        jnp.asarray(scales[..., 0, :], jnp.bfloat16),
        jnp.asarray(scales[..., 1, :], jnp.bfloat16),
        jnp.asarray(k_win, jnp.bfloat16), jnp.asarray(v_win, jnp.bfloat16),
        jnp.int32(nc), jnp.int32(wl), JCODEC, mc, li=jnp.int32(li))
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    before = tqa.fused_q_decode_attention.launches
    to = tqa.fused_q_decode_attention(bf(q), torch.from_numpy(pool), bf(scales),
                                      bf(k_win), bf(v_win), nc, wl, li, TCODEC)
    assert tqa.fused_q_decode_attention.launches == before   # CPU: no launch
    return np.asarray(jo).astype(np.float32), to.float().numpy()


@pytest.mark.parametrize("G", [1, 4])
def test_plain_matches_jax_kernel(G):
    """Cases: n_chunks 0, 1 and mc; window lengths 0 (with chunks), 1, 44,
    200 and the full 288; layer 0 and the last of L = 2."""
    q, pool, scales, k_win, v_win = _inputs(10 + G, 2, 3, 2, 2, G)
    cases = [(0, 1, 0), (0, 44, 1), (1, 44, 0), (1, 0, 1), (3, 288, 1), (3, 200, 0),
             (1, 288, 0)]
    for nc, wl, li in cases:
        jo, to = _run_both(q, pool, scales, k_win, v_win, nc, wl, li)
        # same arithmetic and the same softmax steps; the f32 sums run in
        # another order, which can move a bf16(p) or the bf16 output by one
        # ulp: 2^-8 of the output's magnitude
        np.testing.assert_allclose(to, jo, rtol=0, atol=2 ** -8 * np.abs(jo).max(),
                                   err_msg=f"nc={nc} wl={wl} li={li}")
    jo, to = _run_both(q, pool, scales, k_win, v_win, 0, 0, 0)
    assert (to == 0).all() and (jo == 0).all()               # nothing to attend


def test_plain_output_dtype_follows_q():
    q, pool, scales, k_win, v_win = _inputs(3, 1, 2, 1, 2, 4)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    args = (torch.from_numpy(pool), bf(scales), bf(k_win), bf(v_win), 2, 100, 0, TCODEC)
    o32 = tqa.fused_q_decode_attention(torch.from_numpy(q), *args)
    o16 = tqa.fused_q_decode_attention(bf(q), *args)
    assert o32.dtype == torch.float32 and o16.dtype == torch.bfloat16
    np.testing.assert_array_equal(o16.float().numpy(), o32.to(torch.bfloat16).float().numpy())


def test_window_tile_is_the_tpu_rule():
    from mustafar_tpu.ops.kernels.sparse_attention import _window_tile
    for w in (160, 288, 544, 100, 8):
        assert tqa.window_tile(w) == _window_tile(w, 96)


def test_wrapper_refuses_what_the_kernel_cannot_serve():
    q, pool, scales, k_win, v_win = _inputs(4, 1, 2, 1, 2, 4)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    ok = dict(q=bf(q), kv_pool=torch.from_numpy(pool), kv_scales=bf(scales),
              k_win=bf(k_win), v_win=bf(v_win), n_chunks=1, win_len=10, li=0,
              codec=TCODEC)
    tqa.fused_q_decode_attention(**ok)
    bad = [
        dict(codec=tqf.QuantCodec(256, 128, 8, 8)),          # q8: later slice
        dict(k_win=bf(k_win).float()),                       # f32 window
        dict(kv_pool=torch.from_numpy(pool).to(torch.int32)),
        dict(k_win=bf(k_win).transpose(2, 3).contiguous().transpose(2, 3)),
        dict(n_chunks=3), dict(win_len=W + 1), dict(li=1), dict(n_chunks=1.0),
        dict(q=bf(np.zeros((1, 1, 6, 128), np.float32))),    # G = 3
    ]
    for change in bad:
        with pytest.raises((ValueError, TypeError, NotImplementedError)):
            tqa.fused_q_decode_attention(**dict(ok, **change))
    for opt in (dict(window=512), dict(return_norm=True), dict(return_win_probs=True)):
        with pytest.raises(NotImplementedError):
            tqa.fused_q_decode_attention(**ok, **opt)
    # a device the kernel does not run on is refused, never computed on the CPU
    meta = {k: (v.to("meta") if torch.is_tensor(v) else v) for k, v in ok.items()}
    with pytest.raises(ValueError):
        tqa.fused_q_decode_attention(**meta)


def test_module_imports_and_builds_nothing_without_nvcc(tmp_path):
    """Importing the kernel module needs no nvcc and builds nothing; asking
    for the library where there is no nvcc raises (no fallback)."""
    code = (
        "import mustafar_tpu_torch.ops.kernels.quant_attention as qa\n"
        "from mustafar_tpu_torch.ops.kernels import build\n"
        "assert build._LIBS == {}\n"
        "try:\n"
        "    build.load('q_decode')\n"
        "except RuntimeError as e:\n"
        "    assert 'nvcc' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('built without nvcc')\n")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    build_dir_before = build.BUILD_DIR.exists()
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=os.getcwd(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    if not build_dir_before:
        assert not build.BUILD_DIR.exists() or not any(build.BUILD_DIR.iterdir())
