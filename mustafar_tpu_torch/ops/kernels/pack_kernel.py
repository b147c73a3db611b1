"""Fused prune + quantize + pack for the quant codecs: the CUDA kernel, its
plain PyTorch version and the wrappers that pick between them by device.

Port of ``mustafar_tpu/ops/kernels/pack_kernel.py`` ``prune_quant_pack``
(Pallas body ``_prune_quant_pack_kernel``), kernel
``csrc/prune_quant_pack.cu``.  Per head-chunk x [C, 128] (bf16):
  1. keep exactly ``keep`` entries per token row, the largest |x| (or the
     largest ``score``), ties to the lower channel (``sparse_format``'s
     sort-free bisection on the integer magnitude key);
  2. per channel over the chunk's C tokens: scale = max(amax * f32(1/qmax),
     1e-8) in f32, stored as bf16;
  3. codes = clamp(round_half_even(x / scale), +-qmax), packed ``16/bits``
     token blocks to an int16 row (``quant_format.pack_codes``).
The plain version is the cache's chain (``sparse_format.topk_mask`` then
``quant_format.encode_chunk``), which the JAX package's kernel says it is
bit-exact with; kernel and plain version are held bit-equal on the card.

Two wrappers launch the one kernel: ``prune_quant_pack`` packs one tensor,
``prune_quant_pack_kv`` the cache's K and V (each with its own keep, bits
and, for the Opa policies, score: one of the two may rank by score and the
other by |x|) in one launch.  Layouts: x [.., C, 128] bf16 with one to three
leading axes (job, batch, head; the job is the prompt's chunk in prefill
and the layer in a compaction), any strides that keep the channel axis
contiguous, 16-byte aligned with strides in multiples of 8 elements (the
cache hands it windows and prompt slices where they lie); rows
[.., C*bits/16, 128] int16 (aligned likewise) and scales [.., 128] bf16,
which the caller may pass as views to write into (the pool slots and the
scales' K or V column), with the channel axis contiguous.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mustafar_tpu_torch.ops import quant_format as qf
from mustafar_tpu_torch.ops import sparse_format as sf
from mustafar_tpu_torch.ops.kernels import build
from mustafar_tpu_torch.ops.kernels import quant_attention as qa

D = 128
MAX_CHUNK = 512        # tokens of a head-chunk (C a multiple of CHUNK_MULTIPLE up to it)
CHUNK_MULTIPLE = 128
MAX_CLUSTER = 16       # CTAs of a head-chunk's cluster (non-portable above 8)
MIN_CTA_TOKENS = 16    # a CTA's token rows at the least: four warps of four rows
MAX_SCORE_TOKENS = 256  # a CTA's token rows with a score (their f32 keys staged too)
MAX_WARPS = 16
ROWS_A_WARP = 4


def _threads(C: int, cluster: int) -> int:
    return 32 * min(MAX_WARPS, C // cluster // ROWS_A_WARP)


def pack_grid(n_hc: int, C: int, score: bool = False, sms: int = 132,
              capacity=None) -> tuple[int, int]:
    """(cluster, threads) of one launch over ``n_hc`` head-chunks of C
    tokens (every operand's): each head-chunk is one thread block cluster of
    ``cluster`` CTAs, each CTA owning C / cluster token rows (and C*bits/16
    / cluster carrier rows) with ``threads`` threads, a warp to four rows
    (up to 16 warps).  The cluster is the smallest power of two that gives
    the launch at least one CTA an SM, within [1, 16], leaving a CTA at
    least 16 token rows (at most 256 with a score, whose keys take 512
    bytes a row of shared memory); then halved while the launch's clusters
    would not all be resident at once, where ``capacity(cluster, threads)``
    says how many the card holds (a cluster's CTAs must share a GPC: the
    H100 holds 62 clusters of four 512-thread CTAs, not 66)."""
    lo = _cluster_floor(C, score)
    hi = min(MAX_CLUSTER, C // MIN_CTA_TOKENS)
    cluster = lo
    while cluster < hi and n_hc * cluster < sms:
        cluster *= 2
    while capacity is not None and cluster > lo and \
            n_hc > capacity(cluster, _threads(C, cluster)):
        cluster //= 2
    return cluster, _threads(C, cluster)


def _cluster_floor(C: int, score: bool) -> int:
    lo = 1
    while score and C // lo > MAX_SCORE_TOKENS:
        lo *= 2
    return lo


def prune_quant_pack_plain(x, keep: int, bits: int, score=None, rows_out=None,
                           scales_out=None):
    """``topk_mask`` then ``encode_chunk`` on x (shapes and outputs as
    ``prune_quant_pack``)."""
    lead, C = x.shape[:-2], x.shape[-2]
    xb = x.to(torch.bfloat16).reshape(-1, C, D)
    sel = xb if score is None else score.reshape(-1, C, D)
    pruned = torch.where(sf.topk_mask(sel, keep), xb, torch.zeros_like(xb))
    rows, scales = qf.encode_chunk(pruned, qf.QuantCodec(C, D, bits, bits), "k")
    rows, scales = rows.reshape(*lead, -1, D), scales.reshape(*lead, D)
    if rows_out is not None:
        rows_out.copy_(rows)
        scales_out.copy_(scales)
        return rows_out, scales_out
    return rows, scales


def _check(x, keep, bits, score, rows_out, scales_out):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    if not 3 <= x.dim() <= 5 or x.shape[-1] != D:
        raise ValueError(f"x must be [.., C, 128] with 1-3 leading axes, got "
                         f"{tuple(x.shape)}")
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits!r}")
    C = x.shape[-2]
    if C < 1 or C % CHUNK_MULTIPLE or C > MAX_CHUNK:
        raise ValueError(f"a chunk of {C} tokens: the kernel takes a multiple of "
                         f"{CHUNK_MULTIPLE} up to {MAX_CHUNK}")
    if not isinstance(keep, int) or keep < 1:
        raise ValueError(f"keep must be an int >= 1, got {keep!r}")
    if x.stride(-1) != 1:
        raise ValueError("x's channel axis must be contiguous")
    if score is not None:
        if score.dtype != torch.float32 or score.shape != x.shape:
            raise ValueError(f"score must be float32 {tuple(x.shape)}, got "
                             f"{score.dtype} {tuple(score.shape)}")
        if not score.is_contiguous():
            raise ValueError("score must be contiguous")
        if score.device != x.device:
            raise ValueError(f"score is on {score.device}, x on {x.device}")
    if (rows_out is None) != (scales_out is None):
        raise ValueError("pass both rows_out and scales_out, or neither")
    if rows_out is not None:
        lead = tuple(x.shape[:-2])
        R = C * bits // 16
        for name, t, shape, dt in (("rows_out", rows_out, (*lead, R, D), torch.int16),
                                   ("scales_out", scales_out, (*lead, D), torch.bfloat16)):
            if tuple(t.shape) != shape or t.dtype != dt:
                raise ValueError(f"{name} must be {dt} {shape}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
            if t.stride(-1) != 1:
                raise ValueError(f"{name}'s channel axis must be contiguous")
            if t.device != x.device:
                raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _axes(t, lead: int, n: int):
    """Strides of the (job, b, h)[3 - lead:] leading axes and the ``n``
    trailing axes of t, padded in front to 3 + n axes; 0 for an axis of one
    entry (whatever its stride, it is only ever taken at 0)."""
    sizes = (1,) * (3 - lead) + tuple(t.shape)
    strides = (0,) * (3 - lead) + tuple(t.stride())
    return [s if d > 1 else 0 for d, s in zip(sizes, strides)][:3 + n]


def _check_layout(x, score, rows_out):
    """What the kernel's 16-byte copies and stores need, on any device: x
    and the rows 16-byte aligned with strides in multiples of 8 elements
    (the channel axis aside), a score 16-byte aligned."""
    for name, t in (("x", x), ("rows_out", rows_out)):
        if t is None:
            continue
        if t.data_ptr() % 16 or any(s % 8 for s in _axes(t, t.dim() - 2, 1)):
            raise ValueError(f"{name} must be 16-byte aligned with strides in multiples "
                             f"of 8 elements, got strides {tuple(t.stride())}")
    if score is not None and score.data_ptr() % 16:
        raise ValueError("score must be 16-byte aligned")


class _Op(ctypes.Structure):
    """One operand of ``prune_quant_pack_ops`` (``Op`` in the source)."""
    _fields_ = [("x", ctypes.c_void_p), ("score", ctypes.c_void_p),
                ("rows", ctypes.c_void_p), ("scales", ctypes.c_void_p),
                ("xs", ctypes.c_longlong * 4), ("rs", ctypes.c_longlong * 4),
                ("ss", ctypes.c_longlong * 3), ("keep", ctypes.c_int),
                ("bits", ctypes.c_int), ("inv_qmax", ctypes.c_float),
                ("pad", ctypes.c_int)]


@functools.cache
def _inv_qmax(bits: int) -> float:
    return qf.recip_f32(float(2 ** (bits - 1) - 1))


@functools.cache
def _grid(index: int, n_hc: int, C: int, score: bool) -> tuple[int, int]:
    """``pack_grid`` on card ``index`` (its SMs and cluster capacity)."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return pack_grid(n_hc, C, score, sms, lambda s, t: max_clusters(index, C, s, t, score))


@functools.cache
def max_clusters(index: int, C: int, cluster: int, threads: int, score: bool) -> int:
    """How many clusters of ``cluster`` CTAs of ``threads`` threads at C
    tokens the card ``index`` holds at once (cudaOccupancyMaxActiveClusters)."""
    fn = build.load("prune_quant_pack").prune_quant_pack_max_clusters
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5
        fn.restype = ctypes.c_int
    n = ctypes.c_int(-1)
    rc = fn(ctypes.byref(n), index, C, cluster, threads, int(score))
    if rc != 0:
        raise RuntimeError(f"prune_quant_pack_max_clusters failed: CUDA error {rc}")
    return n.value


def _launch(ops):
    """One launch of the kernel over ``ops``: (x, keep, bits, score, rows,
    scales) each, x of one shape, on the current stream of x's device, at
    ``pack_grid``'s (cluster, threads)."""
    x = ops[0][0]
    stream = qa._stream(x)
    lead = x.dim() - 2
    J, B, H = (1,) * (3 - lead) + tuple(x.shape[:-2])
    C = x.shape[-2]
    # a score on any operand takes the score instance: at most
    # MAX_SCORE_TOKENS rows a CTA, every operand's
    index, score = x.device.index or 0, any(op[3] is not None for op in ops)
    cluster, threads = _grid(index, len(ops) * J * B * H, C, score)
    arr = (_Op * len(ops))()
    for op, (xi, keep, bits, score, rows, scales) in zip(arr, ops):
        op.x, op.rows, op.scales = xi.data_ptr(), rows.data_ptr(), scales.data_ptr()
        op.score = None if score is None else score.data_ptr()
        op.xs[:] = _axes(xi, lead, 1)
        op.rs[:] = _axes(rows, lead, 1)
        op.ss[:] = _axes(scales, lead, 0)
        op.keep, op.bits = keep, bits
        op.inv_qmax = _inv_qmax(bits)
    fn = build.load("prune_quant_pack").prune_quant_pack_ops
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    rc = fn(ctypes.addressof(arr), len(ops), index, J, B, H, C, cluster, threads, stream)
    if rc != 0:
        raise RuntimeError(f"prune_quant_pack launch failed: CUDA error {rc}")


def _outputs(x, bits, rows_out, scales_out):
    if rows_out is not None:
        return rows_out, scales_out
    lead = tuple(x.shape[:-2])
    return (torch.empty((*lead, x.shape[-2] * bits // 16, D), dtype=torch.int16,
                        device=x.device),
            torch.empty((*lead, D), dtype=torch.bfloat16, device=x.device))


def prune_quant_pack(x, keep: int, bits: int, score=None, *, rows_out=None,
                     scales_out=None):
    """Prune x [.., C, 128] to ``keep`` entries per token, quantize per
    channel to ``bits`` (8 or 4) and pack -> (rows [.., C*bits/16, 128]
    int16, scales [.., 128] bf16), written into ``rows_out`` /
    ``scales_out`` when given (views with a contiguous channel axis).
    ``score`` (float32, x's shape, contiguous) ranks the entries in place of
    |x|.

    CUDA tensors launch the kernel of ``csrc/prune_quant_pack.cu`` (built
    at first use) on the current stream, reading x and writing the outputs
    through their strides (no copy), as thread block clusters
    (``pack_grid``); CPU tensors run
    the plain version.  A request the kernel cannot serve raises on
    either device; nothing falls back."""
    _check(x, keep, bits, score, rows_out, scales_out)
    _check_layout(x, score, rows_out)
    if x.device.type == "cpu":
        return prune_quant_pack_plain(x, keep, bits, score, rows_out, scales_out)
    rows_out, scales_out = _outputs(x, bits, rows_out, scales_out)
    _launch([(x, keep, bits, score, rows_out, scales_out)])
    prune_quant_pack.launches += 1
    return rows_out, scales_out


prune_quant_pack.launches = 0


def prune_quant_pack_kv(k, v, k_keep: int, v_keep: int, k_bits: int, v_bits: int, *,
                        k_out=None, v_out=None, k_score=None, v_score=None):
    """``prune_quant_pack`` of K and V, each with its own keep and bits, in
    one launch: k and v [.., C, 128] bf16 of one shape (1-3 leading axes)
    -> ((k rows, k scales), (v rows, v scales)), written into ``k_out`` /
    ``v_out`` ((rows, scales) views) when given.  ``k_score`` / ``v_score``
    (float32 of x's shape, contiguous) rank that operand's entries in place
    of |x|; either, both or neither may be given.  CUDA tensors launch the
    kernel once for both; CPU tensors run the plain version on each."""
    k_rows, k_scales = k_out if k_out is not None else (None, None)
    v_rows, v_scales = v_out if v_out is not None else (None, None)
    _check(k, k_keep, k_bits, k_score, k_rows, k_scales)
    _check(v, v_keep, v_bits, v_score, v_rows, v_scales)
    if k.shape != v.shape or k.device != v.device:
        raise ValueError(f"K and V must share a shape and device, got "
                         f"{tuple(k.shape)} on {k.device} and {tuple(v.shape)} on "
                         f"{v.device}")
    _check_layout(k, k_score, k_rows)
    _check_layout(v, v_score, v_rows)
    if k.device.type == "cpu":
        return (prune_quant_pack_plain(k, k_keep, k_bits, k_score, k_rows, k_scales),
                prune_quant_pack_plain(v, v_keep, v_bits, v_score, v_rows, v_scales))
    k_rows, k_scales = _outputs(k, k_bits, k_rows, k_scales)
    v_rows, v_scales = _outputs(v, v_bits, v_rows, v_scales)
    _launch([(k, k_keep, k_bits, k_score, k_rows, k_scales),
             (v, v_keep, v_bits, v_score, v_rows, v_scales)])
    prune_quant_pack_kv.launches += 1
    return (k_rows, k_scales), (v_rows, v_scales)


prune_quant_pack_kv.launches = 0
