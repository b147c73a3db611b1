"""Chip smoke run of the PyTorch / H100 port (``mustafar_tpu_torch``).

    python3 chip_smoke.py            # from the root of a checkout, one CUDA card

Phases, each printing one flushed JSON line with its ``phase`` and
``elapsed_s``:
  env           torch / CUDA versions, the card's name and power limit
  build         nvcc builds the five kernel libraries at once (csrc/q_decode.cu,
                csrc/q_decode_ps.cu, csrc/q_segment.cu, csrc/sp_decode.cu: the
                bitmap uniform and per-slot entries, csrc/sp_segment.cu)
  kernel        the uniform decode kernel against its plain PyTorch version on
                the card, at the flagship per-layer shapes (B=8, Hq=32, Hkv=8,
                mc=5), with its time beside the plain version's and its bound
  kernel_ps     the per-slot decode kernel likewise, at the engine's pool
                (mc=32): mixed slots (n_chunks 0/1/2/5/31, win_len
                0/1/44/288, an idle slot), groups 1/2/4/8
  kernel_seg    the segment kernel likewise: Tseg=256, G=4, B = 1 and 2,
                n_chunks 0/1/4/31; timed at 31 chunks
  kernel_sp, kernel_sp_ps, kernel_sp_seg
                the bitmap codec's three kernels likewise, at the shapes of
                the three phases above, over real packed chunks (random bf16
                K and V pruned and encoded on the card) at sparsity 0.7, and
                0.5 (zero pads in the rows)
  reference     a tiny f32 model decoded on the card (kernel) and on the CPU
                (plain path) with the same token stream: logits must agree
  reference_cb  the tiny f32 continuous-batching engine (chunked, interleaved
                admission, a slot retired and reused) likewise
  reference_bitmap
                the two reference runs above with the bitmap codec
  serve_q8q4    full-width, 32-layer Llama-3-8B with random W8 weights made
                on the card: Generator.generate, B=8, prompt 300, 300 new
                tokens, q8q4 compressed cache (one compaction on the way);
                every decode step must launch the kernel once per layer
  serve_dense   the same prompts through the dense baseline cache
  serve_bitmap  serve_q8q4 with the bitmap codec (the JAX package's default):
                bitmap decode kernel launches = 32 x 299; first tokens =
                serve_dense's
  decode_split  device time of a decode step's W8 projections, LM head and
                attention kernel, each timed alone, beside the step's wall time
  serve_cb      the continuous-batching engine at full width: 8 slots, 17
                requests (one of 8,000 prompt tokens), chunked interleaved
                admission; per-slot and segment kernel launches = 32 x decode
                steps and 32 x segments; first tokens = a batch-1 chunked
                Generator's
  serve_cb_bitmap
                serve_cb with the bitmap codec
  serve_chunked Generator with chunked prefill at full width, B=4, 2,000 + 64
  host_split    one segment (B=1) and one decode tick (8 slots): host enqueue
                time, wall time, device time and kernels launched
Then the card's ``nvidia-smi`` line, one ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
nothing is caught.  With no CUDA card, or run from a directory that holds
this file and not the port, it exits non-zero before printing a result.
"""

import faulthandler
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()
BUDGET_S = 1100            # the run is cut, with a traceback, past this
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12     # f32 outside the tensor cores (the decode kernels' math)
H100_BF16_FLOPS = 989e12   # bf16 tensor cores, dense (the segment kernel's math)
KERNEL_TOL_ULPS = 2        # bf16 ulps of the output's scale
NO_LIBRARY = "no single PyTorch call computes this function"   # library_ms null


def emit(phase, **fields):
    print(json.dumps({"phase": phase, "elapsed_s": round(time.perf_counter() - T0, 3),
                      **fields}), flush=True)


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


SPIN_CYCLES = 4_000_000   # ~2 ms of the card's clock: longer than a wrapper's host work


def cuda_ms(fn, reps, flush=None, spin=True):
    """Mean ms of ``fn`` over ``reps`` calls between CUDA events, and how
    many of them the card waited on the host for.  Before each call
    ``flush`` runs (if given).  With ``spin`` a spin kernel then holds the
    stream while the host enqueues the start event, ``fn``'s launches and
    the end event, so the events bracket the card's work and not the
    wrapper's host time: a kernel's device time.  A call whose start event
    the card had passed before ``fn`` returned may include host time; the
    second value counts them (expected 0 with ``spin``).  Without ``spin``
    the events also hold the host's enqueue wherever the card waits for it,
    as for a plain version of many small launches: its time as a caller
    sees it."""
    import torch
    total, behind = 0.0, 0
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        behind += bool(start.query())
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps, behind


def host_us(fn, reps):
    """Mean host microseconds a call of ``fn`` takes to return (its
    launches enqueued, not run)."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / reps * 1e6


def phase_env():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    import mustafar_tpu_torch
    pkg = os.path.dirname(os.path.abspath(mustafar_tpu_torch.__file__))
    if os.path.dirname(pkg) != ROOT:
        raise SystemExit(f"chip_smoke: the port must come from this checkout, "
                         f"found {pkg}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), nvidia_smi=smi,
         tf32=False)
    return smi


KERNEL_LIBS = ("q_decode", "q_decode_ps", "q_segment", "sp_decode", "sp_segment")


def phase_build():
    """nvcc builds the five kernel libraries at once, one process each."""
    from concurrent.futures import ThreadPoolExecutor
    from mustafar_tpu_torch.ops.kernels import build
    t = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_LIBS)) as pool:
        list(pool.map(build.load, KERNEL_LIBS))
    ptxas = {name: [ln.strip() for ln in build.BUILD_LOGS.get(name, "").splitlines()
                    if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
             for name in KERNEL_LIBS}
    emit("build", seconds=round(time.perf_counter() - t, 3),
         libraries=[str(build.library_path(n).relative_to(ROOT)) for n in KERNEL_LIBS],
         built_now=[n for n in KERNEL_LIBS if n in build.BUILD_LOGS], ptxas=ptxas)


class _Kit:
    """One codec's kernels over one stacked state, as the kernel phases
    call them: ``decode(q, n_chunks, win_len, li)`` and ``decode_ps``,
    ``segment(q_seg, n_chunks, li)`` and the plain versions beside each;
    ``chunk_bytes`` is what one pool chunk of one kv head holds (rows and,
    for q8q4, scales)."""

    def __init__(self, codec, g, dev, L, mc, BH, W, sparsity=0.7):
        import torch
        from mustafar_tpu_torch.ops import quant_format as qf
        from mustafar_tpu_torch.ops import sparse_format as sf
        from mustafar_tpu_torch.ops.kernels import quant_attention as qa
        from mustafar_tpu_torch.ops.kernels import sparse_attention as ska
        self.codec, self.sparsity = codec, sparsity
        self.k_win = torch.randn((L, BH, W, 128), generator=g, device=dev).to(torch.bfloat16)
        self.v_win = torch.randn((L, BH, W, 128), generator=g, device=dev).to(torch.bfloat16)
        kw, vw = self.k_win, self.v_win
        if codec == "q8q4":
            # every int16 bit pattern is a valid q8q4 code; scales 0.002-0.02
            pool = torch.randint(-32768, 32768, (L, mc, BH, 192, 128), generator=g,
                                 device=dev, dtype=torch.int32).to(torch.int16)
            scales = (0.002 + 0.018 * torch.rand((L, mc, BH, 2, 128), generator=g,
                                                 device=dev)).to(torch.bfloat16)
            qc = qf.QuantCodec(256, 128, 8, 4)
            self.chunk_bytes = 192 * 128 * 2 + 2 * 128 * 2
            self.fns = {"decode": qa.fused_q_decode_attention,
                        "decode_ps": qa.fused_q_decode_attention_ps,
                        "segment": qa.fused_q_segment_attention}
            self.decode = lambda q, nc, wl, li: qa.fused_q_decode_attention(
                q, pool, scales, kw, vw, nc, wl, li, qc)
            self.decode_plain = lambda q, nc, wl, li: qa.fused_q_decode_attention_plain(
                q, pool, scales, kw, vw, nc, wl, li)
            self.decode_ps = lambda q, nc, wl, li: qa.fused_q_decode_attention_ps(
                q, pool, scales, kw, vw, nc, wl, li, qc)
            self.decode_ps_plain = lambda q, nc, wl, li: \
                qa.fused_q_decode_attention_ps_plain(q, pool, scales, kw, vw, nc, wl, li)
            self.segment = lambda q, nc, li: qa.fused_q_segment_attention(
                q, pool, scales, nc, nc * 256, li, qc)
            self.segment_plain = lambda q, nc, li: qa.fused_q_segment_attention_plain(
                q, pool, scales, nc, li)
            return
        # bitmap: real packed chunks, random bf16 K and V pruned to the
        # format's keep and encoded on the card (a stream of random bits
        # would not hold the format's popcounts)
        fmt = sf.ChunkFormat(256, 128, 128 - int(sparsity * 128) + 1)
        pool = torch.empty((L, mc, BH, 2 * fmt.stream_rows, 128), dtype=torch.int16,
                           device=dev)
        for li in range(L):
            x = torch.randn((mc, 2, BH, 256, 128), generator=g, device=dev)
            rows = sf.prune_and_encode_stream(x.to(torch.bfloat16), fmt)
            pool[li] = torch.cat([rows[:, 0], rows[:, 1]], dim=-2)
        self.chunk_bytes = 2 * fmt.stream_rows * 128 * 2
        self.fns = {"decode": ska.fused_sparse_decode_attention,
                    "decode_ps": ska.fused_sparse_decode_attention_ps,
                    "segment": ska.fused_sparse_segment_attention}
        self.decode = lambda q, nc, wl, li: ska.fused_sparse_decode_attention(
            q, pool, kw, vw, nc, wl, li, fmt, fmt)
        self.decode_plain = lambda q, nc, wl, li: ska.fused_sparse_decode_attention_plain(
            q, pool, kw, vw, nc, wl, li, fmt, fmt)
        self.decode_ps = lambda q, nc, wl, li: ska.fused_sparse_decode_attention_ps(
            q, pool, kw, vw, nc, wl, li, fmt, fmt)
        self.decode_ps_plain = lambda q, nc, wl, li: \
            ska.fused_sparse_decode_attention_ps_plain(q, pool, kw, vw, nc, wl, li, fmt, fmt)
        self.segment = lambda q, nc, li: ska.fused_sparse_segment_attention(
            q, pool, nc, nc * 256, li, fmt, fmt)
        self.segment_plain = lambda q, nc, li: ska.fused_sparse_segment_attention_plain(
            q, pool, nc, li, fmt, fmt)


# the kernels line's fixed fields, by codec and kernel
KERNEL_META = {
    ("q8q4", "decode"): ("fused_q_decode_attention", "q_decode.cu",
                         "quant_attention.py:223"),
    ("q8q4", "decode_ps"): ("fused_q_decode_attention_ps", "q_decode_ps.cu",
                            "quant_attention.py:516"),
    ("q8q4", "segment"): ("fused_q_segment_attention", "q_segment.cu",
                          "quant_attention.py:704"),
    ("bitmap", "decode"): ("fused_sparse_decode_attention", "sp_decode.cu",
                           "sparse_attention.py:896"),
    ("bitmap", "decode_ps"): ("fused_sparse_decode_attention_ps", "sp_decode.cu",
                              "sparse_attention.py:417"),
    ("bitmap", "segment"): ("fused_sparse_segment_attention", "sp_segment.cu",
                            "sparse_attention.py:647"),
}


def _entry(codec, kind, results, worst, tol, kernel_ms, plain_ms, bytes_ms, flops_ms):
    name, src, tpu = KERNEL_META[(codec, kind)]
    return {"name": name, "route": "cuda", "source": f"mustafar_tpu_torch/csrc/{src}",
            "replaces": f"mustafar_tpu/ops/kernels/{tpu}", "launches": None,
            "max_abs_err": max(r.get("max_abs_err", 0.0) for r in results),
            "tol": tol, "worst_err_over_tol": worst,
            "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "library_ms": None, "library_note": NO_LIBRARY}


def phase_kernel(codec="q8q4"):
    """Uniform decode kernel vs plain at the flagship per-layer shapes (B=8,
    Hq=32, Hkv=8, L=4, mc=5); returns the kernels-line entry (launches
    filled in by the serve phase).  The bitmap codec is checked at sparsity
    0.7 and 0.5 and timed at 0.7."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    B, Hq, Hkv, L, mc, W, D = 8, 32, 8, 4, 5, 288, 128
    BH = B * Hkv
    kits = [_Kit(codec, g, dev, L, mc, BH, W, sp)
            for sp in ((0.7,) if codec == "q8q4" else (0.7, 0.5))]
    q = torch.randn((B, 1, Hq, D), generator=g, device=dev).to(torch.bfloat16)
    cases = [(0, 1, 0), (0, 44, L - 1), (0, 288, 0), (mc, 288, L - 1), (mc, 1, 0),
             (1, 44, 0), (1, 288, L - 1), (2, 88, 0)]
    # the other query-group sizes the kernel is built for (Llama-3-8B has 4)
    other_groups = [torch.randn((B, 1, Hkv * g_, D), generator=g, device=dev
                                ).to(torch.bfloat16) for g_ in (1, 2, 8)]
    fn = kits[0].fns["decode"]
    launches0 = fn.launches
    results, worst = [], 0.0
    for kit in kits:
        for nc, wl, li in cases:
            qs = (q, q.float(), *other_groups) if (nc, wl) == (1, 288) else (q,)
            for qq in qs:
                got = kit.decode(qq, nc, wl, li)
                torch.cuda.synchronize()
                want = kit.decode_plain(qq, nc, wl, li)
                err = (got.float() - want.float()).abs().max().item()
                scale = want.float().abs().max().item()
                # same arithmetic, sums in another order: a bf16(p) or the bf16
                # output may move by one ulp each
                tol = KERNEL_TOL_ULPS * 2.0 ** -8 * scale
                results.append({"sparsity": kit.sparsity, "n_chunks": nc, "win_len": wl,
                                "li": li, "q_dtype": str(qq.dtype).split(".")[-1],
                                "G": qq.shape[2] // Hkv, "max_abs_err": err, "tol": tol})
                if not (got.isfinite().all() and err <= tol):
                    raise AssertionError(f"kernel disagrees with its plain version: "
                                         f"{results[-1]}")
                worst = max(worst, err / max(tol, 1e-30))

    # time at the main path's largest pre-compaction shape: one pool chunk
    # and a full 288-token window, L2 flushed before each launch
    kit = kits[0]
    nc, wl, li = 1, 288, 0
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    for _ in range(10):
        kit.decode(q, nc, wl, li)
        kit.decode_plain(q, nc, wl, li)
    torch.cuda.synchronize()
    kernel_ms, behind = cuda_ms(lambda: kit.decode(q, nc, wl, li), 100,
                                flush=flush_buf.zero_)
    plain_ms, _ = cuda_ms(lambda: kit.decode_plain(q, nc, wl, li), 20,
                          flush=flush_buf.zero_, spin=False)
    hot_ms, _ = cuda_ms(lambda: kit.decode(q, nc, wl, li), 100)
    full_ms, _ = cuda_ms(lambda: kit.decode(q, mc, 288, li), 100, flush=flush_buf.zero_)
    wrapper_us = host_us(lambda: kit.decode(q, nc, wl, li), 100)
    G = Hq // Hkv
    nbytes = (BH * (nc * kit.chunk_bytes + 2 * wl * 128 * 2)   # pools, windows
              + 2 * B * Hq * D * 2)                          # q in, out
    flops = BH * G * (nc * 256 + wl) * 128 * 2 * 2          # scores + p.v
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    flops_ms = flops / H100_F32_FLOPS * 1e3
    fn.launches = launches0                               # comparisons do not count
    emit("kernel" if codec == "q8q4" else "kernel_sp",
         shapes={"B": B, "Hq": Hq, "Hkv": Hkv, "L": L, "mc": mc, "W": W},
         cases=results, kernel_ms=kernel_ms, kernel_ms_l2_hot=hot_ms,
         kernel_ms_full_pool=full_ms, plain_ms=plain_ms, host_behind=behind,
         wrapper_host_us=wrapper_us,
         timed_at={"sparsity": kit.sparsity, "n_chunks": nc, "win_len": wl},
         bytes=nbytes, flops=flops, bound_ms=max(bytes_ms, flops_ms), library_ms=None)
    entry = _entry(codec, "decode", results, worst, max(r["tol"] for r in results),
                   kernel_ms, plain_ms, bytes_ms, flops_ms)
    entry["max_err"] = entry["max_abs_err"]
    return entry


def phase_kernel_ps(codec="q8q4"):
    """Per-slot decode kernel vs its plain version at the engine's pool
    shape (B=8 slots, Hkv=8, mc=32 as at ``serve_cb``'s max_seq_len 8448):
    mixed slots with n_chunks 0/1/2/5/31 and win_len 0/1/44/288 (the
    31-chunk slot is the 8,000-token request's decode), an idle slot (0, 0)
    among them, query groups 1/2/4/8, bf16 and f32 q (the bitmap codec at
    sparsity 0.7 and 0.5).  Timed at these slots and, beside them, at the
    lighter mix of earlier runs (0-5 chunks)."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    B, Hkv, L, mc, W, D = 8, 8, 4, 32, 288, 128
    BH = B * Hkv
    kits = [_Kit(codec, g, dev, L, mc, BH, W, sp)
            for sp in ((0.7,) if codec == "q8q4" else (0.7, 0.5))]
    slots = [(0, 0), (0, 1), (1, 44), (2, 288), (5, 288), (5, 1), (1, 0), (31, 288)]
    light = slots[:-1] + [(2, 44)]          # the slots timed before mc = 32

    def counts(sl):
        return (torch.tensor([c for c, _ in sl], dtype=torch.int32, device=dev),
                torch.tensor([w for _, w in sl], dtype=torch.int32, device=dev))

    nc, wl = counts(slots)
    fn = kits[0].fns["decode_ps"]
    launches0 = fn.launches
    results, worst = [], 0.0
    for kit in kits:
        for G in (1, 2, 4, 8):
            qb = torch.randn((B, 1, Hkv * G, D), generator=g, device=dev).to(torch.bfloat16)
            for qq in (qb, qb.float()):
                for li in (0, L - 1):
                    got = kit.decode_ps(qq, nc, wl, li)
                    torch.cuda.synchronize()
                    want = kit.decode_ps_plain(qq, nc, wl, li)
                    # each slot is held to its own output scale, so a slot of
                    # small outputs (many chunks) is held as tightly as a
                    # one-token slot
                    dims = (1, 2, 3)
                    errs = (got.float() - want.float()).abs().amax(dim=dims)
                    tols = KERNEL_TOL_ULPS * 2.0 ** -8 * want.float().abs().amax(dim=dims)
                    live = (nc > 0) | (wl > 0)
                    idle_zero = bool((got[~live] == 0).all())
                    live_nonzero = bool((got.float().abs().amax(dim=dims)[live] > 0).all())
                    ratio = (errs[live] / tols[live].clamp_min(1e-30)).max().item()
                    results.append({"sparsity": kit.sparsity, "G": G,
                                    "q_dtype": str(qq.dtype).split(".")[-1],
                                    "li": li, "max_abs_err": errs.max().item(),
                                    "slot_err": errs.tolist(), "slot_tol": tols.tolist(),
                                    "worst_err_over_tol": ratio,
                                    "idle_slots_zero": idle_zero,
                                    "live_slots_nonzero": live_nonzero})
                    if not (got.isfinite().all() and ratio <= 1.0 and idle_zero
                            and live_nonzero):
                        raise AssertionError(f"per-slot kernel disagrees with its "
                                             f"plain version: {results[-1]}")
                    worst = max(worst, ratio)

    # time at the serving shape (G=4), the mixed slots above, L2 flushed
    kit = kits[0]
    q = torch.randn((B, 1, Hkv * 4, D), generator=g, device=dev).to(torch.bfloat16)
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    for _ in range(10):
        kit.decode_ps(q, nc, wl, 0)
    torch.cuda.synchronize()
    kernel_ms, behind = cuda_ms(lambda: kit.decode_ps(q, nc, wl, 0), 100,
                                flush=flush_buf.zero_)
    plain_ms, _ = cuda_ms(lambda: kit.decode_ps_plain(q, nc, wl, 0), 10,
                          flush=flush_buf.zero_, spin=False)
    lnc, lwl = counts(light)
    light_ms, _ = cuda_ms(lambda: kit.decode_ps(q, lnc, lwl, 0), 100,
                          flush=flush_buf.zero_)
    wrapper_us = host_us(lambda: kit.decode_ps(q, nc, wl, 0), 100)
    n_tok = sum(c * 256 + w for c, w in slots)
    nbytes = (Hkv * sum(c * kit.chunk_bytes + 2 * w * 128 * 2
                        for c, w in slots)                  # pools, windows
              + 2 * q.numel() * 2 + 2 * B * 4)              # q in, out, counts
    flops = Hkv * 4 * n_tok * D * 2 * 2                     # scores + p.v, G = 4
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    flops_ms = flops / H100_F32_FLOPS * 1e3
    fn.launches = launches0                               # comparisons do not count
    emit("kernel_ps" if codec == "q8q4" else "kernel_sp_ps",
         shapes={"B": B, "Hq": 4 * Hkv, "Hkv": Hkv, "L": L, "mc": mc, "W": W},
         slots=slots, cases=results, worst_err_over_tol=worst, kernel_ms=kernel_ms,
         kernel_ms_light_slots=light_ms, light_slots=light, plain_ms=plain_ms,
         host_behind=behind, wrapper_host_us=wrapper_us, timed_at={"sparsity": kit.sparsity}, bytes=nbytes,
         flops=flops, bound_ms=max(bytes_ms, flops_ms), library_ms=None)
    return _entry(codec, "decode_ps", results, worst,
                  "per slot: 2 bf16 ulps of the slot's largest output",
                  kernel_ms, plain_ms, bytes_ms, flops_ms)


def phase_kernel_seg(codec="q8q4"):
    """Segment kernel vs its plain version: Tseg=256, Hq=32 over Hkv=8
    (G=4), B = 1 and 2, n_chunks 0/1/4/31 (the bitmap codec at sparsity 0.7
    and, at B=1, 0.5); timed at the serving shape of the longest prompt's
    last segment (B=1, 31 chunks)."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    Hq, Hkv, T, L, mc, D = 32, 8, 256, 2, 32, 128
    fn = None
    results, worst = [], 0.0
    kits = {}
    runs = [(1, 0.7), (2, 0.7)] + ([] if codec == "q8q4" else [(1, 0.5)])
    for B, sparsity in runs:
        kit = _Kit(codec, g, dev, L, mc, B * Hkv, 8, sparsity)
        kits[(B, sparsity)] = kit
        if fn is None:
            fn = kit.fns["segment"]
            launches0 = fn.launches
        qb = torch.randn((B, T, Hq, D), generator=g, device=dev).to(torch.bfloat16)
        for nc in (0, 1, 4, 31):
            for qq, li in ((qb, nc % L), (qb.float(), (nc + 1) % L)):
                acc, m, l = kit.segment(qq, nc, li)
                torch.cuda.synchronize()
                pa, pm, pl = kit.segment_plain(qq, nc, li)
                if nc == 0:
                    exact = bool((acc == 0).all() and (m == -1e30).all() and (l == 0).all())
                    results.append({"B": B, "sparsity": sparsity, "n_chunks": 0, "li": li,
                                    "empty_exact": exact})
                    if not exact:
                        raise AssertionError(f"segment kernel, no chunk: {results[-1]}")
                    continue
                # normalised output within 2 bf16 ulps of its scale (the bf16
                # roundings of p may move by one ulp: other summation order);
                # m and l are f32 sums in another order
                out, pout = acc / l, pa / pl
                err = (out - pout).abs().max().item()
                tol = KERNEL_TOL_ULPS * 2.0 ** -8 * pout.abs().max().item()
                m_err = (m - pm).abs().max().item()
                m_tol = 1e-5 * pm.abs().max().item()
                l_err = ((l - pl).abs() / pl).max().item()
                l_tol = 1e-4
                results.append({"B": B, "sparsity": sparsity, "n_chunks": nc, "li": li,
                                "q_dtype": str(qq.dtype).split(".")[-1],
                                "max_abs_err": err, "tol": tol, "m_err": m_err,
                                "m_tol": m_tol, "l_rel_err": l_err, "l_tol": l_tol})
                if not (acc.isfinite().all() and err <= tol and m_err <= m_tol
                        and l_err <= l_tol):
                    raise AssertionError(f"segment kernel disagrees with its plain "
                                         f"version: {results[-1]}")
                worst = max(worst, err / max(tol, 1e-30), m_err / max(m_tol, 1e-30),
                            l_err / l_tol)

    B, nc = 1, 31
    kit = kits[(B, 0.7)]
    q = torch.randn((B, T, Hq, D), generator=g, device=dev).to(torch.bfloat16)
    for _ in range(3):
        kit.segment(q, nc, 0)
    torch.cuda.synchronize()
    kernel_ms, behind = cuda_ms(lambda: kit.segment(q, nc, 0), 20)
    plain_ms, _ = cuda_ms(lambda: kit.segment_plain(q, nc, 0), 3, spin=False)
    wrapper_us = host_us(lambda: kit.segment(q, nc, 0), 20)
    BH, QR = B * Hkv, T * Hq // Hkv
    flops = 4 * BH * QR * nc * 256 * D                       # scores + p.v, mul + add
    nbytes = (BH * nc * kit.chunk_bytes                      # pools
              + q.numel() * 2 + B * T * Hq * (D + 2) * 4)    # q in; acc, m, l out
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    flops_ms = flops / H100_BF16_FLOPS * 1e3
    fn.launches = launches0
    emit("kernel_seg" if codec == "q8q4" else "kernel_sp_seg",
         shapes={"Tseg": T, "Hq": Hq, "Hkv": Hkv, "L": L, "mc": mc},
         cases=results, worst_err_over_tol=worst,
         timed_at={"B": B, "n_chunks": nc, "sparsity": kit.sparsity},
         kernel_ms=kernel_ms, plain_ms=plain_ms, host_behind=behind,
         wrapper_host_us=wrapper_us,
         flops=flops, bytes=nbytes,
         bound_ms=max(bytes_ms, flops_ms), library_ms=None)
    return _entry(codec, "segment", results, worst,
                  max(r.get("tol", 0.0) for r in results),
                  kernel_ms, plain_ms, bytes_ms, flops_ms)


def _tiny_engine(mode, codec="q8q4", **kw):
    import dataclasses
    from mustafar_tpu_torch import config as tc
    model = dataclasses.replace(tc.TINY_LLAMA, head_dim=128, num_heads=4,
                                num_kv_heads=1, hidden_size=256)
    return tc.EngineConfig(
        model=model, cache_mode=mode,
        prune=tc.PruneConfig(method=tc.PruneMethod.KT_MAG_VT_MAG,
                             k_sparsity=0.7, v_sparsity=0.7),
        max_seq_len=kw.pop("max_seq_len", 1024), prefill_bucket=256, chunk_size=256,
        codec=codec, **kw)


def _counters():
    """The launch count of every kernel wrapper, by name."""
    from mustafar_tpu_torch.ops.kernels import quant_attention as qa
    from mustafar_tpu_torch.ops.kernels import sparse_attention as ska
    return {fn.__name__: fn for fn in (
        qa.fused_q_decode_attention, qa.fused_q_decode_attention_ps,
        qa.fused_q_segment_attention, ska.fused_sparse_decode_attention,
        ska.fused_sparse_decode_attention_ps, ska.fused_sparse_segment_attention)}


def _launches():
    return {name: fn.launches for name, fn in _counters().items()}


def _set_launches(counts):
    for name, fn in _counters().items():
        fn.launches = counts[name]


def _recording_engine():
    """The continuous-batching engine with its token choice recorded per
    request (``logits``), optionally fed given streams (teacher forcing)."""
    import numpy as np
    from mustafar_tpu_torch.runtime.scheduler import ContinuousBatchingEngine

    class Recording(ContinuousBatchingEngine):
        def __init__(self, *args, streams=None, **kw):
            super().__init__(*args, **kw)
            self.streams = streams
            self.logits = {}

        def _choose(self, logits2d, reqs):
            picks = super()._choose(logits2d, reqs)
            for i, req in enumerate(reqs):
                if req is not None:
                    self.logits.setdefault(req.uid, []).append(logits2d[i].float().cpu())
                    if self.streams is not None:
                        picks[i] = self.streams[req.uid][len(req.out)]
            return picks

    return Recording, np


def phase_reference(codec="q8q4"):
    """A tiny f32 model, same weights and token stream on the card and on
    the CPU: the card runs the kernel, the CPU the plain path.  Returns the
    phase's numbers (``reference_bitmap`` prints them for the bitmap
    codec)."""
    import numpy as np
    import torch
    from mustafar_tpu_torch.cache import make_cache
    from mustafar_tpu_torch.config import CacheMode
    from mustafar_tpu_torch.models import llama
    eng = _tiny_engine(CacheMode.COMPRESSED, codec)
    cpu_params = llama.init_params(eng.model, device="cpu", dtype=torch.float32, seed=1)
    gpu_params = {k: ({kk: vv.cuda() for kk, vv in v.items()} if isinstance(v, dict)
                      else v.cuda()) for k, v in cpu_params.items()}
    prompt = np.random.RandomState(1).randint(0, 512, (2, 300))
    toks = torch.zeros((2, 512), dtype=torch.int64)
    toks[:, :300] = torch.from_numpy(prompt)
    launches0 = _launches()
    logs = {}
    stream = None
    with torch.inference_mode():
        for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
            impl = make_cache(eng, device=dev)
            cache = impl.init(2, torch.float32)
            logit, cache = llama.prefill(eng.model, params, toks.to(dev), cache,
                                         impl, 300, last_only=True)
            out = [logit[:, 0].cpu()]
            tok = logit[:, 0].argmax(-1)
            for i in range(1, 40):
                if stream is not None:
                    tok = stream[:, i - 1].to(dev)
                logit, cache = llama.decode_step(eng.model, params, tok[:, None],
                                                 cache, impl, 300 + i - 1)
                out.append(logit[:, 0].cpu())
                tok = logit[:, 0].argmax(-1)
            logs[dev] = torch.stack(out, 1)
            if stream is None:
                stream = logs[dev].argmax(-1)          # the CPU's greedy picks
    launched = {k: v - launches0[k] for k, v in _launches().items() if v > launches0[k]}
    _set_launches(launches0)
    a, b = logs["cpu"], logs["cuda"]
    err = (a - b).abs().max().item()
    scale = a.abs().max().item()
    # the kernel reads q and the window as bf16 and rounds p to bf16: last-bit
    # differences of f32 activations on the two devices can flip one of those
    # roundings (the CPU parity tests measure < 3e-3 of the logits' range)
    tol = 1e-2 * scale
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    fields = {"steps": 40, "max_abs_err": err, "tol": tol, "greedy_agreement": agree,
              "launched": launched}
    if codec == "q8q4":
        emit("reference", **fields)
    if not (b.isfinite().all() and err <= tol):
        raise AssertionError(f"card and CPU logits disagree on the tiny model: {fields}")
    return fields


def phase_reference_cb(codec="q8q4"):
    """The tiny f32 continuous-batching engine, chunked prefill with
    interleaved admission, on the CPU (plain versions) and on the card
    (kernels), fed the CPU's tokens: the card's logits within 1e-2 of their
    range, its own greedy picks equal to the CPU's.  The requests make a
    slot retire while the other decodes (its n_chunks still the old
    request's) and reuse it.  Returns the phase's numbers."""
    import torch
    from mustafar_tpu_torch.config import CacheMode
    from mustafar_tpu_torch.models import llama
    Recording, np = _recording_engine()
    eng = _tiny_engine(CacheMode.COMPRESSED, codec, max_seq_len=2048, batch_size=2,
                       chunked_prefill=True)
    cpu_params = llama.init_params(eng.model, device="cpu", dtype=torch.float32, seed=2)
    gpu_params = {k: ({kk: vv.cuda() for kk, vv in v.items()} if isinstance(v, dict)
                      else v.cuda()) for k, v in cpu_params.items()}
    rs = np.random.RandomState(2)
    reqs = [(rs.randint(0, 512, size=n), m)
            for n, m in ((100, 12), (1000, 6), (280, 30), (530, 20))]
    counts0 = _launches()
    runs = {}
    for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        streams = None if dev == "cpu" else runs["cpu"][0]
        cb = Recording(eng, params, dtype=torch.float32, device=dev, streams=streams)
        for p, m in reqs:
            cb.submit(p, m)
        runs[dev] = (cb.run(), cb.logits, cb.ticks, cb.segments, cb.decode_steps)
    launched = {k: v - counts0[k] for k, v in _launches().items() if v > counts0[k]}
    _set_launches(counts0)
    toks, lc, ticks, segments, steps = runs["cpu"]
    _, lg, *_ = runs["cuda"]
    err, scale, agree, n = 0.0, 0.0, 0, 0
    for uid in toks:
        a, b = torch.stack(lc[uid]), torch.stack(lg[uid])
        err = max(err, (a - b).abs().max().item())
        scale = max(scale, a.abs().max().item())
        agree += int((b.argmax(-1) == torch.as_tensor(toks[uid])).sum())
        n += len(toks[uid])
    tol = 1e-2 * scale
    fields = {"requests": len(reqs), "tokens": n, "ticks": ticks, "segments": segments,
              "decode_steps": steps, "max_abs_err": err, "tol": tol,
              "greedy_agreement": agree / n, "launched": launched}
    if codec == "q8q4":
        emit("reference_cb", **fields)
    if not (err <= tol and agree == n):
        raise AssertionError(f"card and CPU disagree on the tiny continuous-batching "
                             f"run: {fields}")
    return fields


def phase_reference_bitmap():
    """``reference`` and ``reference_cb`` with the bitmap codec: the
    Generator's decode path and the engine (per-slot decode, segments)
    through the bitmap kernels on the card, against the plain versions on
    the CPU.  Each run must have launched the bitmap kernels."""
    gen, cb = phase_reference("bitmap"), phase_reference_cb("bitmap")
    emit("reference_bitmap", generator=gen, engine=cb)
    if set(gen["launched"]) != {"fused_sparse_decode_attention"} or set(
            cb["launched"]) != {"fused_sparse_decode_attention_ps",
                                "fused_sparse_segment_attention"}:
        raise AssertionError(f"reference_bitmap: launched {gen['launched']} and "
                             f"{cb['launched']}")


def serve(label, mode, params, prompt, new_tokens, codec="q8q4"):
    """One warm-up generation, then the measured one; returns its tokens,
    the launches of every kernel during the measured run (those launched)
    and the phase's fields."""
    import numpy as np
    import torch
    from mustafar_tpu_torch.config import EngineConfig, LLAMA3_8B, PruneConfig, PruneMethod
    from mustafar_tpu_torch.runtime.generate import Generator
    eng = EngineConfig(model=LLAMA3_8B, cache_mode=mode,
                       prune=PruneConfig(method=PruneMethod.KT_MAG_VT_MAG,
                                         k_sparsity=0.7, v_sparsity=0.7),
                       max_seq_len=1312, prefill_bucket=256, chunk_size=256,
                       codec=codec)
    gen = Generator(eng, params, dtype=torch.bfloat16)
    gen.generate(prompt, 4)                                   # warm-up
    gen.last_cache = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _set_launches(dict.fromkeys(_counters(), 0))
    t = time.perf_counter()
    out = gen.generate(prompt, new_tokens)
    dt = time.perf_counter() - t
    launches = {k: v for k, v in _launches().items() if v}
    toks = torch.as_tensor(np.stack(out))
    B = toks.shape[0]
    if toks.shape != (B, new_tokens) or toks.min() < 0 or toks.max() >= LLAMA3_8B.vocab_size:
        raise AssertionError(f"{label}: bad tokens {tuple(toks.shape)}")
    fields = {"batch": B, "prompt": prompt.shape[1], "new_tokens": new_tokens,
              "seconds": dt, "tok_s": B * new_tokens / dt,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "kernel_launches": launches}
    if mode.value == "compressed":
        fields["codec"] = codec
    cache = gen.last_cache
    if mode.value == "compressed":
        fields["n_chunks_end"] = cache["nc_host"]
        if not (cache["nc_host"] == 2 and bool((cache["n_chunks"] == 2).all())):
            raise AssertionError(f"{label}: expected 2 pool chunks at the end, "
                                 f"got {cache['nc_host']}")
    # finite logits on a small prefill through the same engine
    from mustafar_tpu_torch.models import llama
    with torch.inference_mode():
        small = torch.as_tensor(prompt[:1, :256]).cuda()
        logits, _ = llama.prefill(LLAMA3_8B, params, small, gen.cache_impl.init(1),
                                  gen.cache_impl, 256, last_only=True)
    if not bool(logits.isfinite().all()):
        raise AssertionError(f"{label}: non-finite logits")
    del gen, cache
    torch.cuda.empty_cache()
    return toks, launches, fields


def phase_decode_split(params, kernel_ms, q8q4_s, dense_s, new_tokens):
    """Device time of the decode step's big parts, each timed alone with
    CUDA events at B=8 (a GPU-bound stream of launches, so the events read
    device time): the seven W8 projections of a layer (int8 widened to bf16,
    then matmul and scale), the LM head, and the attention kernel, beside
    the wall time per generated token of the two serve runs."""
    import torch
    from mustafar_tpu_torch.config import LLAMA3_8B as cfg
    from mustafar_tpu_torch.models.llama import _lm_head
    from mustafar_tpu_torch.models.quant import proj
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    h = torch.randn((8, 1, cfg.hidden_size), generator=g, device="cuda").to(torch.bfloat16)
    hi = torch.randn((8, 1, cfg.intermediate_size), generator=g,
                     device="cuda").to(torch.bfloat16)
    layers = params["layers"]

    def all_layers():
        for li in range(cfg.num_layers):
            lp = {name: leaf[li] for name, leaf in layers.items()}
            for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up"):
                proj(h, lp, name)
            proj(hi, lp, "w_down")

    with torch.inference_mode():
        all_layers()
        _lm_head(cfg, params, h)
        torch.cuda.synchronize()
        w8_layer_ms = cuda_ms(all_layers, 3)[0] / cfg.num_layers
        head_ms = cuda_ms(lambda: _lm_head(cfg, params, h), 5)[0]
    parts_ms = cfg.num_layers * (w8_layer_ms + kernel_ms) + head_ms
    emit("decode_split", w8_layer_ms=w8_layer_ms, lm_head_ms=head_ms,
         attn_kernel_ms=kernel_ms, w8_head_attention_ms_per_step=parts_ms,
         q8q4_wall_ms_per_token=q8q4_s / new_tokens * 1e3,
         dense_wall_ms_per_token=dense_s / new_tokens * 1e3)


def phase_serve_cb(params, codec="q8q4"):
    """Continuous batching at full Llama-3-8B width and depth: 8 slots, 17
    requests (16 with prompts of 200-1,500 tokens and 32-96 new tokens,
    plus one of 8,000 prompt tokens submitted third), chunked prefill with
    interleaved admission, ``codec`` at 0.7.  Every decode step must launch
    the codec's per-slot kernel once a layer, every segment its segment
    kernel once a layer, and no other kernel may run; every request's first
    token must equal a batch-1 chunked Generator's on the same prompt."""
    import numpy as np
    import torch
    from mustafar_tpu_torch.config import (CacheMode, EngineConfig, LLAMA3_8B,
                                           PruneConfig, PruneMethod)
    from mustafar_tpu_torch.runtime.generate import Generator
    from mustafar_tpu_torch.runtime.scheduler import ContinuousBatchingEngine
    eng = EngineConfig(model=LLAMA3_8B, cache_mode=CacheMode.COMPRESSED,
                       prune=PruneConfig(method=PruneMethod.KT_MAG_VT_MAG,
                                         k_sparsity=0.7, v_sparsity=0.7),
                       max_seq_len=8448, prefill_bucket=256, chunk_size=256,
                       codec=codec, batch_size=8, chunked_prefill=True)
    rs = np.random.RandomState(1)
    reqs = [(rs.randint(1, LLAMA3_8B.vocab_size, size=rs.randint(200, 1501)),
             int(rs.randint(32, 97))) for _ in range(16)]
    reqs.insert(2, (rs.randint(1, LLAMA3_8B.vocab_size, size=8000), 64))
    warm = ContinuousBatchingEngine(eng, params)
    for p, _ in reqs[:2]:
        warm.submit(p[:300], 4)
    warm.run()
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    class Timed(ContinuousBatchingEngine):
        """Wall time of each tick by what it ran (a tick that decodes ends
        in the device read of its tokens, so its time includes its work)."""
        split = {"segment+decode": [], "decode": [], "segment": []}

        def tick(self):
            seg0, dec0, t0 = self.segments, self.decode_steps, time.perf_counter()
            super().tick()
            kind = ("segment+" if self.segments > seg0 else "") + \
                ("decode" if self.decode_steps > dec0 else "")
            self.split[kind.rstrip("+")].append(time.perf_counter() - t0)

    cb = Timed(eng, params)
    uids = [cb.submit(p, m) for p, m in reqs]
    _set_launches(dict.fromkeys(_counters(), 0))
    t = time.perf_counter()
    outs = cb.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = _launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    L = LLAMA3_8B.num_layers
    generated = sum(len(outs[u]) for u in uids)
    want = dict.fromkeys(launches, 0)
    want[KERNEL_META[(codec, "decode_ps")][0]] = L * cb.decode_steps
    want[KERNEL_META[(codec, "segment")][0]] = L * cb.segments
    seg_expected = sum(-(-len(p) // 256) for p, _ in reqs)
    bad = [u for u, (p, m) in zip(uids, reqs)
           if len(outs[u]) != m or min(outs[u]) < 0 or max(outs[u]) >= LLAMA3_8B.vocab_size]
    # first tokens against a batch-1 chunked Generator (not counted above)
    gen = Generator(eng, params)
    first_equal = [int(gen.generate(p[None], 1)[0][0]) == int(outs[u][0])
                   for u, (p, _) in zip(uids, reqs)]
    counts = {"ticks": cb.ticks, "decode_steps": cb.decode_steps,
              "segments": cb.segments,
              "tick_ms": {k: {"n": len(v), "mean": 1e3 * sum(v) / max(len(v), 1),
                              "total_s": sum(v)} for k, v in Timed.split.items()}}
    del gen, cb
    torch.cuda.empty_cache()
    label = "serve_cb" if codec == "q8q4" else "serve_cb_bitmap"
    emit(label, model="llama-3-8b x32L, W8 (random, seed 0)", codec=codec, slots=8,
         requests=len(reqs), prompt_tokens=sum(len(p) for p, _ in reqs),
         generated_tokens=generated, seconds=dt, tok_s=generated / dt,
         peak_mem_gib=peak, **counts, launches=launches, expected_launches=want,
         first_token_equal=sum(first_equal))
    if bad or launches != want or counts["segments"] != seg_expected:
        raise AssertionError(f"{label}: bad outputs {bad}, launches {launches} "
                             f"(expected {want}), segments {counts['segments']} "
                             f"(expected {seg_expected})")
    if not all(first_equal):
        raise AssertionError(f"{label}: first tokens differ from the batch-1 "
                             f"chunked Generator for requests "
                             f"{[u for u, ok in zip(uids, first_equal) if not ok]}")
    return launches


def phase_serve_chunked(params):
    """Generator with chunked prefill at full width: B=4, prompt 2,000 (8
    segments), 64 new tokens; prefill through the segment kernel, decode
    through the uniform kernel."""
    import numpy as np
    import torch
    from mustafar_tpu_torch.config import (CacheMode, EngineConfig, LLAMA3_8B,
                                           PruneConfig, PruneMethod)
    from mustafar_tpu_torch.ops.kernels import quant_attention as qa
    from mustafar_tpu_torch.runtime.generate import Generator
    eng = EngineConfig(model=LLAMA3_8B, cache_mode=CacheMode.COMPRESSED,
                       prune=PruneConfig(method=PruneMethod.KT_MAG_VT_MAG,
                                         k_sparsity=0.7, v_sparsity=0.7),
                       max_seq_len=2304, prefill_bucket=256, chunk_size=256,
                       codec="q8q4", chunked_prefill=True)
    prompt = np.random.RandomState(3).randint(1, LLAMA3_8B.vocab_size, (4, 2000))
    new = 64
    gen = Generator(eng, params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    qa.fused_q_decode_attention.launches = 0
    qa.fused_q_segment_attention.launches = 0
    t = time.perf_counter()
    out = gen.generate(prompt, new)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = {"fused_q_decode_attention": qa.fused_q_decode_attention.launches,
                "fused_q_segment_attention": qa.fused_q_segment_attention.launches}
    L = LLAMA3_8B.num_layers
    want = {"fused_q_decode_attention": L * (new - 1),
            "fused_q_segment_attention": L * 2048 // 256}
    toks = np.stack(out)
    emit("serve_chunked", batch=4, prompt=2000, new_tokens=new, seconds=dt,
         tok_s=toks.size / dt, peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         n_chunks_end=gen.last_cache["nc_host"], launches=launches,
         expected_launches=want)
    if toks.shape != (4, new) or launches != want or gen.last_cache["nc_host"] != 7:
        raise AssertionError(f"serve_chunked: tokens {toks.shape}, launches "
                             f"{launches} (expected {want})")
    del gen
    torch.cuda.empty_cache()


def phase_host_split(params):
    """Host or device: one chunked-prefill segment (B=1 after 4 packed
    chunks; it packs a fifth) and one decode tick of the engine with 8
    active slots, each timed three ways: the host's time to enqueue it, the
    wall time until the card is done, and the device time of its kernels
    with the number of kernels launched (torch.profiler)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from mustafar_tpu_torch.cache import make_cache
    from mustafar_tpu_torch.config import (CacheMode, EngineConfig, LLAMA3_8B,
                                           PruneConfig, PruneMethod)
    from mustafar_tpu_torch.models import llama
    from mustafar_tpu_torch.runtime.scheduler import ContinuousBatchingEngine
    eng = EngineConfig(model=LLAMA3_8B, cache_mode=CacheMode.COMPRESSED,
                       prune=PruneConfig(method=PruneMethod.KT_MAG_VT_MAG,
                                         k_sparsity=0.7, v_sparsity=0.7),
                       max_seq_len=2304, prefill_bucket=256, chunk_size=256,
                       codec="q8q4", batch_size=8, chunked_prefill=True)

    def measure(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        enqueue = time.perf_counter() - t
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        # device rows only: an op's row also counts the kernels it launched
        device_us = sum(e.self_device_time_total for e in events
                        if e.device_type == DeviceType.CUDA)
        launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
        return {"enqueue_ms": 1e3 * enqueue, "wall_ms": 1e3 * wall,
                "device_ms": device_us / 1e3, "kernels_launched": launches}

    impl = make_cache(eng)
    toks = torch.as_tensor(np.random.RandomState(4).randint(1, 500, (1, 2048)),
                           device=impl.device)
    sub = impl.init(1)
    seg = [0]

    def segment():
        s = seg[0]
        llama.prefill_segment(LLAMA3_8B, params, toks[:, s * 256:(s + 1) * 256], sub,
                              impl, s * 256, 2000)
        seg[0] += 1

    with torch.inference_mode():
        for _ in range(4):
            segment()
        seg_split = measure(segment)           # segment 4; the profiled one is 5
        cb = ContinuousBatchingEngine(eng, params)
        rs = np.random.RandomState(5)
        for _ in range(8):
            cb.submit(rs.randint(1, 500, size=300), 64)
        while cb._admissions or cb.queue:
            cb.tick()
        tick_split = measure(cb.tick)
    del cb, sub
    torch.cuda.empty_cache()
    emit("host_split", segment_b1=seg_split, decode_tick_b8=tick_split)


def main():
    faulthandler.dump_traceback_later(BUDGET_S, exit=True)
    smi = phase_env()
    phase_build()
    entries = {(codec, kind): phase(codec) for codec in ("q8q4", "bitmap")
               for kind, phase in (("decode", phase_kernel), ("decode_ps", phase_kernel_ps),
                                   ("segment", phase_kernel_seg))}
    phase_reference()
    phase_reference_cb()
    phase_reference_bitmap()

    import numpy as np
    import torch
    from mustafar_tpu_torch.config import CacheMode, LLAMA3_8B
    from mustafar_tpu_torch.models.quant import init_params_w8, weight_bytes
    t = time.perf_counter()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    params = init_params_w8(LLAMA3_8B, g, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    prompt = np.random.RandomState(0).randint(1, LLAMA3_8B.vocab_size, (8, 300))
    new = 300
    decode_steps = new - 1
    expected = LLAMA3_8B.num_layers * decode_steps
    sparse_toks, launches, fields = serve("serve_q8q4", CacheMode.COMPRESSED,
                                          params, prompt, new)
    q8q4_s = fields["seconds"]
    emit("serve_q8q4", model="llama-3-8b x32L, W8 (random, seed 0)",
         weights_gib=weight_bytes(params) / 2 ** 30, weights_init_s=init_s,
         decode_steps=decode_steps, expected_launches=expected, **fields)
    if launches != {"fused_q_decode_attention": expected}:
        raise AssertionError(f"kernels launched {launches}, expected {expected} = "
                             f"32 layers x {decode_steps} steps of the q8q4 kernel")
    entries[("q8q4", "decode")]["launches"] = expected
    dense_toks, dense_launches, fields = serve("serve_dense", CacheMode.DENSE,
                                               params, prompt, new)
    if dense_launches:
        raise AssertionError(f"the dense engine launched {dense_launches}")
    # the first token comes from prefill logits, the same in both engines
    first_equal = bool((sparse_toks[:, 0] == dense_toks[:, 0]).all())
    emit("serve_dense", first_token_equal=first_equal,
         token_agreement_with_q8q4=(sparse_toks == dense_toks).float().mean().item(),
         **fields)
    if not first_equal:
        raise AssertionError("sparse and dense engines disagree on the first token")
    dense_s = fields["seconds"]
    bitmap_toks, launches, fields = serve("serve_bitmap", CacheMode.COMPRESSED, params,
                                          prompt, new, codec="bitmap")
    first_equal = bool((bitmap_toks[:, 0] == dense_toks[:, 0]).all())
    emit("serve_bitmap", decode_steps=decode_steps, expected_launches=expected,
         first_token_equal_dense=first_equal,
         token_agreement_with_q8q4=(bitmap_toks == sparse_toks).float().mean().item(),
         token_agreement_with_dense=(bitmap_toks == dense_toks).float().mean().item(),
         **fields)
    if launches != {"fused_sparse_decode_attention": expected}:
        raise AssertionError(f"serve_bitmap: kernels launched {launches}, expected "
                             f"{expected} of the bitmap decode kernel")
    if not first_equal:
        raise AssertionError("bitmap and dense engines disagree on the first token")
    entries[("bitmap", "decode")]["launches"] = expected
    phase_decode_split(params, entries[("q8q4", "decode")]["kernel_ms"], q8q4_s,
                       dense_s, new)
    for codec in ("q8q4", "bitmap"):
        cb_launches = phase_serve_cb(params, codec)
        for kind in ("decode_ps", "segment"):
            entries[(codec, kind)]["launches"] = cb_launches[KERNEL_META[(codec, kind)][0]]
    phase_serve_chunked(params)
    phase_host_split(params)

    print(smi, flush=True)
    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
