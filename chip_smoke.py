"""Chip smoke run of the PyTorch / H100 port (``mustafar_tpu_torch``).

    python3 chip_smoke.py            # from the root of a checkout, one CUDA card

Phases, each printing one flushed JSON line with its ``phase`` and
``elapsed_s``:
  env           torch / CUDA versions, the card's name and power limit
  build         nvcc builds the eleven kernel libraries at once (csrc/q_decode.cu,
                csrc/q_decode_ps.cu, csrc/q_segment.cu, csrc/sp_decode.cu: the
                bitmap uniform and per-slot entries, csrc/sp_segment.cu, both
                with an instance per value width (16 and 8 bits),
                csrc/w4_matmul.cu, csrc/dense_decode.cu,
                csrc/prune_quant_pack.cu, and the archive's
                csrc/sp_archive_spmv.cu, csrc/sp_archive_fused.cu and
                csrc/sp_archive_stream.cu) and prints ptxas per instance
  kernel        the uniform decode kernel against its plain PyTorch version on
                the card, at the flagship per-layer shapes (B=8, Hq=32, Hkv=8,
                mc=5), with its time beside the plain version's and its bound
  kernel_ps     the per-slot decode kernel likewise, at the engine's pool
                (mc=32): mixed slots (n_chunks 0/1/2/5/31, win_len
                0/1/44/288, an idle slot), groups 1/2/4/8; the kernel
                (split-K, every codec) also against its split plain
                version, and refusing short scratch
  kernel_seg    the segment kernel likewise: Tseg=256, G=4, B = 1 and 2,
                n_chunks 0/1/4/31, a second launch bit-equal to the first;
                timed at 31 chunks (the bitmap codecs' with their cluster
                size and the clusters the card holds), the quant codecs' also
                at 1, 4 and 16 (the counts serve_cb launches it at), each
                beside its bound
  kernel_q8, kernel_ps_q8, kernel_seg_q8, and the same for q4q4
                the three phases above at the codecs q8 and q4q4
  kernel_sp, kernel_sp_ps, kernel_sp_seg
                the bitmap codec's three kernels likewise, at the shapes of
                the three phases above, over real packed chunks (random bf16
                K and V pruned and encoded on the card) at sparsity 0.7, and
                0.5 (zero pads in the rows)
  kernel_sp_q8, kernel_sp_ps_q8, kernel_sp_seg_q8
                the same for the bitmap-q8 codec: the kernels' 8-bit
                instances over chunks pruned, quantized and encoded on the
                card, with their bf16 scales
  kernel_pack   the prune + quantize + pack kernel (TPU kernel 9) against its
                plain version, bit-equal: 64 and 8 head-chunks of 256 tokens,
                bits 8 and 4, keep 40/14/128, ties, a zero row, the score
                option and the cache's strided views; timed beside its byte
                bound and the plain chain
  kernel_w4     the W4 matmul kernel against its plain version at every
                Llama-3-8B projection shape and the fused wqkv / w_gateup, T = 8
                and 32 (and 1, 13, 100, 128 at one shape), a second launch
                bit-equal to the first, refusing a short workspace; timed
                beside its byte bound (and its share of it), the W8 proj and
                a bf16 matmul of the same shape
  kernel_dense  the dense flash-decode kernel (split-K) against its plain
                version and its split plain version (a tighter gate: see
                split_gate), refusing short scratch: B=8, S=1,312, pos 599
                and per slot at S=8,448 (a slot at 8,000, an idle one), both
                timed beside scaled_dot_product_attention
  kernel_archive
                the archive's generations (TPU kernels 10-16: over split
                pools the v1 pair sparse_key_scores / sparse_value_combine,
                v2, v3; over the fused stream v4, v5, v6) against their plain
                versions, and the v1 chain against its plain chain, on random
                chunks pruned and packed on the card (prune_and_encode_chunk
                and _stream; v3's pools a chunk-major copy): B=8, Hkv=8,
                mc=5, W=288, sparsity 0.7 and 0.5, G 1/2/4/8, (n_chunks,
                win_len) (0, 44), (1, 288), (2, 1), (5, 288), (5, 0); v6's
                partials (acc, m, l) against the plain partials, v6 with
                window 300 and 600 at 5 chunks, v5 at hpb 8 and 2; nothing
                to attend (v1 and v6 NaN, v2-v4 the head's window mean, v5
                the mean over its TPU grid step's hpb heads, at hpb 8 and
                2); then the ladder: device ms of kernels 10 and 11, the v1
                chain, v2-v5, kernel 16 alone, the whole v6 and kernel 6
                beside their bounds and plain versions at (a) B=8, 1 chunk +
                288 window and (b) B=32, 3 chunks + 132 window (G=4)
  reference     a tiny f32 model decoded on the card (kernel) and on the CPU
                (plain path) with the same token stream: logits must agree
  reference_cb  the tiny f32 continuous-batching engine (chunked, interleaved
                admission, a slot retired and reused) likewise
  reference_bitmap, reference_bitmap_q8
                the two reference runs above with the bitmap and bitmap-q8
                codecs
  reference_q   the two reference runs above with the codecs q8 and q4q4
  reference_w4  a tiny W4 model, card (kernel 5, and kernel 4 for the dense
                cache with use_pallas, or the q8q4 kernel) against CPU
  serve_q8q4    full-width, 32-layer Llama-3-8B with random W8 weights made
                on the card: Generator.generate, B=8, prompt 300, 300 new
                tokens, q8q4 compressed cache (one compaction on the way);
                every decode step must launch the kernel once per layer, and
                kernel 9 twice a layer (K and V) for prefill's chunk and the
                compaction's: 128 launches
  serve_dense   the same prompts through the dense baseline cache
  kernel_archive_cache
                the archive's main path on serve_dense's own cache: K and V
                of all 32 layers, rows 0-511 as two chunks (split pools and
                fused streams, the streams one stacked pool read a layer view
                at a time), rows 512-598 the window; per layer v1-v6 and
                kernel 6 must agree (3e-2 v2 against v1 and v4 against v2,
                2e-2 v3 and kernel 6 against v2, v5 and v6 against v4), each
                launched once a layer
  serve_bitmap  serve_q8q4 with the bitmap codec (the JAX package's default):
                bitmap decode kernel launches = 32 x 299; first tokens =
                serve_dense's
  serve_bitmap_q8
                serve_bitmap with the bitmap-q8 codec (the capacity codec):
                the same launches; first tokens = serve_dense's; its peak
                memory and pool bytes beside serve_bitmap's
  serve_dense_kernel
                serve_dense with use_pallas: the dense cache through its
                flash-decode kernel, 32 launches a step; first tokens =
                serve_dense's
  serve_q8, serve_q4q4
                serve_q8q4 with the codecs q8 and q4q4 (the same launch
                counts); first tokens = serve_dense's
  decode_split  device time of a decode step's W8 projections, LM head and
                attention kernel, each timed alone, beside the step's wall time
  serve_cb      the continuous-batching engine at full width: 8 slots, 17
                requests (one of 8,000 prompt tokens), chunked interleaved
                admission; per-slot and segment kernel launches = 32 x decode
                steps and 32 x segments; first tokens = a batch-1 chunked
                Generator's
  serve_cb_bitmap, serve_cb_bitmap_q8
                serve_cb with the bitmap and bitmap-q8 codecs (peak memory
                and pool bytes side by side)
  serve_cb_q4q4 serve_cb with the q4q4 codec on its first 8 requests
                without the 8,000-token one; kernel 9 twice a layer for every
                chunk a prompt packs and every compaction (q8q4 and q4q4)
  serve_chunked Generator with chunked prefill at full width, B=4, 2,000 + 64
  host_split    one segment (B=1) at q8q4, bitmap and bitmap-q8, one K and V
                pack of a chunk at each, one decode tick (8 slots, q8q4) and
                one each of q8q4 and bitmap with an 8,000-token slot: host
                enqueue time, wall time, device time and kernels launched
  serve_w4_dense, serve_w4_q8q4, serve_w4_bitmap
                the Generator at full width and depth with W4 weights
                (init_params_w4, seed 0), B=8, 300 + 300: W4 kernel 7 x 32 and
                the cache's decode kernel 32 a step (the dense cache through
                its kernel); first tokens = serve_w4_dense's
  decode_split_w4
                decode_split for the W4 step, per cache
  serve_cb_w4   serve_cb with W4 weights on the bitmap codec: its first 8
                requests without the 8,000-token one
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
SPLIT_TOL = 2.0 ** -10     # of the slot's scale, against the kernel's own arithmetic
SPLIT_TOL_NOTE = ("against the split plain version: its f32 result rounded to the "
                  "output's dtype, within 2^-10 of the slot's largest output")
# why library_ms is null for the attention kernels over compressed pools:
# scaled_dot_product_attention (the one PyTorch attention call) takes
# dense K and V, so it would first need the pool decoded, another function
NO_LIBRARY = {
    "quant": ("no single PyTorch call attends over int8 / int4 codes in int16 "
              "carriers with per-chunk scales; scaled_dot_product_attention "
              "needs dense K and V"),
    "bitmap": ("no single PyTorch call attends over bitmap streams (bf16 values "
               "or int8 codes with scales); scaled_dot_product_attention needs "
               "dense K and V"),
    "archive": ("no single PyTorch call reads the archive's bitmap formats (split pools "
                "of bf16 value segments and uint32 word planes, or the fused int16 "
                "stream): torch.sparse products take COO / CSR / BSR layouts and "
                "scaled_dot_product_attention dense K and V, so the pools would first "
                "be converted (another function)"),
}


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


def split_gate(got, want32, live):
    """Worst error over tolerance, over the ``live`` slots, of a split
    kernel's output ``got`` [B, 1, Hq, D] against its split plain version's
    f32 result ``want32`` on the same inputs: ``got`` must be ``want32``
    rounded to its dtype (half a bf16 ulp of each bf16 element) within
    SPLIT_TOL of the slot's largest output.  Tighter than the gate against
    the TPU order, which allows 2 bf16 ulps of the scale."""
    import torch
    dims = (1, 2, 3)
    err = (got.float() - want32).abs()
    tol = SPLIT_TOL * want32.abs().amax(dim=dims, keepdim=True)
    if got.dtype == torch.bfloat16:
        exp = torch.frexp(got.float()).exponent
        half_ulp = torch.ldexp(torch.ones_like(err), exp - 9)   # 8 significant bits
        tol = tol + torch.where(got == 0, torch.zeros_like(err), half_ulp)
    return (err / tol.clamp_min(1e-30)).amax(dim=dims)[live].max().item()


def refuses_short_scratch(call):
    """Whether a split kernel's C entry refuses scratch one float short of
    what its grid needs (``call`` launches it through its wrapper)."""
    from mustafar_tpu_torch.ops.kernels import quant_attention as qa
    kept = qa._split_scratch
    qa._split_scratch = lambda BH, n_splits, G, *a: \
        kept(BH, n_splits, G, *a)[:BH * n_splits * G * 130 - 1]
    try:
        call()
    except RuntimeError as e:
        return "CUDA error 1" in str(e)          # cudaErrorInvalidValue
    finally:
        qa._split_scratch = kept
    return False


def refuses_short_workspace(call):
    """Whether the W4 kernel's C entry refuses a workspace one float short,
    and counters one short, of what its grid needs (``call`` launches it
    through its wrapper, the wrapper's own check bypassed)."""
    from mustafar_tpu_torch.ops.kernels import w4_matmul as w4
    kept, kept_check = w4._workspace, w4._check_workspace
    refused = []
    for cut in ((1, 0), (0, 1)):
        def short(part, *a, cut=cut):
            ws, counters = kept(part, *a)
            return (ws[:part.ws_floats - cut[0]], counters[:part.n_counters - cut[1]])
        w4._workspace, w4._check_workspace = short, lambda *a: None
        try:
            call()
            refused.append(False)
        except RuntimeError as e:
            refused.append("CUDA error 1" in str(e))           # cudaErrorInvalidValue
        finally:
            w4._workspace, w4._check_workspace = kept, kept_check
    return all(refused)


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


KERNEL_LIBS = ("q_decode", "q_decode_ps", "q_segment", "sp_decode", "sp_segment",
               "w4_matmul", "dense_decode", "prune_quant_pack", "sp_archive_spmv",
               "sp_archive_fused", "sp_archive_stream")
# (kbits, vbits) of the quant codecs, which kernels 1-3 and 9 serve
QUANT_BITS = {"q8": (8, 8), "q8q4": (8, 4), "q4q4": (4, 4)}


def phase_build():
    """nvcc builds the eleven kernel libraries at once, one process each."""
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
    ``segment(q_seg, n_chunks, li)`` and the plain versions beside each
    (and ``decode_ps_split_plain``, the per-slot kernel's split
    arithmetic);
    ``chunk_bytes`` is what one pool chunk of one kv head holds (rows and,
    for the quant codecs and bitmap-q8, scales)."""

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
        if codec in QUANT_BITS:
            # every int16 bit pattern is a valid set of int8 or int4 codes;
            # scales 0.002-0.02
            qc = qf.QuantCodec(256, 128, *QUANT_BITS[codec])
            rows = qc.stream_rows
            pool = torch.randint(-32768, 32768, (L, mc, BH, rows, 128), generator=g,
                                 device=dev, dtype=torch.int32).to(torch.int16)
            scales = (0.002 + 0.018 * torch.rand((L, mc, BH, 2, 128), generator=g,
                                                 device=dev)).to(torch.bfloat16)
            self.chunk_bytes = rows * 128 * 2 + 2 * 128 * 2
            self.fns = {"decode": qa.fused_q_decode_attention,
                        "decode_ps": qa.fused_q_decode_attention_ps,
                        "segment": qa.fused_q_segment_attention}
            self.decode = lambda q, nc, wl, li: qa.fused_q_decode_attention(
                q, pool, scales, kw, vw, nc, wl, li, qc)
            self.decode_plain = lambda q, nc, wl, li: qa.fused_q_decode_attention_plain(
                q, pool, scales, kw, vw, nc, wl, li, qc)
            self.decode_ps = lambda q, nc, wl, li: qa.fused_q_decode_attention_ps(
                q, pool, scales, kw, vw, nc, wl, li, qc)
            self.decode_ps_plain = lambda q, nc, wl, li: \
                qa.fused_q_decode_attention_ps_plain(q, pool, scales, kw, vw, nc, wl, li,
                                                     qc)
            self.decode_ps_split_plain = lambda q, nc, wl, li: \
                qa.fused_q_decode_attention_ps_split_plain(q, pool, scales, kw, vw, nc, wl,
                                                           li, qc)
            self.segment = lambda q, nc, li: qa.fused_q_segment_attention(
                q, pool, scales, nc, nc * 256, li, qc)
            self.segment_plain = lambda q, nc, li: qa.fused_q_segment_attention_plain(
                q, pool, scales, nc, li, qc)
            return
        # bitmap codecs: real packed chunks, random bf16 K and V pruned to
        # the format's keep (and quantized, bitmap-q8) and encoded on the
        # card (a stream of random bits would not hold the format's popcounts)
        qbits = 8 if codec == "bitmap-q8" else 16
        fmt = self.fmt = sf.ChunkFormat(256, 128, 128 - int(sparsity * 128) + 1,
                                        qbits=qbits)
        pool = torch.empty((L, mc, BH, 2 * fmt.stream_rows, 128), dtype=torch.int16,
                           device=dev)
        scales = (torch.empty((L, mc, BH, 2, 128), dtype=torch.bfloat16, device=dev)
                  if qbits == 8 else None)
        for li in range(L):
            x = torch.randn((mc, 2, BH, 256, 128), generator=g, device=dev)
            if qbits == 8:
                rows, sc = sf.prune_and_encode_stream_q8(x.to(torch.bfloat16), fmt)
                scales[li] = sc.to(torch.bfloat16).transpose(1, 2)   # [mc, BH, 2, 128]
            else:
                rows = sf.prune_and_encode_stream(x.to(torch.bfloat16), fmt)
            pool[li] = torch.cat([rows[:, 0], rows[:, 1]], dim=-2)
        self.chunk_bytes = 2 * fmt.stream_rows * 128 * 2 + (2 * 128 * 2 if qbits == 8 else 0)
        self.fns = {"decode": ska.fused_sparse_decode_attention,
                    "decode_ps": ska.fused_sparse_decode_attention_ps,
                    "segment": ska.fused_sparse_segment_attention}
        sc = {"kv_scales": scales}
        self.decode = lambda q, nc, wl, li: ska.fused_sparse_decode_attention(
            q, pool, kw, vw, nc, wl, li, fmt, fmt, **sc)
        self.decode_plain = lambda q, nc, wl, li: ska.fused_sparse_decode_attention_plain(
            q, pool, kw, vw, nc, wl, li, fmt, fmt, scales)
        self.decode_ps = lambda q, nc, wl, li: ska.fused_sparse_decode_attention_ps(
            q, pool, kw, vw, nc, wl, li, fmt, fmt, **sc)
        self.decode_ps_plain = lambda q, nc, wl, li: \
            ska.fused_sparse_decode_attention_ps_plain(q, pool, kw, vw, nc, wl, li, fmt,
                                                       fmt, scales)
        self.decode_ps_split_plain = lambda q, nc, wl, li: \
            ska.fused_sparse_decode_attention_ps_split_plain(q, pool, kw, vw, nc, wl, li,
                                                             fmt, fmt, scales)
        self.segment = lambda q, nc, li: ska.fused_sparse_segment_attention(
            q, pool, nc, nc * 256, li, fmt, fmt, **sc)
        self.segment_plain = lambda q, nc, li: ska.fused_sparse_segment_attention_plain(
            q, pool, nc, li, fmt, fmt, scales)


# the kernels line's fixed fields, by codec family and kernel
KERNEL_META = {
    ("quant", "decode"): ("fused_q_decode_attention", "q_decode.cu",
                          "quant_attention.py:223"),
    ("quant", "decode_ps"): ("fused_q_decode_attention_ps", "q_decode_ps.cu",
                             "quant_attention.py:516"),
    ("quant", "segment"): ("fused_q_segment_attention", "q_segment.cu",
                           "quant_attention.py:704"),
    ("quant", "pack"): ("prune_quant_pack", "prune_quant_pack.cu", "pack_kernel.py:101"),
    ("bitmap", "decode"): ("fused_sparse_decode_attention", "sp_decode.cu",
                           "sparse_attention.py:896"),
    ("bitmap", "decode_ps"): ("fused_sparse_decode_attention_ps", "sp_decode.cu",
                              "sparse_attention.py:417"),
    ("bitmap", "segment"): ("fused_sparse_segment_attention", "sp_segment.cu",
                            "sparse_attention.py:647"),
    ("w4", "matmul"): ("w4_matmul", "w4_matmul.cu", "w4_matmul.py:87"),
    ("dense", "decode"): ("flash_decode_attention", "dense_decode.cu", "dense_decode.py:92"),
    # the archive's names are prefixed: its v2 shares the production name
    ("archive", "key_scores"): ("archive.sparse_key_scores", "sp_archive_spmv.cu",
                                "sparse_attention_archive.py:98"),
    ("archive", "value_combine"): ("archive.sparse_value_combine", "sp_archive_spmv.cu",
                                   "sparse_attention_archive.py:158"),
    ("archive", "v2"): ("archive.fused_sparse_decode_attention", "sp_archive_fused.cu",
                        "sparse_attention_archive.py:314"),
    ("archive", "v3"): ("archive.fused_sparse_decode_attention_v3", "sp_archive_fused.cu",
                        "sparse_attention_archive.py:491"),
    ("archive", "v4"): ("archive.fused_sparse_decode_attention_v4", "sp_archive_stream.cu",
                        "sparse_attention_archive.py:630"),
    ("archive", "v5"): ("archive.fused_sparse_decode_attention_v5", "sp_archive_stream.cu",
                        "sparse_attention_archive.py:785"),
    ("archive", "v6"): ("archive.fused_sparse_decode_attention_v6", "sp_archive_stream.cu",
                        "sparse_attention_archive.py:916"),
}


def _family(codec):
    return ("quant" if codec in QUANT_BITS
            else "bitmap" if codec.startswith("bitmap") else codec)


def _meta(codec, kind):
    return KERNEL_META[(_family(codec), kind)]


def _phase_label(base, codec):
    """The phase's name: ``kernel``... for q8q4 (the names of earlier runs),
    ``kernel_sp``... for bitmap (``_q8`` after it for bitmap-q8),
    ``kernel..._q8`` / ``_q4q4`` else."""
    if codec == "q8q4":
        return base
    if codec.startswith("bitmap"):
        return base.replace("kernel", "kernel_sp", 1) + ("_q8" if codec == "bitmap-q8"
                                                         else "")
    return f"{base}_{codec}"


def _entry(codec, kind, results, worst, tol, kernel_ms, plain_ms, bytes_ms, flops_ms):
    name, src, tpu = _meta(codec, kind)
    return {"name": name, "route": "cuda", "source": f"mustafar_tpu_torch/csrc/{src}",
            "replaces": f"mustafar_tpu/ops/kernels/{tpu}", "launches": None,
            "max_abs_err": max(r.get("max_abs_err", 0.0) for r in results),
            "tol": tol, "worst_err_over_tol": worst,
            "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "library_ms": None, "library_note": NO_LIBRARY.get(_family(codec))}


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
            for sp in ((0.7,) if codec in QUANT_BITS else (0.7, 0.5))]
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
    emit(_phase_label("kernel", codec), codec=codec,
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
    lighter mix of earlier runs (0-5 chunks).  Every codec's kernel
    (split-K) is also held to its split plain version (``split_gate``) and
    must refuse short scratch."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    B, Hkv, L, mc, W, D = 8, 8, 4, 32, 288, 128
    BH = B * Hkv
    kits = [_Kit(codec, g, dev, L, mc, BH, W, sp)
            for sp in ((0.7,) if codec in QUANT_BITS else (0.7, 0.5))]
    slots = [(0, 0), (0, 1), (1, 44), (2, 288), (5, 288), (5, 1), (1, 0), (31, 288)]
    light = slots[:-1] + [(2, 44)]          # the slots timed before mc = 32

    def counts(sl):
        return (torch.tensor([c for c, _ in sl], dtype=torch.int32, device=dev),
                torch.tensor([w for _, w in sl], dtype=torch.int32, device=dev))

    nc, wl = counts(slots)
    fn = kits[0].fns["decode_ps"]
    launches0 = fn.launches
    results, worst, worst_split = [], 0.0, 0.0
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
                    # the kernel's own arithmetic: splits merged
                    ratio = split_gate(got, kit.decode_ps_split_plain(
                        qq.float(), nc, wl, li), live)
                    results[-1]["worst_err_over_tol_split"] = ratio
                    if not ratio <= 1.0:
                        raise AssertionError(f"per-slot kernel disagrees with its "
                                             f"split plain version: {results[-1]}")
                    worst_split = max(worst_split, ratio)

    # time at the serving shape (G=4), the mixed slots above, L2 flushed
    kit = kits[0]
    q = torch.randn((B, 1, Hkv * 4, D), generator=g, device=dev).to(torch.bfloat16)
    if not refuses_short_scratch(lambda: kit.decode_ps(q, nc, wl, 0)):
        raise AssertionError("per-slot kernel took scratch shorter than its grid needs")
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
    emit(_phase_label("kernel_ps", codec), codec=codec,
         shapes={"B": B, "Hq": 4 * Hkv, "Hkv": Hkv, "L": L, "mc": mc, "W": W},
         slots=slots, cases=results, worst_err_over_tol=worst,
         worst_err_over_tol_split=worst_split, kernel_ms=kernel_ms,
         kernel_ms_light_slots=light_ms, light_slots=light, plain_ms=plain_ms,
         host_behind=behind, wrapper_host_us=wrapper_us, timed_at={"sparsity": kit.sparsity}, bytes=nbytes,
         flops=flops, bound_ms=max(bytes_ms, flops_ms), library_ms=None)
    entry = _entry(codec, "decode_ps", results, worst,
                   "per slot: 2 bf16 ulps of the slot's largest output",
                   kernel_ms, plain_ms, bytes_ms, flops_ms)
    entry.update(worst_err_over_tol_split=worst_split, tol_split=SPLIT_TOL_NOTE)
    return entry


def segment_clusters(fmt, T, G):
    """The bitmap segment kernel's clusters at T query tokens of G heads a
    kv head (``segment_grid``) and how many of them the card holds at once
    (``cudaOccupancyMaxActiveClusters`` for the format's shared memory)."""
    import ctypes
    import torch
    from mustafar_tpu_torch.ops.kernels import build
    from mustafar_tpu_torch.ops.kernels import sparse_attention as ska
    cluster, tiles = ska.segment_grid(T, G)
    fn = build.load("sp_segment").sp_segment_max_clusters
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 7
    fn.restype = ctypes.c_int
    n = ctypes.c_int(-1)
    rc = fn(ctypes.byref(n), torch.cuda.current_device(), fmt.qbits, *ska._segs(fmt),
            *ska._segs(fmt), cluster)
    if rc != 0:
        raise RuntimeError(f"sp_segment_max_clusters failed: CUDA error {rc}")
    return {"cluster": cluster, "row_tiles": tiles, "max_active_clusters": n.value}


def phase_kernel_seg(codec="q8q4"):
    """Segment kernel vs its plain version: Tseg=256, Hq=32 over Hkv=8
    (G=4), B = 1 and 2, n_chunks 0/1/4/31 (the bitmap codec at sparsity 0.7
    and, at B=1, 0.5); timed at the serving shape of the longest prompt's
    last segment (B=1, 31 chunks).  The bitmap codecs' kernel runs as
    thread block clusters: their size and how many the card holds at once
    go beside its time."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    Hq, Hkv, T, L, mc, D = 32, 8, 256, 2, 32, 128
    fn = None
    results, worst = [], 0.0
    kits = {}
    runs = [(1, 0.7), (2, 0.7)] + ([] if codec in QUANT_BITS else [(1, 0.5)])
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
    # the same inputs launched twice give the same bits
    first, again = kit.segment(q, nc, 0), kit.segment(q, nc, 0)
    same_bits = all(torch.equal(a, b) for a, b in zip(first, again))
    if not same_bits:
        raise AssertionError("segment kernel: a second launch on the same inputs "
                             "gave other bits")
    BH, QR = B * Hkv, T * Hq // Hkv

    def bounds(n):
        flops = 4 * BH * QR * n * 256 * D                    # scores + p.v, mul + add
        nbytes = (BH * n * kit.chunk_bytes                   # pools
                  + q.numel() * 2 + B * T * Hq * (D + 2) * 4)   # q in; acc, m, l out
        return flops, nbytes, nbytes / H100_BYTES_PER_S * 1e3, flops / H100_BF16_FLOPS * 1e3

    # the quant codecs at the chunk counts serve_cb launches them at
    by_chunks = {}
    for n in ((1, 4, 16) if codec in QUANT_BITS else ()):
        for _ in range(3):
            kit.segment(q, n, 0)
        torch.cuda.synchronize()
        ms, _ = cuda_ms(lambda: kit.segment(q, n, 0), 20)
        _, _, b_ms, f_ms = bounds(n)
        by_chunks[n] = {"kernel_ms": ms, "bound_ms": max(b_ms, f_ms),
                        "share_of_bound": max(b_ms, f_ms) / ms}
    for _ in range(3):
        kit.segment(q, nc, 0)
    torch.cuda.synchronize()
    kernel_ms, behind = cuda_ms(lambda: kit.segment(q, nc, 0), 20)
    plain_ms, _ = cuda_ms(lambda: kit.segment_plain(q, nc, 0), 3, spin=False)
    wrapper_us = host_us(lambda: kit.segment(q, nc, 0), 20)
    flops, nbytes, bytes_ms, flops_ms = bounds(nc)
    if by_chunks:
        by_chunks[nc] = {"kernel_ms": kernel_ms, "bound_ms": max(bytes_ms, flops_ms),
                         "share_of_bound": max(bytes_ms, flops_ms) / kernel_ms}
    fn.launches = launches0
    clusters = (segment_clusters(kit.fmt, T, Hq // Hkv) if _family(codec) == "bitmap"
                else None)
    emit(_phase_label("kernel_seg", codec), codec=codec,
         shapes={"Tseg": T, "Hq": Hq, "Hkv": Hkv, "L": L, "mc": mc},
         cases=results, worst_err_over_tol=worst, clusters=clusters,
         timed_at={"B": B, "n_chunks": nc, "sparsity": kit.sparsity},
         kernel_ms=kernel_ms, plain_ms=plain_ms, host_behind=behind,
         wrapper_host_us=wrapper_us, second_launch_same_bits=same_bits,
         kernel_ms_by_chunks=by_chunks or None,
         flops=flops, bytes=nbytes,
         bound_ms=max(bytes_ms, flops_ms), library_ms=None)
    entry = _entry(codec, "segment", results, worst,
                   max(r.get("tol", 0.0) for r in results),
                   kernel_ms, plain_ms, bytes_ms, flops_ms)
    if clusters is not None:
        entry["clusters"] = clusters
    if by_chunks:
        entry["kernel_ms_by_chunks"] = by_chunks
    return entry


PACK_NO_LIBRARY = ("no single PyTorch call computes an exact top-k with ties to the "
                   "lower channel plus quantize plus pack (torch.topk orders ties "
                   "arbitrarily)")


def phase_kernel_pack():
    """Kernel 9 against its plain version on the card, bit-equal (rows and
    scales, zero tolerance): B*Hkv = 64 and 8 head-chunks of C = 256, bits 8
    and 4, keep 40 (sparsity 0.7), 14 and 128, with injected ties (channel
    10 = channel 90, a row of equal magnitudes, a row of two values), an
    all-zero row and, at 64, the f32 score option; also the cache's strided
    case (a [B, T, Hkv, 128] prompt slice in, the pool slot's K rows and the
    scales' K column out).  Timed L2-flushed at the serving shapes (64
    head-chunks, K at 8 bits and V at 4, keep 40; 8 head-chunks for the
    engine's B=1 segment; and at keep 128, which skips the bisection) beside
    the byte bound and the plain chain."""
    import torch
    from mustafar_tpu_torch.ops.kernels import pack_kernel as pk
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    C, D = 256, 128
    fn = pk.prune_quant_pack
    launches0 = fn.launches

    def chunk(BH):
        x = (0.3 * torch.randn((BH, C, D), generator=g, device=dev)).to(torch.bfloat16)
        x[:, :, 10] = x[:, :, 90]                    # ties across channels
        x[:, 5, :] = 0                                # an all-zero row
        x[:, 7, :] = 0.5                              # a row of equal magnitudes
        x[:, 9, :] = torch.where(torch.arange(D, device=dev) % 2 == 0, 0.25, -0.75)
        return x

    results = []

    def check(label, x, keep, bits, score=None, rows_out=None, scales_out=None):
        got = fn(x, keep, bits, score, rows_out=rows_out, scales_out=scales_out)
        torch.cuda.synchronize()
        want = pk.prune_quant_pack_plain(x, keep, bits, score)
        rows_eq = torch.equal(got[0], want[0])
        sc_eq = torch.equal(got[1].view(torch.int16), want[1].view(torch.int16))
        diff = int((got[0] != want[0]).sum()) + int((got[1] != want[1]).sum())
        results.append({"case": label, "keep": keep, "bits": bits,
                        "score": score is not None, "rows_equal": rows_eq,
                        "scales_equal": sc_eq, "elements_differing": diff})
        if not (rows_eq and sc_eq):
            raise AssertionError(f"prune_quant_pack disagrees with its plain version: "
                                 f"{results[-1]}")

    for BH in (64, 8):
        x = chunk(BH)
        score = torch.rand((BH, C, D), generator=g, device=dev)
        for bits in (8, 4):
            for keep in (40, 14, 128):
                check(f"BH={BH}", x, keep, bits)
            if BH == 64:
                check(f"BH={BH}", x, 40, bits, score)
    # the cache's layouts: a prompt slice [B, Hkv, C, D] (strides of
    # [B, T, Hkv, D]) into the pool slot's K rows and the scales' K column
    B, Hkv, T = 8, 8, 512
    k = (0.3 * torch.randn((B, T, Hkv, D), generator=g, device=dev)).to(torch.bfloat16)
    kh = k.transpose(1, 2)[:, :, 256:512]
    pool = torch.zeros((B, Hkv, 192, D), dtype=torch.int16, device=dev)
    sc = torch.zeros((B, Hkv, 2, D), dtype=torch.bfloat16, device=dev)
    check("strided", kh, 40, 8, rows_out=pool[:, :, :128], scales_out=sc[:, :, 0])
    if not ((pool[:, :, 128:] == 0).all() and (sc[:, :, 1] == 0).all()):
        raise AssertionError("prune_quant_pack wrote outside its output views")

    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    timed = {}
    # keep 128 skips the bisection: the difference is its share
    for BH, bits, keep in ((64, 8, 40), (64, 4, 40), (8, 8, 40), (64, 8, 128)):
        x = chunk(BH)
        for _ in range(5):
            fn(x, keep, bits)
        torch.cuda.synchronize()
        kernel_ms, behind = cuda_ms(lambda: fn(x, keep, bits), 50, flush=flush_buf.zero_)
        plain_ms, _ = cuda_ms(lambda: pk.prune_quant_pack_plain(x, keep, bits), 5,
                              flush=flush_buf.zero_, spin=False)
        nbytes = BH * C * D * 2 + BH * (C * bits // 16) * D * 2 + BH * D * 2
        bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
        timed[f"BH{BH}_bits{bits}" + ("" if keep == 40 else f"_keep{keep}")] = {
            "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bytes_ms,
            "bytes": nbytes, "host_behind": behind,
            "wrapper_host_us": host_us(lambda: fn(x, keep, bits), 50)}
    fn.launches = launches0                               # comparisons do not count
    emit("kernel_pack", C=C, cases=results, timed=timed, library_ms=None,
         library_note=PACK_NO_LIBRARY)
    t = timed["BH64_bits8"]
    entry = _entry("q8q4", "pack", results, 0.0, "bit-equal (rows and scales)",
                   t["kernel_ms"], t["plain_ms"], t["bound_ms"], 0.0)
    entry.update(max_abs_err=0.0, timed_at="B*Hkv=64, C=256, K at 8 bits, keep 40",
                 library_note=PACK_NO_LIBRARY)
    return entry


# every Llama-3-8B projection (wk and wv share 4096 -> 1024, w_gate and w_up
# 4096 -> 14336) and the fused wqkv and w_gateup
W4_SHAPES = {"wq_wo": (4096, 4096), "wk_wv": (4096, 1024), "w_gate_up": (4096, 14336),
             "w_down": (14336, 4096), "wqkv": (4096, 6144), "w_gateup": (4096, 28672)}
W4_NO_LIBRARY = ("no PyTorch call takes these carriers: torch._weight_int4pack_mm "
                 "wants its own tile layout and zero points")


def phase_kernel_w4():
    """The W4 kernel against its plain version on the card at every
    projection shape of the 8B (and the fused ones), T = 8 and 32, layer 1
    of 2-layer stacks of random carriers (every int16 is a valid code set)
    and bf16 scales 0.001-0.021; also T = 1, 13, 100, 128 and f32 x at one
    shape.  Each timed L2-flushed (a layer's weights are read once a
    step) beside its byte bound, the plain version, the wrapper's host
    time, the W8 ``proj`` and a bf16 ``torch.matmul`` at the same shape."""
    import torch
    from mustafar_tpu_torch.models.quant import proj
    from mustafar_tpu_torch.ops.kernels import w4_matmul as w4
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    launches0 = w4.w4_matmul.launches
    results, worst, timed = [], 0.0, {}

    def check(label, x, c, s, T):
        got = w4.w4_matmul(x, c[1], s[1])
        again = w4.w4_matmul(x, c[1], s[1])
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"w4_matmul: a second launch on the same inputs gave "
                                 f"other bits ({label}, T={T})")
        want = w4.w4_matmul_plain(x, c[1], s[1])
        err = (got.float() - want.float()).abs().max().item()
        # f32 sums of the same exact products in another order; each rounds
        # once to the output's type: 2 bf16 ulps of the output's scale
        tol = KERNEL_TOL_ULPS * 2.0 ** -8 * want.float().abs().max().item()
        results.append({"shape": label, "T": T, "x_dtype": str(x.dtype).split(".")[-1],
                        "max_abs_err": err, "tol": tol})
        if not (got.isfinite().all() and got.dtype == x.dtype and err <= tol):
            raise AssertionError(f"w4_matmul disagrees with its plain version: {results[-1]}")
        return err / max(tol, 1e-30)

    for label, (din, dout) in W4_SHAPES.items():
        c = torch.randint(-32768, 32768, (2, din // 4, dout), generator=g, device=dev,
                          dtype=torch.int32).to(torch.int16)
        s = (0.001 + 0.02 * torch.rand((2, din // 128, dout), generator=g,
                                       device=dev)).to(torch.bfloat16)
        ts = (8, 32) + ((1, 13, 100, 128) if label == "wq_wo" else ())
        for T in ts:
            x = torch.randn((T, din), generator=g, device=dev).to(torch.bfloat16)
            worst = max(worst, check(label, x, c, s, T))
            if label == "wq_wo" and T == 13:
                worst = max(worst, check(label, x.float(), c, s, T))
                if not refuses_short_workspace(lambda: w4.w4_matmul(x, c[1], s[1])):
                    raise AssertionError("w4_matmul did not refuse a short workspace")
        # W8 and bf16 weights of the same shape, for context
        w8 = {"w": torch.randint(-127, 128, (din, dout), generator=g, device=dev,
                                 dtype=torch.int32).to(torch.int8),
              "w_scale": torch.rand((dout,), generator=g, device=dev) * 0.01}
        wbf = torch.randn((din, dout), generator=g, device=dev).to(torch.bfloat16)
        for T in (8, 32):
            x = torch.randn((T, din), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(3):
                w4.w4_matmul(x, c[1], s[1])
                proj(x, w8, "w")
            torch.cuda.synchronize()
            kernel_ms, behind = cuda_ms(lambda: w4.w4_matmul(x, c[1], s[1]), 30,
                                        flush=flush_buf.zero_)
            plain_ms, _ = cuda_ms(lambda: w4.w4_matmul_plain(x, c[1], s[1]), 3,
                                  flush=flush_buf.zero_, spin=False)
            w8_ms, _ = cuda_ms(lambda: proj(x, w8, "w"), 10, flush=flush_buf.zero_)
            bf16_ms, _ = cuda_ms(lambda: x @ wbf, 10, flush=flush_buf.zero_)
            nbytes = din * dout // 2 + din // 128 * dout * 2 + T * (din + dout) * 2
            flops = 2 * T * din * dout                      # bf16 tensor-core products
            bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
            flops_ms = flops / H100_BF16_FLOPS * 1e3
            part = w4.partition(T, din, dout, w4._sms(torch.cuda.current_device()))
            timed[f"{label}_T{T}"] = {
                "din": din, "dout": dout, "T": T, "kernel_ms": kernel_ms,
                "bound_ms": max(bytes_ms, flops_ms), "bytes_ms": bytes_ms,
                "flops_ms": flops_ms, "share_of_bound": bytes_ms / kernel_ms,
                "bytes": nbytes, "plain_ms": plain_ms, "w8_proj_ms": w8_ms,
                "bf16_matmul_ms": bf16_ms, "host_behind": behind,
                "wrapper_host_us": host_us(lambda: w4.w4_matmul(x, c[1], s[1]), 50),
                "ctas": part.ctas, "units": part.units}
        del c, s, w8, wbf
    w4.w4_matmul.launches = launches0                    # comparisons do not count
    emit("kernel_w4", cases=results, worst_err_over_tol=worst, timed=timed,
         library_ms=None, library_note=W4_NO_LIBRARY)
    # the kernels line: the decode shape of the largest projection (w_gate / w_up, T=8)
    t = timed["w_gate_up_T8"]
    entry = _entry("w4", "matmul", results, worst, max(r["tol"] for r in results),
                   t["kernel_ms"], t["plain_ms"], t["bytes_ms"], t["flops_ms"])
    entry.update(timed_at="4096 x 14336, T=8", library_note=W4_NO_LIBRARY)
    return entry


def _sdpa_ms(q, k, v, pos, flush):
    """The library call for the same function: ``scaled_dot_product_attention``
    with GQA and a boolean mask of each slot's rows [0, pos[b]]; returns
    (its device ms, the backend PyTorch picked, its output)."""
    import torch
    import torch.nn.functional as F
    B, S = k.shape[:2]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(S, device=q.device)[None, :] <= pos[:, None])[:, None, None, :]
    backend = "unknown"
    if hasattr(torch, "_fused_sdp_choice"):
        from torch.nn.attention import SDPBackend
        backend = SDPBackend(torch._fused_sdp_choice(qt, kt, vt, mask, 0.0, False,
                                                     enable_gqa=True)).name

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)

    out = call()
    torch.cuda.synchronize()
    return cuda_ms(call, 20, flush=flush)[0], backend, out.transpose(1, 2)


def phase_kernel_dense():
    """The dense flash-decode kernel against its plain version: uniform at
    ``serve_dense``'s shape (B=8, S=1,312, pos 599, Hkv=8, G=4) and per slot
    at ``serve_cb``'s cache (S=8,448) with a slot at pos 8,000, an idle slot
    and six of 45-1,499; also G = 1, 2, 8 and f32 q; held to the TPU-order
    plain version at 2 bf16 ulps of each slot's largest output and to the
    split plain version (the kernel's own arithmetic) by ``split_gate``;
    short scratch must be refused.  Timed
    L2-flushed beside its byte bound, the plain version and
    ``scaled_dot_product_attention`` (GQA, boolean mask), both cases."""
    import torch
    from mustafar_tpu_torch.ops.kernels import dense_decode as dd
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    fn = dd.flash_decode_attention
    launches0 = fn.launches
    B, Hkv, D = 8, 8, 128
    shapes, results, worst, worst_split = {}, [], 0.0, 0.0
    cases = {"uniform": (1312, 599),
             "per_slot": (8448, [8000, 1210, 300, -1, 640, 1499, 45, 950])}
    for label, (S, pos) in cases.items():
        k = torch.randn((B, S, Hkv, D), generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn((B, S, Hkv, D), generator=g, device=dev).to(torch.bfloat16)
        kpos = (torch.tensor(pos, dtype=torch.int32, device=dev) if isinstance(pos, list)
                else pos)
        slot_pos = kpos if torch.is_tensor(kpos) else torch.full((B,), pos, device=dev)
        for G in (4, 1, 2, 8):
            qb = torch.randn((B, 1, Hkv * G, D), generator=g, device=dev).to(torch.bfloat16)
            for q in ((qb, qb.float()) if G == 4 else (qb,)):
                got = fn(q, k, v, kpos)
                torch.cuda.synchronize()
                want = dd.flash_decode_attention_plain(q, k, v, kpos)
                # each slot held to 2 bf16 ulps of its own output's scale
                dims = (1, 2, 3)
                errs = (got.float() - want.float()).abs().amax(dim=dims)
                tols = KERNEL_TOL_ULPS * 2.0 ** -8 * want.float().abs().amax(dim=dims)
                live = slot_pos >= 0
                ratio = (errs[live] / tols[live].clamp_min(1e-30)).max().item()
                idle_zero = bool((got[~live] == 0).all())
                results.append({"case": label, "G": G, "q_dtype": str(q.dtype).split(".")[-1],
                                "max_abs_err": errs.max().item(),
                                "worst_err_over_tol": ratio, "idle_slots_zero": idle_zero})
                if not (got.isfinite().all() and ratio <= 1.0 and idle_zero):
                    raise AssertionError(f"dense decode kernel disagrees with its plain "
                                         f"version: {results[-1]}")
                worst = max(worst, ratio)
                ratio = split_gate(got, dd.flash_decode_attention_split_plain(
                    q.float(), k, v, kpos), live)
                results[-1]["worst_err_over_tol_split"] = ratio
                if not ratio <= 1.0:
                    raise AssertionError(f"dense decode kernel disagrees with its split "
                                         f"plain version: {results[-1]}")
                worst_split = max(worst_split, ratio)
        q = torch.randn((B, 1, Hkv * 4, D), generator=g, device=dev).to(torch.bfloat16)
        if not refuses_short_scratch(lambda: fn(q, k, v, kpos)):
            raise AssertionError(f"dense decode kernel took scratch shorter than its "
                                 f"grid needs ({label})")
        for _ in range(5):
            fn(q, k, v, kpos)
        torch.cuda.synchronize()
        kernel_ms, behind = cuda_ms(lambda: fn(q, k, v, kpos), 50, flush=flush_buf.zero_)
        plain_ms, _ = cuda_ms(lambda: dd.flash_decode_attention_plain(q, k, v, kpos), 3,
                              flush=flush_buf.zero_, spin=False)
        lib_ms, backend, lib_out = _sdpa_ms(q, k, v, slot_pos, flush_buf.zero_)
        live = slot_pos >= 0
        lib_err = (lib_out[live].float() - fn(q, k, v, kpos)[live].float()).abs().max().item()
        n_tok = int((slot_pos + 1).clamp(min=0).sum())
        nbytes = n_tok * Hkv * D * 2 * 2 + 2 * q.numel() * 2 + (4 * B if label == "per_slot" else 0)
        flops = n_tok * Hkv * 4 * D * 2 * 2                 # scores + p.v, G = 4
        bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
        flops_ms = flops / H100_F32_FLOPS * 1e3
        shapes[label] = {"S": S, "pos": pos, "kernel_ms": kernel_ms, "host_behind": behind,
                         "bound_ms": max(bytes_ms, flops_ms), "bytes_ms": bytes_ms,
                         "flops_ms": flops_ms, "bytes": nbytes, "flops": flops, "plain_ms": plain_ms,
                         "library_ms": lib_ms, "library_backend": backend,
                         "library_max_abs_diff": lib_err, "tile": dd.decode_tile(S),
                         "split_len": dd.split_len(dd._covered(kpos, S), B * Hkv,
                                                   dd._sms(q.device)),
                         "wrapper_host_us": host_us(lambda: fn(q, k, v, kpos), 50)}
        del k, v
    fn.launches = launches0                                # comparisons do not count
    emit("kernel_dense", B=B, Hkv=Hkv, cases=results, worst_err_over_tol=worst,
         worst_err_over_tol_split=worst_split, timed=shapes)
    t = shapes["uniform"]
    entry = _entry("dense", "decode", results, worst,
                   "per slot: 2 bf16 ulps of the slot's largest output", t["kernel_ms"],
                   t["plain_ms"], t["bytes_ms"], t["flops_ms"])
    p = shapes["per_slot"]
    entry.update(timed_at="B=8, S=1312, pos 599, Hkv=8, G=4", library_ms=t["library_ms"],
                 library_note=f"scaled_dot_product_attention, GQA, boolean mask "
                              f"({t['library_backend']} backend)",
                 worst_err_over_tol_split=worst_split, tol_split=SPLIT_TOL_NOTE,
                 per_slot={"timed_at": "B=8, S=8448, pos 8000 / 1210 / 300 / -1 / 640 / "
                                       "1499 / 45 / 950, Hkv=8, G=4",
                           **{k: p[k] for k in ("kernel_ms", "bound_ms", "plain_ms",
                                                "library_ms")}})
    return entry


# ---------------------------------------------------------------------------
# The archived generations: v1-v3 over split pools (TPU kernels 10-13), v4-v6
# over the fused stream (kernels 14-16)
# ---------------------------------------------------------------------------

ARCHIVE_KINDS = ("key_scores", "value_combine", "v2", "v3", "v4", "v5", "v6")
ARCHIVE_WINDOWS = (300, 600)     # v6's sliding windows, checked at 5 chunks
ARCHIVE_CASES = ((0, 44), (1, 288), (2, 1), (5, 288), (5, 0))   # (n_chunks, win_len)
SCORES_RTOL = 1e-5   # kernel 10: f32 sums of 128 exact bf16 products in two orders


def _archive_pools(x, fmt):
    """Dense chunks x [2 (K, V), BH, mc, 256, 128] pruned and packed on the
    card: "head" ((k_segs, k_bmp), (v_segs, v_bmp)) head-major for v1 and
    v2, "chunk" the chunk-major copy for v3, "stream" the same chunks as
    kernel 6's fused pool [1, mc, BH, KR + VR, 128]."""
    import torch
    from mustafar_tpu_torch.ops import sparse_format as sf
    BH = x.shape[1]
    segs, bmp = sf.prune_and_encode_chunk(x, fmt)     # [2, BH, mc, R_i | 8, 128]
    head = tuple(([s[st].reshape(BH, -1, 128) for s in segs], bmp[st].reshape(BH, -1, 128))
                 for st in range(2))
    chunk = tuple(([s[st].transpose(0, 1).contiguous() for s in segs],
                   bmp[st].transpose(0, 1).contiguous()) for st in range(2))
    rows = sf.prune_and_encode_stream(x, fmt)         # [2, BH, mc, SR, 128]
    stream = torch.cat([rows[0], rows[1]], dim=-2).transpose(0, 1).contiguous()[None]
    return {"head": head, "chunk": chunk, "stream": stream}


def _archive_calls(pools, q, kw, vw, nc, wl, fmt, mc):
    """The generations' wrappers (v1-v6 and kernel 6) on one set of pools
    and windows [B, W, Hkv, 128], and their plain versions; v4-v6 read the
    stream pool's layer view ``pools["stream"][0]``."""
    from mustafar_tpu_torch.ops.kernels import sparse_attention as ska
    from mustafar_tpu_torch.ops.kernels import sparse_attention_archive as sar
    (ks, kb), (vs, vb) = pools["head"]
    (cks, ckb), (cvs, cvb) = pools["chunk"]
    B, W, Hkv, D = kw.shape
    kw6 = kw.permute(0, 2, 1, 3).reshape(1, B * Hkv, W, D).contiguous()
    vw6 = vw.permute(0, 2, 1, 3).reshape(1, B * Hkv, W, D).contiguous()
    head = (ks, kb, vs, vb, kw, vw, nc, wl, fmt, fmt, mc)
    chunk = (cks, ckb, cvs, cvb, kw, vw, nc, wl, fmt, fmt, mc)
    k6 = (pools["stream"], kw6, vw6, nc, wl, 0, fmt, fmt)
    st = (pools["stream"][0], kw, vw, nc, wl, fmt, fmt, mc)
    return {
        "v1": (lambda: sar.sparse_decode_attention(q, *head),
               lambda: sar.sparse_decode_attention_plain(q, *head)),
        "v2": (lambda: sar.fused_sparse_decode_attention(q, *head),
               lambda: sar.fused_sparse_decode_attention_plain(q, *head)),
        "v3": (lambda: sar.fused_sparse_decode_attention_v3(q, *chunk),
               lambda: sar.fused_sparse_decode_attention_v3_plain(q, *chunk)),
        "v4": (lambda: sar.fused_sparse_decode_attention_v4(q, *st),
               lambda: sar.fused_sparse_decode_attention_v4_plain(q, *st)),
        "v5": (lambda: sar.fused_sparse_decode_attention_v5(q, *st),
               lambda: sar.fused_sparse_decode_attention_v5_plain(q, *st)),
        "v6": (lambda: sar.fused_sparse_decode_attention_v6(q, *st),
               lambda: sar.fused_sparse_decode_attention_v6_plain(q, *st)),
        "kernel6": (lambda: ska.fused_sparse_decode_attention(q, *k6),
                    lambda: ska.fused_sparse_decode_attention_plain(q, *k6)),
    }


def _check(results, worst, kind, got, want, tol, **case):
    """Record one kernel-against-plain comparison; raise past ``tol``."""
    err = (got.float() - want.float()).abs().max().item()
    results.append({"kernel": kind, **case, "max_abs_err": err, "tol": tol})
    if not (got.isfinite().all() and err <= tol):
        raise AssertionError(f"archive kernel disagrees with its plain version: "
                             f"{results[-1]}")
    worst[kind] = max(worst[kind], err / max(tol, 1e-30))


def _check_partials(results, worst, got, want, **case):
    """Kernel 16's partials (acc, m, l) against the plain ones: each within
    2 bf16 ulps of its largest magnitude, or exactly (0, -1e30, 0) where no
    chunk column is live."""
    if not bool((want[2] > 0).any()):
        exact = all(bool((t[0] == 0).all() and (t[1] == -1e30).all() and (t[2] == 0).all())
                    for t in (got, want))
        results.append({"kernel": "v6_partials", **case, "part": "none live",
                        "max_abs_err": 0.0, "tol": 0.0})
        if not exact:
            raise AssertionError(f"v6 partials with no live column are not (0, -1e30, 0): "
                                 f"{case}")
        return
    for part, a, b in zip(("acc", "m", "l"), got, want):
        _check(results, worst, "v6_partials", a, b,
               KERNEL_TOL_ULPS * 2.0 ** -8 * b.abs().max().item(), part=part, **case)


def _archive_ladder(g, dev, flush, B, mc, nc, W, wl, G):
    """Device ms (L2 flushed) of kernels 10 and 11, the v1 chain, v2-v5,
    kernel 16 alone, the whole v6 and kernel 6 at one shape, Hkv=8,
    sparsity 0.7, each beside its plain version's ms and its bound from
    these inputs' bytes and operations."""
    import torch
    from mustafar_tpu_torch.ops import sparse_format as sf
    from mustafar_tpu_torch.ops.kernels import sparse_attention_archive as sar
    Hkv, D = 8, 128
    BH = B * Hkv
    fmt = sf.ChunkFormat(256, 128, 40)
    bf = torch.bfloat16
    pools = _archive_pools(torch.randn((2, BH, mc, 256, D), generator=g, device=dev).to(bf),
                           fmt)
    q = torch.randn((B, 1, Hkv * G, D), generator=g, device=dev).to(bf)
    kw = torch.randn((B, W, Hkv, D), generator=g, device=dev).to(bf)
    vw = torch.randn((B, W, Hkv, D), generator=g, device=dev).to(bf)
    qpad = torch.zeros((BH, 8, D), dtype=bf, device=dev)
    qpad[:, :G] = q.reshape(BH, G, D)
    w = torch.zeros((BH, 8, mc * 256), dtype=bf, device=dev)
    w[:, :G, :nc * 256] = torch.rand((BH, G, nc * 256), generator=g, device=dev) / (nc * 256)
    (ks, kb), (vs, vb) = pools["head"]
    calls = {"key_scores": (lambda: sar.sparse_key_scores(qpad, ks, kb, nc, fmt, mc),
                            lambda: sar.sparse_key_scores_plain(qpad, ks, kb, nc, fmt, mc)),
             "value_combine": (lambda: sar.sparse_value_combine(w, vs, vb, nc, fmt, mc),
                               lambda: sar.sparse_value_combine_plain(w, vs, vb, nc, fmt,
                                                                      mc)),
             **_archive_calls(pools, q, kw, vw, nc, wl, fmt, mc)}
    sp = pools["stream"][0]
    calls["v6_kernel"] = (
        lambda: sar.fused_sparse_decode_attention_v6_partials(q, sp, nc, wl, fmt, fmt, mc),
        lambda: sar.fused_sparse_decode_attention_v6_partials_plain(q, sp, nc, wl, fmt, fmt))
    chunk_bytes = BH * nc * fmt.bytes_per_chunk                   # one stream
    spmv_flops = BH * 8 * nc * 256 * D * 2
    decode = (2 * chunk_bytes + BH * 2 * wl * D * 2 + 2 * q.numel() * 2,
              BH * G * (nc * 256 + wl) * D * 2 * 2)
    work = {"key_scores": (chunk_bytes + qpad.numel() * 2 + BH * 8 * mc * 256 * 4, spmv_flops),
            "value_combine": (chunk_bytes + BH * 8 * nc * 256 * 2 + BH * 8 * D * 4,
                              spmv_flops),
            "v1": decode, "v2": decode, "v3": decode, "v4": decode, "v5": decode,
            "v6": decode, "kernel6": decode,
            # the pools, q and the partials acc, m, l
            "v6_kernel": (2 * chunk_bytes + q.numel() * 2 + BH * G * (D + 2) * 4,
                          BH * G * nc * 256 * D * 2 * 2)}
    out = {}
    for name, (fn, plain) in calls.items():
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        ms, behind = cuda_ms(fn, 50, flush=flush)
        plain_ms, _ = cuda_ms(plain, 5, flush=flush, spin=False)
        nbytes, flops = work[name]
        bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
        flops_ms = flops / H100_F32_FLOPS * 1e3
        out[name] = {"cuda_ms": ms, "host_behind": behind, "plain_ms": plain_ms,
                     "bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms,
                     "flops_ms": flops_ms, "bound_ms": max(bytes_ms, flops_ms)}
    return {"shape": {"B": B, "Hkv": Hkv, "G": G, "mc": mc, "n_chunks": nc, "W": W,
                      "win_len": wl, "sparsity": 0.7}, "timed": out}


def phase_kernel_archive():
    """Kernels 10-16 against their plain versions on random chunks pruned
    and packed on the card (B=8, Hkv=8, mc=5, W=288; sparsity 0.7 and 0.5;
    G 1/2/4/8; (n_chunks, win_len) of ``ARCHIVE_CASES``), the v1 chain
    against its plain chain, v6's partials, v6's sliding windows at 5
    chunks, v5 at hpb 8 and 2, nothing to attend (v1 and v6 NaN, v2-v4 the
    head's window mean, v5 its grid step's), then the ladder at kernel 6's
    phase shape and at docs/PERFORMANCE.md's.  Returns the kernels-line
    entries (launches filled in by ``phase_kernel_archive_cache``)."""
    import torch
    from mustafar_tpu_torch.ops import sparse_format as sf
    from mustafar_tpu_torch.ops.kernels import sparse_attention_archive as sar
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(10)
    counts0 = _launches()
    bf = torch.bfloat16
    B, Hkv, mc, W, D = 8, 8, 5, 288, 128
    BH = B * Hkv
    ulps = KERNEL_TOL_ULPS * 2.0 ** -8
    results = []
    worst = dict.fromkeys(("key_scores", "value_combine", "v1", "v2", "v3", "v4", "v5", "v6",
                           "v6_partials"), 0.0)
    for sparsity in (0.7, 0.5):
        fmt = sf.ChunkFormat(256, 128, 128 - int(sparsity * 128) + 1)
        pools = _archive_pools(
            torch.randn((2, BH, mc, 256, D), generator=g, device=dev).to(bf), fmt)
        (ks, kb), (vs, vb) = pools["head"]
        sp = pools["stream"][0]
        kw = torch.randn((B, W, Hkv, D), generator=g, device=dev).to(bf)
        vw = torch.randn((B, W, Hkv, D), generator=g, device=dev).to(bf)
        for G in (1, 2, 4, 8):
            q = torch.randn((B, 1, Hkv * G, D), generator=g, device=dev).to(bf)
            qpad = torch.zeros((BH, 8, D), dtype=bf, device=dev)
            qpad[:, :G] = q.reshape(BH, G, D)
            for nc, wl in ARCHIVE_CASES:
                case = {"sparsity": sparsity, "G": G, "n_chunks": nc, "win_len": wl}
                got = sar.sparse_key_scores(qpad, ks, kb, nc, fmt, mc)
                torch.cuda.synchronize()
                want = sar.sparse_key_scores_plain(qpad, ks, kb, nc, fmt, mc)
                if not (got[:, :, nc * 256:] == 0).all():
                    raise AssertionError(f"kernel 10 wrote non-zero scores past "
                                         f"n_chunks: {case}")
                _check(results, worst, "key_scores", got, want,
                       SCORES_RTOL * want.abs().max().item(), **case)
                w = torch.zeros((BH, 8, mc * 256), dtype=bf, device=dev)
                w[:, :G, :nc * 256] = torch.softmax(
                    torch.randn((BH, G, nc * 256), generator=g, device=dev), -1).to(bf)
                got = sar.sparse_value_combine(w, vs, vb, nc, fmt, mc)
                torch.cuda.synchronize()
                want = sar.sparse_value_combine_plain(w, vs, vb, nc, fmt, mc)
                _check(results, worst, "value_combine", got, want,
                       ulps * want.abs().max().item(), **case)
                for gen, (fn, plain) in _archive_calls(pools, q, kw, vw, nc, wl, fmt,
                                                       mc).items():
                    if gen == "kernel6":
                        continue
                    got = fn()
                    torch.cuda.synchronize()
                    want = plain()
                    # same arithmetic, sums in another order: a bf16(p) or the
                    # bf16 output may move by one ulp each
                    _check(results, worst, gen, got, want,
                           ulps * want.float().abs().max().item(), **case)
                got = sar.fused_sparse_decode_attention_v5(q, sp, kw, vw, nc, wl, fmt, fmt,
                                                           mc, hpb=2)
                want = sar.fused_sparse_decode_attention_v5_plain(q, sp, kw, vw, nc, wl, fmt,
                                                                  fmt, mc, hpb=2)
                _check(results, worst, "v5", got, want,
                       ulps * want.float().abs().max().item(), hpb=2, **case)
                for window in (None,) + (ARCHIVE_WINDOWS if nc == mc else ()):
                    opt = {"window": window}
                    _check_partials(results, worst, sar.fused_sparse_decode_attention_v6_partials(
                        q, sp, nc, wl, fmt, fmt, mc, **opt),
                        sar.fused_sparse_decode_attention_v6_partials_plain(
                            q, sp, nc, wl, fmt, fmt, **opt), **case, **opt)
                    if window is not None:
                        got = sar.fused_sparse_decode_attention_v6(q, sp, kw, vw, nc, wl, fmt,
                                                                   fmt, mc, **opt)
                        want = sar.fused_sparse_decode_attention_v6_plain(
                            q, sp, kw, vw, nc, wl, fmt, fmt, mc, **opt)
                        _check(results, worst, "v6", got, want,
                               ulps * want.float().abs().max().item(), **case, **opt)
        # nothing to attend: v1 and v6 NaN, v2-v4 the mean of the head's
        # whole window, v5 the mean over the hpb heads of its grid step
        G = 4
        q = torch.randn((B, 1, Hkv * G, D), generator=g, device=dev).to(bf)
        calls = _archive_calls(pools, q, kw, vw, 0, 0, fmt, mc)
        heads = vw.float().permute(0, 2, 1, 3).reshape(BH, W, D)
        for gen, hpb in (("v2", 1), ("v3", 1), ("v4", 1), ("v5", 8), ("v5", 2)):
            # the mean over groups of hpb heads (one head: v2-v4)
            mean = heads.reshape(BH // hpb, hpb * W, D).mean(dim=1).repeat_interleave(
                hpb, dim=0)[:, None].expand(BH, G, D).reshape(B, 1, Hkv * G, D)
            got = (calls[gen][0]() if gen != "v5" else sar.fused_sparse_decode_attention_v5(
                q, sp, kw, vw, 0, 0, fmt, fmt, mc, hpb=hpb)).float()
            want = (calls[gen][1]() if gen != "v5" else
                    sar.fused_sparse_decode_attention_v5_plain(q, sp, kw, vw, 0, 0, fmt, fmt,
                                                               mc, hpb=hpb)).float()
            tol = ulps * mean.abs().max().item()
            err = max((got - mean).abs().max().item(), (want - mean).abs().max().item())
            if err > tol:
                raise AssertionError(f"{gen} (hpb {hpb}) with nothing to attend is not the "
                                     f"mean of its heads' windows: {err} > {tol}")
        nan = [calls[gen][k]() for gen in ("v1", "v6") for k in (0, 1)]
        if not all(bool(x.isnan().all()) for x in nan):
            raise AssertionError("v1 or v6 with nothing to attend is not NaN")
    nothing = ("v1 and v6 NaN (kernels and plain); v2, v3 and v4 the mean of the head's 288 "
               "window rows; v5 the mean of the windows of the 8 (hpb 8) or 2 (hpb 2) "
               "heads of its grid step")
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    ladder = {"a": _archive_ladder(g, dev, flush_buf.zero_, 8, 5, 1, 288, 288, 4),
              "b": _archive_ladder(g, dev, flush_buf.zero_, 32, 3, 3, 288, 132, 4)}
    _set_launches(counts0)                                 # comparisons do not count
    by_kind = {k: [r for r in results if r["kernel"] == k] for k in worst}
    emit("kernel_archive", shapes={"B": B, "Hkv": Hkv, "mc": mc, "W": W},
         cases={"sparsity": (0.7, 0.5), "G": (1, 2, 4, 8), "n_chunks_win_len": ARCHIVE_CASES,
                "v6_windows_at_5_chunks": ARCHIVE_WINDOWS, "v5_hpb": (8, 2)},
         n_cases={k: len(v) for k, v in by_kind.items()},
         max_abs_err={k: max(r["max_abs_err"] for r in v) for k, v in by_kind.items()},
         worst_err_over_tol=worst, nothing_to_attend=nothing, ladder=ladder)
    entries = {}
    for kind in ARCHIVE_KINDS:
        # v6's kernel is kernel 16 alone (the partials); the whole function
        # (kernel, torch window and merge) stands beside it
        t = ladder["a"]["timed"]["v6_kernel" if kind == "v6" else kind]
        tol = ("1e-5 of the largest score" if kind == "key_scores"
               else "2 bf16 ulps of the output's largest magnitude (v6: of the whole "
                    "function's output, and of each partial's)" if kind == "v6"
               else "2 bf16 ulps of the output's largest magnitude")
        e = _entry("archive", kind, by_kind[kind], worst[kind], tol, t["cuda_ms"], t["plain_ms"],
                   t["bytes_ms"], t["flops_ms"])
        e.update(timed_at="ladder (a): B=8, Hkv=8, G=4, mc=5, 1 chunk + 288 window",
                 ladder={s: ladder[s]["timed"][kind] for s in ladder})
        if kind == "v6":
            e.update(partials_max_abs_err=max(r["max_abs_err"] for r in by_kind["v6_partials"]),
                     partials_worst_err_over_tol=worst["v6_partials"],
                     kernel_alone={s: ladder[s]["timed"]["v6_kernel"] for s in ladder})
        entries[("archive", kind)] = e
    return entries


def phase_kernel_archive_cache(k, v):
    """The archive's main path: v1-v6 and kernel 6 on every layer of the
    model's own cache (``serve_dense``'s K and V [L, B=8, S, Hkv, 128], 599
    rows written).  Rows 0-511 become two chunks, pruned at sparsity 0.7
    and packed as split pools and as fused streams (one stacked pool [L, 2,
    BH, rows, 128], read a layer view at a time); rows 512-598 are the
    window (W=288); q is seeded.  Per layer v2 agrees with v1 and v4 with
    v2 to 3e-2, v3 and kernel 6 with v2 and v5 and v6 with v4 to 2e-2 (the
    JAX chain's tolerances, tests/test_kernels_archive.py).  Returns the
    launches of the run, one of each kernel a layer."""
    import torch
    from mustafar_tpu_torch.ops import sparse_format as sf
    L, B, S, Hkv, D = k.shape
    if S != 800 or bool((k[:, :, 599:] != 0).any()) or bool((k[:, :, 598] == 0).all()):
        raise AssertionError("expected serve_dense's cache with 599 written rows")
    BH, G, W, nc, wl = B * Hkv, 4, 288, 2, 599 - 512
    fmt = sf.ChunkFormat(256, 128, 40)
    g = torch.Generator(device=k.device)
    g.manual_seed(11)
    before = _launches()
    _set_launches(dict.fromkeys(before, 0))
    pairs = (("v2_vs_v1", "v2", "v1", 3e-2), ("v3_vs_v2", "v3", "v2", 2e-2),
             ("kernel6_vs_v2", "kernel6", "v2", 2e-2), ("v4_vs_v2", "v4", "v2", 3e-2),
             ("v5_vs_v4", "v5", "v4", 2e-2), ("v6_vs_v4", "v6", "v4", 2e-2))
    worst = {name: 0.0 for name, *_ in pairs}
    tols = {name: tol for name, _, _, tol in pairs}
    stacked = torch.empty((L, nc, BH, 2 * fmt.stream_rows, D), dtype=torch.int16,
                          device=k.device)
    for li in range(L):
        x = torch.stack([k[li, :, :512], v[li, :, :512]])          # [2, B, 512, Hkv, D]
        x = x.reshape(2, B, 2, 256, Hkv, D).permute(0, 1, 4, 2, 3, 5).reshape(2, BH, 2, 256, D)
        pools = _archive_pools(x.contiguous(), fmt)
        stacked[li] = pools["stream"][0]
        pools["stream"] = stacked[li:li + 1]           # v4-v6 read stacked[li], a view
        q = torch.randn((B, 1, Hkv * G, D), generator=g, device=k.device).to(torch.bfloat16)
        calls = _archive_calls(pools, q, k[li, :, 512:].contiguous(),
                               v[li, :, 512:].contiguous(), nc, wl, fmt, nc)
        outs = {gen: fn().float() for gen, (fn, _) in calls.items()}
        for name, a, b, tol in pairs:
            # allclose(a, b, rtol=tol, atol=tol): the worst of |a - b| / (tol + tol |b|)
            ratio = ((outs[a] - outs[b]).abs() / (tol * (1 + outs[b].abs()))).max()
            if not (outs[a].isfinite().all() and ratio.item() <= 1.0):
                raise AssertionError(f"layer {li}: {name} off by {ratio.item():.3g} of "
                                     f"its tolerance {tol}")
            worst[name] = max(worst[name], ratio.item())
    torch.cuda.synchronize()
    launches = {n: c for n, c in _launches().items() if c}
    want = {f"archive.{n}": L for n in (
        "sparse_key_scores", "sparse_value_combine", "fused_sparse_decode_attention",
        "fused_sparse_decode_attention_v3", "fused_sparse_decode_attention_v4",
        "fused_sparse_decode_attention_v5", "fused_sparse_decode_attention_v6")}
    want["fused_sparse_decode_attention"] = L
    _set_launches(before)
    emit("kernel_archive_cache", layers=L, B=B, Hkv=Hkv, G=G, n_chunks=nc, win_len=wl, W=W,
         sparsity=0.7, worst_over_tol=worst, tolerances=tols, kernel_launches=launches)
    if launches != want:
        raise AssertionError(f"kernel_archive_cache launched {launches}, expected {want}")
    return launches


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
    from mustafar_tpu_torch.ops.kernels import dense_decode as dd
    from mustafar_tpu_torch.ops.kernels import pack_kernel as pk
    from mustafar_tpu_torch.ops.kernels import quant_attention as qa
    from mustafar_tpu_torch.ops.kernels import sparse_attention as ska
    from mustafar_tpu_torch.ops.kernels import sparse_attention_archive as sar
    from mustafar_tpu_torch.ops.kernels import w4_matmul as w4
    counters = {fn.__name__: fn for fn in (
        qa.fused_q_decode_attention, qa.fused_q_decode_attention_ps,
        qa.fused_q_segment_attention, ska.fused_sparse_decode_attention,
        ska.fused_sparse_decode_attention_ps, ska.fused_sparse_segment_attention,
        w4.w4_matmul, dd.flash_decode_attention, pk.prune_quant_pack)}
    # the archive's v2 has the production kernel's name: its keys are prefixed
    counters.update({f"archive.{fn.__name__}": fn for fn in (
        sar.sparse_key_scores, sar.sparse_value_combine,
        sar.fused_sparse_decode_attention, sar.fused_sparse_decode_attention_v3,
        sar.fused_sparse_decode_attention_v4, sar.fused_sparse_decode_attention_v5,
        sar.fused_sparse_decode_attention_v6)})
    return counters


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


def phase_reference_bitmap(codec="bitmap"):
    """``reference`` and ``reference_cb`` with a bitmap codec (bitmap, or
    bitmap-q8 as ``reference_bitmap_q8``): the Generator's decode path and
    the engine (per-slot decode, segments) through the bitmap kernels on
    the card, against the plain versions on the CPU.  Each run must have
    launched exactly the bitmap kernels."""
    gen, cb = phase_reference(codec), phase_reference_cb(codec)
    label = "reference_" + codec.replace("-", "_")
    emit(label, generator=gen, engine=cb)
    if set(gen["launched"]) != {"fused_sparse_decode_attention"} or set(
            cb["launched"]) != {"fused_sparse_decode_attention_ps",
                                "fused_sparse_segment_attention"}:
        raise AssertionError(f"{label}: launched {gen['launched']} and {cb['launched']}")


def phase_reference_q():
    """``reference`` and ``reference_cb`` with the codecs q8 and q4q4: the
    Generator's decode path (kernel 1, and kernel 9 at prefill) and the
    engine (kernels 2, 3 and 9) on the card against the plain versions on
    the CPU, logits within 1e-2 of their range.  Each run must have
    launched exactly its codec's kernels.  Returns the engine runs'
    launches by codec."""
    runs = {codec: (phase_reference(codec), phase_reference_cb(codec))
            for codec in ("q8", "q4q4")}
    emit("reference_q", **{c: {"generator": gen, "engine": cb}
                           for c, (gen, cb) in runs.items()})
    for codec, (gen, cb) in runs.items():
        if set(gen["launched"]) != {"fused_q_decode_attention", "prune_quant_pack"} or set(
                cb["launched"]) != {"fused_q_decode_attention_ps",
                                    "fused_q_segment_attention", "prune_quant_pack"}:
            raise AssertionError(f"reference_q ({codec}): launched {gen['launched']} and "
                                 f"{cb['launched']}")
    return {codec: cb["launched"] for codec, (_, cb) in runs.items()}


REFERENCE_W4_TOL = 3e-2   # of the logits' range (see phase_reference_w4)


def phase_reference_w4():
    """A tiny model with W4 weights (f32 activations; the same params on the
    card and on the CPU), fed the CPU's greedy tokens on the card: the card
    runs kernel 5 for every projection of at most 128 tokens and the dense
    cache's kernel 4 (``use_pallas``) or the q8q4 kernel; the CPU runs the
    dequant route and the plain versions.  Runs: the dense cache at a
    batch-1 prompt of 100 tokens in a 128-token bucket (kernel 5 at
    prefill too) and at B=2, prompt 300 (a 384-token prefill: the dequant
    route); q8q4 at B=2, prompt 300; the dense engine (per-slot ticks
    through kernel 4), fed the CPU's tokens.  The kernel route reads each
    projection's input as bf16, the CPU's dequant route keeps it in f32:
    simulated on the CPU (the kernel's plain version for <= 128 tokens)
    that moves these logits by 7.7e-3 of their range, so they are held to
    3e-2 of it."""
    import dataclasses
    import numpy as np
    import torch
    from mustafar_tpu_torch.cache import make_cache
    from mustafar_tpu_torch.config import CacheMode
    from mustafar_tpu_torch.models import llama
    from mustafar_tpu_torch.models.quant import quantize_params_w4
    base = _tiny_engine(CacheMode.DENSE)
    cpu_params = quantize_params_w4(llama.init_params(base.model, device="cpu",
                                                      dtype=torch.float32, seed=3))
    gpu_params = {k: ({kk: vv.cuda() for kk, vv in v.items()} if isinstance(v, dict)
                      else v.cuda()) for k, v in cpu_params.items()}
    runs = {"dense_b1_prompt100": (CacheMode.DENSE, 1, 100, 128),
            "dense_b2_prompt300": (CacheMode.DENSE, 2, 300, 128),
            "q8q4_b2_prompt300": (CacheMode.COMPRESSED, 2, 300, 256)}
    results, ok = {}, True
    for label, (mode, B, T, bucket) in runs.items():
        eng = dataclasses.replace(_tiny_engine(mode), prefill_bucket=bucket)
        prompt = np.random.RandomState(B + T).randint(0, 512, (B, T))
        Tpad = -(-T // bucket) * bucket
        toks = torch.zeros((B, Tpad), dtype=torch.int64)
        toks[:, :T] = torch.from_numpy(prompt)
        logs, stream = {}, None
        counts0 = _launches()
        with torch.inference_mode():
            for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
                impl = make_cache(eng, device=dev)
                impl.use_pallas = True
                cache = impl.init(B, torch.float32)
                logit, cache = llama.prefill(eng.model, params, toks.to(dev), cache, impl,
                                             T, last_only=True)
                prefill_w4 = _launches()["w4_matmul"] - counts0["w4_matmul"]
                out = [logit[:, 0].cpu()]
                tok = logit[:, 0].argmax(-1)
                for i in range(1, 30):
                    if stream is not None:
                        tok = stream[:, i - 1].to(dev)
                    logit, cache = llama.decode_step(eng.model, params, tok[:, None],
                                                     cache, impl, T + i - 1)
                    out.append(logit[:, 0].cpu())
                    tok = logit[:, 0].argmax(-1)
                logs[dev] = torch.stack(out, 1)
                if stream is None:
                    stream = logs[dev].argmax(-1)          # the CPU's greedy picks
        launched = {k: v - counts0[k] for k, v in _launches().items() if v > counts0[k]}
        _set_launches(counts0)
        a, b = logs["cpu"], logs["cuda"]
        err, scale = (a - b).abs().max().item(), a.abs().max().item()
        L = eng.model.num_layers
        attn = "flash_decode_attention" if mode == CacheMode.DENSE else "fused_q_decode_attention"
        want = {"w4_matmul": 7 * L * (29 + (B * Tpad <= 128)), attn: L * 29}
        if mode == CacheMode.COMPRESSED:
            want["prune_quant_pack"] = 2 * L      # prefill's one chunk, K and V
        results[label] = {"max_abs_err": err, "tol": REFERENCE_W4_TOL * scale,
                          "greedy_agreement": (a.argmax(-1) == b.argmax(-1)).float().mean().item(),
                          "launched": launched, "expected_launches": want,
                          "prefill_w4_launches": prefill_w4}
        ok &= bool(b.isfinite().all()) and err <= REFERENCE_W4_TOL * scale and launched == want
    # the engine's per-slot ticks on the dense cache through kernel 4: three
    # requests over two slots (one waits, a slot idles at -1), each prompt
    # prefilled alone in a 128-token bucket (kernel 5 at prefill)
    Recording, _ = _recording_engine()
    eng = dataclasses.replace(_tiny_engine(CacheMode.DENSE, batch_size=2), prefill_bucket=128)
    rs = np.random.RandomState(5)
    reqs = [(rs.randint(0, 512, size=n), m) for n, m in ((40, 8), (100, 12), (70, 6))]
    counts0 = _launches()
    cb_runs = {}
    for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        cb = Recording(eng, params, dtype=torch.float32, device=dev,
                       streams=cb_runs["cpu"][0] if dev == "cuda" else None)
        cb.impl.use_pallas = True
        for prompt, m in reqs:
            cb.submit(prompt, m)
        cb_runs[dev] = (cb.run(), cb.logits, cb.decode_steps)
    launched = {k: v - counts0[k] for k, v in _launches().items() if v > counts0[k]}
    _set_launches(counts0)
    toks, lc, steps = cb_runs["cpu"]
    lg = cb_runs["cuda"][1]
    err = max((torch.stack(lc[u]) - torch.stack(lg[u])).abs().max().item() for u in toks)
    scale = max(torch.stack(lc[u]).abs().max().item() for u in toks)
    L = eng.model.num_layers
    want = {"w4_matmul": 7 * L * (steps + len(reqs)), "flash_decode_attention": L * steps}
    results["dense_engine"] = {"requests": len(reqs), "decode_steps": steps,
                               "max_abs_err": err, "tol": REFERENCE_W4_TOL * scale,
                               "launched": launched, "expected_launches": want}
    ok &= err <= REFERENCE_W4_TOL * scale and launched == want
    emit("reference_w4", steps=30, runs=results)
    if not ok:
        raise AssertionError(f"reference_w4: card and CPU disagree or the kernels were "
                             f"not launched as expected: {results}")


def _pool_bytes(cache):
    """Bytes of a compressed cache's pool and scales (allocated at
    ``max_seq_len``'s chunks)."""
    return sum(cache[k].nbytes for k in ("kv_pool", "kv_scales") if k in cache)


def serve(label, mode, params, prompt, new_tokens, codec="q8q4", use_pallas=False,
          on_cache=None):
    """One warm-up generation, then the measured one; returns its tokens,
    the launches of every kernel during the measured run (those launched)
    and the phase's fields.  ``use_pallas`` decodes the dense cache through
    its flash-decode kernel; ``on_cache`` is handed the cache state the
    measured run left."""
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
    gen.cache_impl.use_pallas = use_pallas
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
    else:
        fields["use_pallas"] = use_pallas
    cache = gen.last_cache
    if mode.value == "compressed":
        fields["n_chunks_end"] = cache["nc_host"]
        fields["pool_bytes"] = _pool_bytes(cache)
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
    if on_cache is not None:
        on_cache(cache)
    del gen, cache
    torch.cuda.empty_cache()
    return toks, launches, fields


def _step_parts(params):
    """At B=8: the device ms of one layer's seven projections (``proj``: W8
    widened to bf16, then matmul and scale; W4 through its kernel), each
    layer timed alone under the spin kernel (a layer's launches enqueue
    within it, so the events read device time) and averaged over the 32
    layers; the host us to enqueue one layer's projections; the LM head's
    device ms."""
    import torch
    from mustafar_tpu_torch.config import LLAMA3_8B as cfg
    from mustafar_tpu_torch.models.llama import _lm_head
    from mustafar_tpu_torch.models.quant import proj
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    h = torch.randn((8, 1, cfg.hidden_size), generator=g, device="cuda").to(torch.bfloat16)
    hi = torch.randn((8, 1, cfg.intermediate_size), generator=g,
                     device="cuda").to(torch.bfloat16)
    hq = torch.randn((8, 1, cfg.q_dim), generator=g, device="cuda").to(torch.bfloat16)
    layers = params["layers"]

    def layer(li):
        lp = {name: leaf[li] for name, leaf in layers.items()}
        for name in ("wq", "wk", "wv", "w_gate", "w_up"):
            proj(h, lp, name)
        proj(hq, lp, "wo")
        proj(hi, lp, "w_down")

    with torch.inference_mode():
        layer(0)
        _lm_head(cfg, params, h)
        torch.cuda.synchronize()
        layer_ms = sum(cuda_ms(lambda li=li: layer(li), 2)[0]
                       for li in range(cfg.num_layers)) / cfg.num_layers
        layer_host_us = host_us(lambda: layer(0), 10)
        head_ms = cuda_ms(lambda: _lm_head(cfg, params, h), 5)[0]
    return layer_ms, layer_host_us, head_ms


def phase_decode_split(params, kernel_ms, q8q4_s, dense_s, new_tokens):
    """Device time of the W8 decode step's big parts, each timed alone: the
    seven projections of a layer, the LM head and the attention kernel,
    beside the wall time per generated token of the two serve runs."""
    from mustafar_tpu_torch.config import LLAMA3_8B as cfg
    w8_layer_ms, layer_host_us, head_ms = _step_parts(params)
    parts_ms = cfg.num_layers * (w8_layer_ms + kernel_ms) + head_ms
    emit("decode_split", w8_layer_ms=w8_layer_ms, w8_layer_host_us=layer_host_us,
         lm_head_ms=head_ms,
         attn_kernel_ms=kernel_ms, w8_head_attention_ms_per_step=parts_ms,
         q8q4_wall_ms_per_token=q8q4_s / new_tokens * 1e3,
         dense_wall_ms_per_token=dense_s / new_tokens * 1e3)


def phase_decode_split_w4(params, attn_ms, wall_s, new_tokens):
    """The W4 decode step's parts, as ``decode_split``: a layer's seven W4
    projections through kernel 5, the W8 LM head, and per cache its
    attention kernel (q8q4 kernel 1 and bitmap kernel 6 at one chunk and a
    full window; the dense twin's kernel 4 at pos 599, the run's last
    step), beside each ``serve_w4_*`` run's wall time per token."""
    from mustafar_tpu_torch.config import LLAMA3_8B as cfg
    w4_layer_ms, layer_host_us, head_ms = _step_parts(params)
    parts = {c: cfg.num_layers * (w4_layer_ms + ms) + head_ms for c, ms in attn_ms.items()}
    emit("decode_split_w4", w4_layer_ms=w4_layer_ms, w4_layer_host_us=layer_host_us,
         lm_head_ms=head_ms,
         attn_kernel_ms=attn_ms, w4_head_attention_ms_per_step=parts,
         wall_ms_per_token={c: t / new_tokens * 1e3 for c, t in wall_s.items()})


def phase_serve_cb(params, codec="q8q4", w4=False, first8=False, beside=None):
    """Continuous batching at full Llama-3-8B width and depth: 8 slots, 17
    requests (16 with prompts of 200-1,500 tokens and 32-96 new tokens,
    plus one of 8,000 prompt tokens submitted third), chunked prefill with
    interleaved admission, ``codec`` at 0.7.  Every decode step must launch
    the codec's per-slot kernel once a layer, every segment its segment
    kernel once a layer, and no other kernel may run; every request's first
    token must equal a batch-1 chunked Generator's on the same prompt.
    A quant codec's engine packs through kernel 9: twice a layer (K and V)
    for every chunk a prompt packs and every compaction (one
    ``compact_slots`` call packs all the slots it names).  With ``first8``:
    the first 8 requests of that stream without the 8,000-token one.  With
    ``w4`` (W4 params; implies ``first8``): the W4 kernel 7 times a layer in
    every decode step (a segment's 256 tokens take the dequant route).
    ``beside``: fields of another run printed with this one.  Returns the
    launches and the run's peak memory and pool bytes."""
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
    if w4 or first8:
        reqs = [r for r in reqs if len(r[0]) != 8000][:8]
    warm = ContinuousBatchingEngine(eng, params)
    for p, _ in reqs[:2]:
        warm.submit(p[:300], 4)
    warm.run()
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated() / 2 ** 30     # the weights, no engine

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
    compactions = [0]
    compact_slots = cb.impl.compact_slots

    def counted(state, do):
        compactions[0] += any(do)
        return compact_slots(state, do)

    cb.impl.compact_slots = counted
    uids = [cb.submit(p, m) for p, m in reqs]
    _set_launches(dict.fromkeys(_counters(), 0))
    t = time.perf_counter()
    outs = cb.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = _launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    pool_bytes = _pool_bytes(cb.cache)
    L = LLAMA3_8B.num_layers
    generated = sum(len(outs[u]) for u in uids)
    want = dict.fromkeys(launches, 0)
    want[_meta(codec, "decode_ps")[0]] = L * cb.decode_steps
    want[_meta(codec, "segment")[0]] = L * cb.segments
    prompt_chunks = sum(max(len(p) - 32, 0) // 256 for p, _ in reqs)
    if codec in QUANT_BITS:
        want["prune_quant_pack"] = 2 * L * (prompt_chunks + compactions[0])
    if w4:
        want["w4_matmul"] = 7 * L * cb.decode_steps
    seg_expected = sum(-(-len(p) // 256) for p, _ in reqs)
    bad = [u for u, (p, m) in zip(uids, reqs)
           if len(outs[u]) != m or min(outs[u]) < 0 or max(outs[u]) >= LLAMA3_8B.vocab_size]
    # first tokens against a batch-1 chunked Generator (not counted above)
    gen = Generator(eng, params)
    first_equal = [int(gen.generate(p[None], 1)[0][0]) == int(outs[u][0])
                   for u, (p, _) in zip(uids, reqs)]
    counts = {"ticks": cb.ticks, "decode_steps": cb.decode_steps,
              "segments": cb.segments, "prompt_chunks": prompt_chunks,
              "compactions": compactions[0],
              "tick_ms": {k: {"n": len(v), "mean": 1e3 * sum(v) / max(len(v), 1),
                              "total_s": sum(v)} for k, v in Timed.split.items()}}
    del gen, cb
    torch.cuda.empty_cache()
    label = ("serve_cb_w4" if w4 else "serve_cb" if codec == "q8q4"
             else "serve_cb_" + codec.replace("-", "_"))
    emit(label, model=f"llama-3-8b x32L, {'W4' if w4 else 'W8'} (random, seed 0)",
         codec=codec, slots=8,
         requests=len(reqs), prompt_tokens=sum(len(p) for p, _ in reqs),
         generated_tokens=generated, seconds=dt, tok_s=generated / dt,
         peak_mem_gib=peak, mem_before_gib=mem_before, pool_bytes=pool_bytes, **counts,
         launches=launches,
         expected_launches=want, first_token_equal=sum(first_equal), **(beside or {}))
    if bad or launches != want or counts["segments"] != seg_expected:
        raise AssertionError(f"{label}: bad outputs {bad}, launches {launches} "
                             f"(expected {want}), segments {counts['segments']} "
                             f"(expected {seg_expected})")
    if not all(first_equal):
        raise AssertionError(f"{label}: first tokens differ from the batch-1 "
                             f"chunked Generator for requests "
                             f"{[u for u, ok in zip(uids, first_equal) if not ok]}")
    return launches, {"peak_mem_gib": peak, "pool_bytes": pool_bytes}


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
    chunks; it packs a fifth) at q8q4, bitmap and bitmap-q8, one pack of a
    chunk's K and V (B=1, 8 kv heads: what a segment does per layer) at
    each, one decode tick of the engine with 8 active slots (q8q4), and one
    of the q8q4 and of the bitmap engine with 8 active slots, one of them
    8,000 tokens long (31 pool chunks: the per-slot kernels' longest slot),
    each timed three ways: the host's time to enqueue it, the wall time
    until the card is done, and the device time of its kernels with the
    number of kernels launched (torch.profiler)."""
    import dataclasses
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
        # cudaLaunchKernel, and cudaLaunchKernelExC for cluster launches
        launches = sum(e.count for e in events if e.key.startswith("cudaLaunchKernel"))
        return {"enqueue_ms": 1e3 * enqueue, "wall_ms": 1e3 * wall,
                "device_ms": device_us / 1e3, "kernels_launched": launches}

    toks = torch.as_tensor(np.random.RandomState(4).randint(1, 500, (1, 2048)),
                           device="cuda")
    kv = torch.randn((1, LLAMA3_8B.num_kv_heads, 256, 128), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(4))
    kv = kv.to(torch.bfloat16)
    segments, packs = {}, {}
    with torch.inference_mode():
        for codec in ("q8q4", "bitmap", "bitmap-q8"):
            impl = make_cache(dataclasses.replace(eng, codec=codec))
            sub = impl.init(1)
            seg = [0]

            def segment():
                s = seg[0]
                llama.prefill_segment(LLAMA3_8B, params, toks[:, s * 256:(s + 1) * 256],
                                      sub, impl, s * 256, 2000)
                seg[0] += 1

            for _ in range(4):
                segment()
            segments[codec] = measure(segment)   # segment 4; the profiled one is 5
            packs[codec] = measure(lambda: impl._pack(kv, kv))
            del sub
        cb = ContinuousBatchingEngine(eng, params)
        rs = np.random.RandomState(5)
        for _ in range(8):
            cb.submit(rs.randint(1, 500, size=300), 64)
        while cb._admissions or cb.queue:
            cb.tick()
        tick_split = measure(cb.tick)
        del cb
        ticks_long = {}
        for codec in ("q8q4", "bitmap"):
            cb = ContinuousBatchingEngine(dataclasses.replace(eng, codec=codec,
                                                              max_seq_len=8448), params)
            rs = np.random.RandomState(6)
            for n in (8000, 300, 700, 1500, 450, 1000, 1200, 600):
                cb.submit(rs.randint(1, 500, size=n), 200)
            while cb._admissions or cb.queue:
                cb.tick()
            cb.tick()
            ticks_long[codec] = measure(cb.tick)
            del cb
    torch.cuda.empty_cache()
    emit("host_split", segment_b1=segments["q8q4"], segment_b1_bitmap=segments["bitmap"],
         segment_b1_bitmap_q8=segments["bitmap-q8"], pack_kv_b1=packs,
         decode_tick_b8=tick_split, decode_tick_b8_long=ticks_long["q8q4"],
         decode_tick_b8_bitmap_long=ticks_long["bitmap"])


def serve_w4(entries, prompt, new):
    """The W4 path at full Llama-3-8B width and depth (``init_params_w4``,
    seed 0): ``serve_w4_dense`` (the dense cache through kernel 4),
    ``serve_w4_q8q4`` and ``serve_w4_bitmap``, B=8, 300 + 300 tokens; every
    decode step launches kernel 5 seven times a layer and the cache's
    decode kernel once a layer, prefill (4,096 tokens) takes the dequant
    route; first tokens equal the dense run's.  Then ``decode_split_w4`` and
    ``serve_cb_w4``."""
    import torch
    from mustafar_tpu_torch.config import CacheMode, LLAMA3_8B
    from mustafar_tpu_torch.models.quant import init_params_w4, weight_bytes
    t = time.perf_counter()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    params = init_params_w4(LLAMA3_8B, g, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    L = LLAMA3_8B.num_layers
    steps = new - 1
    runs = (("serve_w4_dense", CacheMode.DENSE, "q8q4", "flash_decode_attention"),
            ("serve_w4_q8q4", CacheMode.COMPRESSED, "q8q4", "fused_q_decode_attention"),
            ("serve_w4_bitmap", CacheMode.COMPRESSED, "bitmap", "fused_sparse_decode_attention"))
    dense_toks, wall = None, {}
    for label, mode, codec, attn in runs:
        toks, launches, fields = serve(label, mode, params, prompt, new, codec=codec,
                                       use_pallas=mode == CacheMode.DENSE)
        if dense_toks is None:
            dense_toks = toks
        want = {"w4_matmul": 7 * L * steps, attn: L * steps}
        if mode == CacheMode.COMPRESSED and codec in QUANT_BITS:
            want["prune_quant_pack"] = serve_packs()
        first_equal = bool((toks[:, 0] == dense_toks[:, 0]).all())
        emit(label, model="llama-3-8b x32L, W4 (random, seed 0)",
             weights_gib=weight_bytes(params) / 2 ** 30, weights_init_s=init_s,
             decode_steps=steps, expected_launches=want, first_token_equal_dense=first_equal,
             token_agreement_with_dense=(toks == dense_toks).float().mean().item(), **fields)
        if launches != want or not first_equal:
            raise AssertionError(f"{label}: launched {launches} (expected {want}), first "
                                 f"tokens equal the dense run's: {first_equal}")
        wall[label.removeprefix("serve_w4_")] = fields["seconds"]
        if mode == CacheMode.DENSE:
            entries[("dense", "decode")]["launches"] = launches[attn]
        elif codec == "q8q4":
            entries[("w4", "matmul")]["launches"] = launches["w4_matmul"]
    phase_decode_split_w4(params, {"q8q4": entries[("q8q4", "decode")]["kernel_ms"],
                                   "bitmap": entries[("bitmap", "decode")]["kernel_ms"],
                                   "dense": entries[("dense", "decode")]["kernel_ms"]},
                          wall, new)
    phase_serve_cb(params, "bitmap", w4=True)
    del params
    torch.cuda.empty_cache()


def serve_packs():
    """Kernel 9 launches of a ``serve`` run of a quant codec: K and V of
    every layer for prefill's one chunk (300 - 32 tokens) and the one
    compaction (after decode step 244)."""
    from mustafar_tpu_torch.config import LLAMA3_8B
    return 2 * LLAMA3_8B.num_layers * 2


QUANT_KINDS = ("decode", "decode_ps", "segment")


def _merge_codecs(entries, other, top, rest, note):
    """The kernels line keeps one entry per kernel: the decode, per-slot and
    segment kernels of a codec family carry codec ``top``'s numbers at the
    top and each codec's (``top`` and ``rest``) under ``codecs``."""
    keys = ("launches", "max_abs_err", "worst_err_over_tol", "ms", "plain_ms",
            "bound_ms", "bound_by")
    for kind in QUANT_KINDS:
        e = entries[(top, kind)]
        e["codecs"] = {c: {k: x[k] for k in keys}
                       for c, x in ((top, e), *((c, other[(c, kind)]) for c in rest))}
        e["max_abs_err"] = max(v["max_abs_err"] for v in e["codecs"].values())
        e["worst_err_over_tol"] = max(v["worst_err_over_tol"] for v in e["codecs"].values())
        e["timed_at"] = f"{top} at the top; each codec under codecs"
        e["launches_note"] = note


def main():
    faulthandler.dump_traceback_later(BUDGET_S, exit=True)
    smi = phase_env()
    phase_build()
    kinds = (("decode", phase_kernel), ("decode_ps", phase_kernel_ps),
             ("segment", phase_kernel_seg))
    entries = {(codec, kind): phase(codec) for codec in ("q8q4", "bitmap")
               for kind, phase in kinds}
    other = {(codec, kind): phase(codec) for codec in ("q8", "q4q4", "bitmap-q8")
             for kind, phase in kinds}
    entries[("q8q4", "pack")] = phase_kernel_pack()
    entries[("w4", "matmul")] = phase_kernel_w4()
    entries[("dense", "decode")] = phase_kernel_dense()
    entries.update(phase_kernel_archive())
    phase_reference()
    phase_reference_cb()
    phase_reference_bitmap()
    phase_reference_bitmap("bitmap-q8")
    q_engine_launches = phase_reference_q()
    phase_reference_w4()

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
    want = {"fused_q_decode_attention": expected, "prune_quant_pack": serve_packs()}
    emit("serve_q8q4", model="llama-3-8b x32L, W8 (random, seed 0)",
         weights_gib=weight_bytes(params) / 2 ** 30, weights_init_s=init_s,
         decode_steps=decode_steps, expected_launches=want, **fields)
    if launches != want:
        raise AssertionError(f"kernels launched {launches}, expected {want}: 32 layers x "
                             f"{decode_steps} steps of the decode kernel, and kernel 9")
    entries[("q8q4", "decode")]["launches"] = expected
    entries[("q8q4", "pack")]["launches"] = launches["prune_quant_pack"]
    kept = {}          # K and V rows 0-799 of the dense cache, for the archive
    dense_toks, dense_launches, fields = serve(
        "serve_dense", CacheMode.DENSE, params, prompt, new,
        on_cache=lambda c: kept.update(k=c["k"][:, :, :800].clone(),
                                       v=c["v"][:, :, :800].clone()))
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
    archive_launches = phase_kernel_archive_cache(kept.pop("k"), kept.pop("v"))
    for kind in ARCHIVE_KINDS:
        entries[("archive", kind)]["launches"] = archive_launches[_meta("archive", kind)[0]]
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
    bitmap_fields = fields
    toks, launches, fields = serve("serve_bitmap_q8", CacheMode.COMPRESSED, params,
                                   prompt, new, codec="bitmap-q8")
    first_equal = bool((toks[:, 0] == dense_toks[:, 0]).all())
    emit("serve_bitmap_q8", decode_steps=decode_steps, expected_launches=expected,
         first_token_equal_dense=first_equal,
         token_agreement_with_bitmap=(toks == bitmap_toks).float().mean().item(),
         token_agreement_with_dense=(toks == dense_toks).float().mean().item(),
         serve_bitmap={k: bitmap_fields[k] for k in ("peak_mem_gib", "pool_bytes")},
         **fields)
    if launches != {"fused_sparse_decode_attention": expected} or not first_equal:
        raise AssertionError(f"serve_bitmap_q8: launched {launches} (expected {expected} "
                             f"of the bitmap decode kernel), first tokens equal the "
                             f"dense run's: {first_equal}")
    other[("bitmap-q8", "decode")]["launches"] = expected
    kernel_toks, launches, fields = serve("serve_dense_kernel", CacheMode.DENSE, params,
                                          prompt, new, use_pallas=True)
    first_equal = bool((kernel_toks[:, 0] == dense_toks[:, 0]).all())
    emit("serve_dense_kernel", decode_steps=decode_steps, expected_launches=expected,
         first_token_equal_dense=first_equal,
         token_agreement_with_dense=(kernel_toks == dense_toks).float().mean().item(),
         **fields)
    if launches != {"flash_decode_attention": expected} or not first_equal:
        raise AssertionError(f"serve_dense_kernel: launched {launches} (expected {expected} "
                             f"of the dense decode kernel), first tokens equal: {first_equal}")
    for codec in ("q8", "q4q4"):
        label = f"serve_{codec}"
        toks, launches, fields = serve(label, CacheMode.COMPRESSED, params, prompt, new,
                                       codec=codec)
        want = {"fused_q_decode_attention": expected, "prune_quant_pack": serve_packs()}
        first_equal = bool((toks[:, 0] == dense_toks[:, 0]).all())
        emit(label, decode_steps=decode_steps, expected_launches=want,
             first_token_equal_dense=first_equal,
             token_agreement_with_q8q4=(toks == sparse_toks).float().mean().item(),
             token_agreement_with_dense=(toks == dense_toks).float().mean().item(),
             **fields)
        if launches != want or not first_equal:
            raise AssertionError(f"{label}: launched {launches} (expected {want}), first "
                                 f"tokens equal the dense run's: {first_equal}")
        other[(codec, "decode")]["launches"] = expected
    phase_decode_split(params, entries[("q8q4", "decode")]["kernel_ms"], q8q4_s,
                       dense_s, new)
    cb_runs = {}
    for codec in ("q8q4", "bitmap"):
        cb_launches, cb_runs[codec] = phase_serve_cb(params, codec)
        for kind in ("decode_ps", "segment"):
            entries[(codec, kind)]["launches"] = cb_launches[_meta(codec, kind)[0]]
    cb_launches, _ = phase_serve_cb(params, "bitmap-q8",
                                    beside={"serve_cb_bitmap": cb_runs["bitmap"]})
    for kind in ("decode_ps", "segment"):
        other[("bitmap-q8", kind)]["launches"] = cb_launches[_meta("bitmap-q8", kind)[0]]
    cb_launches, _ = phase_serve_cb(params, "q4q4", first8=True)
    for kind in ("decode_ps", "segment"):
        name = _meta("q4q4", kind)[0]
        other[("q4q4", kind)]["launches"] = cb_launches[name]
        other[("q8", kind)]["launches"] = q_engine_launches["q8"][name]
    _merge_codecs(entries, other, "q8q4", ("q8", "q4q4"),
                  "q8q4 and q4q4 from serve_q8q4 / serve_q4q4 and "
                  "serve_cb / serve_cb_q4q4; q8's per-slot and segment launches from "
                  "reference_q's engine run on the card (tiny model)")
    _merge_codecs(entries, other, "bitmap", ("bitmap-q8",),
                  "bitmap and bitmap-q8 from serve_bitmap / serve_bitmap_q8 and "
                  "serve_cb_bitmap / serve_cb_bitmap_q8")
    phase_serve_chunked(params)
    phase_host_split(params)
    del params
    torch.cuda.empty_cache()
    serve_w4(entries, prompt, new)

    print(smi, flush=True)
    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
