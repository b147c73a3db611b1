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
                mc=5), groups 1/2/4/8, bf16 and f32 q, also against its split
                plain version, a second launch bit-equal to the first and
                refusing short scratch; timed at 1 chunk + 288 window and at
                the full pool, beside the plain version's time and its bound;
                its window probabilities (return_win_probs) against the
                split plain version's within 2^-18 absolute, and its final
                (m, l) (return_norm) as kernel_dense holds kernel 4's, the
                output bit-equal with either option off, each timed on and
                off in turns; its sliding window (WINDOW_CASES: the edge
                inside a chunk, on a chunk and on a 64-token boundary,
                chunks wholly below it, vacuous) against both plain
                versions, and again at serve_swa's own decode shapes
                (SWA_SERVED: B=4, 17 chunks + 49..288 window tokens and 18
                after the compaction, window 4,096; bf16 and f32 q), timed
                on and off in turns at the serve_swa shape (SWA_TIMED)
                beside each's byte bound (live chunks only)
  kernel_ps     the per-slot decode kernel likewise, at the engine's pool
                (mc=32): mixed slots (n_chunks 0/1/2/5/31, win_len
                0/1/44/288, an idle slot), groups 1/2/4/8; the kernel
                (split-K, every codec) also against its split plain
                version, and refusing short scratch; its window
                probabilities against the split plain version's within
                2^-18 absolute (0 past each slot's window, an idle slot's
                all 0), the output bit-equal with the option off, timed on
                and off in turns; its sliding window (PS_WINDOW_CASES:
                Mistral's 4,096 at the engine's slots, 31 chunks with 15 or
                16 below the edge, and 288 / 320 at the kit's: edges inside
                a chunk, on a boundary, every chunk below, vacuous, idle
                slots, different edges in one call), G 1/2/4/8, bf16 and f32
                q, against both plain versions, a second launch bit-equal,
                the window probabilities within 2^-18; timed with the window
                on and off in turns at the mixed slots with the 8,000-token
                one at 31 chunks + 160, beside each's byte bound (live
                chunks)
  kernel_seg    the segment kernel likewise: Tseg=256, G=4, B = 1 and 2,
                n_chunks 0/1/4/31, a second launch bit-equal to the first;
                timed at 31 chunks (the bitmap codecs' with their cluster
                size and the clusters the card holds), the quant codecs' also
                at 1, 4 and 16 (the counts serve_cb launches it at), each
                beside its bound; its sliding window (SEG_WINDOW_CASES:
                window 4,096 at seg_start 7,936 over 30 chunks, 288 and 320
                over 1 and 4, rows with no live pool column), B = 1 and 2:
                the live rows' partials against the plain version, every
                row merged with a self partial, no NaN, a second launch
                bit-equal; timed on and off in turns at 31 chunks beside
                each's bound (live rows and columns)
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
                option, C = 128, 384 and 512, every cluster size, the cache's
                strided views; K and V in one launch (q8q4, q8, q4q4) in
                prefill's chunk layout and a compaction's layer layout,
                writing nothing outside their views, and with a score on V,
                on K or on both (the Opa packs); timed beside its byte
                bound and the plain chain: K alone, K+V at 64 and 8
                head-chunks, a 32-layer compaction in one launch and in the
                2 x 32 launches it took before, each K+V shape at every
                cluster size, and K+V at 64 with V scored and not, in turns
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
                timed beside scaled_dot_product_attention; its final (m, l)
                (return_norm) against the split plain version's, the output
                bit-equal with the option off, timed on and off in turns;
                its sliding window (DENSE_WINDOWS: serve_swa's cache at pos
                4,500 and the per-slot cache) against both plain versions,
                timed on and off in turns beside each's byte bound and
                scaled_dot_product_attention with the band as its mask
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
  reference_masked
                reference on the masked cache for all eight pruning
                methods (the Opa ones through kernel 4, with its (m, l)
                where V is scored)
  reference_opa reference on the compressed cache under KT_OPA_VT_MAG and
                KT_MAG_VT_OPA at every codec: a 543-token prompt packed by
                its prefill scores, a compaction by the accumulated scores,
                the window probabilities of kernels 1 and 6
  reference_opa_cb
                reference_cb under KT_OPA_VT_MAG and KT_MAG_VT_OPA at q8q4
                and bitmap: per-slot decode scoring each slot's window
                (kernels 2 and 7 with their window probabilities),
                compactions by score and chunked prefill's streamed scores;
                every greedy pick equal or at a near-tie (OPA_CB_NOTE)
  reference_swa reference on a tiny model with a sliding window of 320: a
                600-token prompt (banded prefill), decode steps that leave
                pool chunk 0 below the window, every codec (kernels 1 and 6
                with the window), the dense cache through kernel 4 and the
                masked cache; every greedy pick equal, or a flip at a
                near-tie within SWA_TIE_TOL (a fixed bound; see
                SWA_PICKS_NOTE)
  reference_swa_cb
                the window (320) through the engine over the compressed
                cache at every codec (kernels 2 and 7, 3 and 8 with the
                window) and the chunked Generator at q8q4 and bitmap, card
                against CPU; picks as reference_swa's; the per-slot and
                segment kernels 2 x steps and 2 x segments (the tiny model's
                2 layers)
  reference_sample
                sampled decoding (temperature 0.9, top-k 50, top-p 0.95,
                seed 7) through the Generator and the engine on the card:
                every drawn token in the kept set of the CPU's filter on
                the card's logits, the same seed the same tokens, top-k 1
                the greedy tokens
  serve_q8q4    full-width, 32-layer Llama-3-8B with random W8 weights made
                on the card: Generator.generate, B=8, prompt 300, 300 new
                tokens, q8q4 compressed cache (one compaction on the way);
                every decode step must launch the kernel once per layer, and
                kernel 9 (K and V in one launch) once a layer for prefill's
                chunk and once for the compaction of every layer: 33
                launches
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
  serve_masked, serve_masked_opa, serve_opa_q8q4, serve_opa_bitmap
                the masked cache, 100 new tokens (EngineConfig defaults:
                KT_MAG_VT_MAG at 0.5, no kernel; KT_MAG_VC_OPA at 0.7
                through kernel 4 with its (m, l), 32 x 99 launches) and Opa
                in the compressed cache, 300 (KT_MAG_VT_OPA at 0.7: kernel
                1 or 6 with its window probabilities 32 x 299, kernel 9
                with V's scores 33 for q8q4); first tokens = serve_dense's
  decode_split  device time of a decode step's W8 projections, LM head and
                attention kernel, each timed alone, beside the step's wall time
  serve_cb      the continuous-batching engine at full width: 8 slots, 17
                requests (one of 8,000 prompt tokens), chunked interleaved
                admission; per-slot and segment kernel launches = 32 x decode
                steps and 32 x segments; first tokens = a batch-1 chunked
                Generator's
  serve_cb_bitmap, serve_cb_bitmap_q8
                serve_cb with the bitmap and bitmap-q8 codecs (peak memory
                and pool bytes side by side), at 8 of the 32 layers
                (CUT_LAYERS: 8 x steps and segments)
  serve_cb_q4q4 serve_cb with the q4q4 codec on its first 8 requests (8 of
                the 32 layers, CUT_LAYERS)
                without the 8,000-token one; kernel 9 (K and V in one
                launch) once a layer for every chunk a prompt packs and once
                for every compaction (q8q4 and q4q4)
  serve_cb_opa  serve_cb's first 8 requests (q8q4) under KT_MAG_VT_OPA at
                0.7, 8 of the 32 layers (CUT_LAYERS): kernel 2 with its window
                probabilities 8 x decode steps, kernel 3 8 x segments, kernel
                9 at the same packing
                counts (V ranked by its scores); first tokens = a batch-1
                chunked Generator's under the same method; V's scores live
                at the end
  serve_chunked Generator with chunked prefill at full width, B=4, 2,000 + 64
  serve_swa_dense, serve_swa_dense_kernel, serve_swa_q8q4, serve_swa_bitmap
                Mistral-7B with its 4,096 window (MISTRAL_7B_SWA), 32 layers,
                W8 (random, seed 0), B=4, prompt 4,400 (banded prefill), 300
                new tokens (chunk 0 below the window from the first step;
                one compaction): the dense cache plain and through kernel 4,
                q8q4 (kernel 1, kernel 9) and bitmap (kernel 6) with the
                window, 32 x 299 decode launches; first tokens =
                serve_swa_dense's; tok/s, prefill seconds, peak memory
  serve_cb_swa_q8q4, serve_cb_swa_bitmap
                serve_cb's requests (17, one of 8,000 tokens) through the
                engine on Mistral-7B with its window, full width and depth:
                the per-slot and segment kernels with the window 32 x steps
                and 32 x segments (kernel 9 for q8q4), first tokens = a
                batch-1 chunked Generator's; tok/s, peak memory, tick times
  serve_swa_chunked
                the chunked Generator on Mistral-7B, B=4, serve_swa's
                4,400-token prompt (18 segments) + 64: kernel 3 32 a
                segment, kernel 1 32 a step, kernel 9 32 a packed chunk;
                token agreement with serve_swa_q8q4
  host_split    one segment (B=1) at q8q4, bitmap and bitmap-q8, one K and V
                pack of a chunk at each, one decode tick (8 slots, q8q4) and
                one each of q8q4 and bitmap with an 8,000-token slot: host
                enqueue time, wall time, device time and kernels launched;
                at 8 of the 32 layers (CUT_LAYERS)
  serve_w4_dense, serve_w4_q8q4, serve_w4_bitmap
                the Generator at full width and depth with W4 weights
                (init_params_w4, seed 0), B=8, 300 + 300: W4 kernel 7 x 32 and
                the cache's decode kernel 32 a step (the dense cache through
                its kernel); first tokens = serve_w4_dense's
  decode_split_w4
                decode_split for the W4 step, per cache
  serve_cb_w4   serve_cb with W4 weights on the bitmap codec: its first 8
                requests without the 8,000-token one, at 8 of the 32 layers
                (CUT_LAYERS)
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


def cuda_ms(fn, reps, flush=None, spin=True, spin_cycles=SPIN_CYCLES):
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
    sees it.  ``spin_cycles`` lengthens the spin for a call whose host work
    takes longer than the default's ~2 ms."""
    import torch
    total, behind = 0.0, 0
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(spin_cycles)
        start.record()
        fn()
        behind += bool(start.query())
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps, behind


def in_turns(ms):
    """An option's times taken in turns on, off, off, on -> the least of
    each pair (one slow repetition, a host hiccup, moves a mean of 100 by
    several us) and the four."""
    return {"on": min(ms[0], ms[3]), "off": min(ms[1], ms[2]), "in_turns": ms}


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
    (and ``decode_split_plain`` and ``decode_ps_split_plain``, the decode
    kernels' split arithmetic), each decode with its options (``_wp``:
    window probabilities, ``_norm``: the final (m, l));
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
            self.decode = lambda q, nc, wl, li, **o: qa.fused_q_decode_attention(
                q, pool, scales, kw, vw, nc, wl, li, qc, **o)
            self.decode_plain = lambda q, nc, wl, li, **o: qa.fused_q_decode_attention_plain(
                q, pool, scales, kw, vw, nc, wl, li, qc, **o)
            self.decode_split_plain = lambda q, nc, wl, li, **o: \
                qa.fused_q_decode_attention_split_plain(q, pool, scales, kw, vw, nc, wl, li,
                                                        qc, **o)
            self.decode_wp = lambda q, nc, wl, li, **o: qa.fused_q_decode_attention(
                q, pool, scales, kw, vw, nc, wl, li, qc, return_win_probs=True, **o)
            self.decode_split_plain_wp = lambda q, nc, wl, li, **o: \
                qa.fused_q_decode_attention_split_plain(q, pool, scales, kw, vw, nc, wl, li,
                                                        qc, win_probs=True, **o)
            self.decode_norm = lambda q, nc, wl, li, **o: qa.fused_q_decode_attention(
                q, pool, scales, kw, vw, nc, wl, li, qc, return_norm=True, **o)
            self.decode_split_plain_norm = lambda q, nc, wl, li, **o: \
                qa.fused_q_decode_attention_split_plain(q, pool, scales, kw, vw, nc, wl, li,
                                                        qc, norm=True, **o)
            self.decode_ps = lambda q, nc, wl, li, **o: qa.fused_q_decode_attention_ps(
                q, pool, scales, kw, vw, nc, wl, li, qc, **o)
            self.decode_ps_wp = lambda q, nc, wl, li, **o: qa.fused_q_decode_attention_ps(
                q, pool, scales, kw, vw, nc, wl, li, qc, return_win_probs=True, **o)
            self.decode_ps_plain = lambda q, nc, wl, li, **o: \
                qa.fused_q_decode_attention_ps_plain(q, pool, scales, kw, vw, nc, wl, li,
                                                     qc, **o)
            self.decode_ps_split_plain = lambda q, nc, wl, li, **o: \
                qa.fused_q_decode_attention_ps_split_plain(q, pool, scales, kw, vw, nc, wl,
                                                           li, qc, **o)
            self.decode_ps_split_plain_wp = lambda q, nc, wl, li, **o: \
                qa.fused_q_decode_attention_ps_split_plain(q, pool, scales, kw, vw, nc, wl,
                                                           li, qc, win_probs=True, **o)
            self.segment = lambda q, nc, li, seg_start=None, window=None: \
                qa.fused_q_segment_attention(q, pool, scales, nc,
                                             nc * 256 if seg_start is None else seg_start,
                                             li, qc, window=window)
            self.segment_plain = lambda q, nc, li, seg_start=None, window=None: \
                qa.fused_q_segment_attention_plain(
                    q, pool, scales, nc, li, qc, nc * 256 if seg_start is None else seg_start,
                    window)
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
        self.decode = lambda q, nc, wl, li, **o: ska.fused_sparse_decode_attention(
            q, pool, kw, vw, nc, wl, li, fmt, fmt, **sc, **o)
        self.decode_plain = lambda q, nc, wl, li, **o: ska.fused_sparse_decode_attention_plain(
            q, pool, kw, vw, nc, wl, li, fmt, fmt, scales, **o)
        self.decode_split_plain = lambda q, nc, wl, li, **o: \
            ska.fused_sparse_decode_attention_split_plain(q, pool, kw, vw, nc, wl, li, fmt,
                                                          fmt, scales, **o)
        self.decode_wp = lambda q, nc, wl, li, **o: ska.fused_sparse_decode_attention(
            q, pool, kw, vw, nc, wl, li, fmt, fmt, **sc, return_win_probs=True, **o)
        self.decode_split_plain_wp = lambda q, nc, wl, li, **o: \
            ska.fused_sparse_decode_attention_split_plain(q, pool, kw, vw, nc, wl, li, fmt,
                                                          fmt, scales, win_probs=True, **o)
        self.decode_norm = lambda q, nc, wl, li, **o: ska.fused_sparse_decode_attention(
            q, pool, kw, vw, nc, wl, li, fmt, fmt, **sc, return_norm=True, **o)
        self.decode_split_plain_norm = lambda q, nc, wl, li, **o: \
            ska.fused_sparse_decode_attention_split_plain(q, pool, kw, vw, nc, wl, li, fmt,
                                                          fmt, scales, norm=True, **o)
        self.decode_ps = lambda q, nc, wl, li, **o: ska.fused_sparse_decode_attention_ps(
            q, pool, kw, vw, nc, wl, li, fmt, fmt, **sc, **o)
        self.decode_ps_wp = lambda q, nc, wl, li, **o: ska.fused_sparse_decode_attention_ps(
            q, pool, kw, vw, nc, wl, li, fmt, fmt, **sc, return_win_probs=True, **o)
        self.decode_ps_plain = lambda q, nc, wl, li, **o: \
            ska.fused_sparse_decode_attention_ps_plain(q, pool, kw, vw, nc, wl, li, fmt,
                                                       fmt, scales, **o)
        self.decode_ps_split_plain = lambda q, nc, wl, li, **o: \
            ska.fused_sparse_decode_attention_ps_split_plain(q, pool, kw, vw, nc, wl, li,
                                                             fmt, fmt, scales, **o)
        self.decode_ps_split_plain_wp = lambda q, nc, wl, li, **o: \
            ska.fused_sparse_decode_attention_ps_split_plain(q, pool, kw, vw, nc, wl, li,
                                                             fmt, fmt, scales, win_probs=True,
                                                             **o)
        self.segment = lambda q, nc, li, seg_start=None, window=None: \
            ska.fused_sparse_segment_attention(
                q, pool, nc, nc * 256 if seg_start is None else seg_start, li, fmt, fmt,
                **sc, window=window)
        self.segment_plain = lambda q, nc, li, seg_start=None, window=None: \
            ska.fused_sparse_segment_attention_plain(
                q, pool, nc, li, fmt, fmt, scales,
                nc * 256 if seg_start is None else seg_start, window)


# the kernels line's fixed fields, by codec family and kernel
KERNEL_META = {
    ("quant", "decode"): ("fused_q_decode_attention", "q_decode.cu",
                          "quant_attention.py:223"),
    ("quant", "decode_ps"): ("fused_q_decode_attention_ps", "q_decode_ps.cu",
                             "quant_attention.py:516"),
    ("quant", "segment"): ("fused_q_segment_attention", "q_segment.cu",
                           "quant_attention.py:704"),
    ("quant", "pack"): ("prune_quant_pack_kv", "prune_quant_pack.cu", "pack_kernel.py:101"),
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
    0.7 and 0.5 and timed at 0.7.  Each case is held to the TPU-order plain
    version and to the kernel's split plain version (``split_gate``); a
    second launch must give the same bits, and the C entry must refuse
    short scratch.  Timed at 1 chunk + 288 window and at the full pool."""
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
    results, worst, worst_split = [], 0.0, 0.0
    every_row = torch.ones(B, dtype=torch.bool, device=dev)
    for kit in kits:
        for nc, wl, li in cases:
            for qq in (q, q.float(), *other_groups):
                got = kit.decode(qq, nc, wl, li)
                again = kit.decode(qq, nc, wl, li)
                torch.cuda.synchronize()
                want = kit.decode_plain(qq, nc, wl, li)
                err = (got.float() - want.float()).abs().max().item()
                scale = want.float().abs().max().item()
                # the TPU's steps, f32 sums in another order and p rounded at
                # each split's own max: a bf16(p) or the bf16 output may move
                # by one ulp each
                tol = KERNEL_TOL_ULPS * 2.0 ** -8 * scale
                split = split_gate(got, kit.decode_split_plain(qq.float(), nc, wl, li),
                                   every_row)
                results.append({"sparsity": kit.sparsity, "n_chunks": nc, "win_len": wl,
                                "li": li, "q_dtype": str(qq.dtype).split(".")[-1],
                                "G": qq.shape[2] // Hkv, "max_abs_err": err, "tol": tol,
                                "worst_err_over_tol_split": split,
                                "second_launch_equal": bool(torch.equal(got, again))})
                if not (got.isfinite().all() and err <= tol and split <= 1.0
                        and results[-1]["second_launch_equal"]):
                    raise AssertionError(f"kernel disagrees with its plain versions or "
                                         f"with itself: {results[-1]}")
                worst = max(worst, err / max(tol, 1e-30))
                worst_split = max(worst_split, split)

    probs_cases, probs_worst = _check_win_probs(kits[0], (q, q.float()), cases + [(0, 0, 0)])
    more, worse = _check_win_probs(kits[0], other_groups, cases[:2])
    probs_cases, probs_worst = probs_cases + more, max(probs_worst, worse)
    norm_cases, norm_worst = _check_uniform_norm(kits[0], (q, q.float()),
                                                 cases + [(0, 0, 0)])
    more, worse = _check_uniform_norm(kits[0], other_groups, cases[:2])
    norm_cases, norm_worst = norm_cases + more, max(norm_worst, worse)
    window = _check_windows(kits, q, other_groups, L)

    # time at the main path's largest pre-compaction shape: one pool chunk
    # and a full 288-token window, L2 flushed before each launch
    kit = kits[0]
    nc, wl, li = 1, 288, 0
    if not refuses_short_scratch(lambda: kit.decode(q, nc, wl, li)):
        raise AssertionError("uniform kernel took scratch shorter than its grid needs")
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    for _ in range(10):
        kit.decode(q, nc, wl, li)
        kit.decode_plain(q, nc, wl, li)
    for _ in range(200):                 # the kernel alone, a few ms, before timing it
        kit.decode(q, nc, wl, li)
    torch.cuda.synchronize()
    kernel_ms, behind = cuda_ms(lambda: kit.decode(q, nc, wl, li), 100,
                                flush=flush_buf.zero_)
    plain_ms, _ = cuda_ms(lambda: kit.decode_plain(q, nc, wl, li), 20,
                          flush=flush_buf.zero_, spin=False)
    hot_ms, _ = cuda_ms(lambda: kit.decode(q, nc, wl, li), 100)
    full_ms, _ = cuda_ms(lambda: kit.decode(q, mc, 288, li), 100, flush=flush_buf.zero_)
    # the window probabilities on and off, in turns
    probs_ms = [cuda_ms(call, 100, flush=flush_buf.zero_)[0]
                for call in (lambda: kit.decode_wp(q, nc, wl, li),
                             lambda: kit.decode(q, nc, wl, li),
                             lambda: kit.decode(q, nc, wl, li),
                             lambda: kit.decode_wp(q, nc, wl, li))]
    probs_plain_ms, _ = cuda_ms(lambda: kit.decode_split_plain_wp(q, nc, wl, li), 5,
                                flush=flush_buf.zero_, spin=False)
    # the final (m, l) on and off, in turns
    norm_ms = [cuda_ms(call, 100, flush=flush_buf.zero_)[0]
               for call in (lambda: kit.decode_norm(q, nc, wl, li),
                            lambda: kit.decode(q, nc, wl, li),
                            lambda: kit.decode(q, nc, wl, li),
                            lambda: kit.decode_norm(q, nc, wl, li))]
    norm_plain_ms, _ = cuda_ms(lambda: kit.decode_split_plain_norm(q, nc, wl, li), 5,
                               flush=flush_buf.zero_, spin=False)
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
         cases=results, worst_err_over_tol=worst, worst_err_over_tol_split=worst_split,
         kernel_ms=kernel_ms, kernel_ms_l2_hot=hot_ms,
         kernel_ms_full_pool=full_ms, plain_ms=plain_ms, host_behind=behind,
         wrapper_host_us=wrapper_us, win_probs_cases=probs_cases,
         win_probs_ms=dict(in_turns(probs_ms), split_plain=probs_plain_ms),
         return_norm_cases=norm_cases,
         return_norm_ms=dict(in_turns(norm_ms), split_plain=norm_plain_ms),
         window=window,
         timed_at={"sparsity": kit.sparsity, "n_chunks": nc, "win_len": wl},
         bytes=nbytes, flops=flops, bound_ms=max(bytes_ms, flops_ms), library_ms=None)
    entry = _entry(codec, "decode", results, worst, max(r["tol"] for r in results),
                   kernel_ms, plain_ms, bytes_ms, flops_ms)
    entry.update(max_err=entry["max_abs_err"], worst_err_over_tol_split=worst_split,
                 tol_split=SPLIT_TOL_NOTE)
    entry["options"] = {"return_win_probs": {
        "max_abs_err": max(r["probs_max_abs_err"] for r in probs_cases),
        "tol": WIN_PROBS_TOL, "worst_err_over_tol": probs_worst,
        "ms": in_turns(probs_ms)["on"], "ms_off": in_turns(probs_ms)["off"],
        "plain_ms": probs_plain_ms, "launches": None,
        "timed_at": "as ms: 1 chunk + 288 window, in turns on, off, off, on (the least "
                    "of each pair)"},
        "return_norm": {
        "max_abs_err_m": max(r["m_max_abs_err"] for r in norm_cases),
        "max_rel_err_l": max(r["l_max_rel_err"] for r in norm_cases),
        "tol": NORM_TOL_NOTE, "worst_err_over_tol": norm_worst,
        "ms": in_turns(norm_ms)["on"], "ms_off": in_turns(norm_ms)["off"],
        "plain_ms": norm_plain_ms, "launches": 0,
        "launches_note": "no serving path asks for it (the JAX package's paths do not)",
        "timed_at": "as ms: 1 chunk + 288 window, in turns on, off, off, on (the least "
                    "of each pair)"},
        "window": _window_option(window)}
    return entry


def _window_option(w):
    """The kernels line's record of a kernel's sliding window, from the
    phase's window results (``launches`` filled by its serve_swa or
    serve_cb_swa phase)."""
    t = w["timed"]
    return {"max_abs_err": w["max_abs_err"], "tol": w["tol"],
            "worst_err_over_tol": w["worst_err_over_tol"],
            "worst_err_over_tol_split": w["worst_err_over_tol_split"],
            "ms": t["ms_on"], "ms_off": t["ms_off"], "bound_ms": t["bound_ms"],
            "bound_ms_off": t["bound_ms_off"], "bound_by": "bytes",
            "plain_ms": t["plain_ms"], "library_ms": t.get("library_ms"),
            "launches": None, "timed_at": t["timed_at"]}


# sliding-window cases of the uniform decode kernels at the flagship kit's
# shape (mc = 5, W = 288): (n_chunks, win_len, li, window); the decoded token
# is at n_chunks * 256 + win_len - 1 and the window keeps columns past
# low = that - window
WINDOW_CASES = (
    (5, 288, 3, 1000),     # low 567: chunks 0-1 left out, chunk 2 cut mid-run
    (5, 100, 0, 612),      # low 767: a chunk boundary, chunks 0-2 left out
    (5, 100, 0, 548),      # low 831: a 64-token step boundary inside chunk 3
    (3, 288, 3, 500),      # low 555: chunk 2 cut
    (1, 288, 0, 300),      # low 243: the only chunk cut
    (5, 288, 0, 288),      # low 1279: every chunk left out, the window alone
    (5, 1, 0, 4096))       # vacuous: nothing masked
# the serve_swa shape the window is timed at: Mistral-7B's B=4, 8 kv heads,
# G=4; 17 chunks (a 4,400-token prompt) and 160 window tokens: position
# 4,511, window 4,096, low 415
SWA_TIMED = {"B": 4, "Hkv": 8, "G": 4, "mc": 19, "n_chunks": 17, "win_len": 160,
             "window": 4096}
# (n_chunks, win_len) of serve_swa's decode steps the kernels are held at
# there: its decodes run at 17 chunks + 49..288 window tokens, then (after
# the compaction) 18 + 33..91.  The first step (low 304: chunk 0 left out,
# chunk 1 cut), the timed one (low 415), a chunk boundary (low 511: chunks
# 0-1 left out), the last before the compaction (low 543), the first and
# the last after it (low 544, 602)
SWA_SERVED = ((17, 49), (17, 160), (17, 256), (17, 288), (18, 33), (18, 91))


def _hold_windows(kit, cases, qs_of):
    """The uniform decode kernel with a sliding window at each case
    (n_chunks, win_len, li, window), for each q of ``qs_of(case index)``:
    held to the TPU-order plain version at 2 bf16 ulps of the output's
    scale and to its split plain version by ``split_gate``, a second launch
    bit-equal.  Returns (the cases, the worst error over each tolerance)."""
    import torch
    from mustafar_tpu_torch.ops.kernels import quant_attention as qa
    results, worst, worst_split = [], 0.0, 0.0
    for i, (nc, wl, li, window) in enumerate(cases):
        for qq in qs_of(i):
            B = qq.shape[0]
            got = kit.decode(qq, nc, wl, li, window=window)
            again = kit.decode(qq, nc, wl, li, window=window)
            torch.cuda.synchronize()
            want = kit.decode_plain(qq, nc, wl, li, window=window)
            err = (got.float() - want.float()).abs().max().item()
            tol = KERNEL_TOL_ULPS * 2.0 ** -8 * want.float().abs().max().item()
            split = split_gate(got, kit.decode_split_plain(qq.float(), nc, wl, li,
                                                           window=window),
                               torch.ones(B, dtype=torch.bool, device=qq.device))
            results.append({"sparsity": kit.sparsity, "B": B, "n_chunks": nc,
                            "win_len": wl, "li": li, "window": window,
                            "low": qa.window_low(nc, wl, window),
                            "q_dtype": str(qq.dtype).split(".")[-1],
                            "G": qq.shape[2] // (kit.k_win.shape[1] // B),
                            "max_abs_err": err, "tol": tol,
                            "worst_err_over_tol_split": split,
                            "second_launch_equal": bool(torch.equal(got, again))})
            if not (got.isfinite().all() and err <= tol and split <= 1.0
                    and results[-1]["second_launch_equal"]):
                raise AssertionError(f"windowed kernel disagrees with its plain "
                                     f"versions or with itself: {results[-1]}")
            worst = max(worst, err / max(tol, 1e-30))
            worst_split = max(worst_split, split)
    return results, worst, worst_split


def _check_windows(kits, q, other_groups, L):
    """The uniform decode kernel with a sliding window (``_hold_windows``):
    at WINDOW_CASES with f32 and bf16 q, and the other groups at the first
    two cases; the window probabilities and (m, l) with a window at the
    first case.  Then, at SWA_TIMED, held at serve_swa's own shapes and
    timed with the window on and off, in turns (``_time_window``)."""
    results, worst, worst_split = [], 0.0, 0.0
    for kit in kits:
        got = _hold_windows(kit, WINDOW_CASES,
                            lambda i: (q, q.float(), *(other_groups if i < 2 else ())))
        results += got[0]
        worst, worst_split = max(worst, got[1]), max(worst_split, got[2])
    probs, probs_worst = _check_win_probs(kits[0], (q, q.float()), WINDOW_CASES[:1])
    norm, norm_worst = _check_uniform_norm(kits[0], (q, q.float()), WINDOW_CASES[:1])
    timed = _time_window(kits[0].codec, kits[0].sparsity)
    results += timed.pop("cases")
    worst = max(worst, timed.pop("worst_err_over_tol"))
    worst_split = max(worst_split, timed.pop("worst_err_over_tol_split"))
    return {"cases": results, "max_abs_err": max(r["max_abs_err"] for r in results),
            "tol": "2 bf16 ulps of the output's scale (TPU order); " + SPLIT_TOL_NOTE,
            "worst_err_over_tol": worst, "worst_err_over_tol_split": worst_split,
            "win_probs_cases": probs, "win_probs_worst": probs_worst,
            "return_norm_cases": norm, "return_norm_worst": norm_worst,
            "timed": timed}


def _time_window(codec, sparsity):
    """The uniform decode kernel at SWA_TIMED's B, heads and window: first
    held (``_hold_windows``, bf16 and f32 q) at the serve_swa phases' own
    counts (SWA_SERVED), then timed at SWA_TIMED's with the window on and
    off, in turns on, off, off, on (the least of each pair), L2 flushed;
    the byte bounds count the chunks each reads (with the window, those
    with a live column)."""
    import torch
    from mustafar_tpu_torch.ops.kernels import quant_attention as qa
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(19)
    s = SWA_TIMED
    B, Hkv, G, nc, wl, window = (s[k] for k in ("B", "Hkv", "G", "n_chunks", "win_len",
                                                "window"))
    BH = B * Hkv
    kit = _Kit(codec, g, dev, 1, s["mc"], BH, 288, sparsity)
    q = torch.randn((B, 1, Hkv * G, 128), generator=g, device=dev).to(torch.bfloat16)
    fn = kit.fns["decode"]
    launches0 = fn.launches
    held, worst, worst_split = _hold_windows(
        kit, [(c, w, 0, window) for c, w in SWA_SERVED], lambda i: (q, q.float()))
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    for _ in range(20):
        kit.decode(q, nc, wl, 0, window=window)
        kit.decode(q, nc, wl, 0)
    torch.cuda.synchronize()
    ms = [cuda_ms(call, 100, flush=flush_buf.zero_)[0]
          for call in (lambda: kit.decode(q, nc, wl, 0, window=window),
                       lambda: kit.decode(q, nc, wl, 0), lambda: kit.decode(q, nc, wl, 0),
                       lambda: kit.decode(q, nc, wl, 0, window=window))]
    plain_ms, _ = cuda_ms(lambda: kit.decode_plain(q, nc, wl, 0, window=window), 3,
                          flush=flush_buf.zero_, spin=False)
    fn.launches = launches0
    live = nc - qa.masked_steps(nc, wl, window, 256)        # chunks with a live column

    def bound(chunks):
        nbytes = BH * (chunks * kit.chunk_bytes + 2 * wl * 128 * 2) + 2 * q.numel() * 2
        flops = BH * G * (chunks * 256 + wl) * 128 * 2 * 2
        return max(nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS) * 1e3
    turns = in_turns(ms)
    return {"timed_at": f"B={B}, Hkv={Hkv}, G={G}, {nc} chunks + {wl} window, window "
                        f"{window} (low {qa.window_low(nc, wl, window)}: {nc - live} chunk "
                        f"left out), in turns on, off, off, on (the least of each pair)",
            "ms_on": turns["on"], "ms_off": turns["off"], "in_turns": ms,
            "live_chunks": live, "bound_ms": bound(live), "bound_ms_off": bound(nc),
            "plain_ms": plain_ms, "cases": held, "worst_err_over_tol": worst,
            "worst_err_over_tol_split": worst_split}


def _check_uniform_norm(kit, qs, cases):
    """The uniform decode kernel's final (m, l) (``return_norm``) against its
    split plain version's (NORM_TOL_NOTE; nothing to attend: -1e30 and 0
    from both), and the output with the option bit-equal to the output
    without it.  A case (n_chunks, win_len, li) may add a sliding window.
    Returns (the cases, the worst error over the tolerance)."""
    import torch
    results, worst = [], 0.0
    for nc, wl, li, *window in cases:
        o = {"window": window[0]} if window else {}
        for qq in qs:
            out, m, l = kit.decode_norm(qq, nc, wl, li, **o)
            plain = kit.decode(qq, nc, wl, li, **o)
            torch.cuda.synchronize()
            _, want_m, want_l = kit.decode_split_plain_norm(qq.float(), nc, wl, li, **o)
            m_err = (m - want_m).abs().max().item()
            l_err = ((l - want_l).abs() / want_l.clamp_min(1.0)).max().item()
            results.append({"n_chunks": nc, "win_len": wl, "li": li, **o,
                            "q_dtype": str(qq.dtype).split(".")[-1], "G": m.shape[2],
                            "m_max_abs_err": m_err, "l_max_rel_err": l_err,
                            "out_equal_without": bool(torch.equal(out, plain))})
            if not (results[-1]["out_equal_without"] and m_err <= NORM_TOL
                    and l_err <= NORM_TOL):
                raise AssertionError(f"uniform decode kernel's (m, l) disagree with its "
                                     f"split plain version's, or change the output: "
                                     f"{results[-1]}")
            worst = max(worst, max(m_err, l_err) / NORM_TOL)
    return results, worst


WIN_PROBS_TOL = 2.0 ** -18   # absolute, of probabilities summed over <= 8 heads


def _check_win_probs(kit, qs, cases):
    """The uniform decode kernel's window probabilities (``return_win_probs``)
    against its split plain version's, within WIN_PROBS_TOL absolute (the
    scores and the merged (m, l) are the plain version's bit for bit; expf
    and the division differ by an ulp or so), 0 at and past ``win_len``,
    and the output with the option bit-equal to the output without it.  A
    case (n_chunks, win_len, li) may add a sliding window.  Returns (the
    cases, the worst error over the tolerance)."""
    import torch
    results, worst = [], 0.0
    for nc, wl, li, *window in cases:
        o = {"window": window[0]} if window else {}
        for qq in qs:
            out, probs = kit.decode_wp(qq, nc, wl, li, **o)
            plain = kit.decode(qq, nc, wl, li, **o)
            torch.cuda.synchronize()
            _, want = kit.decode_split_plain_wp(qq.float(), nc, wl, li, **o)
            err = (probs - want).abs().max().item()
            ok = (bool(torch.equal(out, plain)) and bool(probs.isfinite().all())
                  and err <= WIN_PROBS_TOL and bool((probs[..., wl:] == 0).all()))
            results.append({"n_chunks": nc, "win_len": wl, "li": li, **o,
                            "q_dtype": str(qq.dtype).split(".")[-1],
                            "G": qq.shape[2] // probs.shape[1], "probs_max_abs_err": err,
                            "out_equal_without": bool(torch.equal(out, plain))})
            if not ok:
                raise AssertionError(f"window probabilities disagree with the split plain "
                                     f"version (tol {WIN_PROBS_TOL}) or change the "
                                     f"output: {results[-1]}")
            worst = max(worst, err / WIN_PROBS_TOL)
    return results, worst


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
                    results.append(_hold_ps(kit, qq, nc, wl, li))
                    worst = max(worst, results[-1]["worst_err_over_tol"])
                    worst_split = max(worst_split, results[-1]["worst_err_over_tol_split"])

    # the window probabilities (return_win_probs) at every group size
    kit = kits[0]
    qs = [torch.randn((B, 1, Hkv * G, D), generator=g, device=dev).to(torch.bfloat16)
          for G in (4, 1, 2, 8)]
    probs_cases, probs_worst = _check_ps_win_probs(kit, [qs[0], qs[0].float(), *qs[1:]],
                                                   nc, wl, W)
    window = _check_ps_windows(kit, qs, counts, slots)

    # time at the serving shape (G=4), the mixed slots above, L2 flushed
    q = torch.randn((B, 1, Hkv * 4, D), generator=g, device=dev).to(torch.bfloat16)
    if not refuses_short_scratch(lambda: kit.decode_ps(q, nc, wl, 0)):
        raise AssertionError("per-slot kernel took scratch shorter than its grid needs")
    if not refuses_short_scratch(lambda: kit.decode_ps_wp(q, nc, wl, 0)):
        raise AssertionError("per-slot kernel took scratch shorter than its grid needs "
                             "(with the window probabilities)")
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
    # the window probabilities on and off, in turns
    probs_ms = [cuda_ms(call, 100, flush=flush_buf.zero_)[0]
                for call in (lambda: kit.decode_ps_wp(q, nc, wl, 0),
                             lambda: kit.decode_ps(q, nc, wl, 0),
                             lambda: kit.decode_ps(q, nc, wl, 0),
                             lambda: kit.decode_ps_wp(q, nc, wl, 0))]
    probs_plain_ms, _ = cuda_ms(lambda: kit.decode_ps_split_plain_wp(q, nc, wl, 0), 3,
                                flush=flush_buf.zero_, spin=False)
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
         flops=flops, bound_ms=max(bytes_ms, flops_ms), library_ms=None,
         win_probs_cases=probs_cases,
         win_probs_ms=dict(in_turns(probs_ms), split_plain=probs_plain_ms), window=window)
    entry = _entry(codec, "decode_ps", results, worst,
                   "per slot: 2 bf16 ulps of the slot's largest output",
                   kernel_ms, plain_ms, bytes_ms, flops_ms)
    entry.update(worst_err_over_tol_split=worst_split, tol_split=SPLIT_TOL_NOTE)
    entry["options"] = {"return_win_probs": {
        "max_abs_err": max(r["probs_max_abs_err"] for r in probs_cases),
        "tol": WIN_PROBS_TOL, "worst_err_over_tol": probs_worst,
        "ms": in_turns(probs_ms)["on"], "ms_off": in_turns(probs_ms)["off"],
        "plain_ms": probs_plain_ms, "launches": None,
        "timed_at": "as ms: the mixed slots, G=4, in turns on, off, off, on (the least of "
                    "each pair)"},
        "window": _window_option(window)}
    return entry


def _hold_ps(kit, qq, nc, wl, li, **o):
    """The per-slot kernel at counts ``nc``, ``wl`` (and a sliding window in
    ``o``) against its TPU-order plain version, each slot within 2 bf16 ulps
    of its own output scale (so a slot of small outputs, many chunks, is
    held as tightly as a one-token slot), an idle slot 0 and a live one
    not, and against its split plain version by ``split_gate``; a second
    launch bit-equal.  Returns the case; raises on a miss."""
    import torch
    got = kit.decode_ps(qq, nc, wl, li, **o)
    again = kit.decode_ps(qq, nc, wl, li, **o)
    torch.cuda.synchronize()
    want = kit.decode_ps_plain(qq, nc, wl, li, **o)
    dims = (1, 2, 3)
    errs = (got.float() - want.float()).abs().amax(dim=dims)
    tols = KERNEL_TOL_ULPS * 2.0 ** -8 * want.float().abs().amax(dim=dims)
    live = (nc > 0) | (wl > 0)
    idle_zero = bool((got[~live] == 0).all())
    live_nonzero = bool((got.float().abs().amax(dim=dims)[live] > 0).all())
    ratio = (errs[live] / tols[live].clamp_min(1e-30)).max().item()
    case = {"sparsity": kit.sparsity, "G": qq.shape[2] // (kit.k_win.shape[1] // qq.shape[0]),
            "q_dtype": str(qq.dtype).split(".")[-1], "li": li, **o,
            "max_abs_err": errs.max().item(), "slot_err": errs.tolist(),
            "slot_tol": tols.tolist(), "worst_err_over_tol": ratio,
            "idle_slots_zero": idle_zero, "live_slots_nonzero": live_nonzero,
            "second_launch_equal": bool(torch.equal(got, again))}
    if not (got.isfinite().all() and ratio <= 1.0 and idle_zero and live_nonzero
            and case["second_launch_equal"]):
        raise AssertionError(f"per-slot kernel disagrees with its plain version or with "
                             f"itself: {case}")
    # the kernel's own arithmetic: splits merged
    case["worst_err_over_tol_split"] = split_gate(
        got, kit.decode_ps_split_plain(qq.float(), nc, wl, li, **o), live)
    if not case["worst_err_over_tol_split"] <= 1.0:
        raise AssertionError(f"per-slot kernel disagrees with its split plain version: "
                             f"{case}")
    return case


# per-slot sliding-window cases at kernel_ps's pool (mc = 32, W = 288):
# window -> the 8 slots' (n_chunks, win_len); slot b's edge is low =
# n_chunks * 256 + win_len - 1 - window, its first live chunk (low + 1) // 256
PS_WINDOW_CASES = {
    # Mistral's window at the engine's shape: the 8,000-token slot at 31
    # chunks + 160 (low 3,999: 15 chunks wholly below, chunk 15 cut) and at
    # 31 + 256 (low 4,095: 16 below, on a chunk boundary), 16 + 256 (low
    # 255: chunk 0 below), 17 + 160 (low 415: chunk 1 cut), an idle slot and
    # three the window covers
    4096: ((31, 160), (0, 0), (16, 256), (17, 160), (1, 44), (5, 288), (31, 256), (2, 1)),
    # test-size windows: low 479 (chunk 1 cut), 511 (chunks 0-1 below, on a
    # boundary), 960 (chunk 3 cut), idle, vacuous, 7,903 (30 below), 1,247
    # (chunk 4 cut), a slot with no chunk
    320: ((2, 288), (3, 64), (5, 1), (0, 0), (1, 44), (31, 288), (5, 288), (0, 232)),
    # low 511 (every chunk below: the window alone), 11 (chunk 0 cut), 992,
    # idle, 7,807, 835, 255 (the only chunk below), one token and no chunk
    288: ((2, 288), (1, 44), (5, 1), (0, 0), (31, 160), (4, 100), (1, 288), (0, 1)),
}
# the 8,000-token slot as serve_cb_swa decodes it: 31 chunks + 160 (15 of
# them wholly below Mistral's window), beside kernel_ps's other slots
PS_WINDOW_TIMED = 4096


def _check_ps_windows(kit, qs, counts, slots):
    """The per-slot kernel with a sliding window (``_hold_ps``) at each
    PS_WINDOW_CASES window, bf16 and f32 q at G=4 and bf16 at G=1/2/8 (qs:
    G = 4, 1, 2, 8), with its window probabilities within WIN_PROBS_TOL of
    the split plain version's; then timed with Mistral's window on and off,
    in turns, at kernel_ps's slots with the 8,000-token one at 31 chunks +
    160, beside each's byte bound (live chunks only)."""
    import torch
    from mustafar_tpu_torch.ops.kernels import quant_attention as qa
    results, probs, worst, worst_split, probs_worst = [], [], 0.0, 0.0, 0.0
    for window, sl in PS_WINDOW_CASES.items():
        nc, wl = counts(sl)
        for qq in (qs[0], qs[0].float(), *(qs[1:] if window == 4096 else ())):
            results.append(dict(_hold_ps(kit, qq, nc, wl, 0, window=window),
                                slots=list(sl),
                                lows=[qa.window_low(c, w, window) for c, w in sl]))
            worst = max(worst, results[-1]["worst_err_over_tol"])
            worst_split = max(worst_split, results[-1]["worst_err_over_tol_split"])
        for qq in (qs[0], qs[0].float()):
            out, pr = kit.decode_ps_wp(qq, nc, wl, 0, window=window)
            plain = kit.decode_ps(qq, nc, wl, 0, window=window)
            torch.cuda.synchronize()
            _, want = kit.decode_ps_split_plain_wp(qq.float(), nc, wl, 0, window=window)
            err = (pr - want).abs().max().item()
            probs.append({"window": window, "q_dtype": str(qq.dtype).split(".")[-1],
                          "probs_max_abs_err": err,
                          "out_equal_without": bool(torch.equal(out, plain))})
            if not (probs[-1]["out_equal_without"] and err <= WIN_PROBS_TOL
                    and bool(pr.isfinite().all())):
                raise AssertionError(f"per-slot window probabilities with the window "
                                     f"disagree with the split plain version: {probs[-1]}")
            probs_worst = max(probs_worst, err / WIN_PROBS_TOL)
    q = qs[0]
    window = PS_WINDOW_TIMED
    timed_slots = [(c, 160) if c == 31 else (c, w) for c, w in slots]
    nc, wl = counts(timed_slots)
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=q.device)
    for _ in range(10):
        kit.decode_ps(q, nc, wl, 0, window=window)
    torch.cuda.synchronize()
    ms = [cuda_ms(call, 100, flush=flush_buf.zero_)[0]
          for call in (lambda: kit.decode_ps(q, nc, wl, 0, window=window),
                       lambda: kit.decode_ps(q, nc, wl, 0), lambda: kit.decode_ps(q, nc, wl, 0),
                       lambda: kit.decode_ps(q, nc, wl, 0, window=window))]
    plain_ms, _ = cuda_ms(lambda: kit.decode_ps_plain(q, nc, wl, 0, window=window), 3,
                          flush=flush_buf.zero_, spin=False)
    Hkv = kit.k_win.shape[1] // q.shape[0]
    G = q.shape[2] // Hkv
    live = [c - qa.masked_steps(c, w, window, 256) for c, w in timed_slots]

    def bound(chunks):
        n_tok = sum(c * 256 + w for c, (_, w) in zip(chunks, timed_slots))
        nbytes = (Hkv * sum(c * kit.chunk_bytes + 2 * w * 128 * 2
                            for c, (_, w) in zip(chunks, timed_slots))
                  + 2 * q.numel() * 2 + 2 * q.shape[0] * 4)
        flops = Hkv * G * n_tok * 128 * 2 * 2
        return max(nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS) * 1e3
    turns = in_turns(ms)
    timed = {"timed_at": f"the slots {timed_slots}, G={G}, window {window} (the 31-chunk "
                         f"slot's low {qa.window_low(31, 160, window)}: "
                         f"{31 - live[timed_slots.index((31, 160))]} chunks left out), "
                         f"in turns on, off, off, on (the least of each pair)",
             "ms_on": turns["on"], "ms_off": turns["off"], "in_turns": ms,
             "live_chunks": sum(live), "chunks": sum(c for c, _ in timed_slots),
             "bound_ms": bound(live), "bound_ms_off": bound([c for c, _ in timed_slots]),
             "plain_ms": plain_ms}
    return {"cases": results, "max_abs_err": max(r["max_abs_err"] for r in results),
            "tol": "per slot: 2 bf16 ulps of the slot's largest output (TPU order); "
                   + SPLIT_TOL_NOTE,
            "worst_err_over_tol": worst, "worst_err_over_tol_split": worst_split,
            "win_probs_cases": probs, "win_probs_worst": probs_worst, "timed": timed}


def _check_ps_win_probs(kit, qs, nc, wl, W):
    """The per-slot kernel's window probabilities (``return_win_probs``)
    against its split plain version's, within WIN_PROBS_TOL absolute, each
    slot's 0 at and past its ``win_len`` (an idle slot's all 0), and the
    output with the option bit-equal to the output without it.  Returns
    (the cases, the worst error over the tolerance)."""
    import torch
    results, worst = [], 0.0
    past = (torch.arange(W, device=wl.device)[None, :] >= wl.clamp(0, W)[:, None])
    for qq in qs:
        out, probs = kit.decode_ps_wp(qq, nc, wl, 0)
        plain = kit.decode_ps(qq, nc, wl, 0)
        torch.cuda.synchronize()
        _, want = kit.decode_ps_split_plain_wp(qq.float(), nc, wl, 0)
        err = (probs - want).abs().max().item()
        zero_past = bool((probs.masked_select(past[:, None, :]) == 0).all())
        results.append({"q_dtype": str(qq.dtype).split(".")[-1],
                        "G": qq.shape[2] // probs.shape[1], "probs_max_abs_err": err,
                        "zero_past_win_len": zero_past,
                        "out_equal_without": bool(torch.equal(out, plain))})
        if not (results[-1]["out_equal_without"] and zero_past and err <= WIN_PROBS_TOL
                and bool(probs.isfinite().all())):
            raise AssertionError(f"per-slot window probabilities disagree with the split "
                                 f"plain version (tol {WIN_PROBS_TOL}) or change the "
                                 f"output: {results[-1]}")
        worst = max(worst, err / WIN_PROBS_TOL)
    return results, worst


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

    window = _check_seg_windows(kits, g, Hq, Hkv, T, L)
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
         bound_ms=max(bytes_ms, flops_ms), library_ms=None, window=window)
    entry = _entry(codec, "segment", results, worst,
                   max(r.get("tol", 0.0) for r in results),
                   kernel_ms, plain_ms, bytes_ms, flops_ms)
    if clusters is not None:
        entry["clusters"] = clusters
    if by_chunks:
        entry["kernel_ms_by_chunks"] = by_chunks
    entry["options"] = {"window": dict(_window_option(window), bound_by=window["bound_by"])}
    return entry


# sliding-window cases of the segment kernels: (n_chunks, seg_start, window);
# query row t*G + g sees the pool columns past seg_start + t - window
SEG_WINDOW_CASES = (
    (30, 7936, 4096),   # chunks 0-14 dead for every row, the edge through chunk 15
    (1, 512, 288),      # the edge through chunk 0; rows of tokens 31 on see no pool column
    (1, 512, 320),      # tokens 63 on see none
    (4, 1280, 320),     # chunks 0-2 dead for every row; the edge through chunk 3
    (4, 1280, 288),     # chunks 0-2 dead; tokens 31 on see no pool column
)
# timed at the longest prompt's last segment: 31 chunks, seg_start 7,936,
# Mistral's window (chunks 0-14 dead for every row)
SEG_WINDOW_TIMED = (31, 7936, 4096)


def _check_seg_windows(kits, g, Hq, Hkv, T, L):
    """The segment kernel with a sliding window at each SEG_WINDOW_CASES
    case, B = 1 and 2 (``kits`` by (B, sparsity)), bf16 q: the rows with a
    live pool column held to the plain version (normalised output within 2
    bf16 ulps of its scale, m within 1e-5 of its scale, l within 1e-4
    relative), the rows with none m = -1e30 in both; every row after
    ``merge_partials`` with a causal self partial within 2 bf16 ulps of the
    plain version's merge; no NaN in any partial; a second launch
    bit-equal.  Then timed at SEG_WINDOW_TIMED, B=1, window on and off in
    turns, beside each's bound (on: the live (row, column) pairs' products
    and the chunks with a live column)."""
    import torch
    from mustafar_tpu_torch.ops.attention import attention_partials, merge_partials
    from mustafar_tpu_torch.ops.kernels import quant_attention as qa
    D = 128
    G = Hq // Hkv
    results, worst = [], 0.0
    for nc, seg_start, window in SEG_WINDOW_CASES:
        for B in (1, 2):
            kit = kits[(B, 0.7)]
            dev = kit.k_win.device
            qq = torch.randn((B, T, Hq, D), generator=g, device=dev).to(torch.bfloat16)
            k, v = (torch.randn((B, T, Hkv, D), generator=g, device=dev).to(torch.bfloat16)
                    for _ in range(2))
            li = nc % L
            got = kit.segment(qq, nc, li, seg_start, window)
            again = kit.segment(qq, nc, li, seg_start, window)
            torch.cuda.synchronize()
            want = kit.segment_plain(qq, nc, li, seg_start, window)
            acc, m, l = got
            pa, pm, pl = want
            t = torch.arange(T, device=dev)
            live = seg_start + t - window < nc * 256 - 1            # tokens with a live column
            out, pout = acc[:, live] / l[:, live], pa[:, live] / pl[:, live]
            err = (out - pout).abs().max().item()
            tol = KERNEL_TOL_ULPS * 2.0 ** -8 * pout.abs().max().item()
            m_err = (m[:, live] - pm[:, live]).abs().max().item()
            m_tol = 1e-5 * pm[:, live].abs().max().item()
            l_err = ((l[:, live] - pl[:, live]).abs() / pl[:, live]).max().item()
            dead_m = bool((m[:, ~live] == -1e30).all() and (pm[:, ~live] == -1e30).all())
            p_self = attention_partials(qq, k, v, torch.ones((T, T), dtype=torch.bool,
                                                             device=dev).tril())
            merged = merge_partials([got, p_self])
            merged_want = merge_partials([want, p_self])
            merged_err = (merged - merged_want).abs().max().item()
            merged_tol = KERNEL_TOL_ULPS * 2.0 ** -8 * merged_want.abs().max().item()
            finite = all(bool(x.isfinite().all()) for x in (*got, merged))
            case = {"B": B, "n_chunks": nc, "seg_start": seg_start, "window": window,
                    "li": li, "live_tokens": int(live.sum()),
                    "first_chunk_of_oldest_row": qa.segment_first_chunk(seg_start, 0,
                                                                        window, nc),
                    "max_abs_err": err, "tol": tol, "m_err": m_err, "m_tol": m_tol,
                    "l_rel_err": l_err, "l_tol": 1e-4, "dead_rows_m_neg": dead_m,
                    "merged_max_abs_err": merged_err, "merged_tol": merged_tol,
                    "finite": finite,
                    "second_launch_equal": all(torch.equal(a, b) for a, b in zip(got, again))}
            results.append(case)
            if not (finite and err <= tol and m_err <= m_tol and l_err <= 1e-4 and dead_m
                    and merged_err <= merged_tol and case["second_launch_equal"]):
                raise AssertionError(f"windowed segment kernel disagrees with its plain "
                                     f"version or with itself: {case}")
            worst = max(worst, err / max(tol, 1e-30), m_err / max(m_tol, 1e-30),
                        l_err / 1e-4, merged_err / max(merged_tol, 1e-30))
    nc, seg_start, window = SEG_WINDOW_TIMED
    kit = kits[(1, 0.7)]
    q = torch.randn((1, T, Hq, D), generator=g, device=kit.k_win.device).to(torch.bfloat16)
    for _ in range(3):
        kit.segment(q, nc, 0, seg_start, window)
        kit.segment(q, nc, 0, seg_start)
    torch.cuda.synchronize()
    ms = [cuda_ms(call, 20)[0]
          for call in (lambda: kit.segment(q, nc, 0, seg_start, window),
                       lambda: kit.segment(q, nc, 0, seg_start),
                       lambda: kit.segment(q, nc, 0, seg_start),
                       lambda: kit.segment(q, nc, 0, seg_start, window))]
    plain_ms, _ = cuda_ms(lambda: kit.segment_plain(q, nc, 0, seg_start, window), 3,
                          spin=False)
    BH = Hkv
    first = qa.segment_first_chunk(seg_start, 0, window, nc)
    lows = [seg_start + t - window for t in range(T)]
    live_cols = sum(max(nc * 256 - 1 - max(lo, -1), 0) for lo in lows)

    def bound(cols, chunks):
        flops = 4 * BH * G * cols * D
        nbytes = BH * chunks * kit.chunk_bytes + q.numel() * 2 + T * Hq * (D + 2) * 4
        return nbytes / H100_BYTES_PER_S * 1e3, flops / H100_BF16_FLOPS * 1e3
    on, off = bound(live_cols, nc - first), bound(T * nc * 256, nc)
    turns = in_turns(ms)
    return {"cases": results, "max_abs_err": max(r["max_abs_err"] for r in results),
            "tol": ("live rows: the output (acc / l) within 2 bf16 ulps of its scale, m "
                    "within 1e-5 of its scale, l within 1e-4 relative; rows with no live "
                    "pool column m = -1e30; every row merged with a self partial within "
                    "2 bf16 ulps"),
            "worst_err_over_tol": worst, "worst_err_over_tol_split": None,
            "timed": {"timed_at": f"B=1, {nc} chunks, seg_start {seg_start}, window "
                                  f"{window} (chunks 0-{first - 1} dead for every row), in "
                                  f"turns on, off, off, on (the least of each pair)",
                      "ms_on": turns["on"], "ms_off": turns["off"], "in_turns": ms,
                      "live_chunks": nc - first, "bound_ms": max(on), "bound_ms_off": max(off),
                      "plain_ms": plain_ms},
            "bound_by": "operations" if on[1] >= on[0] else "bytes"}


PACK_NO_LIBRARY = ("no single PyTorch call computes an exact top-k with ties to the "
                   "lower channel plus quantize plus pack (torch.topk orders ties "
                   "arbitrarily)")


def phase_kernel_pack():
    """Kernel 9 against its plain version on the card, bit-equal (rows and
    scales, zero tolerance).  The one-tensor entry (``prune_quant_pack``):
    B*Hkv = 64 and 8 head-chunks of C = 256, bits 8 and 4, keep 40
    (sparsity 0.7), 14 and 128, with injected ties (channel 10 = channel
    90, a row of equal magnitudes, a row of two values), an all-zero row
    and, at 64, the f32 score option; C = 128, 384 and 512 at 8 head-chunks
    (with a score too); the cache's strided case (a [B, T, Hkv, 128] prompt
    slice in, the pool slot's K rows and the scales' K column out).  The
    K+V entry (``prune_quant_pack_kv``, the cache's), each case into pool
    views filled with sentinels that it must leave alone: q8q4, q8 and
    q4q4, K and V keeps apart, in prefill's chunk layout (3 chunks of a
    [8, 840, 8, 128] prompt into pool slots 0-2 of a layer) and a
    compaction's layer layout (4 layers' windows into slot 2 of each); every
    cluster size ``pack_grid`` picks on this card, at the largest even
    head-chunk count up to two an SM that makes it pick that size; and
    the timed calls' own inputs.  Timed L2-flushed beside the byte bound and
    the plain chain: K alone at 64 head-chunks (8 and 4 bits, keep 40; keep
    128, which skips the selection), 8 head-chunks (8 bits); K+V (q8q4) of
    prefill's chunk at B=8 (the main path's call, the kernels line's
    numbers), of the engine's batch-1 pack and of a compaction of 32 layers
    at B=8, the first two beside a launch each for K and V, the last
    beside the 2 x 32 one-tensor launches that packed it before."""
    import torch
    from mustafar_tpu_torch.ops.kernels import pack_kernel as pk
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    C, D = 256, 128
    fn, kv = pk.prune_quant_pack, pk.prune_quant_pack_kv
    launches0 = (fn.launches, kv.launches)

    def chunk(*lead, C=C):
        x = (0.3 * torch.randn((*lead, C, D), generator=g, device=dev)).to(torch.bfloat16)
        x[..., 10] = x[..., 90]                       # ties across channels
        x[..., 5, :] = 0                              # an all-zero row
        x[..., 7, :] = 0.5                            # a row of equal magnitudes
        x[..., 9, :] = torch.where(torch.arange(D, device=dev) % 2 == 0, 0.25, -0.75)
        return x

    results = []

    def same(label, got, want, **case):
        rows_eq = torch.equal(got[0], want[0])
        sc_eq = torch.equal(got[1].view(torch.int16), want[1].view(torch.int16))
        diff = int((got[0] != want[0]).sum()) + int((got[1] != want[1]).sum())
        results.append({"case": label, **case, "rows_equal": rows_eq,
                        "scales_equal": sc_eq, "elements_differing": diff})
        if not (rows_eq and sc_eq):
            raise AssertionError(f"prune_quant_pack disagrees with its plain version: "
                                 f"{results[-1]}")

    def check(label, x, keep, bits, score=None, rows_out=None, scales_out=None):
        got = fn(x, keep, bits, score, rows_out=rows_out, scales_out=scales_out)
        torch.cuda.synchronize()
        same(label, got, pk.prune_quant_pack_plain(x, keep, bits, score), keep=keep,
             bits=bits, score=score is not None)

    for BH in (64, 8):
        x = chunk(BH)
        score = torch.rand((BH, C, D), generator=g, device=dev)
        for bits in (8, 4):
            for keep in (40, 14, 128):
                check(f"BH={BH}", x, keep, bits)
            if BH == 64:
                check(f"BH={BH}", x, 40, bits, score)
    for Ci in (128, 384, 512):
        x = chunk(8, C=Ci)
        score = torch.rand((8, Ci, D), generator=g, device=dev)
        for bits in (8, 4):
            check(f"C={Ci}", x, 40, bits)
            check(f"C={Ci}", x, 40, bits, score)
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

    def kv_views(pool, scales, at, KR):
        """(K rows, K scales), (V rows, V scales) of pool[at] / scales[at]."""
        return ((pool[at][..., :KR, :], scales[at][..., 0, :]),
                (pool[at][..., KR:, :], scales[at][..., 1, :]))

    def check_kv(label, k, v, pool, scales, at, keeps, bits, scores=(None, None), **case):
        """K+V into pool[at] / scales[at] (K rows, then V rows), each ranked
        by its score if given; the rest of pool and scales must keep their
        sentinels."""
        KR = C * bits[0] // 16
        pool.fill_(7)
        scales.fill_(3.0)
        k_out, v_out = kv_views(pool, scales, at, KR)
        kv(k, v, *keeps, *bits, k_out=k_out, v_out=v_out, k_score=scores[0],
           v_score=scores[1])
        torch.cuda.synchronize()
        for name, x, keep, nb, out, sc in (("K", k, keeps[0], bits[0], k_out, scores[0]),
                                           ("V", v, keeps[1], bits[1], v_out, scores[1])):
            same(f"{label} {name}", out, pk.prune_quant_pack_plain(x, keep, nb, sc),
                 keep=keep, bits=nb, score=sc is not None, **case)
        pool[at] = 7
        scales[at] = 3.0
        if not ((pool == 7).all() and (scales == 3.0).all()):
            raise AssertionError(f"prune_quant_pack_kv ({label}) wrote outside its views")

    def kv_pool(*lead, rows=192):
        return (torch.empty((*lead, rows, D), dtype=torch.int16, device=dev),
                torch.empty((*lead, 2, D), dtype=torch.bfloat16, device=dev))

    for codec, keeps in (("q8q4", (40, 14)), ("q8", (40, 77)), ("q4q4", (14, 40))):
        bits = QUANT_BITS[codec]
        rows = C * (bits[0] + bits[1]) // 16
        # prefill: the prompt's 3 chunks of layer 1 into pool slots 0-2
        # (a [B, T, Hkv, D] prompt seen as [B, Hkv, T, D], as the cache sees it)
        kp, vp = (chunk(B, Hkv, C=3 * C + 72).transpose(1, 2).contiguous().transpose(1, 2)
                  [:, :, :3 * C].unflatten(2, (3, C)).movedim(2, 0) for _ in range(2))
        check_kv(f"{codec} prefill", kp, vp, *kv_pool(2, 5, B, Hkv, rows=rows),
                 (1, slice(0, 3)), keeps, bits)
        # compaction: 4 layers' windows (r + C = 288 tokens) into slot 2
        kw, vw = (chunk(4, B, Hkv, C=288)[..., :C, :] for _ in range(2))
        check_kv(f"{codec} compaction", kw, vw, *kv_pool(4, 5, B, Hkv, rows=rows),
                 (slice(None), 2), keeps, bits)
        # the Opa policies: a score on one operand (V for KT_MAG_VT_OPA, K
        # for KT_OPA_VT_MAG) or both; the other keyed by |x| in the same launch
        for scored in ((False, True), (True, False), (True, True)):
            sk, sv = (torch.rand(x.shape, generator=g, device=dev) if on else None
                      for x, on in zip((kp, vp), scored))
            check_kv(f"{codec} prefill scored", kp, vp, *kv_pool(2, 5, B, Hkv, rows=rows),
                     (1, slice(0, 3)), keeps, bits, (sk, sv), scored=scored)
            sk, sv = (torch.rand(x.shape, generator=g, device=dev) if on else None
                      for x, on in zip((kw, vw), scored))
            check_kv(f"{codec} compaction scored", kw, vw,
                     *kv_pool(4, 5, B, Hkv, rows=rows), (slice(None), 2), keeps, bits,
                     (sk, sv), scored=scored)

    index = torch.cuda.current_device()

    def capacity(cluster, threads):
        return pk.max_clusters(index, C, cluster, threads, False)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # every cluster size the grid rule picks here (C = 256), K+V (q8q4) of
    # the largest even head-chunk count up to 2 x SMs that picks it
    picks = {}
    for n in range(2, 2 * sms + 1, 2):
        picks[pk.pack_grid(n, C, sms=sms, capacity=capacity)] = n
    clusters = {}
    for (cluster, threads), n in sorted(picks.items()):
        check_kv(f"cluster {cluster}", chunk(n // 2), chunk(n // 2), *kv_pool(2, n // 2), 1,
                 (40, 14), (8, 4), head_chunks=n, cluster=cluster)
        clusters[cluster] = {"head_chunks": n, "threads": threads,
                             "max_active_clusters": capacity(cluster, threads)}

    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)

    def timed_call(call, plain, nbytes, n_hc, plain_reps=5):
        for _ in range(5):
            call()
        torch.cuda.synchronize()
        kernel_ms, behind = cuda_ms(call, 50, flush=flush_buf.zero_)
        plain_ms, _ = cuda_ms(plain, plain_reps, flush=flush_buf.zero_, spin=False)
        cluster, threads = pk.pack_grid(n_hc, C, sms=sms, capacity=capacity)
        return {"kernel_ms": kernel_ms, "plain_ms": plain_ms,
                "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bytes": nbytes,
                "head_chunks": n_hc, "cluster": cluster, "threads": threads,
                "max_active_clusters": capacity(cluster, threads),
                "host_behind": behind, "wrapper_host_us": host_us(call, 50)}

    def chunk_bytes(bits):
        return C * D * 2 + (C * bits // 16) * D * 2 + D * 2

    timed = {}
    # one tensor; keep 128 skips the selection: the difference is its share
    for BH, bits, keep in ((64, 8, 40), (64, 4, 40), (8, 8, 40), (64, 8, 128)):
        x = chunk(BH)
        timed[f"BH{BH}_bits{bits}" + ("" if keep == 40 else f"_keep{keep}")] = timed_call(
            lambda x=x, keep=keep, bits=bits: fn(x, keep, bits),
            lambda x=x, keep=keep, bits=bits: pk.prune_quant_pack_plain(x, keep, bits),
            BH * chunk_bytes(bits), BH)
    # K+V (q8q4, keep 40 each) in one launch into pool views, held against
    # the plain version first: prefill's chunk at B=8, the engine's batch-1
    # pack, and a compaction of 32 layers at B=8 (every layer's window into
    # its pool slot)
    L = 32
    cases = (("kv_BH64", (B, Hkv), C, 1), ("kv_BH8", (1, Hkv), C, 1),
             ("kv_compaction_L32", (L, B, Hkv), 288, (slice(None), 1)))
    for label, lead, W, at in cases:
        k, v = (chunk(*lead, C=W)[..., :C, :] for _ in range(2))
        pool, scales = kv_pool(*((L, 2, B, Hkv) if len(lead) == 3 else (2, *lead)))
        check_kv(label, k, v, pool, scales, at, (40, 40), (8, 4))
        outs = kv_views(pool, scales, at, 128)
        n = k.numel() // (C * D)
        timed[label] = timed_call(
            lambda k=k, v=v, outs=outs: kv(k, v, 40, 40, 8, 4, k_out=outs[0],
                                           v_out=outs[1]),
            lambda k=k, v=v: (pk.prune_quant_pack_plain(k, 40, 8),
                              pk.prune_quant_pack_plain(v, 40, 4)),
            n * (chunk_bytes(8) + chunk_bytes(4)), 2 * n, plain_reps=2 if n > 64 else 5)
        if len(lead) == 2:
            timed[label]["two_launches_ms"] = cuda_ms(
                lambda k=k, v=v: (fn(k, 40, 8), fn(v, 40, 4)), 50, flush=flush_buf.zero_)[0]
            if label == "kv_BH64":
                # V ranked by a score (KT_MAG_VT_OPA's pack) and not, in turns
                sv = torch.rand(v.shape, generator=g, device=dev)
                check_kv("kv_BH64 V scored", k, v, pool, scales, at, (40, 40), (8, 4),
                         (None, sv))
                timed["kv_BH64_v_score"] = [cuda_ms(call, 50, flush=flush_buf.zero_)[0]
                                            for call in (
                    lambda: kv(k, v, 40, 40, 8, 4, k_out=outs[0], v_out=outs[1],
                               v_score=sv),
                    lambda: kv(k, v, 40, 40, 8, 4, k_out=outs[0], v_out=outs[1]),
                    lambda: kv(k, v, 40, 40, 8, 4, k_out=outs[0], v_out=outs[1]),
                    lambda: kv(k, v, 40, 40, 8, 4, k_out=outs[0], v_out=outs[1],
                               v_score=sv))]
            continue

        def per_layer(k=k, v=v, outs=outs):
            for li in range(L):
                fn(k[li], 40, 8, rows_out=outs[0][0][li], scales_out=outs[0][1][li])
                fn(v[li], 40, 4, rows_out=outs[1][0][li], scales_out=outs[1][1][li])

        per_layer()
        torch.cuda.synchronize()
        # 64 wrapper calls take longer on the host than the default spin
        ms, behind = cuda_ms(per_layer, 20, flush=flush_buf.zero_,
                             spin_cycles=20 * SPIN_CYCLES)
        timed[label].update(per_layer_launches_ms=ms, per_layer_host_behind=behind,
                            per_layer_host_us=host_us(per_layer, 10))
    fn.launches, kv.launches = launches0                   # comparisons do not count
    emit("kernel_pack", C=C, cases=results, timed=timed, clusters_checked=clusters,
         library_ms=None, library_note=PACK_NO_LIBRARY)
    t = timed["kv_BH64"]
    entry = _entry("q8q4", "pack", results, 0.0, "bit-equal (rows and scales)",
                   t["kernel_ms"], t["plain_ms"], t["bound_ms"], 0.0)
    entry.update(max_abs_err=0.0,
                 timed_at="B=8, Hkv=8, C=256 (prefill's chunk of a layer): K at 8 bits "
                          "and V at 4, keep 40, one launch",
                 timed_other={key: {f: timed[key][f] for f in ("kernel_ms", "bound_ms",
                                                               "plain_ms")}
                              for key in ("BH64_bits8", "kv_BH8", "kv_compaction_L32")},
                 library_note=PACK_NO_LIBRARY)
    on_off = timed["kv_BH64_v_score"]
    entry["options"] = {"score": {
        "max_abs_err": 0.0, "tol": "bit-equal (rows and scales)",
        "ms": (on_off[0] + on_off[3]) / 2, "ms_off": (on_off[1] + on_off[2]) / 2,
        "launches": None,
        "timed_at": "as ms with V ranked by an f32 score and K by |x| in the same "
                    "launch, in turns on, off, off, on"}}
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


def _sdpa_ms(q, k, v, pos, flush, window=None):
    """The library call for the same function: ``scaled_dot_product_attention``
    with GQA and a boolean mask of each slot's rows [0, pos[b]] (with a
    sliding ``window``, the band (pos[b] - window, pos[b]]); returns (its
    device ms, the backend PyTorch picked, its output)."""
    import torch
    import torch.nn.functional as F
    B, S = k.shape[:2]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    rows = torch.arange(S, device=q.device)[None, :]
    mask = rows <= pos[:, None]
    if window is not None:
        mask &= rows > pos[:, None] - window
    mask = mask[:, None, None, :]
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
    shapes, results, worst, worst_split, norm_worst = {}, [], 0.0, 0.0, 0.0
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
                norm_worst = max(norm_worst, _check_norm(fn, dd, q, k, v, kpos, got,
                                                         results[-1]))
        q = torch.randn((B, 1, Hkv * 4, D), generator=g, device=dev).to(torch.bfloat16)
        if not refuses_short_scratch(lambda: fn(q, k, v, kpos)):
            raise AssertionError(f"dense decode kernel took scratch shorter than its "
                                 f"grid needs ({label})")
        for _ in range(5):
            fn(q, k, v, kpos)
        torch.cuda.synchronize()
        kernel_ms, behind = cuda_ms(lambda: fn(q, k, v, kpos), 50, flush=flush_buf.zero_)
        # the final (m, l) on and off, in turns
        norm_ms = [cuda_ms(call, 50, flush=flush_buf.zero_)[0]
                   for call in (lambda: fn(q, k, v, kpos, return_norm=True),
                                lambda: fn(q, k, v, kpos), lambda: fn(q, k, v, kpos),
                                lambda: fn(q, k, v, kpos, return_norm=True))]
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
                         "wrapper_host_us": host_us(lambda: fn(q, k, v, kpos), 50),
                         "return_norm_ms": {"on": (norm_ms[0] + norm_ms[3]) / 2,
                                            "off": (norm_ms[1] + norm_ms[2]) / 2,
                                            "in_turns": norm_ms}}
        del k, v
    window = _dense_windows(fn, dd, g, dev, flush_buf)
    fn.launches = launches0                                # comparisons do not count
    emit("kernel_dense", B=B, Hkv=Hkv, cases=results, worst_err_over_tol=worst,
         worst_err_over_tol_split=worst_split, return_norm_worst_err_over_tol=norm_worst,
         timed=shapes, window=window)
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
    entry["options"] = {"return_norm": {
        "max_abs_err_m": max(r["m_max_abs_err"] for r in results),
        "max_rel_err_l": max(r["l_max_rel_err"] for r in results),
        "tol": NORM_TOL_NOTE, "worst_err_over_tol": norm_worst,
        "ms": t["return_norm_ms"]["on"], "ms_off": t["return_norm_ms"]["off"],
        "per_slot_ms": p["return_norm_ms"]["on"], "per_slot_ms_off": p["return_norm_ms"]["off"],
        "launches": None, "timed_at": "as ms, in turns on, off, off, on"},
        "window": _window_option(window)}
    return entry


# kernel 4's sliding-window cases: serve_swa's cache (B=4, 8 kv heads, G=4,
# S=4,928) at pos 4,500 with Mistral's 4,096 (first live row 405, inside a
# split) and 3,989 (512, a split boundary); serve_cb's per-slot cache (B=8,
# S=8,448) with 4,096 (the long slot cut) and 1,000 (four slots cut)
DENSE_WINDOWS = (("uniform", 4, 4928, 4500, 4096), ("uniform", 4, 4928, 4500, 3989),
                 ("per_slot", 8, 8448, [8000, 1210, 300, -1, 640, 1499, 45, 950], 4096),
                 ("per_slot", 8, 8448, [8000, 1210, 300, -1, 640, 1499, 45, 950], 1000))


def _dense_windows(fn, dd, g, dev, flush_buf):
    """Kernel 4 with a sliding window (DENSE_WINDOWS; G = 4 at bf16 and f32
    q, G = 1 and 8 at the first case): each slot held to the TPU-order plain
    version at 2 bf16 ulps of its scale and to the split plain version by
    ``split_gate``, its (m, l) by ``_check_norm``, an idle slot 0.  Timed at
    the first case with the window on and off, in turns, beside each's byte
    bound (the rows each attends), the plain version and
    ``scaled_dot_product_attention`` with the band as its mask."""
    import torch
    Hkv, D = 8, 128
    results, worst, worst_split, timed = [], 0.0, 0.0, None
    for i, (label, B, S, pos, window) in enumerate(DENSE_WINDOWS):
        k = torch.randn((B, S, Hkv, D), generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn((B, S, Hkv, D), generator=g, device=dev).to(torch.bfloat16)
        kpos = torch.tensor(pos, dtype=torch.int32, device=dev) if label == "per_slot" else pos
        slot_pos = kpos if torch.is_tensor(kpos) else torch.full((B,), pos, device=dev)
        live = slot_pos >= 0
        dims = (1, 2, 3)
        for G in ((4, 1, 8) if i == 0 else (4,)):
            qb = torch.randn((B, 1, Hkv * G, D), generator=g, device=dev).to(torch.bfloat16)
            for q in ((qb, qb.float()) if G == 4 else (qb,)):
                got = fn(q, k, v, kpos, window=window)
                torch.cuda.synchronize()
                want = dd.flash_decode_attention_plain(q, k, v, kpos, window=window)
                errs = (got.float() - want.float()).abs().amax(dim=dims)
                tols = KERNEL_TOL_ULPS * 2.0 ** -8 * want.float().abs().amax(dim=dims)
                ratio = (errs[live] / tols[live].clamp_min(1e-30)).max().item()
                split = split_gate(got, dd.flash_decode_attention_split_plain(
                    q.float(), k, v, kpos, window=window), live)
                case = {"case": label, "S": S, "pos": pos, "window": window, "G": G,
                        "q_dtype": str(q.dtype).split(".")[-1],
                        "max_abs_err": errs.max().item(), "worst_err_over_tol": ratio,
                        "worst_err_over_tol_split": split,
                        "idle_slots_zero": bool((got[~live] == 0).all())}
                results.append(case)
                if not (got.isfinite().all() and ratio <= 1.0 and split <= 1.0
                        and case["idle_slots_zero"]):
                    raise AssertionError(f"dense decode kernel with a window disagrees with "
                                         f"its plain versions: {case}")
                _check_norm(fn, dd, q, k, v, kpos, got, case, window)
                worst, worst_split = max(worst, ratio), max(worst_split, split)
        if i == 0:
            q = torch.randn((B, 1, Hkv * 4, D), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(5):
                fn(q, k, v, kpos, window=window)
                fn(q, k, v, kpos)
            torch.cuda.synchronize()
            ms = [cuda_ms(call, 50, flush=flush_buf.zero_)[0]
                  for call in (lambda: fn(q, k, v, kpos, window=window),
                               lambda: fn(q, k, v, kpos), lambda: fn(q, k, v, kpos),
                               lambda: fn(q, k, v, kpos, window=window))]
            plain_ms, _ = cuda_ms(lambda: dd.flash_decode_attention_plain(
                q, k, v, kpos, window=window), 3, flush=flush_buf.zero_, spin=False)
            lib_ms, backend, lib_out = _sdpa_ms(q, k, v, slot_pos, flush_buf.zero_, window)
            lib_off_ms = _sdpa_ms(q, k, v, slot_pos, flush_buf.zero_)[0]
            lib_err = (lib_out.float() - fn(q, k, v, kpos, window=window).float()
                       ).abs().max().item()

            def bound(rows):
                nbytes = rows * Hkv * D * 2 * 2 + 2 * q.numel() * 2
                flops = rows * Hkv * 4 * D * 2 * 2
                return max(nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS) * 1e3
            turns = in_turns(ms)
            timed = {"timed_at": f"B={B}, S={S}, pos {pos}, Hkv={Hkv}, G=4, window {window} "
                                 f"(rows {pos - window + 1}-{pos}), in turns on, off, off, on "
                                 f"(the least of each pair)",
                     "ms_on": turns["on"], "ms_off": turns["off"], "in_turns": ms,
                     "bound_ms": bound(B * window), "bound_ms_off": bound(B * (pos + 1)),
                     "plain_ms": plain_ms, "library_ms": lib_ms, "library_ms_off": lib_off_ms,
                     "library_backend": backend, "library_max_abs_diff": lib_err}
        del k, v
    return {"cases": results, "max_abs_err": max(r["max_abs_err"] for r in results),
            "tol": "per slot: 2 bf16 ulps of the slot's largest output (TPU order); "
                   + SPLIT_TOL_NOTE,
            "worst_err_over_tol": worst, "worst_err_over_tol_split": worst_split,
            "timed": timed}


NORM_TOL = 2.0 ** -18
NORM_TOL_NOTE = ("m within 2^-18 absolute, l within 2^-18 of l (a sum of up to 128 "
                 "exps a split, >= 1 for a live slot), of the split plain version's")


def _check_norm(fn, dd, q, k, v, kpos, got, case, window=None):
    """Kernel 4's final (m, l) (``return_norm``) against its split plain
    version's (NORM_TOL_NOTE; an idle slot -1e30 and 0 exactly) and its
    output bit-equal to ``got``, the call without the option (with the
    sliding ``window``, if given, in both).  Records into ``case`` and
    returns the worst error over the tolerance."""
    import torch
    out, m, l = fn(q, k, v, kpos, window=window, return_norm=True)
    torch.cuda.synchronize()
    _, wm, wl = dd.flash_decode_attention_split_plain(q.float(), k, v, kpos,
                                                       return_norm=True, window=window)
    m_err = (m - wm).abs().max().item()
    l_err = ((l - wl).abs() / wl.clamp_min(1.0)).max().item()
    case.update(m_max_abs_err=m_err, l_max_rel_err=l_err,
                norm_out_equal_without=bool(torch.equal(out, got)))
    if not (case["norm_out_equal_without"] and m_err <= NORM_TOL and l_err <= NORM_TOL):
        raise AssertionError(f"dense decode kernel's (m, l) disagree with its split plain "
                             f"version's, or change the output: {case}")
    return max(m_err, l_err) / NORM_TOL


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


def _tiny_engine(mode, codec="q8q4", method=None, window=None, **kw):
    import dataclasses
    from mustafar_tpu_torch import config as tc
    model = dataclasses.replace(tc.TINY_LLAMA, head_dim=128, num_heads=4,
                                num_kv_heads=1, hidden_size=256, sliding_window=window)
    return tc.EngineConfig(
        model=model, cache_mode=mode,
        prune=tc.PruneConfig(method=method or tc.PruneMethod.KT_MAG_VT_MAG,
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
        w4.w4_matmul, dd.flash_decode_attention, pk.prune_quant_pack,
        pk.prune_quant_pack_kv)}
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


def phase_reference(codec="q8q4", mode=None, method=None, use_pallas=False, T=300,
                    tol_frac=1e-2, window=None, chunked=False):
    """A tiny f32 model, same weights and token stream on the card and on
    the CPU: the card runs the kernel, the CPU the plain path, a prompt of
    ``T`` tokens and 39 decode steps (a compressed cache compacts when its
    window fills, as the Generator does).  ``mode`` and ``method`` default
    to the compressed cache and KT_MAG_VT_MAG; ``use_pallas`` sends a dense
    or masked cache through kernel 4; ``tol_frac`` is the logits'
    tolerance as a fraction of their range; ``window`` gives the model a
    sliding window; ``chunked`` prefills the prompt segment by segment
    (chunked prefill, the segment kernel).  Returns the phase's numbers
    (``reference_bitmap`` and the others print them)."""
    import numpy as np
    import torch
    from mustafar_tpu_torch.cache import make_cache
    from mustafar_tpu_torch.config import CacheMode
    from mustafar_tpu_torch.models import llama
    eng = _tiny_engine(mode or CacheMode.COMPRESSED, codec, method, window)
    cpu_params = llama.init_params(eng.model, device="cpu", dtype=torch.float32, seed=1)
    gpu_params = {k: ({kk: vv.cuda() for kk, vv in v.items()} if isinstance(v, dict)
                      else v.cuda()) for k, v in cpu_params.items()}
    prompt = np.random.RandomState(1).randint(0, 512, (2, T))
    toks = torch.zeros((2, -(-T // 256) * 256), dtype=torch.int64)
    toks[:, :T] = torch.from_numpy(prompt)
    launches0 = _launches()
    logs = {}
    stream = None
    compactions = 0
    with torch.inference_mode():
        for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
            impl = make_cache(eng, device=dev)
            impl.use_pallas = use_pallas
            cache = impl.init(2, torch.float32)
            if chunked:
                logit, cache = llama.prefill_chunked(eng.model, params, toks.to(dev), cache,
                                                     impl, T)
            else:
                logit, cache = llama.prefill(eng.model, params, toks.to(dev), cache,
                                             impl, T, last_only=True)
            out = [logit[:, 0].cpu()]
            tok = logit[:, 0].argmax(-1)
            for i in range(1, 40):
                if stream is not None:
                    tok = stream[:, i - 1].to(dev)
                logit, cache = llama.decode_step(eng.model, params, tok[:, None],
                                                 cache, impl, T + i - 1)
                out.append(logit[:, 0].cpu())
                tok = logit[:, 0].argmax(-1)
                if hasattr(impl, "compact") and impl.window_full(cache, T + i):
                    impl.compact(cache)
                    compactions += dev == "cuda"
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
    tol = tol_frac * scale
    want, pick = a.argmax(-1), b.argmax(-1)
    agree = (want == pick).float().mean().item()
    # each differing pick with the CPU's margin between its token and the card's
    flips = [{"row": r, "step": t,
              "cpu_margin": (a[r, t, want[r, t]] - a[r, t, pick[r, t]]).item()}
             for r, t in torch.nonzero(pick != want).tolist()]
    fields = {"steps": 40, "max_abs_err": err, "tol": tol, "greedy_agreement": agree,
              "flips": flips, "launched": launched, "compactions": compactions}
    if codec == "q8q4" and mode is None and method is None:
        emit("reference", **fields)
    if not (b.isfinite().all() and err <= tol):
        raise AssertionError(f"card and CPU logits disagree on the tiny model: {fields}")
    return fields


def phase_reference_cb(codec="q8q4", method=None, window=None):
    """The tiny f32 continuous-batching engine, chunked prefill with
    interleaved admission, on the CPU (plain versions) and on the card
    (kernels), fed the CPU's tokens: the card's logits within 1e-2 of their
    range, its own greedy picks equal to the CPU's.  The requests make a
    slot retire while the other decodes (its n_chunks still the old
    request's) and reuse it.  ``method`` defaults to KT_MAG_VT_MAG;
    ``window`` gives the model a sliding window, and then (as under Opa) a
    pick may differ at a near-tie, within SWA_TIE_TOL.  Returns the phase's
    numbers."""
    import torch
    from mustafar_tpu_torch.config import CacheMode
    from mustafar_tpu_torch.models import llama
    Recording, np = _recording_engine()
    eng = _tiny_engine(CacheMode.COMPRESSED, codec, method, window, max_seq_len=2048,
                       batch_size=2, chunked_prefill=True)
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
    err, scale, agree, n, flips = 0.0, 0.0, 0, 0, []
    for uid in toks:
        a, b = torch.stack(lc[uid]), torch.stack(lg[uid])
        err = max(err, (a - b).abs().max().item())
        scale = max(scale, a.abs().max().item())
        want, pick = torch.as_tensor(toks[uid]), b.argmax(-1)
        agree += int((pick == want).sum())
        n += len(toks[uid])
        flips += [{"uid": uid, "step": t, "cpu_margin": (a[t, want[t]] - a[t, pick[t]]).item()}
                  for t in torch.nonzero(pick != want).flatten().tolist()]
    tol = 1e-2 * scale
    fields = {"requests": len(reqs), "tokens": n, "ticks": ticks, "segments": segments,
              "decode_steps": steps, "max_abs_err": err, "tol": tol,
              "greedy_agreement": agree / n, "flips": flips, "launched": launched}
    if codec == "q8q4" and method is None and window is None:
        emit("reference_cb", **fields)
    # under Opa (OPA_CB_NOTE) a differing pick must be a near-tie on the CPU,
    # with the window one within SWA_TIE_TOL (SWA_PICKS_NOTE)
    picks_ok = agree == n if method is None and window is None else all(
        f["cpu_margin"] <= (SWA_TIE_TOL if window else 2 * err) for f in flips)
    if not (err <= tol and picks_ok):
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
        if set(gen["launched"]) != {"fused_q_decode_attention", "prune_quant_pack_kv"} or set(
                cb["launched"]) != {"fused_q_decode_attention_ps",
                                    "fused_q_segment_attention", "prune_quant_pack_kv"}:
            raise AssertionError(f"reference_q ({codec}): launched {gen['launched']} and "
                                 f"{cb['launched']}")
    return {codec: cb["launched"] for codec, (_, cb) in runs.items()}


SWA_TINY_WINDOW, SWA_TINY_T = 320, 600
SWA_TIE_TOL = 1e-2   # absolute: the CPU tests' TIE_TOL for a kernel's route
SWA_PICKS_NOTE = ("every greedy pick equal, or at a near-tie: the CPU's margin between its "
                  "token and the card's pick at most SWA_TIE_TOL = 1e-2, the tie "
                  "tolerance the CPU tests hold a kernel's route to against the JAX "
                  "package (tests/test_torch_generate.py, tests/test_torch_w4.py), a "
                  "fixed bound that no run's error sets. The kernels round q, the "
                  "window and p to bf16 and the f32 activations differ in their last "
                  "bits between card and CPU, so a pick whose top-2 logits lie that "
                  "close may flip (on an H100: one of 80 at q4q4 at a CPU margin of "
                  "3.6e-5, one of 80 through kernel 4 at 1.4e-3)")


def phase_reference_swa():
    """``reference`` on a tiny f32 model with a sliding window of 320, card
    against CPU: a 600-token prompt (banded prefill; 2 chunks packed, 88
    window tokens) and 39 decode steps from position 600 (first live pool
    column 281: chunk 0 wholly below the window, chunk 1 cut), as the
    Generator runs them, at every codec (kernels 1 and 6 with ``window``,
    kernel 9 at prefill), the dense cache through kernel 4 with ``window``,
    and the masked cache (plain route, KT_MAG_VT_MAG at 0.7); logits within
    1e-2 of their range and every greedy pick equal or at a near-tie
    within SWA_TIE_TOL (SWA_PICKS_NOTE); each run launched its kernels and
    no other."""
    from mustafar_tpu_torch.config import CacheMode
    steps = 2 * 39
    runs = {}
    cases = [(CacheMode.COMPRESSED, c, False,
              {"fused_q_decode_attention": steps, "prune_quant_pack_kv": 2}
              if c in QUANT_BITS else {"fused_sparse_decode_attention": steps})
             for c in ("q8q4", "q8", "q4q4", "bitmap", "bitmap-q8")]
    cases += [(CacheMode.DENSE, "q8q4", True, {"flash_decode_attention": steps}),
              (CacheMode.MASKED, "q8q4", False, {})]
    for mode, codec, use_pallas, want in cases:
        label = f"{mode.value}/{codec}" if mode == CacheMode.COMPRESSED else (
            f"{mode.value}" + ("/kernel4" if use_pallas else ""))
        fields = phase_reference(codec, mode, None, use_pallas, T=SWA_TINY_T,
                                 window=SWA_TINY_WINDOW)
        runs[label] = dict(fields, expected_launches=want)
        runs[label]["picks"] = SWA_PICKS_NOTE
        if fields["launched"] != want:
            raise AssertionError(f"reference_swa ({label}): launched {fields['launched']}, "
                                 f"expected {want}")
        wide = [f for f in fields["flips"] if f["cpu_margin"] > SWA_TIE_TOL]
        if wide:
            raise AssertionError(f"reference_swa ({label}): greedy picks flipped at a CPU "
                                 f"margin past SWA_TIE_TOL ({SWA_TIE_TOL}): {wide}")
    emit("reference_swa", window=SWA_TINY_WINDOW, prompt=SWA_TINY_T, runs=runs)
    return runs


def phase_reference_swa_cb():
    """The sliding window through the engine and chunked prefill over the
    compressed cache, tiny f32 model (window 320), card against CPU: the
    engine (``reference_cb``'s requests: segments whose rows see part of a
    chunk or none of the pool, per-slot decode with chunks below a slot's
    edge, compactions) at every codec (kernels 2 and 7, 3 and 8 with the
    window; kernel 9 at the quant codecs), and the chunked Generator
    (``reference`` with chunked prefill, 600 tokens: 3 segments, then 39
    decode steps through kernels 1 and 6) at q8q4 and bitmap; logits within
    1e-2 of their range, picks equal or at a near-tie within SWA_TIE_TOL
    (SWA_PICKS_NOTE); the per-slot and segment kernels launched once a layer
    a step and a segment, and no kernel of another codec.  Returns the
    runs."""
    from mustafar_tpu_torch.config import CacheMode, TINY_LLAMA
    from mustafar_tpu_torch.models.llama import n_segments
    L = TINY_LLAMA.num_layers
    runs = {}
    for codec in ("q8q4", "q8", "q4q4", "bitmap", "bitmap-q8"):
        fields = phase_reference_cb(codec, window=SWA_TINY_WINDOW)
        want = {_meta(codec, "decode_ps")[0]: L * fields["decode_steps"],
                _meta(codec, "segment")[0]: L * fields["segments"]}
        got = {k: v for k, v in fields["launched"].items() if k in want}
        names = set(want) | ({"prune_quant_pack_kv"} if codec in QUANT_BITS else set())
        runs[f"engine/{codec}"] = dict(fields, expected_launches=want, picks=SWA_PICKS_NOTE)
        if got != want or set(fields["launched"]) != names:
            raise AssertionError(f"reference_swa_cb (engine, {codec}): launched "
                                 f"{fields['launched']}, expected {want} (and kernel 9 at "
                                 f"the quant codecs)")
    for codec in ("q8q4", "bitmap"):
        fields = phase_reference(codec, CacheMode.COMPRESSED, None, False, T=SWA_TINY_T,
                                 window=SWA_TINY_WINDOW, chunked=True)
        want = {_meta(codec, "decode")[0]: L * 39,
                _meta(codec, "segment")[0]: L * n_segments(SWA_TINY_T, 256)}
        if codec in QUANT_BITS:          # the chunks segments 2 and 3 pack
            want["prune_quant_pack_kv"] = L * ((SWA_TINY_T - 32) // 256)
        runs[f"chunked_generator/{codec}"] = dict(fields, expected_launches=want,
                                                  picks=SWA_PICKS_NOTE)
        wide = [f for f in fields["flips"] if f["cpu_margin"] > SWA_TIE_TOL]
        if fields["launched"] != want or wide:
            raise AssertionError(f"reference_swa_cb (chunked Generator, {codec}): launched "
                                 f"{fields['launched']} (expected {want}); flips past "
                                 f"SWA_TIE_TOL: {wide}")
    emit("reference_swa_cb", window=SWA_TINY_WINDOW, runs=runs)
    return runs


SAMPLE = {"temperature": 0.9, "top_k": 50, "top_p": 0.95, "seed": 7}


def phase_reference_sample():
    """Sampled decoding on the card (tiny f32 model, q8q4 compressed cache):
    the Generator (B=2, 300 + 40) and the engine (reference_cb's requests)
    with temperature 0.9, top-k 50, top-p 0.95, seed 7.  Every drawn token
    lies in the kept set of the CPU's filter (``filter_logits``) on the
    card's logits of that pick; the same seed draws the same tokens again;
    with top-k 1 the tokens are the greedy ones."""
    import dataclasses
    import numpy as np
    import torch
    from mustafar_tpu_torch.config import CacheMode
    from mustafar_tpu_torch.models import llama
    from mustafar_tpu_torch.runtime import generate as tg
    from mustafar_tpu_torch.runtime.scheduler import ContinuousBatchingEngine
    hot = tg.SamplingParams(**SAMPLE)
    one = dataclasses.replace(hot, top_k=1)
    eng = _tiny_engine(CacheMode.COMPRESSED, "q8q4", max_seq_len=2048, batch_size=2,
                       chunked_prefill=True)
    params = llama.init_params(eng.model, device="cuda", dtype=torch.float32, seed=3)
    picks = []                       # (logits on the CPU, tokens, rows of a request)

    def filtered_out(rows_logits, toks, sp):
        kept = torch.isfinite(tg.filter_logits(rows_logits, sp))
        return int((~kept[torch.arange(len(toks)), toks]).sum())

    choose = tg.choose

    def recorded(logits2d, sp, step):
        tok = choose(logits2d, sp, step)
        picks.append((logits2d.float().cpu(), tok.cpu(), sp))
        return tok

    class Recording(ContinuousBatchingEngine):
        def _choose(self, logits2d, reqs):
            toks = super()._choose(logits2d, reqs)
            rows = [i for i, r in enumerate(reqs) if r is not None]
            picks.append((logits2d[rows].float().cpu(), torch.as_tensor(toks[rows]),
                          self.sampling))
            return toks

    prompt = np.random.RandomState(3).randint(0, 512, (2, 300))
    rs = np.random.RandomState(2)
    reqs = [(rs.randint(0, 512, size=n), m)
            for n, m in ((100, 12), (1000, 6), (280, 30), (530, 20))]
    counts0 = _launches()
    tg.choose = recorded
    try:
        gen = tg.Generator(eng, params, dtype=torch.float32)
        runs = {name: np.stack(gen.generate(prompt, 40, sampling=sp))
                for name, sp in (("hot", hot), ("hot_again", hot), ("top_k_1", one))}
        runs["greedy"] = np.stack(gen.generate(prompt, 40))
    finally:
        tg.choose = choose
    gen_picks = len(picks)

    def engine(sp):
        cb = Recording(eng, params, dtype=torch.float32, sampling=sp)
        uids = [cb.submit(p, m) for p, m in reqs]
        out = cb.run()
        return [np.asarray(out[u]) for u in uids]
    cb_runs = {name: engine(sp) for name, sp in (("hot", hot), ("hot_again", hot),
                                                   ("top_k_1", one), ("greedy", tg.GREEDY))}
    engine_picks = len(picks) - gen_picks
    _set_launches(counts0)
    outside = sum(filtered_out(lg, tk, sp) for lg, tk, sp in picks if not sp.greedy)
    fields = {"sampling": SAMPLE, "generator_picks": gen_picks, "engine_picks": engine_picks,
              "drawn_outside_kept_set": outside,
              "generator": {"same_seed_equal": bool((runs["hot"] == runs["hot_again"]).all()),
                            "top_k_1_equal_greedy": bool((runs["top_k_1"]
                                                          == runs["greedy"]).all()),
                            "agreement_with_greedy": float((runs["hot"]
                                                            == runs["greedy"]).mean())},
              "engine": {"same_seed_equal": all((a == b).all() for a, b in
                                                zip(cb_runs["hot"], cb_runs["hot_again"])),
                         "top_k_1_equal_greedy": all((a == b).all() for a, b in
                                                     zip(cb_runs["top_k_1"],
                                                         cb_runs["greedy"]))}}
    emit("reference_sample", **fields)
    if outside or not all(v for part in ("generator", "engine")
                          for k, v in fields[part].items() if k != "agreement_with_greedy"):
        raise AssertionError(f"reference_sample: {fields}")


CHANNEL_OPA_TOL = 5e-2   # of the logits' range (see phase_reference_masked)


def phase_reference_masked():
    """``reference`` on the masked cache (the EngineConfig default) for all
    eight pruning methods, card against CPU, logits within 1e-2 of their
    range: the plain route, and for the Opa methods the kernel route
    (``use_pallas``: kernel 4, with its final (m, l) where V is scored,
    2 layers x 39 steps).  KT_MAG_VC_OPA is held to CHANNEL_OPA_TOL and to
    every greedy pick equal: it ranks each group's 32 tokens per channel
    by w_t |v_td| (softmax weights summed in another order on the card),
    so near-ties flip which entries survive, on the plain route as on the
    kernel's, and each flip moves the logits."""
    from mustafar_tpu_torch.config import CacheMode, PruneMethod
    runs = {}
    for method in PruneMethod:
        kernel = "opa" in method.k_policy or "opa" in method.v_policy
        channel_opa = method.v_policy == "channel_opa"
        fields = phase_reference("q8q4", CacheMode.MASKED, method, use_pallas=kernel,
                                 tol_frac=CHANNEL_OPA_TOL if channel_opa else 1e-2)
        want = {"flash_decode_attention": 2 * 39} if kernel else {}
        runs[method.value] = dict(fields, use_pallas=kernel, expected_launches=want)
        if fields["launched"] != want or (channel_opa and fields["greedy_agreement"] < 1):
            raise AssertionError(f"reference_masked ({method.value}): launched "
                                 f"{fields['launched']}, expected {want}; {fields}")
    emit("reference_masked", runs=runs)


def phase_reference_opa():
    """``reference`` on the compressed cache under the Opa methods
    (KT_OPA_VT_MAG, KT_MAG_VT_OPA) at every codec, card against CPU: a
    543-token prompt (one chunk packed by its prefill scores, kernel 9 with
    a score on the card for the quant codecs), a compaction after the first
    step (the oldest C tokens packed by their accumulated scores), the
    uniform decode kernel with its window probabilities where V is scored;
    logits within 1e-2 of their range."""
    from mustafar_tpu_torch.config import CacheMode, PruneMethod
    runs = {}
    for method in (PruneMethod.KT_OPA_VT_MAG, PruneMethod.KT_MAG_VT_OPA):
        for codec in ("q8q4", "q8", "q4q4", "bitmap", "bitmap-q8"):
            fields = phase_reference(codec, CacheMode.COMPRESSED, method, T=543)
            if codec in QUANT_BITS:
                want = {"fused_q_decode_attention": 2 * 39, "prune_quant_pack_kv": 2 + 1}
            else:
                want = {"fused_sparse_decode_attention": 2 * 39}
            runs[f"{method.value}/{codec}"] = dict(fields, expected_launches=want)
            if fields["launched"] != want or fields["compactions"] != 1:
                raise AssertionError(f"reference_opa ({method.value}, {codec}): launched "
                                     f"{fields['launched']}, expected {want}, "
                                     f"{fields['compactions']} compactions")
    emit("reference_opa", runs=runs)


OPA_CB_NOTE = ("every greedy pick equal, or at a near-tie: the CPU's margin between its "
               "token and the card's pick at most twice the largest logit difference. "
               "The Opa packs keep each row's top entries by accumulated scores whose "
               "float sums differ between card and CPU by ~1e-7, so a near-tie of the "
               "scores can flip a kept entry and move the logits by ~1e-3 of their range, "
               "and with it a pick whose top-2 logits lie closer")


def phase_reference_opa_cb():
    """``reference_cb`` under the Opa methods (KT_OPA_VT_MAG, KT_MAG_VT_OPA)
    at q8q4 and bitmap: the engine's per-slot decode scoring each slot's
    window (kernel 2 or 7 with its window probabilities where V is scored),
    compactions by score (``compact_slots``; kernel 9 with a score for
    q8q4) and chunked prefill's streamed scores (the segment kernel's
    partials), card against CPU: logits within 1e-2 of their range, every
    greedy pick equal or at a near-tie (OPA_CB_NOTE); each run launched its
    codec's kernels and no other.  Returns the runs' launches by (method,
    codec)."""
    from mustafar_tpu_torch.config import PruneMethod
    runs = {}
    for method in (PruneMethod.KT_OPA_VT_MAG, PruneMethod.KT_MAG_VT_OPA):
        for codec in ("q8q4", "bitmap"):
            fields = phase_reference_cb(codec, method)
            want = ({"fused_q_decode_attention_ps", "fused_q_segment_attention",
                     "prune_quant_pack_kv"} if codec in QUANT_BITS
                    else {"fused_sparse_decode_attention_ps", "fused_sparse_segment_attention"})
            runs[f"{method.value}/{codec}"] = dict(fields, expected_kernels=sorted(want),
                                                   picks=OPA_CB_NOTE)
            if set(fields["launched"]) != want:
                raise AssertionError(f"reference_opa_cb ({method.value}, {codec}): launched "
                                     f"{fields['launched']}, expected {sorted(want)}")
    emit("reference_opa_cb", runs=runs)
    return {key: run["launched"] for key, run in runs.items()}


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
            want["prune_quant_pack_kv"] = L       # prefill: a layer's chunk, K and V
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


# Layers of the earlier host-bound engine phases: host_split,
# serve_cb_bitmap, serve_cb_bitmap_q8, serve_cb_q4q4, serve_cb_opa and
# serve_cb_w4 run Llama-3-8B at full width and this depth, so that the
# whole run keeps well inside BUDGET_S on a slower host (serve_cb and the
# new paths stay at full depth).
CUT_LAYERS = 8


def cut_depth(model, params, n=CUT_LAYERS):
    """``model`` and ``params`` (either weight format) cut to their first
    ``n`` layers, full width: views of the stacked layer leaves."""
    import dataclasses
    cut = dict(params, layers={k: v[:n] for k, v in params["layers"].items()})
    return dataclasses.replace(model, num_layers=n), cut


def _pool_bytes(cache):
    """Bytes of a compressed cache's pool and scales (allocated at
    ``max_seq_len``'s chunks)."""
    return sum(cache[k].nbytes for k in ("kv_pool", "kv_scales") if k in cache)


def serve(label, mode, params, prompt, new_tokens, codec="q8q4", use_pallas=False,
          on_cache=None, prune=None, model=None, max_seq_len=1312, chunks_end=2,
          time_prefill=False):
    """One warm-up generation, then the measured one; returns its tokens,
    the launches of every kernel during the measured run (those launched)
    and the phase's fields.  ``use_pallas`` decodes the dense or masked
    cache through its flash-decode kernel; ``on_cache`` is handed the cache
    state the measured run left; ``prune`` defaults to KT_MAG_VT_MAG at
    sparsity 0.7; ``model`` to Llama-3-8B, whose compressed runs end with
    ``chunks_end`` pool chunks.  With ``time_prefill`` a prefill of the
    prompt alone is timed after the run (``prefill_s``)."""
    import numpy as np
    import torch
    from mustafar_tpu_torch.config import EngineConfig, LLAMA3_8B, PruneConfig, PruneMethod
    from mustafar_tpu_torch.runtime.generate import Generator
    model = model or LLAMA3_8B
    if prune is None:
        prune = PruneConfig(method=PruneMethod.KT_MAG_VT_MAG, k_sparsity=0.7,
                            v_sparsity=0.7)
    eng = EngineConfig(model=model, cache_mode=mode, prune=prune,
                       max_seq_len=max_seq_len, prefill_bucket=256, chunk_size=256,
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
    if toks.shape != (B, new_tokens) or toks.min() < 0 or toks.max() >= model.vocab_size:
        raise AssertionError(f"{label}: bad tokens {tuple(toks.shape)}")
    fields = {"batch": B, "prompt": prompt.shape[1], "new_tokens": new_tokens,
              "seconds": dt, "tok_s": B * new_tokens / dt,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "kernel_launches": launches}
    if mode.value == "compressed":
        fields["codec"] = codec
    else:
        fields["use_pallas"] = use_pallas
    fields["prune"] = {"method": prune.method.value, "k_sparsity": prune.k_sparsity,
                       "v_sparsity": prune.v_sparsity}
    cache = gen.last_cache
    if mode.value == "compressed":
        fields["n_chunks_end"] = cache["nc_host"]
        fields["pool_bytes"] = _pool_bytes(cache)
        if not (cache["nc_host"] == chunks_end
                and bool((cache["n_chunks"] == chunks_end).all())):
            raise AssertionError(f"{label}: expected {chunks_end} pool chunks at the end, "
                                 f"got {cache['nc_host']}")
    from mustafar_tpu_torch.models import llama
    if time_prefill:
        del cache
        gen.last_cache = None
        T = prompt.shape[1]
        toks_in = torch.zeros((B, gen._bucket(T)), dtype=torch.int64)
        toks_in[:, :T] = torch.as_tensor(prompt)
        toks_in = toks_in.cuda()
        with torch.inference_mode():
            fresh = gen.cache_impl.init(B)
            torch.cuda.synchronize()
            t = time.perf_counter()
            llama.prefill(model, params, toks_in, fresh, gen.cache_impl, T, last_only=True)
            torch.cuda.synchronize()
            fields["prefill_s"] = time.perf_counter() - t
        del fresh
        cache = None
    # finite logits on a small prefill through the same engine
    with torch.inference_mode():
        small = torch.as_tensor(prompt[:1, :256]).cuda()
        logits, _ = llama.prefill(model, params, small, gen.cache_impl.init(1),
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


def phase_serve_cb(params, codec="q8q4", w4=False, first8=False, beside=None, prune=None,
                   model=None):
    """Continuous batching at full Llama-3-8B width and depth (or
    ``model``'s: Llama-3-8B cut in depth by ``cut_depth``, or Mistral-7B with
    its window as ``serve_cb_swa_<codec>``): 8 slots, 17
    requests (16 with prompts of 200-1,500 tokens and 32-96 new tokens,
    plus one of 8,000 prompt tokens submitted third), chunked prefill with
    interleaved admission, ``codec`` at 0.7.  Every decode step must launch
    the codec's per-slot kernel once a layer, every segment its segment
    kernel once a layer, and no other kernel may run; every request's first
    token must equal a batch-1 chunked Generator's on the same prompt.
    A quant codec's engine packs through kernel 9, K and V in one launch:
    once a layer for every chunk a prompt packs (a segment packs its layer's
    chunk) and once for every compaction (one ``compact_slots`` call packs
    every layer of all the slots it names).  With ``first8``:
    the first 8 requests of that stream without the 8,000-token one.  With
    ``w4`` (W4 params; implies ``first8``): the W4 kernel 7 times a layer in
    every decode step (a segment's 256 tokens take the dequant route).
    ``beside``: fields of another run printed with this one.  ``prune``
    (default KT_MAG_VT_MAG at 0.7): with an Opa method the run is
    ``serve_cb_opa``, and the scored buffers must be live at its end (the
    per-slot kernel's window probabilities, or K's scores, reached the
    cache).  Returns the launches and the run's peak memory and pool
    bytes."""
    import numpy as np
    import torch
    from mustafar_tpu_torch.config import (CacheMode, EngineConfig, LLAMA3_8B,
                                           PruneConfig, PruneMethod)
    from mustafar_tpu_torch.runtime.generate import Generator
    from mustafar_tpu_torch.runtime.scheduler import ContinuousBatchingEngine
    model = model or LLAMA3_8B
    if prune is None:
        prune = PruneConfig(method=PruneMethod.KT_MAG_VT_MAG, k_sparsity=0.7,
                            v_sparsity=0.7)
    eng = EngineConfig(model=model, cache_mode=CacheMode.COMPRESSED, prune=prune,
                       max_seq_len=8448, prefill_bucket=256, chunk_size=256,
                       codec=codec, batch_size=8, chunked_prefill=True)
    rs = np.random.RandomState(1)
    reqs = [(rs.randint(1, model.vocab_size, size=rs.randint(200, 1501)),
             int(rs.randint(32, 97))) for _ in range(16)]
    reqs.insert(2, (rs.randint(1, model.vocab_size, size=8000), 64))
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
    L = model.num_layers
    generated = sum(len(outs[u]) for u in uids)
    want = dict.fromkeys(launches, 0)
    want[_meta(codec, "decode_ps")[0]] = L * cb.decode_steps
    want[_meta(codec, "segment")[0]] = L * cb.segments
    prompt_chunks = sum(max(len(p) - 32, 0) // 256 for p, _ in reqs)
    if codec in QUANT_BITS:
        want["prune_quant_pack_kv"] = L * prompt_chunks + compactions[0]
    if w4:
        want["w4_matmul"] = 7 * L * cb.decode_steps
    seg_expected = sum(-(-len(p) // 256) for p, _ in reqs)
    bad = [u for u, (p, m) in zip(uids, reqs)
           if len(outs[u]) != m or min(outs[u]) < 0 or max(outs[u]) >= model.vocab_size]
    # first tokens against a batch-1 chunked Generator (not counted above)
    gen = Generator(eng, params)
    first_equal = [int(gen.generate(p[None], 1)[0][0]) == int(outs[u][0])
                   for u, (p, _) in zip(uids, reqs)]
    counts = {"ticks": cb.ticks, "decode_steps": cb.decode_steps,
              "segments": cb.segments, "prompt_chunks": prompt_chunks,
              "compactions": compactions[0],
              "tick_ms": {k: {"n": len(v), "mean": 1e3 * sum(v) / max(len(v), 1),
                              "total_s": sum(v)} for k, v in Timed.split.items()}}
    scores = {k: float(cb.cache[k].abs().sum()) for k in cb.impl.score_keys}
    del gen, cb
    torch.cuda.empty_cache()
    label = ("serve_cb_w4" if w4 else "serve_cb_opa" if scores
             else "serve_cb_swa_" + codec.replace("-", "_") if model.sliding_window
             else "serve_cb" if codec == "q8q4" else "serve_cb_" + codec.replace("-", "_"))
    window = f", window {model.sliding_window}" if model.sliding_window else ""
    emit(label, model=f"{model.name} x{L}L{window}, {'W4' if w4 else 'W8'} (random, seed 0)",
         codec=codec, slots=8,
         requests=len(reqs), prompt_tokens=sum(len(p) for p, _ in reqs),
         generated_tokens=generated, seconds=dt, tok_s=generated / dt,
         peak_mem_gib=peak, mem_before_gib=mem_before, pool_bytes=pool_bytes, **counts,
         launches=launches, prune={"method": prune.method.value,
                                   "k_sparsity": prune.k_sparsity,
                                   "v_sparsity": prune.v_sparsity},
         score_sums=scores,
         expected_launches=want, first_token_equal=sum(first_equal), **(beside or {}))
    if scores and not all(scores.values()):
        raise AssertionError(f"{label}: the scored buffers are empty at the end: {scores}")
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


def phase_host_split(params, model=None):
    """Host or device: one chunked-prefill segment (B=1 after 4 packed
    chunks; it packs a fifth) at q8q4, bitmap and bitmap-q8, one pack of a
    chunk's K and V (B=1, 8 kv heads: what a segment does per layer) at
    each, one decode tick of the engine with 8 active slots (q8q4), and one
    of the q8q4 and of the bitmap engine with 8 active slots, one of them
    8,000 tokens long (31 pool chunks: the per-slot kernels' longest slot),
    each timed three ways: the host's time to enqueue it, the wall time
    until the card is done, and the device time of its kernels with the
    number of kernels launched (torch.profiler).  ``model`` (default
    Llama-3-8B) may be cut in depth (``cut_depth``): every number is then
    that depth's."""
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
    model = model or LLAMA3_8B
    eng = EngineConfig(model=model, cache_mode=CacheMode.COMPRESSED,
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
    kv = torch.randn((1, model.num_kv_heads, 256, 128), device="cuda",
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
                llama.prefill_segment(model, params, toks[:, s * 256:(s + 1) * 256],
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
    emit("host_split", model=f"{model.name} x{model.num_layers}L, W8 (random, seed 0)",
         segment_b1=segments["q8q4"], segment_b1_bitmap=segments["bitmap"],
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
            want["prune_quant_pack_kv"] = serve_packs()
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
    cut_model, cut_params = cut_depth(LLAMA3_8B, params)
    phase_serve_cb(cut_params, "bitmap", w4=True, model=cut_model)
    del cut_params
    del params
    torch.cuda.empty_cache()


MASKED_NEW = 100   # new tokens of the masked serve phases (their exits cross 3 groups)


def serve_opa(entries, params, prompt, new, dense_toks):
    """The masked cache and Opa pruning at full width and depth (B=8, prompt
    300, first tokens = serve_dense's): ``serve_masked`` (the EngineConfig
    defaults: masked cache, KT_MAG_VT_MAG at 0.5, plain route: no kernel)
    and ``serve_masked_opa`` (KT_MAG_VC_OPA at 0.7, use_pallas: kernel 4
    with its (m, l) 32 x 99 times), MASKED_NEW new tokens each;
    ``serve_opa_q8q4`` and ``serve_opa_bitmap`` (KT_MAG_VT_OPA at 0.7,
    ``new`` tokens, a compaction by score on the way: kernel 1 or 6 with
    its window probabilities 32 x 299 times; kernel 9 with V's scores 32 +
    1 times, K and V in one launch).  Each run's V scores must be live at
    its end (the options' results reached the cache).  Fills the options'
    launches in the kernels line."""
    from mustafar_tpu_torch.config import CacheMode, PruneConfig, PruneMethod
    opa = PruneConfig(method=PruneMethod.KT_MAG_VC_OPA, k_sparsity=0.7, v_sparsity=0.7)
    vt_opa = PruneConfig(method=PruneMethod.KT_MAG_VT_OPA, k_sparsity=0.7, v_sparsity=0.7)
    masked_steps, steps = 32 * (MASKED_NEW - 1), 32 * (new - 1)
    runs = (("serve_masked", CacheMode.MASKED, "q8q4", False, PruneConfig(), MASKED_NEW,
             {}),
            ("serve_masked_opa", CacheMode.MASKED, "q8q4", True, opa, MASKED_NEW,
             {"flash_decode_attention": masked_steps}),
            ("serve_opa_q8q4", CacheMode.COMPRESSED, "q8q4", False, vt_opa, new,
             {"fused_q_decode_attention": steps, "prune_quant_pack_kv": serve_packs()}),
            ("serve_opa_bitmap", CacheMode.COMPRESSED, "bitmap", False, vt_opa, new,
             {"fused_sparse_decode_attention": steps}))
    for label, mode, codec, use_pallas, prune, n_new, want in runs:
        scores = {}
        toks, launches, fields = serve(
            label, mode, params, prompt, n_new, codec=codec, use_pallas=use_pallas,
            prune=prune, on_cache=lambda c: scores.update(
                {k: float(c[k].abs().sum()) for k in ("k_score", "v_score") if k in c}))
        first_equal = bool((toks[:, 0] == dense_toks[:, 0]).all())
        emit(label, decode_steps=n_new - 1, expected_launches=want,
             first_token_equal_dense=first_equal,
             token_agreement_with_dense=(toks == dense_toks[:, :n_new]).float().mean().item(),
             score_sums=scores, **fields)
        scored = prune.method.v_policy in ("token_opa", "channel_opa")
        if launches != want or not first_equal or (scored and not scores.get("v_score")):
            raise AssertionError(f"{label}: launched {launches} (expected {want}), first "
                                 f"tokens equal the dense run's: {first_equal}, scores "
                                 f"{scores}")
        note = f"{label}: every launch with the option (V scored by {prune.method.value})"
        if label == "serve_masked_opa":
            opt = entries[("dense", "decode")]["options"]["return_norm"]
            opt.update(launches=launches["flash_decode_attention"], launches_note=note)
        elif label == "serve_opa_q8q4":
            opt = entries[("q8q4", "decode")]["options"]["return_win_probs"]
            opt.update(launches=launches["fused_q_decode_attention"], launches_note=note)
            opt = entries[("q8q4", "pack")]["options"]["score"]
            opt.update(launches=launches["prune_quant_pack_kv"],
                       launches_note=f"{label}: V ranked by its scores, K by |x|, one "
                                     f"launch a layer at prefill and one compaction")
        elif label == "serve_opa_bitmap":
            opt = entries[("bitmap", "decode")]["options"]["return_win_probs"]
            opt.update(launches=launches["fused_sparse_decode_attention"],
                       launches_note=note)


def serve_cb_opa(entries, params, model, reference_launches):
    """``serve_cb_opa``: the engine at full Llama-3-8B width (``model``, cut
    in depth by ``cut_depth``) under KT_MAG_VT_OPA at 0.7 (q8q4,
    ``serve_cb``'s first 8 requests): kernel 2 with its window
    probabilities a layer a decode step, kernel 3 a layer a segment,
    kernel 9 at serve_cb's packing counts (V ranked by its
    scores), first tokens equal to a batch-1 chunked Generator's under the
    same method, V's scores live at the end.  Fills the per-slot kernels'
    option launches in the kernels line (kernel 7's from
    ``reference_opa_cb``'s bitmap engine on the card)."""
    from mustafar_tpu_torch.config import PruneConfig, PruneMethod
    vt_opa = PruneConfig(method=PruneMethod.KT_MAG_VT_OPA, k_sparsity=0.7, v_sparsity=0.7)
    launches, _ = phase_serve_cb(params, "q8q4", first8=True, prune=vt_opa, model=model)
    name = "fused_q_decode_attention_ps"
    entries[("q8q4", "decode_ps")]["options"]["return_win_probs"].update(
        launches=launches[name],
        launches_note="serve_cb_opa: every launch with the option (V scored by "
                      "kt_mag_vt_opa)")
    name = "fused_sparse_decode_attention_ps"
    entries[("bitmap", "decode_ps")]["options"]["return_win_probs"].update(
        launches=reference_launches["kt_mag_vt_opa/bitmap"][name],
        launches_note="reference_opa_cb's bitmap engine under kt_mag_vt_opa on the card "
                      "(tiny model): every launch with the option")


def serve_packs():
    """Kernel 9 launches of a ``serve`` run of a quant codec: one a layer for
    prefill's chunk (300 - 32 tokens; K and V of every chunk of the layer's
    prompt in one launch) and one for the compaction (after decode step
    244; every layer's K and V in one launch)."""
    from mustafar_tpu_torch.config import LLAMA3_8B
    return LLAMA3_8B.num_layers + 1


SWA_B, SWA_PROMPT, SWA_NEW = 4, 4400, 300


def phase_serve_swa_chunked(params, m, prompt, q8q4_toks, new=64):
    """The chunked Generator on Mistral-7B with its window at full width and
    depth: B=4, serve_swa's 4,400-token prompt in 18 segments (segment 17's
    rows see chunk 0 none and chunk 1 past their own edge), ``new`` tokens;
    q8q4.  Kernel 3 with the window 32 a segment, kernel 1 32 a decode step,
    kernel 9 32 a packed chunk (17) and nothing else; tokens beside
    serve_swa_q8q4's (monolithic banded prefill)."""
    import numpy as np
    import torch
    from mustafar_tpu_torch.config import CacheMode, EngineConfig, PruneConfig, PruneMethod
    from mustafar_tpu_torch.models.llama import n_segments
    from mustafar_tpu_torch.runtime.generate import Generator
    T = prompt.shape[1]
    eng = EngineConfig(model=m, cache_mode=CacheMode.COMPRESSED,
                       prune=PruneConfig(method=PruneMethod.KT_MAG_VT_MAG, k_sparsity=0.7,
                                         v_sparsity=0.7),
                       max_seq_len=-(-T // 256) * 256 + new, prefill_bucket=256,
                       chunk_size=256, codec="q8q4", chunked_prefill=True)
    gen = Generator(eng, params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _set_launches(dict.fromkeys(_counters(), 0))
    t = time.perf_counter()
    toks = np.stack(gen.generate(prompt, new))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = {k: v for k, v in _launches().items() if v}
    L = m.num_layers
    want = {"fused_q_decode_attention": L * (new - 1),
            "fused_q_segment_attention": L * n_segments(T, 256),
            "prune_quant_pack_kv": L * ((T - 32) // 256)}
    agree = float((toks == q8q4_toks[:, :new].numpy()).mean())
    emit("serve_swa_chunked", model=f"{m.name} x{L}L, window {m.sliding_window}, W8 "
                                    f"(random, seed 0)",
         batch=prompt.shape[0], prompt=T, new_tokens=new, segments=n_segments(T, 256),
         seconds=dt, tok_s=toks.size / dt,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         n_chunks_end=gen.last_cache["nc_host"], launches=launches, expected_launches=want,
         token_agreement_with_serve_swa_q8q4=agree,
         first_token_equal_serve_swa_q8q4=bool((toks[:, 0]
                                                == q8q4_toks[:, 0].numpy()).all()))
    if toks.shape != (prompt.shape[0], new) or launches != want:
        raise AssertionError(f"serve_swa_chunked: tokens {toks.shape}, launches {launches} "
                             f"(expected {want})")
    del gen
    torch.cuda.empty_cache()


def serve_swa(entries, other, reference_runs, cb_runs):
    """Mistral-7B with its sliding window (``MISTRAL_7B_SWA``: 32 layers,
    hidden 4,096, 32 query and 8 kv heads, window 4,096) at full width and
    depth, W8 random weights from seed 0, through the ``Generator``: B=4, a
    4,400-token prompt (past the window: banded prefill; 17 chunks packed)
    and 300 new tokens (from the first step the window leaves chunk 0 out;
    one compaction after step 240).  ``serve_swa_dense`` (plain route, no
    kernel), ``serve_swa_dense_kernel`` (kernel 4 with ``window``),
    ``serve_swa_q8q4`` (kernel 1; kernel 9 at prefill and the compaction),
    ``serve_swa_bitmap`` (kernel 6): each decode kernel 32 x 299 launches,
    every first token equal to ``serve_swa_dense``'s; tok/s, prefill
    seconds (a prefill of the prompt alone) and peak memory.  Then the same
    weights through the engine (``serve_cb_swa_q8q4``, ``serve_cb_swa_bitmap``:
    ``phase_serve_cb``'s requests, kernels 2 and 3, or 7 and 8, with the
    window) and the chunked Generator (``serve_swa_chunked``).  Fills the
    window's launches in the kernels line (q8, q4q4 and bitmap-q8 from
    ``reference_swa``'s and ``reference_swa_cb``'s runs on the card, tiny
    model)."""
    import numpy as np
    import torch
    from mustafar_tpu_torch.config import CacheMode, MISTRAL_7B_SWA as m
    from mustafar_tpu_torch.models.quant import init_params_w8, weight_bytes
    t = time.perf_counter()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    params = init_params_w8(m, g, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    prompt = np.random.RandomState(0).randint(1, m.vocab_size, (SWA_B, SWA_PROMPT))
    steps = SWA_NEW - 1
    expected = m.num_layers * steps
    common = dict(model=m, max_seq_len=-(-SWA_PROMPT // 256) * 256 + SWA_NEW,
                  chunks_end=SWA_PROMPT // 256 + 1, time_prefill=True)
    model_note = (f"{m.name} x{m.num_layers}L, window {m.sliding_window}, W8 (random, "
                  f"seed 0)")
    dense_toks, launches, fields = serve("serve_swa_dense", CacheMode.DENSE, params, prompt,
                                         SWA_NEW, **common)
    emit("serve_swa_dense", model=model_note, weights_gib=weight_bytes(params) / 2 ** 30,
         weights_init_s=init_s, decode_steps=steps, **fields)
    if launches:
        raise AssertionError(f"serve_swa_dense launched {launches}")
    runs = (("serve_swa_dense_kernel", CacheMode.DENSE, "q8q4", True,
             {"flash_decode_attention": expected}, ("dense", "decode")),
            ("serve_swa_q8q4", CacheMode.COMPRESSED, "q8q4", False,
             {"fused_q_decode_attention": expected, "prune_quant_pack_kv": m.num_layers + 1},
             ("q8q4", "decode")),
            ("serve_swa_bitmap", CacheMode.COMPRESSED, "bitmap", False,
             {"fused_sparse_decode_attention": expected}, ("bitmap", "decode")))
    served = {}
    for label, mode, codec, use_pallas, want, key in runs:
        toks, launches, fields = serve(label, mode, params, prompt, SWA_NEW, codec=codec,
                                       use_pallas=use_pallas, **common)
        served[label] = toks
        first_equal = bool((toks[:, 0] == dense_toks[:, 0]).all())
        emit(label, model=model_note, decode_steps=steps, expected_launches=want,
             first_token_equal_dense=first_equal,
             token_agreement_with_dense=(toks == dense_toks).float().mean().item(), **fields)
        if launches != want or not first_equal:
            raise AssertionError(f"{label}: launched {launches} (expected {want}), first "
                                 f"tokens equal serve_swa_dense's: {first_equal}")
        name = _meta(codec if mode == CacheMode.COMPRESSED else "dense", "decode")[0]
        entries[key]["options"]["window"].update(
            launches=launches[name],
            launches_note=f"{label}: every decode launch with the window "
                          f"({m.sliding_window})")
    for codec in ("q8", "q4q4", "bitmap-q8"):
        name = _meta(codec, "decode")[0]
        other[(codec, "decode")]["options"]["window"].update(
            launches=reference_runs[f"compressed/{codec}"]["launched"][name],
            launches_note="reference_swa's run on the card (tiny model, window 320)")
    for codec in ("q8q4", "bitmap"):
        launches, _ = phase_serve_cb(params, codec, model=m)
        for kind in ("decode_ps", "segment"):
            entries[(codec, kind)]["options"]["window"].update(
                launches=launches[_meta(codec, kind)[0]],
                launches_note=f"serve_cb_swa_{codec}: every launch with the window "
                              f"({m.sliding_window})")
    for codec in ("q8", "q4q4", "bitmap-q8"):
        for kind in ("decode_ps", "segment"):
            other[(codec, kind)]["options"]["window"].update(
                launches=cb_runs[f"engine/{codec}"]["launched"][_meta(codec, kind)[0]],
                launches_note="reference_swa_cb's engine on the card (tiny model, window "
                              "320)")
    phase_serve_swa_chunked(params, m, prompt, served["serve_swa_q8q4"])
    del params
    torch.cuda.empty_cache()


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
        for c in rest:                # each codec's sliding window
            e["codecs"][c]["window"] = other[(c, kind)]["options"]["window"]
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
    phase_reference_masked()
    phase_reference_opa()
    opa_cb_launches = phase_reference_opa_cb()
    swa_runs = phase_reference_swa()
    swa_cb_runs = phase_reference_swa_cb()
    phase_reference_sample()

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
    want = {"fused_q_decode_attention": expected, "prune_quant_pack_kv": serve_packs()}
    emit("serve_q8q4", model="llama-3-8b x32L, W8 (random, seed 0)",
         weights_gib=weight_bytes(params) / 2 ** 30, weights_init_s=init_s,
         decode_steps=decode_steps, expected_launches=want, **fields)
    if launches != want:
        raise AssertionError(f"kernels launched {launches}, expected {want}: 32 layers x "
                             f"{decode_steps} steps of the decode kernel, and kernel 9")
    entries[("q8q4", "decode")]["launches"] = expected
    entries[("q8q4", "pack")]["launches"] = launches["prune_quant_pack_kv"]
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
        want = {"fused_q_decode_attention": expected, "prune_quant_pack_kv": serve_packs()}
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
    serve_opa(entries, params, prompt, new, dense_toks)
    phase_decode_split(params, entries[("q8q4", "decode")]["kernel_ms"], q8q4_s,
                       dense_s, new)
    cb_runs = {}
    cut_model, cut_params = cut_depth(LLAMA3_8B, params)
    for codec in ("q8q4", "bitmap"):
        cb_launches, cb_runs[codec] = (phase_serve_cb(params, codec) if codec == "q8q4" else
                                       phase_serve_cb(cut_params, codec, model=cut_model))
        for kind in ("decode_ps", "segment"):
            entries[(codec, kind)]["launches"] = cb_launches[_meta(codec, kind)[0]]
    cb_launches, _ = phase_serve_cb(cut_params, "bitmap-q8", model=cut_model,
                                    beside={"serve_cb_bitmap": cb_runs["bitmap"]})
    for kind in ("decode_ps", "segment"):
        other[("bitmap-q8", kind)]["launches"] = cb_launches[_meta("bitmap-q8", kind)[0]]
    cb_launches, _ = phase_serve_cb(cut_params, "q4q4", first8=True, model=cut_model)
    for kind in ("decode_ps", "segment"):
        name = _meta("q4q4", kind)[0]
        other[("q4q4", kind)]["launches"] = cb_launches[name]
        other[("q8", kind)]["launches"] = q_engine_launches["q8"][name]
    serve_cb_opa(entries, cut_params, cut_model, opa_cb_launches)
    _merge_codecs(entries, other, "q8q4", ("q8", "q4q4"),
                  "q8q4 and q4q4 from serve_q8q4 / serve_q4q4 and "
                  "serve_cb / serve_cb_q4q4; q8's per-slot and segment launches from "
                  "reference_q's engine run on the card (tiny model)")
    _merge_codecs(entries, other, "bitmap", ("bitmap-q8",),
                  "bitmap and bitmap-q8 from serve_bitmap / serve_bitmap_q8 and "
                  "serve_cb_bitmap / serve_cb_bitmap_q8")
    phase_serve_chunked(params)
    phase_host_split(cut_params, cut_model)
    del params, cut_params
    torch.cuda.empty_cache()
    serve_swa(entries, other, swa_runs, swa_cb_runs)
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
