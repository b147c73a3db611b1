"""Before / after of the port's kernels on one card: run it once for each
checkout in one call (parent, change, change, parent) and compare the lines.

    python3 tools/kernel_ab.py --root DIR --label NAME \
        [--engine | --host-only | --variants | --eager-engine | --archive]

``DIR`` is the root of a checkout of this repository (its ``chip_smoke.py``
and ``mustafar_tpu_torch/``; an unpacked ``git archive`` of another commit
will do).  From that checkout it builds the kernels and runs the kernel
phases of its ``chip_smoke.py`` (every codec's decode, per-slot and segment
kernels, the pack, W4, dense and archive kernels; each prints its JSON
line), then prints a ``kernel_ab`` line: the SHA-256 of the outputs of the
uniform decode kernels 1 (q8q4, q8, q4q4) and 6 (bitmap, bitmap-q8; G=4,
bf16 and f32 q, five (n_chunks, win_len) cases each), of the per-slot
decode kernels 2 and 7 (each codec, at ``phase_kernel_ps``'s slots), of
the segment kernels 3 (q8q4, q8, q4q4) and 8 (bitmap, bitmap-q8): acc, m
and l at ``phase_kernel_seg``'s cases, and of the W4 kernel 5 at every
``W4_SHAPES`` shape at T = 8 and 32, and of the pack kernel 9 (rows and
scales at ``phase_kernel_pack``'s one-tensor cases), so that two
checkouts' outputs can be compared bit for bit; the device time of
kernels 1 and 6 (1 chunk + 288 window and 5 chunks + 288, ``k1_k6_ms``),
3 (at 1, 4, 16 and 31 chunks) and 5 (``k3_k5_ms``) and 9 (``k9_ms``: K
alone at 64 head-chunks, and K and V at 64 and 8 head-chunks and over a
compaction's 32 layers, in one launch where the checkout has
``prune_quant_pack_kv``, else as the cache packed them before it: a
launch each for K and V, of each layer); and the host time of the kernel
1, 2, 4, 5, 6, 7 and 9 wrappers (``wrapper_host_us``: the least and the
median of means over many calls, steadier than the kernel phases' single
mean).  With
``--engine`` it then makes the random W8 Llama-3-8B
weights (seed 0) and runs the ``serve_cb`` (q8q4) and ``host_split``
phases of the ``chip_smoke.py`` next to this script on DIR's package, so
both checkouts take the same engine measurements.  With ``--host-only`` it
builds and prints only the wrappers' host time, over batches of 40 calls
(the launch queue never fills) and of 400 (alternate the two checkouts'
processes a few times: the host's speed drifts from process to process).
With ``--variants [LIB ...]`` it builds each of ``VARIANTS`` (a kernel's
source with a few substitutions; those of the named libraries only, if
any) beside DIR's own build, prints their ptxas reports and times the
variant's kernels (``VARIANT_TIMES``: kernels 1 and 6, or 3 and 5) with
DIR's build and each variant in turn, beside the digests of DIR's
kernels.  With ``--eager-engine`` it builds the kernels and times only
the eager paths (``graph=False``) of DIR's package at ``serve_cb``'s depth
(DIR's ``chip_smoke.cut_depth`` of the random W8 Llama-3-8B, seed 0),
q8q4: the engine on ``serve_cb``'s 17 requests (the wall time of its ticks
by what they ran, as ``serve_cb`` splits them, and the SHA-256 of the
tokens), a batch-1 chunked ``Generator`` prefill of 1,280 tokens (5
segments: enqueue and wall ms, the least of 5), and DIR's
``phase_serve_cb_tp`` (the engine at tp=2, two processes on the card over
gloo).  With ``--archive`` it builds the kernels and prints only the
device time of the archive's kernels 12 and 13 (v2, v3) and of kernel 6
at the ``kernel_archive`` ladder's shapes (``archive_ms``), the SHA-256 of
kernels 14 and 16's outputs there (v4, v6's partials) and the digests of
kernels 1-9 above.  Needs one CUDA card.
"""

import argparse
import dataclasses
import hashlib
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sha(tensors):
    """SHA-256 of the tensors' bits, in order."""
    import torch
    h = hashlib.sha256()
    for t in tensors:
        bits = t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)
        h.update(bits.cpu().numpy().tobytes())
    return h.hexdigest()


# chip_smoke.phase_kernel_ps's slots: (n_chunks, win_len) of 8 slots at mc = 32
PS_SLOTS = ((0, 0), (0, 1), (1, 44), (2, 288), (5, 288), (5, 1), (1, 0), (31, 288))


def digests(c):
    """Output digests of kernels 1 and 6 (uniform decode, each codec), 2 and
    7 (per-slot decode, each codec, at ``PS_SLOTS``), 3 and 8 (segment
    partials acc, m, l, each codec) and 5 (W4, every projection shape at T =
    8 and 32), from DIR's kernels on inputs made from fixed seeds."""
    import torch
    dev = torch.device("cuda")
    out = {}
    for codec in ("q8q4", "q8", "q4q4", "bitmap", "bitmap-q8"):
        g = torch.Generator(device=dev)
        g.manual_seed(11)
        kit = c._Kit(codec, g, dev, 2, 5, 64, 288)
        q = torch.randn((8, 1, 32, 128), generator=g, device=dev).to(torch.bfloat16)
        out[f"decode_{codec}"] = _sha(
            kit.decode(qq, nc, wl, li) for qq in (q, q.float())
            for nc, wl, li in ((0, 44, 0), (1, 288, 1), (2, 1, 0), (5, 288, 1), (5, 0, 0)))
    for codec in ("q8q4", "q8", "q4q4", "bitmap", "bitmap-q8"):
        g = torch.Generator(device=dev)
        g.manual_seed(12)
        kit = c._Kit(codec, g, dev, 2, 32, 64, 288)
        q = torch.randn((8, 1, 32, 128), generator=g, device=dev).to(torch.bfloat16)
        nc = torch.tensor([n for n, _ in PS_SLOTS], dtype=torch.int32, device=dev)
        wl = torch.tensor([w for _, w in PS_SLOTS], dtype=torch.int32, device=dev)
        out[f"decode_ps_{codec}"] = _sha(kit.decode_ps(qq, nc, wl, li) for qq in (q, q.float())
                                         for li in (0, 1))
        del kit
    for codec in ("bitmap", "bitmap-q8"):
        g = torch.Generator(device=dev)
        g.manual_seed(3)
        parts = []
        for B, sparsity in ((1, 0.7), (2, 0.7), (1, 0.5)):
            kit = c._Kit(codec, g, dev, 2, 32, B * 8, 8, sparsity)
            qb = torch.randn((B, 256, 32, 128), generator=g, device=dev).to(torch.bfloat16)
            for nc in (0, 1, 4, 31):
                for qq, li in ((qb, nc % 2), (qb.float(), (nc + 1) % 2)):
                    parts.extend(kit.segment(qq, nc, li))
        out[f"segment_{codec}"] = _sha(parts)
    for codec in ("q8q4", "q8", "q4q4"):
        g = torch.Generator(device=dev)
        g.manual_seed(3)
        parts = []
        for B in (1, 2):
            kit = c._Kit(codec, g, dev, 2, 32, B * 8, 8)
            qb = torch.randn((B, 256, 32, 128), generator=g, device=dev).to(torch.bfloat16)
            for nc in (0, 1, 4, 31):
                for qq, li in ((qb, nc % 2), (qb.float(), (nc + 1) % 2)):
                    parts.extend(kit.segment(qq, nc, li))
        out[f"segment_{codec}"] = _sha(parts)
    from mustafar_tpu_torch.ops.kernels import w4_matmul as w4
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    for label, (din, dout) in c.W4_SHAPES.items():
        cw = torch.randint(-32768, 32768, (din // 4, dout), generator=g, device=dev,
                           dtype=torch.int32).to(torch.int16)
        sw = (0.001 + 0.02 * torch.rand((din // 128, dout), generator=g,
                                        device=dev)).to(torch.bfloat16)
        out[f"w4_{label}"] = _sha(
            w4.w4_matmul(torch.randn((T, din), generator=g, device=dev).to(torch.bfloat16),
                         cw, sw) for T in (8, 32))
    out["pack"] = _sha(pack_outputs(c))
    return out


def _pack_chunk(g, dev, lead, C=256):
    """phase_kernel_pack's chunk: 0.3 randn in bf16 with ties, a zero row,
    a row of equal magnitudes and a row of two values."""
    import torch
    x = (0.3 * torch.randn((*lead, C, 128), generator=g, device=dev)).to(torch.bfloat16)
    x[..., 10] = x[..., 90]
    x[..., 5, :] = 0
    x[..., 7, :] = 0.5
    x[..., 9, :] = torch.where(torch.arange(128, device=dev) % 2 == 0, 0.25, -0.75)
    return x


def pack_outputs(c):
    """Kernel 9's rows and scales (the one-tensor wrapper, which both
    checkouts have) at phase_kernel_pack's cases: 64 and 8 head-chunks of
    256, bits 8 and 4, keep 40 / 14 / 128, the score at 64; C = 128, 384 and
    512 at 8 head-chunks, with and without a score."""
    import torch
    from mustafar_tpu_torch.ops.kernels import pack_kernel as pk
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    outs = []
    for BH in (64, 8):
        x = _pack_chunk(g, dev, (BH,))
        score = torch.rand((BH, 256, 128), generator=g, device=dev)
        for bits in (8, 4):
            for keep in (40, 14, 128):
                outs.extend(pk.prune_quant_pack(x, keep, bits))
            if BH == 64:
                outs.extend(pk.prune_quant_pack(x, 40, bits, score))
    for C in (128, 384, 512):
        x = _pack_chunk(g, dev, (8,), C)
        score = torch.rand((8, C, 128), generator=g, device=dev)
        for bits in (8, 4):
            outs.extend(pk.prune_quant_pack(x, 40, bits))
            outs.extend(pk.prune_quant_pack(x, 40, bits, score))
    return outs


def _pack_calls(dev, g):
    """Kernel 9's calls at the serving shapes (q8q4, keep 40): K alone at 64
    head-chunks; K and V at 64 (B=8 prefill) and 8 (the engine's batch-1
    segment); K and V of a 32-layer compaction at B=8 into pool views.  In
    one launch each where the checkout has ``prune_quant_pack_kv``; else as
    the cache packed them before it (K and V apart, a layer at a time)."""
    import torch
    from mustafar_tpu_torch.ops.kernels import pack_kernel as pk
    fn, kv = pk.prune_quant_pack, getattr(pk, "prune_quant_pack_kv", None)
    x64 = _pack_chunk(g, dev, (8, 8))
    v64 = _pack_chunk(g, dev, (8, 8))
    x8, v8 = _pack_chunk(g, dev, (1, 8)), _pack_chunk(g, dev, (1, 8))
    L = 32
    kw = _pack_chunk(g, dev, (L, 8, 8), 288)[..., :256, :]
    vw = _pack_chunk(g, dev, (L, 8, 8), 288)[..., :256, :]
    pool = torch.zeros((L, 2, 8, 8, 192, 128), dtype=torch.int16, device=dev)
    scales = torch.zeros((L, 2, 8, 8, 2, 128), dtype=torch.bfloat16, device=dev)
    ko = (pool[:, 1, ..., :128, :], scales[:, 1, ..., 0, :])
    vo = (pool[:, 1, ..., 128:, :], scales[:, 1, ..., 1, :])

    def pair(k, v):
        return (lambda: kv(k, v, 40, 40, 8, 4)) if kv else \
            (lambda: (fn(k, 40, 8), fn(v, 40, 4)))

    def compaction_per_layer():
        for li in range(L):
            fn(kw[li], 40, 8, rows_out=ko[0][li], scales_out=ko[1][li])
            fn(vw[li], 40, 4, rows_out=vo[0][li], scales_out=vo[1][li])

    calls = {"k9_k_BH64": lambda: fn(x64, 40, 8), "k9_kv_BH64": pair(x64, v64),
             "k9_kv_BH8": pair(x8, v8),
             "k9_kv_compaction_L32": (lambda: kv(kw, vw, 40, 40, 8, 4, k_out=ko, v_out=vo))
             if kv else compaction_per_layer}
    if kv:
        calls["k9_kv_compaction_L32_per_layer"] = compaction_per_layer
    return calls


def _long_spin_ms(call, reps, flush):
    """``chip_smoke.cuda_ms`` with a spin of ~40 ms: the per-layer compaction's
    64 wrapper calls take longer on the host than its ~2 ms spin."""
    import torch
    total = 0.0
    for _ in range(reps):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(80_000_000)
        start.record()
        call()
        if start.query():
            raise RuntimeError("the card reached the start event before the host "
                               "enqueued the call: lengthen the spin")
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def k9_ms(c):
    """Device ms of kernel 9's calls (``_pack_calls``), L2 flushed; the
    compaction's under a longer spin (``_long_spin_ms``)."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(14)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    out = {}
    for label, call in _pack_calls(dev, g).items():
        for _ in range(3):
            call()
        out[label] = (_long_spin_ms(call, 10, flush.zero_) if "compaction" in label
                      else c.cuda_ms(call, 50, flush=flush.zero_)[0])
    return out


def wrapper_host_us(c, reps=7, calls=200):
    """Host microseconds a wrapper call takes to return: the least and the
    median of ``reps`` means over ``calls`` back-to-back calls, the card
    synchronised between (a shared host only adds time, so the least is the
    steadier), for kernel 4 (B=8, S=1,312, pos 599 and per slot at S=8,448),
    kernels 2 (q8q4) and 7 (bitmap) at chip_smoke's mixed slots at mc=32,
    kernels 6 (bitmap) and 1 (q8q4) at 1 chunk + 288 window, kernel 5 (W4) at
    4096 x 14336 and 4096 x 1024, T=8, kernel 9 at ``_pack_calls``' shapes
    but the compaction and, for scale, one
    ``torch.empty`` of the split scratch (4.7 MB) and one small
    ``torch.add`` (one launch)."""
    import statistics
    import torch
    from mustafar_tpu_torch.ops.kernels import dense_decode as dd
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(3)

    def timed(fn):
        fn()
        means = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(calls):
                fn()
            means.append((time.perf_counter() - t) / calls * 1e6)
        torch.cuda.synchronize()
        return [min(means), statistics.median(means)]

    out = {}
    B, Hkv, D = 8, 8, 128
    q = torch.randn((B, 1, Hkv * 4, D), generator=g, device=dev).to(torch.bfloat16)
    for label, S, pos in (("k4_uniform", 1312, 599),
                          ("k4_per_slot", 8448, torch.tensor(
                              [8000, 1210, 300, -1, 640, 1499, 45, 950],
                              dtype=torch.int32, device=dev))):
        k = torch.randn((B, S, Hkv, D), generator=g, device=dev).to(torch.bfloat16)
        out[label] = timed(lambda: dd.flash_decode_attention(q, k, k, pos))
        del k
    kit = c._Kit("bitmap", g, dev, 4, 32, B * Hkv, 288)
    slots = [(0, 0), (0, 1), (1, 44), (2, 288), (5, 288), (5, 1), (1, 0), (31, 288)]
    nc = torch.tensor([n for n, _ in slots], dtype=torch.int32, device=dev)
    wl = torch.tensor([w for _, w in slots], dtype=torch.int32, device=dev)
    out["k7_mixed"] = timed(lambda: kit.decode_ps(q, nc, wl, 0))
    out["k6"] = timed(lambda: kit.decode(q, 1, 288, 0))
    kit = c._Kit("q8q4", g, dev, 4, 32, B * Hkv, 288)
    out["k2_mixed"] = timed(lambda: kit.decode_ps(q, nc, wl, 0))
    out["k1"] = timed(lambda: kit.decode(q, 1, 288, 0))
    from mustafar_tpu_torch.ops.kernels import w4_matmul as w4
    for label, (din, dout) in (("k5_w_gate_up_T8", (4096, 14336)),
                               ("k5_wk_wv_T8", (4096, 1024))):
        cw = torch.zeros((din // 4, dout), dtype=torch.int16, device=dev)
        sw = torch.ones((din // 128, dout), dtype=torch.bfloat16, device=dev)
        xw = torch.randn((8, din), generator=g, device=dev).to(torch.bfloat16)
        out[label] = timed(lambda: w4.w4_matmul(xw, cw, sw))
    for label, call in _pack_calls(dev, g).items():
        if "compaction" not in label:
            out[label] = timed(call)
    out["torch_empty_k7_scratch"] = timed(
        lambda: torch.empty(B * Hkv * 35 * 4 * 130, dtype=torch.float32, device=dev))
    x = torch.zeros(1024, device=dev)
    out["torch_add"] = timed(lambda: torch.add(x, 1.0, out=x))
    return out


# kernel 3's first pass in one m64n256k16 product a k-step (the chunk's
# scores at once, 128 accumulators a thread) instead of four of m64n64
_N256_HELPER = ("""__device__ __forceinline__ void wgmma_64x256_ss(float (&d)[128], uint64_t a,
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %130, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"""
                + ", ".join(f"%{i}" for i in range(128))
                + """}, %128, %129, p, 1, 1, 0, 0;\\n}\\n"
      : """ + ", ".join(f'"+f"(d[{i}])' for i in range(128)) + """
      : "l"(a), "l"(b), "r"(accumulate));
}

""")
_K3_PASS1_N64 = """#pragma unroll 1
    for (int tok0 = 0; tok0 < CHUNK; tok0 += SUB) {
      float s[32];
      sub_scores(sb, tok0, s);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * nt], s[4 * nt + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * nt + 2], s[4 * nt + 3]));
      }
    }"""
_K3_PASS1_N256 = """    {
      float s[128];
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_64x256_ss(s, sw128_desc(sb + QK + (kk >> 2) * (BLOCK_ROWS * 128) + (kk & 3) * 32),
                        sw128_desc(sb + KT + (kk >> 2) * (CHUNK * 128) + (kk & 3) * 32), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
#pragma unroll
      for (int nt = 0; nt < 32; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * nt], s[4 * nt + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * nt + 2], s[4 * nt + 3]));
      }
      mx0 *= SM_SCALE;               // the scale is positive: max commutes with it
      mx1 *= SM_SCALE;
    }"""

# Variants for ``--variants``: (library, label, {file of csrc/: [(old, new),
# ...]}), each built from a copy of DIR's csrc/ with the substitutions (a
# variant whose text DIR lacks is skipped).  "Timed only": its outputs are
# wrong by design.  Kernels 3 and 5 without one of their parts, to see what
# each costs:
VARIANTS = (
    # kernel 3 without unpacking the codes (the tiles keep stale values),
    # without the score products (both passes), without the value product
    ("q_segment", "k3_no_unpack", {"q_segment.cu": [
        ("i < K_ROWS * 16; i += THREADS", "i < 0; i += THREADS"),
        ("it < V_ROWS * 16 / THREADS; ++it", "it < 0; ++it")]}),
    ("q_segment", "k3_no_scores", {"q_segment.cu": [
        ("    wgmma_64x64_ss(s, a, b, kk > 0);", "")]}),
    ("q_segment", "k3_no_pv", {"q_segment.cu": [
        ("for (int j = 0; j < SUB / 16; ++j) {", "for (int j = 0; j < 0; ++j) {")]}),
    # kernel 3 with its unpack loops unrolled by 4, not 2; with its first
    # pass as one product of the whole chunk a k-step (outputs as shipped
    # within the gates: the same products, another grouping)
    ("q_segment", "k3_unpack_unroll4", {"q_segment.cu": [
        ("#pragma unroll 2\n    for (int i = tid; i < K_ROWS * 16; i += THREADS)",
         "#pragma unroll 4\n    for (int i = tid; i < K_ROWS * 16; i += THREADS)"),
        ("#pragma unroll 2\n    for (int it = 0; it < V_ROWS * 16 / THREADS; ++it)",
         "#pragma unroll 4\n    for (int it = 0; it < V_ROWS * 16 / THREADS; ++it)")]}),
    ("q_segment", "k3_pass1_n256", {"q_segment.cu": [
        ("// Scores of the CTA's 64 rows against tokens tok0 .. tok0 + 63, scaled.",
         _N256_HELPER + "// Scores of the CTA's 64 rows against tokens tok0 .. tok0 + 63, scaled."),
        (_K3_PASS1_N64, _K3_PASS1_N256)]}),
    # kernel 5 with every tile written by the CTA that ends it, unreduced;
    # and without its products (the ring still streams every unit)
    ("w4_matmul", "k5_no_reduce", {"w4_matmul.cu": [
        ("const bool alone = kfirst >= u_begin && kfirst + gr.nb <= u_end;",
         "const bool alone = true;")]}),
    ("w4_matmul", "k5_no_compute", {"w4_matmul.cu": [
        ("    for (int i = 0; i < 4; ++i)\n#pragma unroll\n      for (int jp = 0; jp < 2; ++jp) {",
         "    for (int i = 0; i < 0; ++i)\n#pragma unroll\n      for (int jp = 0; jp < 2; ++jp) {")]}),
    # timed only: kernel 1 without its chunks' scores, kernel 6 without its
    # expansion or its chunks' scores
    ("q_decode", "k1_no_chunk_scores", {"q_decode.cu": [
        ("for (int r0 = 8 * warp; r0 < K_ROWS; r0 += 8 * WARPS) {",
         "for (int r0 = 8 * warp; r0 < 0; r0 += 8 * WARPS) {")]}),
    ("sp_decode", "k6_no_expand", {"chunk_share.cuh": [
        ("for (int r0 = warp; r0 < STEP; r0 += NR * WARPS) {",
         "for (int r0 = warp; r0 < 0; r0 += NR * WARPS) {")]}),
    ("sp_decode", "k6_no_chunk_scores", {"sp_decode.cu": [
        ("    tile_scores<G>(sm, kt, STEP, warp, lane);\n", "")]}),
    # kernel 9 with every code divided (no reciprocal fast path): the same
    # outputs.  Timed only: returning at once (the launch), without its
    # staging copies, its selection (every entry kept), its cluster's amax
    # exchange or its codes and stores
    ("prune_quant_pack", "k9_divide_all", {"prune_quant_pack.cu": [
        ("  if (fabsf(v - (tv - MAGIC)) < 0.5f - HALF_STEP_MARGIN) return __float_as_uint(tv);",
         "")]}),
    ("prune_quant_pack", "k9_empty", {"prune_quant_pack.cu": [
        ("  extern __shared__ __align__(16) unsigned char smem_raw[];\n  cg::cluster_group",
         "  if (p.C > 0) return;\n  extern __shared__ __align__(16) unsigned char smem_raw[];\n"
         "  cg::cluster_group")]}),
    ("prune_quant_pack", "k9_no_stage", {"prune_quant_pack.cu": [
        ("for (int c = lane; c < RG * 16; c += 32) {", "for (int c = lane; c < 0; c += 32) {")]}),
    ("prune_quant_pack", "k9_no_select", {"prune_quant_pack.cu": [
        ("(warp + pass * warps) * RG, op.keep, lane, am);",
         "(warp + pass * warps) * RG, D, lane, am);")]}),
    ("prune_quant_pack", "k9_no_cluster", {"prune_quant_pack.cu": [
        ("  if (S > 1) cluster_arrive_relaxed();", "  if (S > 1000) cluster_arrive_relaxed();"),
        ("  if (S > 1) {\n    // push", "  if (S > 1000) {\n    // push")]}),
    ("prune_quant_pack", "k9_no_codes", {"prune_quant_pack.cu": [
        ("  if (op.bits == 8)\n    write_codes<8>", "  if (op.bits == 0)\n    write_codes<8>"),
        ("  else\n    write_codes<4>", "  else if (op.bits == 0)\n    write_codes<4>")]}),
)


def build_variant(lib, label, subs):
    """nvcc of csrc/<lib>.cu from a copy of csrc/ with the substitutions,
    into the package's build directory; returns (library path, ptxas
    lines), or None if the sources lack a substitution's text."""
    import shutil
    import subprocess
    from mustafar_tpu_torch.ops.kernels import build
    out = build.BUILD_DIR / "variants" / label
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, out / "csrc")
    for fname, pairs in subs.items():
        path = out / "csrc" / fname
        text = path.read_text()
        for old, new in pairs:
            if old not in text:
                return None
            text = text.replace(old, new)
        path.write_text(text)
    so = out / f"lib{lib}.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                           str(out / "csrc" / f"{lib}.cu")], capture_output=True,
                          text=True, timeout=build.BUILD_TIMEOUT_S)
    if proc.returncode:
        raise RuntimeError(f"variant {label}: nvcc failed:\n{proc.stderr[-4000:]}")
    return str(so), [ln.strip() for ln in proc.stderr.splitlines()
                     if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def k3_k5_ms(c):
    """Device ms of kernel 3 (B=1, T=256, G=4 at 1, 4, 16 and 31 chunks, the
    counts ``serve_cb`` launches it at; q8q4, q8, q4q4) and of kernel 5
    (every ``W4_SHAPES`` shape at T=8, L2 flushed) with the libraries
    loaded now."""
    import torch
    from mustafar_tpu_torch.ops.kernels import w4_matmul as w4
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    out = {}
    for codec in ("q8q4", "q8", "q4q4"):
        kit = c._Kit(codec, g, dev, 2, 32, 8, 8)
        q = torch.randn((1, 256, 32, 128), generator=g, device=dev).to(torch.bfloat16)
        for n in (1, 4, 16, 31):
            for _ in range(3):
                kit.segment(q, n, 0)
            out[f"k3_{codec}_{n}"] = c.cuda_ms(lambda: kit.segment(q, n, 0), 20)[0]
    for label, (din, dout) in c.W4_SHAPES.items():
        cw = torch.randint(-32768, 32768, (din // 4, dout), generator=g, device=dev,
                           dtype=torch.int32).to(torch.int16)
        sw = (0.001 + 0.02 * torch.rand((din // 128, dout), generator=g,
                                        device=dev)).to(torch.bfloat16)
        x = torch.randn((8, din), generator=g, device=dev).to(torch.bfloat16)
        for _ in range(3):
            w4.w4_matmul(x, cw, sw)
        out[f"k5_{label}_T8"] = c.cuda_ms(lambda: w4.w4_matmul(x, cw, sw), 30,
                                          flush=flush.zero_)[0]
    return out


def k1_k6_ms(c):
    """Device ms of kernels 1 (q8q4, q8, q4q4) and 6 (bitmap, bitmap-q8) at
    ``phase_kernel``'s shapes (B=8, Hkv=8, G=4, W=288, L2 flushed): 1 chunk
    and the full 288-token window, and the full pool, 5 chunks + 288."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    out = {}
    for codec in ("q8q4", "q8", "q4q4", "bitmap", "bitmap-q8"):
        kit = c._Kit(codec, g, dev, 2, 5, 64, 288)
        q = torch.randn((8, 1, 32, 128), generator=g, device=dev).to(torch.bfloat16)
        k = 1 if codec in c.QUANT_BITS else 6
        for nc in (1, 5):
            for _ in range(3):
                kit.decode(q, nc, 288, 0)
            out[f"k{k}_{codec}_{nc}"] = c.cuda_ms(lambda: kit.decode(q, nc, 288, 0), 50,
                                                  flush=flush.zero_)[0]
    return out


ARCHIVE_SHAPES = {"a": (8, 5, 1, 288, 288), "b": (32, 3, 3, 288, 132)}   # B, mc, nc, W, wl


def archive_ms(c, rounds=3, reps=100):
    """Device ms (L2 flushed, the mean of ``reps`` launches; ``rounds``
    rounds in turns) of kernels 12 and 13 (v2, v3) and kernel 6 at the
    ``kernel_archive`` ladder's shapes (Hkv=8, G=4, sparsity 0.7): (a) B=8,
    1 chunk + 288 window, (b) B=32, 3 chunks + 132; and the SHA-256 of
    kernels 14 and 16's outputs there (v4's output, v6's partials), through
    the wrappers DIR's checkout has in common with its parent."""
    import torch
    from mustafar_tpu_torch.ops import sparse_format as sf
    from mustafar_tpu_torch.ops.kernels import sparse_attention_archive as sar
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(10)
    bf = torch.bfloat16
    fmt = sf.ChunkFormat(256, 128, 40)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    times, kept = {}, []
    for label, (B, mc, nc, W, wl) in ARCHIVE_SHAPES.items():
        pools = c._archive_pools(
            torch.randn((2, B * 8, mc, 256, 128), generator=g, device=dev).to(bf), fmt)
        q = torch.randn((B, 1, 32, 128), generator=g, device=dev).to(bf)
        kw = torch.randn((B, W, 8, 128), generator=g, device=dev).to(bf)
        vw = torch.randn((B, W, 8, 128), generator=g, device=dev).to(bf)
        calls = c._archive_calls(pools, q, kw, vw, nc, wl, fmt, mc)
        kept.append(calls["v4"][0]())
        kept.extend(sar.fused_sparse_decode_attention_v6_partials(
            q, pools["stream"][0], nc, wl, fmt, fmt, mc))
        for name in ("v2", "v3", "kernel6"):
            for _ in range(5):
                calls[name][0]()
        torch.cuda.synchronize()
        for _ in range(rounds):
            for name in ("v2", "v3", "kernel6"):
                times.setdefault(f"{name}_{label}", []).append(
                    c.cuda_ms(calls[name][0], reps, flush=flush.zero_)[0])
    return times, _sha(kept)


# the kernels each library's variants are timed on
VARIANT_TIMES = {"q_segment": k3_k5_ms, "w4_matmul": k3_k5_ms, "q_decode": k1_k6_ms,
                 "sp_decode": k1_k6_ms, "prune_quant_pack": k9_ms}


def run_variants(c, label, smi, libs):
    """The ``--variants`` mode: builds, then DIR's build, each variant of
    its library (those of ``libs``, all if empty), and DIR's build again,
    timed in turn on the variant's kernels (``VARIANT_TIMES``); with the
    digests of DIR's kernels (``digests``)."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor
    from mustafar_tpu_torch.ops.kernels import build
    chosen = [v for v in VARIANTS if not libs or v[0] in libs]
    with ThreadPoolExecutor(len(chosen)) as pool:
        built = list(pool.map(lambda v: build_variant(*v), chosen))
    timers = list(dict.fromkeys(VARIANT_TIMES[v[0]] for v in chosen))

    def times():
        return {k: v for timer in timers for k, v in timer(c).items()}

    own = dict(build._LIBS)
    rows = [{"variant": label, "times": times()}]
    for (lib, name, _), done in zip(chosen, built):
        if done is None:
            continue
        build._LIBS[lib] = ctypes.CDLL(done[0])
        rows.append({"variant": name, "library": lib, "ptxas": done[1],
                     "times": VARIANT_TIMES[lib](c)})
        build._LIBS[lib] = own[lib]
    rows.append({"variant": label, "times": times()})
    print(json.dumps({"phase": "kernel_ab_variants", "label": label, "nvidia_smi": smi,
                      "sha256": digests(c), "rows": rows}), flush=True)


def eager_engine(c, label, smi):
    """``--eager-engine``'s line (module note), then DIR's serve_cb_tp."""
    import numpy as np
    import torch
    from mustafar_tpu_torch.config import (CacheMode, EngineConfig, LLAMA3_8B,
                                           PruneConfig, PruneMethod)
    from mustafar_tpu_torch.models.quant import init_params_w8
    from mustafar_tpu_torch.runtime.generate import Generator
    from mustafar_tpu_torch.runtime.scheduler import ContinuousBatchingEngine
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    model, params = c.cut_depth(LLAMA3_8B, init_params_w8(LLAMA3_8B, g, device="cuda"))
    eng = EngineConfig(model=model, cache_mode=CacheMode.COMPRESSED,
                       prune=PruneConfig(method=PruneMethod.KT_MAG_VT_MAG, k_sparsity=0.7,
                                         v_sparsity=0.7),
                       max_seq_len=8448, prefill_bucket=256, chunk_size=256, codec="q8q4",
                       batch_size=8, chunked_prefill=True)
    reqs = c.serve_cb_requests(model)
    warm = ContinuousBatchingEngine(eng, params, graph=False)
    for p, _ in reqs[:2]:
        warm.submit(p[:300], 4)
    warm.run()
    del warm
    split = {"segment+decode": [], "decode": [], "segment": []}
    cb = ContinuousBatchingEngine(eng, params, graph=False)
    uids = [cb.submit(p, m) for p, m in reqs]
    t = time.perf_counter()
    with torch.inference_mode():
        while cb.busy():
            seg0, dec0, t0 = cb.segments, cb.decode_steps, time.perf_counter()
            cb.tick()
            kind = ("segment+" if cb.segments > seg0 else "") + \
                ("decode" if cb.decode_steps > dec0 else "")
            split[kind.rstrip("+")].append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    outs = [np.asarray(cb.finished[u].out, np.int64) for u in uids]
    tokens = hashlib.sha256(b"".join(o.tobytes() for o in outs)).hexdigest()
    del cb
    gen = Generator(dataclasses.replace(eng, batch_size=1), params, graph=False)
    prompt = np.random.RandomState(5).randint(1, model.vocab_size, (1, 1280))
    gen.generate(prompt, 1)
    enqueue, wall = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen.generate(prompt, 1)
        enqueue.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    del gen, params
    torch.cuda.empty_cache()
    print(json.dumps({
        "phase": "kernel_ab_eager_engine", "label": label, "nvidia_smi": smi,
        "model": f"{model.name} x{model.num_layers}L, W8 (random, seed 0), q8q4",
        "serve_cb_eager": {"seconds": seconds, "tokens_sha256": tokens,
                           "tick_ms": {k: {"n": len(v), "mean": 1e3 * sum(v) / max(len(v), 1)}
                                       for k, v in split.items()}},
        "generator_eager_prefill_1280": {"segments": 5, "enqueue_ms": 1e3 * min(enqueue),
                                         "wall_ms": 1e3 * min(wall)}}), flush=True)
    c.phase_serve_cb_tp(model)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--engine", action="store_true")
    ap.add_argument("--host-only", action="store_true")
    ap.add_argument("--eager-engine", action="store_true")
    ap.add_argument("--archive", action="store_true")
    ap.add_argument("--variants", nargs="*", metavar="LIB",
                    help="build and time the VARIANTS (of these libraries only, if named)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    # from DIR, so that what the phases spawn (``python -c``, which puts the
    # working directory first on its path) imports DIR's package too
    os.chdir(root)
    import chip_smoke as c
    t0 = time.perf_counter()
    smi = c.phase_env()
    c.phase_build()
    if args.variants is not None:
        run_variants(c, args.label, smi, args.variants)
        return
    if args.eager_engine:
        eager_engine(c, args.label, smi)
        return
    if args.archive:
        times, sha = archive_ms(c)
        print(json.dumps({"phase": "kernel_ab_archive", "label": args.label,
                          "root": args.root, "nvidia_smi": smi, "archive_ms": times,
                          "v4_v6_sha256": sha, "sha256": digests(c),
                          "seconds": time.perf_counter() - t0}), flush=True)
        return
    if args.host_only:
        print(json.dumps({"phase": "kernel_ab", "label": args.label, "root": args.root,
                          "nvidia_smi": smi, "wrapper_host_us": wrapper_host_us(c, 15, 40),
                          "wrapper_host_us_400": wrapper_host_us(c, 9, 400)}), flush=True)
        return
    for codec in ("q8q4", "bitmap", "bitmap-q8", "q8", "q4q4"):
        c.phase_kernel(codec)
        c.phase_kernel_ps(codec)
        c.phase_kernel_seg(codec)
    c.phase_kernel_pack()
    c.phase_kernel_w4()
    c.phase_kernel_dense()
    c.phase_kernel_archive()
    line = {"phase": "kernel_ab", "label": args.label, "root": args.root,
            "nvidia_smi": smi, "sha256": digests(c), "k1_k6_ms": k1_k6_ms(c),
            "k3_k5_ms": k3_k5_ms(c), "k9_ms": k9_ms(c),
            "wrapper_host_us": wrapper_host_us(c)}
    if args.engine:
        import torch
        from mustafar_tpu_torch.config import LLAMA3_8B
        from mustafar_tpu_torch.models.quant import init_params_w8
        spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                      os.path.join(HERE, "chip_smoke.py"))
        here = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(here)
        g = torch.Generator(device="cuda")
        g.manual_seed(0)
        params = init_params_w8(LLAMA3_8B, g, device="cuda")
        here.phase_serve_cb(params, "q8q4")
        here.phase_host_split(params)
    line["seconds"] = time.perf_counter() - t0
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
