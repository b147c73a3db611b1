"""Before / after of the port's kernels on one card: run it once for each
checkout in one call (parent, change, change, parent) and compare the lines.

    python3 tools/kernel_ab.py --root DIR --label NAME \
        [--engine | --host-only | --variants]

``DIR`` is the root of a checkout of this repository (its ``chip_smoke.py``
and ``mustafar_tpu_torch/``; an unpacked ``git archive`` of another commit
will do).  From that checkout it builds the kernels and runs the kernel
phases of its ``chip_smoke.py`` (every codec's decode, per-slot and segment
kernels, the pack, W4, dense and archive kernels; each prints its JSON
line), then prints a ``kernel_ab`` line: the SHA-256 of the outputs of the
uniform decode kernels 1 (q8q4, q8, q4q4) and 6 (bitmap, bitmap-q8; G=4,
bf16 and f32 q, five (n_chunks, win_len) cases each), of the segment
kernels 3 (q8q4, q8, q4q4) and 8 (bitmap, bitmap-q8): acc, m and l at
``phase_kernel_seg``'s cases, and of the W4 kernel 5 at every
``W4_SHAPES`` shape at T = 8 and 32, so that two checkouts' outputs can be
compared bit for bit; the device time of kernels 3 (at 1, 4, 16 and 31
chunks) and 5 (``k3_k5_ms``); and the host time of the kernel 2, 4, 5, 6
and 7 wrappers (``wrapper_host_us``: the least and the median of means
over many calls, steadier than the kernel phases' single mean).  With
``--engine`` it then makes the random W8 Llama-3-8B
weights (seed 0) and runs the ``serve_cb`` (q8q4) and ``host_split``
phases of the ``chip_smoke.py`` next to this script on DIR's package, so
both checkouts take the same engine measurements.  With ``--host-only`` it
builds and prints only the wrappers' host time, over batches of 40 calls
(the launch queue never fills) and of 400 (alternate the two checkouts'
processes a few times: the host's speed drifts from process to process).
With ``--variants`` it builds each of ``VARIANTS`` (a kernel's source with
a few substitutions) beside DIR's own build, prints their ptxas reports
and times kernels 3 and 5 at ``chip_smoke.py``'s shapes with DIR's build
and each variant in turn, beside the digests of DIR's kernels.  Needs one
CUDA card.
"""

import argparse
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


def digests(c):
    """Output digests of kernels 1 and 6 (uniform decode, each codec), 3 and
    8 (segment partials acc, m, l, each codec) and 5 (W4, every projection
    shape at T = 8 and 32), from DIR's kernels on inputs made from fixed
    seeds."""
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
    return out


def wrapper_host_us(c, reps=7, calls=200):
    """Host microseconds a wrapper call takes to return: the least and the
    median of ``reps`` means over ``calls`` back-to-back calls, the card
    synchronised between (a shared host only adds time, so the least is the
    steadier), for kernel 4 (B=8, S=1,312, pos 599 and per slot at S=8,448),
    kernels 2 (q8q4) and 7 (bitmap) at chip_smoke's mixed slots at mc=32,
    kernel 6 (bitmap, 1 chunk + 288 window), kernel 5 (W4) at
    4096 x 14336 and 4096 x 1024, T=8 and, for scale, one
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
    from mustafar_tpu_torch.ops.kernels import w4_matmul as w4
    for label, (din, dout) in (("k5_w_gate_up_T8", (4096, 14336)),
                               ("k5_wk_wv_T8", (4096, 1024))):
        cw = torch.zeros((din // 4, dout), dtype=torch.int16, device=dev)
        sw = torch.ones((din // 128, dout), dtype=torch.bfloat16, device=dev)
        xw = torch.randn((8, din), generator=g, device=dev).to(torch.bfloat16)
        out[label] = timed(lambda: w4.w4_matmul(xw, cw, sw))
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


def run_variants(c, label, smi):
    """The ``--variants`` mode: builds, then DIR's build, each variant of
    its library, and DIR's build again, timed in turn; with the digests of
    DIR's kernels (``digests``)."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor
    from mustafar_tpu_torch.ops.kernels import build
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(lambda v: build_variant(*v), VARIANTS))
    own = dict(build._LIBS)
    rows = [{"variant": label, "times": k3_k5_ms(c)}]
    for (lib, name, _), done in zip(VARIANTS, built):
        if done is None:
            continue
        build._LIBS[lib] = ctypes.CDLL(done[0])
        rows.append({"variant": name, "library": lib, "ptxas": done[1],
                     "times": k3_k5_ms(c)})
        build._LIBS[lib] = own[lib]
    rows.append({"variant": label, "times": k3_k5_ms(c)})
    print(json.dumps({"phase": "kernel_ab_variants", "label": label, "nvidia_smi": smi,
                      "sha256": digests(c), "rows": rows}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--engine", action="store_true")
    ap.add_argument("--host-only", action="store_true")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as c
    t0 = time.perf_counter()
    smi = c.phase_env()
    c.phase_build()
    if args.variants:
        run_variants(c, args.label, smi)
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
            "nvidia_smi": smi, "sha256": digests(c), "k3_k5_ms": k3_k5_ms(c),
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
