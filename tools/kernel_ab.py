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
bf16 and f32 q, five (n_chunks, win_len) cases each) and of the segment
kernel 8's acc, m and l (bitmap, bitmap-q8; ``phase_kernel_seg``'s cases),
so that two checkouts' outputs can be compared bit for bit, and the host
time of the kernel 2, 4, 6 and 7 wrappers (``wrapper_host_us``: the least
and the median of means over many calls, steadier than the kernel phases'
single mean).  With ``--engine`` it then makes the random W8 Llama-3-8B
weights (seed 0) and runs the ``serve_cb`` (q8q4) and ``host_split``
phases of the ``chip_smoke.py`` next to this script on DIR's package, so
both checkouts take the same engine measurements.  With ``--host-only`` it
builds and prints only the wrappers' host time, over batches of 40 calls
(the launch queue never fills) and of 400 (alternate the two checkouts'
processes a few times: the host's speed drifts from process to process).
With ``--variants`` it builds each of ``VARIANTS`` (a kernel's source with
a few substitutions) beside DIR's own build, prints their ptxas reports
and times kernels 2 and 8 at ``chip_smoke.py``'s shapes with DIR's build
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
    """Output digests of kernels 1 and 6 (uniform decode, each codec) and 8
    (segment partials acc, m, l, the bitmap codecs), from DIR's kernels on
    inputs made from fixed seeds."""
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
    return out


def wrapper_host_us(c, reps=7, calls=200):
    """Host microseconds a wrapper call takes to return: the least and the
    median of ``reps`` means over ``calls`` back-to-back calls, the card
    synchronised between (a shared host only adds time, so the least is the
    steadier), for kernel 4 (B=8, S=1,312, pos 599 and per slot at S=8,448),
    kernels 2 (q8q4) and 7 (bitmap) at chip_smoke's mixed slots at mc=32,
    kernel 6 (bitmap, 1 chunk + 288 window) and, for scale, one
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
    out["torch_empty_k7_scratch"] = timed(
        lambda: torch.empty(B * Hkv * 35 * 4 * 130, dtype=torch.float32, device=dev))
    x = torch.zeros(1024, device=dev)
    out["torch_add"] = timed(lambda: torch.add(x, 1.0, out=x))
    return out


# Variants for ``--variants``: (library, label, {file of csrc/: [(old, new),
# ...]}), each built from a copy of DIR's csrc/ with the substitutions (a
# variant whose text DIR lacks is skipped).  "Timed only": its outputs are
# wrong by design.
_K8_SCALAR_SCORES = (
    """      uint32_t b[4];
      ldmatrix_x4<false>(b, &sm.k[tok0 + 8 * nt + 8 * (lane >> 4) + (lane & 7)]
                                 [16 * kk + 8 * ((lane >> 3) & 1)]);
      mma_bf16(s[nt], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], b[0], b[1]);
      mma_bf16(s[nt + 1], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], b[2], b[3]);""",
    """      const int gid = lane >> 2, k0 = 16 * kk + 2 * (lane & 3);
      for (int u = 0; u < 2; ++u) {
        const __nv_bfloat16* kr = &sm.k[tok0 + 8 * (nt + u) + gid][0];
        mma_bf16(s[nt + u], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], ld32(kr + k0),
                 ld32(kr + k0 + 8));
      }""")
_K8_SCALAR_V16 = (
    """            ldmatrix_x4<true>(b, &sm.v[tok0 + 16 * j + (lane & 15)][8 * (nt + (lane >> 4))]);""",
    """            for (int u = 0; u < 2; ++u) {
              const int tk = tok0 + 16 * j + 2 * tig, d = 8 * (nt + u) + gid;
              b[2 * u] = (uint32_t)__bfloat16_as_ushort(sm.v[tk][d]) |
                         ((uint32_t)__bfloat16_as_ushort(sm.v[tk + 1][d]) << 16);
              b[2 * u + 1] = (uint32_t)__bfloat16_as_ushort(sm.v[tk + 8][d]) |
                             ((uint32_t)__bfloat16_as_ushort(sm.v[tk + 9][d]) << 16);
            }""")
_K8_SCALAR_V8 = (
    """            ldmatrix_x4<true>(b, &sm.v[tok0 + 16 * j + lane][8 * nt]);""",
    """            for (int u = 0; u < 2; ++u) {
              const int tk = tok0 + 16 * (j + u) + 2 * tig, d = 8 * nt + gid;
              b[2 * u] = (uint32_t)__bfloat16_as_ushort(sm.v[tk][d]) |
                         ((uint32_t)__bfloat16_as_ushort(sm.v[tk + 1][d]) << 16);
              b[2 * u + 1] = (uint32_t)__bfloat16_as_ushort(sm.v[tk + 8][d]) |
                             ((uint32_t)__bfloat16_as_ushort(sm.v[tk + 9][d]) << 16);
            }""")
VARIANTS = (
    # kernel 2's split instance built for three, and for two, blocks an SM
    ("q_decode_ps", "k2_3_blocks", {"quant_decode.cuh": [
        ("return G <= 4 ? 4 : 2;", "return G <= 4 ? 3 : 2;")]}),
    ("q_decode_ps", "k2_2_blocks", {"quant_decode.cuh": [
        ("return G <= 4 ? 4 : 2;", "return G <= 4 ? 2 : 1;")]}),
    # kernel 8's chunks split over two sets of clusters (grid z = 2), without
    # the merge: both halves write the same outputs (timed only)
    ("sp_segment", "k8_two_sets", {"sp_segment.cu": [
        ("if (n_chunks > 0) bitmap::stage_rows_async(stage, chunk(0), rows, tid, THREADS);",
         "const int cb = n_chunks * (int)blockIdx.z / (int)gridDim.z;\n"
         "  const int ce = n_chunks * ((int)blockIdx.z + 1) / (int)gridDim.z;\n"
         "  if (cb < ce) bitmap::stage_rows_async(stage, chunk(cb), rows, tid, THREADS);"),
        ("for (int ci = 0; ci < n_chunks; ++ci) {", "for (int ci = cb; ci < ce; ++ci) {"),
        ("if (ci + 1 < n_chunks)", "if (ci + 1 < ce)"),
        ("cfg.gridDim = dim3(tiles, BH);", "cfg.gridDim = dim3(tiles, BH, 2);")]}),
    # kernel 8 with its mma fragments loaded element by element from shared
    # memory, not by ldmatrix (the same values: outputs unchanged)
    ("sp_segment", "k8_scalar_loads", {"sp_segment.cu": [
        _K8_SCALAR_SCORES, _K8_SCALAR_V16, _K8_SCALAR_V8]}),
    # kernel 8's parts: without the mma passes, and without the copies to the
    # peers' tiles (timed only)
    ("sp_segment", "k8_no_passes", {"sp_segment.cu": [
        ("    if (!computes) continue;", "    continue;")]}),
    ("sp_segment", "k8_no_push", {"sp_segment.cu": [
        ("    if (csize == 1) continue;", "    continue;")]}),
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


def variant_times(c):
    """Device ms (L2 flushed) of kernel 2 (G=4; q8q4, q8, q4q4; the mixed
    and the light slots of ``phase_kernel_ps``, with the split gate at the
    mixed ones) and of kernel 8 (B=1, T=256, G=4, 31 chunks; bitmap and
    bitmap-q8) with the libraries loaded now."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    mixed = [(0, 0), (0, 1), (1, 44), (2, 288), (5, 288), (5, 1), (1, 0), (31, 288)]
    light = mixed[:-1] + [(2, 44)]
    counts = {name: tuple(torch.tensor([x[i] for x in sl], dtype=torch.int32, device=dev)
                          for i in (0, 1)) for name, sl in (("mixed", mixed), ("light", light))}
    out = {}
    for codec in ("q8q4", "q8", "q4q4"):
        kit = c._Kit(codec, g, dev, 4, 32, 64, 288)
        q = torch.randn((8, 1, 32, 128), generator=g, device=dev).to(torch.bfloat16)
        nc, wl = counts["mixed"]
        gate = (c.split_gate(kit.decode_ps(q, nc, wl, 0),
                             kit.decode_ps_split_plain(q.float(), nc, wl, 0),
                             (nc > 0) | (wl > 0))
                if hasattr(kit, "decode_ps_split_plain") else None)
        for name, (nc, wl) in counts.items():
            for _ in range(5):
                kit.decode_ps(q, nc, wl, 0)
            out[f"k2_{codec}_{name}"] = c.cuda_ms(lambda: kit.decode_ps(q, nc, wl, 0), 100,
                                                  flush=flush.zero_)[0]
        out[f"k2_{codec}_split_gate"] = gate
    for codec in ("bitmap", "bitmap-q8"):
        kit = c._Kit(codec, g, dev, 2, 32, 8, 8)
        q = torch.randn((1, 256, 32, 128), generator=g, device=dev).to(torch.bfloat16)
        for _ in range(3):
            kit.segment(q, 31, 0)
        out[f"k8_{codec}"] = c.cuda_ms(lambda: kit.segment(q, 31, 0), 20)[0]
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
    rows = [{"variant": label, "times": variant_times(c)}]
    for (lib, name, _), done in zip(VARIANTS, built):
        if done is None:
            continue
        build._LIBS[lib] = ctypes.CDLL(done[0])
        rows.append({"variant": name, "library": lib, "ptxas": done[1],
                     "times": variant_times(c)})
        build._LIBS[lib] = own[lib]
    rows.append({"variant": label, "times": variant_times(c)})
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
            "nvidia_smi": smi, "sha256": digests(c),
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
