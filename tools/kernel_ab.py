"""Before / after of the port's kernels on one card: run it once for each
checkout in one call (parent, change, change, parent) and compare the lines.

    python3 tools/kernel_ab.py --root DIR --label NAME [--engine | --host-only]

``DIR`` is the root of a checkout of this repository (its ``chip_smoke.py``
and ``mustafar_tpu_torch/``; an unpacked ``git archive`` of another commit
will do).  From that checkout it builds the kernels and runs the kernel
phases of its ``chip_smoke.py`` (every codec's decode, per-slot and segment
kernels, the pack, W4, dense and archive kernels; each prints its JSON
line), then prints a ``kernel_ab`` line: the SHA-256 of the uniform bitmap
decode kernel's outputs (kernel 6, bitmap and bitmap-q8, G=4, bf16 and f32
q, five (n_chunks, win_len) cases), so that two checkouts' outputs can be
compared bit for bit, and the host time of the kernel 4, 6 and 7 wrappers
(``wrapper_host_us``: the least and the median of means over many calls,
steadier than the kernel phases' single mean).  With ``--engine`` it
then makes the random W8 Llama-3-8B weights (seed 0) and runs the
``serve_cb_bitmap`` and ``host_split`` phases of the ``chip_smoke.py`` next
to this script on DIR's package, so both checkouts take the same engine
measurements.  With ``--host-only`` it builds and prints only the wrappers'
host time, over batches of 40 calls (the launch queue never fills) and of
400 (alternate the two checkouts' processes a few times: the host's speed
drifts from process to process).  Needs one CUDA card.
"""

import argparse
import hashlib
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernel6_digest(c):
    import torch
    dev = torch.device("cuda")
    out = {}
    for codec in ("bitmap", "bitmap-q8"):
        g = torch.Generator(device=dev)
        g.manual_seed(11)
        kit = c._Kit(codec, g, dev, 2, 5, 64, 288)
        q = torch.randn((8, 1, 32, 128), generator=g, device=dev).to(torch.bfloat16)
        h = hashlib.sha256()
        for qq in (q, q.float()):
            for nc, wl, li in ((0, 44, 0), (1, 288, 1), (2, 1, 0), (5, 288, 1), (5, 0, 0)):
                got = kit.decode(qq, nc, wl, li)
                bits = got.view(torch.int16 if got.dtype == torch.bfloat16 else torch.int32)
                h.update(bits.cpu().numpy().tobytes())
        out[codec] = h.hexdigest()
    return out


def wrapper_host_us(c, reps=7, calls=200):
    """Host microseconds a wrapper call takes to return: the least and the
    median of ``reps`` means over ``calls`` back-to-back calls, the card
    synchronised between (a shared host only adds time, so the least is the
    steadier), for kernel 4 (B=8, S=1,312, pos 599 and per slot at S=8,448),
    kernel 7 (bitmap, chip_smoke's mixed slots at mc=32), kernel 6 (bitmap,
    1 chunk + 288 window) and, for scale, one ``torch.empty`` of kernel 7's
    split scratch (4.7 MB) and one small ``torch.add`` (one launch)."""
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
    out["torch_empty_k7_scratch"] = timed(
        lambda: torch.empty(B * Hkv * 35 * 4 * 130, dtype=torch.float32, device=dev))
    x = torch.zeros(1024, device=dev)
    out["torch_add"] = timed(lambda: torch.add(x, 1.0, out=x))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--engine", action="store_true")
    ap.add_argument("--host-only", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as c
    t0 = time.perf_counter()
    smi = c.phase_env()
    c.phase_build()
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
            "nvidia_smi": smi, "kernel6_sha256": kernel6_digest(c),
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
        here.phase_serve_cb(params, "bitmap")
        here.phase_host_split(params)
    line["seconds"] = time.perf_counter() - t0
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
