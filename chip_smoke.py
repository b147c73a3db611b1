"""Chip smoke run of the PyTorch / H100 port (``mustafar_tpu_torch``).

    python3 chip_smoke.py            # from the root of a checkout, one CUDA card

Phases, each printing one flushed JSON line with its ``phase`` and
``elapsed_s``:
  env          torch / CUDA versions, the card's name and power limit
  build        nvcc builds the q8q4 decode kernel (csrc/q_decode.cu)
  kernel       the kernel against its plain PyTorch version on the card, at
               the flagship per-layer shapes (B=8, Hq=32, Hkv=8, mc=5), with
               its time beside the plain version's and its bound
  reference    a tiny f32 model decoded on the card (kernel) and on the CPU
               (plain path) with the same token stream: logits must agree
  serve_q8q4   full-width, 32-layer Llama-3-8B with random W8 weights made
               on the card: Generator.generate, B=8, prompt 300, 300 new
               tokens, q8q4 compressed cache (one compaction on the way);
               every decode step must launch the kernel once per layer
  serve_dense  the same prompts through the dense baseline cache
  decode_split device time of a decode step's W8 projections, LM head and
               attention kernel, each timed alone, beside the step's wall time
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
H100_F32_FLOPS = 67e12     # f32 outside the tensor cores (the kernel's math)
KERNEL_TOL_ULPS = 2        # bf16 ulps of the output's scale


def emit(phase, **fields):
    print(json.dumps({"phase": phase, "elapsed_s": round(time.perf_counter() - T0, 3),
                      **fields}), flush=True)


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, flush=None):
    """Mean device ms of ``fn`` over ``reps`` launches, CUDA events around
    each launch; ``flush`` runs between launches, outside the timing."""
    import torch
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


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


def phase_build():
    from mustafar_tpu_torch.ops.kernels import build
    from mustafar_tpu_torch.ops.kernels import quant_attention as qa
    t = time.perf_counter()
    qa._library()
    log = build.BUILD_LOGS.get("q_decode", "")
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit("build", seconds=round(time.perf_counter() - t, 3),
         library=str(build.library_path("q_decode").relative_to(ROOT)),
         built_now="q_decode" in build.BUILD_LOGS, ptxas=ptxas)


def phase_kernel():
    """Kernel vs plain at the flagship per-layer shapes; returns the
    kernels-line entry (launches filled in by the serve phase)."""
    import torch
    from mustafar_tpu_torch.ops import quant_format as qf
    from mustafar_tpu_torch.ops.kernels import quant_attention as qa
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    B, Hq, Hkv, L, mc, W, D = 8, 32, 8, 4, 5, 288, 128
    BH = B * Hkv
    codec = qf.QuantCodec(256, 128, 8, 4)
    pool = torch.randint(-32768, 32768, (L, mc, BH, 192, D), generator=g,
                         device=dev, dtype=torch.int32).to(torch.int16)
    scales = (0.002 + 0.018 * torch.rand((L, mc, BH, 2, D), generator=g,
                                         device=dev)).to(torch.bfloat16)
    k_win = torch.randn((L, BH, W, D), generator=g, device=dev).to(torch.bfloat16)
    v_win = torch.randn((L, BH, W, D), generator=g, device=dev).to(torch.bfloat16)
    q = torch.randn((B, 1, Hq, D), generator=g, device=dev).to(torch.bfloat16)
    cases = [(0, 1, 0), (0, 44, L - 1), (0, 288, 0), (mc, 288, L - 1), (mc, 1, 0),
             (1, 44, 0), (1, 288, L - 1), (2, 88, 0)]
    # the other query-group sizes the kernel is built for (Llama-3-8B has 4)
    other_groups = [torch.randn((B, 1, Hkv * g_, D), generator=g, device=dev
                                ).to(torch.bfloat16) for g_ in (1, 2, 8)]
    launches0 = qa.fused_q_decode_attention.launches
    results, worst = [], 0.0
    for nc, wl, li in cases:
        qs = (q, q.float(), *other_groups) if (nc, wl) == (1, 288) else (q,)
        for qq in qs:
            args = (qq, pool, scales, k_win, v_win, nc, wl, li)
            got = qa.fused_q_decode_attention(*args, codec)
            torch.cuda.synchronize()
            want = qa.fused_q_decode_attention_plain(*args)
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            # same arithmetic, sums in another order: a bf16(p) or the bf16
            # output may move by one ulp each
            tol = KERNEL_TOL_ULPS * 2.0 ** -8 * scale
            results.append({"n_chunks": nc, "win_len": wl, "li": li,
                            "q_dtype": str(qq.dtype).split(".")[-1],
                            "G": qq.shape[2] // Hkv,
                            "max_abs_err": err, "tol": tol})
            if not (got.isfinite().all() and err <= tol):
                raise AssertionError(f"kernel disagrees with its plain version: "
                                     f"{results[-1]}")
            worst = max(worst, err / max(tol, 1e-30))

    # time at the main path's largest pre-compaction shape: one pool chunk
    # and a full 288-token window, L2 flushed before each launch
    nc, wl, li = 1, 288, 0
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    args = (q, pool, scales, k_win, v_win, nc, wl, li)
    for _ in range(10):
        qa.fused_q_decode_attention(*args, codec)
        qa.fused_q_decode_attention_plain(*args)
    torch.cuda.synchronize()
    kernel_ms = cuda_ms(lambda: qa.fused_q_decode_attention(*args, codec), 100,
                        flush=flush_buf.zero_)
    plain_ms = cuda_ms(lambda: qa.fused_q_decode_attention_plain(*args), 20,
                       flush=flush_buf.zero_)
    hot_ms = cuda_ms(lambda: qa.fused_q_decode_attention(*args, codec), 100)
    full_args = (q, pool, scales, k_win, v_win, mc, 288, li)
    full_ms = cuda_ms(lambda: qa.fused_q_decode_attention(*full_args, codec), 100,
                      flush=flush_buf.zero_)
    G = Hq // Hkv
    nbytes = (BH * (nc * 192 * 128 * 2 + 2 * wl * 128 * 2)   # pool rows, windows
              + BH * nc * 2 * 128 * 2                        # scales
              + 2 * B * Hq * D * 2)                          # q in, out
    flops = BH * G * (nc * 256 + wl) * 128 * 2 * 2          # scores + p.v
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    flops_ms = flops / H100_F32_FLOPS * 1e3
    qa.fused_q_decode_attention.launches = launches0      # comparisons do not count
    emit("kernel", shapes={"B": B, "Hq": Hq, "Hkv": Hkv, "L": L, "mc": mc, "W": W},
         cases=results, kernel_ms=kernel_ms, kernel_ms_l2_hot=hot_ms,
         kernel_ms_full_pool=full_ms, plain_ms=plain_ms,
         timed_at={"n_chunks": nc, "win_len": wl}, bytes=nbytes, flops=flops,
         bound_ms=max(bytes_ms, flops_ms), library_ms=None)
    return {"name": "fused_q_decode_attention", "route": "cuda",
            "source": "mustafar_tpu_torch/csrc/q_decode.cu",
            "replaces": "mustafar_tpu/ops/kernels/quant_attention.py:223",
            "launches": None, "max_abs_err": max(r["max_abs_err"] for r in results),
            "max_err": max(r["max_abs_err"] for r in results),
            "tol": max(r["tol"] for r in results), "worst_err_over_tol": worst,
            "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "library_ms": None}


def _tiny_engine(mode):
    import dataclasses
    from mustafar_tpu_torch import config as tc
    model = dataclasses.replace(tc.TINY_LLAMA, head_dim=128, num_heads=4,
                                num_kv_heads=1, hidden_size=256)
    return tc.EngineConfig(
        model=model, cache_mode=mode,
        prune=tc.PruneConfig(method=tc.PruneMethod.KT_MAG_VT_MAG,
                             k_sparsity=0.7, v_sparsity=0.7),
        max_seq_len=1024, prefill_bucket=256, chunk_size=256, codec="q8q4")


def phase_reference():
    """A tiny f32 model, same weights and token stream on the card and on
    the CPU: the card runs the kernel, the CPU the plain path."""
    import numpy as np
    import torch
    from mustafar_tpu_torch.cache import make_cache
    from mustafar_tpu_torch.config import CacheMode
    from mustafar_tpu_torch.models import llama
    from mustafar_tpu_torch.ops.kernels import quant_attention as qa
    eng = _tiny_engine(CacheMode.COMPRESSED)
    cpu_params = llama.init_params(eng.model, device="cpu", dtype=torch.float32, seed=1)
    gpu_params = {k: ({kk: vv.cuda() for kk, vv in v.items()} if isinstance(v, dict)
                      else v.cuda()) for k, v in cpu_params.items()}
    prompt = np.random.RandomState(1).randint(0, 512, (2, 300))
    toks = torch.zeros((2, 512), dtype=torch.int64)
    toks[:, :300] = torch.from_numpy(prompt)
    launches0 = qa.fused_q_decode_attention.launches
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
    qa.fused_q_decode_attention.launches = launches0
    a, b = logs["cpu"], logs["cuda"]
    err = (a - b).abs().max().item()
    scale = a.abs().max().item()
    # the kernel reads q and the window as bf16 and rounds p to bf16: last-bit
    # differences of f32 activations on the two devices can flip one of those
    # roundings (the CPU parity tests measure < 3e-3 of the logits' range)
    tol = 1e-2 * scale
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    emit("reference", steps=40, max_abs_err=err, tol=tol, greedy_agreement=agree)
    if not (b.isfinite().all() and err <= tol):
        raise AssertionError("card and CPU logits disagree on the tiny model")


def serve(label, mode, params, prompt, new_tokens):
    """One warm-up generation, then the measured one; returns its tokens and
    the launches of the kernel during the measured run."""
    import numpy as np
    import torch
    from mustafar_tpu_torch.config import EngineConfig, LLAMA3_8B, PruneConfig, PruneMethod
    from mustafar_tpu_torch.ops.kernels import quant_attention as qa
    from mustafar_tpu_torch.runtime.generate import Generator
    eng = EngineConfig(model=LLAMA3_8B, cache_mode=mode,
                       prune=PruneConfig(method=PruneMethod.KT_MAG_VT_MAG,
                                         k_sparsity=0.7, v_sparsity=0.7),
                       max_seq_len=1312, prefill_bucket=256, chunk_size=256,
                       codec="q8q4")
    gen = Generator(eng, params, dtype=torch.bfloat16)
    gen.generate(prompt, 4)                                   # warm-up
    gen.last_cache = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    qa.fused_q_decode_attention.launches = 0
    t = time.perf_counter()
    out = gen.generate(prompt, new_tokens)
    dt = time.perf_counter() - t
    launches = qa.fused_q_decode_attention.launches
    toks = torch.as_tensor(np.stack(out))
    B = toks.shape[0]
    if toks.shape != (B, new_tokens) or toks.min() < 0 or toks.max() >= LLAMA3_8B.vocab_size:
        raise AssertionError(f"{label}: bad tokens {tuple(toks.shape)}")
    fields = {"batch": B, "prompt": prompt.shape[1], "new_tokens": new_tokens,
              "seconds": dt, "tok_s": B * new_tokens / dt,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "kernel_launches": launches}
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
        w8_layer_ms = cuda_ms(all_layers, 3) / cfg.num_layers
        head_ms = cuda_ms(lambda: _lm_head(cfg, params, h), 5)
    parts_ms = cfg.num_layers * (w8_layer_ms + kernel_ms) + head_ms
    emit("decode_split", w8_layer_ms=w8_layer_ms, lm_head_ms=head_ms,
         attn_kernel_ms=kernel_ms, w8_head_attention_ms_per_step=parts_ms,
         q8q4_wall_ms_per_token=q8q4_s / new_tokens * 1e3,
         dense_wall_ms_per_token=dense_s / new_tokens * 1e3)


def main():
    faulthandler.dump_traceback_later(BUDGET_S, exit=True)
    smi = phase_env()
    phase_build()
    entry = phase_kernel()
    phase_reference()

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
    sparse_toks, launches, fields = serve("serve_q8q4", CacheMode.COMPRESSED,
                                          params, prompt, new)
    q8q4_s = fields["seconds"]
    decode_steps = new - 1
    expected = LLAMA3_8B.num_layers * decode_steps
    emit("serve_q8q4", model="llama-3-8b x32L, W8 (random, seed 0)",
         weights_gib=weight_bytes(params) / 2 ** 30, weights_init_s=init_s,
         decode_steps=decode_steps, expected_launches=expected, **fields)
    if launches != expected:
        raise AssertionError(f"kernel launched {launches} times, expected "
                             f"{expected} = 32 layers x {decode_steps} steps")
    dense_toks, dense_launches, fields = serve("serve_dense", CacheMode.DENSE,
                                               params, prompt, new)
    if dense_launches != 0:
        raise AssertionError("the dense engine launched the q8q4 kernel")
    # the first token comes from prefill logits, the same in both engines
    first_equal = bool((sparse_toks[:, 0] == dense_toks[:, 0]).all())
    emit("serve_dense", first_token_equal=first_equal,
         token_agreement_with_q8q4=(sparse_toks == dense_toks).float().mean().item(),
         **fields)
    if not first_equal:
        raise AssertionError("sparse and dense engines disagree on the first token")
    phase_decode_split(params, entry["kernel_ms"], q8q4_s, fields["seconds"], new)

    entry["launches"] = launches
    print(smi, flush=True)
    print(json.dumps({"kernels": [entry]}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
