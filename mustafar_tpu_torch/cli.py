"""Command-line interface of the port: ``python -m mustafar_tpu_torch``.

The subcommands, with the JAX package's flags and defaults
(``mustafar_tpu/cli.py``) but for the output directories, ``pred_torch/``
and ``accuracy_torch/``, which leave the JAX package's recorded ``pred/``
and ``accuracy/`` as they are:

  python -m mustafar_tpu_torch predict --model <hf_dir> --mode kt_mag_vt_mag \\
      --k_sparsity 0.7 --v_sparsity 0.7 --datasets qasper --data_dir <rows>
  python -m mustafar_tpu_torch eval --pred_dir pred_torch/<run>
  python -m mustafar_tpu_torch synth-ckpt --out <dir> [--small] [--rows N]
  python -m mustafar_tpu_torch accuracy --ckpt ckpt/tiny-acc --out <dir>
  python -m mustafar_tpu_torch train-tiny --out ckpt_torch/tiny-acc --steps 3000

Every subcommand that runs a model runs it on ``cuda`` and raises without a
card; ``MUSTAFAR_CPU=1`` selects the CPU (the plain versions of the
kernels).  ``train-tiny`` writes ``ckpt_torch/tiny-acc`` by default, not the
JAX package's recorded ``ckpt/tiny-acc``.  ``bench`` is not ported yet: it
waits for the port's bench entry point.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _device() -> str:
    """``cpu`` under ``MUSTAFAR_CPU=1``, else ``cuda`` (checked by each
    entry point, which raises without a card)."""
    return "cpu" if os.environ.get("MUSTAFAR_CPU") else "cuda"


def _add_engine_args(p: argparse.ArgumentParser):
    p.add_argument("--mode", default="kt_mag_vt_mag",
                   help="pruning variant (PruneMethod value) or 'dense'")
    p.add_argument("--cache", default=None,
                   choices=[None, "dense", "masked", "compressed"],
                   help="cache mode (default: compressed for kt_*_vt_* mag, else masked)")
    p.add_argument("--k_sparsity", type=float, default=0.5)
    p.add_argument("--v_sparsity", type=float, default=0.5)
    p.add_argument("--group_size", type=int, default=32)
    p.add_argument("--residual_length", type=int, default=32)
    p.add_argument("--max_seq_len", type=int, default=4608)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--chunked_prefill", action="store_true",
                   help="stream the prompt chunk-by-chunk through the "
                        "compressed cache (O(chunk) activation memory; "
                        "prefill attends to the pruned past)")
    p.add_argument("--codec", default="bitmap",
                   choices=["bitmap", "bitmap-q8", "q8", "q8q4", "q4q4"],
                   help="compressed-chunk codec: bitmap-packed sparse "
                        "(capacity-optimal) or quantized-dense "
                        "(q8q4 matches bitmap compression, q4q4 = 4x bytes)")
    p.add_argument("--weights", default="bf16",
                   choices=["bf16", "int8", "int8-a8", "int4"],
                   help="weight quantization (models/quant.py).  int8/int4 "
                        "load and quantize on the CPU and move only the "
                        "quantized params to the card; int8-a8 = int8 "
                        "weights + dynamic int8 activations")
    p.add_argument("--fuse_proj", action="store_true",
                   help="fuse qkv and gate+up projections "
                        "(quant.fuse_projections)")


def _build_engine(args, model_cfg):
    from mustafar_tpu_torch.config import CacheMode, EngineConfig, PruneConfig, PruneMethod

    method = PruneMethod(args.mode)
    if args.cache is not None:
        cache_mode = CacheMode(args.cache)
    elif method == PruneMethod.DENSE:
        cache_mode = CacheMode.DENSE
    elif method.k_policy == "token_mag" and method.v_policy == "token_mag":
        cache_mode = CacheMode.COMPRESSED
    else:
        cache_mode = CacheMode.MASKED
    prune = PruneConfig(method=method, k_sparsity=args.k_sparsity,
                        v_sparsity=args.v_sparsity, group_size=args.group_size,
                        residual_length=args.residual_length)
    return EngineConfig(model=model_cfg, prune=prune, cache_mode=cache_mode,
                        max_seq_len=args.max_seq_len,
                        chunked_prefill=getattr(args, "chunked_prefill", False),
                        codec=getattr(args, "codec", "bitmap"))


def _move(params: dict, device) -> dict:
    return {k: (_move(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in params.items()}


def cmd_predict(args):
    import torch

    from mustafar_tpu_torch.device import resolve_device
    from mustafar_tpu_torch.harness import configs
    from mustafar_tpu_torch.harness.longbench import (PredictConfig, load_longbench_rows,
                                                      predict_dataset)
    from mustafar_tpu_torch.harness.tokenizer import LocalTokenizer
    from mustafar_tpu_torch.models import quant
    from mustafar_tpu_torch.models.weights import load_hf_dir
    from mustafar_tpu_torch.runtime.generate import Generator

    dev = resolve_device(_device())
    weights = getattr(args, "weights", "bf16")
    if weights in ("int8", "int8-a8", "int4"):
        # load bf16 on the CPU, quantize there, move only the quantized
        # params (a full 8B in bf16 beside its cache is the card's limit)
        cfg, params = load_hf_dir(args.model, dtype=torch.bfloat16, device="cpu")
        params = (quant.quantize_params_w4(params) if weights == "int4"
                  else quant.quantize_params(params))
        params = _move(params, dev)
        if weights == "int8-a8":
            params = quant.enable_act_quant(params)
    else:
        cfg, params = load_hf_dir(args.model, dtype=torch.bfloat16, device=dev)
    if getattr(args, "fuse_proj", False):
        params = quant.fuse_projections(params)
    tokenizer = LocalTokenizer.from_pretrained(args.model)
    eng = _build_engine(args, cfg)
    gen = Generator(eng, params, device=dev)

    model_name = os.path.basename(args.model.rstrip("/"))
    max_length = args.max_length or configs.model_max_len(model_name)
    run = f"{model_name}_{max_length}_K_{args.k_sparsity}_V_{args.v_sparsity}"
    out_dir = os.path.join(args.out_root, run)
    pc = PredictConfig(model_name=model_name, max_length=max_length,
                       out_dir=out_dir)
    datasets = args.datasets or configs.DATASETS_EN
    for ds in datasets:
        rows = load_longbench_rows(ds, data_dir=args.data_dir, e_split=args.e)
        if args.limit:
            rows = rows[: args.limit]
        predict_dataset(gen, tokenizer, ds, rows, pc,
                        eos_id=tokenizer.eos_token_id)
    print(f"predictions written to {out_dir}")


def cmd_eval(args):
    from mustafar_tpu_torch.harness.longbench import evaluate_dir

    scores = evaluate_dir(args.pred_dir, e_buckets=args.e)
    print(json.dumps(scores, indent=2, ensure_ascii=False))


def cmd_synth_ckpt(args):
    from mustafar_tpu_torch.harness.synth_ckpt import write_checkpoint
    write_checkpoint(args.out, small=args.small, seed=args.seed,
                     shard_gib=args.shard_gib, rows=args.rows,
                     ctx_bytes=args.ctx)
    print(f"synthetic checkpoint written to {args.out}")


def cmd_accuracy(args):
    from mustafar_tpu_torch.harness import tinylm
    res = tinylm.run_accuracy(
        args.ckpt, args.out, n_rows=args.rows, ctx_bytes=args.ctx,
        sparsities=tuple(args.sparsities), modes=tuple(args.modes),
        depths=tuple(args.depths) if args.depths else None, device=_device())
    print(json.dumps(res, indent=2))


def cmd_train_tiny(args):
    from mustafar_tpu_torch.harness import tinylm
    tinylm.train(args.out, steps=args.steps, batch=args.batch, seq=args.seq,
                 lr=args.lr, seed=args.seed, hidden=args.hidden,
                 layers=args.layers, window=args.window,
                 rope_theta=args.rope_theta, device=_device())
    print(f"checkpoint written to {args.out}")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="mustafar_tpu_torch",
        epilog="MUSTAFAR_CPU=1 runs on the CPU (default: the CUDA card).  The JAX "
               "package's bench subcommand is not ported yet.")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("predict", help="LongBench prediction run")
    p.add_argument("--model", required=True, help="local HF checkpoint dir")
    p.add_argument("--datasets", nargs="*", default=None)
    p.add_argument("--data_dir", default=None, help="dir of <task>.jsonl files")
    p.add_argument("--out_root", default="pred_torch",
                   help="predictions' root (the JAX package's stay in pred/)")
    p.add_argument("--max_length", type=int, default=None)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--e", action="store_true", help="LongBench-E split")
    _add_engine_args(p)
    p.set_defaults(fn=cmd_predict)

    p = sub.add_parser("eval", help="score a prediction directory")
    p.add_argument("--pred_dir", required=True)
    p.add_argument("--e", action="store_true")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("synth-ckpt",
                       help="write a synthetic full-layout HF checkpoint "
                            "(sharded bf16 safetensors + tokenizer) to prove "
                            "the real-checkpoint predict path")
    p.add_argument("--out", required=True)
    p.add_argument("--small", action="store_true",
                   help="small geometry (tests); default is the full "
                        "Llama-3.1-8B layout (~15 GiB on disk)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--shard_gib", type=float, default=4.0)
    p.add_argument("--rows", type=int, default=0,
                   help="also write N passkey rows to <out>/rows/")
    p.add_argument("--ctx", type=int, default=4000,
                   help="passkey row context bytes")
    p.set_defaults(fn=cmd_synth_ckpt)

    p = sub.add_parser("train-tiny",
                       help="train the tiny accuracy-evidence model")
    p.add_argument("--out", default="ckpt_torch/tiny-acc",
                   help="the checkpoint's directory (the JAX package's recorded "
                        "ckpt/tiny-acc stays as it is)")
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=2048)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--hidden", type=int, default=None)
    p.add_argument("--layers", type=int, default=None)
    p.add_argument("--rope_theta", type=float, default=None)
    p.add_argument("--window", type=int, default=None,
                   help="sliding-window attention (Mistral semantics)")
    p.set_defaults(fn=cmd_train_tiny)

    p = sub.add_parser("accuracy",
                       help="dense-vs-pruned accuracy grid on a checkpoint")
    p.add_argument("--ckpt", default="ckpt/tiny-acc")
    p.add_argument("--out", default="accuracy_torch",
                   help="the grid's directory (the JAX package's recorded "
                        "grids stay in accuracy*/)")
    p.add_argument("--rows", type=int, default=40)
    p.add_argument("--ctx", type=int, default=1600)
    p.add_argument("--sparsities", nargs="*", type=float, default=[0.5, 0.7])
    p.add_argument("--modes", nargs="*", default=["masked", "compressed"])
    p.add_argument("--depths", nargs="*", type=float, default=None,
                   help="fixed needle depths (adds per-depth accuracy)")
    p.set_defaults(fn=cmd_accuracy)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
