"""Check that ranks sharing one CUDA card can reduce over ``gloo``.

    python3 tools/gloo_card_check.py [--seconds 60] [--world 2]

Prints the card's compute mode (an exclusive mode admits one process), then
starts ``--world`` processes on card 0, joins them in a ``gloo`` group over a
``file://`` store and a ("data", "model") device mesh, and for ``--seconds``
all-reduces CUDA tensors (f32 SUM of 1 Mi floats, int64 SUM of 8, f32 MAX of
8) checking every result.  One JSON line per rank and a summary line; exits
non-zero on a wrong sum, a rank that fails or a mode that forbids sharing.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time


def _rank(rank: int, world: int, store: str, seconds: float, out: str):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    mesh = init_device_mesh("cuda", (world // 2 if world > 2 else 1, min(world, 2)),
                            mesh_dim_names=("data", "model"))
    g = mesh.get_group("model")
    n_model = dist.get_world_size(g)
    big = torch.full((1 << 20,), float(rank + 1), device="cuda")
    small = torch.arange(8, device="cuda", dtype=torch.int64) + rank
    mx = torch.full((8,), float(rank), device="cuda")
    ranks = dist.get_process_group_ranks(g)
    want_big = float(sum(r + 1 for r in ranks))
    iters, t0, ms = 0, time.perf_counter(), []
    go = torch.ones(1, device="cuda")
    while True:
        # the ranks agree when to stop (a rank leaving alone would hang the rest)
        go.fill_(float(time.perf_counter() - t0 < seconds))
        dist.all_reduce(go, op=dist.ReduceOp.MIN)
        if go.item() == 0:
            break
        big.fill_(float(rank + 1))
        small.copy_(torch.arange(8, device="cuda", dtype=torch.int64) + rank)
        mx.fill_(float(rank))
        t = time.perf_counter()
        dist.all_reduce(big, group=g)
        dist.all_reduce(small, group=g)
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=g)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        ok = (bool((big == want_big).all())
              and small.tolist() == [n_model * i + sum(ranks) for i in range(8)]
              and bool((mx == float(max(ranks))).all()))
        if not ok:
            raise AssertionError(f"rank {rank}: wrong reduction at iteration {iters}")
        iters += 1
    dist.monitored_barrier(timeout=datetime.timedelta(seconds=30))
    ms.sort()
    with open(out, "w") as f:
        json.dump({"rank": rank, "iters": iters, "ms_p50": ms[len(ms) // 2],
                   "ms_max": ms[-1], "model_ranks": ranks,
                   "mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                   "torch": torch.__version__, "cuda": torch.version.cuda}, f)
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        _rank(args.rank, args.world, args.store, args.seconds, args.out)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,compute_mode",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    if "Exclusive" in smi or "Prohibited" in smi:
        raise SystemExit(f"the card's compute mode forbids a second process: {smi}")
    tmp = tempfile.mkdtemp(prefix="gloo_check_")
    store = os.path.join(tmp, "store")
    outs = [os.path.join(tmp, f"rank{r}.json") for r in range(args.world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                               "--world", str(args.world), "--store", store,
                               "--seconds", str(args.seconds), "--out", outs[r]])
             for r in range(args.world)]
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=args.seconds + 120))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append("timeout")
    results = [json.load(open(o)) for o in outs if os.path.exists(o)]
    for r in results:
        print(json.dumps(r), flush=True)
    print(json.dumps({"world": args.world, "exit_codes": codes,
                      "ok": codes == [0] * args.world}), flush=True)
    if codes != [0] * args.world:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
