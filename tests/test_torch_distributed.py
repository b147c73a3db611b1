"""Port parity, the multi-process runtime (``parallel/distributed.py``) on
the CPU, processes joined over gloo through a ``file://`` store in the
test's own directory.

(s) ``python -m mustafar_tpu_torch.parallel.distributed`` in two processes
    (dp=1 x tp=2), both step programs ("masked", and "q8q4": the compressed
    serving path) on the JAX program's own weights (``--params``, carried
    from ``mustafar_tpu.parallel.distributed._step_program``): both
    processes agree exactly, and with one process of the port and with the
    JAX program on one device (checksums within 2e-4, tokens equal).
(r) Recovery: a two-process timed decode at tp=2 with a snapshot every
    step, whose process 1 dies abruptly at step 4 (``--die-after``): the
    survivor reports the peer's loss from its health barrier within the
    barrier's deadline, and its snapshot (4 steps) re-admitted on one
    process (``run_recovery``: prefill, checked replay, the rest) gives the
    uninterrupted two-process run's stream token for token.
Every process is waited for with a timeout and killed past it.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from mustafar_tpu_torch.parallel import distributed as dist_rt

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROC_TIMEOUT_S = 240
STEPS, DIE_AT, BARRIER_MS = 12, 4, 3000


def _launch(tmp, tag, extra, n=2):
    """n processes of the command line on one file store; their JSON
    results, each process's exit code."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    outs = [tmp / f"{tag}{i}.json" for i in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mustafar_tpu_torch.parallel.distributed",
         "--coordinator", f"file://{tmp / tag}.store", "--num-processes", str(n),
         "--process-id", str(i), "--backend", "gloo", "--device", "cpu",
         "--dp", "1", "--tp", str(n), "--timeout-s", "120", "--out", str(outs[i]),
         *extra], env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=PROC_TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return ([json.loads(o.read_text()) if o.exists() else None for o in outs],
            [p.returncode for p in procs], logs)


def _jax_step(program, tmp):
    """The JAX program on one device, and its params written as an npz."""
    import jax
    from mustafar_tpu.parallel.distributed import _step_program
    _, _, _, params, tokens, cache, fn = _step_program(program)
    s1, s2, tok = jax.jit(fn)(params, tokens, cache)
    path = tmp / f"{program}.npz"
    flat = {}
    for k, v in params.items():
        if isinstance(v, dict):
            flat.update({f"layers/{kk}": np.asarray(vv) for kk, vv in v.items()})
        else:
            flat[k] = np.asarray(v)
    np.savez(path, **flat)
    return (float(s1), float(s2), np.asarray(tok).tolist()), path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    with ThreadPoolExecutor(6) as ex:
        timed = ex.submit(_launch, tmp, "timed", ["--program", "q8q4", "--steps",
                                                  str(STEPS)])
        died = ex.submit(_launch, tmp, "died", [
            "--program", "q8q4", "--steps", str(STEPS), "--die-after", str(DIE_AT),
            "--barrier-ms", str(BARRIER_MS), "--snapshot", str(tmp / "snap.json")])
        jax_refs = {p: _jax_step(p, tmp) for p in ("masked", "q8q4")}
        steps = {p: ex.submit(_launch, tmp, p, ["--program", p, "--params",
                                                str(jax_refs[p][1])])
                 for p in ("masked", "q8q4")}
        one = {p: dist_rt.run_sharded_step(None, p, dist_rt.load_params_npz(
            str(jax_refs[p][1])), device="cpu") for p in ("masked", "q8q4")}
        return (jax_refs, {p: f.result() for p, f in steps.items()}, one,
                timed.result(), died.result(), tmp)


@pytest.mark.parametrize("program", ["masked", "q8q4"])
def test_two_process_sharded_step_parity(runs, program):
    jax_refs, steps, one, *_ = runs
    (res, codes, logs) = steps[program]
    assert codes == [0, 0], logs[0][-3000:] + logs[1][-3000:]
    r0, r1 = res
    assert r0["n_processes"] == 2 and r0["backend"] == "gloo"
    # the two processes of the SPMD program agree exactly
    assert r0["tokens"] == r1["tokens"]
    assert r0["prefill_sum"] == r1["prefill_sum"] and r0["decode_sum"] == r1["decode_sum"]
    # and match one process of the port, and the JAX program on one device
    s1, s2, tok = one[program]
    np.testing.assert_allclose(r0["prefill_sum"], s1, rtol=2e-4)
    np.testing.assert_allclose(r0["decode_sum"], s2, rtol=2e-4)
    assert r0["tokens"] == tok.tolist()
    (j1, j2, jtok), _ = jax_refs[program]
    np.testing.assert_allclose(r0["prefill_sum"], j1, rtol=2e-4)
    np.testing.assert_allclose(r0["decode_sum"], j2, rtol=2e-4)
    assert r0["tokens"] == jtok


def test_peer_death_surfaces_within_the_barrier_deadline(runs):
    *_, (res, codes, logs), _ = runs
    assert codes == [0, 17], logs
    survivor = res[0]
    assert survivor["peer_loss_detected"], survivor
    assert survivor["steps_done"] == DIE_AT
    assert survivor["detected_after_s"] < BARRIER_MS / 1e3 + 5, survivor
    assert res[1] is None                       # the dead process wrote nothing


def test_recovery_on_another_mesh_is_token_exact(runs):
    *_, (timed, codes, logs), _, tmp = runs
    assert codes == [0, 0], logs
    ref = timed[0]["stream"]
    assert len(ref) == STEPS + 1 and timed[1]["stream"] == ref
    snap = json.loads((tmp / "snap.json").read_text())
    assert snap["steps_done"] == DIE_AT and snap["stream"] == ref[:DIE_AT + 1]
    rec = dist_rt.run_recovery(str(tmp / "snap.json"), None, device="cpu")
    assert rec["replay_steps_checked"] == DIE_AT and rec["tp"] == 1
    assert rec["stream"] == ref


def test_cli_refuses_a_mesh_the_processes_cannot_hold(tmp_path):
    with pytest.raises(SystemExit, match="needs 4 processes"):
        dist_rt.main(["--dp", "2", "--tp", "2", "--num-processes", "2", "--device", "cpu",
                      "--out", str(tmp_path / "x.json")])
