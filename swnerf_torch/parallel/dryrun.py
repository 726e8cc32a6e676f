"""Launch a world of ranks on one host, and the CPU dry run of the four
trainers over it (port of ``__graft_entry__.dryrun_multichip``)::

    python -m swnerf_torch.parallel.dryrun --ranks 2 [--steps 3] [--workdir DIR]

writes a small static and a small dynamic scene, then runs ``run_nerf``
(with a save at step 2 and a resume for one more step), ``run_dnerf`` (TV
loss), ``run_tnerf`` and ``run_multires`` (both phases) over ``--ranks``
gloo processes on the CPU, at the full widths (D=8, W=256 trunks; the
T-NeRF's 128) with tiny ray counts. Each rank joins through a file store
(no TCP port); the run fails unless every rank finishes, every loss is
finite and the ranks agree on every metric. It prints one JSON line of the
metrics. Under ``SWNERF_TENSOR_PARALLEL=k`` (which the ranks inherit) the
trainers cut their fields over a ``(rays, model)`` grid of the ranks
(``parallel/tensor.py``): ``--ranks 4`` with k = 2 runs a 2 x 2 grid, and
the JSON line names it.

:func:`launch` is the launcher: it starts one process per rank with the
``SWNERF_COORDINATOR`` / ``SWNERF_NUM_PROCESSES`` / ``SWNERF_PROCESS_ID`` of
``multihost.initialize_from_env``, waits for all of them within a timeout,
and kills the survivors when one fails.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def launch(cmd: Sequence[str], world: int, workdir: str, timeout: float = 300.0, threads: int = 1,
           cwd: Optional[str] = None) -> List[str]:
    """Run ``cmd`` as ``world`` ranks joined through a fresh file store in
    ``workdir``; ``threads`` caps each rank's CPU threads. Returns each
    rank's output (stdout and stderr together). Raises ``RuntimeError`` with
    the failing rank's output when a rank exits non-zero or the world
    outlives ``timeout`` seconds; every process still running is killed
    first."""
    os.makedirs(workdir, exist_ok=True)
    fd, store = tempfile.mkstemp(prefix="store_", dir=workdir)
    os.close(fd)
    os.remove(store)  # a file store starts from no file
    base = dict(os.environ)
    base.update(SWNERF_COORDINATOR=f"file://{store}", SWNERF_NUM_PROCESSES=str(world),
                OMP_NUM_THREADS=str(threads), MKL_NUM_THREADS=str(threads))
    base["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, base.get("PYTHONPATH", "")) if p)
    logs = [open(os.path.join(workdir, f"{os.path.basename(store)}_rank{r}.log"), "w+") for r in range(world)]
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(list(cmd), env=dict(base, SWNERF_PROCESS_ID=str(r)), cwd=cwd,
                                          stdout=logs[r], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        failed = None
        while failed is None and any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs) if p.poll() not in (None, 0)), None)
            if time.monotonic() > deadline:
                failed = "timeout"
            time.sleep(0.05)
        if failed is None:
            failed = next((r for r, p in enumerate(procs) if p.returncode != 0), None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
    if failed is not None:
        rank = 0 if failed == "timeout" else failed
        why = f"timed out after {timeout:.0f} s" if failed == "timeout" else f"rank {rank} exited {procs[rank].returncode}"
        raise RuntimeError(f"{why}: {' '.join(cmd)}\n--- rank {rank} output (tail) ---\n{outs[rank][-6000:]}")
    return outs


def _trainer_runs(data: str, ddata: str, logs: str, ranks: int) -> List[tuple]:
    """(name, module, argv, env) of the dry run's trainer calls."""
    common = ["--white_bkgd", "--use_viewdirs", "--netdepth", "8", "--netwidth", "256", "--multires", "10",
              "--multires_views", "4", "--N_rand", str(8 * ranks), "--N_samples", "8", "--chunk", "128",
              "--i_weights", "100000", "--i_print", "1", "--i_video", "100000", "--i_testset", "100000",
              "--precrop_iters", "0", "--device", "cpu"]
    dyn = ["--dataset_type", "blender", "--nerf_type", "direct_temporal", "--testskip", "1", "--N_iter", "2",
           "--i_img", "100000", "--precrop_iters_time", "0"]
    fine = ["--netdepth_fine", "8", "--netwidth_fine", "256", "--N_importance", "8"]
    nerf = ["--basedir", logs, "--datadir", data, "--dataset_type", "blender"] + fine + common
    return [
        ("run_nerf", "run_nerf", ["--expname", "dry_nerf"] + nerf, {}),
        ("run_nerf[save@2]", "run_nerf", ["--expname", "dry_resume"] + nerf + ["--i_weights", "2"],
         {"SWNERF_MAX_ITERS": "3", "SWNERF_CKPT_FORMAT": "both"}),
        ("run_nerf[resume@3]", "run_nerf", ["--expname", "dry_resume"] + nerf + ["--i_weights", "1"],
         {"SWNERF_MAX_ITERS": "4", "SWNERF_CKPT_FORMAT": "both"}),
        ("run_dnerf", "run_dnerf", ["--expname", "dry_dnerf", "--basedir", logs, "--datadir", ddata,
                                    "--N_importance", "8", "--add_tv_loss"] + dyn + common, {}),
        ("run_tnerf", "run_tnerf", ["--expname", "dry_tnerf", "--basedir", logs, "--datadir", ddata] + dyn + common,
         {}),
        ("run_multires", "run_multires", ["--expname", "dry_multires", "--basedir", logs, "--datadir", ddata,
                                          "--layer_num", "4", "--global_optimization_epoch", "1"] + dyn + common,
         {"SWNERF_PHASE1_ITERS": "1"}),
    ]


def _worker(workdir: str, steps: int) -> None:
    """One rank: join the world, run every trainer in this process, write
    ``result_<rank>.json``."""
    import importlib

    import torch

    from swnerf_torch.parallel.multihost import initialize_from_env, process_count, process_index

    torch.set_num_threads(1)
    initialize_from_env("cpu")
    rank, ranks = process_index(), process_count()
    data, ddata, logs = (os.path.join(workdir, d) for d in ("data", "ddata", "logs"))
    results = {}
    for name, module, argv, env in _trainer_runs(data, ddata, logs, ranks):
        saved = {k: os.environ.get(k) for k in ("SWNERF_MAX_ITERS", "SWNERF_CKPT_FORMAT", "SWNERF_PHASE1_ITERS")}
        os.environ["SWNERF_MAX_ITERS"] = str(steps + 1)
        os.environ.update(env)
        try:
            out = importlib.import_module(f"swnerf_torch.pipelines.{module}").train(argv)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        results[name] = {k: out["metrics"][k] for k in ("loss", "psnr", "total_loss", "global_loss")
                         if k in out["metrics"]}
        # Rank 0 may still be writing the run's last checkpoint, which the
        # next run resumes from.
        torch.distributed.barrier()
    exp = os.path.join(logs, "dry_resume")
    if rank == 0:
        names = sorted(os.listdir(exp))
        if "000001.tar" in names or "000003.tar" not in names or "000002.msgpack" not in names:
            raise RuntimeError(f"the resume leg did not resume from step 2: {names}")
    with open(os.path.join(workdir, f"result_{rank}.json"), "w") as f:
        json.dump(results, f)


def dryrun(ranks: int, workdir: str, steps: int = 2, timeout: float = 600.0) -> Dict[str, Dict[str, float]]:
    """Write the scenes, run the trainers over ``ranks`` gloo ranks, check
    the results. Returns rank 0's metrics per trainer run."""
    from swnerf_torch.data.synthetic import write_blender_scene

    write_blender_scene(os.path.join(workdir, "data"), n_train=3, n_val=1, n_test=1, size=16, device="cpu")
    # size 32: the smallest MultiRes scene (levels 32/16/8/4, the patch sizes)
    write_blender_scene(os.path.join(workdir, "ddata"), n_train=3, n_val=1, n_test=1, size=32, dynamic=True,
                        device="cpu")
    launch([sys.executable, "-m", "swnerf_torch.parallel.dryrun", "--worker", "--workdir", workdir,
            "--steps", str(steps)], ranks, workdir, timeout=timeout)
    results = []
    for r in range(ranks):
        with open(os.path.join(workdir, f"result_{r}.json")) as f:
            results.append(json.load(f))
    for r, res in enumerate(results[1:], 1):
        if res != results[0]:
            raise RuntimeError(f"rank {r}'s metrics differ from rank 0's: {res} != {results[0]}")
    bad = {k: v for k, v in results[0].items() if not all(math.isfinite(x) for x in v.values())}
    if bad:
        raise RuntimeError(f"non-finite losses: {bad}")
    return results[0]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--steps", type=int, default=2, help="steps of each trainer run")
    p.add_argument("--workdir", default=None, help="scratch directory (default: a temporary one)")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    if a.worker:
        _worker(a.workdir, a.steps)
        return
    if a.workdir is None:
        with tempfile.TemporaryDirectory() as tmp:
            res = dryrun(a.ranks, tmp, a.steps, a.timeout)
    else:
        res = dryrun(a.ranks, a.workdir, a.steps, a.timeout)
    k = int(os.environ.get("SWNERF_TENSOR_PARALLEL", "0") or 0)
    grid = {"rays": a.ranks // k, "model": k} if k > 1 else None
    print(json.dumps({"ranks": a.ranks, "tensor_parallel": grid, "results": res}))


if __name__ == "__main__":
    main()
