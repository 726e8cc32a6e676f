"""The four trainer CLIs over 2 gloo ranks on the CPU against one process.

One 2-rank world (``parallel/dryrun.py::launch``, a file store in
``tmp_path``) runs, in each rank, ``run_nerf`` (the kernel step's twins,
noise on; a test-set render), its ``--render_only --render_test`` of rank
0's checkpoint,
``run_tnerf`` (B4's twin), ``run_dnerf`` (the kernel step with TV, 15 rays:
an uneven split; a test-set render through the eval pass) and
``run_multires`` (one phase-2 step with the global term from the
replicated start, as ``chip_smoke.py`` phase 45 runs it; a test-set
render), then ``run_nerf`` under
``SWNERF_DATA_PARALLEL=0``, each rank in a base directory of its own. Here
the same runs in one process give the references:

* every tensor of each run's last checkpoint (weights and Adam) within
  rtol 1e-5, atol 1e-6 (the bar of ``tests/test_multihost.py:238-244``),
  every level of the MultiRes run too, where a tensor leaves the bar only
  as far as summation order alone takes it: a control, the one-process
  MultiRes run with phase 2's rows reversed inside ``render_rays`` (the
  same sums in another order), must leave it at least half as far (level
  0 encodes positions at 2^19 frequencies, and its gradient entries that
  cancel to near 0 keep the rounding of the terms they cancel);
* rank 0 wrote the ``.tar``, ``.msgpack``, ``args.txt``, ``metrics.jsonl``,
  ``log.txt`` and PNGs, rank 1 none of them;
* the ``--render_only`` frames of the 2 ranks equal the one process's
  (``torch.equal``);
* ``SWNERF_DATA_PARALLEL=0`` runs no collective and prints no sharding line.
"""

import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from swnerf_torch.data.synthetic import write_blender_scene
from swnerf_torch.parallel.dryrun import launch
from swnerf_torch.train.checkpoint import load_tar

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
WRITTEN = (".tar", ".msgpack", ".png", ".gif", ".mp4")
LOGS = ("args.txt", "metrics.jsonl", "log.txt")


def _legs(data, ddata):
    """(name, module, argv with ``{base}`` for the rank's base directory,
    env, last checkpoint) of each run."""
    nerf = ["--expname", "nerf", "--basedir", "{base}", "--datadir", data, "--dataset_type", "blender",
            "--white_bkgd", "--use_viewdirs", "--netdepth", "6", "--netwidth", "128", "--netdepth_fine", "6",
            "--netwidth_fine", "128", "--multires", "4", "--multires_views", "2", "--N_rand", "32",
            "--N_samples", "8", "--N_importance", "8", "--chunk", "64", "--i_weights", "10", "--i_print", "5",
            "--i_video", "100000", "--i_testset", "10", "--precrop_iters", "0", "--raw_noise_std", "1",
            "--device", "cpu"]
    dyn = ["--basedir", "{base}", "--datadir", ddata, "--dataset_type", "blender", "--white_bkgd", "--use_viewdirs",
           "--multires", "4", "--multires_views", "2", "--N_samples", "8", "--chunk", "64", "--testskip", "1",
           "--i_print", "5", "--i_video", "100000", "--i_img", "100000", "--raw_noise_std", "1", "--device", "cpu"]
    return [
        ("nerf", "run_nerf", nerf, {"SWNERF_MAX_ITERS": "11", "SWNERF_CKPT_FORMAT": "both"}, "nerf/000010.tar"),
        ("nerf_render", "run_nerf", nerf + ["--render_only", "--render_test", "--ft_path", "{base0}/nerf/000010.tar"],
         {}, None),
        ("tnerf", "run_tnerf", ["--expname", "tnerf", "--netdepth", "8", "--N_rand", "16", "--i_weights", "10",
                                "--i_testset", "100000"] + dyn, {"SWNERF_MAX_ITERS": "11"}, "tnerf/000010.tar"),
        ("dnerf", "run_dnerf", ["--expname", "dnerf", "--nerf_type", "direct_temporal", "--netdepth", "6",
                                "--netwidth", "128", "--N_importance", "8", "--N_rand", "15", "--i_weights", "10",
                                "--i_testset", "10", "--add_tv_loss", "--tv_loss_weight", "1e-2"] + dyn,
         {"SWNERF_MAX_ITERS": "11"}, "dnerf/000010.tar"),
        ("multires", "run_multires", ["--expname", "multires", "--nerf_type", "direct_temporal", "--netdepth", "2",
                                      "--netwidth", "16", "--N_rand", "16", "--layer_num", "3",
                                      "--global_optimization_epoch", "1", "--i_weights", "1", "--i_testset", "1",
                                      "--no_batching"] + dyn + ["--i_print", "1"],
         {"SWNERF_MAX_ITERS": "2", "SWNERF_PHASE1_ITERS": "0"}, "multires/000001.tar"),
        ("nerf_dp0", "run_nerf", [a.replace("nerf", "dp0") if a == "nerf" else a for a in nerf],
         {"SWNERF_MAX_ITERS": "3", "SWNERF_DATA_PARALLEL": "0"}, None),
    ]


def _run_leg(leg, base, base0):
    """One run in this process: its environment set, every frame that
    ``render_path`` renders recorded, the collectives counted."""
    import importlib

    import swnerf_torch.pipelines.common as common

    name, module, argv, env, _ = leg
    argv = [a.replace("{base0}", base0).replace("{base}", base) for a in argv]
    frames, calls = [], {"n": 0}
    render_image, saved_env = common.render_image, {k: os.environ.get(k) for k in env}
    coll = {k: getattr(torch.distributed, k) for k in ("all_reduce", "broadcast")}

    def recording(*a, **kw):
        out = render_image(*a, **kw)
        frames.append(out["rgb"].clone())
        return out

    def counting(fn):
        def call(*a, **kw):
            calls["n"] += 1
            return fn(*a, **kw)
        return call

    common.render_image = recording
    for k, fn in coll.items():
        setattr(torch.distributed, k, counting(fn))
    os.environ.update(env)
    try:
        importlib.import_module(f"swnerf_torch.pipelines.{module}").main(argv)
    finally:
        common.render_image = render_image
        for k, fn in coll.items():
            setattr(torch.distributed, k, fn)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {"frames": frames, "collectives": calls["n"]}


def _cli_child(tmp):
    """A rank: every leg in turn in ``<tmp>/rank<r>``, a barrier after
    each (rank 1 reads rank 0's checkpoint)."""
    from swnerf_torch.parallel import initialize_from_env, process_index

    torch.set_num_threads(2)
    assert initialize_from_env("cpu")
    rank = process_index()
    with open(os.path.join(tmp, "plan.json")) as f:
        data, ddata = json.load(f)
    out = {}
    for leg in _legs(data, ddata):
        out[leg[0]] = _run_leg(leg, os.path.join(tmp, f"rank{rank}"), os.path.join(tmp, "rank0"))
        torch.distributed.barrier()
    torch.save(out, os.path.join(tmp, f"cli_out{rank}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-rank world's results per rank and the one-process results."""
    tmp = tmp_path_factory.mktemp("cli")
    data, ddata = str(tmp / "data"), str(tmp / "ddata")
    write_blender_scene(data, n_train=4, n_val=1, n_test=2, size=16, device="cpu")
    write_blender_scene(ddata, n_train=4, n_val=1, n_test=2, size=16, dynamic=True, scene="textured", device="cpu")
    with open(tmp / "plan.json", "w") as f:
        json.dump([data, ddata], f)
    code = f"from tests.test_torch_parallel_cli import _cli_child; _cli_child({str(tmp)!r})"
    outs = launch([sys.executable, "-c", code], 2, str(tmp), timeout=400, threads=2, cwd=str(REPO))
    ranks = [torch.load(tmp / f"cli_out{r}.pt", weights_only=False) for r in range(2)]
    # The one process renders rank 0's checkpoint too: the same weights.
    single = {leg[0]: _run_leg(leg, str(tmp / "single"), str(tmp / "rank0")) for leg in _legs(data, ddata)
              if leg[0] != "nerf_dp0"}
    with reversed_rows():
        _run_leg(next(leg for leg in _legs(data, ddata) if leg[0] == "multires"), str(tmp / "control"), "")
    return tmp, ranks, single, outs


@contextlib.contextmanager
def reversed_rows():
    """MultiRes phase 2's field renders with their rows reversed (rays and
    draws in, every per-row output back): the same sums in another order."""
    import swnerf_torch.pipelines.run_multires as mr

    render_rays = mr.render_rays

    def reversed_render(model, rays, cfg, fine_model=None, draws=None, **kw):
        n = rays.origins.shape[0]
        idx = torch.arange(n - 1, -1, -1)
        flip = lambda t: None if t is None else type(t)(*(None if x is None else x[idx] for x in t))  # noqa: E731
        out = render_rays(model, flip(rays), cfg, fine_model=fine_model, draws=flip(draws), **kw)
        return {k: v[idx] if isinstance(v, torch.Tensor) and v.dim() and v.shape[0] == n else v
                for k, v in out.items()}

    mr.render_rays = reversed_render
    try:
        yield
    finally:
        mr.render_rays = render_rays


def _tensors(x, prefix=""):
    if isinstance(x, torch.Tensor):
        yield prefix, x
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _tensors(v, f"{prefix}/{k}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _tensors(v, f"{prefix}/{i}")


@pytest.mark.parametrize("name", ["nerf", "tnerf", "dnerf", "multires"])
def test_two_rank_cli_matches_one_process(runs, name):
    """The last checkpoint of each trainer over 2 ranks: every tensor
    (weights, Adam moments and counts) against the one-process run's; a
    MultiRes tensor outside the bar no further from it than twice the
    reversed-rows control is (module docstring)."""
    tmp, _, _, outs = runs
    ckpt = dict((leg[0], leg[4]) for leg in _legs("", ""))[name]
    got, ref = load_tar(tmp / "rank0" / ckpt), load_tar(tmp / "single" / ckpt)
    assert got["global_step"] == ref["global_step"]
    got_t, ref_t = dict(_tensors(got)), dict(_tensors(ref))
    ctl_t = dict(_tensors(load_tar(tmp / "control" / ckpt))) if name == "multires" else {}
    assert got_t.keys() == ref_t.keys()
    for k, r in ref_t.items():
        g, r = got_t[k].double().numpy(), r.double().numpy()
        if k in ctl_t and not np.allclose(g, r, rtol=1e-5, atol=1e-6):
            d, d_ctl = np.abs(g - r).max(), np.abs(ctl_t[k].double().numpy() - r).max()
            assert d <= 2 * d_ctl, (k, d, d_ctl)
            continue
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6, err_msg=k)
    assert "Data parallelism: sharding rays over 2 ranks (gloo)" in outs[0]


def test_only_rank_0_writes(runs):
    """Checkpoints (both formats), args.txt, metrics.jsonl, MultiRes's
    log.txt, the test sets' and --render_only's PNGs and videos: in rank 0's
    base directory, none in rank 1's."""
    tmp = runs[0]
    found = [{os.path.relpath(os.path.join(d, f), tmp / f"rank{r}") for d, _, fs in os.walk(tmp / f"rank{r}")
              for f in fs if f.endswith(WRITTEN) or f in LOGS} for r in range(2)]
    assert found[1] == set()
    for must in ("nerf/000010.tar", "nerf/000010.msgpack", "nerf/args.txt", "nerf/metrics.jsonl",
                 "tnerf/000010.tar", "dnerf/000010.tar", "multires/000001.tar", "multires/log.txt",
                 "nerf/testset_000010/000.png", "dnerf/testset_000010/000.png",
                 "multires/testset_000001/recon_000.png", "nerf/renderonly_test_000010/000.png"):
        assert must in found[0], must


def test_two_rank_render_only_frames_are_bit_equal(runs):
    """--render_only --render_test: each rank renders its chunks of every
    frame and the frame is assembled by one all-reduce of disjoint pieces,
    so both ranks hold frames equal to the one process's; so do the test
    sets rendered during training."""
    _, ranks, single, _ = runs
    for name in ("nerf_render", "nerf", "dnerf", "multires"):
        ref = single[name]["frames"]
        assert ref
        for r in range(2):
            got = ranks[r][name]["frames"]
            assert len(got) == len(ref)
            if name != "nerf_render":  # the trained weights differ by the step's summation order
                continue
            for a, b in zip(got, ref):
                assert torch.equal(a, b)


def test_data_parallel_0_runs_no_collective(runs):
    """SWNERF_DATA_PARALLEL=0 in a world of 2: no group, no collective,
    no sharding line; each process trains alone (rank 0 writes)."""
    tmp, ranks, _, outs = runs
    assert all(r["nerf_dp0"]["collectives"] == 0 for r in ranks)
    assert all(r["nerf"]["collectives"] > 0 for r in ranks)
    assert outs[0].count("Data parallelism: sharding rays") == 5  # every leg but nerf_dp0 (render_only too)


def test_cpu_dry_run_two_ranks(tmp_path):
    """``python -m swnerf_torch.parallel.dryrun --ranks 2``: the four
    trainers at full widths over 2 gloo ranks, the resume leg too; the
    ranks agree on every metric and every loss is finite."""
    out = subprocess.run([sys.executable, "-m", "swnerf_torch.parallel.dryrun", "--ranks", "2", "--workdir",
                          str(tmp_path)], cwd=str(REPO), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["ranks"] == 2
    assert set(res["results"]) == {"run_nerf", "run_nerf[save@2]", "run_nerf[resume@3]", "run_dnerf", "run_tnerf",
                                   "run_multires"}
