"""The four trainer CLIs under ``SWNERF_TENSOR_PARALLEL=2`` over 2 gloo ranks
on the CPU (a (rays 1, model 2) grid) against one process.

One 2-rank world (``parallel/dryrun.py::launch``, a file store in
``tmp_path``, 1 thread a rank) runs, in each rank, the JAX package's
tensor-parallel CLI cases (``tests/test_tensor_parallel.py:161-325``) in
the port: ``run_nerf`` at W=32 (D=8) and at W=512 (every trunk layer cut),
10 steps each; ``run_dnerf`` (TV on); ``run_tnerf`` (the JAX package has
no T-NeRF case: held to ``run_nerf``'s bar); ``run_multires`` (2 phase-1
steps a level, 4 joint steps; and one joint step from scratch, D=8, W=32);
a resume of one process's native snapshot
at step 5; and ``--render_only --render_test`` of the W=32 run's
checkpoint. Here one process runs the same legs and resumes the TP run's
step-5 ``.tar``. The bars are the JAX tests': every tensor of the last
checkpoint (weights and Adam moments) within atol 2e-4 after 10 steps
(``run_nerf``, ``run_dnerf``, and ``run_tnerf`` at ``run_nerf``'s bar);
for MultiRes the JAX test's holds: every level's weights within atol 6e-3
(2 x 6 Adam steps x lr: a near-zero gradient whose sign the summation
order flips moves its weight by the learning rate either way), the first
joint step's losses rtol 2e-2 and every joint step's total loss rtol 0.2.
No tighter bar holds over those 6 Adam updates a level: level 0 encodes
positions at 2^19 frequencies, so fp32 rounding compounds (the run lands
as far from one process that sums as the grid does, ``grid_sums``, as from
one process: level 0's first moments 1.4 rel L2, level 1's 0.12-0.27).
The one joint step from scratch is held tight: every tensor of its
checkpoint (each level's weights and Adam moments) within rel L2 1e-5 of
one process summing as the grid does. The ``--render_only`` frames
``torch.equal`` to one process's from the same checkpoint (a TP
``--render_only`` cuts nothing: it renders the loaded fields over the
world). The TP checkpoints have a one-process checkpoint's keys, shapes
and formats, and rank 1 writes none.
"""

import concurrent.futures
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import grid_sums
from swnerf_torch.data.synthetic import write_blender_scene
from swnerf_torch.parallel.dryrun import launch
from swnerf_torch.train.checkpoint import load_tar
from swnerf_torch.utils import msgpack
from tests.test_torch_parallel_cli import _run_leg, _tensors

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TP = {"SWNERF_TENSOR_PARALLEL": "2"}
BARS = {"nerf32": 2e-4, "nerf512": 2e-4, "dnerf": 2e-4, "tnerf": 2e-4, "multires": 2 * 6 * 5e-4, "resume": 2e-4}


def _legs(data, ddata, single):
    """(name, module, argv with ``{base}`` / ``{base0}``, env, the last
    checkpoint) of each run; ``single`` is the one process's base
    directory, whose step-5 snapshot the resume leg reads."""
    nerf = ["--dataset_type", "blender", "--datadir", data, "--basedir", "{base}", "--white_bkgd", "--use_viewdirs",
            "--netdepth", "8", "--netwidth", "32", "--netdepth_fine", "2", "--netwidth_fine", "32", "--multires", "4",
            "--multires_views", "2", "--N_rand", "16", "--N_samples", "8", "--N_importance", "4", "--chunk", "64",
            "--testskip", "1", "--i_weights", "5", "--i_print", "5", "--i_video", "100000", "--i_testset", "100000",
            "--precrop_iters", "5", "--precrop_frac", "0.5", "--device", "cpu"]
    dyn = ["--dataset_type", "blender", "--datadir", ddata, "--basedir", "{base}", "--white_bkgd", "--use_viewdirs",
           "--multires", "4", "--multires_views", "2", "--N_rand", "16", "--N_samples", "8", "--chunk", "64",
           "--testskip", "1", "--i_print", "5", "--i_video", "100000", "--i_testset", "100000", "--i_img", "100000",
           "--precrop_iters", "0", "--precrop_iters_time", "0", "--device", "cpu"]
    ten = {"SWNERF_MAX_ITERS": "11"}
    return [
        ("nerf32", "run_nerf", ["--expname", "nerf32"] + nerf + ["--i_testset", "10"],
         dict(ten, SWNERF_CKPT_FORMAT="both"),
         "nerf32/000010.tar"),
        ("nerf512", "run_nerf", ["--expname", "nerf512"] + nerf + ["--netwidth", "512", "--netwidth_fine", "512"],
         ten, "nerf512/000010.tar"),
        ("resume", "run_nerf", ["--expname", "resume", "--ft_path", f"{single}/nerf32/000005.msgpack"] + nerf, ten,
         "resume/000010.tar"),
        ("render", "run_nerf", ["--expname", "render", "--ft_path", "{base0}/nerf32/000010.tar", "--render_only",
                                "--render_test"] + nerf, {}, None),
        ("dnerf", "run_dnerf", ["--expname", "dnerf", "--nerf_type", "direct_temporal", "--netdepth", "8",
                                "--netwidth", "32", "--add_tv_loss", "--i_weights", "10"] + dyn + ["--i_testset", "10"],
         ten,
         "dnerf/000010.tar"),
        ("tnerf", "run_tnerf", ["--expname", "tnerf", "--netdepth", "8", "--i_weights", "10"] + dyn, ten,
         "tnerf/000010.tar"),
        ("multires", "run_multires", ["--expname", "multires", "--nerf_type", "direct_temporal", "--netdepth", "2",
                                      "--netwidth", "16", "--layer_num", "3", "--global_optimization_epoch", "2",
                                      "--i_weights", "4", "--no_batching"] + dyn + ["--N_samples", "4", "--i_print",
                                                                                    "1", "--i_testset", "4"],
         {"SWNERF_MAX_ITERS": "5", "SWNERF_PHASE1_ITERS": "2"}, "multires/000004.tar"),
        ("multires1", "run_multires", ["--expname", "multires1", "--nerf_type", "direct_temporal", "--netdepth", "8",
                                       "--netwidth", "32", "--layer_num", "3", "--global_optimization_epoch", "1",
                                       "--i_weights", "1", "--no_batching"] + dyn + ["--N_samples", "4", "--i_print",
                                                                                     "1"],
         {"SWNERF_MAX_ITERS": "2", "SWNERF_PHASE1_ITERS": "0"}, "multires1/000001.tar"),
    ]


def _tp_leg(leg):
    name, module, argv, env, ckpt = leg
    return name, module, argv, dict(env, **TP), ckpt


def _cli_child(tmp):
    """A rank: every leg under SWNERF_TENSOR_PARALLEL=2 in ``<tmp>/rank<r>``,
    a barrier after each."""
    from swnerf_torch.parallel import initialize_from_env, process_index

    torch.set_num_threads(1)
    assert initialize_from_env("cpu")
    rank = process_index()
    with open(os.path.join(tmp, "plan.json")) as f:
        data, ddata, single = json.load(f)
    out = {}
    for leg in _legs(data, ddata, single):
        out[leg[0]] = _run_leg(_tp_leg(leg), os.path.join(tmp, f"rank{rank}"), os.path.join(tmp, "rank0"))
        torch.distributed.barrier()
    torch.save(out, os.path.join(tmp, f"cli_out{rank}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world's results per rank, its output, and the one process's
    results. The one process runs the W=32 leg first (the world resumes its
    step-5 snapshot), then its other legs while the world runs, then the
    resume of the TP run's step-5 ``.tar`` and the render of its last."""
    tmp = tmp_path_factory.mktemp("tpcli")
    data, ddata, single = str(tmp / "data"), str(tmp / "ddata"), str(tmp / "single")
    write_blender_scene(data, n_train=3, n_val=1, n_test=2, size=8, device="cpu")
    write_blender_scene(ddata, n_train=4, n_val=1, n_test=1, size=16, dynamic=True, scene="textured", device="cpu")
    with open(tmp / "plan.json", "w") as f:
        json.dump([data, ddata, single], f)
    legs = {leg[0]: leg for leg in _legs(data, ddata, single)}
    ref = {"nerf32": _run_leg(legs["nerf32"], single, "")}
    code = f"from tests.test_torch_tensor_parallel_cli import _cli_child; _cli_child({str(tmp)!r})"
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(launch, [sys.executable, "-c", code], 2, str(tmp), timeout=400, threads=1,
                            cwd=str(REPO))
        for name in ("nerf512", "resume", "dnerf", "tnerf", "multires"):
            ref[name] = _run_leg(legs[name], single, "")
        with grid_sums():
            _run_leg(legs["multires1"], str(tmp / "control"), "")
        outs = world.result()
    ranks = [torch.load(tmp / f"cli_out{r}.pt", weights_only=False) for r in range(2)]
    _, module, argv, env, _ = legs["resume"]
    argv = ["--expname", "from_tp", "--ft_path", str(tmp / "rank0" / "nerf32" / "000005.tar")] + argv[4:]
    ref["from_tp"] = _run_leg(("from_tp", module, argv, env, None), single, "")
    ref["render"] = _run_leg(legs["render"], single, str(tmp / "rank0"))
    return tmp, ranks, ref, outs


def _close(got, want, atol):
    """Every tensor of two checkpoints: the same names and shapes, and
    within ``atol``; returns the largest distance."""
    got_t, want_t = dict(_tensors(got)), dict(_tensors(want))
    assert got_t.keys() == want_t.keys()
    worst = 0.0
    for k, w in want_t.items():
        g = got_t[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        np.testing.assert_allclose(g.double().numpy(), w.double().numpy(), rtol=0, atol=atol, err_msg=k)
        worst = max(worst, (g.double() - w.double()).abs().max().item() if g.numel() else 0.0)
    return worst


def test_tensor_parallel_multires_step_matches_grid_sums(runs):
    """run_multires's one joint step from scratch over the (1, 2) grid:
    every tensor of its checkpoint (each level's weights, Adam moments and
    counts) within rel L2 1e-5 of one process that sums each cut layer's
    products as the grid does (``grid_sums``), so a wrong gradient of any
    level fails. (Element by element a few of level 0's large first-moment
    entries part by 1e-4 relative: the backward adds its terms in another
    order.)"""
    tmp = runs[0]
    got = dict(_tensors(load_tar(tmp / "rank0" / "multires1" / "000001.tar")))
    want = dict(_tensors(load_tar(tmp / "control" / "multires1" / "000001.tar")))
    assert got.keys() == want.keys() and any("/optimizer_2/" in k for k in want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        g, w = got[k].double().numpy(), w.double().numpy()
        assert np.linalg.norm(g - w) <= 1e-5 * np.linalg.norm(w), (k, np.linalg.norm(g - w) / np.linalg.norm(w))


@pytest.mark.parametrize("name", ["nerf32", "nerf512", "dnerf", "tnerf", "multires", "resume"])
def test_tensor_parallel_cli_matches_one_process(runs, name):
    """The last checkpoint of each leg over the (1, 2) grid against one
    process's (module docstring's bars); ``resume`` resumed one process's
    native step-5 snapshot under tensor parallelism."""
    tmp = runs[0]
    ckpt = {leg[0]: leg[4] for leg in _legs("", "", "")}[name]
    got, want = load_tar(tmp / "rank0" / ckpt), load_tar(tmp / "single" / ckpt)
    assert got["global_step"] == want["global_step"]
    if name != "multires":
        _close(got, want, BARS[name])
        return
    assert dict(_tensors(got)).keys() == dict(_tensors(want)).keys()
    _close({k: v for k, v in got.items() if k.startswith("network_fn_")},
           {k: v for k, v in want.items() if k.startswith("network_fn_")}, BARS[name])
    recs = [[json.loads(line) for line in (tmp / who / "multires" / "metrics.jsonl").read_text().splitlines()
             if "global_loss" in line] for who in ("rank0", "single")]
    assert len(recs[0]) == len(recs[1]) == 4 and recs[0][0]["step"] == 1
    for key in ("global_loss", "total_loss", "loss_layer_0"):
        assert recs[0][0][key] == pytest.approx(recs[1][0][key], rel=2e-2), key
    for a, b in zip(*recs):
        assert a["total_loss"] == pytest.approx(b["total_loss"], rel=0.2), a["step"]


def test_one_process_resumes_a_tensor_parallel_checkpoint(runs):
    """The TP run's step-5 ``.tar`` resumed by one process lands within the
    bar of one process resuming its own step-5 snapshot."""
    tmp = runs[0]
    _close(load_tar(tmp / "single" / "from_tp" / "000010.tar"), load_tar(tmp / "single" / "resume" / "000010.tar"),
           BARS["resume"])


def test_tensor_parallel_checkpoints_have_the_one_process_format(runs):
    """Gathered: the ``.tar`` holds a one-process checkpoint's keys, shapes
    and dtypes (the optimizer's param groups too); the native
    ``.msgpack`` the same tree of keys and shapes; rank 1 wrote nothing."""
    tmp = runs[0]
    for step in ("000005", "000010"):
        got, want = load_tar(tmp / "rank0" / "nerf32" / f"{step}.tar"), load_tar(tmp / "single" / "nerf32" / f"{step}.tar")
        assert [(k, tuple(v.shape), v.dtype) for k, v in _tensors(got)] == \
            [(k, tuple(v.shape), v.dtype) for k, v in _tensors(want)]
        assert got["optimizer_state_dict"]["param_groups"] == want["optimizer_state_dict"]["param_groups"]

        def tree(path):
            def walk(x):
                if isinstance(x, dict):
                    return {k: walk(v) for k, v in x.items()}
                return getattr(x, "shape", x)
            with open(path, "rb") as f:
                return walk(msgpack.unpackb(f.read()))
        assert tree(tmp / "rank0" / "nerf32" / f"{step}.msgpack") == tree(tmp / "single" / "nerf32" / f"{step}.msgpack")
    written = [p for p in (tmp / "rank1").rglob("*") if p.is_file()] if (tmp / "rank1").exists() else []
    assert not [p for p in written if p.suffix in (".tar", ".msgpack", ".png", ".gif", ".mp4", ".jsonl")]


def test_tensor_parallel_render_only_frames_are_bit_equal(runs):
    """--render_only --render_test of the TP run's last checkpoint: every
    rank gathers the whole fields and the two ranks share each frame's
    chunks, so both hold frames equal to one process's render of the same
    checkpoint."""
    _, ranks, ref, _ = runs
    want = ref["render"]["frames"]
    assert len(want) == 2
    for r in range(2):
        got = ranks[r]["render"]["frames"]
        assert len(got) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_tensor_parallel_cli_prints_its_grid_and_takes_the_eager_step(runs):
    """Every leg prints the JAX package's line (MultiRes with its levels),
    trains through the eager step and runs the layers' collectives; the
    test sets rendered during training (W=32, D-NeRF, every MultiRes level)
    from gathered fields have one process's frames' count and shapes."""
    _, ranks, ref, outs = runs
    for name in ("nerf32", "dnerf", "multires"):
        want = ref[name]["frames"]
        assert want and all(len(r[name]["frames"]) == len(want) for r in ranks)
        assert all(a.shape == b.shape and torch.isfinite(a).all() for r in ranks
                   for a, b in zip(r[name]["frames"], want))
    line = "Tensor parallelism: 2-way model sharding x 1-way ray sharding (2 devices)"
    assert outs[0].count(line) == 7  # every leg but --render_only, which cuts nothing
    assert outs[0].count("Tensor parallelism: 2-way model sharding, render only: whole fields over 2 devices") == 1
    assert f"{line}, 3 pyramid levels" in outs[0]
    assert "Using the kernel" not in outs[0] and "Data parallelism" not in outs[0]
    assert all(r[name]["collectives"] > 0 for r in ranks for name in r)


def test_cpu_dry_run_tensor_parallel_2x2(tmp_path):
    """``SWNERF_TENSOR_PARALLEL=2 python -m swnerf_torch.parallel.dryrun
    --ranks 4``: the four trainers at full widths (D=8, W=256; the T-NeRF's
    128) on a 2 x 2 grid of gloo ranks, the resume leg too; the ranks agree
    on every metric and every loss is finite."""
    env = dict(os.environ, SWNERF_TENSOR_PARALLEL="2")
    out = subprocess.run([sys.executable, "-m", "swnerf_torch.parallel.dryrun", "--ranks", "4", "--workdir",
                          str(tmp_path)], cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["ranks"] == 4 and res["tensor_parallel"] == {"rays": 2, "model": 2}
    assert set(res["results"]) == {"run_nerf", "run_nerf[save@2]", "run_nerf[resume@3]", "run_dnerf", "run_tnerf",
                                   "run_multires"}
    logs = "".join(p.read_text() for p in tmp_path.glob("*_rank3.log"))
    assert logs.count("Tensor parallelism: 2-way model sharding x 2-way ray sharding (4 devices)") == 6
