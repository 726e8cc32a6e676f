"""The T-NeRF entry points of swnerf_torch against swnerf_tpu on the CPU:
the dnerf config parser, the dynamic Blender loader, the scene writer, the
time-curriculum sampler and the time step's rays, and the ``run_tnerf`` CLI
(training, resuming, the ``.tar`` bridge both ways, ``--render_only``)."""

import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swnerf_torch.data.blender import load_blender_dynamic_data
from swnerf_torch.data.synthetic import write_blender_scene
from swnerf_torch.pipelines import run_tnerf
from swnerf_torch.pipelines.common import ImageSampler, Scene, load_scene, make_time_image_step
from swnerf_torch.render.core import RenderConfig
from swnerf_torch.train.checkpoint import load_tar
from swnerf_torch.utils.config import config_parser_dnerf
from swnerf_torch.utils.png import read_png
from swnerf_tpu.data.blender import load_blender_dynamic_data as jax_load_dynamic
from swnerf_tpu.data.synthetic import write_blender_scene as jax_write_blender_scene
from swnerf_tpu.pipelines import run_tnerf as jax_run_tnerf
from swnerf_tpu.pipelines.common import ImageSampler as JaxImageSampler
from swnerf_tpu.pipelines.common import Scene as JaxScene
from swnerf_tpu.pipelines.common import load_scene as jax_load_scene
from swnerf_tpu.pipelines.common import make_time_image_step as jax_make_time_image_step
from swnerf_tpu.render import RenderConfig as JaxRenderConfig
from swnerf_tpu.train import checkpoint as jck
from swnerf_tpu.utils.config import config_parser_dnerf as jax_config_parser_dnerf

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "benchmarks" / "round5_artifacts" / "full_tnerf_800k" / "config.txt"


@pytest.fixture(scope="module")
def jax_scene(tmp_path_factory):
    """A 16x16 dynamic textured scene written by the JAX package's writer."""
    root = tmp_path_factory.mktemp("dyn") / "data"
    jax_write_blender_scene(str(root), n_train=4, n_val=2, n_test=3, size=16, dynamic=True, scene="textured")
    return root


def test_config_parser_dnerf_reads_the_round5_config():
    """The round-5 T-NeRF config parses unchanged, to the JAX parser's
    values for every flag the two share, and --device defaults to cuda."""
    argv = ["--config", str(CONFIG)]
    ours, ref = vars(config_parser_dnerf().parse_args(argv)), vars(jax_config_parser_dnerf().parse_args(argv))
    shared = set(ours) & set(ref)
    assert {"nerf_type", "N_iter", "precrop_iters_time", "add_tv_loss", "tv_loss_weight", "do_half_precision",
            "not_zero_canonical", "use_two_models_for_fine"} <= shared
    assert {k: ours[k] for k in shared} == {k: ref[k] for k in shared}
    assert set(ours) - set(ref) == {"device"} and ours["device"] == "cuda"
    assert ours["nerf_type"] == "direct_temporal" and ours["N_iter"] == 800000 and ours["N_rand"] == 500


def test_dynamic_loader_matches_jax(jax_scene):
    """Images, poses, times, render poses and times, hwf and the splits of
    the JAX loader; and load_scene's --render_test times."""
    ours, ref = load_blender_dynamic_data(str(jax_scene), testskip=1), jax_load_dynamic(str(jax_scene), testskip=1)
    for a, b in zip(ours[:5], ref[:5]):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert [float(x) for x in ours[5]] == [float(x) for x in ref[5]]
    for a, b in zip(ours[6], ref[6]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours[2], np.array([0, 1 / 3, 2 / 3, 1, 0, 1, 0, 0.5, 1], np.float32))
    assert ours[4].shape == (40,) and ours[4][-1] == 1.0

    argv = ["--datadir", str(jax_scene), "--white_bkgd", "--testskip", "1", "--render_test"]
    args, jargs = config_parser_dnerf().parse_args(argv), jax_config_parser_dnerf().parse_args(argv)
    args.dataset_type = jargs.dataset_type = "blender_dnerf"
    scene, jscene = load_scene(args), jax_load_scene(jargs)
    np.testing.assert_array_equal(scene.images, jscene.images)
    np.testing.assert_array_equal(scene.render_poses, jscene.render_poses)
    np.testing.assert_array_equal(scene.times, jscene.times)
    np.testing.assert_array_equal(scene.render_times, jscene.render_times)
    np.testing.assert_array_equal(scene.render_times, scene.times[scene.i_test])


def test_dynamic_loader_applies_testskip_to_every_split(jax_scene, tmp_path):
    """testskip strides the train split too (the reference's quirk), each
    split's times start at 0, and a split whose first time is not 0 is
    refused."""
    _, _, times, _, _, _, (i_train, i_val, i_test) = load_blender_dynamic_data(str(jax_scene), testskip=2)
    assert (len(i_train), len(i_val), len(i_test)) == (2, 1, 2)
    np.testing.assert_array_equal(times, np.array([0, 2 / 3, 0, 0, 1], np.float32))
    shutil.copytree(jax_scene, tmp_path / "data")
    meta = json.loads((tmp_path / "data" / "transforms_val.json").read_text())
    meta["frames"] = [dict(f, time=0.5) for f in meta["frames"]]
    (tmp_path / "data" / "transforms_val.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="start at 0"):
        load_blender_dynamic_data(str(tmp_path / "data"), testskip=1)


def test_scene_writer_matches_jax(jax_scene, tmp_path):
    """The port's writer (torch, CPU) against the JAX writer at 16x16, both
    dynamic textured scenes of 4/2/3 views: identical JSON (poses drawn from
    the same numpy stream, times, camera angle) and decoded PNGs that differ
    by at most one 8-bit level, on at most 1% of the values (measured: 3 of
    6,912 rgb values, 0.043%, where float rounding crosses a level; 0.18% of
    a 32x32 scene of 22 views)."""
    write_blender_scene(str(tmp_path), n_train=4, n_val=2, n_test=3, size=16, dynamic=True, scene="textured",
                        device="cpu")
    diffs = []
    for split in ("train", "val", "test"):
        ours = json.loads((tmp_path / f"transforms_{split}.json").read_text())
        ref = json.loads((jax_scene / f"transforms_{split}.json").read_text())
        assert ours == ref
        for frame in ref["frames"]:
            a = read_png(str(tmp_path / (frame["file_path"] + ".png"))).astype(np.int16)
            b = read_png(str(jax_scene / (frame["file_path"] + ".png"))).astype(np.int16)
            assert a.shape == b.shape == (16, 16, 4)
            diffs.append(np.abs(a - b)[..., :3])
    diffs = np.concatenate([d.reshape(-1) for d in diffs])
    assert diffs.max() <= 1
    assert (diffs > 0).mean() <= 0.01


def _tiny_scene(n_train=6, size=12):
    rng = np.random.default_rng(0)
    poses = np.stack([np.eye(4, dtype=np.float32) for _ in range(n_train + 1)])
    poses[:, :3, 3] = rng.standard_normal((n_train + 1, 3))
    images = rng.uniform(0, 1, (n_train + 1, size, size, 3)).astype(np.float32)
    times = np.linspace(0, 1, n_train + 1).astype(np.float32)
    K = np.array([[10.0, 0, 0.5 * size], [0, 10.0, 0.5 * size], [0, 0, 1]])
    kw = dict(images=images, poses=poses, render_poses=poses, H=size, W=size, focal=10.0, K=K, near=2.0, far=6.0,
              i_train=np.arange(n_train), i_val=np.array([n_train]), i_test=np.array([n_train]))
    return Scene(**kw, times=times), JaxScene(**kw), times


def test_image_sampler_time_curriculum_matches_jax():
    """With precrop_iters_time the reachable frames grow linearly, drawn as
    the JAX sampler draws them (seed 0), then the whole train split."""
    scene, jscene, _ = _tiny_scene()
    ours = ImageSampler(scene, 20, 2, 0.5, precrop_iters_time=6)
    ref = JaxImageSampler(jscene, 20, 2, 0.5, precrop_iters_time=6)
    picks = []
    for step in range(1, 10):
        (a, pa), (b, pb) = ours.next(step), ref.next(step)
        assert a == b and np.array_equal(pa, pb)
        picks.append(a)
    assert max(picks[:2]) <= 2


def test_time_step_rays_match_jax():
    """make_time_image_step hands the train step JAX's rays, target and
    per-ray frame time [N, 1]."""
    scene, jscene, times = _tiny_scene(size=16)
    pixels = np.random.default_rng(1).integers(0, 16, (40, 2))
    got, ref = {}, {}

    def grab(store):
        def step(state, rays, target, rng):
            store.update(rays=rays, target=target)
            return state, {}
        return step

    make_time_image_step(lambda s, r, t, g: grab(got)(s, r, t, g), RenderConfig(), scene)(
        None, torch.from_numpy(scene.images), torch.from_numpy(scene.poses[:, :3, :4]), torch.from_numpy(times), 3,
        pixels)
    jax_make_time_image_step(grab(ref), JaxRenderConfig(), jscene).__wrapped__(
        None, jnp.asarray(jscene.images), jnp.asarray(jscene.poses), jnp.asarray(times), 3, jnp.asarray(pixels),
        0.0, None)
    np.testing.assert_allclose(got["target"].numpy(), np.asarray(ref["target"]))
    for a, b in zip(got["rays"], ref["rays"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    assert got["rays"].times.shape == (40, 1) and float(got["rays"].times[0, 0]) == float(times[3])


def _argv(data, logs):
    return [
        "--expname", "t", "--basedir", str(logs), "--datadir", str(data), "--dataset_type", "blender",
        "--nerf_type", "direct_temporal", "--white_bkgd", "--use_viewdirs", "--netdepth", "8",
        "--multires", "4", "--multires_views", "2", "--N_rand", "32", "--N_samples", "8", "--chunk", "128",
        "--i_weights", "20", "--i_print", "10", "--i_video", "100000", "--i_testset", "20", "--testskip", "1",
        "--raw_noise_std", "1", "--lrate", "5e-3",
    ]


def test_tnerf_cli_cpu_trains_resumes_and_serves(jax_scene, tmp_path, monkeypatch, capsys):
    """run_tnerf --device cpu on the 16x16 dynamic scene: 20 kernel steps
    (B4's twin) save 000020.tar (three keys) and metrics.jsonl and render
    the test set; a second run resumes at 20 on the eager step
    (SWNERF_FUSED_STEP=0) and reaches 30; the JAX package's run_tnerf loads
    the port's .tar with its Adam count, and the port loads a .tar the JAX
    package wrote; --render_only --render_test writes a frame per test view
    and metrics.json."""
    logs = tmp_path / "logs"
    argv = _argv(jax_scene, logs) + ["--device", "cpu"]
    monkeypatch.setenv("SWNERF_MAX_ITERS", "21")
    res = run_tnerf.main(argv)
    out = capsys.readouterr().out
    assert "kernel T-NeRF train step" in out
    exp = logs / "t"
    ckpt = load_tar(str(exp / "000020.tar"))
    assert set(ckpt) == {"global_step", "network_fn_state_dict", "optimizer_state_dict"}
    assert ckpt["global_step"] == 20
    assert all(int(e["step"]) == 20 for e in ckpt["optimizer_state_dict"]["state"].values())
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if "loss" in r] == [10, 20]
    assert np.isfinite(list(res["metrics"].values())).all()
    assert sorted(p.name for p in (exp / "testset_000020").glob("*.png")) == ["000.png", "001.png", "002.png"]

    monkeypatch.setenv("SWNERF_MAX_ITERS", "31")
    monkeypatch.setenv("SWNERF_FUSED_STEP", "0")
    run_tnerf.main(argv)
    out = capsys.readouterr().out
    assert f"Reloading from {exp / '000020.tar'}" in out and "Iter: 30 " in out and "Iter: 20 " not in out
    assert "eager autograd train step" in out

    # JAX's run_tnerf resumes from the port's checkpoint ...
    jargs = jax_config_parser_dnerf().parse_args(_argv(jax_scene, logs) + ["--ft_path", str(exp / "000020.tar")])
    _, _, _, jstate, start, _ = jax_run_tnerf.create_tnerf(jargs)
    assert start == 20 and int(jstate.step) == 20
    got = jck.params_to_state_dict("tnerf", jstate.params["coarse"])
    for k, v in ckpt["network_fn_state_dict"].items():
        np.testing.assert_array_equal(got[k], v.numpy())
    # ... and writes one the port resumes from.
    jargs.expname = "j"
    (logs / "j").mkdir()
    jax_run_tnerf.save_tnerf_ckpt(jargs, jstate, 20)
    state, _, _, _ = run_tnerf.create_tnerf(config_parser_dnerf().parse_args(
        _argv(jax_scene, logs)[2:] + ["--expname", "j", "--device", "cpu"]), torch.device("cpu"))
    assert state.step == 20
    for k, v in state.coarse.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), got[k])
    assert all(int(e["step"]) == 20 for e in state.optimizer.state_dict()["state"].values())

    savedir = Path(run_tnerf.main(argv + ["--render_only", "--render_test"]))
    assert savedir.name == "renderonly_test_000020"  # the newest .tar
    assert sorted(p.name for p in savedir.glob("*.png")) == ["000.png", "001.png", "002.png"]
    metrics = json.loads((savedir / "metrics.json").read_text())
    assert len(metrics["psnr"]) == 3 and np.isfinite(metrics["psnr"]).all()


def test_tnerf_cli_on_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_tnerf.main(["--datadir", str(REPO), "--dataset_type", "blender"])
