"""The D-NeRF entry points of swnerf_torch against swnerf_tpu on the CPU:
the dnerf config parser on the round-5 D-NeRF config, the time step's rays
with the TV loss's neighbour time, and the ``run_dnerf`` CLI (the kernel
step on the twins, resuming on the eager step, the ``.tar`` bridge both
ways, two models, ``--nerf_type original``, ``--render_only``)."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swnerf_torch.pipelines import run_dnerf
from swnerf_torch.pipelines.common import Scene, make_time_image_step
from swnerf_torch.render.core import RenderConfig
from swnerf_torch.train.checkpoint import load_tar
from swnerf_torch.utils.config import config_parser_dnerf
from swnerf_tpu.data.synthetic import write_blender_scene as jax_write_blender_scene
from swnerf_tpu.pipelines import run_dnerf as jax_run_dnerf
from swnerf_tpu.pipelines.common import Scene as JaxScene
from swnerf_tpu.pipelines.common import make_time_image_step as jax_make_time_image_step
from swnerf_tpu.render import RenderConfig as JaxRenderConfig
from swnerf_tpu.train import checkpoint as jck
from swnerf_tpu.utils.config import config_parser_dnerf as jax_config_parser_dnerf

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "benchmarks" / "round5_artifacts" / "full_dnerf_800k" / "config.txt"


@pytest.fixture(scope="module")
def jax_scene(tmp_path_factory):
    """A 16x16 dynamic textured scene written by the JAX package's writer."""
    root = tmp_path_factory.mktemp("dyn") / "data"
    jax_write_blender_scene(str(root), n_train=4, n_val=2, n_test=3, size=16, dynamic=True, scene="textured")
    return root


def test_config_parser_dnerf_reads_the_round5_dnerf_config():
    """Every key of the round-5 D-NeRF config.txt is a flag of the port's
    parser, and the parsed values equal the JAX parser's for every flag the
    two share."""
    keys = {line.split("=")[0].strip() for line in CONFIG.read_text().splitlines() if "=" in line}
    argv = ["--config", str(CONFIG)]
    ours, ref = vars(config_parser_dnerf().parse_args(argv)), vars(jax_config_parser_dnerf().parse_args(argv))
    assert keys <= set(ours), keys - set(ours)
    shared = set(ours) & set(ref)
    assert keys <= shared and {k: ours[k] for k in shared} == {k: ref[k] for k in shared}
    assert ours["nerf_type"] == "direct_temporal" and ours["add_tv_loss"] and ours["tv_loss_weight"] == 1e-4
    assert (ours["N_rand"], ours["N_samples"], ours["N_importance"], ours["raw_noise_std"]) == (500, 64, 128, 1.0)
    assert not ours["use_two_models_for_fine"] and ours["device"] == "cuda"


def test_time_step_forwards_the_neighbor_time():
    """make_time_image_step(pass_neighbor=True) hands the train step JAX's
    rays, target and per-ray frame time, and the TV loss's neighbour time."""
    rng = np.random.default_rng(0)
    n, size = 5, 16
    poses = np.stack([np.eye(4, dtype=np.float32) for _ in range(n)])
    poses[:, :3, 3] = rng.standard_normal((n, 3))
    images = rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)
    times = np.linspace(0, 1, n).astype(np.float32)
    K = np.array([[10.0, 0, 0.5 * size], [0, 10.0, 0.5 * size], [0, 0, 1]])
    kw = dict(images=images, poses=poses, render_poses=poses, H=size, W=size, focal=10.0, K=K, near=2.0, far=6.0,
              i_train=np.arange(n), i_val=np.arange(0), i_test=np.arange(0))
    scene, jscene = Scene(**kw, times=times), JaxScene(**kw)
    pixels = rng.integers(0, size, (30, 2))
    got, ref = {}, {}

    def grab(store):
        def step(state, rays, target, neighbor_time, rng):
            store.update(rays=rays, target=target, neighbor_time=float(neighbor_time))
            return state, {}
        return step

    make_time_image_step(grab(got), RenderConfig(), scene, pass_neighbor=True)(
        None, torch.from_numpy(images), torch.from_numpy(poses[:, :3, :4]), torch.from_numpy(times), 2, pixels,
        0.3125)
    jax_make_time_image_step(grab(ref), JaxRenderConfig(), jscene, pass_neighbor=True).__wrapped__(
        None, jnp.asarray(images), jnp.asarray(poses), jnp.asarray(times), 2, jnp.asarray(pixels), 0.3125, None)
    np.testing.assert_allclose(got["target"].numpy(), np.asarray(ref["target"]))
    for a, b in zip(got["rays"], ref["rays"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    assert got["neighbor_time"] == ref["neighbor_time"] == 0.3125
    assert float(got["rays"].times[0, 0]) == float(times[2])


def _argv(data, logs, *extra):
    return [
        "--expname", "d", "--basedir", str(logs), "--datadir", str(data), "--dataset_type", "blender",
        "--nerf_type", "direct_temporal", "--white_bkgd", "--use_viewdirs", "--netdepth", "6", "--netwidth", "128",
        "--netdepth_fine", "6", "--netwidth_fine", "128", "--multires", "4", "--multires_views", "2",
        "--N_rand", "16", "--N_samples", "8", "--N_importance", "8", "--chunk", "64", "--i_weights", "10",
        "--i_print", "5", "--i_video", "100000", "--i_testset", "10", "--testskip", "1", "--raw_noise_std", "1",
        "--add_tv_loss", "--tv_loss_weight", "1e-2", "--lrate", "5e-3", *extra,
    ]


def test_dnerf_cli_cpu_trains_resumes_and_serves(jax_scene, tmp_path, monkeypatch, capsys):
    """run_dnerf --device cpu on the 16x16 dynamic scene: 10 kernel steps (the
    twins of B6, B3's pts mode, B5 and B2; TV on) save 000010.tar (three
    keys, Adam at 10) and metrics.jsonl with the TV term, and render the test
    set; a second run resumes at 10 on the eager step (SWNERF_FUSED_STEP=0)
    and reaches 15; the JAX package's run_dnerf loads the port's .tar with
    its Adam count, and the port loads a .tar the JAX package wrote;
    --render_only --render_test writes a frame per test view and
    metrics.json."""
    logs = tmp_path / "logs"
    argv = _argv(jax_scene, logs, "--device", "cpu")
    monkeypatch.setenv("SWNERF_MAX_ITERS", "11")
    res = run_dnerf.main(argv)
    out = capsys.readouterr().out
    assert "kernel D-NeRF train step" in out and "TV:" in out
    exp = logs / "d"
    ckpt = load_tar(str(exp / "000010.tar"))
    assert set(ckpt) == {"global_step", "network_fn_state_dict", "optimizer_state_dict"}
    assert ckpt["global_step"] == 10 and len(ckpt["network_fn_state_dict"]) == 2 * (6 + 4 + 6 + 1)
    assert all(int(e["step"]) == 10 for e in ckpt["optimizer_state_dict"]["state"].values())
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if "loss" in r] == [5, 10] and all("tv" in r for r in recs if "loss" in r)
    assert np.isfinite(list(res["metrics"].values())).all()
    assert sorted(p.name for p in (exp / "testset_000010").glob("*.png")) == ["000.png", "001.png", "002.png"]

    monkeypatch.setenv("SWNERF_MAX_ITERS", "16")
    monkeypatch.setenv("SWNERF_FUSED_STEP", "0")
    run_dnerf.main(argv)
    out = capsys.readouterr().out
    assert f"Reloading from {exp / '000010.tar'}" in out and "Iter: 15 " in out and "Iter: 10 " not in out
    assert "eager autograd train step" in out

    # JAX's run_dnerf resumes from the port's checkpoint ...
    jargs = jax_config_parser_dnerf().parse_args(_argv(jax_scene, logs, "--ft_path", str(exp / "000010.tar")))
    *_, jstate, start, _ = jax_run_dnerf.create_dnerf(jargs)
    assert start == 10
    got = jck.params_to_state_dict("direct_temporal", jstate.params["coarse"])
    assert list(got) == list(ckpt["network_fn_state_dict"])
    for k, v in ckpt["network_fn_state_dict"].items():
        np.testing.assert_array_equal(got[k], v.numpy())
    # ... and writes one the port resumes from.
    jargs.expname = "j"
    (logs / "j").mkdir()
    jax_run_dnerf.save_dnerf_ckpt(jargs, "direct_temporal", jstate, 10)
    state, *_ = run_dnerf.create_dnerf(config_parser_dnerf().parse_args(
        _argv(jax_scene, logs, "--device", "cpu")[2:] + ["--expname", "j"]), torch.device("cpu"))
    assert state.step == 10
    for k, v in state.coarse.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), got[k])
    assert all(int(e["step"]) == 10 for e in state.optimizer.state_dict()["state"].values())

    savedir = Path(run_dnerf.main(argv + ["--render_only", "--render_test"]))
    assert savedir.name == "renderonly_test_000010"  # the newest .tar (the resumed run saved none)
    assert sorted(p.name for p in savedir.glob("*.png")) == ["000.png", "001.png", "002.png"]
    metrics = json.loads((savedir / "metrics.json").read_text())
    assert len(metrics["psnr"]) == 3 and np.isfinite(metrics["psnr"]).all()


@pytest.mark.parametrize("kind", ["two_models", "original"])
def test_dnerf_cli_cpu_two_models_and_original(jax_scene, tmp_path, monkeypatch, capsys, kind):
    """--use_two_models_for_fine trains both models on the kernel step and
    writes the fine dict (checkpoint.py:8), which the JAX package reads;
    --nerf_type original (NeRFOriginal, dx = 0) trains on the eager step and
    renders through the plain path."""
    logs = tmp_path / "logs"
    extra = ["--use_two_models_for_fine"] if kind == "two_models" else ["--nerf_type", "original"]
    argv = _argv(jax_scene, logs, "--device", "cpu", "--i_testset", "100000", *extra)
    monkeypatch.setenv("SWNERF_MAX_ITERS", "11")
    res = run_dnerf.main(argv)
    out = capsys.readouterr().out
    assert np.isfinite(list(res["metrics"].values())).all()
    ckpt = load_tar(str(logs / "d" / "000010.tar"))
    if kind == "two_models":
        assert "kernel D-NeRF train step" in out and "psnr0" in res["metrics"]
        assert set(ckpt) == {"global_step", "network_fn_state_dict", "network_fine_state_dict",
                             "optimizer_state_dict"}
        assert len(ckpt["optimizer_state_dict"]["state"]) == 2 * len(ckpt["network_fn_state_dict"])
        jargs = jax_config_parser_dnerf().parse_args(_argv(jax_scene, logs, *extra))
        *_, jstate, start, _ = jax_run_dnerf.create_dnerf(jargs)
        got = jck.params_to_state_dict("direct_temporal", jstate.params["fine"])
        assert start == 10
        for k, v in ckpt["network_fine_state_dict"].items():
            np.testing.assert_array_equal(got[k], v.numpy())
    else:
        assert "eager autograd train step" in out
        assert not any(k.startswith("_time") for k in ckpt["network_fn_state_dict"])
        state, _, eval_pass, _ = run_dnerf.create_dnerf(config_parser_dnerf().parse_args(argv), torch.device("cpu"))
        assert eval_pass is None and state.step == 10
        savedir = Path(run_dnerf.main(argv + ["--render_only", "--render_test"]))
        assert len(json.loads((savedir / "metrics.json").read_text())["psnr"]) == 3


def test_dnerf_cli_on_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_dnerf.main(["--datadir", str(REPO), "--dataset_type", "blender"])
