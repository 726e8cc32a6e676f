"""The MultiRes CLI of swnerf_torch on the CPU (``--device cpu``), mirroring
tests/test_multires.py::test_two_phase_train_and_ckpt: both phases, the
per-level ``.tar`` keys (read back by the JAX package's create_multires),
both log phases, the resume, the early exit of a finished run, and the
``--i_testset`` per-level renders and their reconstruction."""

import json

import numpy as np
import pytest

from swnerf_torch.data.synthetic import write_blender_scene
from swnerf_torch.pipelines import run_multires as mr
from swnerf_torch.train.checkpoint import load_tar
from swnerf_torch.utils.png import read_png
from swnerf_tpu.pipelines import run_multires as jmr
from swnerf_tpu.utils.config import config_parser_dnerf as jax_config_parser_dnerf


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("mr_scene") / "dyn"
    write_blender_scene(str(root), n_train=4, n_val=1, n_test=2, size=32, dynamic=True, n_samples=32,
                        device="cpu")
    return root


def _argv(data, logs, *extra):
    return ["--expname", "mr", "--basedir", str(logs), "--datadir", str(data), "--dataset_type", "blender",
            "--white_bkgd", "--use_viewdirs", "--nerf_type", "direct_temporal", "--netdepth", "2",
            "--netwidth", "16", "--N_rand", "16", "--N_samples", "4", "--chunk", "4096", "--testskip", "1",
            "--layer_num", "3", "--global_optimization_epoch", "2", "--i_weights", "4", "--i_print", "2",
            "--i_video", "100000", "--i_img", "100000", "--no_batching", "--device", "cpu", *extra]


def test_two_phase_train_resume_testset_and_early_exit(scene_dir, tmp_path, monkeypatch, capsys):
    logs = tmp_path / "logs"
    monkeypatch.setenv("SWNERF_PHASE1_ITERS", "3")
    monkeypatch.setenv("SWNERF_MAX_ITERS", "5")
    res = mr.train(_argv(scene_dir, logs, "--i_testset", "4"))
    out = capsys.readouterr().out
    assert sorted(res["phase1_loss"]) == [0, 1, 2] and all(len(v) == 2 for v in res["phase1_loss"].values())
    assert np.isfinite(res["metrics"]["global_psnr"]) and res["test_frame_ms"] > 0
    assert res["phase1_step_ms"] == {0: {}, 1: {}, 2: {}} and res["phase2_step_ms"] == {}  # no card: no events

    ckpt = load_tar(str(logs / "mr" / "000004.tar"))
    assert ckpt["global_step"] == 4
    assert set(ckpt) == {"global_step", *(f"{k}_{l}" for k in ("network_fn", "optimizer") for l in range(3))}
    for l in range(3):
        assert "_time_out.weight" in ckpt[f"network_fn_{l}"]
        assert ckpt[f"optimizer_{l}"]["state"][0]["step"] == 3 + 4  # phase 1's updates, then steps 1-4
    # per-level embeddings: level 0 (20, 8, 20) -> 123 position columns, 140 deformation-net inputs
    assert ckpt["network_fn_0"]["_occ.pts_linears.0.weight"].shape[1] == 123
    assert ckpt["network_fn_0"]["_time.0.weight"].shape[1] == 140
    assert ckpt["network_fn_2"]["_occ.pts_linears.0.weight"].shape[1] == 63
    assert ckpt["network_fn_0"]["_occ.views_linears.0.weight"].shape[1] == 16 + 123

    log = (logs / "mr" / "log.txt").read_text()
    assert "[PRETRAIN] Layer 2 Iter: 0" in log and "[PRETRAIN] Layer 0 Iter: 2" in log and "[GLOBAL OPT]" in log
    assert log.index("Layer 2") < log.index("Layer 0")  # coarsest first
    assert "Global PSNR" in out and "Saved test set reconstructed images" in out
    lines = [json.loads(x) for x in (logs / "mr" / "metrics.jsonl").read_text().splitlines()]
    assert any("pretrain_l0_loss" in x for x in lines) and any("global_loss" in x for x in lines)

    # --i_testset 4: each level's renders at its own size, the reconstruction at full size
    test = logs / "mr" / "testset_000004"
    for l, size in enumerate((32, 16, 8)):
        assert read_png(str(test / f"layer_{l}" / "000.png")).shape[:2] == (size, size)
    assert read_png(str(test / "recon_001.png")).shape[:2] == (32, 32)
    assert (logs / "mr" / "pyramid_images" / "image_2_0.png").exists()

    # the JAX package's create_multires resumes from the port's per-level keys
    jargs = jax_config_parser_dnerf().parse_args([a for a in _argv(scene_dir, logs) if a not in ("--device", "cpu")])
    jscene = type("S", (), {"H": 32, "W": 32, "focal": 40.0})()
    _, _, params_all, _, opt_states, _, _, start = jmr.create_multires(jargs, jscene)
    assert start == 4
    w = np.asarray(params_all[0]["coarse"]["canonical"]["pts_linears"][0]["w"])
    np.testing.assert_array_equal(w.T, ckpt["network_fn_0"]["_occ.pts_linears.0.weight"].numpy())

    # resume: from 000004.tar (weights, Adam), phase 1 skipped, step 5 runs
    monkeypatch.setenv("SWNERF_PHASE1_ITERS", "0")
    monkeypatch.setenv("SWNERF_MAX_ITERS", "6")
    res = mr.train(_argv(scene_dir, logs, "--i_testset", "100000"))
    out = capsys.readouterr().out
    assert "Reloading from" in out and "000004.tar" in out
    assert res["phase1_loss"] == {} or all(v == [] for v in res["phase1_loss"].values())
    assert np.isfinite(res["metrics"]["total_loss"])

    # a finished run exits before phase 1 (which would not end here)
    monkeypatch.setenv("SWNERF_PHASE1_ITERS", "100000")
    monkeypatch.setenv("SWNERF_MAX_ITERS", "5")
    res = mr.train(_argv(scene_dir, logs, "--i_testset", "100000"))
    assert "training already complete" in capsys.readouterr().out and res["metrics"] == {}


def test_small_image_clamps_the_patch(tmp_path, monkeypatch, capsys):
    """A 16x16 scene: the 32-pixel base patch is clamped to 16 (the
    reference would slice past the image), and phase 2 runs."""
    data = tmp_path / "dyn16"
    write_blender_scene(str(data), n_train=4, n_val=1, n_test=1, size=16, dynamic=True, n_samples=16, device="cpu")
    monkeypatch.setenv("SWNERF_PHASE1_ITERS", "1")
    monkeypatch.setenv("SWNERF_MAX_ITERS", "3")
    res = mr.train(_argv(data, tmp_path / "logs", "--i_testset", "100000"))
    assert "Patch size clamped to 16 for 16x16 images" in capsys.readouterr().out
    assert np.isfinite(res["metrics"]["total_loss"])


def test_multires_cli_on_cuda_needs_a_card(scene_dir, tmp_path):
    """The default device is cuda; without a card the CLI raises rather
    than fall back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = [a for a in _argv(scene_dir, tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA"):
        mr.train(argv)
