"""The serving slice of swnerf_torch as a whole, against swnerf_tpu on the
CPU: render_image, the real 010000.tar at full width, the weight bridge,
the --render_only CLI, the PNG reader, and the import guard."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swnerf_torch.models import VanillaNeRF, VanillaNeRFConfig
from swnerf_torch.ops.embedding import positional_encoding
from swnerf_torch.pipelines import run_nerf
from swnerf_torch.render.core import Rays, RenderConfig, make_rays_from_camera, render_image
from swnerf_torch.render.fused_eval import make_vanilla_eval_pass
from swnerf_torch.train.checkpoint import load_tar, params_from_jax, vanilla_state_dict
from swnerf_torch.utils.png import read_png, write_png_bytes
from swnerf_tpu.models import VanillaNeRFConfig as JaxConfig
from swnerf_tpu.models import make_vanilla_field
from swnerf_tpu.models.vanilla import apply_vanilla_trunk, init_vanilla_params
from swnerf_tpu.ops.embedding import positional_encoding as jax_pe
from swnerf_tpu.render import RenderConfig as JaxRenderConfig
from swnerf_tpu.render.core import Rays as JaxRays
from swnerf_tpu.render.core import make_rays_from_camera as jax_make_rays
from swnerf_tpu.render.core import render_image as jax_render_image
from swnerf_tpu.train.checkpoint import state_dict_to_params

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SCENE = REPO / "benchmarks" / "full_scale" / "data_nerf_400"
CKPT = REPO / "benchmarks" / "full_scale" / "logs" / "full_nerf_200k" / "010000.tar"
SMALL = dict(netdepth=3, netwidth=128, skips=(1,), multires=4, multires_views=2)


def _jax_params(cfg, seed):
    return jax.tree.map(np.asarray, init_vanilla_params(jax.random.PRNGKey(seed), cfg))


def _port_model(cfg, params):
    model = VanillaNeRF(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model


def _rays(n=100, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = 4.0
    return o, d


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_render_image_matches_jax_eval_pass(white_bkgd):
    """The port's eval pass (plain twins on the CPU, fp32) against the JAX
    eval pass with the Pallas kernels in interpret mode."""
    jcfg, tcfg = JaxConfig(**SMALL), VanillaNeRFConfig(**SMALL)
    pc, pf = _jax_params(jcfg, 0), _jax_params(jcfg, 1)
    o, d = _rays(100)  # chunk 64: a ragged last chunk
    n = o.shape[0]
    jrays = JaxRays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(d), jnp.full((n,), 2.0), jnp.full((n,), 6.0), None)
    jfield = make_vanilla_field(jcfg, fused=False, fused_interpret=True)
    rc = dict(n_samples=8, n_importance=8, white_bkgd=white_bkgd)
    ref = jax_render_image(jfield, pc, jrays, JaxRenderConfig(**rc), chunk=64, fine_params=pf)
    trays = Rays(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(d), torch.full((n,), 2.0),
                 torch.full((n,), 6.0))
    got = render_image(
        _port_model(tcfg, pc), trays, RenderConfig(**rc), chunk=64, fine_model=_port_model(tcfg, pf),
        eval_pass=make_vanilla_eval_pass(tcfg, compute_dtype=torch.float32),
    )
    for k in ("rgb", "disp", "acc", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-5, rtol=5e-4, err_msg=k)


def test_render_rays_plain_path_matches_jax():
    """Without an eval pass render_image goes through the field modules."""
    jcfg, tcfg = JaxConfig(**SMALL), VanillaNeRFConfig(**SMALL)
    pc, pf = _jax_params(jcfg, 2), _jax_params(jcfg, 3)
    o, d = _rays(64, seed=1)
    n = o.shape[0]
    jrays = JaxRays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(d), jnp.full((n,), 2.0), jnp.full((n,), 6.0), None)
    rc = dict(n_samples=16, n_importance=16, white_bkgd=True)
    ref = jax_render_image(make_vanilla_field(jcfg, fused=False), pc, jrays, JaxRenderConfig(**rc), chunk=32,
                           fine_params=pf)
    trays = Rays(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(d), torch.full((n,), 2.0),
                 torch.full((n,), 6.0))
    got = render_image(_port_model(tcfg, pc), trays, RenderConfig(**rc), chunk=32, fine_model=_port_model(tcfg, pf))
    for k in ("rgb", "disp", "acc", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-5, rtol=5e-4, err_msg=k)


def test_full_width_checkpoint_crop_matches_jax():
    """010000.tar (D=8, W=256, 64+128 samples) on a 16x16 crop of test view
    r_0: the JAX jnp path against the port's eval pass in fp32."""
    ckpt = load_tar(str(CKPT))
    with open(SCENE / "transforms_test.json") as f:
        meta = json.load(f)
    c2w = np.array(meta["frames"][0]["transform_matrix"], np.float32)
    H = W = 400
    focal = 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    ys, xs = np.meshgrid(np.arange(192, 208), np.arange(192, 208), indexing="ij")
    sel = (ys * W + xs).reshape(-1)

    jcfg = JaxConfig()
    jfield = make_vanilla_field(jcfg, fused=False)
    template = init_vanilla_params(jax.random.PRNGKey(0), jcfg)
    np_sd = lambda sd: {k: np.asarray(v) for k, v in sd.items()}  # noqa: E731
    jc = state_dict_to_params("vanilla", np_sd(ckpt["network_fn_state_dict"]), template)
    jf = state_dict_to_params("vanilla", np_sd(ckpt["network_fine_state_dict"]), template)
    jr = jax_make_rays(H, W, K, c2w[:3, :4], 2.0, 6.0)
    jr = JaxRays(*(None if x is None else x[sel] for x in jr))
    rc = dict(n_samples=64, n_importance=128, white_bkgd=True)
    ref = jax_render_image(jfield, jc, jr, JaxRenderConfig(**rc), chunk=256, fine_params=jf)

    tcfg = VanillaNeRFConfig()
    model, fine = VanillaNeRF(tcfg, device="cpu"), VanillaNeRF(tcfg, device="cpu")
    model.load_state_dict(vanilla_state_dict(ckpt["network_fn_state_dict"]))
    fine.load_state_dict(vanilla_state_dict(ckpt["network_fine_state_dict"]))
    tr = make_rays_from_camera(H, W, K, c2w[:3, :4], 2.0, 6.0, device="cpu")
    tr = Rays(*(None if x is None else x[torch.from_numpy(sel)] for x in tr))
    got = render_image(model, tr, RenderConfig(**rc), chunk=256, fine_model=fine,
                       eval_pass=make_vanilla_eval_pass(tcfg, compute_dtype=torch.float32))
    assert float(got["acc"].mean()) > 0.5  # the crop sees the object
    for k in ("rgb", "disp", "acc", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-4, err_msg=k)


def test_params_from_jax_round_trip():
    """A JAX-initialised model and the port given its weights return the
    same raw [P, 4] from embedded inputs (apply_vanilla_trunk)."""
    jcfg, tcfg = JaxConfig(), VanillaNeRFConfig()
    params = _jax_params(jcfg, 7)
    rng = np.random.default_rng(7)
    pts = rng.uniform(-2, 2, (64, 3)).astype(np.float32)
    vd = rng.standard_normal((64, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    ref = apply_vanilla_trunk(params, jcfg, jax_pe(jnp.asarray(pts), 10), jax_pe(jnp.asarray(vd), 4))
    model = _port_model(tcfg, params)
    with torch.no_grad():
        got = model.trunk(positional_encoding(torch.from_numpy(pts), 10), positional_encoding(torch.from_numpy(vd), 4))
    assert got.shape == (64, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    assert names[:2] == ["pts_linears.0.weight", "pts_linears.0.bias"]
    assert names[-2:] == ["rgb_linear.weight", "rgb_linear.bias"]


def test_render_only_cli_cpu(tmp_path):
    """run_nerf --render_only --render_test --device cpu on a tiny Blender
    scene and a checkpoint written by the JAX package."""
    from swnerf_tpu.data.synthetic import write_blender_scene
    from swnerf_tpu.train.checkpoint import params_to_state_dict, save_tar
    from swnerf_tpu.utils.metrics import calculate_metrics as jax_metrics

    data, logs = tmp_path / "data", tmp_path / "logs"
    write_blender_scene(str(data), n_train=2, n_val=1, n_test=2, size=16)
    flags = dict(netdepth=6, netwidth=128, skips=(4,), multires=4, multires_views=2)
    jcfg = JaxConfig(**flags)
    pc, pf = _jax_params(jcfg, 0), _jax_params(jcfg, 1)
    save_tar(str(logs / "tiny" / "000100.tar"), {
        "global_step": 100,
        "network_fn_state_dict": params_to_state_dict("vanilla", pc),
        "network_fine_state_dict": params_to_state_dict("vanilla", pf),
    })
    argv = [
        "--expname", "tiny", "--basedir", str(logs), "--datadir", str(data), "--dataset_type", "blender",
        "--white_bkgd", "--use_viewdirs", "--netdepth", "6", "--netwidth", "128", "--netdepth_fine", "6",
        "--netwidth_fine", "128", "--multires", "4", "--multires_views", "2", "--N_samples", "8",
        "--N_importance", "8", "--chunk", "100", "--testskip", "1", "--render_only", "--render_test",
        "--device", "cpu",
    ]
    savedir = Path(run_nerf.main(argv))
    assert savedir == logs / "tiny" / "renderonly_test_000100"
    assert sorted(p.name for p in savedir.glob("*.png")) == ["000.png", "001.png"]
    metrics = json.loads((savedir / "metrics.json").read_text())
    assert len(metrics["psnr"]) == 2 and np.isfinite(metrics["psnr"]).all() and np.isfinite(metrics["ssim"]).all()
    assert metrics["lpips"] == [None, None] and len(metrics["seconds_per_frame"]) == 2

    # The same frames rendered by the JAX package score the same PSNR.
    from swnerf_tpu.data.blender import load_blender_data

    imgs, poses, _, (H, W, focal), (_, _, i_test) = load_blender_data(str(data), False, 1)
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    field = make_vanilla_field(jcfg, fused=False)
    for k, i in enumerate(i_test):
        rays = jax_make_rays(H, W, K, poses[i][:3, :4], 2.0, 6.0)
        out = jax_render_image(field, pc, rays, JaxRenderConfig(n_samples=8, n_importance=8, white_bkgd=True),
                               chunk=100, fine_params=pf)
        gt = imgs[i][..., :3] * imgs[i][..., 3:] + (1.0 - imgs[i][..., 3:])
        psnr = jax_metrics(gt, np.asarray(out["rgb"]).reshape(H, W, 3))[0]
        assert abs(psnr - metrics["psnr"][k]) < 1e-3
        png = read_png(str(savedir / f"{k:03d}.png"))
        assert png.shape == (16, 16, 3)


def test_device_default_is_cuda():
    from swnerf_torch.device import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device()
        with pytest.raises(RuntimeError, match="CUDA"):
            VanillaNeRF(VanillaNeRFConfig(**SMALL))
        with pytest.raises(RuntimeError, match="CUDA"):
            make_rays_from_camera(2, 2, 1.0, np.eye(4, dtype=np.float32)[:3], 2.0, 6.0)
        with pytest.raises(RuntimeError, match="CUDA"):
            run_nerf.main(["--render_only"])


@pytest.mark.parametrize("split", ["test", "train", "val"])
def test_png_reader_matches_imageio(split):
    import imageio.v2 as imageio

    path = SCENE / split / "r_0.png"
    got = read_png(str(path))
    assert got.shape == (400, 400, 4) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, imageio.imread(str(path)))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_write_read_round_trip(tmp_path, channels):
    import imageio.v2 as imageio

    img = np.random.default_rng(channels).integers(0, 256, (9, 13, channels), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png_bytes(path, img)
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(np.asarray(imageio.imread(path)).reshape(img.shape), img)


def _port_files():
    return sorted((REPO / "swnerf_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_import_guard_ast():
    """No module of swnerf_torch, and not chip_smoke.py, imports jax or
    swnerf_tpu."""
    banned = ("jax", "jaxlib", "swnerf_tpu", "flax", "optax")
    for path in _port_files():
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: imports {name}"


def test_import_guard_runtime():
    """Every module of the package imports with jax blocked."""
    mods = [
        ".".join(p.relative_to(REPO).with_suffix("").parts).replace(".__init__", "")
        for p in sorted((REPO / "swnerf_torch").rglob("*.py"))
    ]
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'jaxlib', 'swnerf_tpu'): sys.modules[m] = None\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
