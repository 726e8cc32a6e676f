"""The forward-facing LLFF slice of swnerf_torch as a whole, against
swnerf_tpu on the CPU, on a small capture (12 x 12, 6 images, llffhold 3):
the ray pool and its NDC rays, one pool step of the kernel route (B1, B2,
B1 on their plain twins) against the JAX fused step with the Pallas
kernels in interpret mode, a whole NDC frame through ``render_image``
against the JAX render, the spiral path at a render factor, and the
training and serving CLI end to end.

Every draw is passed in: the port's step takes the JAX step's jitter,
density noise and importance uniforms, rebuilt from its key schedule.
Bars: rays rtol / atol 1e-6; the step's metrics rel 1e-5 and each gradient
tensor within ``1e-4 * max|g_ref| + 1e-7`` (the bars of
tests/test_torch_train_kernels.py and tests/test_torch_train.py for
Blender rays); renders atol 1e-5, rtol 5e-4 (tests/test_torch_render.py)."""

import argparse
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from swnerf_torch.data.synthetic import write_llff_scene
from swnerf_torch.models import VanillaNeRF, VanillaNeRFConfig
from swnerf_torch.pipelines import run_nerf
from swnerf_torch.pipelines.common import RayPoolSampler, load_scene, make_pool_step, render_path
from swnerf_torch.render.core import Draws, RenderConfig, build_rays, make_rays_from_camera, render_image
from swnerf_torch.render.fused_eval import make_vanilla_eval_pass
from swnerf_torch.train.checkpoint import params_from_jax
from swnerf_torch.train.fused_step import make_fused_train_step
from swnerf_torch.train.loop import init_train_state
from swnerf_tpu.models import VanillaNeRFConfig as JaxConfig
from swnerf_tpu.models import make_vanilla_field
from swnerf_tpu.models.vanilla import init_vanilla_params
from swnerf_tpu.pipelines.common import RayPoolSampler as JaxRayPoolSampler
from swnerf_tpu.pipelines.common import load_scene as jax_load_scene
from swnerf_tpu.pipelines.common import render_path as jax_render_path
from swnerf_tpu.render import RenderConfig as JaxRenderConfig
from swnerf_tpu.render.core import build_rays as jax_build_rays
from swnerf_tpu.render.core import make_rays_from_camera as jax_make_rays
from swnerf_tpu.render.core import render_image as jax_render_image
from swnerf_tpu.train.fused_step import make_fused_train_step as jax_make_fused_train_step
from swnerf_tpu.train.loop import init_train_state as jax_init_train_state

torch.set_num_threads(2)

SMALL = dict(netdepth=3, netwidth=128, skips=(1,), multires=4, multires_views=2)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """A 12 x 12, 6-image capture written by the port's writer, and both
    packages' Scenes of it (NDC, llffhold 3: test views 0 and 3)."""
    root = tmp_path_factory.mktemp("llff")
    write_llff_scene(str(root), n_images=6, size=12, n_samples=32, device="cpu")
    args = argparse.Namespace(dataset_type="llff", datadir=str(root), factor=1, spherify=False, llffhold=3,
                              no_ndc=False, render_test=False)
    return root, load_scene(args), jax_load_scene(args)


def _params(seed):
    return jax.tree.map(np.asarray, init_vanilla_params(jax.random.PRNGKey(seed), JaxConfig(**SMALL)))


def _model(params):
    model = VanillaNeRF(VanillaNeRFConfig(**SMALL), device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model


def test_ray_pool_matches_jax(capture):
    """The pool of the 4 train views (raw origins, directions and colours)
    and its epoch-shuffled indices, past the reshuffle."""
    _, scene, jscene = capture
    assert scene.ndc and (scene.near, scene.far) == (0.0, 1.0) and list(scene.i_test) == [0, 3]
    ours, ref = RayPoolSampler(scene, 100, "cpu"), JaxRayPoolSampler(jscene, 100)
    np.testing.assert_array_equal(ours.pool.numpy(), np.asarray(ref.pool))
    for _ in range(8):  # 576 rays: the reshuffle at the sixth draw
        assert np.array_equal(ours.next_indices(), ref.next_indices())


@pytest.mark.parametrize("use_viewdirs", [True, False])
def test_build_rays_ndc_matches_jax(capture, use_viewdirs):
    """NDC projection of pool rays: origins on the near plane, z in [-1, 1),
    viewdirs from the directions before the projection."""
    _, scene, _ = capture
    pool = RayPoolSampler(scene, 100, "cpu").pool
    o, d = pool[:, 0], pool[:, 1]
    kw = dict(use_viewdirs=use_viewdirs, ndc=True, H=scene.H, W=scene.W, focal=scene.focal)
    got = build_rays(o, d, 0.0, 1.0, **kw)
    ref = jax_build_rays(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), 0.0, 1.0, **kw)
    for a, b in zip(got[:5], ref[:5]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.origins[:, 2].numpy(), -1.0, atol=1e-6)


def _jax_draws(rcfg, n, key):
    """The JAX fused step's draws from its key schedule: fold_in(key, 0),
    split 4 (train/fused_step.py:179-181 there)."""
    k_jit, k_noise0, k_pdf, k_noise1 = jax.random.split(jax.random.fold_in(key, 0), 4)
    nc, nf = rcfg.n_samples, rcfg.n_importance
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return Draws(
        t_rand=t(jax.random.uniform(k_jit, (n, nc))),
        noise0=t(jax.random.normal(k_noise0, (n, nc)) * rcfg.raw_noise_std),
        u=t(jax.random.uniform(k_pdf, (n, nf))),
        noise1=t(jax.random.normal(k_noise1, (n, nc + nf)) * rcfg.raw_noise_std),
    )


@pytest.mark.parametrize("seed", [3, 11])
def test_pool_kernel_step_matches_jax_fused_step(capture, seed):
    """One pool step of the port's kernel route (the pool gather, NDC rays,
    B1 coarse, B2 + the sorted union, B1 fine on their fp32 twins) against
    the JAX fused step (Pallas in interpret mode, fp32) on the same pool
    rows, jittered depths and density noise of std 1 (the fern config's
    raw_noise_std): metrics and every gradient before Adam."""
    _, scene, jscene = capture
    rc = dict(n_samples=8, n_importance=8, perturb=1.0, raw_noise_std=1.0, white_bkgd=False)
    rcfg, jrc = RenderConfig(**rc), JaxRenderConfig(**rc)
    n = 32
    idx = RayPoolSampler(scene, n, "cpu").next_indices()
    pool = RayPoolSampler(scene, n, "cpu").pool
    pc, pf = _params(0), _params(1)
    key = jax.random.PRNGKey(seed)

    stash = optax.GradientTransformation(  # its state is the last gradient
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    jcfg = JaxConfig(**SMALL)
    jstep = jax_make_fused_train_step(jcfg, jrc, stash, fcfg=jcfg, interpret=True, compute_dtype=jnp.float32)
    batch = np.asarray(JaxRayPoolSampler(jscene, n).pool)[idx]
    jrays = jax_build_rays(jnp.asarray(batch[:, 0]), jnp.asarray(batch[:, 1]), 0.0, 1.0, ndc=True, H=scene.H,
                           W=scene.W, focal=scene.focal)
    s_ref, m_ref = jstep(jax_init_train_state({"coarse": pc, "fine": pf}, stash), jrays, jnp.asarray(batch[:, 2]),
                         key)
    ref = {f"{net}.{k}": v.numpy() for net in ("coarse", "fine")
           for k, v in params_from_jax(jax.tree.map(np.asarray, s_ref.opt_state[net])).items()}

    cfg = VanillaNeRFConfig(**SMALL)
    draws = _jax_draws(rcfg, n, key)
    fused = make_fused_train_step(cfg, rcfg, fcfg=cfg)
    step = make_pool_step(lambda st, rays, target, generator=None: fused(st, rays, target, draws=draws), rcfg, scene)
    state = init_train_state(_model(pc), _model(pf), 5e-4, 250)
    m = step(state, pool, idx)
    got = {f"{net}.{k}": p.grad.numpy() for net, mod in (("coarse", state.coarse), ("fine", state.fine))
           for k, p in mod.named_parameters()}
    assert set(got) == set(ref)
    for k, r in ref.items():
        assert np.abs(got[k] - r).max() <= 1e-4 * np.abs(r).max() + 1e-7, k
    assert set(m) == set(m_ref)
    for k in m_ref:
        assert float(m[k]) == pytest.approx(float(m_ref[k]), rel=1e-5), k


def test_ndc_frame_matches_jax_render(capture):
    """Test view 3 whole (144 NDC rays, chunks of 64: a ragged last one)
    through the port's eval pass (B3, B2, B3 twins) against the JAX render
    with the Pallas eval kernels in interpret mode."""
    _, scene, _ = capture
    jcfg, cfg = JaxConfig(**SMALL), VanillaNeRFConfig(**SMALL)
    pc, pf = _params(4), _params(5)
    c2w = scene.poses[3][:3, :4]
    rc = dict(n_samples=16, n_importance=16, white_bkgd=False)
    kw = dict(ndc=True)
    jrays = jax_make_rays(scene.H, scene.W, scene.K, c2w, 0.0, 1.0, **kw)
    ref = jax_render_image(make_vanilla_field(jcfg, fused=False, fused_interpret=True), pc, jrays,
                           JaxRenderConfig(**rc), chunk=64, fine_params=pf)
    rays = make_rays_from_camera(scene.H, scene.W, scene.K, c2w, 0.0, 1.0, device="cpu", **kw)
    for a, b in zip(rays[:5], jrays[:5]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    got = render_image(_model(pc), rays, RenderConfig(**rc), chunk=64, fine_model=_model(pf),
                       eval_pass=make_vanilla_eval_pass(cfg, compute_dtype=torch.float32))
    for k in ("rgb", "disp", "acc", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-5, rtol=5e-4, err_msg=k)


def test_spiral_at_a_render_factor_matches_jax(capture):
    """Four poses of the spiral path at --render_factor 2 (6 x 6 frames,
    the intrinsics scaled) through render_path, against the JAX
    render_path."""
    _, scene, jscene = capture
    assert scene.render_poses.shape == (120, 3, 5)
    jcfg = JaxConfig(**SMALL)
    pc, pf = _params(6), _params(7)
    rc = dict(n_samples=8, n_importance=8, white_bkgd=False)
    poses = scene.render_poses[::30]
    rgbs, disps, _ = render_path(_model(pc), _model(pf), poses, scene, RenderConfig(**rc), chunk=64, render_factor=2)
    jrgbs, jdisps = jax_render_path(make_vanilla_field(jcfg, fused=False), pc, pf, poses, jscene,
                                    JaxRenderConfig(**rc), chunk=64, render_factor=2)[:2]
    assert rgbs.shape == (4, 6, 6, 3)
    np.testing.assert_allclose(rgbs, np.asarray(jrgbs), atol=1e-5, rtol=5e-4)
    np.testing.assert_allclose(disps, np.asarray(jdisps), atol=1e-5, rtol=5e-4)


def test_llff_train_render_only_cli(tmp_path, monkeypatch, capsys):
    """The port's counterpart of tests/test_pipeline.py:80-114: an LLFF
    folder -> NDC rays and the pooled sampler through the kernel step (D=6,
    W=128: B1 and B2 on their twins) -> checkpoint -> --render_only
    --render_test with two finite PSNRs (llffhold 3 on 6 images) ->
    --render_only: the 120-view spiral as PNG frames, and at
    --render_factor 2."""
    data, logs = tmp_path / "llff", tmp_path / "logs"
    write_llff_scene(str(data), n_images=6, size=8, n_samples=16, device="cpu")
    argv = [
        "--expname", "tiny", "--basedir", str(logs), "--datadir", str(data), "--dataset_type", "llff",
        "--factor", "1", "--llffhold", "3", "--use_viewdirs", "--netdepth", "6", "--netwidth", "128",
        "--netdepth_fine", "6", "--netwidth_fine", "128", "--multires", "4", "--multires_views", "2",
        "--N_rand", "16", "--N_samples", "8", "--N_importance", "8", "--raw_noise_std", "1", "--chunk", "64",
        "--i_weights", "10", "--i_print", "5", "--i_video", "100000", "--i_testset", "100000", "--device", "cpu",
    ]
    monkeypatch.setenv("SWNERF_MAX_ITERS", "11")
    res = run_nerf.main(argv)
    out = capsys.readouterr().out
    assert "kernel train step" in out and "TEST views are [0 3]" in out
    assert np.isfinite(list(res["metrics"].values())).all()
    exp = logs / "tiny"
    assert (exp / "000010.tar").exists()

    rdir = Path(run_nerf.main(argv + ["--render_only", "--render_test"]))
    metrics = json.loads((rdir / "metrics.json").read_text())
    assert len(metrics["psnr"]) == 2 and np.isfinite(metrics["psnr"]).all()
    assert sorted(p.name for p in rdir.glob("*.png")) == ["000.png", "001.png"]

    spiral = Path(run_nerf.main(argv + ["--render_only"]))
    assert spiral.name == "renderonly_path_000010" and len(list(spiral.glob("*.png"))) == 120
    assert len(json.loads((spiral / "metrics.json").read_text())["seconds_per_frame"]) == 120
    from swnerf_torch.utils.png import read_png

    small = Path(run_nerf.main(argv + ["--render_only", "--render_factor", "2", "--expname", "tiny",
                                       "--ft_path", str(exp / "000010.tar"), "--basedir", str(tmp_path / "rf")]))
    assert read_png(str(small / "000.png")).shape == (4, 4, 3) and len(list(small.glob("*.png"))) == 120
