"""The training slice of swnerf_torch as a whole, against swnerf_tpu on the
CPU: one eager train step against JAX ``make_train_step`` (gradients, loss,
Adam), the kernel step (B1 and B2 on their plain twins) against the eager
step, Adam and its schedule against optax, the ``.tar`` bridge in both
directions, the samplers, the watchdog, and the training CLI.

Bars: gradients ``max|d| <= 1e-4 * max|g_ref| + 1e-7`` per tensor; loss and
metrics rel 1e-5; parameters after Adam from shared gradients atol 2e-7,
after a further train step from a shared checkpoint atol 1e-6."""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from swnerf_torch.models import VanillaNeRF, VanillaNeRFConfig
from swnerf_torch.ops.rays import get_rays_at
from swnerf_torch.pipelines import run_nerf
from swnerf_torch.pipelines.common import (
    DeadInitDetected,
    DeadInitWatchdog,
    ImageSampler,
    RayPoolSampler,
    auto_reseed_loop,
)
from swnerf_torch.render.core import Draws, Rays, RenderConfig, build_rays
from swnerf_torch.train.checkpoint import load_tar, params_from_jax, save_tar, vanilla_state_dict
from swnerf_torch.train.fused_step import make_fused_train_step, supports_fused_step
from swnerf_torch.train.loop import exp_decay_schedule, init_train_state, make_train_step, mse_to_psnr
from swnerf_tpu.data.synthetic import render_gt, write_blender_scene
from swnerf_tpu.models import VanillaNeRFConfig as JaxConfig
from swnerf_tpu.models import make_vanilla_field
from swnerf_tpu.ops.rays import get_rays_at as jax_get_rays_at
from swnerf_tpu.pipelines.common import ImageSampler as JaxImageSampler
from swnerf_tpu.pipelines.common import RayPoolSampler as JaxRayPoolSampler
from swnerf_tpu.pipelines.common import Scene as JaxScene
from swnerf_tpu.render import RenderConfig as JaxRenderConfig
from swnerf_tpu.render.core import Rays as JaxRays
from swnerf_tpu.render.core import build_rays as jax_build_rays
from swnerf_tpu.train import checkpoint as jck
from swnerf_tpu.train.loop import init_train_state as jax_init_train_state
from swnerf_tpu.train.loop import make_optimizer as jax_make_optimizer
from swnerf_tpu.train.loop import make_train_step as jax_make_train_step
from swnerf_tpu.train.loop import mse_to_psnr as jax_mse_to_psnr

torch.set_num_threads(2)

SMALL = dict(netdepth=3, netwidth=128, skips=(1,), multires=4, multires_views=2)


def _rays(n=32, seed=0):
    """The ray batch of tests/test_fused_step.py:17-27 and its targets."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = 4.0
    jrays = JaxRays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(d), jnp.full((n,), 2.0), jnp.full((n,), 6.0), None)
    target = np.array(render_gt(jrays, n_samples=32))
    t = torch.from_numpy
    rays = Rays(t(o), t(d), t(d.copy()), torch.full((n,), 2.0), torch.full((n,), 6.0))
    return jrays, rays, target


def _jax_params(seed, cfg=None):
    from swnerf_tpu.models.vanilla import init_vanilla_params

    return jax.tree.map(np.asarray, init_vanilla_params(jax.random.PRNGKey(seed), cfg or JaxConfig(**SMALL)))


def _port_model(params, kw=SMALL):
    model = VanillaNeRF(VanillaNeRFConfig(**kw), device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model


def _jax_draws(rcfg, n, key, step=0):
    """JAX's draws of one train step, rebuilt from its key schedule:
    fold_in(key, step), split 4 (render/core.py:104, loop.py:109)."""
    k_jit, k_noise0, k_pdf, k_noise1 = jax.random.split(jax.random.fold_in(key, step), 4)
    nc, nf = rcfg.n_samples, rcfg.n_importance
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    std = rcfg.raw_noise_std
    return Draws(
        t_rand=t(jax.random.uniform(k_jit, (n, nc))),
        noise0=t(jax.random.normal(k_noise0, (n, nc)) * std),
        u=t(jax.random.uniform(k_pdf, (n, nf))) if nf else None,
        noise1=t(jax.random.normal(k_noise1, (n, nc + nf)) * std) if nf else None,
    )


def _grads_of(state):
    out = {f"coarse.{k}": p.grad.detach().clone() for k, p in state.coarse.named_parameters()}
    if state.fine is not None:
        out.update({f"fine.{k}": p.grad.detach().clone() for k, p in state.fine.named_parameters()})
    return out


def _assert_grads_close(got, ref, rel=1e-4):
    assert set(got) == set(ref)
    for k in ref:
        g, r = np.asarray(got[k], np.float64), np.asarray(ref[k], np.float64)
        err = np.abs(g - r).max()
        assert err <= rel * np.abs(r).max() + 1e-7, (k, err, np.abs(r).max())


def _grad_stash():
    """An optax transformation whose state is the last gradient (and whose
    update is zero): JAX's gradients before any optimizer touches them."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g),
    )


# ---------------------------------------------------------------- one step against JAX


@pytest.mark.parametrize("mode", ["deterministic", "random"])
def test_train_step_matches_jax(mode):
    """Two nets, hierarchical: gradients before Adam and the metrics."""
    noise, perturb = (0.0, 0.0) if mode == "deterministic" else (0.7, 1.0)
    jrc = JaxRenderConfig(n_samples=8, n_importance=8, perturb=perturb, white_bkgd=True, raw_noise_std=noise)
    rcfg = RenderConfig(n_samples=8, n_importance=8, perturb=perturb, white_bkgd=True, raw_noise_std=noise)
    jrays, rays, target = _rays(32)
    pc, pf = _jax_params(0), _jax_params(1)
    params = {"coarse": pc, "fine": pf}
    field = make_vanilla_field(JaxConfig(**SMALL), fused=False)
    key = jax.random.PRNGKey(42)

    stash = _grad_stash()
    s_stash, m_ref = jax.jit(jax_make_train_step(field, jrc, stash))(jax_init_train_state(params, stash), jrays,
                                                                      jnp.asarray(target), key)
    jgrads = {f"{net}.{k}": v.numpy() for net in ("coarse", "fine")
              for k, v in params_from_jax(jax.tree.map(np.asarray, s_stash.opt_state[net])).items()}

    state = init_train_state(_port_model(pc), _port_model(pf), 5e-3, 250)
    draws = _jax_draws(rcfg, 32, key) if mode == "random" else None
    m = make_train_step(rcfg)(state, rays, torch.from_numpy(target), draws=draws)
    _assert_grads_close({k: v.numpy() for k, v in _grads_of(state).items()}, jgrads)
    for k in m_ref:
        assert float(m[k]) == pytest.approx(float(m_ref[k]), rel=1e-5), k
    # The step ran Adam on those gradients (test_adam_matches_optax holds
    # the update itself to optax).
    assert state.optimizer.state_dict()["state"][0]["step"].item() == 1
    assert state.step == 1


# ---------------------------------------------------------------- kernel step against eager step


@pytest.mark.parametrize("nets", ["two", "shared", "coarse_only"])
def test_fused_step_matches_eager(nets):
    """B1 and B2 (plain twins on the CPU) against autograd, same draws."""
    n_imp = 0 if nets == "coarse_only" else 8
    rcfg = RenderConfig(n_samples=8, n_importance=n_imp, perturb=1.0, white_bkgd=nets != "coarse_only",
                        raw_noise_std=0.7)
    cfg = VanillaNeRFConfig(**SMALL)
    _, rays, target = _rays(27)
    target = torch.from_numpy(target)
    draws = _jax_draws(rcfg, 27, jax.random.PRNGKey(7))
    pc, pf = _jax_params(0), _jax_params(1)

    def state():
        return init_train_state(_port_model(pc), _port_model(pf) if nets == "two" else None, 5e-3, 250)

    s_eager, s_fused = state(), state()
    m_eager = make_train_step(rcfg)(s_eager, rays, target, draws=draws)
    assert supports_fused_step(cfg, cfg if nets == "two" else None, rcfg)
    m_fused = make_fused_train_step(cfg, rcfg, fcfg=cfg if nets == "two" else None)(s_fused, rays, target,
                                                                                     draws=draws)
    assert set(m_fused) == set(m_eager)
    for k in m_eager:
        assert float(m_fused[k]) == pytest.approx(float(m_eager[k]), rel=1e-5), k
    _assert_grads_close({k: v.numpy() for k, v in _grads_of(s_fused).items()},
                        {k: v.numpy() for k, v in _grads_of(s_eager).items()})


def test_fused_step_draws_from_its_generator():
    """Without draws, both steps take the same numbers from equal generators."""
    rcfg = RenderConfig(n_samples=8, n_importance=8, perturb=1.0, white_bkgd=True, raw_noise_std=0.7)
    cfg = VanillaNeRFConfig(**SMALL)
    _, rays, target = _rays(16)
    target = torch.from_numpy(target)
    pc = _jax_params(0)
    m = [step(init_train_state(_port_model(pc), None, 5e-3, 250), rays, target, torch.Generator().manual_seed(5))
         for step in (make_train_step(rcfg), make_fused_train_step(cfg, rcfg))]
    assert float(m[0]["total_loss"]) == pytest.approx(float(m[1]["total_loss"]), rel=1e-5)


# ---------------------------------------------------------------- Adam and the schedule


def _torch_adam_dict(mu, nu, step, lr):
    state = {i: {"step": step, "exp_avg": torch.from_numpy(m.copy()), "exp_avg_sq": torch.from_numpy(v.copy())}
             for i, (m, v) in enumerate(zip(mu, nu))}
    return {"state": state, "param_groups": [{"lr": lr, "betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 0,
                                              "amsgrad": False, "params": list(range(len(mu)))}]}


@pytest.mark.parametrize("start", [0, 1000])
def test_adam_matches_optax(start):
    """Three identical gradients through the port's Adam and JAX
    make_optimizer(5e-3, 250), fresh and from a resumed count (moments
    handed over through the JAX package's torch_dict_to_adam). Bar atol
    2e-7: optax forms the bias correction 1 - 0.999^t in fp32, which is off
    by up to ~1e-5 relative at t <= 3 (torch forms it in float64); measured
    max |d| 1.34e-7 on the fresh run."""
    pc = _jax_params(0)
    model = _port_model(pc)
    state = init_train_state(model, None, 5e-3, 250, step=start)
    opt = jax_make_optimizer(5e-3, 250)
    jparams = {"coarse": pc, "fine": None}
    jstate = jax_init_train_state(jparams, opt)
    rng = np.random.default_rng(0)
    names = [k for k, _ in model.named_parameters()]
    if start:
        shapes = [p.shape for p in model.parameters()]
        mu = [rng.standard_normal(s).astype(np.float32) * 1e-3 for s in shapes]
        nu = [(np.abs(m) * rng.uniform(1, 3, m.shape)).astype(np.float32) ** 2 for m in mu]
        # One dict each: JAX may alias a contiguous numpy buffer that torch
        # then updates in place.
        state.optimizer.load_state_dict(_torch_adam_dict(mu, nu, start, 1.0))
        opt_state, count = jck.torch_dict_to_adam(_torch_adam_dict(mu, nu, start, 1.0), jparams,
                                                  [("vanilla", "coarse")], jstate.opt_state)
        assert count == start
        jstate = jstate._replace(opt_state=opt_state)
    for _ in range(3):
        grads = {k: rng.standard_normal(p.shape).astype(np.float32) * 1e-2 for k, p in model.named_parameters()}
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[k])
        state.apply_update()
        gtree = jck.state_dict_to_params("vanilla", grads, pc)
        updates, new_opt = opt.update({"coarse": gtree, "fine": None}, jstate.opt_state, jstate.params)
        jstate = jstate._replace(params=optax.apply_updates(jstate.params, updates), opt_state=new_opt)
    ref = params_from_jax(jax.tree.map(np.asarray, jstate.params["coarse"]))
    for k in names:
        np.testing.assert_allclose(model.state_dict()[k].numpy(), ref[k].numpy(), atol=2e-7, rtol=0, err_msg=k)
    assert state.step == start + 3


def test_schedule_and_psnr_match_jax():
    sched = exp_decay_schedule(5e-4, 500)
    for step in (0, 1, 10000, 200000):
        assert sched(step) == pytest.approx(float(jck.jnp.asarray(5e-4 * 0.1 ** (step / 500000.0))), rel=1e-6)
    assert mse_to_psnr(0.01) == pytest.approx(float(jax_mse_to_psnr(jnp.asarray(0.01))), rel=1e-6)
    assert float(mse_to_psnr(torch.tensor(0.02))) == pytest.approx(float(jax_mse_to_psnr(jnp.asarray(0.02))), rel=1e-6)


# ---------------------------------------------------------------- the .tar bridge


def test_checkpoint_bridge_round_trip(tmp_path):
    """JAX writes a .tar after two steps; the port loads it (weights and
    Adam), saves it back; JAX reads the same params, moments and count bit
    for bit, and one more step in each framework agrees."""
    jrc = JaxRenderConfig(n_samples=8, n_importance=8, perturb=0.0, white_bkgd=True)
    rcfg = RenderConfig(n_samples=8, n_importance=8, perturb=0.0, white_bkgd=True)
    jrays, rays, target = _rays(32)
    params = {"coarse": _jax_params(0), "fine": _jax_params(1)}
    field = make_vanilla_field(JaxConfig(**SMALL), fused=False)
    opt = jax_make_optimizer(5e-3, 250)
    step = jax.jit(jax_make_train_step(field, jrc, opt))
    js = jax_init_train_state(params, opt)
    for _ in range(2):
        js, _ = step(js, jrays, jnp.asarray(target), jax.random.PRNGKey(0))
    groups = [("vanilla", "coarse"), ("vanilla", "fine")]
    jck.save_tar(str(tmp_path / "000002.tar"), {
        "global_step": 2,
        "network_fn_state_dict": jck.params_to_state_dict("vanilla", js.params["coarse"]),
        "network_fine_state_dict": jck.params_to_state_dict("vanilla", js.params["fine"]),
        "optimizer_state_dict": jck.adam_to_torch_dict(js.opt_state, js.params, groups, 5e-3),
    })

    ckpt = load_tar(str(tmp_path / "000002.tar"))
    cfg = VanillaNeRFConfig(**SMALL)
    coarse, fine = VanillaNeRF(cfg, device="cpu"), VanillaNeRF(cfg, device="cpu")
    coarse.load_state_dict(vanilla_state_dict(ckpt["network_fn_state_dict"]))
    fine.load_state_dict(vanilla_state_dict(ckpt["network_fine_state_dict"]))
    state = init_train_state(coarse, fine, 5e-3, 250, step=int(ckpt["global_step"]))
    state.optimizer.load_state_dict(ckpt["optimizer_state_dict"])

    class Args:
        basedir, expname, lrate, lrate_decay = str(tmp_path), "port", 5e-3, 250

    path = run_nerf.save_vanilla_ckpt(Args, state, 2)
    back = jck.load_tar(path)
    assert set(back) == {"global_step", "network_fn_state_dict", "network_fine_state_dict", "optimizer_state_dict"}
    assert back["global_step"] == 2
    for net, key in (("coarse", "network_fn_state_dict"), ("fine", "network_fine_state_dict")):
        got = jck.state_dict_to_params("vanilla", back[key], js.params[net])
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(js.params[net])):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    opt_state, count = jck.torch_dict_to_adam(back["optimizer_state_dict"], js.params, groups, js.opt_state)
    assert count == 2
    adam_ref, adam_got = jck._find_adam_state(js.opt_state), jck._find_adam_state(opt_state)
    for a, b in zip(jax.tree.leaves((adam_got.mu, adam_got.nu)), jax.tree.leaves((adam_ref.mu, adam_ref.nu))):
        assert np.array_equal(np.asarray(a), np.asarray(b))

    js3, _ = step(js, jrays, jnp.asarray(target), jax.random.PRNGKey(0))
    make_train_step(rcfg)(state, rays, torch.from_numpy(target))
    for net, model in (("coarse", coarse), ("fine", fine)):
        ref = params_from_jax(jax.tree.map(np.asarray, js3.params[net]))
        for k, v in model.state_dict().items():
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), atol=1e-6, err_msg=f"{net}.{k}")


def test_save_tar_moves_tensors_to_cpu(tmp_path):
    save_tar(str(tmp_path / "x.tar"), {"a": {"b": torch.ones(2)}, "c": [torch.zeros(1)], "d": 3})
    got = load_tar(str(tmp_path / "x.tar"))
    assert torch.equal(got["a"]["b"], torch.ones(2)) and got["d"] == 3
    assert not list(tmp_path.glob("*.tmp"))


# ---------------------------------------------------------------- rays and samplers


def _tiny_scene(n_train=3, size=12):
    rng = np.random.default_rng(0)
    poses = np.stack([np.eye(4, dtype=np.float32) for _ in range(n_train + 1)])
    poses[:, :3, 3] = rng.standard_normal((n_train + 1, 3))
    images = rng.uniform(0, 1, (n_train + 1, size, size, 3)).astype(np.float32)
    focal = 10.0
    K = np.array([[focal, 0, 0.5 * size], [0, focal, 0.5 * size], [0, 0, 1]])
    kw = dict(images=images, poses=poses, render_poses=poses, H=size, W=size, focal=focal, K=K, near=2.0, far=6.0,
              i_train=np.arange(n_train), i_val=np.array([n_train]), i_test=np.array([n_train]))
    from swnerf_torch.pipelines.common import Scene

    return Scene(**kw), JaxScene(**kw)


def test_image_sampler_matches_jax():
    """Seed 0 draws JAX's images and pixels, during the pre-crop and after."""
    scene, jscene = _tiny_scene()
    ours, ref = ImageSampler(scene, 20, 3, 0.5), JaxImageSampler(jscene, 20, 3, 0.5)
    for step in range(1, 7):
        (a, pa), (b, pb) = ours.next(step), ref.next(step)
        assert a == b and np.array_equal(pa, pb)
    assert ImageSampler(scene, 200, 0, 0.5).next(1)[1].shape == (200, 2)  # more than the pixels: with replacement


def test_ray_pool_sampler_matches_jax():
    scene, jscene = _tiny_scene()
    ours, ref = RayPoolSampler(scene, 50, "cpu"), JaxRayPoolSampler(jscene, 50)
    np.testing.assert_array_equal(ours.pool.numpy(), np.asarray(ref.pool))
    for _ in range(12):  # past one epoch of 432 rays: the reshuffle too
        assert np.array_equal(ours.next_indices(), ref.next_indices())


def test_samplers_follow_swnerf_seed(monkeypatch):
    scene, _ = _tiny_scene()
    draws = {}
    for seed in ("0", "1"):
        monkeypatch.setenv("SWNERF_SEED", seed)
        draws[seed] = (ImageSampler(scene, 20, 0, 0.5).next(1), RayPoolSampler(scene, 50, "cpu").next_indices())
    assert not np.array_equal(draws["0"][0][1], draws["1"][0][1])
    assert not np.array_equal(draws["0"][1], draws["1"][1])


def test_get_rays_at_and_build_rays_match_jax():
    scene, _ = _tiny_scene(size=16)
    pixels = np.random.default_rng(1).integers(0, 16, (40, 2))
    c2w = scene.poses[1][:3, :4]
    o, d = get_rays_at(torch.from_numpy(pixels), 16, 16, scene.K, torch.from_numpy(c2w))
    jo, jd = jax_get_rays_at(jnp.asarray(pixels), 16, 16, scene.K, jnp.asarray(c2w))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)
    rays, jrays = build_rays(o, d, 2.0, 6.0), jax_build_rays(jo, jd, 2.0, 6.0)
    for a, b in zip(rays, jrays[:5]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


# ---------------------------------------------------------------- watchdog and safe init


def test_watchdog_fires_on_a_noisy_flat_run(monkeypatch):
    """A dead run's minibatch PSNR is noisy but flat: the port's half-window
    test fires where the JAX package's max-min spread test cannot."""
    rng = np.random.default_rng(0)
    dog = DeadInitWatchdog(100)
    for i in range(1, 12):
        dog.check(i * 100, 12.0 + rng.normal(0, 0.3))
    assert dog.warned
    live = DeadInitWatchdog(100)
    for i in range(1, 12):
        live.check(i * 100, 10.0 + i * 0.5 + rng.normal(0, 0.3))
    assert not live.warned
    monkeypatch.setenv("SWNERF_AUTO_RESEED", "1")
    arming = DeadInitWatchdog(100, restart_until=10_000)
    with pytest.raises(DeadInitDetected):
        for i in range(1, 12):
            arming.check(i * 100, 12.0)


def test_auto_reseed_loop_restarts_once(monkeypatch):
    monkeypatch.setenv("SWNERF_AUTO_RESEED", "1")
    attempts = []

    def once(argv):
        attempts.append(os.environ.get("SWNERF_RESEED_ATTEMPT", "0"))
        if len(attempts) == 1:
            raise DeadInitDetected("dead")
        return "done"

    assert auto_reseed_loop(once) == "done" and attempts == ["0", "1"]
    assert "SWNERF_RESEED_ATTEMPT" not in os.environ


def test_safe_init_floors_the_density_bias(monkeypatch):
    monkeypatch.setenv("SWNERF_SAFE_INIT", "1")
    for seed in range(4):
        model = VanillaNeRF(VanillaNeRFConfig(**SMALL), device="cpu", generator=torch.Generator().manual_seed(seed))
        assert model.alpha_linear.bias.item() >= 0.1
    model = VanillaNeRF(VanillaNeRFConfig(**SMALL, use_viewdirs=False), device="cpu")
    assert model.output_linear.bias[3].item() >= 0.1


# ---------------------------------------------------------------- the CLI


@pytest.mark.parametrize("depth,width,kernel_step", [(2, 32, False), (6, 128, True)], ids=["eager", "kernel"])
def test_train_cli_cpu_saves_and_resumes(tmp_path, monkeypatch, capsys, depth, width, kernel_step):
    """run_nerf --device cpu on a 16x16 Blender scene: 40 steps save
    000040.tar (four keys) and metrics.jsonl; a second run resumes at 40 and
    reaches 60; the JAX package loads the port's .tar. D=2 has no skip
    inside the trunk, so the eager step runs; D=6 takes the kernel step on
    the plain twins (SWNERF_FUSED_STEP=0 turns it off for the resumed run)."""
    data, logs = tmp_path / "data", tmp_path / "logs"
    write_blender_scene(str(data), n_train=3, n_val=1, n_test=1, size=16)
    argv = [
        "--expname", "t", "--basedir", str(logs), "--datadir", str(data), "--dataset_type", "blender",
        "--white_bkgd", "--use_viewdirs", "--netdepth", str(depth), "--netwidth", str(width),
        "--netdepth_fine", str(depth), "--netwidth_fine", str(width), "--multires", "4", "--multires_views", "2",
        "--N_rand", "32", "--N_samples", "8", "--N_importance", "8", "--chunk", "128", "--i_weights", "40",
        "--i_print", "10", "--i_video", "100000", "--i_testset", "40", "--precrop_iters", "0", "--lrate", "5e-3",
        "--testskip", "1", "--no_batching", "--device", "cpu",
    ]
    monkeypatch.setenv("SWNERF_MAX_ITERS", "41")
    res = run_nerf.main(argv)
    out = capsys.readouterr().out
    assert ("kernel train step" in out) is kernel_step
    exp = logs / "t"
    ckpt = load_tar(str(exp / "000040.tar"))
    assert set(ckpt) == {"global_step", "network_fn_state_dict", "network_fine_state_dict", "optimizer_state_dict"}
    assert ckpt["global_step"] == 40
    assert all(int(e["step"]) == 40 for e in ckpt["optimizer_state_dict"]["state"].values())
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    losses = [r["total_loss"] for r in recs if "total_loss" in r]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert np.isfinite(list(res["metrics"].values())).all()
    assert sorted(p.name for p in (exp / "testset_000040").glob("*.png")) == ["000.png"]
    assert (exp / "args.txt").exists()

    monkeypatch.setenv("SWNERF_MAX_ITERS", "61")
    monkeypatch.setenv("SWNERF_FUSED_STEP", "0")
    run_nerf.main(argv)
    out = capsys.readouterr().out
    assert f"Reloading from {exp / '000040.tar'}" in out and "Iter: 60 " in out and "Iter: 40 " not in out
    assert "eager autograd train step" in out

    jcfg = JaxConfig(netdepth=depth, netwidth=width, skips=(4,), multires=4, multires_views=2)
    jparams = {"coarse": _jax_params(0, jcfg), "fine": _jax_params(1, jcfg)}
    back = jck.load_tar(str(exp / "000040.tar"))
    got = jck.state_dict_to_params("vanilla", back["network_fn_state_dict"], jparams["coarse"])
    np.testing.assert_array_equal(np.asarray(got["rgb_linear"]["w"]),
                                  ckpt["network_fn_state_dict"]["rgb_linear.weight"].numpy().T)
    opt = jax_make_optimizer(5e-3, 250)
    _, count = jck.torch_dict_to_adam(back["optimizer_state_dict"], jparams,
                                      [("vanilla", "coarse"), ("vanilla", "fine")],
                                      jax_init_train_state(jparams, opt).opt_state)
    assert count == 40


def test_train_cli_on_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_nerf.main([])


def test_eager_step_for_unsupported_configs():
    """D=2 puts skip 4 outside the trunk: B1 does not cover it."""
    cfg = VanillaNeRFConfig(netdepth=2, netwidth=32, multires=4, multires_views=2)
    assert not supports_fused_step(cfg, cfg, RenderConfig(n_samples=8, n_importance=8))
    assert supports_fused_step(VanillaNeRFConfig(), VanillaNeRFConfig(), RenderConfig(n_samples=64, n_importance=128))
