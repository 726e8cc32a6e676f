"""The MultiRes slice of swnerf_torch against swnerf_tpu on the CPU: the
Laplacian pyramid and its reconstruction's VJP, the D-NeRF field's kernel
route (the twins of B6 and B7) at the per-level widths, one phase-1 step and
one phase-2 step, the per-level ``.tar`` bridge, and the seeded host stream.

Bars: pyramid atol 1e-6; raw and dx atol 1e-5 (rtol 5e-4); metrics rel
1e-5; gradients ``max|d| <= 1e-4 * max|g_ref| + 1e-7`` per tensor, with the
float64 fallback of tests/test_torch_dnerf.py in the steps. At level 0 the
position and view encodings reach 2^19 |x|: an fp32 rounding of dx or of a
view direction (1e-7) moves them by ~0.05 rad, so fp32 results of the two
packages there agree only on well-conditioned inputs (ROADMAP.md Queue C);
the tests below say how each keeps to those."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from swnerf_torch.models import DirectTemporalNeRF, DNeRFConfig
from swnerf_torch.ops import pyramid as tp
from swnerf_torch.pipelines import run_multires as mr
from swnerf_torch.pipelines.common import Scene, make_time_image_step, neighbor_time_rng, pick_neighbor_time
from swnerf_torch.render.core import Draws, Rays, RenderConfig
from swnerf_torch.train.checkpoint import load_tar, params_from_jax
from swnerf_torch.train.loop import init_train_state, make_dnerf_train_step
from swnerf_torch.utils.config import config_parser_dnerf
from swnerf_tpu.models.dnerf import DNeRFConfig as JaxConfig
from swnerf_tpu.models.dnerf import make_dnerf_field
from swnerf_tpu.ops import pyramid as jp
from swnerf_tpu.pipelines import run_multires as jmr
from swnerf_tpu.pipelines.common import Scene as JaxScene
from swnerf_tpu.pipelines.run_dnerf import make_dnerf_step as jax_make_dnerf_step
from swnerf_tpu.pipelines.run_dnerf import pick_neighbor_time as jax_pick_neighbor_time
from swnerf_tpu.render import RenderConfig as JaxRenderConfig
from swnerf_tpu.train.loop import init_train_state as jax_init_train_state
from swnerf_tpu.utils.config import config_parser_dnerf as jax_config_parser_dnerf

torch.set_num_threads(2)

BASE = dict(netdepth=4, netwidth=128, skips=(2,))
LEVELS = [
    dict(BASE, multires=20, multires_time=8, multires_views=20),
    dict(BASE, multires=10, multires_time=4, multires_views=10),
    dict(BASE, multires=10, multires_time=4, multires_views=10),
    dict(BASE, multires=-1, multires_time=-1, multires_views=-1, i_embed=-1),
]


# ---------------------------------------------------------------- the pyramid


@pytest.mark.parametrize("shape", [(2, 50, 50, 3), (1, 25, 37, 3)], ids=["50x50", "odd"])
def test_pyramid_matches_jax(shape):
    """gaussian_kernel, gaussian_blur, both pyramids and the reconstruction
    against swnerf_tpu.ops.pyramid, 4 levels, odd sizes (25 -> 12, 37 -> 18)
    included: the antialiased bilinear resize is jax.image.resize's
    "linear". Measured max |d| 2.4e-7."""
    x = np.random.default_rng(0).uniform(0, 1, shape).astype(np.float32)
    np.testing.assert_allclose(tp.gaussian_kernel().numpy(), np.asarray(jp.gaussian_kernel()), atol=1e-7)
    np.testing.assert_allclose(tp.gaussian_blur(torch.from_numpy(x)).numpy(), np.asarray(jp.gaussian_blur(x)),
                               atol=1e-6)
    for name in ("generate_gaussian_pyramid", "generate_laplacian_pyramid"):
        got = getattr(tp, name)(torch.from_numpy(x), levels=4)
        ref = getattr(jp, name)(jnp.asarray(x), levels=4)
        assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)
    bands = [np.asarray(b) for b in jp.generate_laplacian_pyramid(jnp.asarray(x), levels=4)]
    recon = tp.reconstruct_from_pyramid([torch.from_numpy(b.copy()) for b in bands])
    np.testing.assert_allclose(recon.numpy(), np.asarray(jp.reconstruct_from_pyramid(bands)), atol=1e-6)
    np.testing.assert_allclose(recon.numpy(), x, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 25, 37, 3)], ids=["32x32", "odd"])
def test_reconstruction_vjp_matches_jax(shape):
    """The cotangent of each band through reconstruct_from_pyramid (the
    phase-2 global term's path) against jax.vjp: atol 1e-5, rtol 1e-6 (the
    cotangents reach ~13; measured max |d| 2.9e-6)."""
    x = np.random.default_rng(1).uniform(0, 1, shape).astype(np.float32)
    bands = [np.asarray(b) for b in jp.generate_laplacian_pyramid(jnp.asarray(x), levels=4)]
    g = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(jp.reconstruct_from_pyramid, [jnp.asarray(b) for b in bands])
    (ref,) = vjp(jnp.asarray(g))
    tb = [torch.from_numpy(b.copy()).requires_grad_(True) for b in bands]
    (tp.reconstruct_from_pyramid(tb) * torch.from_numpy(g)).sum().backward()
    for t, r in zip(tb, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=1e-5, rtol=1e-6)


def test_plain_bilinear_resize_would_miss_jax():
    """The reference PyTorch code resizes without the antialias: on the
    50x50 pyramid that lands up to 8.8e-2 from the JAX package at level 1
    (the port's antialiased resize: 2.4e-7), which is why the port follows
    jax.image.resize (ROADMAP.md Queue C)."""
    x = np.random.default_rng(0).uniform(0, 1, (2, 50, 50, 3)).astype(np.float32)
    ref = np.asarray(jp.generate_gaussian_pyramid(jnp.asarray(x), levels=2)[1])
    blurred = tp.gaussian_blur(torch.from_numpy(x)).permute(0, 3, 1, 2)
    plain = F.interpolate(blurred, size=(25, 25), mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    ours = tp.generate_gaussian_pyramid(torch.from_numpy(x), levels=2)[1]
    assert np.abs(plain.numpy() - ref).max() > 5e-2
    assert np.abs(ours.numpy() - ref).max() < 1e-6


# ---------------------------------------------------------------- the field's kernel route and the steps


def _rays(n=12, seed=0):
    """A quarter of the rays at t = 0 (the zero_canonical mask)."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = rng.uniform(0.0, 1.0, (n, 1)).astype(np.float32)
    t[: n // 4] = 0.0
    z = np.sort(rng.uniform(2.0, 6.0, (n, 8)), -1).astype(np.float32)
    pts = np.array([0.0, 0.0, 4.0], np.float32) + d[:, None, :] * z[..., None]
    return pts.astype(np.float32), d, t


def _port_field(kw, params, dtype=torch.float32):
    model = DirectTemporalNeRF(DNeRFConfig(**kw), device="cpu", fused=True, compute_dtype=dtype)
    model.load_state_dict(params_from_jax(params))
    model = model.to(dtype)
    assert model.fused_time and model.fused_trunk
    return model


def _small_deformation(params):
    """The deformation head scaled by 1e-3: dx near 1e-3, so its fp32
    rounding (~1e-10) moves a 2^19 encoding by 5e-5 rad instead of 0.05."""
    params["time_net"]["out"] = {k: v * np.float32(1e-3) for k, v in params["time_net"]["out"].items()}
    return params


def _assert_grads(got, ref, rel=1e-4):
    for k, r in ref.items():
        err = np.abs(np.asarray(got[k], np.float64) - np.asarray(r, np.float64)).max()
        assert err <= rel * np.abs(r).max() + 1e-7, (k, err, np.abs(r).max())


@pytest.mark.parametrize("level", [0, 1, 3], ids=["level0", "level1", "identity"])
def test_kernel_route_field_matches_jax(level):
    """DirectTemporalNeRF on its kernel route (the twins of B6 and B7 on the
    CPU) against make_dnerf_field(fused=False), fp32: raw and dx (atol 1e-5,
    rtol 5e-4), and jax.grad of sum(g_raw * raw + g_dx * dx) in every
    parameter (the loss reaches the deformation net through B7's demb).
    Both packages take the same _small_deformation weights, so the
    comparison is well conditioned at every level."""
    kw = LEVELS[level]
    field = make_dnerf_field(JaxConfig(**kw), fused=False)
    params = _small_deformation(jax.tree.map(np.asarray, field.init(jax.random.PRNGKey(level))))
    pts, vd, t = _rays(seed=level)
    rng = np.random.default_rng(9)
    g_raw = rng.standard_normal((12, 8, 4)).astype(np.float32)
    g_dx = rng.standard_normal((12, 8, 3)).astype(np.float32)

    def loss(p):
        raw, aux = field.apply(p, jnp.asarray(pts), jnp.asarray(vd), jnp.asarray(t))
        return jnp.sum(jnp.asarray(g_raw) * raw) + jnp.sum(jnp.asarray(g_dx) * aux["dx"]), (raw, aux["dx"])

    jgrads, (jraw, jdx) = jax.jit(jax.grad(loss, has_aux=True))(params)
    model = _port_field(kw, params)
    raw, aux = model(torch.from_numpy(pts), torch.from_numpy(vd), torch.from_numpy(t))
    ((raw * torch.from_numpy(g_raw)).sum() + (aux["dx"] * torch.from_numpy(g_dx)).sum()).backward()
    np.testing.assert_allclose(raw.detach().numpy(), np.asarray(jraw), atol=1e-5, rtol=5e-4)
    np.testing.assert_allclose(aux["dx"].detach().numpy(), np.asarray(jdx), atol=1e-5, rtol=5e-4)
    _assert_grads({k: p.grad.numpy() for k, p in model.named_parameters()},
                  {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, jgrads)).items()})


def _tiny_scene(n=5, size=16, seed=0):
    """The port's and the JAX package's Scene for the same random images,
    camera positions (identity rotations: the rays are exact in fp32 in
    both) and frame times."""
    rng = np.random.default_rng(seed)
    poses = np.stack([np.eye(4, dtype=np.float32) for _ in range(n)])
    poses[:, :3, 3] = rng.standard_normal((n, 3)) * 0.2 + np.array([0.0, 0.0, 4.0])
    images = rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)
    times = np.linspace(0, 1, n).astype(np.float32)
    K = np.array([[20.0, 0, 0.5 * size], [0, 20.0, 0.5 * size], [0, 0, 1]])
    kw = dict(images=images, poses=poses, render_poses=poses, H=size, W=size, focal=20.0, K=K, near=2.0, far=6.0,
              i_train=np.arange(n), i_val=np.arange(0), i_test=np.arange(0))
    return Scene(**kw, times=times), JaxScene(**kw), images, poses, times


def _grad_stash():
    """An optax transformation whose state is the last gradient (and whose
    update is zero): JAX's gradients before any optimizer touches them."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g),
    )


def _draws(key, n, n_samples):
    """render_rays' jitter from ``key`` (split 4: jitter, coarse noise, ...)."""
    k_jit = jax.random.split(key, 4)[0]
    return Draws(torch.from_numpy(np.array(jax.random.uniform(k_jit, (n, n_samples)))), None, None, None)


def _check_grads(g32, g64, ref):
    """Each tensor: the fp32 (or float64) port within 1e-4 * max|g| + 1e-7
    of JAX's fp32 gradients; or, where fp32 rounding flips a ReLU mask in
    either package, the fp32 port no further from the float64 port than
    twice JAX is (as tests/test_torch_dnerf.py)."""
    for k, r in ref.items():
        bar = 1e-4 * np.abs(r).max() + 1e-7
        d32, d64 = np.abs(g32[k] - r).max(), np.abs(g64[k] - r).max()
        assert min(d32, d64) <= bar or np.abs(g32[k] - g64[k]).max() <= 2 * np.abs(r - g64[k]).max(), (k, d32, bar)


def _check_metrics(metrics, m_ref, keys):
    """Rel 1e-5 from the fp32 or the float64 port (the TV term against the
    total loss it enters)."""
    for k in keys:
        scale = float(m_ref["total_loss" if k == "tv" else k])
        assert any(abs(float(m[k]) - float(m_ref[k])) <= 1e-5 * scale for m in metrics.values()), k


RC = dict(n_samples=8, n_importance=0, perturb=1.0, white_bkgd=True)


@pytest.mark.parametrize("level", [1, 3], ids=["level1", "identity"])
def test_phase1_step_matches_jax_make_dnerf_step(level):
    """One phase-1 step: the port's make_dnerf_train_step (TV on) through
    make_time_image_step on a level's field (the kernel route's twins)
    against JAX make_dnerf_step(make_dnerf_field(fused=False)) on the same
    weights, 24 pixels of frame 1, neighbour time 0.37 and the same jitter
    (JAX's fold_in(key, 0)), the deformation head small in both
    (_small_deformation): metrics as _check_metrics, gradients before the
    optimizer as _check_grads. Level 0's widths meet JAX in
    test_kernel_route_field_matches_jax: the view directions each package
    normalises differ there by fp32 rounding, which its 2^19 view encoding
    amplifies."""
    kw = LEVELS[level]
    jrc, rcfg = JaxRenderConfig(**RC), RenderConfig(**RC)
    scene, jscene, images, poses, times = _tiny_scene()
    pixels = np.random.default_rng(3).integers(0, 16, (24, 2))
    key = jax.random.PRNGKey(42)
    field = make_dnerf_field(JaxConfig(**kw), fused=False)
    params = _small_deformation(jax.tree.map(np.asarray, field.init(jax.random.PRNGKey(7))))
    stash = _grad_stash()
    js = jax_init_train_state(jax.tree.map(jnp.asarray, {"coarse": params, "fine": None}), stash)
    jstep = jax_make_dnerf_step(field, jrc, stash, jscene, True, 1e-2)
    s_ref, m_ref = jstep(js, jnp.asarray(images), jnp.asarray(poses), jnp.asarray(times), 1, jnp.asarray(pixels),
                         jnp.float32(0.37), key)
    ref = {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, s_ref.opt_state["coarse"])).items()}
    draws = _draws(jax.random.fold_in(key, 0), 24, 8)
    grads, metrics = {}, {}
    for dtype in (torch.float32, torch.float64):
        state = init_train_state(_port_field(kw, params, dtype), None, 5e-4, 250)
        cast = lambda x: None if x is None else x.to(dtype)  # noqa: E731

        def step(st, rays, target, nt, gen):  # the float64 step takes the fp32 image step's rays, cast
            return make_dnerf_train_step(rcfg, True, 1e-2)(st, Rays(*(cast(x) for x in rays)), cast(target), nt,
                                                           draws=Draws(*(cast(x) for x in draws)))

        metrics[dtype] = make_time_image_step(step, rcfg, scene, pass_neighbor=True)(
            state, *(torch.from_numpy(a) for a in (images, poses[:, :3, :4], times)), 1, pixels, 0.37)
        grads[dtype] = {k: p.grad.numpy() for k, p in state.coarse.named_parameters()}
    assert set(metrics[torch.float32]) == set(m_ref)
    _check_metrics(metrics, m_ref, m_ref)
    _check_grads(grads[torch.float32], grads[torch.float64], ref)


def test_phase2_step_matches_jax_make_phase2_step():
    """One phase-2 step over 3 levels (levels 1 and 2's widths and the
    identity; 8/4/2-pixel patches at 16/8/4 px): the port's
    make_phase2_step on the kernel route's twins against JAX
    make_phase2_step(fused=False), same weights, patches, Laplacian
    targets, frame time, global weight 1 and jitter (JAX renders every
    level with one key), small deformation heads: each level's loss, the global loss and the total
    as _check_metrics, every level's gradients as _check_grads (the levels
    meet through the reconstruction's VJP)."""
    kws = [LEVELS[1], LEVELS[2], LEVELS[3]]
    jrc, rcfg = JaxRenderConfig(**RC), RenderConfig(**RC)
    _, _, images, poses, times = _tiny_scene()
    pyr_hwf = [[16 // 2**l, 16 // 2**l, 20.0 / 2**l] for l in range(3)]
    patch_sizes = [8, 4, 2]
    coords = [(4, 4), (2, 2), (1, 1)]
    fields = [make_dnerf_field(JaxConfig(**kw), fused=False) for kw in kws]
    params = [_small_deformation(jax.tree.map(np.asarray, f.init(jax.random.PRNGKey(11 + l))))
              for l, f in enumerate(fields)]
    lap = [np.asarray(b) for b in jp.generate_laplacian_pyramid(jnp.asarray(images), levels=3)]
    pixels = [np.stack(np.meshgrid(np.arange(y, y + ps), np.arange(x, x + ps), indexing="ij"), -1).reshape(-1, 2)
              for (y, x), ps in zip(coords, patch_sizes)]
    targets = [lap[l][2, y : y + ps, x : x + ps] for l, ((y, x), ps) in enumerate(zip(coords, patch_sizes))]
    key = jax.random.PRNGKey(5)
    stash = _grad_stash()
    jstep = jmr.make_phase2_step(None, fields, [stash] * 3, jrc, pyr_hwf, patch_sizes, 2.0, 6.0, fused=False)
    jparams = [{"coarse": jax.tree.map(jnp.asarray, p), "fine": None} for p in params]
    _, jstates, m_ref = jstep(jparams, [stash.init(p) for p in jparams], [jnp.asarray(p) for p in pixels],
                              [jnp.asarray(t) for t in targets], jnp.asarray(images[2, 4:12, 4:12]),
                              jnp.asarray(poses[2, :3, :4]), jnp.float32(times[2]), jnp.float32(1.0), key)
    refs = [{k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, s["coarse"])).items()}
            for s in jstates]
    draws = [_draws(key, ps * ps, 8) for ps in patch_sizes]
    step = mr.make_phase2_step(rcfg, pyr_hwf, patch_sizes, 2.0, 6.0)
    grads, metrics = {}, {}
    for dtype in (torch.float32, torch.float64):
        states = [init_train_state(_port_field(kw, p, dtype), None, 5e-4, 250) for kw, p in zip(kws, params)]
        cast = lambda x: torch.from_numpy(np.array(x)).to(dtype)  # noqa: E731
        metrics[dtype] = step(states, [torch.from_numpy(p) for p in pixels], [cast(t) for t in targets],
                              cast(images[2, 4:12, 4:12]), cast(poses[2, :3, :4]), float(times[2]), 1.0,
                              draws=[Draws(*(None if x is None else x.to(dtype) for x in d)) for d in draws])
        grads[dtype] = [{k: p.grad.numpy() for k, p in st.coarse.named_parameters()} for st in states]
    _check_metrics(metrics, m_ref, ("loss_layer_0", "loss_layer_1", "loss_layer_2", "global_loss", "total_loss"))
    for l in range(3):
        _check_grads(grads[torch.float32][l], grads[torch.float64][l], refs[l])


# ---------------------------------------------------------------- checkpoints and the host stream


def _argv(tmp_path, expname):
    return ["--expname", expname, "--basedir", str(tmp_path), "--nerf_type", "direct_temporal", "--use_viewdirs",
            "--netdepth", "2", "--netwidth", "16", "--layer_num", "3", "--lrate", "5e-4", "--lrate_decay", "250"]


def test_jax_written_multires_tar_loads_and_saves_back(tmp_path):
    """A per-level .tar written by the JAX package's save_multires_ckpt (3
    levels, Adam states after 2 updates, saved at iteration 2) resumes the
    port's create_multires (weights, torch Adam, each level's update count)
    and save_multires_ckpt writes it back with the same keys, shapes and
    tensors, and the schedule's learning rate at step 2."""
    jargs = jax_config_parser_dnerf().parse_args(_argv(tmp_path, "jax"))
    jscene = type("S", (), {"H": 16, "W": 16, "focal": 20.0})()
    kind, _, params_all, opts, opt_states, _, _, _ = jmr.create_multires(jargs, jscene)
    for l in range(3):
        for _ in range(2):
            g = jax.tree.map(lambda x: jnp.sin(jnp.arange(x.size, dtype=jnp.float32).reshape(x.shape)) * 1e-3,
                             params_all[l])
            updates, opt_states[l] = jax.jit(opts[l].update)(g, opt_states[l], params_all[l])
            params_all[l] = optax.apply_updates(params_all[l], updates)
    jmr.save_multires_ckpt(jargs, kind, params_all, opt_states, 2)
    ckpt = load_tar(str(tmp_path / "jax" / "000002.tar"))

    args = config_parser_dnerf().parse_args(_argv(tmp_path, "jax") + ["--device", "cpu"])
    scene = _tiny_scene()[0]
    kind, states, pyr_hwf, _, start = mr.create_multires(args, scene, torch.device("cpu"))
    assert start == 2 and [st.step for st in states] == [2, 2, 2] and pyr_hwf[2] == [4, 4, 5.0]
    back = load_tar(mr.save_multires_ckpt(config_parser_dnerf().parse_args(_argv(tmp_path, "back")), states, 2))
    assert set(back) == set(ckpt) == {"global_step", *(f"{k}_{l}" for k in ("network_fn", "optimizer")
                                                        for l in range(3))}
    assert ckpt["network_fn_0"]["_occ.pts_linears.0.weight"].shape == (16, 123)
    assert ckpt["network_fn_2"]["_time.0.weight"].shape == (16, 72)
    for l in range(3):
        a, b = back[f"network_fn_{l}"], ckpt[f"network_fn_{l}"]
        assert list(a) == list(b)
        for k, v in b.items():
            assert torch.equal(a[k], torch.as_tensor(v)), (l, k)
        oa, ob = back[f"optimizer_{l}"], ckpt[f"optimizer_{l}"]
        for i, entry in ob["state"].items():
            for f in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(torch.as_tensor(oa["state"][i][f]), torch.as_tensor(entry[f])), (l, i, f)
        assert oa["param_groups"][0]["lr"] == pytest.approx(ob["param_groups"][0]["lr"], rel=1e-12)


def test_host_stream_draws_jax_indices_at_seed_0(monkeypatch):
    """At SWNERF_SEED 0 the port's host stream draws the JAX package's patch
    corners, image indices and neighbour times (its default_rng(0),
    run_multires.py:529), past the centre-only iterations too; another
    seed draws others."""
    pyr_hwf = [[200, 200, 277.0], [100, 100, 138.5], [50, 50, 69.25], [25, 25, 34.6]]
    times = np.linspace(0, 1, 10).astype(np.float32)

    def draws(rng, patches, pick):
        out = []
        for i in (1, 2, 4001, 4002):
            for base in (32, 16):  # 16 fits the coarsest level: the corner is random there
                out.append(patches(rng, pyr_hwf, i, base_patch_size=base))
            img_i = int(rng.choice(np.arange(10)))
            out.append((img_i, pick(rng, times, img_i)))
        return out

    ref = draws(np.random.default_rng(0), jmr.initialize_patches, jax_pick_neighbor_time)
    monkeypatch.setenv("SWNERF_SEED", "0")
    assert draws(neighbor_time_rng(), mr.initialize_patches, pick_neighbor_time) == ref
    assert any(c != (0, 0) for c in ref[1])
    monkeypatch.setenv("SWNERF_SEED", "3")
    assert draws(neighbor_time_rng(), mr.initialize_patches, pick_neighbor_time) != ref
