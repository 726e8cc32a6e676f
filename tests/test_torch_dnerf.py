"""The D-NeRF slice of swnerf_torch, against swnerf_tpu on the CPU: the
fields against ``apply_time_net`` / ``apply_nerf_original`` /
``make_dnerf_field``, the ``.tar`` bridge both ways, the eval pass (B6's and
B3's pts-mode twins) against the JAX one, the eager step against the JAX
reference step, the kernel step (the twins of B6, B3's pts mode, B5 and B2)
against ``make_fused_dnerf_step(interpret=True)`` and against the eager
step, and the TV loss's neighbour times.

Bars: raw and dx atol 1e-5 (multires 10: 3e-5); gradients ``max|d| <= 1e-4
* max|g_ref| + 1e-7`` per tensor; loss and metrics rel 1e-5; rendered maps
atol 1e-5."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from swnerf_torch.models import DirectTemporalNeRF, DNeRFConfig, NeRFOriginal
from swnerf_torch.pipelines.common import Scene, make_time_image_step, neighbor_time_rng, pick_neighbor_time
from swnerf_torch.pipelines.run_dnerf import save_dnerf_ckpt
from swnerf_torch.render.core import Draws, Rays, RenderConfig, make_draws, render_image, render_rays
from swnerf_torch.render.fused_eval import make_dnerf_eval_pass, supports_dnerf_eval_pass
from swnerf_torch.train.checkpoint import dnerf_state_dict, load_tar, params_from_jax
from swnerf_torch.train.fused_step import make_fused_dnerf_step, supports_fused_dnerf_step
from swnerf_torch.train.loop import init_train_state, make_dnerf_train_step
from swnerf_tpu.models.dnerf import DNeRFConfig as JaxConfig
from swnerf_tpu.models.dnerf import make_dnerf_field, make_nerf_original_field
from swnerf_tpu.pipelines.common import Scene as JaxScene
from swnerf_tpu.pipelines.run_dnerf import make_dnerf_step as jax_make_dnerf_step
from swnerf_tpu.pipelines.run_dnerf import pick_neighbor_time as jax_pick_neighbor_time
from swnerf_tpu.render import RenderConfig as JaxRenderConfig
from swnerf_tpu.render.core import Rays as JaxRays
from swnerf_tpu.render.fused_eval import make_dnerf_eval_pass as jax_make_dnerf_eval_pass
from swnerf_tpu.train import checkpoint as jck
from swnerf_tpu.train.fused_step import make_fused_dnerf_step as jax_make_fused_dnerf_step
from swnerf_tpu.train.loop import init_train_state as jax_init_train_state

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CKPT = REPO / "benchmarks" / "round5_artifacts" / "full_dnerf_800k" / "800000.tar"
SMALL = dict(netdepth=3, netwidth=128, skips=(1,), multires=4, multires_views=2)  # tests/test_fused_dnerf_step.py
FULL = dict(netdepth=8, netwidth=256, skips=(4,), multires=10, multires_views=4)


def _jax_params(kw, seed=0, kind="direct_temporal"):
    jcfg = JaxConfig(**kw)
    field = make_dnerf_field(jcfg, fused=False) if kind == "direct_temporal" else make_nerf_original_field(
        jcfg, fused=False)
    return field, jax.tree.map(np.asarray, field.init(jax.random.PRNGKey(seed)))


def _port_model(kw, params, kind="direct_temporal"):
    cls = DirectTemporalNeRF if kind == "direct_temporal" else NeRFOriginal
    model = cls(DNeRFConfig(**kw), device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model


def _rays(n=32, seed=0, with_t0=True):
    """tests/test_fused_dnerf_step.py:_rays, both ways: a quarter of the
    rays at t = 0 (the zero_canonical mask)."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = 4.0
    t = rng.uniform(0.0, 1.0, (n, 1)).astype(np.float32)
    if with_t0:
        t[: n // 4] = 0.0
    target = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    jrays = JaxRays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(d), jnp.full((n,), 2.0), jnp.full((n,), 6.0),
                    jnp.asarray(t))
    f = torch.from_numpy
    rays = Rays(f(o), f(d), f(d.copy()), torch.full((n,), 2.0), torch.full((n,), 6.0), f(t))
    return jrays, rays, target


def _assert_grads_close(got, ref, rel=1e-4):
    assert set(got) == set(ref)
    for k in ref:
        g, r = np.asarray(got[k], np.float64), np.asarray(ref[k], np.float64)
        err = np.abs(g - r).max()
        assert err <= rel * np.abs(r).max() + 1e-7, (k, err, np.abs(r).max())


def _grads_of(state):
    out = {f"coarse.{k}": p.grad.detach().clone().numpy() for k, p in state.coarse.named_parameters()}
    if state.fine is not None:
        out.update({f"fine.{k}": p.grad.detach().clone().numpy() for k, p in state.fine.named_parameters()})
    return out


def _grad_stash():
    """An optax transformation whose state is the last gradient (and whose
    update is zero): JAX's gradients before any optimizer touches them."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g),
    )


def _jax_grads(opt_state):
    out = {}
    for net in ("coarse", "fine"):
        if opt_state.get(net) is not None:
            out.update({f"{net}.{k}": v.numpy()
                        for k, v in params_from_jax(jax.tree.map(np.asarray, opt_state[net])).items()})
    return out


# ---------------------------------------------------------------- the fields


@pytest.mark.parametrize("zero_canonical", [True, False])
@pytest.mark.parametrize("kw,atol", [(SMALL, 1e-5), (FULL, 3e-5)], ids=["small", "full"])
def test_dnerf_field_matches_make_dnerf_field(kw, atol, zero_canonical):
    """DirectTemporalNeRF against make_dnerf_field(fused=False).apply on a
    mixed-time batch (a quarter of the rays at t = 0): raw and dx within
    atol, rtol 5e-4, and dx exactly 0 on the t = 0 rays under
    zero_canonical. At D=8, W=256, multires 10 the canonical net reads x + dx
    at frequencies up to 2^9, so dx's fp32 rounding moves raw by up to 5.6e-5
    (relative 7e-5)."""
    kw = dict(kw, zero_canonical=zero_canonical)
    field, params = _jax_params(kw, seed=1)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1.2, 1.2, (8, 5, 3)).astype(np.float32)
    vd = rng.standard_normal((8, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    t = rng.uniform(0, 1, (8, 1)).astype(np.float32)
    t[:2] = 0.0
    raw_ref, aux = field.apply(params, jnp.asarray(pts), jnp.asarray(vd), jnp.asarray(t))
    raw, got = _port_model(kw, params)(torch.from_numpy(pts), torch.from_numpy(vd), torch.from_numpy(t))
    np.testing.assert_allclose(raw.detach().numpy(), np.asarray(raw_ref), atol=atol, rtol=5e-4)
    np.testing.assert_allclose(got["dx"].detach().numpy(), np.asarray(aux["dx"]), atol=atol, rtol=5e-4)
    assert (not got["dx"][:2].any()) == zero_canonical and got["dx"][2:].abs().min() > 0


def test_nerf_original_matches_and_returns_zero_dx():
    """NeRFOriginal (``--nerf_type original``) against
    make_nerf_original_field: raw within 1e-5, dx = 0, the vanilla keys."""
    field, params = _jax_params(SMALL, seed=2, kind="original")
    pts = np.random.default_rng(1).uniform(-1, 1, (4, 6, 3)).astype(np.float32)
    vd = np.tile(np.array([[0.0, 0.6, -0.8]], np.float32), (4, 1))
    raw_ref, aux = field.apply(params, jnp.asarray(pts), jnp.asarray(vd), jnp.zeros((4, 1)))
    model = _port_model(SMALL, params, kind="original")
    raw, got = model(torch.from_numpy(pts), torch.from_numpy(vd), torch.full((4, 1), 0.5))
    np.testing.assert_allclose(raw.detach().numpy(), np.asarray(raw_ref), atol=1e-5, rtol=0)
    assert not got["dx"].any() and not np.asarray(aux["dx"]).any()
    names = [n for n, _ in model.named_parameters()]
    assert names == [f"{n}.{f}" for n, _ in jck.model_layout("original", params) for f in ("weight", "bias")]


def test_dnerf_registers_the_tar_order_and_inits():
    """parameters() walks _occ.* (pts_linears, views_linears, feature,
    alpha, rgb), _time.{i}, _time_out: the .tar's order; the canonical
    weights are kaiming-normal (std sqrt(2 / fan_in)), the deformation MLP's
    torch's default uniform; the skip layers take embed(x) only."""
    model = DirectTemporalNeRF(DNeRFConfig(), device="cpu", generator=torch.Generator().manual_seed(0))
    _, params = _jax_params(FULL)
    names = [n for n, _ in model.named_parameters()]
    assert names == [f"{n}.{f}" for n, _ in jck.model_layout("direct_temporal", params) for f in ("weight", "bias")]
    assert len(names) == 42
    assert model._time[5].weight.shape == (256, 319) and model._time[0].weight.shape == (256, 84)
    w = model._occ.pts_linears[1].weight
    assert abs(w.std().item() - (2.0 / 256) ** 0.5) < 0.005
    wt = model._time[1].weight
    assert wt.abs().max() <= 1 / 16 and abs(wt.std().item() - 1 / 16 / 3**0.5) < 0.003


# ---------------------------------------------------------------- checkpoints


def test_800k_checkpoint_loads_with_its_adam_state():
    """benchmarks/round5_artifacts/full_dnerf_800k/800000.tar: its three keys,
    42 tensors into DirectTemporalNeRF() as they are, 42 Adam entries at step
    800000 in registration order, and the JAX package reads the same
    weights."""
    ckpt = load_tar(str(CKPT))
    assert set(ckpt) == {"global_step", "network_fn_state_dict", "optimizer_state_dict"}
    assert ckpt["global_step"] == 800000 and len(ckpt["network_fn_state_dict"]) == 42
    model = DirectTemporalNeRF(DNeRFConfig(), device="cpu")
    model.load_state_dict(dnerf_state_dict(ckpt["network_fn_state_dict"]))
    state = init_train_state(model, None, 5e-4, 500, step=800000)
    state.optimizer.load_state_dict(ckpt["optimizer_state_dict"])
    opt = state.optimizer.state_dict()
    assert len(opt["state"]) == 42
    for p, (_, entry) in zip(model.parameters(), sorted(opt["state"].items())):
        assert int(entry["step"]) == 800000 and entry["exp_avg"].shape == p.shape
    _, template = _jax_params(FULL)
    jparams = jck.state_dict_to_params("direct_temporal", ckpt["network_fn_state_dict"], template)
    for k, v in params_from_jax(jax.tree.map(np.asarray, jparams)).items():
        assert torch.equal(model.state_dict()[k], v), k


@pytest.mark.parametrize("two_models", [False, True])
def test_jax_written_tar_loads_and_saves_back_bit_for_bit(tmp_path, two_models):
    """A .tar written by the JAX package (params_to_state_dict,
    adam_to_torch_dict of a real Adam state) loads into the port's models
    and torch Adam, and save_dnerf_ckpt writes it back with every tensor
    bit-equal; two models write the fine dict (checkpoint.py:8)."""
    _, pc = _jax_params(SMALL, 0)
    _, pf = _jax_params(SMALL, 1)
    params = {"coarse": pc, "fine": pf if two_models else None}
    opt = optax.adam(5e-4)
    js = jax_init_train_state(jax.tree.map(jnp.asarray, params), opt)
    g = jax.tree.map(lambda x: jnp.sin(jnp.arange(x.size, dtype=jnp.float32).reshape(x.shape)) * 1e-3, js.params)
    updates, opt_state = opt.update(g, js.opt_state, js.params)
    js = js._replace(params=optax.apply_updates(js.params, updates), opt_state=opt_state, step=jnp.asarray(7))
    groups = [("direct_temporal", "coarse")] + ([("direct_temporal", "fine")] if two_models else [])
    payload = {"global_step": 7,
               "network_fn_state_dict": jck.params_to_state_dict("direct_temporal", js.params["coarse"])}
    if two_models:
        payload["network_fine_state_dict"] = jck.params_to_state_dict("direct_temporal", js.params["fine"])
    payload["optimizer_state_dict"] = jck.adam_to_torch_dict(js.opt_state, js.params, groups, 5e-4 * 0.1 ** (7 / 250e3))
    src = tmp_path / "000007.tar"
    jck.save_tar(str(src), payload)

    ckpt = load_tar(str(src))
    cfg = DNeRFConfig(**SMALL)
    coarse = DirectTemporalNeRF(cfg, device="cpu")
    coarse.load_state_dict(dnerf_state_dict(ckpt["network_fn_state_dict"]))
    fine = None
    if two_models:
        fine = DirectTemporalNeRF(cfg, device="cpu")
        fine.load_state_dict(dnerf_state_dict(ckpt["network_fine_state_dict"]))
    state = init_train_state(coarse, fine, 5e-4, 250, step=7)
    state.optimizer.load_state_dict(ckpt["optimizer_state_dict"])

    args = type("Args", (), {"basedir": str(tmp_path), "expname": "back"})()
    back = load_tar(save_dnerf_ckpt(args, state, 7))
    assert set(back) == set(ckpt)
    for key in ("network_fn_state_dict", "network_fine_state_dict"):
        if key in ckpt:
            assert list(back[key]) == list(ckpt[key])
            for k, v in ckpt[key].items():
                assert torch.equal(torch.as_tensor(back[key][k]), torch.as_tensor(v)), (key, k)
    a, b = back["optimizer_state_dict"], ckpt["optimizer_state_dict"]
    assert len(a["state"]) == len(b["state"]) == len(list(coarse.parameters())) * (2 if two_models else 1)
    for i, entry in b["state"].items():
        for f in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(torch.as_tensor(a["state"][i][f]), torch.as_tensor(entry[f])), (i, f)
    assert a["param_groups"][0]["lr"] == pytest.approx(b["param_groups"][0]["lr"], rel=1e-12)


# ---------------------------------------------------------------- the eval pass


@pytest.mark.parametrize("white_bkgd", [True, False])
@pytest.mark.parametrize("two_models", [False, True])
def test_dnerf_eval_pass_matches_jax(white_bkgd, two_models):
    """The port's D-NeRF eval pass (the fp32 twins of B6, B3's pts mode and
    B2) against the JAX one (interpret mode, fp32), 13 rays with a quarter
    at t = 0, 8 + 8 samples: rgb, disp, acc, depth within atol 1e-5, rtol
    1e-5."""
    _, pc = _jax_params(SMALL, 0)
    _, pf = _jax_params(SMALL, 1)
    jrays, rays, _ = _rays(13)
    ecfg = RenderConfig(n_samples=8, n_importance=8, white_bkgd=white_bkgd).eval_mode()
    jecfg = JaxRenderConfig(n_samples=8, n_importance=8, white_bkgd=white_bkgd).eval_mode()
    jcfg = JaxConfig(**SMALL)
    ref = jax_make_dnerf_eval_pass(jcfg, interpret=True, compute_dtype=jnp.float32)(
        pc, pf if two_models else None, None, jrays, jecfg)
    coarse = _port_model(SMALL, pc)
    fine = _port_model(SMALL, pf) if two_models else None
    ep = make_dnerf_eval_pass(coarse.cfg, compute_dtype=torch.float32)
    assert ep.supports_times and supports_dnerf_eval_pass(coarse.cfg)
    got = ep(ep.pack(coarse), ep.pack(fine) if fine is not None else None, rays, ecfg)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=1e-5)


def test_render_image_uses_the_dnerf_pass_and_matches_render_rays():
    """render_image takes the D-NeRF pass for rays with times and agrees
    with the plain render_rays path (atol 1e-5), which carries dx out."""
    _, pc = _jax_params(SMALL, 0)
    model = _port_model(SMALL, pc)
    _, rays, _ = _rays(20)
    cfg = RenderConfig(n_samples=8, n_importance=8, white_bkgd=True)
    fast = render_image(model, rays, cfg, chunk=7, eval_pass=make_dnerf_eval_pass(model.cfg, torch.float32))
    plain = render_image(model, rays, cfg, chunk=7)
    for k in ("rgb", "acc", "depth"):
        np.testing.assert_allclose(fast[k].numpy(), plain[k].numpy(), atol=1e-5)
    out = render_rays(model, rays, dataclasses.replace(cfg, coarse_contributes=False).eval_mode())
    assert out["dx"].shape == (20, 16, 3) and "rgb0" not in out and not out["dx"][:5].any()


# ---------------------------------------------------------------- the steps


def _jax_draws(rcfg, n, key, step=0):
    """JAX's draws of one train step: fold_in(key, step), split 4."""
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


def _configs(n_importance=8, two_models=False, noise=0.0, perturb=0.0, zero_canonical=True):
    rc = dict(n_samples=8, n_importance=n_importance, perturb=perturb, white_bkgd=True, raw_noise_std=noise,
              coarse_contributes=two_models)
    return JaxRenderConfig(**rc), RenderConfig(**rc), dict(SMALL, zero_canonical=zero_canonical)


def _states(kw, two_models, stash):
    _, pc = _jax_params(kw, 0)
    _, pf = _jax_params(kw, 1)
    jparams = {"coarse": pc, "fine": pf if two_models else None}
    js = jax_init_train_state(jax.tree.map(jnp.asarray, jparams), stash)
    state = init_train_state(_port_model(kw, pc), _port_model(kw, pf) if two_models else None, 5e-3, 250)
    return js, state


def _tiny_scene(n=5, size=16, seed=0):
    """The port's and the JAX package's Scene for the same random images,
    poses and frame times."""
    rng = np.random.default_rng(seed)
    poses = np.stack([np.eye(4, dtype=np.float32) for _ in range(n)])
    poses[:, :3, 3] = rng.standard_normal((n, 3)) * 0.2 + np.array([0.0, 0.0, 4.0])
    images = rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)
    times = np.linspace(0, 1, n).astype(np.float32)
    K = np.array([[20.0, 0, 0.5 * size], [0, 20.0, 0.5 * size], [0, 0, 1]])
    kw = dict(images=images, poses=poses, render_poses=poses, H=size, W=size, focal=20.0, K=K, near=2.0, far=6.0,
              i_train=np.arange(n), i_val=np.arange(0), i_test=np.arange(0))
    return Scene(**kw, times=times), JaxScene(**kw), images, poses, times


@pytest.mark.parametrize("mode", ["deterministic", "random"])
@pytest.mark.parametrize("two_models", [False, True])
def test_eager_step_matches_jax_reference_step(mode, two_models):
    """One eager D-NeRF step (render_rays with times, the TV re-render at the
    neighbour time on the stopped z_vals, MSE terms, autograd) against the
    JAX package's make_dnerf_step on the same weights, pixels and draws,
    both through their make_time_image_step: 32 pixels of frame 1 (t =
    0.25), then of frame 0 (t = 0, the zero_canonical mask). Metrics rel
    1e-5, from the port's fp32 step or its float64 step (the TV term's
    difference relative to the total loss it enters). Each gradient
    tensor before the optimizer within 1e-4 * max|g| + 1e-7 of JAX's
    (fp32), from the port's fp32 or float64 step; or, where fp32 rounding
    flips a ReLU in either package, the port's fp32 step no further from
    its float64 step than twice JAX's fp32 step is. The step's gradients
    are autograd's of a forward held to JAX's, so the float64 step is the
    function both packages compute. Measured on frame 1 (relative to
    max|g|): the fp32 step up to 1.2e-2 from the float64 step; the float64
    step within 4.7e-5 of JAX's, except one two-model tensor at 1.5e-3,
    where JAX's fp32 step is as far from it as the port's."""
    noise, perturb = (0.0, 0.0) if mode == "deterministic" else (0.7, 1.0)
    jrc, rcfg, kw = _configs(two_models=two_models, noise=noise, perturb=perturb)
    stash = _grad_stash()
    scene, jscene, images, poses, times = _tiny_scene()
    pixels = np.random.default_rng(3).integers(0, 16, (32, 2))
    key = jax.random.PRNGKey(42)
    jcfg = JaxConfig(**kw)
    field = make_dnerf_field(jcfg, fused=False)
    jstep = jax_make_dnerf_step(field, jrc, stash, jscene, True, 1e-2, fine_field=field if two_models else None)
    draws = _jax_draws(rcfg, 32, key) if mode == "random" else None
    for img_i in (1, 0):
        js, _ = _states(kw, two_models, stash)
        s_ref, m_ref = jstep.__wrapped__(js, jnp.asarray(images), jnp.asarray(poses), jnp.asarray(times), img_i,
                                         jnp.asarray(pixels), jnp.float32(0.37), key)
        ref = _jax_grads(s_ref.opt_state)
        grads, metrics = {}, {}
        for dtype in (torch.float32, torch.float64):
            _, state = _states(kw, two_models, stash)
            _to(state, dtype)
            cast = lambda x: None if x is None else x.to(dtype)  # noqa: E731

            def step(st, rays, target, nt, gen):  # the float64 step takes the fp32 image step's rays, cast
                return make_dnerf_train_step(rcfg, True, 1e-2)(
                    st, Rays(*(cast(x) for x in rays)), cast(target), nt,
                    draws=None if draws is None else Draws(*(cast(x) for x in draws)))

            metrics[dtype] = make_time_image_step(step, rcfg, scene, pass_neighbor=True)(
                state, torch.from_numpy(images), torch.from_numpy(poses[:, :3, :4]), torch.from_numpy(times), img_i,
                pixels, 0.37)
            grads[dtype] = _grads_of(state)
        assert set(metrics[torch.float32]) == set(m_ref)
        for k in m_ref:  # the TV term (a sum of squared dx differences) against the total loss it enters
            ok = [abs(float(m[k]) - float(m_ref[k])) <= 1e-5 * float(m_ref["total_loss" if k == "tv" else k])
                  for m in metrics.values()]
            assert any(ok), (img_i, k)
        g32, g64 = grads[torch.float32], grads[torch.float64]
        for k, r in ref.items():
            def dist(a, b):
                return np.abs(a - b).max()
            bar = 1e-4 * np.abs(r).max() + 1e-7
            assert min(dist(g32[k], r), dist(g64[k], r)) <= bar or dist(g32[k], g64[k]) <= 2 * dist(r, g64[k]), \
                (img_i, k)


def _to(state, dtype):
    """The state's models in ``dtype`` (the tests read the gradients of one
    step)."""
    for m in (state.coarse, state.fine):
        if m is not None:
            m.to(dtype)
    return state


def _port_step(kw, two_models, rcfg, add_tv, rays, target, neighbor_time, dtype, draws=None):
    """One kernel step (twins) of the port in ``dtype``; its gradients and
    metrics."""
    cfg = DNeRFConfig(**kw)
    _, state = _states(kw, two_models, optax.sgd(1.0))
    _to(state, dtype)
    cast = lambda x: None if x is None else x.to(dtype)  # noqa: E731
    step = make_fused_dnerf_step(cfg, rcfg, fcfg=cfg if two_models else None, add_tv_loss=add_tv,
                                 tv_loss_weight=1e-2, compute_dtype=dtype)
    m = step(state, Rays(*(cast(x) for x in rays)), cast(target), neighbor_time,
             draws=None if draws is None else Draws(*(cast(x) for x in draws)))
    return _grads_of(state), m


@pytest.mark.parametrize("case", ["shared_tv", "two_models_tv", "no_tv_no_zero_canonical", "coarse_only_tv"])
def test_kernel_step_matches_jax_fused_step(case):
    """The kernel D-NeRF step on the twins against
    make_fused_dnerf_step(interpret=True, fp32), deterministic (perturb 0,
    noise 0), the cases of tests/test_fused_dnerf_step.py: metrics rel
    1e-5; each gradient tensor before the optimizer within 1e-4 * max|g| +
    1e-7 of JAX's, from the port's fp32 step or from its float64 step.

    The float64 step is the exact function. fp32 alone cannot carry the bar
    through this pipeline: fp32 rounding of the coarse weights moves the
    fine samples (B2) by ~1e-6, which can flip a ReLU in either package.
    Measured worst max|d| / max|g| (port fp32, port float64): shared_tv
    2.6e-5 / 3.2e-4, two_models_tv 6.7e-4 / 4.7e-5, no_tv 2.2e-6 / 8.2e-6,
    coarse_only_tv 1.3e-5 / 4.7e-5."""
    two_models = case == "two_models_tv"
    add_tv = case != "no_tv_no_zero_canonical"
    jrc, rcfg, kw = _configs(n_importance=0 if case == "coarse_only_tv" else 8, two_models=two_models,
                             zero_canonical=case != "no_tv_no_zero_canonical")
    cfg, jcfg = DNeRFConfig(**kw), JaxConfig(**kw)
    stash = _grad_stash()
    js, _ = _states(kw, two_models, stash)
    jrays, rays, target = _rays(32)
    jstep = jax_make_fused_dnerf_step(jcfg, jrc, stash, fcfg=jcfg if two_models else None, add_tv_loss=add_tv,
                                      tv_loss_weight=1e-2, interpret=True, compute_dtype=jnp.float32)
    s_ref, m_ref = jstep(js, jrays, jnp.asarray(target), jnp.float32(0.37), jax.random.PRNGKey(42))
    ref = _jax_grads(s_ref.opt_state)
    assert supports_fused_dnerf_step(cfg, cfg if two_models else None, rcfg)
    g32, m = _port_step(kw, two_models, rcfg, add_tv, rays, torch.from_numpy(target), 0.37, torch.float32)
    g64, _ = _port_step(kw, two_models, rcfg, add_tv, rays, torch.from_numpy(target), 0.37, torch.float64)
    assert set(g32) == set(g64) == set(ref)
    for k, r in ref.items():
        bar = 1e-4 * np.abs(r).max() + 1e-7
        assert min(np.abs(g32[k] - r).max(), np.abs(g64[k] - r).max()) <= bar, k
    assert set(m) == set(m_ref)
    for k in m_ref:
        assert float(m[k]) == pytest.approx(float(m_ref[k]), rel=1e-5), k


@pytest.mark.parametrize("two_models", [False, True])
@pytest.mark.parametrize("kw", [SMALL, dict(netdepth=6, netwidth=128, skips=(4,), multires=10, multires_views=4)],
                         ids=["small", "multires10"])
def test_kernel_step_matches_eager_step(kw, two_models):
    """The kernel step (twins) against the port's eager step, both in
    float64, from the same state and random draws (perturb 1, noise 0.7, TV
    on, a quarter of the rays at t = 0): gradients at the bar, metrics rel
    1e-5 (measured: gradients within 5.5e-8 * max|g|). In fp32 the eager step
    itself lands 2e-3 (multires 4) to O(1) (multires 10, random weights)
    from its float64 value, so only float64 tells the two computations
    apart."""
    _, rcfg, _ = _configs(two_models=two_models, noise=0.7, perturb=1.0)
    _, rays, target = _rays(27)
    rays = Rays(*(None if x is None else x.double() for x in rays))
    target = torch.from_numpy(target).double()
    draws = make_draws(rcfg, 27, torch.Generator().manual_seed(7), "cpu")
    draws = Draws(*(None if x is None else x.double() for x in draws))
    _, s_eager = _states(kw, two_models, optax.sgd(1.0))
    _to(s_eager, torch.float64)
    m_eager = make_dnerf_train_step(rcfg, True, 1e-2)(s_eager, rays, target, 0.61, draws=draws)
    g_kernel, m_kernel = _port_step(kw, two_models, rcfg, True, rays, target, 0.61, torch.float64, draws)
    assert set(m_kernel) == set(m_eager)
    for k in m_eager:
        assert float(m_kernel[k]) == pytest.approx(float(m_eager[k]), rel=1e-5), k
    _assert_grads_close(g_kernel, _grads_of(s_eager))


def test_supports_fused_dnerf_step():
    rcfg = RenderConfig(n_samples=8, n_importance=8)
    cfg = DNeRFConfig(**SMALL)
    assert supports_fused_dnerf_step(cfg, cfg, rcfg) and supports_fused_dnerf_step(DNeRFConfig(), None, rcfg)
    assert not supports_fused_dnerf_step(DNeRFConfig(netwidth=100), None, rcfg)
    assert not supports_fused_dnerf_step(cfg, DNeRFConfig(**dict(SMALL, multires=6)), rcfg)
    assert not supports_fused_dnerf_step(cfg, None, RenderConfig(use_viewdirs=False))


# ---------------------------------------------------------------- neighbour times


def test_pick_neighbor_time_matches_jax_at_seed_0(monkeypatch):
    """At SWNERF_SEED 0 the port draws the JAX package's neighbour times
    (its host generator is default_rng(0)); another seed draws others; every
    time lies between the frame's and a neighbour's."""
    times = np.linspace(0.0, 1.0, 9).astype(np.float32)
    frames = [0, 8, 3, 4, 4, 7, 1, 5, 2, 6] * 3
    ref_rng = np.random.default_rng(0)
    ref = [jax_pick_neighbor_time(ref_rng, times, i) for i in frames]
    monkeypatch.setenv("SWNERF_SEED", "0")
    rng = neighbor_time_rng()
    assert [pick_neighbor_time(rng, times, i) for i in frames] == ref
    monkeypatch.setenv("SWNERF_SEED", "3")
    rng = neighbor_time_rng()
    other = [pick_neighbor_time(rng, times, i) for i in frames]
    assert other != ref
    for i, t in zip(frames, other):
        lo, hi = times[max(i - 1, 0)], times[min(i + 1, 8)]
        assert lo <= t <= hi
