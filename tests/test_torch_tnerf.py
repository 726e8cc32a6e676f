"""The T-NeRF slice of swnerf_torch, against swnerf_tpu on the CPU: the
field against ``apply_tnerf``, the eval pass (B4's twin) against the JAX
one (Pallas in interpret mode), one eager train step against the JAX
reference step, the kernel step (B4's twin) against the eager step, and the
round-5 800000.tar checkpoint.

Bars: raw outputs atol 1e-5; gradients ``max|d| <= 1e-4 * max|g_ref| +
1e-7`` per tensor; loss and metrics rel 1e-5; rendered maps atol 1e-5 at
multires 4/2."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from swnerf_torch.models import TNeRF, TNeRFConfig
from swnerf_torch.render.core import Draws, Rays, RenderConfig, make_draws, render_image
from swnerf_torch.render.fused_eval import make_tnerf_eval_pass
from swnerf_torch.train.checkpoint import load_tar, params_from_jax, tnerf_state_dict
from swnerf_torch.train.fused_step import make_fused_tnerf_step, supports_fused_tnerf_step
from swnerf_torch.train.loop import init_train_state, make_train_step
from swnerf_tpu.models.tnerf import TNeRFConfig as JaxConfig
from swnerf_tpu.models.tnerf import apply_tnerf, init_tnerf_params, make_tnerf_field
from swnerf_tpu.ops.embedding import positional_encoding as jax_pe
from swnerf_tpu.render import RenderConfig as JaxRenderConfig
from swnerf_tpu.render import render_rays as jax_render_rays
from swnerf_tpu.render.core import Rays as JaxRays
from swnerf_tpu.render.fused_eval import make_tnerf_eval_pass as jax_make_tnerf_eval_pass
from swnerf_tpu.train import checkpoint as jck
from swnerf_tpu.train.loop import TrainState as JaxTrainState
from swnerf_tpu.train.loop import init_train_state as jax_init_train_state
from swnerf_tpu.train.loop import mse, mse_to_psnr

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CKPT = REPO / "benchmarks" / "round5_artifacts" / "full_tnerf_800k" / "800000.tar"
SMALL = dict(netdepth=4, net_dim=128, skip_layer=2, multires=4, multires_views=2)


def _jax_params(kw, seed=0):
    return jax.tree.map(np.asarray, init_tnerf_params(jax.random.PRNGKey(seed), JaxConfig(**kw)))


def _port_model(kw, params):
    model = TNeRF(TNeRFConfig(**kw), device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model


def _rays(n=32, seed=0):
    """The ray batch of tests/test_fused_tnerf_step.py:_rays, both ways."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = 4.0
    t = rng.uniform(0.0, 1.0, (n, 1)).astype(np.float32)
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
    return {k: p.grad.detach().clone().numpy() for k, p in state.coarse.named_parameters()}


def test_tnerf_matches_apply_tnerf():
    """D=8, W=128, skip 4, multires 10/4 (the shipped widths), weights
    through params_from_jax: raw within atol 1e-5 (measured 6.7e-8 over
    seeds 0-3)."""
    kw = dict(netdepth=8, net_dim=128, skip_layer=4, multires=10, multires_views=4)
    params = _jax_params(kw, seed=1)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1.5, 1.5, (6, 5, 3)).astype(np.float32)
    vd = rng.standard_normal((6, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    t = rng.uniform(0, 1, (6, 1)).astype(np.float32)
    jcfg = JaxConfig(**kw)
    ve = np.broadcast_to(np.asarray(jax_pe(jnp.asarray(vd), jcfg.nf_views))[:, None, :], (6, 5, jcfg.dir_feat))
    te = jax_pe(jnp.broadcast_to(jnp.asarray(t)[:, None, :], (6, 5, 1)), jcfg.nf_time)
    ref = np.asarray(apply_tnerf(params, jcfg, jax_pe(jnp.asarray(pts), jcfg.nf_pts), jnp.asarray(ve), te))
    got = _port_model(kw, params)(torch.from_numpy(pts), torch.from_numpy(vd), torch.from_numpy(t))
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-5, rtol=0)


def test_tnerf_registers_the_tar_order():
    """parameters() walks layers.{i}.0, density.0, feature.0, layer_9.0,
    color.0 (weight, bias each): the .tar's order, so Adam's state maps."""
    model = TNeRF(TNeRFConfig(), device="cpu")
    names = [n for n, _ in model.named_parameters()]
    layout = [f"{name}.{f}" for name, _ in jck.model_layout("tnerf", {"layers": [0] * 8}) for f in ("weight", "bias")]
    assert names == layout and len(names) == 24
    assert model.layers[5][0].weight.shape == (128, 212) and model.layer_9[0].weight.shape == (64, 155)


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_tnerf_eval_pass_matches_jax(white_bkgd):
    """The port's T-NeRF eval pass (B4's twin, fp32) against the JAX one
    (Pallas, interpret mode, fp32), 13 rays of frame times in [0, 1], 8
    samples: rgb, disp, acc, depth within atol 1e-5, rtol 1e-5 (measured
    1.8e-6 relative to 1 + |ref| over seeds 0-3 and both backgrounds)."""
    params = _jax_params(SMALL)
    jrays, rays, _ = _rays(13)
    ecfg = RenderConfig(n_samples=8, white_bkgd=white_bkgd).eval_mode()
    jecfg = JaxRenderConfig(n_samples=8, n_importance=0, white_bkgd=white_bkgd).eval_mode()
    ref = jax_make_tnerf_eval_pass(JaxConfig(**SMALL), interpret=True, compute_dtype=jnp.float32)(
        params, None, None, jrays, jecfg
    )
    model = _port_model(SMALL, params)
    ep = make_tnerf_eval_pass(model.cfg, compute_dtype=torch.float32)
    assert ep.supports_times
    got = ep(ep.pack(model), None, rays, ecfg)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="single-pass"):
        ep(ep.pack(model), None, rays, RenderConfig(n_samples=8, n_importance=8).eval_mode())


def test_render_image_uses_the_tnerf_pass_only_with_times():
    """render_image takes the eval pass for rays with times and agrees with
    the plain render_rays path (atol 1e-5); rays without times never reach
    the T-NeRF pass (the plain path runs, and the field asks for times)."""
    model = _port_model(SMALL, _jax_params(SMALL))
    _, rays, _ = _rays(20)
    cfg = RenderConfig(n_samples=8, white_bkgd=True)
    inner = make_tnerf_eval_pass(model.cfg, compute_dtype=torch.float32)
    calls = []

    class Counting:
        supports_times = True
        pack = staticmethod(inner.pack)

        def __call__(self, *args):
            calls.append(1)
            return inner(*args)

    fast = render_image(model, rays, cfg, chunk=7, eval_pass=Counting())
    plain = render_image(model, rays, cfg, chunk=7)
    assert len(calls) == 3
    for k in ("rgb", "acc", "depth"):
        np.testing.assert_allclose(fast[k].numpy(), plain[k].numpy(), atol=1e-5)
    with pytest.raises(TypeError):
        render_image(model, rays._replace(times=None), cfg, chunk=7, eval_pass=Counting())
    assert len(calls) == 3


def _jax_draws(rcfg, n, key, step=0):
    """JAX's draws of one train step: fold_in(key, step), split 4."""
    k_jit, k_noise0, _, _ = jax.random.split(jax.random.fold_in(key, step), 4)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return Draws(
        t_rand=t(jax.random.uniform(k_jit, (n, rcfg.n_samples))) if rcfg.perturb > 0 else None,
        noise0=t(jax.random.normal(k_noise0, (n, rcfg.n_samples)) * rcfg.raw_noise_std)
        if rcfg.raw_noise_std > 0 else None,
        u=None, noise1=None,
    )


def _jax_ref_step(field, rcfg):
    """tests/test_fused_tnerf_step.py:_make_ref_step (make_dnerf_step's inner
    semantics without TV), with an optimizer whose state is the gradient."""
    stash = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g)
    )

    def loss_fn(params, rays, target, rng):
        out = jax_render_rays(field, params["coarse"], rays, rcfg, rng=rng)
        img_loss = mse(out["rgb"], target)
        return img_loss, {"loss": img_loss, "psnr": mse_to_psnr(img_loss), "total_loss": img_loss}

    def step(state, rays, target, rng):
        grads, metrics = jax.grad(loss_fn, has_aux=True)(state.params, rays, target, jax.random.fold_in(rng, state.step))
        updates, opt_state = stash.update(grads, state.opt_state, state.params)
        return JaxTrainState(state.step + 1, optax.apply_updates(state.params, updates), opt_state), metrics

    return stash, step


@pytest.mark.parametrize("mode", ["deterministic", "random"])
def test_eager_step_matches_jax_reference_step(mode):
    """One eager T-NeRF step (render_rays with times, MSE, autograd) against
    the JAX reference step on the same weights and draws: gradients at the
    bar, metrics rel 1e-5."""
    noise, perturb = (0.0, 0.0) if mode == "deterministic" else (0.7, 1.0)
    jrc = JaxRenderConfig(n_samples=8, n_importance=0, perturb=perturb, white_bkgd=True, raw_noise_std=noise)
    rcfg = RenderConfig(n_samples=8, perturb=perturb, white_bkgd=True, raw_noise_std=noise)
    jrays, rays, target = _rays(32)
    params = _jax_params(SMALL)
    field = make_tnerf_field(JaxConfig(**SMALL), fused=False)
    stash, step = _jax_ref_step(field, jrc)
    key = jax.random.PRNGKey(42)
    s_ref, m_ref = jax.jit(step)(jax_init_train_state({"coarse": params, "fine": None}, stash), jrays,
                                 jnp.asarray(target), key)
    jgrads = {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, s_ref.opt_state["coarse"])).items()}

    state = init_train_state(_port_model(SMALL, params), None, 5e-3, 250)
    m = make_train_step(rcfg)(state, rays, torch.from_numpy(target), draws=_jax_draws(rcfg, 32, key))
    _assert_grads_close(_grads_of(state), jgrads)
    assert set(m) == set(m_ref)
    for k in m_ref:
        assert float(m[k]) == pytest.approx(float(m_ref[k]), rel=1e-5), k


@pytest.mark.parametrize("kw", [SMALL, dict(SMALL, multires=10, multires_views=4)], ids=["small", "multires10"])
def test_kernel_step_matches_eager_step(kw):
    """The kernel T-NeRF step (B4's twin on the CPU, fp32) against the eager
    step from the same state and draws: gradients at the bar, loss rel
    1e-5; both steps then ran Adam once."""
    cfg = TNeRFConfig(**kw)
    rcfg = RenderConfig(n_samples=8, perturb=1.0, white_bkgd=True, raw_noise_std=0.7)
    assert supports_fused_tnerf_step(cfg, rcfg)
    assert not supports_fused_tnerf_step(cfg, RenderConfig(n_samples=8, n_importance=8))
    _, rays, target = _rays(27)
    target = torch.from_numpy(target)
    draws = make_draws(rcfg, 27, torch.Generator().manual_seed(7), "cpu")
    params = _jax_params(kw)
    s_eager, s_kernel = (init_train_state(_port_model(kw, params), None, 5e-3, 250) for _ in range(2))
    m_eager = make_train_step(rcfg)(s_eager, rays, target, draws=draws)
    m_kernel = make_fused_tnerf_step(cfg, rcfg)(s_kernel, rays, target, draws=draws)
    assert set(m_kernel) == set(m_eager)
    for k in m_eager:
        assert float(m_kernel[k]) == pytest.approx(float(m_eager[k]), rel=1e-5), k
    _assert_grads_close(_grads_of(s_kernel), _grads_of(s_eager))
    assert s_kernel.step == s_eager.step == 1


def test_800k_checkpoint_loads_with_its_adam_state():
    """benchmarks/round5_artifacts/full_tnerf_800k/800000.tar: its three
    keys, weights into TNeRF() as they are, 24 Adam entries at step 800000
    whose moments have the shapes of the parameters in registration order,
    and the JAX package reads the same weights."""
    ckpt = load_tar(str(CKPT))
    assert set(ckpt) == {"global_step", "network_fn_state_dict", "optimizer_state_dict"}
    assert ckpt["global_step"] == 800000
    model = TNeRF(TNeRFConfig(), device="cpu")
    model.load_state_dict(tnerf_state_dict(ckpt["network_fn_state_dict"]))
    state = init_train_state(model, None, 5e-4, 500, step=800000)
    state.optimizer.load_state_dict(ckpt["optimizer_state_dict"])
    opt = state.optimizer.state_dict()
    assert len(opt["state"]) == 24
    assert opt["param_groups"][0]["lr"] == pytest.approx(5e-4 * 0.1 ** (800000 / 500000), rel=1e-6)
    for p, (i, entry) in zip(model.parameters(), sorted(opt["state"].items())):
        assert int(entry["step"]) == 800000
        assert entry["exp_avg"].shape == p.shape and entry["exp_avg_sq"].shape == p.shape
    template = _jax_params(dict(netdepth=8, net_dim=128, skip_layer=4, multires=10, multires_views=4))
    jparams = jck.state_dict_to_params("tnerf", ckpt["network_fn_state_dict"], template)
    for k, v in params_from_jax(jax.tree.map(np.asarray, jparams)).items():
        assert torch.equal(model.state_dict()[k], v), k
