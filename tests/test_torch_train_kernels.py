"""Kernel B1 (train-mode render pass: forward, per-ray squared error,
compositing backward and every parameter gradient) through its plain twin
on the CPU, against the JAX Pallas kernel in interpret mode (fp32) and
against the port's own autograd. The CUDA kernel itself is held to the twin
on the card (tests/test_torch_cuda.py, chip_smoke.py).

Bars: outputs atol 1e-5, rtol 5e-4 (the B3 bar); every gradient tensor
within ``max|d| <= 1e-4 * max|g_ref| + 1e-7``. At multires 10 the outputs
hold atol 3e-5 (see test_b1_plain_matches_pallas_multires10)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swnerf_torch.models import VanillaNeRF, VanillaNeRFConfig
from swnerf_torch.ops.embedding import positional_encoding
from swnerf_torch.ops.kernels import launches
from swnerf_torch.ops.kernels import render_loss as b1
from swnerf_torch.ops.kernels import render_pass as b3
from swnerf_torch.train.checkpoint import params_from_jax
from swnerf_tpu.models.vanilla import VanillaNeRFConfig as JaxConfig
from swnerf_tpu.models.vanilla import init_vanilla_params
from swnerf_tpu.ops.embedding import positional_encoding as jax_pe
from swnerf_tpu.ops.pallas.render_fused import fused_render_pass

torch.set_num_threads(2)

SMALL = dict(netdepth=3, netwidth=128, skips=(1,), multires=4, multires_views=2)


def _inputs(n, s, seed=0, noise_std=0.7):
    """Rays through the origin region; the last dist is 1e10 * |d| (a
    background ray's transmittance stays ~1 to the end)."""
    rng = np.random.default_rng(seed)
    o = (rng.standard_normal((n, 3)) * 0.3).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(2, 6, (n, s)), -1).astype(np.float32)
    dist = np.concatenate([z[:, 1:] - z[:, :-1], np.full((n, 1), 1e10, np.float32)], -1)
    dist = (dist * np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    noise = (rng.standard_normal((n, s)) * noise_std).astype(np.float32)
    target = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return o, d, vd, z, dist, noise, target


def _assert_grads_close(got, ref, rel=1e-4):
    """Each tensor: max|got - ref| <= rel * max|ref| + 1e-7."""
    assert set(got) == set(ref)
    for k in ref:
        g, r = np.asarray(got[k], np.float64), np.asarray(ref[k], np.float64)
        assert g.shape == r.shape, k
        err = np.abs(g - r).max()
        assert err <= rel * np.abs(r).max() + 1e-7, (k, err, np.abs(r).max())


def _jax_vs_twin(kw, n_samples, white_bkgd, seed=0):
    jcfg, tcfg = JaxConfig(**kw), VanillaNeRFConfig(**kw)
    params = jax.tree.map(np.asarray, init_vanilla_params(jax.random.PRNGKey(seed), jcfg))
    n = 13  # not a multiple of the Pallas ray tile: padding exercised
    o, d, vd, z, dist, noise, target = _inputs(n, n_samples, seed)
    scale = 1.0 / (3 * n)
    res, grads = fused_render_pass(
        params, jcfg, None, jax_pe(jnp.asarray(vd), jcfg.nf_views), jnp.asarray(z), jnp.asarray(dist),
        jnp.asarray(noise), jnp.asarray(target), white_bkgd, scale, rays_per_tile=8, interpret=True,
        compute_dtype=jnp.float32, origins=jnp.asarray(o), directions=jnp.asarray(d), need_param_grads=True,
    )
    packed = b3.pack_params(params_from_jax(params), tcfg, torch.float32)
    t = torch.from_numpy
    out, g = b1.render_loss_plain(
        packed, t(o), t(d), positional_encoding(t(vd), tcfg.nf_views), t(z), t(dist), t(noise), t(target),
        white_bkgd, scale,
    )
    ref_grads = params_from_jax(jax.tree.map(np.asarray, grads))
    return out, res, b1.unpack_grads(g, packed), ref_grads


@pytest.mark.parametrize("n_samples", [8, 16])
@pytest.mark.parametrize("white_bkgd", [True, False])
def test_b1_plain_matches_pallas(n_samples, white_bkgd):
    out, res, got, ref = _jax_vs_twin(SMALL, n_samples, white_bkgd)
    for key in ("rgb", "acc", "depth", "sqerr", "weights"):
        np.testing.assert_allclose(getattr(out, key).numpy(), np.asarray(res[key]), atol=1e-5, rtol=5e-4, err_msg=key)
    _assert_grads_close({k: v.numpy() for k, v in got.items()}, {k: v.numpy() for k, v in ref.items()})


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_b1_plain_matches_pallas_multires10(white_bkgd):
    """Multires 10/4, the width of every full-scale config (D=3, W=128,
    skip 1, N=13, S=16, fp32, interpret mode). The Pallas kernel builds cos
    as sin(t + pi/2) and t reaches ~2000 rad, where rounding t + pi/2 moves
    the cos; the port keeps its true cos. Measured over seeds 0-3 and both
    backgrounds: max |d| 1.7e-6 rgb, 3.2e-6 acc, 1.1e-5 depth (rel 7e-6),
    3.2e-6 weights, 4.5e-6 sqerr; gradients within 3.0e-5 * max|g|. Bars:
    outputs atol 3e-5, rtol 5e-4; gradients the 1e-4 bar of the module."""
    kw = dict(SMALL, multires=10, multires_views=4)
    out, res, got, ref = _jax_vs_twin(kw, 16, white_bkgd)
    for key in ("rgb", "acc", "depth", "sqerr", "weights"):
        np.testing.assert_allclose(getattr(out, key).numpy(), np.asarray(res[key]), atol=3e-5, rtol=5e-4, err_msg=key)
    _assert_grads_close({k: v.numpy() for k, v in got.items()}, {k: v.numpy() for k, v in ref.items()})


def _autograd_grads(packed, args, white_bkgd, scale):
    """d(scale * sum sqerr)/d(packed buffers) by autograd through B3's twin."""
    w = packed.weights.clone().requires_grad_(True)
    bias = packed.biases.clone().requires_grad_(True)
    leaf = b3.PackedParams(w, bias, packed.D, packed.W, packed.skip, packed.n_freqs, packed.input_ch_views)
    o, d, ve, z, dist, noise, target = args
    out = b3.render_pass_plain(leaf, o, d, ve, z, dist, noise, white_bkgd)
    (scale * ((out.rgb - target) ** 2).sum()).backward()
    return w.grad, bias.grad


@pytest.mark.parametrize("kw", [SMALL, dict(netdepth=6, netwidth=128, skips=(4,), multires=10, multires_views=4)],
                         ids=["small", "skip4-multires10"])
@pytest.mark.parametrize("n_samples", [8, 16])
@pytest.mark.parametrize("white_bkgd", [True, False])
def test_b1_plain_matches_autograd(kw, n_samples, white_bkgd):
    cfg = VanillaNeRFConfig(**kw)
    model = VanillaNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    packed = b3.pack_params(model.state_dict(), cfg, torch.float32)
    o, d, vd, z, dist, noise, target = (torch.from_numpy(x) for x in _inputs(21, n_samples, seed=4))
    args = (o, d, positional_encoding(vd, cfg.nf_views), z, dist, noise, target)
    scale = 1.0 / 63
    _, (gw, gb) = b1.render_loss_plain(packed, *args, white_bkgd, scale)
    aw, ab = _autograd_grads(packed, args, white_bkgd, scale)
    got = b1.unpack_grads((gw, gb), packed)
    ref = b1.unpack_grads((aw, ab), packed)
    _assert_grads_close({k: v.numpy() for k, v in got.items()}, {k: v.numpy() for k, v in ref.items()})
    # The padded rows of the packed gradient stay zero.
    mats = dict(zip([nm for nm, _, _ in b3.weight_layout(cfg.netdepth, cfg.netwidth, cfg.skips[0])],
                    torch.split(gw, [r * c for _, r, c in b3.weight_layout(cfg.netdepth, cfg.netwidth, cfg.skips[0])])))
    assert not mats["pts0"].view(b3.CIN_PAD, -1)[cfg.input_ch:].any()
    assert not mats["views_emb"].view(b3.CV_PAD, -1)[cfg.input_ch_views:].any()


def test_b1_wrapper_runs_the_twin_on_cpu():
    cfg = VanillaNeRFConfig(**SMALL)
    model = VanillaNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    packed = b3.pack_params(model.state_dict(), cfg, torch.float32)
    o, d, vd, z, dist, noise, target = (torch.from_numpy(x) for x in _inputs(5, 8))
    ve = positional_encoding(vd, cfg.nf_views)
    before = sum(launches.values())
    a_out, (a_w, a_b) = b1.render_loss(packed, o, d, ve, z, dist, noise, target, True, 0.1)
    b_out, (b_w, b_b) = b1.render_loss_plain(packed, o, d, ve, z, dist, noise, target, True, 0.1)
    assert sum(launches.values()) == before  # the CPU path launches nothing
    for x, y in zip(a_out, b_out):
        assert torch.equal(x, y)
    assert torch.equal(a_w, b_w) and torch.equal(a_b, b_b)


def test_unpack_grads_inverts_pack_params():
    """Packed buffers laid out as gradients map back to each nn.Linear's
    [out, in] tensor, and the gradients cover every parameter."""
    cfg = VanillaNeRFConfig()
    model = VanillaNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    packed = b3.pack_params(sd, cfg, torch.float32)
    got = b1.unpack_grads((packed.weights, packed.biases), packed)
    assert set(got) == set(sd)
    for k in sd:
        assert torch.equal(got[k], sd[k]), k


def test_b1_bf16_twin_rounds_operands():
    """bf16 operands round the cotangents as well as the forward; the
    gradients stay close to fp32 and differ from them."""
    cfg = VanillaNeRFConfig(**SMALL)
    model = VanillaNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    o, d, vd, z, dist, noise, target = (torch.from_numpy(x) for x in _inputs(32, 16, seed=2))
    args = (o, d, positional_encoding(vd, cfg.nf_views), z, dist, noise, target)
    p32 = b3.pack_params(model.state_dict(), cfg, torch.float32)
    p16 = b3.pack_params(model.state_dict(), cfg, torch.bfloat16)
    g32 = b1.unpack_grads(b1.render_loss_plain(p32, *args, True, 0.01)[1], p32)
    g16 = b1.unpack_grads(b1.render_loss_plain(p16, *args, True, 0.01)[1], p16)
    rel = max(((g16[k] - g32[k]).norm() / g32[k].norm()).item() for k in g32)
    assert 0 < rel < 5e-2


def test_b1_background_ray_stays_finite():
    """A ray that hits nothing (sigma <= 0 everywhere, acc ~ 0, T ~ 1 up to
    the 1e10 * |d| last dist) and a ray whose alpha saturates to 1 keep every
    output and gradient finite."""
    cfg = VanillaNeRFConfig(**SMALL)
    model = VanillaNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    packed = b3.pack_params(model.state_dict(), cfg, torch.float32)
    o, d, vd, z, dist, noise, target = (torch.from_numpy(x) for x in _inputs(2, 8))
    noise[0] = -1e3  # empty space
    noise[1] = 1e3  # opaque from the first sample
    out, (gw, gb) = b1.render_loss_plain(packed, o, d, positional_encoding(vd, cfg.nf_views), z, dist, noise,
                                         target, True, 0.1)
    assert out.acc[0].item() == 0.0 and out.acc[1].item() == pytest.approx(1.0)
    for x in (*out, gw, gb):
        assert torch.isfinite(x).all()


def test_train_macs_per_sample():
    """Forward 593,408 multiply-adds per sample at D=8, W=256, every dW as
    many again, and 557,696 for the dX products: ~3.49 MFLOP per sample."""
    cfg = VanillaNeRFConfig()
    model = VanillaNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    packed = b3.pack_params(model.state_dict(), cfg, torch.bfloat16)
    assert b1.train_macs_per_sample(packed) == 2 * 593_408 + 557_696


def test_bf16_colour_rounding_bound():
    """The JAX kernel in bf16 mode rounds each sample's sigmoid colour to
    bf16 before compositing (render_fused.py:389); B1, B3 and their twins
    keep it fp32. Half a bf16 ulp of a value in (0, 1) is at most 2^-9 and
    the weights sum to at most 1, so the composited colours differ by at most
    2^-9 (~1.95e-3) per channel. On these 4096 random rays of 192 samples
    the difference measures 5.5e-4."""
    g = torch.Generator().manual_seed(0)
    sigma = torch.relu(torch.randn((4096, 192), generator=g) * 2)
    dist = torch.full((4096, 192), 4.0 / 192)
    alpha = 1.0 - torch.exp(-sigma * dist)
    trans = torch.cumprod(torch.cat([torch.ones(4096, 1), 1.0 - alpha + 1e-10], -1), -1)[:, :-1]
    w = alpha * trans
    rgb = torch.sigmoid(torch.randn((4096, 192, 3), generator=g) * 2)
    diff = ((w[..., None] * rgb).sum(1) - (w[..., None] * rgb.bfloat16().float()).sum(1)).abs().max().item()
    assert 0 < diff < 2.0**-9 / 2
