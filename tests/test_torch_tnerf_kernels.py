"""Kernel B4 (the T-NeRF render pass: [embed(xyz) | embed(t)] input, ELU
trunk and view layer, ReLU colour head; forward and train modes) through
its plain twin on the CPU, against the JAX Pallas kernel in interpret mode
(fp32, ``arch="tnerf"``) and against the port's own autograd. The CUDA
kernel itself is held to the twin on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Bars, with the maxima measured over seeds 0-3 and both backgrounds in each
test's docstring: outputs atol 1e-5, rtol 5e-4 at multires 4/2 (atol 3e-5
at multires 10/4); every gradient tensor within
``max|d| <= 1e-4 * max|g_ref| + 1e-7``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from swnerf_torch.models import TNeRF, TNeRFConfig
from swnerf_torch.ops.embedding import positional_encoding
from swnerf_torch.ops.kernels import launches
from swnerf_torch.ops.kernels import render_loss as b1
from swnerf_torch.ops.kernels import render_pass as b3
from swnerf_torch.train.checkpoint import params_from_jax
from swnerf_tpu.models.tnerf import TNeRFConfig as JaxConfig
from swnerf_tpu.models.tnerf import init_tnerf_params
from swnerf_tpu.ops.embedding import positional_encoding as jax_pe
from swnerf_tpu.ops.pallas.render_fused import fused_render_pass

torch.set_num_threads(2)

SMALL = dict(netdepth=4, net_dim=128, skip_layer=2, multires=4, multires_views=2)
MULTIRES10 = dict(SMALL, multires=10, multires_views=4)  # 63 + 21 = 84 input columns


def _inputs(n, s, seed=0, noise_std=0.7):
    """Rays through the origin region, per-ray frame times in [0, 1]; the
    last dist is 1e10 * |d|."""
    rng = np.random.default_rng(seed)
    o = (rng.standard_normal((n, 3)) * 0.3).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(2, 6, (n, s)), -1).astype(np.float32)
    dist = np.concatenate([z[:, 1:] - z[:, :-1], np.full((n, 1), 1e10, np.float32)], -1)
    dist = (dist * np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    noise = (rng.standard_normal((n, s)) * noise_std).astype(np.float32)
    target = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    times = rng.uniform(0, 1, (n,)).astype(np.float32)
    return o, d, vd, z, dist, noise, target, times


def _assert_grads_close(got, ref, rel=1e-4):
    """Each tensor: max|got - ref| <= rel * max|ref| + 1e-7."""
    assert set(got) == set(ref)
    for k in ref:
        g, r = np.asarray(got[k], np.float64), np.asarray(ref[k], np.float64)
        assert g.shape == r.shape, k
        err = np.abs(g - r).max()
        assert err <= rel * np.abs(r).max() + 1e-7, (k, err, np.abs(r).max())


def _jax_vs_twin(kw, n_samples, white_bkgd, param_grads, seed=0):
    jcfg, tcfg = JaxConfig(**kw), TNeRFConfig(**kw)
    params = jax.tree.map(np.asarray, init_tnerf_params(jax.random.PRNGKey(seed), jcfg))
    n = 13  # not a multiple of the Pallas ray tile: padding exercised
    o, d, vd, z, dist, noise, target, times = _inputs(n, n_samples, seed)
    scale = 1.0 / (3 * n)
    res, grads = fused_render_pass(
        params, jcfg, None, jax_pe(jnp.asarray(vd), jcfg.nf_views), jnp.asarray(z), jnp.asarray(dist),
        jnp.asarray(noise), jnp.asarray(target), white_bkgd, scale, rays_per_tile=8, interpret=True,
        compute_dtype=jnp.float32, origins=jnp.asarray(o), directions=jnp.asarray(d), times=jnp.asarray(times),
        arch="tnerf", need_param_grads=param_grads,
    )
    packed = b3.pack_tnerf_params(params_from_jax(params), tcfg, torch.float32)
    t = torch.from_numpy
    ve = positional_encoding(t(vd), tcfg.nf_views)
    if not param_grads:
        out = b3.render_pass_plain(packed, t(o), t(d), ve, t(z), t(dist), t(noise), white_bkgd, t(times))
        return out, res, None, None
    out, g = b1.render_loss_plain(packed, t(o), t(d), ve, t(z), t(dist), t(noise), t(target), white_bkgd, scale,
                                  t(times))
    return out, res, b1.unpack_tnerf_grads(g, packed), params_from_jax(jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_b4_forward_twin_matches_pallas(white_bkgd):
    """D=4, W=128, skip 2, multires 4/2, N=13, S=8, fp32. Measured max |d|
    over seeds 0-3 and both backgrounds: rgb 5.4e-7, acc 1.0e-6, depth
    5.7e-6, weights 1.0e-6."""
    out, res, _, _ = _jax_vs_twin(SMALL, 8, white_bkgd, False)
    for key in ("rgb", "acc", "depth", "weights"):
        np.testing.assert_allclose(getattr(out, key).numpy(), np.asarray(res[key]), atol=1e-5, rtol=5e-4, err_msg=key)


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_b4_forward_twin_matches_pallas_multires10(white_bkgd):
    """Multires 10/4: 84 input columns padded to 96, N=13, S=16, fp32. The
    Pallas kernel builds cos as sin(u + pi/2) at u up to ~1500 rad (time:
    512 rad), where rounding u + pi/2 moves the cos; the twin keeps the true
    cos. Measured max |d| over seeds 0-3 and both backgrounds: rgb 2.3e-6,
    acc 4.5e-6, depth 1.7e-5 (inside rtol 5e-4 of depths of 2-6), weights
    7.8e-6."""
    out, res, _, _ = _jax_vs_twin(MULTIRES10, 16, white_bkgd, False)
    for key in ("rgb", "acc", "depth", "weights"):
        np.testing.assert_allclose(getattr(out, key).numpy(), np.asarray(res[key]), atol=3e-5, rtol=5e-4, err_msg=key)


@pytest.mark.parametrize("kw,n_samples,atol", [(SMALL, 8, 1e-5), (MULTIRES10, 16, 3e-5)], ids=["small", "multires10"])
@pytest.mark.parametrize("white_bkgd", [True, False])
def test_b4_train_twin_matches_pallas(kw, n_samples, atol, white_bkgd):
    """Train mode, the same two cases: outputs at the forward bars, sqerr
    too (measured max |d| 6.6e-7 / 3.5e-6); gradients (measured within
    4.5e-6 * max|g| at multires 4/2 and 2.4e-5 * max|g| at multires 10/4,
    seeds 0-3, both backgrounds) at the module's 1e-4 bar."""
    out, res, got, ref = _jax_vs_twin(kw, n_samples, white_bkgd, True)
    for key in ("rgb", "acc", "depth", "sqerr", "weights"):
        np.testing.assert_allclose(getattr(out, key).numpy(), np.asarray(res[key]), atol=atol, rtol=5e-4, err_msg=key)
    _assert_grads_close({k: v.numpy() for k, v in got.items()}, {k: v.numpy() for k, v in ref.items()})


def _autograd_grads(packed, args, times, white_bkgd, scale):
    """d(scale * sum sqerr)/d(packed buffers) by autograd through B4's
    forward twin."""
    w = packed.weights.clone().requires_grad_(True)
    bias = packed.biases.clone().requires_grad_(True)
    leaf = b3.PackedParams(w, bias, packed.D, packed.W, packed.skip, packed.n_freqs, packed.input_ch_views, "tnerf")
    o, d, ve, z, dist, noise, target = args
    out = b3.render_pass_plain(leaf, o, d, ve, z, dist, noise, white_bkgd, times)
    (scale * ((out.rgb - target) ** 2).sum()).backward()
    return w.grad, bias.grad


@pytest.mark.parametrize("kw", [SMALL, dict(netdepth=8, net_dim=128, skip_layer=4, multires=10, multires_views=4)],
                         ids=["small", "full"])
@pytest.mark.parametrize("white_bkgd", [True, False])
def test_b4_twin_backward_matches_autograd(kw, white_bkgd):
    """The twin's written-out backward (ELU' from the stored activations, the
    colour ReLU's mask) against autograd through its forward; the padded
    rows of the gradient, embedding rows 84-95 among them, stay zero."""
    cfg = TNeRFConfig(**kw)
    model = TNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    packed = b3.pack_tnerf_params(model.state_dict(), cfg, torch.float32)
    o, d, vd, z, dist, noise, target, times = (torch.from_numpy(x) for x in _inputs(21, 16, seed=4))
    args = (o, d, positional_encoding(vd, cfg.nf_views), z, dist, noise, target)
    scale = 1.0 / 63
    _, (gw, gb) = b1.render_loss_plain(packed, *args, white_bkgd, scale, times)
    aw, ab = _autograd_grads(packed, args, times, white_bkgd, scale)
    got, ref = b1.unpack_tnerf_grads((gw, gb), packed), b1.unpack_tnerf_grads((aw, ab), packed)
    _assert_grads_close({k: v.numpy() for k, v in got.items()}, {k: v.numpy() for k, v in ref.items()})
    layout = b3.weight_layout(cfg.netdepth, cfg.net_dim, cfg.skip_layer, b3.CIN_PAD_T)
    mats = dict(zip([nm for nm, _, _ in layout], torch.split(gw, [r * c for _, r, c in layout])))
    cin = cfg.in_feat + cfg.time_feat
    assert not mats["pts0"].view(b3.CIN_PAD_T, -1)[cin:].any()
    assert not mats[f"pts{cfg.skip_layer + 1}_emb"].view(b3.CIN_PAD_T, -1)[cin:].any()
    assert not mats["views_emb"].view(b3.CV_PAD, -1)[cfg.dir_feat:].any()


def test_b4_embedding_layout():
    """The twin's input rows: [embed(xyz) | t, sin(2^i t), cos(2^i t) ...]
    as positional_encoding orders it, 84 live columns at multires 10 and
    zeros up to the 96 padded ones."""
    cfg = TNeRFConfig()
    model = TNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    packed = b3.pack_tnerf_params(model.state_dict(), cfg, torch.float32)
    o, d, vd, z, _, _, _, times = (torch.from_numpy(x) for x in _inputs(3, 4))
    emb = b3.field_forward(packed, o, d, positional_encoding(vd, 4), z, times).emb
    assert emb.shape == (12, 96) and packed.cin == 84
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(12, 3)
    t = times[:, None].expand(3, 4).reshape(12, 1)
    torch.testing.assert_close(emb[:, :63], positional_encoding(pts, 10), rtol=0, atol=0)
    torch.testing.assert_close(emb[:, 63:84], positional_encoding(t, 10), rtol=0, atol=0)
    assert torch.equal(emb[:, 63], t[:, 0]) and torch.equal(emb[:, 64], torch.sin(t[:, 0]))
    assert not emb[:, 84:].any()


def test_b4_wrappers_run_the_twin_on_cpu_and_check_times():
    cfg = TNeRFConfig(**SMALL)
    model = TNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    packed = b3.pack_tnerf_params(model.state_dict(), cfg, torch.float32)
    o, d, vd, z, dist, noise, target, times = (torch.from_numpy(x) for x in _inputs(5, 8))
    ve = positional_encoding(vd, cfg.nf_views)
    before = sum(launches.values())
    a = b3.render_pass(packed, o, d, ve, z, dist, noise, True, times)
    b = b3.render_pass_plain(packed, o, d, ve, z, dist, noise, True, times)
    a_out, (a_w, a_b) = b1.render_loss(packed, o, d, ve, z, dist, noise, target, True, 0.1, times)
    b_out, (b_w, b_b) = b1.render_loss_plain(packed, o, d, ve, z, dist, noise, target, True, 0.1, times)
    assert sum(launches.values()) == before  # the CPU path launches nothing
    for x, y in zip((*a, *a_out, a_w, a_b), (*b, *b_out, b_w, b_b)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="needs times"):
        b3.render_pass(packed, o, d, ve, z, dist, noise, True)
    with pytest.raises(ValueError, match="times must be"):
        b1.render_loss(packed, o, d, ve, z, dist, noise, target, True, 0.1, times[:, None])
    vanilla = b3.PackedParams(packed.weights, packed.biases, 4, 128, 2, 4, 15)
    with pytest.raises(ValueError, match="takes no times"):
        b3.render_pass(vanilla, o, d, ve, z, dist, noise, True, times)


def test_unpack_tnerf_grads_inverts_pack_tnerf_params():
    """Packed buffers laid out as gradients map back to each nn.Linear's
    [out, in] tensor under the .tar keys, and cover every parameter."""
    cfg = TNeRFConfig()
    model = TNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    packed = b3.pack_tnerf_params(sd, cfg, torch.float32)
    got = b1.unpack_tnerf_grads((packed.weights, packed.biases), packed)
    assert set(got) == set(sd)
    for k in sd:
        assert torch.equal(got[k], sd[k]), k


def test_tnerf_macs_per_sample():
    """D=8, W=128, 84 input and 27 view columns: 162,816 multiply-adds per
    sample forward, 465,216 in train mode (forward, every dW, and the dX
    products of the reverse sweep)."""
    cfg = TNeRFConfig()
    model = TNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    packed = b3.pack_tnerf_params(model.state_dict(), cfg, torch.bfloat16)
    assert packed.macs_per_sample == 162_816
    assert b1.train_macs_per_sample(packed) == 465_216


def test_b4_bf16_twin_rounds_operands():
    """bf16 operands round the time embedding, the ELU outputs and the
    cotangents; the gradients stay close to fp32 and differ from them
    (measured: 5.3e-2 rel L2 at worst, on these random weights)."""
    cfg = TNeRFConfig(**SMALL)
    model = TNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    o, d, vd, z, dist, noise, target, times = (torch.from_numpy(x) for x in _inputs(32, 16, seed=2))
    args = (o, d, positional_encoding(vd, cfg.nf_views), z, dist, noise, target)
    p32 = b3.pack_tnerf_params(model.state_dict(), cfg, torch.float32)
    p16 = b3.pack_tnerf_params(model.state_dict(), cfg, torch.bfloat16)
    g32 = b1.unpack_tnerf_grads(b1.render_loss_plain(p32, *args, True, 0.01, times)[1], p32)
    g16 = b1.unpack_tnerf_grads(b1.render_loss_plain(p16, *args, True, 0.01, times)[1], p16)
    rel = max(((g16[k] - g32[k]).norm() / g32[k].norm()).item() for k in g32)
    assert 0 < rel < 1e-1


# ---------------------------------------------------------------- where B4 and the Pallas kernel part ways


def test_elu_expm1_against_exp_minus_one():
    """The kernel and the twin write ELU with expm1; the Pallas kernel with
    exp(z) - 1 (raymarch.py:239). On 2^20 pre-activations in [-8, 8] (fp32)
    the two differ by at most 6.0e-8 absolute (half an fp32 ulp of 1, near
    z = -8) and by at most 1.2e-4 relative to |elu(z)| (near z = 0, where
    exp(z) - 1 cancels). That is far under half a bf16 ulp of any output, so
    in bf16 mode it moves a rounded activation only on a tie."""
    z = torch.linspace(-8.0, 8.0, 2**20)
    elu = F.elu(z)
    diff = (elu - torch.where(z > 0, z, torch.exp(z) - 1.0)).abs()
    assert diff.max().item() <= 6e-8
    assert (diff[z < 0] / elu[z < 0].abs()).max().item() <= 2e-4


def test_colour_relu_mask_against_pallas_rule():
    """B4 masks the colour cotangent with [logit > 0]; the Pallas kernel
    with rgb > 0.5 on the sigmoid rounded to bf16 in bf16 mode
    (render_fused.py:389,466), which also zeroes 0 < logit <= 2^-7 (there
    sigmoid rounds to 0.5 in bf16). In fp32 mode the two rules agree except
    for the few logits whose fp32 sigmoid still rounds to 0.5. Measured on
    2^20 logits in [-0.05, 0.05]: the bf16 rule drops the 15.6% of the
    positive ones that lie below 2^-7 (each carries a colour cotangent of
    about w * g * 0.25); the fp32 rule differs on 1."""
    logit = torch.linspace(-0.05, 0.05, 2**20)
    port = logit > 0
    pallas_bf16 = torch.sigmoid(logit).bfloat16().float() > 0.5
    pallas_fp32 = torch.sigmoid(logit) > 0.5
    dropped = (port & ~pallas_bf16).float().sum() / port.float().sum()
    assert 0.15 < dropped.item() < 0.16
    assert not (pallas_bf16 & ~port).any()
    assert (logit[port & ~pallas_bf16] <= 2.0**-7 * 1.0001).all()
    assert (port != pallas_fp32).sum().item() <= 4
