"""Kernels B6 (the D-NeRF deformation MLP and its backward), B3's pts mode
and B5 (the train-mode render pass with position gradients) through their
plain twins on the CPU, against the JAX Pallas kernels in interpret mode
(fp32) and against the port's own autograd. The CUDA kernels themselves are
held to the twins on the card (tests/test_torch_cuda.py, chip_smoke.py).

Bars, with the maxima measured over seeds 0-3 in each test's docstring:
outputs atol 1e-5, rtol 5e-4 at multires 4/2 (atol 3e-5 at multires 10);
every gradient tensor and ``dpts`` within ``max|d| <= 1e-4 * max|g_ref| +
1e-7``; loss rel 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swnerf_torch.models import DirectTemporalNeRF, DNeRFConfig
from swnerf_torch.ops.embedding import positional_encoding
from swnerf_torch.ops.kernels import launches
from swnerf_torch.ops.kernels import render_loss as b1
from swnerf_torch.ops.kernels import render_pass as b3
from swnerf_torch.ops.kernels import time_net as b6
from swnerf_torch.render.fused_eval import canonical_params
from swnerf_torch.train.checkpoint import params_from_jax
from swnerf_tpu.models.dnerf import DNeRFConfig as JaxConfig
from swnerf_tpu.models.dnerf import apply_time_net, init_nerf_original_params, init_time_net_params
from swnerf_tpu.ops.embedding import positional_encoding as jax_pe
from swnerf_tpu.ops.pallas.raymarch import fused_time_net, fused_time_net_pts
from swnerf_tpu.ops.pallas.render_fused import fused_render_pass

torch.set_num_threads(2)

SMALL = dict(netdepth=4, netwidth=128, skips=(2,), multires=4, multires_views=2)
MULTIRES10 = dict(SMALL, multires=10, multires_views=4)  # 63 + 21 = 84 time-net input columns
SKIP1 = dict(SMALL, skips=(1,), multires=6)  # the skip of tests/test_fused_timenet.py


def _assert_close(got, ref, rel=1e-4):
    """Each tensor: max|got - ref| <= rel * max|ref| + 1e-7."""
    assert set(got) == set(ref)
    for k in ref:
        g, r = np.asarray(got[k], np.float64), np.asarray(ref[k], np.float64)
        assert g.shape == r.shape, k
        err = np.abs(g - r).max()
        assert err <= rel * np.abs(r).max() + 1e-7, (k, err, np.abs(r).max())


def _pts_inputs(n, s, seed=0):
    """Deformed sample positions around the origin, per-ray times in [0, 1]
    (a quarter at exactly 0), sorted z, dists with the trailing 1e10 * |d|,
    view directions, noise and targets."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.2, 1.2, (n, s, 3)).astype(np.float32)
    times = rng.uniform(0, 1, (n,)).astype(np.float32)
    times[: n // 4] = 0.0
    z = np.sort(rng.uniform(2, 6, (n, s)), -1).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    dist = np.concatenate([z[:, 1:] - z[:, :-1], np.full((n, 1), 1e10, np.float32)], -1)
    dist = (dist * np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    noise = (rng.standard_normal((n, s)) * 0.7).astype(np.float32)
    target = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return pts, times, z, dist, vd, noise, target


def _time_tree_to_port(tree):
    """A JAX time-net tree {"layers": [{"w", "b"}], "out"} -> the ``_time.*``
    keys of the port's state dict, ``[out, in]``."""
    out = {}
    for name, lyr in [(f"_time.{i}", lyr) for i, lyr in enumerate(tree["layers"])] + [("_time_out", tree["out"])]:
        out[f"{name}.weight"] = torch.tensor(np.asarray(lyr["w"]).T)
        out[f"{name}.bias"] = torch.tensor(np.asarray(lyr["b"]))
    return out


def _jax_time_net(kw, seed):
    jcfg = JaxConfig(**kw)
    return jcfg, jax.tree.map(np.asarray, init_time_net_params(jax.random.PRNGKey(seed), jcfg))


# ---------------------------------------------------------------- B6


@pytest.mark.parametrize("kw,atol", [(SMALL, 1e-5), (SKIP1, 1e-5), (MULTIRES10, 3e-5)],
                         ids=["small", "skip1", "multires10"])
@pytest.mark.parametrize("seed", [0, 1])
def test_b6_twin_matches_pallas_forward(kw, atol, seed):
    """D=4, W=128, N=13 rays x S=8, fp32: B6's twin (in-block encode from
    pts and per-ray times) against fused_time_net(interpret=True) on the
    JAX-encoded rows. Measured max |d| over seeds 0-3: 4.5e-8 (multires
    4/2), 3.0e-8 (multires 6), 6.0e-8 (multires 10)."""
    jcfg, tp = _jax_time_net(kw, seed)
    pts, times, *_ = _pts_inputs(13, 8, seed)
    t = np.broadcast_to(times[:, None, None], (13, 8, 1))
    ref = fused_time_net(tp, jcfg, jax_pe(jnp.asarray(pts), jcfg.nf_pts), jax_pe(jnp.asarray(t), jcfg.nf_time),
                         block=64, interpret=True, compute_dtype=jnp.float32)
    packed = b6.pack_time_params(_time_tree_to_port(tp), DNeRFConfig(**kw), torch.float32)
    got = b6.time_net_plain(packed, torch.from_numpy(pts), torch.from_numpy(times))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol, rtol=5e-4)


@pytest.mark.parametrize("kw", [SMALL, SKIP1, MULTIRES10], ids=["small", "skip1", "multires10"])
def test_b6_twin_backward_matches_pallas_vjp(kw):
    """The parameter gradients of sum(g * dx) through fused_time_net's custom
    VJP (the Pallas backward kernel, interpret mode) against B6's twin
    backward, N=11 x S=8, fp32. Measured within 5.0e-7 * max|g| (seeds
    0-3)."""
    jcfg, tp = _jax_time_net(kw, 2)
    pts, times, *_ = _pts_inputs(11, 8, 2)
    g = np.random.default_rng(5).standard_normal((11, 8, 3)).astype(np.float32)
    te = jax_pe(jnp.asarray(np.broadcast_to(times[:, None, None], (11, 8, 1))), jcfg.nf_time)
    pe = jax_pe(jnp.asarray(pts), jcfg.nf_pts)

    def f(p):
        return jnp.sum(jnp.asarray(g) * fused_time_net(p, jcfg, pe, te, block=64, interpret=True,
                                                        compute_dtype=jnp.float32, need_input_grads=False))

    ref = _time_tree_to_port(jax.tree.map(np.asarray, jax.grad(f)(tp)))
    packed = b6.pack_time_params(_time_tree_to_port(tp), DNeRFConfig(**kw), torch.float32)
    grads = b6.time_net_plain_bwd(packed, torch.from_numpy(pts), torch.from_numpy(times), torch.from_numpy(g))
    got = b6.unpack_time_grads(grads, packed)
    _assert_close({k: v.numpy() for k, v in got.items()}, {k: v.numpy() for k, v in ref.items()})


def test_b6_skip_ignores_the_time_rows():
    """The skip concatenates embed(x) only (model.py:128-134): the packed
    skip block's embed(t) rows are zero, the twin matches apply_time_net
    (whose skip takes pts_emb alone), and filling those rows would change
    dx: the zeros are what makes the shared body ignore the time columns."""
    jcfg, tp = _jax_time_net(SKIP1, 3)
    cfg = DNeRFConfig(**SKIP1)
    packed = b6.pack_time_params(_time_tree_to_port(tp), cfg, torch.float32)
    skip_rows = packed.matrices()["pts2_emb"]
    assert packed.cin == cfg.input_ch + cfg.input_ch_time == 52
    assert not skip_rows[cfg.input_ch:].any() and skip_rows[: cfg.input_ch].abs().sum() > 0
    pts, times, *_ = _pts_inputs(9, 4, 3)
    t = np.broadcast_to(times[:, None, None], (9, 4, 1))
    ref = apply_time_net(tp, jcfg, jax_pe(jnp.asarray(pts), jcfg.nf_pts), jax_pe(jnp.asarray(t), jcfg.nf_time))
    got = b6.time_net_plain(packed, torch.from_numpy(pts), torch.from_numpy(times))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=5e-4)
    filled = packed.weights.clone()
    off = sum(r * c for name, r, c in b6.weight_layout(4, 128, 1)[:2])  # pts0, pts1 precede pts2_emb
    filled.view(-1)[off + cfg.input_ch * 128 : off + packed.cin * 128] = 0.5
    moved = b6.time_net_plain(dataclasses.replace(packed, weights=filled), torch.from_numpy(pts),
                              torch.from_numpy(times))
    assert (moved - got).abs().max() > 1e-3


@pytest.mark.parametrize("kw", [SMALL, dict(netdepth=8, netwidth=256, skips=(4,), multires=10, multires_views=4)],
                         ids=["small", "full"])
def test_b6_twin_backward_matches_autograd(kw):
    """The twin's written-out backward against autograd through the
    module's own deformation MLP (DirectTemporalNeRF.time_net), and
    unpack_time_grads drops exactly the padded rows."""
    cfg = DNeRFConfig(**kw)
    model = DirectTemporalNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    params = dict(model.named_parameters())
    pts, times, *_ = (torch.from_numpy(x) for x in _pts_inputs(7, 6, 4))
    g = torch.randn((7, 6, 3), generator=torch.Generator().manual_seed(2))
    packed = b6.pack_time_params(model.state_dict(), cfg, torch.float32)
    got = b6.unpack_time_grads(b6.time_net_plain_bwd(packed, pts, times, g), packed)
    t = times[:, None, None].expand(7, 6, 1)
    dx = model.time_net(positional_encoding(pts, cfg.nf_pts), positional_encoding(t, cfg.nf_time))
    (dx * g).sum().backward()
    ref = {k: p.grad for k, p in params.items() if k.startswith("_time")}
    _assert_close({k: v.numpy() for k, v in got.items()}, {k: v.numpy() for k, v in ref.items()})
    np.testing.assert_allclose(b6.time_net_plain(packed, pts, times).detach().numpy(), dx.detach().numpy(),
                               atol=1e-5, rtol=5e-4)


def test_b6_autograd_function_and_wrappers_on_cpu():
    """time_net_autograd hands the twin's packed gradients back through the
    differentiable packing to each parameter; the CPU wrappers run the twin
    and launch nothing; pack_time_params refuses what B6 does not take."""
    cfg = DNeRFConfig(**SMALL)
    model = DirectTemporalNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    params = dict(model.named_parameters())
    pts, times, *_ = (torch.from_numpy(x) for x in _pts_inputs(6, 5, 1))
    g = torch.randn((6, 5, 3), generator=torch.Generator().manual_seed(0))
    before = sum(launches.values())
    packed32 = b6.pack_time_params(params, cfg, torch.float32)
    dx = b6.time_net_autograd(packed32, torch.float32, pts, times)
    (dx * g).sum().backward()
    detached = b6.pack_time_params(model.state_dict(), cfg, torch.float32)
    ref = b6.unpack_time_grads(b6.time_net_plain_bwd(detached, pts, times, g), detached)
    for k, v in ref.items():
        assert torch.equal(params[k].grad, v), k
    dx2, grads = b6.time_net_fwd_bwd(detached, pts, times, g)
    assert torch.equal(dx2, dx.detach()) and torch.equal(b6.time_net(detached, pts, times), dx2)
    assert sum(launches.values()) == before
    assert b6.supports_time_net(DNeRFConfig()) and b6.pack_time_params(model.state_dict(), cfg).weights.dtype == \
        torch.bfloat16
    for bad in (dict(SMALL, netwidth=200), dict(SMALL, skips=(3,)), dict(SMALL, multires=24)):
        assert not b6.supports_time_net(DNeRFConfig(**bad)), bad
    # separate time frequencies and inputs past 95 columns: the widened B6 (144 padded rows)
    for good in (dict(SMALL, multires_time=3), dict(SMALL, multires=12), dict(SMALL, multires=20, multires_time=8)):
        assert b6.supports_time_net(DNeRFConfig(**good)), good
    with pytest.raises(ValueError):
        b6.pack_time_params(model.state_dict(), DNeRFConfig(**dict(SMALL, skips=(3,))))


def test_b6_macs_match_the_issue_counts():
    """497,152 multiply-adds per row forward at D=8, W=256, multires 10
    (84*256 + 6*256^2 + 319*256 + 256*3), 956,672 for the backward; B5's
    1,776,768 per sample (B1's 1,744,512 and the two embedding products)."""
    cfg = DNeRFConfig()
    model = DirectTemporalNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    packed = b6.pack_time_params(model.state_dict(), cfg)
    assert packed.macs_per_row == 84 * 256 + 6 * 256**2 + 319 * 256 + 256 * 3 == 497152
    assert packed.bwd_macs_per_row == 497152 + 7 * 256**2 + 768
    canon = b3.pack_params(canonical_params(model.state_dict()), cfg)
    assert b1.pts_train_macs_per_sample(canon) == 1744512 + 2 * 63 * 256 == 1776768


# ---------------------------------------------------------------- B3 pts mode and B5


def _canonical(kw, seed):
    jcfg = JaxConfig(**kw)
    params = jax.tree.map(np.asarray, init_nerf_original_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, params, b3.pack_params(params_from_jax(params), DNeRFConfig(**kw), torch.float32)


def _jax_pts_pass(jcfg, params, args, white, grads):
    pts, _, z, dist, vd, noise, target = args
    n = z.shape[0]
    return fused_render_pass(
        params, jcfg, None, jax_pe(jnp.asarray(vd), jcfg.nf_views), jnp.asarray(z), jnp.asarray(dist),
        jnp.asarray(noise), jnp.asarray(target), white, 1.0 / (3 * n), rays_per_tile=8, interpret=True,
        compute_dtype=jnp.float32, pts=jnp.asarray(pts), need_input_grads=grads, need_param_grads=grads,
    )


@pytest.mark.parametrize("kw,atol", [(SMALL, 1e-5), (MULTIRES10, 3e-5)], ids=["small", "multires10"])
@pytest.mark.parametrize("white", [True, False])
def test_b3_pts_twin_matches_pallas(kw, atol, white):
    """B3's pts mode: the twin on given positions against
    fused_render_pass(pts=..., need_param_grads=False, interpret=True), N=13
    (not a multiple of the ray tile), S=8, fp32. The forward B5 shares:
    measured through B5 over seeds 0-3 and both backgrounds, every output
    within 5.2e-6 (multires 4/2) and 6.7e-6 (multires 10)."""
    jcfg, params, packed = _canonical(kw, 0)
    args = _pts_inputs(13, 8, 1)
    res, _ = _jax_pts_pass(jcfg, params, args, white, False)
    pts, _, z, dist, vd, noise, _ = (torch.from_numpy(x) for x in args)
    ve = positional_encoding(vd, jcfg.nf_views)
    out = b3.render_pass_plain(packed, None, None, ve, z, dist, noise, white, None, pts)
    for key in ("rgb", "acc", "depth", "weights"):
        np.testing.assert_allclose(getattr(out, key).numpy(), np.asarray(res[key]), atol=atol, rtol=5e-4,
                                   err_msg=key)


@pytest.mark.parametrize("kw,atol,seeds", [(SMALL, 1e-5, (1, 2)), (MULTIRES10, 3e-5, (1, 2)), (MULTIRES10, 3e-5, (0, 10))],
                         ids=["small", "multires10", "multires10-pallas-off"])
@pytest.mark.parametrize("white", [True, False])
def test_b5_twin_matches_pallas(kw, atol, seeds, white):
    """B5: fused_render_pass(pts=..., need_input_grads=True, interpret=True)
    against the twin: outputs and sqerr at the forward bars; every
    parameter gradient and dpts = dx8[..., :3] within 1e-4 * max|g| + 1e-7
    of the float64 twin (the exact function) and of the Pallas kernel.

    At multires 10 the Pallas kernel's own fp32 can miss that bar: it forms
    cos(u) as sin(u + pi/2) at |u| up to ~600 rad (ROADMAP Queue C), and the
    encode backward multiplies by 2^9. Measured over seeds 0-3 and both
    backgrounds (gradients and dpts, relative to max|g|): the fp32 twin
    within 1.2e-5 of the float64 twin; the Pallas kernel within 1.5e-4 of it
    except at params seed 0 (the ``pallas-off`` case), 4.1e-3 off in
    pts_linears.1.weight. There, the twin must be within the bar of the
    float64 twin and no further from it than the Pallas kernel is, and the
    Pallas kernel within 1e-2 of it. At multires 4/2: twin and Pallas within
    7.7e-6, dpts 2.4e-6."""
    jcfg, params, packed = _canonical(kw, seeds[0])
    args = _pts_inputs(13, 8, seeds[1])
    res, jgrads = _jax_pts_pass(jcfg, params, args, white, True)
    pts, _, z, dist, vd, noise, target = (torch.from_numpy(x) for x in args)
    ve = positional_encoding(vd, jcfg.nf_views)
    out, grads, dpts = b1.render_loss_pts_plain(packed, pts, ve, z, dist, noise, target, white, 1.0 / 39)
    for key in ("rgb", "acc", "depth", "sqerr", "weights"):
        np.testing.assert_allclose(getattr(out, key).numpy(), np.asarray(res[key]), atol=atol, rtol=5e-4,
                                   err_msg=key)
    p64 = dataclasses.replace(packed, weights=packed.weights.double())
    _, g64, d64 = b1.render_loss_pts_plain(p64, *(x.double() for x in (pts, ve, z, dist, noise, target)), white,
                                           1.0 / 39)
    got = dict({k: v.numpy() for k, v in b1.unpack_grads(grads, packed).items()}, dpts=dpts.numpy())
    exact = dict({k: v.numpy() for k, v in b1.unpack_grads(g64, p64).items()}, dpts=d64.numpy())
    ref = dict({k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, jgrads)).items()},
               dpts=np.asarray(res["dx8"])[..., :3])
    _assert_close(got, exact)
    for k, r in ref.items():
        scale = np.abs(exact[k]).max()
        d_port, d_ref = np.abs(got[k] - r).max(), np.abs(r - exact[k]).max()
        assert d_port <= 1e-4 * np.abs(r).max() + 1e-7 or (
            d_ref <= 1e-2 * scale and np.abs(got[k] - exact[k]).max() <= d_ref), (k, d_port, d_ref)


@pytest.mark.parametrize("white", [True, False])
def test_b5_twin_matches_autograd(white):
    """The twin's written-out position gradient (the fp32 embedding
    cotangent through encode_backward) and parameter gradients against
    autograd through B3's pts-mode twin, D=8, W=256, multires 10/4."""
    cfg = DNeRFConfig()
    model = DirectTemporalNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    packed = b3.pack_params(canonical_params(model.state_dict()), cfg, torch.float32)
    pts, _, z, dist, vd, noise, target = (torch.from_numpy(x) for x in _pts_inputs(5, 12, 3))
    ve = positional_encoding(vd, 4)
    out, (gw, gb), dpts = b1.render_loss_pts_plain(packed, pts, ve, z, dist, noise, target, white, 1.0 / 15)
    w = packed.weights.clone().requires_grad_(True)
    bias = packed.biases.clone().requires_grad_(True)
    p = pts.clone().requires_grad_(True)
    ref = b3.render_pass_plain(dataclasses.replace(packed, weights=w, biases=bias), None, None, ve, z, dist, noise,
                               white, None, p)
    (((ref.rgb - target) ** 2).sum() / 15).backward()
    _assert_close({"w": gw.numpy(), "b": gb.numpy(), "dpts": dpts.numpy()},
                  {"w": w.grad.numpy(), "b": bias.grad.numpy(), "dpts": p.grad.numpy()})
    torch.testing.assert_close(out.sqerr.sum() / 15, ((ref.rgb - target) ** 2).sum().detach() / 15, rtol=1e-5,
                               atol=0)


@pytest.mark.parametrize("n_freqs", [0, 4, 10])
def test_encode_backward_matches_autograd(n_freqs):
    """encode_backward against autograd through positional_encoding."""
    x = (torch.rand((50, 3), generator=torch.Generator().manual_seed(n_freqs), dtype=torch.float64) - 0.5) * 3
    g = torch.randn((50, 3 + 6 * n_freqs), generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    xr = x.clone().requires_grad_(True)
    (positional_encoding(xr, n_freqs) * g).sum().backward()
    torch.testing.assert_close(b1.encode_backward(x, g, n_freqs), xr.grad, rtol=1e-12, atol=1e-12)


def test_b5_autograd_function_and_wrappers_on_cpu():
    """render_loss_pts_autograd: the loss is scale * sum(sqerr); its backward
    scales the twin's packed gradients and dpts by the loss cotangent, the
    per-ray outputs carry none. The CPU wrappers run the twins; pts mode
    refuses origins or a T-NeRF field."""
    cfg = DNeRFConfig(**SMALL)
    model = DirectTemporalNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    pts, _, z, dist, vd, noise, target = (torch.from_numpy(x) for x in _pts_inputs(6, 8, 5))
    ve = positional_encoding(vd, 2)
    params = dict(model.named_parameters())
    packed32 = b3.pack_params(canonical_params(params), cfg, torch.float32)
    p = pts.clone().requires_grad_(True)
    before = sum(launches.values())
    loss, out = b1.render_loss_pts_autograd(packed32, torch.float32, p, ve, z, dist, noise, target, True, 0.05)
    (2.5 * loss).backward()
    detached = b3.pack_params(canonical_params(model.state_dict()), cfg, torch.float32)
    ref_out, grads, dpts = b1.render_loss_pts(detached, pts, ve, z, dist, noise, target, True, 0.05)
    assert sum(launches.values()) == before
    assert torch.equal(loss, ref_out.sqerr.sum() * 0.05) and not out.rgb.requires_grad
    torch.testing.assert_close(p.grad, 2.5 * dpts, rtol=1e-6, atol=0)
    for k, v in b1.unpack_grads(grads, detached).items():
        torch.testing.assert_close(params[f"_occ.{k}"].grad, 2.5 * v, rtol=1e-6, atol=1e-12)
    fwd = b3.render_pass(detached, None, None, ve, z, dist, noise, True, None, pts)
    assert torch.equal(fwd.rgb, b3.render_pass_plain(detached, None, None, ve, z, dist, noise, True, None, pts).rgb)
    with pytest.raises(ValueError, match="pts mode"):
        b3.render_pass(detached, pts[:, 0], pts[:, 1], ve, z, dist, noise, True, None, pts)
    with pytest.raises(ValueError, match="origins and directions"):
        b3.render_pass(detached, None, None, ve, z, dist, noise, True)
    with pytest.raises(ValueError, match="pts must be"):
        b1.render_loss_pts(detached, pts[:, :4], ve, z, dist, noise, target, True, 0.05)
    assert b3.launch_key("render_pass", detached, 64, pts=True) == "render_pass[pts,S=64]"


# ---------------------------------------------------------------- B11: fused_time_net_pts


B11_LEVEL0 = dict(SKIP1, multires=20, multires_time=8)  # MultiRes level 0's 140 input columns


@pytest.mark.parametrize("kw,scale", [(SMALL, 1.0), (MULTIRES10, 1.0), (B11_LEVEL0, 2.0**-10)],
                         ids=["small", "multires10", "level0"])
def test_b11_twin_matches_pallas_vjp(kw, scale):
    """fused_time_net_pts(need_input_grads=True) on the CPU (B6's twin
    forward, B11's twin backward: the fp32 [embed(x) | embed(t)] cotangent
    through the encode) against raymarch.py::fused_time_net_pts(
    need_input_grads=True, interpret=True, f32), N=11 x S=8, per-ray times a
    quarter at 0: dx atol 1e-5 (rtol 5e-4), and jax.vjp for a seeded
    cotangent in every parameter, pts and times within 1e-4 * max|g| +
    1e-7. At level 0's 2^19 frequencies the Pallas encode's
    cos(u) = sin(u + pi/2) (ROADMAP Queue C) holds to fp32 on |x| <= 2^-10
    only. Measured over seeds 0-3: dx within 6.7e-7, gradients within
    3.9e-6 * max|g|."""
    jcfg, tp = _jax_time_net(kw, 6)
    pts, times, *_ = _pts_inputs(11, 8, 6)
    pts = (pts * np.float32(scale)).astype(np.float32)
    g = np.random.default_rng(7).standard_normal((11, 8, 3)).astype(np.float32)
    t3 = np.broadcast_to(times[:, None, None], (11, 1, 1)).copy()  # per ray, broadcast over the samples

    def f(p, x, t):
        return fused_time_net_pts(p, jcfg, x, t, block=64, interpret=True, compute_dtype=jnp.float32,
                                  need_input_grads=True)

    ref, vjp = jax.vjp(f, tp, jnp.asarray(pts), jnp.asarray(t3))
    gp, gx, gt = vjp(jnp.asarray(g))
    params = {k: v.clone().requires_grad_(True) for k, v in _time_tree_to_port(tp).items()}
    packed = b6.pack_time_params(params, DNeRFConfig(**kw), torch.float32)
    p, t = torch.from_numpy(pts).requires_grad_(True), torch.from_numpy(times).requires_grad_(True)
    before = sum(launches.values())
    dx = b6.fused_time_net_pts(packed, p, t, need_input_grads=True)
    (dx * torch.from_numpy(g)).sum().backward()
    assert sum(launches.values()) == before
    np.testing.assert_allclose(dx.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=5e-4)
    got = dict({k: v.grad.numpy() for k, v in params.items()}, dpts=p.grad.numpy(), dtimes=t.grad.numpy())
    want = dict({k: v.numpy() for k, v in _time_tree_to_port(jax.tree.map(np.asarray, gp)).items()},
                dpts=np.asarray(gx), dtimes=np.asarray(gt).reshape(11))
    _assert_close(got, want)


def test_b11_twin_backward_matches_autograd_and_b6():
    """B11's written-out input cotangent against autograd through the
    module's own deformation MLP (float64; the skip takes embed(x) only, so
    the position columns take two contributions and the time columns one),
    within 1e-10 relative; without need_input_grads fused_time_net_pts is
    time_net_autograd: the same parameter gradients bit for bit and no
    gradient for pts or times."""
    cfg = DNeRFConfig(**dict(SMALL, multires_time=3))
    model = DirectTemporalNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(8)).double()
    params = dict(model.named_parameters())
    pts, times, *_ = (torch.from_numpy(x).double() for x in _pts_inputs(5, 7, 8))
    g = torch.randn((5, 7, 3), generator=torch.Generator().manual_seed(9), dtype=torch.float64)
    p, t = pts.clone().requires_grad_(True), times.clone().requires_grad_(True)
    dx = model.time_net(positional_encoding(p, cfg.nf_pts), positional_encoding(t[:, None, None].expand(5, 7, 1),
                                                                                 cfg.nf_time))
    (dx * g).sum().backward()
    packed = b6.pack_time_params({k: v.detach() for k, v in params.items()}, cfg, torch.float64)
    grads, dpts, dtimes = b6.time_net_plain_bwd(packed, pts, times, g, need_input_grads=True)
    _assert_close(dict({k: v.numpy() for k, v in b6.unpack_time_grads(grads, packed).items()}, dpts=dpts.numpy(),
                       dtimes=dtimes.numpy()),
                  dict({k: v.grad.numpy() for k, v in params.items() if k.startswith("_time")}, dpts=p.grad.numpy(),
                       dtimes=t.grad.numpy()), rel=1e-10)
    assert torch.equal(grads[0], b6.time_net_plain_bwd(packed, pts, times, g)[0])
    p32 = b6.pack_time_params({k: v.detach().float() for k, v in params.items()}, cfg, torch.float32)
    out = {}
    for name, fn in (("b11", lambda pk, x, tt: b6.fused_time_net_pts(pk, x, tt)),
                     ("b6", lambda pk, x, tt: b6.time_net_autograd(pk, torch.float32, x, tt))):
        w = p32.weights.clone().requires_grad_(True)
        x, tt = pts.float().requires_grad_(True), times.float().requires_grad_(True)
        (fn(dataclasses.replace(p32, weights=w), x, tt) * g.float()).sum().backward()
        assert x.grad is None and tt.grad is None
        out[name] = w.grad
    assert torch.equal(out["b11"], out["b6"])
    assert packed.din_macs_per_row == packed.bwd_macs_per_row + (packed.cin + packed.input_ch) * packed.W
