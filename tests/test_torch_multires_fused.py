"""MultiRes on the render kernels, on the CPU through the twins: B3's pts
mode at the MultiRes widths (the wide pack), B9 and
``render_outputs_autograd`` (the port of ``make_render_outputs``), the
fused phase-2 step (``SWNERF_FUSED_MULTIRES``) and the test render through
the D-NeRF eval pass, against the JAX package (Pallas kernels in interpret
mode, fp32) and against the port's own unfused routes. The CUDA kernels are
held to the twins on the card (tests/test_torch_cuda.py, chip_smoke.py
phases 31-33).

Small fields: D=3, W=128, skip 1. Bars, with what was measured: outputs
atol 1e-5, rtol 5e-4 (depth ``allclose(rtol=1e-4, atol=1e-5)``, ROADMAP
Queue C); gradients and d pts within ``1e-4 * max|g| + 1e-7`` per tensor;
step metrics rel 1e-5 and gradients as tests/test_torch_multires.py's
_check_grads. At 20 frequencies the Pallas kernel forms cos(u) as
sin(u + pi/2), which at |u| = 2^19 |x| misses by up to half an ulp of u
(ROADMAP Queue C): level 0 meets JAX on positions with |x| <= 2^-10, and
meets a float64 twin at full-range positions."""

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
from swnerf_torch.pipelines import run_multires as mr
from swnerf_torch.render.core import Draws, Rays, RenderConfig, render_image
from swnerf_torch.train.checkpoint import params_from_jax
from swnerf_torch.train.loop import init_train_state
from swnerf_torch.utils import switches
from swnerf_tpu.models.dnerf import DNeRFConfig as JaxConfig
from swnerf_tpu.models.dnerf import init_nerf_original_params, make_dnerf_field
from swnerf_tpu.ops import pyramid as jp
from swnerf_tpu.ops.embedding import positional_encoding as jax_pe
from swnerf_tpu.ops.pallas.render_fused import fused_render_pass
from swnerf_tpu.pipelines import run_multires as jmr
from swnerf_tpu.render import Rays as JaxRays
from swnerf_tpu.render import RenderConfig as JaxRenderConfig
from swnerf_tpu.render.fused_eval import make_dnerf_eval_pass as jax_make_dnerf_eval_pass
from swnerf_tpu.train.fused_step import make_render_outputs
from tests.test_torch_multires import _check_grads, _check_metrics, _draws, _grad_stash, _tiny_scene

torch.set_num_threads(2)

BASE = dict(netdepth=3, netwidth=128, skips=(1,))
LEVELS = {
    "level0": dict(BASE, multires=20, multires_time=8, multires_views=20),
    "level1": dict(BASE, multires=10, multires_time=4, multires_views=10),
    "identity": dict(BASE, multires=-1, multires_time=-1, multires_views=-1, i_embed=-1),
}
SMALL_X = 2.0**-10  # level 0's positions, where the Pallas cos(u) = sin(u + pi/2) holds to fp32


def _canonical(kw, seed):
    jcfg = JaxConfig(**kw)
    params = jax.tree.map(np.asarray, init_nerf_original_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, params


def _inputs(kw, n=13, s=8, seed=0, scale=None):
    """Positions (|x| <= 1.2, or ``scale`` for level 0), sorted z, dists
    with the trailing 1e10 * |d|, the view embedding of unit directions,
    noise and per-ray cotangents of (rgb, acc, depth), all non-zero."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.2, 1.2, (n, s, 3)).astype(np.float32)
    if scale is not None:
        pts = (pts / 1.2 * scale).astype(np.float32)
    z = np.sort(rng.uniform(2, 6, (n, s)), -1).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    vd = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    dist = np.concatenate([z[:, 1:] - z[:, :-1], np.full((n, 1), 1e10, np.float32)], -1)
    dist = (dist * np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    noise = (rng.standard_normal((n, s)) * 0.7).astype(np.float32)
    ve = np.array(jax_pe(jnp.asarray(vd), JaxConfig(**kw).nf_views))
    gct = rng.standard_normal((n, 5)).astype(np.float32)
    return pts, z, dist, ve, noise, gct


def _assert_close(got, ref, rel=1e-4):
    """Each tensor: max|got - ref| <= rel * max|ref| + 1e-7."""
    for k in ref:
        g, r = np.asarray(got[k], np.float64), np.asarray(ref[k], np.float64)
        assert g.shape == r.shape, k
        err = np.abs(g - r).max()
        assert err <= rel * np.abs(r).max() + 1e-7, (k, err, np.abs(r).max())


def _check_outputs(out, ref):
    for key in ("rgb", "acc", "weights"):
        np.testing.assert_allclose(np.asarray(out[key]), np.asarray(ref[key]), atol=1e-5, rtol=5e-4, err_msg=key)
    assert np.allclose(np.asarray(out["depth"]), np.asarray(ref["depth"]), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- B3's pts mode at the MultiRes widths


@pytest.mark.parametrize("white", [True, False])
@pytest.mark.parametrize("level", ["level0", "level1"])
def test_b3_wide_twin_matches_pallas(level, white):
    """B3's pts mode on the wide pack (128 / 128 padded rows: level 0's 123 /
    123 columns, level 1's 63 / 63, whose 63 view columns exceed the
    narrow 32) against fused_render_pass(pts=..., need_param_grads=False,
    interpret=True, f32), N=13, S=8; level 0 on |x| <= 2^-10. Measured over
    params and inputs seeds 0-3 and both backgrounds: every output within
    8.9e-6."""
    kw = LEVELS[level]
    jcfg, params = _canonical(kw, 1)
    packed = b3.pack_params(params_from_jax(params), DNeRFConfig(**kw), torch.float32)
    assert packed.wide and packed.cin_pad == packed.cv_pad == 128
    pts, z, dist, ve, noise, _ = _inputs(kw, scale=SMALL_X if level == "level0" else None)
    res, _ = fused_render_pass(params, jcfg, None, jnp.asarray(ve), jnp.asarray(z), jnp.asarray(dist),
                               jnp.asarray(noise), jnp.zeros((13, 3)), white, 0.0, rays_per_tile=8, interpret=True,
                               compute_dtype=jnp.float32, pts=jnp.asarray(pts), need_param_grads=False)
    t = [torch.from_numpy(x) for x in (pts, z, dist, ve, noise)]
    out = b3.render_pass_plain(packed, None, None, t[3], t[1], t[2], t[4], white, None, t[0])
    _check_outputs(out._asdict(), res)


def test_b3_wide_twin_matches_float64_at_full_range():
    """At level 0 on full-range positions (|x| <= 1.2, encode arguments up
    to 6e5 rad) the fp32 twin (sinf/cosf of the exact products, as the
    kernel) against the float64 twin: rgb and acc within 1e-5."""
    kw = LEVELS["level0"]
    _, params = _canonical(kw, 2)
    packed = b3.pack_params(params_from_jax(params), DNeRFConfig(**kw), torch.float32)
    p64 = dataclasses.replace(packed, weights=packed.weights.double())
    t = [torch.from_numpy(x) for x in _inputs(kw, seed=3)[:5]]
    pts, z, dist, ve, noise = t
    out = b3.render_pass_plain(packed, None, None, ve, z, dist, noise, True, None, pts)
    ref = b3.render_pass_plain(p64, None, None, *(x.double() for x in (ve, z, dist, noise)), True, None,
                               pts.double())
    for key in ("rgb", "acc"):
        np.testing.assert_allclose(getattr(out, key).numpy(), getattr(ref, key).numpy(), atol=1e-5, err_msg=key)


def test_wide_pack_and_predicates():
    """supports_config keeps the narrow widths (and what they run) by
    default; ``wide`` takes inputs up to 127 / 128 columns and the identity
    embedding. pack_params takes the narrow pads wherever they fit (the
    identity level too: 3 / 3 columns) and the wide ones otherwise; the
    wide pads serve the pts mode only (the shared-memory bound on S that
    they set is the CUDA sources', held in tests/test_torch_cuda.py)."""
    full = dict(netdepth=8, netwidth=256, skips=(4,))
    for name, kw in LEVELS.items():
        cfg = DNeRFConfig(**dict(kw, **full))
        assert not b3.supports_config(cfg) and b3.supports_config(cfg, wide=True)
        model = DirectTemporalNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(0), fused=False)
        sd = {k[len("_occ."):]: v for k, v in model.state_dict().items() if k.startswith("_occ.")}
        for dtype in (torch.float32, torch.bfloat16):
            packed = b3.pack_params(sd, cfg, dtype)
            assert packed.wide == (name != "identity")
            assert packed.n_freqs == max(kw["multires"], 0) and packed.cin == cfg.input_ch
            assert (packed.cin_pad, packed.cv_pad) == ((128, 128) if packed.wide else (64, 32)), (name, dtype)
    assert b3.supports_config(DNeRFConfig()) and b3.supports_config(DNeRFConfig(), wide=True)
    assert not b3.supports_config(DNeRFConfig(multires=21), wide=True)  # 129 columns
    assert not b3.supports_config(DNeRFConfig(multires_views=22), wide=True)  # 135 view columns
    cfg = DNeRFConfig(**dict(LEVELS["level1"], **full))
    model = DirectTemporalNeRF(cfg, device="cpu", fused=False)
    packed = b3.pack_params({k[5:]: v for k, v in model.state_dict().items() if k.startswith("_occ.")}, cfg,
                            torch.float32)
    assert b3.launch_key("render_pass", packed, 64, pts=True) == "render_pass[pts,wide,S=64]"
    assert b1.ext_launch_key(packed, 64) == "render_loss[ext,wide,S=64]"


@pytest.mark.parametrize("level", ["level0", "identity"])
def test_ordered_launch_on_the_cpu_is_the_twin(level):
    """``ordered`` chooses the body of a card launch in bf16 (the training
    path's B3 launch runs the SIMT body, as B9's recomputed forward does);
    on CPU tensors the wrapper runs the plain twin either way, and the
    switch serves the pts mode only."""
    kw = dict(LEVELS[level], netdepth=3, netwidth=128, skips=(1,))
    cfg = DNeRFConfig(**kw)
    model = DirectTemporalNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(2), fused=False)
    sd = {k[len("_occ."):]: v for k, v in model.state_dict().items() if k.startswith("_occ.")}
    packed = b3.pack_params(sd, cfg, torch.bfloat16)
    pts, z, dist, ve, noise, _ = (torch.from_numpy(np.ascontiguousarray(x)) for x in _inputs(kw, n=5, s=8))
    got = b3.render_pass(packed, None, None, ve, z, dist, noise, True, None, pts, ordered=True)
    ref = b3.render_pass_plain(packed, None, None, ve, z, dist, noise, True, None, pts)
    for k in ("rgb", "acc", "depth", "weights"):
        assert torch.equal(getattr(got, k), getattr(ref, k)), k
    if not packed.wide:
        o, d = pts[:, 0].contiguous(), torch.ones(5, 3)
        with pytest.raises(ValueError, match="pts mode only"):
            b3.render_pass(packed, o, d, ve, z, dist, noise, True, ordered=True)


# ---------------------------------------------------------------- B9 and render_outputs_autograd


def _jax_render_outputs(jcfg, params, args, white):
    pts, z, dist, ve, noise, gct = args
    fn = make_render_outputs(jcfg, white, tile=8, interpret=True, compute_dtype=jnp.float32)
    out, vjp = jax.vjp(lambda p, x: fn(p, x, jnp.asarray(ve), jnp.asarray(z), jnp.asarray(dist), jnp.asarray(noise)),
                       params, jnp.asarray(pts))
    ct = {"rgb": jnp.asarray(gct[:, :3]), "acc": jnp.asarray(gct[:, 3]), "depth": jnp.asarray(gct[:, 4]),
          "weights": jnp.zeros(z.shape)}
    gp, gx = vjp(ct)
    return out, params_from_jax(jax.tree.map(np.asarray, gp)), np.asarray(gx)


@pytest.mark.parametrize("white", [True, False])
@pytest.mark.parametrize("level,seed", [("level0", 1), ("level1", 1), ("identity", 1), ("level1", 0)],
                         ids=["level0", "level1", "identity", "level1-pallas-off"])
def test_render_outputs_twin_matches_make_render_outputs(level, seed, white):
    """render_outputs_autograd on the CPU (B3's twin forward, B9's twin as
    the backward) against make_render_outputs(interpret=True, f32): rgb,
    acc, depth, weights at the output bars, and jax.vjp for seeded
    cotangents of rgb, acc and depth in every parameter and in pts: each
    tensor within 1e-4 * max|g| + 1e-7 of the float64 twin (the exact
    function) and of the Pallas kernel; N=13, S=8, level 0 on |x| <= 2^-10,
    the identity level on the narrow pads with no encoding.

    At level 1's 2^9 frequencies the Pallas kernel's own fp32 can miss that
    bar (its cos(u) = sin(u + pi/2), ROADMAP Queue C, as B5's
    ``multires10-pallas-off``). Measured over params seeds 0-3 (inputs
    seeds 10-13) and both backgrounds: outputs within 6.4e-6; gradients and
    d pts, relative to max|g|: the fp32 twin within 9.3e-6 of the float64
    twin, the Pallas kernel within 1.7e-5 of the twin except at level 1,
    params seed 0 (the ``pallas-off`` case), 3.4e-3 off, all of it its own
    distance from the float64 twin. There the twin must be within the bar
    of the float64 twin and no further from it than the Pallas kernel is,
    and the Pallas kernel within 1e-2 of it."""
    kw = LEVELS[level]
    jcfg, params = _canonical(kw, seed)
    args = _inputs(kw, seed=10 + seed, scale=SMALL_X if level == "level0" else None)
    jout, jgrads, jdpts = _jax_render_outputs(jcfg, params, args, white)
    cfg = DNeRFConfig(**kw)
    sd = {k: v.clone().requires_grad_(True) for k, v in params_from_jax(params).items()}
    packed = b3.pack_params(sd, cfg, torch.float32)
    assert packed.wide == (level != "identity")
    pts, z, dist, ve, noise, gct = (torch.from_numpy(x) for x in args)
    p = pts.clone().requires_grad_(True)
    before = sum(launches.values())
    out = b1.render_outputs_autograd(packed, torch.float32, p, ve, z, dist, noise, white)
    assert not out["weights"].requires_grad
    _check_outputs({k: v.detach().numpy() for k, v in out.items()}, jout)
    ((out["rgb"] * gct[:, :3]).sum() + (out["acc"] * gct[:, 3]).sum() + (out["depth"] * gct[:, 4]).sum()).backward()
    assert sum(launches.values()) == before
    detached = b3.pack_params(params_from_jax(params), cfg, torch.float32)
    p64 = dataclasses.replace(detached, weights=detached.weights.double())
    _, g64, d64 = b1.render_loss_ext_plain(p64, *(x.double() for x in (pts, ve, z, dist, noise, gct)), white)
    got = dict({k: v.grad.numpy() for k, v in sd.items()}, dpts=p.grad.numpy())
    exact = dict({k: v.numpy() for k, v in b1.unpack_grads(g64, p64).items()}, dpts=d64.numpy())
    ref = dict({k: v.numpy() for k, v in jgrads.items()}, dpts=jdpts)
    _assert_close(got, exact)
    for k, r in ref.items():
        scale = np.abs(exact[k]).max()
        d_port, d_ref = np.abs(got[k] - r).max(), np.abs(r - exact[k]).max()
        assert d_port <= 1e-4 * np.abs(r).max() + 1e-7 or (
            d_ref <= 1e-2 * scale and np.abs(got[k] - exact[k]).max() <= d_ref), (k, d_port, d_ref)


@pytest.mark.parametrize("white", [True, False])
def test_b9_twin_matches_autograd(white):
    """B9's written-out twin (render_loss_ext_plain) against autograd through
    B3's plain pts-mode forward (render_outputs_plain), float64, level 1's
    widths at D=8, W=256: packed gradients and d pts within 1e-10 relative;
    its forward is B3's twin's."""
    cfg = DNeRFConfig(**dict(LEVELS["level1"], netdepth=8, netwidth=256, skips=(4,)))
    model = DirectTemporalNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(6), fused=False)
    sd = {k[5:]: v.double() for k, v in model.state_dict().items() if k.startswith("_occ.")}
    packed = b3.pack_params(sd, cfg, torch.float64)
    pts, z, dist, ve, noise, gct = (torch.from_numpy(x).double() for x in _inputs(LEVELS["level1"], 5, 12, 7))
    fwd, (gw, gb), dpts = b1.render_loss_ext_plain(packed, pts, ve, z, dist, noise, gct, white)
    w, b, p = (x.clone().requires_grad_(True) for x in (packed.weights, packed.biases.double(), pts))
    ref = b1.render_outputs_plain(dataclasses.replace(packed, weights=w, biases=b), torch.float64, p, ve, z, dist,
                                  noise, white)
    ((ref["rgb"] * gct[:, :3]).sum() + (ref["acc"] * gct[:, 3]).sum() + (ref["depth"] * gct[:, 4]).sum()).backward()
    _assert_close({"w": gw.numpy(), "b": gb.numpy(), "dpts": dpts.numpy()},
                  {"w": w.grad.numpy(), "b": b.grad.numpy(), "dpts": p.grad.numpy()}, rel=1e-10)
    for k in ("rgb", "acc", "depth"):
        assert torch.equal(getattr(fwd, k), ref[k].detach()), k


# ---------------------------------------------------------------- the fused phase-2 step


def _small_time_out(params, factor=1e-3):
    params["time_net"]["out"] = {k: v * np.float32(factor) for k, v in params["time_net"]["out"].items()}
    return params


def _port_level(kw, params, dtype=torch.float32):
    model = DirectTemporalNeRF(DNeRFConfig(**kw), device="cpu", fused=False)
    model.load_state_dict(params_from_jax(params))
    return model.to(dtype)


def test_fused_phase2_step_matches_jax(monkeypatch):
    """One fused phase-2 step over level 1's widths, level 1 again and the
    identity level (8/4/2-pixel patches at 16/8/4 px): the port's
    make_phase2_step(fused=True) on the twins (B6 under autograd, B3's pts
    mode, B9) against JAX make_phase2_step(fused=True) under
    SWNERF_FUSED_STEP=force-interpret (make_render_outputs in interpret mode,
    f32), the pattern of test_phase2_step_matches_jax_make_phase2_step: same
    weights, patches, Laplacian targets, frame time, global weight 1 and
    the JAX draws handed over; metrics as _check_metrics, every level's
    gradients as _check_grads (the float64 port through compute_dtype).
    The scene is shrunk 16-fold (camera and near/far): at level 1's 2^9
    frequencies an ulp of a position 6 units out moves the encode by 2.4e-4
    rad, and either package's fp32 landed up to 5e-3 (relative) from the
    float64 gradients of the deformation net at full size, the plain fp32
    route of the port as far as its fused one."""
    monkeypatch.setenv("SWNERF_FUSED_STEP", "force-interpret")
    kws = [LEVELS["level1"], LEVELS["level1"], LEVELS["identity"]]
    RC = dict(n_samples=8, n_importance=0, perturb=1.0, white_bkgd=True)
    jrc, rcfg = JaxRenderConfig(**RC), RenderConfig(**RC)
    _, _, images, poses, times = _tiny_scene()
    poses[:, :3, 3] /= 16.0
    near, far = 2.0 / 16, 6.0 / 16
    pyr_hwf = [[16 // 2**l, 16 // 2**l, 20.0 / 2**l] for l in range(3)]
    patch_sizes = [8, 4, 2]
    coords = [(4, 4), (2, 2), (1, 1)]
    fields = [make_dnerf_field(JaxConfig(**kw), fused=False) for kw in kws]
    assert all(jmr.supports_fused_phase2(f, jrc) for f in fields)
    params = [_small_time_out(jax.tree.map(np.asarray, f.init(jax.random.PRNGKey(21 + l))))
              for l, f in enumerate(fields)]
    lap = [np.asarray(b) for b in jp.generate_laplacian_pyramid(jnp.asarray(images), levels=3)]
    pixels = [np.stack(np.meshgrid(np.arange(y, y + ps), np.arange(x, x + ps), indexing="ij"), -1).reshape(-1, 2)
              for (y, x), ps in zip(coords, patch_sizes)]
    targets = [lap[l][2, y : y + ps, x : x + ps] for l, ((y, x), ps) in enumerate(zip(coords, patch_sizes))]
    key = jax.random.PRNGKey(8)
    stash = _grad_stash()
    jstep = jmr.make_phase2_step(None, fields, [stash] * 3, jrc, pyr_hwf, patch_sizes, near, far, fused=True)
    jparams = [{"coarse": jax.tree.map(jnp.asarray, p), "fine": None} for p in params]
    _, jstates, m_ref = jstep(jparams, [stash.init(p) for p in jparams], [jnp.asarray(p) for p in pixels],
                              [jnp.asarray(t) for t in targets], jnp.asarray(images[2, 4:12, 4:12]),
                              jnp.asarray(poses[2, :3, :4]), jnp.float32(times[2]), jnp.float32(1.0), key)
    refs = [{k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, s["coarse"])).items()}
            for s in jstates]
    draws = [_draws(key, ps * ps, 8) for ps in patch_sizes]
    grads, metrics = {}, {}
    for dtype in (torch.float32, torch.float64):
        step = mr.make_phase2_step(rcfg, pyr_hwf, patch_sizes, near, far, fused=True, compute_dtype=dtype)
        states = [init_train_state(_port_level(kw, p, dtype), None, 5e-4, 250) for kw, p in zip(kws, params)]
        cast = lambda x: torch.from_numpy(np.array(x)).to(dtype)  # noqa: E731
        metrics[dtype] = step(states, [torch.from_numpy(p) for p in pixels], [cast(t) for t in targets],
                              cast(images[2, 4:12, 4:12]), cast(poses[2, :3, :4]), float(times[2]), 1.0,
                              draws=[Draws(*(None if x is None else x.to(dtype) for x in d)) for d in draws])
        grads[dtype] = [{k: p.grad.numpy() for k, p in st.coarse.named_parameters()} for st in states]
    _check_metrics(metrics, m_ref, ("loss_layer_0", "loss_layer_1", "loss_layer_2", "global_loss", "total_loss"))
    for l in range(3):
        _check_grads(grads[torch.float32][l], grads[torch.float64][l], refs[l])


def test_fused_phase2_step_matches_the_unfused_step():
    """The port's fused phase-2 step against its own unfused step (the
    fields through render_rays), four levels at the config's channels
    (level 0 on a scene a thousandth the size, so that its encode stays
    well conditioned; the deformation heads small), the same draws with
    density noise: metrics rel 1e-5 and every gradient within 1e-4 *
    max|g| + 1e-7. Measured: metrics within 2.0e-7, gradients within
    5.6e-5 * max|g| (level 0's 2^19 encoding, summed in two orders)."""
    kws = [LEVELS["level0"], LEVELS["level1"], LEVELS["level1"], LEVELS["identity"]]
    rcfg = RenderConfig(n_samples=8, perturb=1.0, raw_noise_std=0.5, white_bkgd=True)
    ps_all = [8, 4, 2, 1]
    pyr_hwf = [[16 // 2**l, 16 // 2**l, 20.0 / 2**l] for l in range(4)]
    near, far = 2e-3, 6e-3
    g = torch.Generator().manual_seed(9)
    models = []
    for l, kw in enumerate(kws):
        m = DirectTemporalNeRF(DNeRFConfig(**kw), device="cpu", generator=torch.Generator().manual_seed(30 + l),
                               fused=False)
        with torch.no_grad():
            m._time_out.weight.mul_(1e-6)
            m._time_out.bias.mul_(1e-6)
        models.append(m)
    draws = [Draws(torch.rand((ps * ps, 8), generator=g), torch.randn((ps * ps, 8), generator=g) * 0.5, None, None)
             for ps in ps_all]
    pixels = [torch.stack(torch.meshgrid(torch.arange(ps), torch.arange(ps), indexing="ij"), -1).reshape(-1, 2)
              for ps in ps_all]
    targets = [torch.rand((ps, ps, 3), generator=g) for ps in ps_all]
    full = torch.rand((8, 8, 3), generator=g)
    pose = torch.eye(4)[:3, :4].clone()
    pose[2, 3] = 4e-3
    out = {}
    for fused in (False, True):
        states = [init_train_state(_copy(m), None, 5e-4, 250) for m in models]
        met = mr.make_phase2_step(rcfg, pyr_hwf, ps_all, near, far, fused=fused)(
            states, pixels, targets, full, pose, 0.4, 1.0, draws=draws)
        out[fused] = (met, [{k: p.grad.numpy() for k, p in st.coarse.named_parameters()} for st in states])
    for k, v in out[False][0].items():
        assert abs(float(out[True][0][k]) - float(v)) <= 1e-5 * abs(float(v)) + 1e-12, k
    for l in range(4):
        _assert_close(out[True][1][l], out[False][1][l])


def _copy(model):
    m = DirectTemporalNeRF(model.cfg, device="cpu", fused=False)
    m.load_state_dict(model.state_dict())
    return m


@pytest.mark.parametrize("mode,expect", [
    ("0", [False] * 4), ("1", [True] * 4), ("1,0,0,0", [True, False, False, False]),
    ("0,1", [False, True, False, False]), (None, [False] * 4),
])
def test_fused_multires_switch_grammar(monkeypatch, mode, expect):
    """SWNERF_FUSED_MULTIRES as run_multires.py:276-290 reads it: "0" (the
    default) fuses nothing, "1" every supported level, a comma list chooses
    per level; an unsupported level never fuses; SWNERF_FUSED=0 fuses
    nothing. fused_levels reads it, and make_phase2_step(fused=None) runs
    B9's route exactly on the chosen levels (counted through
    render_outputs_autograd)."""
    if mode is None:
        monkeypatch.delenv("SWNERF_FUSED_MULTIRES", raising=False)
    else:
        monkeypatch.setenv("SWNERF_FUSED_MULTIRES", mode)
    assert switches.fused_multires("cpu", [True] * 4) == expect
    assert switches.fused_multires("cpu", [True, True, False, True]) == [e and l != 2 for l, e in enumerate(expect)]
    kws = [LEVELS["level1"]] * 3 + [LEVELS["identity"]]
    rcfg = RenderConfig(n_samples=4, perturb=1.0, white_bkgd=True)
    models = [DirectTemporalNeRF(DNeRFConfig(**kw), device="cpu", generator=torch.Generator().manual_seed(l),
                                 fused=False) for l, kw in enumerate(kws)]
    assert all(mr.supports_fused_phase2(m, rcfg) for m in models)
    assert not mr.supports_fused_phase2(models[0], dataclasses.replace(rcfg, n_importance=4))
    calls = []
    real = b1.render_outputs_autograd
    monkeypatch.setattr(b1, "render_outputs_autograd", lambda *a: calls.append(a[2].shape[0]) or real(*a))
    ps_all = [4, 2, 1, 1]
    pixels = [torch.zeros((ps * ps, 2), dtype=torch.long) for ps in ps_all]
    targets = [torch.rand((ps, ps, 3)) for ps in ps_all]
    pose = torch.eye(4)[:3, :4].clone()
    pose[2, 3] = 4.0
    states = [init_train_state(m, None) for m in models]
    assert mr.fused_levels(states, rcfg, "cpu") == expect
    step = mr.make_phase2_step(rcfg, [[8, 8, 10.0], [4, 4, 5.0], [2, 2, 2.5], [1, 1, 1.25]], ps_all, 2.0, 6.0)
    step(states, pixels, targets, torch.rand((4, 4, 3)), pose, 0.5, 1.0, generator=torch.Generator().manual_seed(0))
    assert calls == [ps_all[l] ** 2 for l in range(4) if expect[l]]
    monkeypatch.setenv("SWNERF_FUSED", "0")
    assert switches.fused_multires("cpu", [True] * 4) == [False] * 4


# ---------------------------------------------------------------- the test render through the eval pass


def test_level_eval_passes_and_the_test_render_match_jax():
    """make_level_eval_passes gives levels 0-2 the D-NeRF eval pass (B6, B3's
    pts mode on the wide pack) and the identity level none (it renders
    through its fields), as make_dnerf_field attaches them; SWNERF_FUSED_EVAL
    (switches.eval_pass_route) and the kernel widths decide. Each level's
    render_image through its pass against the JAX eval pass (interpret, f32)
    at atol 1e-5, rtol 1e-5: 13 rays, a quarter at t = 0, 8 samples; level 0
    on a scene 2^-10 the size (its encode well conditioned) with its
    deformation head scaled by 1e-6 and its density bias raised by 2^13 (so
    that the short steps composite: alpha ~ 0.7, not 0). Measured: within
    1.8e-6, and 1.4e-7 relative for level 0's disp (~10^3)."""
    kws = [LEVELS["level0"], LEVELS["level1"], LEVELS["level1"], LEVELS["identity"]]
    states, jparams = [], []
    for l, kw in enumerate(kws):
        field = make_dnerf_field(JaxConfig(**kw), fused=False)
        p = _small_time_out(jax.tree.map(np.asarray, field.init(jax.random.PRNGKey(40 + l))),
                            1e-6 if l == 0 else 1e-3)
        if l == 0:
            p["canonical"]["alpha_linear"]["b"] = p["canonical"]["alpha_linear"]["b"] + np.float32(2.0**13)
        jparams.append(p)
        states.append(init_train_state(_port_level(kw, p), None))
    passes = mr.make_level_eval_passes(states, torch.device("cpu"))
    assert [p is not None for p in passes] == [True, True, True, False]
    ecfg = RenderConfig(n_samples=8, white_bkgd=True).eval_mode()
    jecfg = JaxRenderConfig(n_samples=8, white_bkgd=True).eval_mode()
    for l in range(3):
        scale = SMALL_X if l == 0 else 1.0
        rng = np.random.default_rng(l)
        d = rng.standard_normal((13, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o = (rng.uniform(-1, 1, (13, 3)) * 0.3 * scale).astype(np.float32)
        t = rng.uniform(0, 1, (13, 1)).astype(np.float32)
        t[:3] = 0.0
        near, far = np.float32(0.5 * scale), np.float32(1.5 * scale)
        rays = Rays(*(torch.from_numpy(x) for x in (o, d, d.copy())), torch.full((13,), float(near)),
                    torch.full((13,), float(far)), torch.from_numpy(t))
        jrays = JaxRays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(d), jnp.full((13,), near), jnp.full((13,), far),
                        jnp.asarray(t))
        ref = jax_make_dnerf_eval_pass(JaxConfig(**kws[l]), interpret=True, compute_dtype=jnp.float32)(
            jparams[l], None, None, jrays, jecfg)
        got = render_image(states[l].coarse, rays, ecfg, chunk=7, eval_pass=passes[l])
        assert float(got["acc"].min()) > 0.05, (l, got["acc"])  # the rays composite: the comparison is not vacuous
        for key, r in zip(("rgb", "disp", "acc", "depth"), ref):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(r), atol=1e-5, rtol=1e-5, err_msg=(l, key))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SWNERF_FUSED_EVAL", "0")
        assert mr.make_level_eval_passes(states, torch.device("cpu")) == [None] * 4
