"""Kernels B7' (the ELU T-NeRF trunk on embedded inputs) and B8 (the
vanilla trunk with the encode in the kernel) through their plain twins on
the CPU, against the JAX package's Pallas kernels in interpret mode
(``fused_tnerf``, ``fused_field_raw``, fp32), and the fields' kernel routes
(``TNeRF`` / ``VanillaNeRF`` with ``fused=True``: the twins on the CPU)
against the JAX fields' plain route. The CUDA kernels are held to the twins
on the card (tests/test_torch_cuda.py, chip_smoke.py phases 26-27).

Shapes: D=4, W=128, skip 2 (T-NeRF ``skip_layer=2``) at multires 4/2 and
10/4; 12 rays x 8 samples (96 rows, within the interpret-mode budget).
Bars, with the maxima measured in each test's docstring: outputs atol
1e-5, rtol 5e-4; every gradient tensor within ``max|d| <= 1e-4 *
max|g_ref| + 1e-7`` (B8's backward: each side against a float64 reference
on its own encoding, since at multires 10 the Pallas kernel's cos moves a
ReLU mask)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swnerf_torch.models import TNeRF, TNeRFConfig, VanillaNeRF, VanillaNeRFConfig
from swnerf_torch.ops.kernels import launches
from swnerf_torch.ops.kernels import trunk as b7
from swnerf_torch.ops.kernels.render_pass import field_mlp
from swnerf_torch.train.checkpoint import params_from_jax
from swnerf_tpu.models.tnerf import TNeRFConfig as JaxTConfig
from swnerf_tpu.models.tnerf import init_tnerf_params, make_tnerf_field
from swnerf_tpu.models.vanilla import VanillaNeRFConfig as JaxVConfig
from swnerf_tpu.models.vanilla import init_vanilla_params, make_vanilla_field
from swnerf_tpu.ops.embedding import positional_encoding as jax_pe
from swnerf_tpu.ops.pallas.raymarch import fused_field_raw, fused_tnerf

torch.set_num_threads(2)

FREQS = {"multires4": dict(multires=4, multires_views=2), "multires10": dict(multires=10, multires_views=4)}
TKW = dict(netdepth=4, net_dim=128, skip_layer=2)
VKW = dict(netdepth=4, netwidth=128, skips=(2,))


def _assert_close(got, ref, rel=1e-4):
    """Each tensor: max|got - ref| <= rel * max|ref| + 1e-7."""
    assert set(got) == set(ref)
    for k in ref:
        g, r = np.asarray(got[k], np.float64), np.asarray(ref[k], np.float64)
        assert g.shape == r.shape, (k, g.shape, r.shape)
        err = np.abs(g - r).max()
        assert err <= rel * np.abs(r).max() + 1e-7, (k, err, np.abs(r).max())


def _rays(n=12, s=8, seed=0):
    """Sample positions [n, s, 3] in [-1.2, 1.2], unit view directions
    [n, 3], frame times [n, 1] and a cotangent [n*s, 4]."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.2, 1.2, (n, s, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    vd = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t = rng.uniform(0.0, 1.0, (n, 1)).astype(np.float32)
    g = rng.standard_normal((n * s, 4)).astype(np.float32)
    return pts, vd, t, g


# ---------------------------------------------------------------- B7'


def _tnerf_inputs(freq, seed):
    jcfg = JaxTConfig(**TKW, **FREQS[freq])
    cfg = TNeRFConfig(**TKW, **FREQS[freq])
    params = jax.tree.map(np.asarray, init_tnerf_params(jax.random.PRNGKey(seed), jcfg))
    pts, vd, t, g = _rays(seed=seed)
    n, s = pts.shape[:2]
    pe = np.asarray(jax_pe(jnp.asarray(pts.reshape(-1, 3)), jcfg.nf_pts))
    te = np.asarray(jax_pe(jnp.asarray(np.repeat(t, s, 0)), jcfg.nf_time))
    ve = np.asarray(jax_pe(jnp.asarray(np.repeat(vd, s, 0)), jcfg.nf_views))
    return jcfg, cfg, params, pe, te, ve, g


@pytest.mark.parametrize("freq", list(FREQS))
def test_b7p_twin_matches_pallas(freq):
    """raw of B7''s twin against fused_tnerf(interpret=True) on the same
    embeddings, fp32. Measured max |d| (seed 0): multires 4 6.0e-8,
    multires 10 1.8e-7."""
    jcfg, cfg, params, pe, te, ve, _ = _tnerf_inputs(freq, 0)
    ref = fused_tnerf(params, jcfg, jnp.asarray(pe), jnp.asarray(ve), jnp.asarray(te), block=64, interpret=True,
                      compute_dtype=jnp.float32)
    packed = b7.pack_tnerf_trunk_params(params_from_jax(params), cfg, torch.float32)
    assert packed.arch == "tnerf" and packed.cin == pe.shape[1] + te.shape[1]
    got = b7.trunk_plain(packed, torch.from_numpy(np.concatenate([pe, te], -1)), torch.from_numpy(ve))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=5e-4)
    assert (got[:, :3] >= 0).all() and (got[:, :3] == 0).any()  # the colour ReLU, live on these weights


@pytest.mark.parametrize("freq", list(FREQS))
def test_b7p_twin_backward_matches_pallas_vjp(freq):
    """The parameter gradients and the embeddings' cotangents (position,
    time, view) of sum(g * raw) through fused_tnerf's custom VJP (the
    Pallas backward in interpret mode, need_input_grads=True, colour
    cotangent masked by u > 0) against B7''s twin backward. Measured
    (seed 1) within 4.8e-7 * max|g| at multires 4, 8.3e-7 at multires 10."""
    jcfg, cfg, params, pe, te, ve, g = _tnerf_inputs(freq, 1)
    jg = jnp.asarray(g)

    def loss(p, a, v, t):
        return jnp.sum(jg * fused_tnerf(p, jcfg, a, v, t, block=64, interpret=True, compute_dtype=jnp.float32))

    gp, gpe, gve, gte = jax.grad(loss, argnums=(0, 1, 2, 3))(params, jnp.asarray(pe), jnp.asarray(ve),
                                                            jnp.asarray(te))
    packed = b7.pack_tnerf_trunk_params(params_from_jax(params), cfg, torch.float32)
    grads, demb, dvemb = b7.trunk_plain_bwd(packed, torch.from_numpy(np.concatenate([pe, te], -1)),
                                            torch.from_numpy(ve), torch.from_numpy(g), True, True)
    got = dict({k: v.numpy() for k, v in b7.unpack_trunk_grads(grads, packed).items()},
               dpts_emb=demb[:, : pe.shape[1]].numpy(), dtime_emb=demb[:, pe.shape[1]:].numpy(), dvemb=dvemb.numpy())
    ref = dict({k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, gp)).items()},
               dpts_emb=np.asarray(gpe), dtime_emb=np.asarray(gte), dvemb=np.asarray(gve))
    _assert_close(got, ref)


def test_b7p_colour_mask_is_u_positive():
    """The twin masks the colour cotangent by the recomputed pre-clip logits
    u > 0 (raymarch.py:364-368), not by the bf16 sigmoid rule of the render
    kernels: the backward of g equals the backward of g with the colour
    columns zeroed where u <= 0, and differs from that of the unmasked
    field where any u <= 0 carries a cotangent. 14% of the logits are <= 0
    on these seeded weights."""
    _, cfg, params, pe, te, ve, g = _tnerf_inputs("multires4", 2)
    packed = b7.pack_tnerf_trunk_params(params_from_jax(params), cfg, torch.float32)
    emb, vemb, gt = torch.from_numpy(np.concatenate([pe, te], -1)), torch.from_numpy(ve), torch.from_numpy(g)
    e, v = b7._padded(packed, emb, vemb)
    u = field_mlp(packed, e, v)[4]
    live = (u > 0).float().mean().item()
    assert 0.2 < live < 0.9, live
    masked = torch.cat([torch.where(u > 0, gt[:, :3], torch.zeros_like(gt[:, :3])), gt[:, 3:]], -1)
    a, da, _ = b7.trunk_plain_bwd(packed, emb, vemb, gt)
    b, db, _ = b7.trunk_plain_bwd(packed, emb, vemb, masked)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and torch.equal(da, db)
    assert torch.equal(b7.trunk_plain(packed, emb, vemb)[:, :3], torch.relu(u))
    c = b7.field_reverse_plain(packed, e, v, *field_mlp(packed, e, v)[:3], gt)[0]
    assert not torch.equal(a[1], c[1])  # the unmasked sweep's rgb bias gradient differs


# ---------------------------------------------------------------- B8


def _raw_inputs(freq, seed):
    jcfg = JaxVConfig(**VKW, **FREQS[freq])
    cfg = VanillaNeRFConfig(**VKW, **FREQS[freq])
    params = jax.tree.map(np.asarray, init_vanilla_params(jax.random.PRNGKey(seed), jcfg))
    pts, vd, _, g = _rays(seed=seed)
    n, s = pts.shape[:2]
    return jcfg, cfg, params, pts.reshape(-1, 3), np.repeat(vd, s, 0), g


@pytest.mark.parametrize("freq", list(FREQS))
def test_b8_twin_matches_pallas(freq):
    """raw of B8's twin against fused_field_raw(interpret=True) on the same
    positions and per-row view directions, fp32. Measured max |d| (seed 0):
    multires 4 5.2e-8, multires 10 3.6e-7."""
    jcfg, cfg, params, pts, vd, _ = _raw_inputs(freq, 0)
    ref = fused_field_raw(params, jcfg, jnp.asarray(pts), jnp.asarray(vd), block=64, interpret=True,
                          compute_dtype=jnp.float32)
    packed = b7.pack_trunk_params(params_from_jax(params), cfg, torch.float32)
    assert b7.supports_field_raw(cfg) and packed.n_freqs == (cfg.multires, cfg.multires_views)
    got = b7.field_raw_plain(packed, torch.from_numpy(pts), torch.from_numpy(vd))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=5e-4)


def _pallas_encoding(x, L):
    """The Pallas kernels' encode of x [P, 3] (raymarch.py::_embed_fwd) in
    float64 from its fp32 arguments: t = fl32(x 2^f) for the sin columns and
    fl32(x 2^f + fl32(pi/2)) for the cos columns, sin(t) for both. Returns
    (embedding [P, 3 + 6L], t [P, 3 + 6L] with the identity columns' t
    unused)."""
    x32 = x.astype(np.float32)
    cols, ts = [x32.astype(np.float64)], [np.zeros_like(x32, np.float64)]
    for f in range(L):
        u = (x32 * np.float32(2.0**f)).astype(np.float32)
        for t in (u, (u + np.float32(np.pi / 2)).astype(np.float32)):
            cols.append(np.sin(t.astype(np.float64)))
            ts.append(t.astype(np.float64))
    return np.concatenate(cols, -1), np.concatenate(ts, -1)


def _pallas_encoding_bwd(t, demb, L):
    """raymarch.py::_embed_bwd in float64: d/dx = demb[identity] + sum_f 2^f
    (demb_sin cos(t_sin) + demb_cos cos(t_cos))."""
    out = demb[:, :3].copy()
    for f in range(L):
        for c in (3 + 6 * f, 6 + 6 * f):
            out += 2.0**f * demb[:, c : c + 3] * np.cos(t[:, c : c + 3])
    return out


@pytest.mark.parametrize("freq", list(FREQS))
def test_b8_twin_backward_matches_pallas_vjp(freq):
    """The parameter gradients, d pts and d viewdirs of sum(g * raw)
    through fused_field_raw's custom VJP (interpret mode) and through B8's
    twin backward, each against the float64 twin on its own encoding: the
    twin (true cos) within 1e-4 * max|g| + 1e-7 of the float64 twin, and the
    Pallas kernel within the same bar of the float64 trunk on the Pallas
    encoding (cos as sin(u + pi/2), u rounded to fp32; ROADMAP Queue C).
    Both encodings agree to fp32 rounding, but at multires 10 (|u| up to
    ~600 rad) their difference can flip a ReLU near 0: at seed 1 the Pallas
    kernel lies 3.7e-2 * max|g| from the true-cos float64 gradient in
    pts_linears.1.weight, the twin 3.9e-7 of it, and the Pallas kernel 3.1e-7
    of the float64 trunk on its own encoding. At multires 4 (seed 1): twin
    3.0e-7, Pallas 3.5e-7."""
    jcfg, cfg, params, pts, vd, g = _raw_inputs(freq, 1)
    jg = jnp.asarray(g)

    def loss(p, x, v):
        return jnp.sum(jg * fused_field_raw(p, jcfg, x, v, block=64, interpret=True, compute_dtype=jnp.float32))

    gp, gx, gv = jax.grad(loss, argnums=(0, 1, 2))(params, jnp.asarray(pts), jnp.asarray(vd))
    sd = params_from_jax(params)
    packed = b7.pack_trunk_params(sd, cfg, torch.float32)
    grads, dpts, dvd = b7.field_raw_plain_bwd(packed, torch.from_numpy(pts), torch.from_numpy(vd),
                                              torch.from_numpy(g))
    got = dict({k: v.numpy() for k, v in b7.unpack_trunk_grads(grads, packed).items()}, dpts=dpts.numpy(),
               dvd=dvd.numpy())
    p64 = b7.pack_trunk_params({k: v.double() for k, v in sd.items()}, cfg, torch.float64)
    g64, d64, v64 = b7.field_raw_plain_bwd(p64, torch.from_numpy(pts).double(), torch.from_numpy(vd).double(),
                                           torch.from_numpy(g).double())
    _assert_close(got, dict({k: v.numpy() for k, v in b7.unpack_trunk_grads(g64, p64).items()}, dpts=d64.numpy(),
                            dvd=v64.numpy()))
    (emb, t), (vemb, tv) = _pallas_encoding(pts, cfg.multires), _pallas_encoding(vd, cfg.multires_views)
    gpe, demb, dvemb = b7.trunk_plain_bwd(p64, torch.from_numpy(emb), torch.from_numpy(vemb),
                                          torch.from_numpy(g).double(), True, True)
    ref = dict({k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, gp)).items()}, dpts=np.asarray(gx),
               dvd=np.asarray(gv))
    _assert_close(ref, dict({k: v.numpy() for k, v in b7.unpack_trunk_grads(gpe, p64).items()},
                            dpts=_pallas_encoding_bwd(t, demb.numpy(), cfg.multires),
                            dvd=_pallas_encoding_bwd(tv, dvemb.numpy(), cfg.multires_views)))


# ---------------------------------------------------------------- the fields' routes


def _grads(model):
    return {k: p.grad.detach().numpy().copy() for k, p in model.named_parameters()}


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "twin-route"])
@pytest.mark.parametrize("freq", list(FREQS))
def test_tnerf_field_routes_match_jax(freq, fused):
    """TNeRF(fused=False) and its kernel route on the CPU (fused=True: B7''s
    twin through trunk_autograd) against make_tnerf_field(fused=False).apply
    on the same weights, rays and times: raw (atol 1e-5, rtol 5e-4) and the
    parameter gradients of sum(g * raw) (rel 1e-4). Measured within 1.2e-7
    (raw) and 6.7e-7 * max|g|."""
    jcfg, cfg, params, *_ = _tnerf_inputs(freq, 3)
    pts, vd, t, g = _rays(seed=3)
    model = TNeRF(cfg, device="cpu", fused=fused)
    model.load_state_dict(params_from_jax(params))
    assert model.fused is fused
    field = make_tnerf_field(jcfg, fused=False)
    jg = jnp.asarray(g.reshape(pts.shape[0], pts.shape[1], 4))
    ref, _ = field.apply(params, jnp.asarray(pts), jnp.asarray(vd), jnp.asarray(t))
    gref = jax.grad(lambda p: jnp.sum(jg * field.apply(p, jnp.asarray(pts), jnp.asarray(vd), jnp.asarray(t))[0]))(
        params)
    raw = model(torch.from_numpy(pts), torch.from_numpy(vd), torch.from_numpy(t))
    np.testing.assert_allclose(raw.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=5e-4)
    (raw * torch.from_numpy(np.asarray(jg))).sum().backward()
    _assert_close(_grads(model), {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, gref)).items()})


@pytest.mark.parametrize("route", ["plain", "b7-twin", "b8-twin"])
def test_vanilla_field_routes_match_jax(route, monkeypatch):
    """VanillaNeRF(fused=False), its kernel route on the CPU (B7's twin) and
    that route under SWNERF_FUSED_RAW=1 (B8's twin through
    field_raw_autograd) against make_vanilla_field(fused=False).apply,
    multires 10/4: raw (atol 1e-5, rtol 5e-4) and the parameter gradients
    (rel 1e-4). Measured within 6.0e-8 (raw) and 4.4e-7 * max|g|. The CPU
    routes launch nothing."""
    monkeypatch.setenv("SWNERF_FUSED_RAW", "1" if route == "b8-twin" else "0")
    jcfg, cfg, params, *_ = _raw_inputs("multires10", 4)
    pts, vd, _, g = _rays(seed=4)
    model = VanillaNeRF(cfg, device="cpu", fused=route != "plain")
    model.load_state_dict(params_from_jax(params))
    assert model.uses_field_raw() is (route == "b8-twin")
    field = make_vanilla_field(jcfg, fused=False)
    jg = jnp.asarray(g.reshape(pts.shape[0], pts.shape[1], 4))
    ref, _ = field.apply(params, jnp.asarray(pts), jnp.asarray(vd))
    gref = jax.grad(lambda p: jnp.sum(jg * field.apply(p, jnp.asarray(pts), jnp.asarray(vd))[0]))(params)
    launches.clear()
    raw = model(torch.from_numpy(pts), torch.from_numpy(vd))
    np.testing.assert_allclose(raw.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=5e-4)
    (raw * torch.from_numpy(np.asarray(jg))).sum().backward()
    _assert_close(_grads(model), {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, gref)).items()})
    assert not launches


@pytest.mark.parametrize("input_grads", ["0", "1"])
def test_kernel_route_input_grads_switch(input_grads, monkeypatch):
    """SWNERF_FUSED_INPUT_GRADS: on the kernel route the embeddings are
    detached (no position gradient, as the JAX field's stop_gradient gives
    zeros) unless it is 1; then the twin route's d pts matches the plain
    route's autograd d pts (rel 1e-4). Vanilla (B7) and T-NeRF (B7')."""
    monkeypatch.setenv("SWNERF_FUSED_INPUT_GRADS", input_grads)
    pts, vd, t, g = _rays(seed=5)
    cases = (
        (VanillaNeRF, VanillaNeRFConfig(**VKW, **FREQS["multires4"]), ()),
        (TNeRF, TNeRFConfig(**TKW, **FREQS["multires4"]), (torch.from_numpy(t),)),
    )
    for cls, cfg, extra in cases:
        dpts = {}
        for fused in (False, True):
            model = cls(cfg, device="cpu", generator=torch.Generator().manual_seed(0), fused=fused)
            x = torch.from_numpy(pts).requires_grad_(True)
            (model(x, torch.from_numpy(vd), *extra) * torch.from_numpy(g).reshape(*pts.shape[:2], 4)).sum().backward()
            dpts[fused] = x.grad
        assert dpts[False] is not None
        if input_grads == "1":
            _assert_close({"dpts": dpts[True].numpy()}, {"dpts": dpts[False].numpy()})
        else:
            assert dpts[True] is None
