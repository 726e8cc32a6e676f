"""Kernel B7 (the field trunk on embedded inputs and its backward) and the
widened kernel B6 (separate position and time frequencies, the identity
level, the 144-row input) through their plain twins on the CPU, against the
JAX package's Pallas kernels in interpret mode (fp32) and its plain
functions. The CUDA kernels are held to the twins on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 23).

Shapes: D=4, W=128, skip 2 at MultiRes's per-level frequencies (20, 8, 20),
(10, 4, 10) and the identity (-1, -1, -1); 12 rays x 8 samples (96 rows,
within the interpret-mode budget). Bars, with the maxima measured in each
test's docstring: outputs atol 1e-5, rtol 5e-4; every gradient tensor and
``demb`` within ``max|d| <= 1e-4 * max|g_ref| + 1e-7``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swnerf_torch.models import DirectTemporalNeRF, DNeRFConfig
from swnerf_torch.ops.embedding import positional_encoding
from swnerf_torch.ops.kernels import launches
from swnerf_torch.ops.kernels import time_net as b6
from swnerf_torch.ops.kernels import trunk as b7
from swnerf_torch.train.checkpoint import params_from_jax
from swnerf_tpu.models.dnerf import DNeRFConfig as JaxConfig
from swnerf_tpu.models.dnerf import apply_nerf_original, init_nerf_original_params, init_time_net_params
from swnerf_tpu.ops.embedding import positional_encoding as jax_pe
from swnerf_tpu.ops.pallas.raymarch import fused_time_net, fused_trunk

torch.set_num_threads(2)

BASE = dict(netdepth=4, netwidth=128, skips=(2,))
LEVELS = {
    "level0": dict(BASE, multires=20, multires_time=8, multires_views=20),
    "level1": dict(BASE, multires=10, multires_time=4, multires_views=10),
    "identity": dict(BASE, multires=-1, multires_time=-1, multires_views=-1, i_embed=-1),
}


def _assert_close(got, ref, rel=1e-4):
    """Each tensor: max|got - ref| <= rel * max|ref| + 1e-7."""
    assert set(got) == set(ref)
    for k in ref:
        g, r = np.asarray(got[k], np.float64), np.asarray(ref[k], np.float64)
        assert g.shape == r.shape, (k, g.shape, r.shape)
        err = np.abs(g - r).max()
        assert err <= rel * np.abs(r).max() + 1e-7, (k, err, np.abs(r).max())


def _emb_inputs(kw, n=12, s=8, seed=0):
    """Embedded positions [n*s, input_ch] and per-sample view embeddings
    [n*s, input_ch_views] of positions in [-1.2, 1.2] (the frequencies and
    identities of the level), and a cotangent g [n*s, 4]."""
    cfg = DNeRFConfig(**kw)
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.2, 1.2, (n * s, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    vd = np.repeat(d / np.linalg.norm(d, axis=-1, keepdims=True), s, 0)
    emb = np.asarray(jax_pe(jnp.asarray(pts), cfg.nf_pts))
    vemb = np.asarray(jax_pe(jnp.asarray(vd), cfg.nf_views))
    g = rng.standard_normal((n * s, 4)).astype(np.float32)
    return cfg, emb, vemb, g


def _canonical(kw, seed):
    jcfg = JaxConfig(**kw)
    params = jax.tree.map(np.asarray, init_nerf_original_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, params


# ---------------------------------------------------------------- B7


@pytest.mark.parametrize("level", list(LEVELS))
def test_b7_twin_matches_pallas_and_plain(level):
    """raw of B7's twin against fused_trunk(interpret=True) and
    apply_nerf_original on the same embeddings, fp32. Measured max |d|
    (seed 0): level 0 9.5e-7, level 1 8.3e-7, identity 6.0e-7 against the
    Pallas kernel; 1.2e-6, 1.7e-6, 1.5e-6 against the plain function."""
    kw = LEVELS[level]
    cfg, emb, vemb, _ = _emb_inputs(kw)
    jcfg, params = _canonical(kw, 0)
    ref = fused_trunk(params, jcfg, jnp.asarray(emb), jnp.asarray(vemb), block=64, interpret=True,
                      compute_dtype=jnp.float32)
    plain = apply_nerf_original(params, jcfg, jnp.asarray(emb), jnp.asarray(vemb))
    packed = b7.pack_trunk_params(params_from_jax(params), cfg, torch.float32)
    got = b7.trunk_plain(packed, torch.from_numpy(emb), torch.from_numpy(vemb))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=5e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(plain), atol=1e-5, rtol=5e-4)


@pytest.mark.parametrize("level", list(LEVELS))
def test_b7_twin_backward_matches_pallas_vjp(level):
    """The parameter gradients and demb of sum(g * raw) through
    fused_trunk's custom VJP (the Pallas backward, interpret mode,
    need_input_grads=True) and through jax.grad of apply_nerf_original,
    against B7's twin backward. Measured (seed 1) within 4.1e-7 * max|g|
    of the Pallas kernel and 8.0e-7 * max|g| of jax.grad."""
    kw = LEVELS[level]
    cfg, emb, vemb, g = _emb_inputs(kw, seed=1)
    jcfg, params = _canonical(kw, 1)
    ja, jv, jg = jnp.asarray(emb), jnp.asarray(vemb), jnp.asarray(g)

    def fused(p, e):
        return jnp.sum(jg * fused_trunk(p, jcfg, e, jv, block=64, interpret=True, compute_dtype=jnp.float32))

    def plain(p, e):
        return jnp.sum(jg * apply_nerf_original(p, jcfg, e, jv))

    packed = b7.pack_trunk_params(params_from_jax(params), cfg, torch.float32)
    grads, demb, dvemb = b7.trunk_plain_bwd(packed, torch.from_numpy(emb), torch.from_numpy(vemb),
                                            torch.from_numpy(g))
    assert dvemb is None and demb.shape == emb.shape
    got = dict({k: v.numpy() for k, v in b7.unpack_trunk_grads(grads, packed).items()}, demb=demb.numpy())
    for fn in (fused, plain):
        gp, ge = jax.grad(fn, argnums=(0, 1))(params, ja)
        ref = dict({k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, gp)).items()},
                   demb=np.asarray(ge))
        _assert_close(got, ref)


def test_b7_view_cotangent_and_autograd_on_cpu():
    """dvemb (formed only where autograd asks) against jax.grad in the view
    embedding; trunk_autograd hands the twin's gradients to the parameters
    and the embeddings through the differentiable packing; the CPU wrappers
    launch nothing; supports_trunk and the MACs per row."""
    kw = LEVELS["level1"]
    cfg, emb, vemb, g = _emb_inputs(kw, seed=2)
    jcfg, params = _canonical(kw, 2)
    ref_v = jax.grad(lambda v: jnp.sum(jnp.asarray(g) * apply_nerf_original(params, jcfg, jnp.asarray(emb), v)))(
        jnp.asarray(vemb))
    packed = b7.pack_trunk_params(params_from_jax(params), cfg, torch.float32)
    _, _, dvemb = b7.trunk_plain_bwd(packed, torch.from_numpy(emb), torch.from_numpy(vemb), torch.from_numpy(g),
                                     need_demb=False, need_dvemb=True)
    _assert_close({"dvemb": dvemb.numpy()}, {"dvemb": np.asarray(ref_v)})

    model = DirectTemporalNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    occ = dict(model._occ.named_parameters())
    e = torch.from_numpy(emb).requires_grad_(True)
    v = torch.from_numpy(vemb)
    before = sum(launches.values())
    raw = b7.trunk_autograd(b7.pack_trunk_params(occ, cfg, torch.float32), torch.float32, e, v)
    (raw * torch.from_numpy(g)).sum().backward()
    detached = b7.pack_trunk_params(model._occ.state_dict(), cfg, torch.float32)
    raw2, grads, demb, none = b7.trunk_fwd_bwd(detached, e.detach(), v, torch.from_numpy(g))
    assert sum(launches.values()) == before and none is None
    assert torch.equal(raw.detach(), raw2) and torch.equal(b7.trunk(detached, e.detach(), v), raw2)
    assert torch.equal(e.grad, demb)
    for k, val in b7.unpack_trunk_grads(grads, detached).items():
        assert torch.equal(occ[k].grad, val), k
    assert b7.supports_trunk(DNeRFConfig(**LEVELS["level0"]))
    for bad in (dict(BASE, multires=21, multires_views=4), dict(BASE, multires=10, multires_views=21),
                dict(BASE, netwidth=96), dict(BASE, skips=(3,))):
        assert not b7.supports_trunk(DNeRFConfig(**bad)), bad
    p0 = b7.pack_trunk_params(DirectTemporalNeRF(DNeRFConfig(**dict(LEVELS["level0"], netdepth=8, netwidth=256,
                                                                    skips=(4,))), device="cpu")._occ.state_dict(),
                              DNeRFConfig(**dict(LEVELS["level0"], netdepth=8, netwidth=256, skips=(4,))))
    # 2*123*256 + 7*256^2 + 256^2 + 256 + (256 + 123)*128 + 128*3: about 636k, as the issue sizes it
    assert p0.macs_per_row == 636416
    assert p0.bwd_macs_per_row() == 636416 + 384 + 256 * 128 + 256**2 + 256 + 7 * 256**2 + 2 * 123 * 256


# ---------------------------------------------------------------- B6 widened


def _time_tree_to_port(tree):
    out = {}
    for name, lyr in [(f"_time.{i}", lyr) for i, lyr in enumerate(tree["layers"])] + [("_time_out", tree["out"])]:
        out[f"{name}.weight"] = torch.tensor(np.asarray(lyr["w"]).T)
        out[f"{name}.bias"] = torch.tensor(np.asarray(lyr["b"]))
    return out


def _time_inputs(n=12, s=8, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.2, 1.2, (n, s, 3)).astype(np.float32)
    times = rng.uniform(0, 1, (n,)).astype(np.float32)
    return pts, times


@pytest.mark.parametrize("level", list(LEVELS))
def test_b6_widened_twin_matches_pallas(level):
    """B6's twin (in-block encode with Lx position and Lt time frequencies)
    against fused_time_net(interpret=True) on the JAX-encoded rows: dx at
    atol 1e-5, and the parameter gradients of sum(g * dx) at the gradient
    bar. Level 0 packs 140 live columns into 144 rows. Measured (seed 3):
    dx within 6.0e-8 (0 at the identity), gradients within 3.2e-7 *
    max|g|."""
    kw = LEVELS[level]
    cfg = DNeRFConfig(**kw)
    jcfg = JaxConfig(**kw)
    tp = jax.tree.map(np.asarray, init_time_net_params(jax.random.PRNGKey(3), jcfg))
    pts, times = _time_inputs(seed=3)
    pe = jax_pe(jnp.asarray(pts), jcfg.nf_pts)
    te = jax_pe(jnp.asarray(np.broadcast_to(times[:, None, None], (12, 8, 1))), jcfg.nf_time)
    g = np.random.default_rng(4).standard_normal((12, 8, 3)).astype(np.float32)
    ref = fused_time_net(tp, jcfg, pe, te, block=64, interpret=True, compute_dtype=jnp.float32)

    def f(p):
        return jnp.sum(jnp.asarray(g) * fused_time_net(p, jcfg, pe, te, block=64, interpret=True,
                                                        compute_dtype=jnp.float32, need_input_grads=False))

    packed = b6.pack_time_params(_time_tree_to_port(tp), cfg, torch.float32)
    assert packed.cin == cfg.input_ch + cfg.input_ch_time
    assert packed.cin_pad == (144 if level == "level0" else 96)
    got = b6.time_net_plain(packed, torch.from_numpy(pts), torch.from_numpy(times))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=5e-4)
    grads = b6.time_net_plain_bwd(packed, torch.from_numpy(pts), torch.from_numpy(times), torch.from_numpy(g))
    ref_g = _time_tree_to_port(jax.tree.map(np.asarray, jax.grad(f)(tp)))
    _assert_close({k: v.numpy() for k, v in b6.unpack_time_grads(grads, packed).items()},
                  {k: v.numpy() for k, v in ref_g.items()})


def test_b6_wide_layout_keeps_the_skip_time_rows_zero():
    """At level 0 the skip block's embedding rows hold embed(x)'s 123 rows,
    then zeros through row 144 where embed(t) would sit; the twin encodes x
    with 20 frequencies and t with 8 (positional_encoding's column order)."""
    cfg = DNeRFConfig(**dict(LEVELS["level0"]))
    model = DirectTemporalNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    packed = b6.pack_time_params(model.state_dict(), cfg, torch.float32)
    rows = packed.matrices()["pts3_emb"]
    assert rows.shape == (144, 128) and not rows[123:].any() and rows[:123].abs().sum() > 0
    assert (packed.n_freqs, packed.n_freqs_time, packed.cin) == (20, 8, 140)
    pts, times = (torch.from_numpy(x) for x in _time_inputs(3, 4, 6))
    t = times[:, None, None].expand(3, 4, 1)
    dx = model.time_net(positional_encoding(pts, 20), positional_encoding(t, 8))
    np.testing.assert_allclose(b6.time_net_plain(packed, pts, times).detach().numpy(), dx.detach().numpy(),
                               atol=1e-5, rtol=5e-4)
    ident = b6.pack_time_params(model.state_dict(), cfg, torch.float32)
    assert dataclasses.replace(ident, n_freqs=0, n_freqs_time=0).cin == 4


@pytest.mark.parametrize("level", ["level0", "level1"])
def test_fp32_demb_against_a_bf16_rounded_one(level):
    """B7 keeps demb in fp32; the Pallas backward casts it to the compute
    dtype, bf16 on the TPU (raymarch.py:765). What that rounding costs,
    measured on the twin (D=4, W=128, 96 rows, seed 4): demb moves by at
    most bf16's unit roundoff 2^-8 per element (measured 3.9e-3; 1.6e-3 rel
    L2), and the cotangent it carries to the warped positions (through
    positional_encoding's backward, where level 0's 2^19 frequencies weigh
    the highest columns) by 1.75e-3 rel L2 at level 0 and 1.48e-3 at level
    1; bar 3e-3 (ROADMAP.md Queue C)."""
    kw = LEVELS[level]
    cfg, emb, vemb, g = _emb_inputs(kw, seed=4)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(-1.2, 1.2, (96, 3)).astype(np.float32)).requires_grad_(True)
    e = positional_encoding(x, cfg.nf_pts)
    _, params = _canonical(kw, 4)
    packed = b7.pack_trunk_params(params_from_jax(params), cfg, torch.float32)
    _, demb, _ = b7.trunk_plain_bwd(packed, e.detach(), torch.from_numpy(vemb), torch.from_numpy(g))
    d16 = demb.to(torch.bfloat16).float()
    rel_elem = ((d16 - demb).abs() / demb.abs().clamp_min(1e-30)).max().item()
    assert rel_elem <= 2.0**-8
    dx = torch.autograd.grad(e, x, demb, retain_graph=True)[0]
    dx16 = torch.autograd.grad(e, x, d16)[0]
    rel = ((dx16 - dx).norm() / dx.norm()).item()
    assert rel <= 3e-3, rel
