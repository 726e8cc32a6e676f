"""The mesh sweep's tile (``VanillaNeRF.query_views``) against the JAX
sweep's field call, and ``extract_mesh.sample_grid``'s one packing per
sweep, on the CPU.

``query_views`` on the plain route at the mesh widths (D=8, W 64 and 128,
skip 4, multires 10/4), 37 points x 5 views, fp32, weights from a seeded
numpy draw carried into both packages by ``params_from_jax``: raw against
``make_vanilla_field(fused=False).apply`` on the same broadcast inputs (the
body of ``swnerf_tpu/pipelines/extract_mesh.py::sample_grid``'s ``one``),
atol 1e-5. ``sample_grid`` on the kernel route's twins (``fused=True``, B7's
and, under ``SWNERF_FUSED_RAW=1``, B8's) packs the weights once per sweep
and gives the grid that packing at every tile gives, bit for bit. The card's
sweep is ``chip_smoke.py``'s phase 29."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swnerf_torch.models import VanillaNeRF, VanillaNeRFConfig
from swnerf_torch.ops.kernels import launches
from swnerf_torch.ops.kernels import trunk as b7
from swnerf_torch.pipelines import extract_mesh
from swnerf_torch.train.checkpoint import params_from_jax
from swnerf_tpu.models.vanilla import VanillaNeRFConfig as JaxVConfig
from swnerf_tpu.models.vanilla import init_vanilla_params, make_vanilla_field

torch.set_num_threads(2)

MESH = dict(netdepth=8, skips=(4,), multires=10, multires_views=4)


def _numpy_params(jcfg, seed):
    """The JAX field's parameter tree with every leaf drawn anew from a
    seeded numpy generator: kernels uniform in +-sqrt(6 / fan_in) (He's
    bound, which keeps the ReLU trunk's scale), biases in +-0.1."""
    rng = np.random.default_rng(seed)
    shapes = jax.tree.map(np.asarray, init_vanilla_params(jax.random.PRNGKey(0), jcfg))

    def draw(x):
        bound = np.sqrt(6.0 / x.shape[0]) if x.ndim == 2 else 0.1
        return rng.uniform(-bound, bound, x.shape).astype(np.float32)

    return jax.tree.map(draw, shapes)


@pytest.mark.parametrize("width", [64, 128])
def test_query_views_matches_jax_field(width):
    """raw [V, C, 4] of query_views(points [C, 3], views [V, 3]) against
    the JAX field's apply on the points broadcast to [V, C, 3] and the views
    [V, 3]: atol 1e-5. Measured max |d| 2.9e-6 at max |raw| 7.3 (W 64) and
    1.9e-6 at 4.2 (W 128)."""
    jcfg, cfg = JaxVConfig(netwidth=width, **MESH), VanillaNeRFConfig(netwidth=width, **MESH)
    params = _numpy_params(jcfg, seed=width)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-2.0, 2.0, (37, 3)).astype(np.float32)
    views = extract_mesh.fibonacci_sphere(5)
    model = VanillaNeRF(cfg, device="cpu", fused=False)
    model.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = model.query_views(torch.from_numpy(pts), torch.from_numpy(views))
    field = make_vanilla_field(jcfg, fused=False)
    ref, _ = field.apply(params, jnp.broadcast_to(jnp.asarray(pts)[None], (5, 37, 3)), jnp.asarray(views))
    assert got.shape == (5, 37, 4) and np.abs(np.asarray(ref)).max() > 0.5
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("raw_route", [False, True], ids=["b7-twin", "b8-twin"])
def test_sample_grid_packs_once(raw_route, monkeypatch):
    """sample_grid on the kernel route's twins (W 128, a 6^3 grid in tiles of
    64 points x 3 views: 4 tiles) packs the weights once, where calling
    query_views tile by tile packs them at every tile, and both give the
    same grid bit for bit; no packing outlives the sweep, and the CPU
    launches nothing."""
    monkeypatch.setenv("SWNERF_FUSED_RAW", "1" if raw_route else "0")
    cfg = VanillaNeRFConfig(netwidth=128, **MESH)
    model = VanillaNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(0), fused=True)
    assert model.fused and model.uses_field_raw() is raw_route
    packs = []
    pack = b7.pack_trunk_params
    monkeypatch.setattr(b7, "pack_trunk_params", lambda *a, **k: packs.append(1) or pack(*a, **k))
    bounds = ((-1.0, 1.0), (-1.0, 2.0), (-2.0, 1.0))
    launches.clear()
    density, colors, axes = extract_mesh.sample_grid(model, bounds, resolution=6, num_views=3, chunk=64)
    assert len(packs) == 1 and not hasattr(model, "_packed_once") and not launches

    X, Y, Z = np.meshgrid(*axes, indexing="ij")
    pts = torch.from_numpy(np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1).astype(np.float32))
    pts = torch.cat([pts, torch.zeros((256 - pts.shape[0], 3))])
    views = torch.from_numpy(extract_mesh.fibonacci_sphere(3))
    with torch.no_grad():
        ref = torch.cat([model.query_views(pts[i : i + 64], views).mean(0) for i in range(0, 256, 64)])[:216]
    assert len(packs) == 5
    np.testing.assert_array_equal(density, ref[:, 3].reshape(6, 6, 6).numpy())
    np.testing.assert_array_equal(colors, ref[:, :3].reshape(6, 6, 6, 3).numpy())
