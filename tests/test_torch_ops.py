"""swnerf_torch.ops against the JAX functions and the numpy oracles, fp32.

Inputs come from a numpy seed and go to both packages; the port runs on the
CPU. Tolerance: atol 1e-5 (fp32 with differently ordered reductions).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swnerf_torch.ops import embedding as t_emb
from swnerf_torch.ops import rays as t_rays
from swnerf_torch.ops import sampling as t_samp
from swnerf_torch.ops import volume as t_vol
from swnerf_torch.ops.kernels.sample_pdf import sample_pdf_plain
from swnerf_tpu.ops import embedding as j_emb
from swnerf_tpu.ops import rays as j_rays
from swnerf_tpu.ops import sampling as j_samp
from swnerf_tpu.ops import volume as j_vol
from tests.oracles import embed_oracle, get_rays_oracle, raw2outputs_oracle, sample_pdf_oracle

torch.set_num_threads(2)

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


@pytest.mark.parametrize("num_freqs", [-1, 0, 4, 10])
def test_positional_encoding(num_freqs):
    x = np.random.default_rng(0).uniform(-4, 4, (50, 3)).astype(np.float32)
    got = t_emb.positional_encoding(_t(x), num_freqs).numpy()
    assert got.shape[-1] == t_emb.embedding_dim(num_freqs) == j_emb.embedding_dim(num_freqs)
    np.testing.assert_allclose(got, np.asarray(j_emb.positional_encoding(jnp.asarray(x), num_freqs)), atol=ATOL)
    np.testing.assert_allclose(got, embed_oracle(x.astype(np.float64), num_freqs), atol=ATOL)


def _pose(seed=0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = q
    c2w[:3, 3] = rng.uniform(-2, 2, 3)
    return c2w


@pytest.mark.parametrize("intrinsics", ["focal", "K"])
def test_get_rays(intrinsics):
    H, W, f = 12, 16, 20.5
    fk = f if intrinsics == "focal" else np.array([[f, 0, 7.5], [0, f + 1, 6.25], [0, 0, 1]])
    c2w = _pose()
    o, d = t_rays.get_rays(H, W, fk, c2w, device="cpu")
    jo, jd = j_rays.get_rays(H, W, fk, c2w)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=ATOL)
    oo, od = get_rays_oracle(H, W, fk, c2w)
    np.testing.assert_allclose(d.numpy(), od, atol=ATOL)
    no, nd = t_rays.get_rays_np(H, W, fk, c2w)
    jno, jnd = j_rays.get_rays_np(H, W, fk, c2w)
    np.testing.assert_array_equal(nd, jnd)
    np.testing.assert_array_equal(no, jno)


def test_ndc_rays():
    rng = np.random.default_rng(1)
    o = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    d = rng.standard_normal((40, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    got = t_rays.ndc_rays(30, 40, 35.0, 1.0, _t(o), _t(d))
    ref = j_rays.ndc_rays(30, 40, 35.0, 1.0, jnp.asarray(o), jnp.asarray(d))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("lindisp", [False, True])
def test_sample_along_rays_det(lindisp):
    near, far = np.full((7,), 2.0, np.float32), np.full((7,), 6.0, np.float32)
    got = t_samp.sample_along_rays(_t(near), _t(far), 64, 0.0, lindisp)
    ref = j_samp.sample_along_rays(None, jnp.asarray(near), jnp.asarray(far), 64, 0.0, lindisp)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_sample_along_rays_perturbed_within_intervals():
    near, far = torch.full((9,), 2.0), torch.full((9,), 6.0)
    g = torch.Generator().manual_seed(0)
    z = t_samp.sample_along_rays(near, far, 32, 1.0, generator=g)
    det = t_samp.sample_along_rays(near, far, 32, 0.0)
    mids = 0.5 * (det[:, 1:] + det[:, :-1])
    lower = torch.cat([det[:, :1], mids], -1)
    upper = torch.cat([mids, det[:, -1:]], -1)
    assert bool(((z >= lower) & (z <= upper)).all())
    z2 = t_samp.sample_along_rays(near, far, 32, 1.0, generator=torch.Generator().manual_seed(0))
    assert torch.equal(z, z2)  # the generator fixes the draw


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_composite(white_bkgd):
    rng = np.random.default_rng(2)
    raw = rng.standard_normal((20, 16, 4)).astype(np.float32)
    z = np.sort(rng.uniform(2, 6, (20, 16)), -1).astype(np.float32)
    d = rng.standard_normal((20, 3)).astype(np.float32)
    got = t_vol.composite(_t(raw), _t(z), _t(d), white_bkgd=white_bkgd)
    ref = j_vol.composite(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(d), white_bkgd=white_bkgd)
    ora = raw2outputs_oracle(raw.astype(np.float64), z.astype(np.float64), d.astype(np.float64), white_bkgd)
    for k, (a, b, o) in enumerate(zip(got, ref, ora)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=1e-5, err_msg=str(k))
        np.testing.assert_allclose(a.numpy(), o, atol=ATOL, rtol=1e-5, err_msg=str(k))


def test_composite_disp_keeps_nan_at_zero_acc():
    raw = torch.full((2, 4, 4), -5.0)
    raw[..., 3] = -1.0  # relu -> zero density -> acc == depth == 0
    z = torch.linspace(2, 6, 4).expand(2, 4)
    out = t_vol.composite(raw, z, torch.ones(2, 3))
    assert torch.isnan(out.disp).all()


def _pdf_inputs(n=300, m=63, s=128, seed=3):
    """Evenly spaced bins (as the coarse z midpoints are) and weights in
    [0.5, 1]. The output's sensitivity to cdf rounding is gap / pdf, so
    fp32 implementations that sum in different orders stay within atol 1e-5
    here. Where a bin's cdf step sits at the denom < 1e-5 guard, a rounding
    difference can flip the guard and move a sample by up to one bin width
    (ROADMAP.md Queue C), which is why the kernel is held to its own plain
    twin bit for bit and not to these."""
    rng = np.random.default_rng(seed)
    bins = np.broadcast_to(np.linspace(2, 6, m, dtype=np.float32), (n, m)).copy()
    w = rng.uniform(0.5, 1, (n, m - 1)).astype(np.float32)
    u = rng.uniform(0, 1, (n, s)).astype(np.float32)
    return bins, w, u


@pytest.mark.parametrize("det", [True, False])
def test_sample_pdf_plain(det):
    bins, w, u = _pdf_inputs()
    if det:
        got = t_samp.sample_pdf(_t(bins), _t(w), 128, det=True).numpy()
        ref = j_samp.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 128, det=True)
        u = torch.linspace(0, 1, 128).expand(u.shape).numpy()
    else:
        got = t_samp.sample_pdf(_t(bins), _t(w), 128, u=_t(u)).numpy()
        ref = j_samp.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 128, u=jnp.asarray(u))
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(got, sample_pdf_oracle(bins, w, u), atol=ATOL)
    np.testing.assert_array_equal(got, sample_pdf_plain(_t(bins), _t(w), _t(u)).numpy())
    assert got.min() >= 2.0 and got.max() <= 6.0


def test_sample_pdf_edge_uniforms_and_zero_weights():
    """All-zero weights (the 1e-5 floor decides) and u at 0, 1, 0.5."""
    bins = np.linspace(2.0, 6.0, 63, dtype=np.float32)[None].repeat(4, 0)
    w = np.zeros((4, 62), np.float32)
    u = np.stack([np.zeros(16), np.ones(16), np.full(16, 0.5), np.linspace(0, 1, 16)]).astype(np.float32)
    got = t_samp.sample_pdf(_t(bins), _t(w), 16, u=_t(u)).numpy()
    np.testing.assert_allclose(got, sample_pdf_oracle(bins, w, u), atol=ATOL)
    ref = j_samp.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 16, u=jnp.asarray(u))
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)


def test_sample_pdf_random_uniforms_use_generator():
    bins, w, _ = _pdf_inputs(n=16)
    a = t_samp.sample_pdf(_t(bins), _t(w), 32, generator=torch.Generator().manual_seed(5))
    b = t_samp.sample_pdf(_t(bins), _t(w), 32, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not a.requires_grad


def test_merge_and_sample_pdf_merge():
    rng = np.random.default_rng(4)
    z = np.sort(rng.uniform(2, 6, (10, 16)), -1).astype(np.float32)
    w = rng.uniform(0, 1, (10, 16)).astype(np.float32)
    got = t_samp.sample_pdf_merge(_t(z), _t(w), 24, det=True).numpy()
    ref = j_samp.sample_pdf_merge(jnp.asarray(z), jnp.asarray(w), 24, det=True)
    assert got.shape == (10, 40)
    assert np.all(np.diff(got, axis=-1) >= 0)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)
