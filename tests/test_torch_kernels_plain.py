"""The plain twins of kernels B2 and B3 against the JAX Pallas kernels run
in interpret mode (fp32), one test group per kernel module. The CUDA
kernels themselves are held to these twins on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swnerf_torch.models import VanillaNeRFConfig
from swnerf_torch.ops.embedding import positional_encoding
from swnerf_torch.ops.kernels import launches
from swnerf_torch.ops.kernels import render_pass as b3
from swnerf_torch.ops.kernels import sample_pdf as b2
from swnerf_torch.train.checkpoint import params_from_jax
from swnerf_tpu.models.vanilla import VanillaNeRFConfig as JaxConfig
from swnerf_tpu.models.vanilla import init_vanilla_params
from swnerf_tpu.ops.embedding import positional_encoding as jax_pe
from swnerf_tpu.ops.pallas.render_fused import fused_render_pass
from swnerf_tpu.ops.pallas.sample_pdf import sample_pdf_pallas
from swnerf_tpu.ops.sampling import sample_pdf as jax_sample_pdf

torch.set_num_threads(2)


# ---------------------------------------------------------------- B2


def _pdf_inputs(n=300, m=63, s=128, seed=0):
    """N=300 is not a multiple of the Pallas kernel's 128-ray blocks, so its
    padding is exercised. Evenly spaced bins and weights in [0.5, 1] keep
    the problem well conditioned (see tests/test_torch_ops.py)."""
    rng = np.random.default_rng(seed)
    bins = np.broadcast_to(np.linspace(2, 6, m, dtype=np.float32), (n, m)).copy()
    w = rng.uniform(0.5, 1, (n, m - 1)).astype(np.float32)
    u = rng.uniform(0, 1, (n, s)).astype(np.float32)
    return bins, w, u


@pytest.mark.parametrize("mode", ["det", "given_u"])
def test_b2_plain_matches_pallas_and_jnp(mode):
    bins, w, u = _pdf_inputs()
    if mode == "det":
        u = torch.linspace(0.0, 1.0, 128).expand(u.shape).numpy()
        kw = dict(det=True)
    else:
        kw = dict(u=jnp.asarray(u))
    got = b2.sample_pdf_plain(torch.from_numpy(bins), torch.from_numpy(w), torch.from_numpy(u)).numpy()
    pallas = sample_pdf_pallas(jnp.asarray(bins), jnp.asarray(w), 128, interpret=True, **kw)
    ref = jax_sample_pdf(jnp.asarray(bins), jnp.asarray(w), 128, **kw)
    assert got.shape == (300, 128)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5)
    assert got.min() >= 2.0 and got.max() <= 6.0


def test_b2_wrapper_runs_the_twin_on_cpu():
    bins, w, u = (torch.from_numpy(x) for x in _pdf_inputs(n=40))
    before = launches["sample_pdf"]
    assert torch.equal(b2.sample_pdf(bins, w, u), b2.sample_pdf_plain(bins, w, u))
    assert launches["sample_pdf"] == before  # the CPU path launches nothing


def test_b2_plain_sums_in_index_order():
    """The twin's cdf is the sequential fp32 running sum the kernel forms."""
    bins, w, u = (torch.from_numpy(x) for x in _pdf_inputs(n=4, m=9, s=5))
    got = b2.sample_pdf_plain(bins, w, u)
    wf = (w + 1e-5).numpy()
    for r in range(4):
        total = np.float32(wf[r, 0])
        for j in range(1, 8):
            total = np.float32(total + wf[r, j])
        cdf = [np.float32(0)]
        for j in range(8):
            cdf.append(np.float32(cdf[-1] + np.float32(wf[r, j] / total)))
        for s in range(5):
            us = u[r, s].item()
            inds = sum(c <= us for c in cdf)
            lo, hi = max(0, inds - 1), min(8, inds)
            denom = np.float32(cdf[hi] - cdf[lo])
            denom = np.float32(1) if denom < 1e-5 else denom
            t = np.float32(np.float32(us - cdf[lo]) / denom)
            b_lo, b_hi = bins[r, lo].numpy(), bins[r, hi].numpy()
            assert got[r, s].item() == np.float32(b_lo + np.float32(t * np.float32(b_hi - b_lo)))


# ---------------------------------------------------------------- B3


def _small_config():
    kw = dict(netdepth=3, netwidth=128, skips=(1,), multires=4, multires_views=2)
    return JaxConfig(**kw), VanillaNeRFConfig(**kw)


def _render_inputs(n, s, seed=0):
    rng = np.random.default_rng(seed)
    o = (rng.standard_normal((n, 3)) * 0.3).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(2, 6, (n, s)), -1).astype(np.float32)
    dist = np.concatenate([z[:, 1:] - z[:, :-1], np.full((n, 1), 1e10, np.float32)], -1)
    dist = (dist * np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    noise = (rng.standard_normal((n, s)) * 0.1).astype(np.float32)
    return o, d, vd, z, dist, noise


@pytest.mark.parametrize("n_samples", [8, 16])
@pytest.mark.parametrize("white_bkgd", [True, False])
def test_b3_plain_matches_pallas(n_samples, white_bkgd):
    jcfg, tcfg = _small_config()
    params = jax.tree.map(np.asarray, init_vanilla_params(jax.random.PRNGKey(0), jcfg))
    n = 13  # not a multiple of the Pallas ray tile: padding exercised
    o, d, vd, z, dist, noise = _render_inputs(n, n_samples)
    res, _ = fused_render_pass(
        params, jcfg, None, jax_pe(jnp.asarray(vd), jcfg.nf_views), jnp.asarray(z), jnp.asarray(dist),
        jnp.asarray(noise), jnp.zeros((n, 3)), white_bkgd, 0.0, rays_per_tile=8, interpret=True,
        compute_dtype=jnp.float32, origins=jnp.asarray(o), directions=jnp.asarray(d),
        need_param_grads=False,
    )
    packed = b3.pack_params(params_from_jax(params), tcfg, torch.float32)
    t = torch.from_numpy
    out = b3.render_pass_plain(
        packed, t(o), t(d), positional_encoding(t(vd), tcfg.nf_views), t(z), t(dist), t(noise), white_bkgd
    )
    # The bar of tests/test_fused_eval.py:46-48: the Pallas kernel sums
    # per-ray maps through a segment matmul and builds cos as sin(t + pi/2).
    for key, got in (("rgb", out.rgb), ("acc", out.acc), ("depth", out.depth), ("weights", out.weights)):
        np.testing.assert_allclose(got.numpy(), np.asarray(res[key]), atol=1e-5, rtol=5e-4, err_msg=key)


@pytest.mark.parametrize("white_bkgd", [True, False])
def test_b3_plain_matches_pallas_multires10(white_bkgd):
    """Multires 10/4, the width of every full-scale config (D=3, W=128,
    skip 1, N=13, S=16, fp32, interpret mode). The Pallas kernel builds cos
    as sin(t + pi/2) and t reaches ~2000 rad, where rounding t + pi/2 to
    fp32 moves the cos; the port keeps its true cos. Measured over seeds 0-3
    and both backgrounds: max |d| 2.2e-6 rgb, 4.2e-6 acc, 3.7e-5 depth (rel
    1e-5), 1.2e-5 weights, past the atol 1e-5 of the multires-4 test. Bar:
    atol 3e-5 (2.5x the measured maximum), rtol 5e-4."""
    kw = dict(netdepth=3, netwidth=128, skips=(1,), multires=10, multires_views=4)
    jcfg, tcfg = JaxConfig(**kw), VanillaNeRFConfig(**kw)
    params = jax.tree.map(np.asarray, init_vanilla_params(jax.random.PRNGKey(0), jcfg))
    n = 13
    o, d, vd, z, dist, noise = _render_inputs(n, 16)
    res, _ = fused_render_pass(
        params, jcfg, None, jax_pe(jnp.asarray(vd), jcfg.nf_views), jnp.asarray(z), jnp.asarray(dist),
        jnp.asarray(noise), jnp.zeros((n, 3)), white_bkgd, 0.0, rays_per_tile=8, interpret=True,
        compute_dtype=jnp.float32, origins=jnp.asarray(o), directions=jnp.asarray(d),
        need_param_grads=False,
    )
    packed = b3.pack_params(params_from_jax(params), tcfg, torch.float32)
    t = torch.from_numpy
    out = b3.render_pass_plain(
        packed, t(o), t(d), positional_encoding(t(vd), tcfg.nf_views), t(z), t(dist), t(noise), white_bkgd
    )
    for key, got in (("rgb", out.rgb), ("acc", out.acc), ("depth", out.depth), ("weights", out.weights)):
        np.testing.assert_allclose(got.numpy(), np.asarray(res[key]), atol=3e-5, rtol=5e-4, err_msg=key)


def test_b3_wrapper_runs_the_twin_on_cpu():
    _, tcfg = _small_config()
    from swnerf_torch.models import VanillaNeRF

    model = VanillaNeRF(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    packed = b3.pack_params(model.state_dict(), tcfg, torch.float32)
    o, d, vd, z, dist, _ = (torch.from_numpy(x) for x in _render_inputs(5, 8))
    ve = positional_encoding(vd, tcfg.nf_views)
    before = sum(launches.values())
    a = b3.render_pass(packed, o, d, ve, z, dist, None, True)
    b = b3.render_pass_plain(packed, o, d, ve, z, dist, None, True)
    assert sum(launches.values()) == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_b3_bf16_twin_rounds_operands():
    """bf16 operands round the weights, embeddings and activations; the
    result stays close to fp32 and differs from it."""
    _, tcfg = _small_config()
    from swnerf_torch.models import VanillaNeRF

    model = VanillaNeRF(tcfg, device="cpu", generator=torch.Generator().manual_seed(1))
    o, d, vd, z, dist, _ = (torch.from_numpy(x) for x in _render_inputs(32, 16, seed=2))
    ve = positional_encoding(vd, tcfg.nf_views)
    f32 = b3.render_pass_plain(b3.pack_params(model.state_dict(), tcfg, torch.float32), o, d, ve, z, dist)
    p16 = b3.pack_params(model.state_dict(), tcfg, torch.bfloat16)
    assert p16.weights.dtype == torch.bfloat16 and p16.biases.dtype == torch.float32
    bf = b3.render_pass_plain(p16, o, d, ve, z, dist)
    diff = (bf.rgb - f32.rgb).abs()
    assert 0 < diff.max() < 5e-2


def test_pack_params_layout():
    """Every packed matrix is the transposed, padded checkpoint weight, and
    the MAC count is the unpadded network's (593,408 at D=8, W=256)."""
    cfg = VanillaNeRFConfig()
    from swnerf_torch.models import VanillaNeRF

    model = VanillaNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    p = b3.pack_params(sd, cfg, torch.float32)
    m, b = p.matrices(), p.bias_vectors()
    assert p.macs_per_sample == 593_408
    assert torch.equal(m["pts0"][:63], sd["pts_linears.0.weight"].t())
    assert torch.equal(m["pts0"][63:], torch.zeros(1, 256))
    assert torch.equal(m["pts5_emb"][:63], sd["pts_linears.5.weight"].t()[:63])
    assert torch.equal(m["pts5"], sd["pts_linears.5.weight"].t()[63:])
    assert torch.equal(m["views_emb"][:27], sd["views_linears.0.weight"].t()[256:])
    assert torch.equal(m["alpha"][:, 0], sd["alpha_linear.weight"][0])
    assert torch.equal(b["rgb"], sd["rgb_linear.bias"]) and torch.equal(b["alpha"], sd["alpha_linear.bias"])
    assert p.weights.numel() == sum(r * c for _, r, c in b3.weight_layout(8, 256, 4))
    assert all(r * c % 8 == 0 for _, r, c in b3.weight_layout(8, 256, 4)[:-1])  # 16-byte aligned tiles


@pytest.mark.parametrize(
    "kw,ok",
    [
        (dict(), True),
        (dict(netwidth=128), True),
        (dict(netwidth=192), False),
        (dict(multires=11), False),
        (dict(use_viewdirs=False), False),
        (dict(skips=(6,), netdepth=7), False),
        (dict(i_embed=-1), False),
    ],
)
def test_supports_config(kw, ok):
    assert b3.supports_config(VanillaNeRFConfig(**kw)) is ok
