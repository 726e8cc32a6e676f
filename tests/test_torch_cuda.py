"""The CUDA kernels B2 and B3 against their plain twins, on the card.

Marked ``cuda``; without a card every test skips. Run on a machine with an
H100 (the repo's conftest imports JAX, which that machine need not have):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances are those of chip_smoke.py: B2 bit-exact; B3 fp32 atol 1e-4 on
rgb/acc and rtol 1e-4 on depth; B3 bf16 max |drgb| <= 1e-2, mean <= 1e-3.
"""

import pytest
import torch

from swnerf_torch.models import VanillaNeRF, VanillaNeRFConfig
from swnerf_torch.ops.embedding import positional_encoding
from swnerf_torch.ops.kernels import build, launches
from swnerf_torch.ops.kernels import render_pass as b3
from swnerf_torch.ops.kernels import sample_pdf as b2

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain twin's matmuls in true fp32
    return torch.device("cuda")


def test_build(dev):
    libs = build.build()
    assert set(libs) == set(build.SOURCES) and all(p.exists() for p in libs.values())


def _pdf_inputs(dev, n, m=63, s=128, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.sort(torch.rand((n, m), generator=g, device=dev) * 4 + 2, -1).values
    w64 = torch.rand((n, m + 1), generator=g, device=dev)
    w64[: n // 3, 5:] = 0.0  # the denom < 1e-5 guard
    return bins, w64[:, 1:-1], torch.rand((n, s), generator=g, device=dev)


@pytest.mark.parametrize("det", [True, False])
def test_b2_bit_exact(dev, det):
    bins, w, u = _pdf_inputs(dev, 4099)  # strided weights, N % 4 != 0
    if det:
        u = torch.linspace(0, 1, 128, device=dev).expand(4099, 128)
    before = launches["sample_pdf"]
    got = b2.sample_pdf(bins, w, u)
    torch.cuda.synchronize()
    assert launches["sample_pdf"] == before + 1
    assert torch.equal(got, b2.sample_pdf_plain(bins, w, u))


def test_b2_rejects_bad_inputs(dev):
    bins, w, u = _pdf_inputs(dev, 8)
    with pytest.raises(ValueError):
        b2.sample_pdf(bins, w[:, :-1], u)
    with pytest.raises(ValueError):
        b2.sample_pdf(bins, w, u.t().contiguous().t())


def _rays(dev, n, s, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    o = torch.randn((n, 3), generator=g, device=dev) * 0.3 + torch.tensor([0.0, 0.0, 4.0], device=dev)
    d = torch.randn((n, 3), generator=g, device=dev)
    d[:, 2] = -d[:, 2].abs() - 1.0
    z = torch.sort(torch.rand((n, s), generator=g, device=dev) * 4 + 2, -1).values
    dist = torch.cat([z[:, 1:] - z[:, :-1], torch.full((n, 1), 1e10, device=dev)], -1)
    dist = dist * torch.linalg.norm(d, dim=-1, keepdim=True)
    vd = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return o, d, vd, z.contiguous(), dist.contiguous()


@pytest.mark.parametrize(
    "kw", [dict(netdepth=3, netwidth=128, skips=(1,), multires=4, multires_views=2), dict()], ids=["small", "flagship"]
)
@pytest.mark.parametrize("n_samples", [8, 64, 100, 192])
@pytest.mark.parametrize("white", [True, False])
def test_b3_fp32_matches_plain(dev, kw, n_samples, white):
    cfg = VanillaNeRFConfig(**kw)
    model = VanillaNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    packed = b3.pack_params(model.state_dict(), cfg, torch.float32)
    o, d, vd, z, dist = _rays(dev, 300, n_samples)
    ve = positional_encoding(vd, cfg.nf_views).contiguous()
    noise = torch.randn(z.shape, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    got = b3.render_pass(packed, o, d, ve, z, dist, noise, white)
    ref = b3.render_pass_plain(packed, o, d, ve, z, dist, noise, white)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.rgb, ref.rgb, atol=1e-4, rtol=0)
    torch.testing.assert_close(got.acc, ref.acc, atol=1e-4, rtol=0)
    torch.testing.assert_close(got.depth, ref.depth, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(got.weights, ref.weights, atol=1e-4, rtol=0)


@pytest.mark.parametrize("n_samples", [64, 192])
def test_b3_bf16_matches_plain(dev, n_samples):
    cfg = VanillaNeRFConfig()
    model = VanillaNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    packed = b3.pack_params(model.state_dict(), cfg, torch.bfloat16)
    o, d, vd, z, dist = _rays(dev, 512, n_samples)
    ve = positional_encoding(vd, cfg.nf_views).contiguous()
    before = launches[f"render_pass[S={n_samples}]"]
    got = b3.render_pass(packed, o, d, ve, z, dist, None, True)
    ref = b3.render_pass_plain(packed, o, d, ve, z, dist, None, True)
    torch.cuda.synchronize()
    assert launches[f"render_pass[S={n_samples}]"] == before + 1
    diff = (got.rgb - ref.rgb).abs()
    assert diff.max().item() <= 1e-2 and diff.mean().item() <= 1e-3


def test_b3_rejects_bad_inputs(dev):
    cfg = VanillaNeRFConfig(netdepth=3, netwidth=128, skips=(1,), multires=4, multires_views=2)
    model = VanillaNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    packed = b3.pack_params(model.state_dict(), cfg, torch.float32)
    o, d, vd, z, dist = _rays(dev, 16, 8)
    ve = positional_encoding(vd, cfg.nf_views).contiguous()
    with pytest.raises(ValueError):
        b3.render_pass(packed, o, d, ve, z.t().contiguous().t(), dist)
    with pytest.raises(ValueError):
        b3.render_pass(packed, o, d, ve[:, :-1].contiguous(), z, dist)
