"""The CUDA kernels B1, B2, B3 and B4 against their plain twins, on the card.

Marked ``cuda``; without a card every test skips. Run on a machine with an
H100 (the repo's conftest imports JAX, which that machine need not have):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances are those of chip_smoke.py: B2 bit-exact; B3 fp32 atol 1e-4 on
rgb/acc and rtol 1e-4 on depth; B3 bf16 max |drgb| <= 1e-2, mean <= 1e-3.
B1 fp32: the same output bars, sqerr rel 1e-4; each gradient tensor within
rel L2 (||d|| / ||g||) 1e-4 of the fp32 twin or, where the two disagree on
a ReLU mask (at D=8 a few pre-activations sit on fp32 ties, PERF.md), no
further from the float64 twin than twice the fp32 twin is;
B1 bf16: rgb max 1e-2, mean 1e-3, each gradient tensor rel L2 1e-2; two
launches give bit-equal gradients. The kernel step against the eager step:
loss rel 1e-5 and the same gradient bar against the float64 eager step.
B4 (T-NeRF, both modes) is held to the bars of B3 (forward) and B1 (train
mode); its colour ReLU can tie at a logit of 0 as B1's trunk ReLUs do, so
its fp32 gradients take the same float64 fallback.
"""

import dataclasses

import pytest
import torch

from swnerf_torch.models import TNeRF, TNeRFConfig, VanillaNeRF, VanillaNeRFConfig
from swnerf_torch.ops.embedding import positional_encoding
from swnerf_torch.ops.kernels import build, launches
from swnerf_torch.ops.kernels import render_loss as b1
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


def _b1_case(dev, kw, n, s, dtype, seed=0):
    cfg = VanillaNeRFConfig(**kw)
    model = VanillaNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(seed))
    packed = b3.pack_params(model.state_dict(), cfg, dtype)
    o, d, vd, z, dist = _rays(dev, n, s, seed)
    ve = positional_encoding(vd, cfg.nf_views).contiguous()
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    noise = torch.randn(z.shape, generator=g, device=dev)  # std 1: the sigma > 0 mask is exercised
    target = torch.rand((n, 3), generator=g, device=dev)
    return packed, (o, d, ve, z, dist, noise, target)


def _rel_l2(got, ref):
    """Per-tensor ||got - ref|| / ||ref|| over the unpacked gradients."""
    return {k: ((got[k].double().cpu() - ref[k].double().cpu()).norm() / ref[k].double().cpu().norm().clamp_min(1e-300))
            .item() for k in ref}


def _assert_fp32_grads(got, ref32, ref64):
    """rel L2 1e-4 against the fp32 reference, or (ReLU mask ties) no
    further from the float64 reference than twice the fp32 one."""
    r32, rk, rr = _rel_l2(got, ref32), _rel_l2(got, ref64), _rel_l2(ref32, ref64)
    bad = {k: (r32[k], rk[k], rr[k]) for k in rk if r32[k] > 1e-4 and rk[k] > 2.0 * rr[k]}
    assert not bad, bad


@pytest.mark.parametrize(
    "kw", [dict(netdepth=3, netwidth=128, skips=(1,), multires=4, multires_views=2), dict()], ids=["small", "flagship"]
)
@pytest.mark.parametrize("n_samples", [8, 64, 192])
@pytest.mark.parametrize("white", [True, False])
def test_b1_fp32_matches_plain(dev, kw, n_samples, white):
    packed, args = _b1_case(dev, kw, 300, n_samples, torch.float32)
    scale = 1.0 / (3 * 300)
    got, gg = b1.render_loss(packed, *args, white, scale)
    ref, gr = b1.render_loss_plain(packed, *args, white, scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.rgb, ref.rgb, atol=1e-4, rtol=0)
    torch.testing.assert_close(got.acc, ref.acc, atol=1e-4, rtol=0)
    torch.testing.assert_close(got.depth, ref.depth, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(got.weights, ref.weights, atol=1e-4, rtol=0)
    torch.testing.assert_close(got.sqerr, ref.sqerr, atol=1e-7, rtol=1e-4)
    p64 = dataclasses.replace(packed, weights=packed.weights.double())
    _, g64 = b1.render_loss_plain(p64, *(x.double() for x in args), white, scale)
    _assert_fp32_grads(b1.unpack_grads(gg, packed), b1.unpack_grads(gr, packed), b1.unpack_grads(g64, p64))


@pytest.mark.parametrize("n_samples", [64, 192])
def test_b1_bf16_matches_plain(dev, n_samples):
    packed, args = _b1_case(dev, {}, 1024, n_samples, torch.bfloat16)
    before = launches[f"render_loss[S={n_samples}]"]
    got, gg = b1.render_loss(packed, *args, True, 1.0 / 3072)
    ref, gr = b1.render_loss_plain(packed, *args, True, 1.0 / 3072)
    torch.cuda.synchronize()
    assert launches[f"render_loss[S={n_samples}]"] == before + 1
    diff = (got.rgb - ref.rgb).abs()
    assert diff.max().item() <= 1e-2 and diff.mean().item() <= 1e-3
    rel = _rel_l2(b1.unpack_grads(gg, packed), b1.unpack_grads(gr, packed))
    assert max(rel.values()) <= 1e-2, rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b1_gradients_are_deterministic(dev, dtype):
    packed, args = _b1_case(dev, {}, 1024, 192, dtype)
    _, (w1, b1_) = b1.render_loss(packed, *args, True, 1.0 / 3072)
    _, (w2, b2_) = b1.render_loss(packed, *args, True, 1.0 / 3072)
    torch.cuda.synchronize()
    assert torch.equal(w1, w2) and torch.equal(b1_, b2_)


def test_b1_rejects_bad_inputs(dev):
    packed, (o, d, ve, z, dist, noise, target) = _b1_case(
        dev, dict(netdepth=3, netwidth=128, skips=(1,), multires=4, multires_views=2), 16, 8, torch.float32
    )
    with pytest.raises(ValueError):
        b1.render_loss(packed, o, d, ve, z, dist, noise, target[:, :2].contiguous(), True, 1.0)
    with pytest.raises(ValueError):
        b1.render_loss(packed, o, d, ve, z.t().contiguous().t(), dist, noise, target, True, 1.0)


def test_kernel_step_matches_eager_step(dev):
    """One kernel train step (B1, B2; fp32 operands) against the eager
    autograd step from the same state and draws; the eager step in float64
    on the CPU is the gradient reference."""
    from swnerf_torch.render.core import Draws, Rays, RenderConfig, make_draws
    from swnerf_torch.train.fused_step import make_fused_train_step
    from swnerf_torch.train.loop import init_train_state, make_train_step

    cfg = VanillaNeRFConfig(netdepth=6, netwidth=128, skips=(4,), multires=10, multires_views=4)
    rcfg = RenderConfig(n_samples=32, n_importance=64, perturb=1.0, white_bkgd=True, raw_noise_std=1.0)
    o, d, vd, _, _ = _rays(dev, 256, 8)
    rays = Rays(o, d, vd, torch.full((256,), 2.0, device=dev), torch.full((256,), 6.0, device=dev))
    target = torch.rand((256, 3), generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    draws = make_draws(rcfg, 256, torch.Generator(device=dev).manual_seed(3), dev)

    def state(device, dtype=torch.float32):
        nets = [VanillaNeRF(cfg, device=device, generator=torch.Generator().manual_seed(s)).to(dtype) for s in (0, 1)]
        return init_train_state(*nets, 5e-4, 500)

    def grads(st):
        return {f"{n}.{k}": p.grad for n, m in (("c", st.coarse), ("f", st.fine)) for k, p in m.named_parameters()}

    sk, se, s64 = state(dev), state(dev), state("cpu", torch.float64)
    before = launches["render_loss[S=96]"]
    mk = make_fused_train_step(cfg, rcfg, fcfg=cfg, compute_dtype=torch.float32)(sk, rays, target, draws=draws)
    me = make_train_step(rcfg)(se, rays, target, draws=draws)
    cpu64 = lambda x: None if x is None else x.cpu().double()  # noqa: E731
    make_train_step(rcfg)(s64, Rays(*(cpu64(x) for x in rays)), cpu64(target), draws=Draws(*(cpu64(x) for x in draws)))
    torch.cuda.synchronize()
    assert launches["render_loss[S=96]"] == before + 1
    assert mk["total_loss"].item() == pytest.approx(me["total_loss"].item(), rel=1e-5)
    _assert_fp32_grads(grads(sk), grads(se), grads(s64))


# ---------------------------------------------------------------- B4 (T-NeRF)

TNERF_SMALL = dict(netdepth=4, net_dim=128, skip_layer=2, multires=4, multires_views=2)
TNERF_CASES = [TNERF_SMALL, dict(), dict(TNERF_SMALL, net_dim=256)]
TNERF_IDS = ["small", "full", "w256"]


def _b4_case(dev, kw, n, s, dtype, seed=0):
    cfg = TNeRFConfig(**kw)
    model = TNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(seed))
    packed = b3.pack_tnerf_params(model.state_dict(), cfg, dtype)
    o, d, vd, z, dist = _rays(dev, n, s, seed)
    ve = positional_encoding(vd, cfg.nf_views).contiguous()
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    noise = torch.randn(z.shape, generator=g, device=dev)
    target = torch.rand((n, 3), generator=g, device=dev)
    times = torch.rand((n,), generator=g, device=dev)
    return packed, (o, d, ve, z, dist, noise, target), times


@pytest.mark.parametrize("kw", TNERF_CASES, ids=TNERF_IDS)
@pytest.mark.parametrize("n_samples", [8, 64, 100])
@pytest.mark.parametrize("white", [True, False])
def test_b4_forward_fp32_matches_plain(dev, kw, n_samples, white):
    packed, (o, d, ve, z, dist, noise, _), times = _b4_case(dev, kw, 300, n_samples, torch.float32)
    got = b3.render_pass(packed, o, d, ve, z, dist, noise, white, times)
    ref = b3.render_pass_plain(packed, o, d, ve, z, dist, noise, white, times)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.rgb, ref.rgb, atol=1e-4, rtol=0)
    torch.testing.assert_close(got.acc, ref.acc, atol=1e-4, rtol=0)
    torch.testing.assert_close(got.depth, ref.depth, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(got.weights, ref.weights, atol=1e-4, rtol=0)


def test_b4_forward_bf16_matches_plain(dev):
    packed, (o, d, ve, z, dist, _, _), times = _b4_case(dev, {}, 4096, 64, torch.bfloat16)
    before = launches["render_pass[tnerf,S=64]"]
    got = b3.render_pass(packed, o, d, ve, z, dist, None, True, times)
    ref = b3.render_pass_plain(packed, o, d, ve, z, dist, None, True, times)
    torch.cuda.synchronize()
    assert launches["render_pass[tnerf,S=64]"] == before + 1
    diff = (got.rgb - ref.rgb).abs()
    assert diff.max().item() <= 1e-2 and diff.mean().item() <= 1e-3


@pytest.mark.parametrize("kw", TNERF_CASES, ids=TNERF_IDS)
@pytest.mark.parametrize("n_samples", [8, 64])
@pytest.mark.parametrize("white", [True, False])
def test_b4_train_fp32_matches_plain(dev, kw, n_samples, white):
    packed, args, times = _b4_case(dev, kw, 500, n_samples, torch.float32)
    scale = 1.0 / 1500
    got, gg = b1.render_loss(packed, *args, white, scale, times)
    ref, gr = b1.render_loss_plain(packed, *args, white, scale, times)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.rgb, ref.rgb, atol=1e-4, rtol=0)
    torch.testing.assert_close(got.acc, ref.acc, atol=1e-4, rtol=0)
    torch.testing.assert_close(got.depth, ref.depth, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(got.sqerr, ref.sqerr, atol=1e-7, rtol=1e-4)
    p64 = dataclasses.replace(packed, weights=packed.weights.double())
    _, g64 = b1.render_loss_plain(p64, *(x.double() for x in args), white, scale, times.double())
    _assert_fp32_grads(b1.unpack_tnerf_grads(gg, packed), b1.unpack_tnerf_grads(gr, packed),
                       b1.unpack_tnerf_grads(g64, p64))


def test_b4_train_bf16_matches_plain(dev):
    packed, args, times = _b4_case(dev, {}, 500, 64, torch.bfloat16)
    before = launches["render_loss[tnerf,S=64]"]
    got, gg = b1.render_loss(packed, *args, True, 1.0 / 1500, times)
    ref, gr = b1.render_loss_plain(packed, *args, True, 1.0 / 1500, times)
    torch.cuda.synchronize()
    assert launches["render_loss[tnerf,S=64]"] == before + 1
    diff = (got.rgb - ref.rgb).abs()
    assert diff.max().item() <= 1e-2 and diff.mean().item() <= 1e-3
    rel = _rel_l2(b1.unpack_tnerf_grads(gg, packed), b1.unpack_tnerf_grads(gr, packed))
    assert max(rel.values()) <= 1e-2, rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b4_gradients_are_deterministic(dev, dtype):
    packed, args, times = _b4_case(dev, {}, 500, 64, dtype)
    _, (w1, b1_) = b1.render_loss(packed, *args, True, 1.0 / 1500, times)
    _, (w2, b2_) = b1.render_loss(packed, *args, True, 1.0 / 1500, times)
    torch.cuda.synchronize()
    assert torch.equal(w1, w2) and torch.equal(b1_, b2_)


def test_b4_rejects_bad_times(dev):
    packed, (o, d, ve, z, dist, noise, target), times = _b4_case(dev, TNERF_SMALL, 16, 8, torch.float32)
    with pytest.raises(ValueError):
        b3.render_pass(packed, o, d, ve, z, dist, noise, True)
    with pytest.raises(ValueError):
        b1.render_loss(packed, o, d, ve, z, dist, noise, target, True, 1.0, times[:8].contiguous())
    vpacked, _ = _b1_case(dev, dict(netdepth=3, netwidth=128, skips=(1,), multires=4, multires_views=2), 16, 8,
                          torch.float32)
    with pytest.raises(ValueError):
        b3.render_pass(vpacked, o, d, ve, z, dist, noise, True, times)


def test_tnerf_kernel_step_matches_eager_step(dev):
    """One kernel T-NeRF train step (B4, fp32 operands) against the eager
    autograd step from the same state and draws; the eager step in float64
    on the CPU is the gradient reference."""
    from swnerf_torch.render.core import Draws, Rays, RenderConfig, make_draws
    from swnerf_torch.train.fused_step import make_fused_tnerf_step
    from swnerf_torch.train.loop import init_train_state, make_train_step

    cfg = TNeRFConfig()
    rcfg = RenderConfig(n_samples=64, perturb=1.0, white_bkgd=True, raw_noise_std=1.0)
    o, d, vd, _, _ = _rays(dev, 500, 8)
    g = torch.Generator(device=dev).manual_seed(2)
    times = torch.rand((500, 1), generator=g, device=dev)
    rays = Rays(o, d, vd, torch.full((500,), 2.0, device=dev), torch.full((500,), 6.0, device=dev), times)
    target = torch.rand((500, 3), generator=g, device=dev)
    draws = make_draws(rcfg, 500, torch.Generator(device=dev).manual_seed(3), dev)

    def state(device, dtype=torch.float32):
        net = TNeRF(cfg, device=device, generator=torch.Generator().manual_seed(0)).to(dtype)
        return init_train_state(net, None, 5e-4, 500)

    def grads(st):
        return {k: p.grad for k, p in st.coarse.named_parameters()}

    sk, se, s64 = state(dev), state(dev), state("cpu", torch.float64)
    before = launches["render_loss[tnerf,S=64]"]
    mk = make_fused_tnerf_step(cfg, rcfg, compute_dtype=torch.float32)(sk, rays, target, draws=draws)
    me = make_train_step(rcfg)(se, rays, target, draws=draws)
    cpu64 = lambda x: None if x is None else x.cpu().double()  # noqa: E731
    make_train_step(rcfg)(s64, Rays(*(cpu64(x) for x in rays)), cpu64(target), draws=Draws(*(cpu64(x) for x in draws)))
    torch.cuda.synchronize()
    assert launches["render_loss[tnerf,S=64]"] == before + 1
    assert mk["total_loss"].item() == pytest.approx(me["total_loss"].item(), rel=1e-5)
    _assert_fp32_grads(grads(sk), grads(se), grads(s64))
