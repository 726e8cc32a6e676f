"""The CUDA kernels B1-B11 against their plain twins, on the card.

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
D-NeRF: B6 (the deformation MLP) fp32 dx atol 1e-5; its fp32 gradients at
B1's bar, where the float64 fallback also admits the distance that a
perturbation of fp32 size moves the float64 reference (its ReLUs tie
often: _assert_fp32_grads); bf16 dx max 1e-2, gradients rel L2 1e-2;
bit-equal repeats. B3's pts mode at B3's bars; B5 at B6's, its dpts
[N, S, 3] counted among the gradients. The kernel D-NeRF step against the
eager step: loss rel 1e-5 (or as close to the float64 eager step as the
fallback allows) and B6's gradient bar.
MultiRes: B7 (the field trunk on embedded inputs) and the widened B6 at each
level's widths, fp32 at B6's bars (raw atol 1e-4, rtol 1e-4; B7's gradients
and demb at the fallback bar), bf16 within 1e-2 of the bf16 twins (raw
relative to its largest value; gradients rel L2), bit-equal repeats; the
D-NeRF field's kernel route and a MultiRes phase-2 step against the plain
route (fp32, the float64 plain route on the CPU as the fallback's
reference), with small deformation heads so that level 0's 2^19 encoding
stays well conditioned (tests/test_torch_multires.py); ``NeRFOriginal``'s
kernel route (B7 alone) against its plain route, fp32 and the default bf16.
B7's and B8's bf16 forward-only launches (the tensor cores) at both pads,
W 128 and 256, from one row to a 204,800-row mesh tile: raw within 1e-2
(max) and 1e-3 (mean) of the twin's largest value, bit-equal repeats; they
sum in another order than the train-mode launch, so the fields' no-grad
forwards are held to that bar, not to the autograd forward bit for bit.
B7''s the same (ELU in the epilogues, raw rgb clipped at 0) at its 96 / 64-
and 128 / 128-column tiles, W 128 and 256, one to 32,000 rows; its bf16
train mode (the tensor cores at W=128, SIMT at W=256) and its backward on
the tensor cores from one row to 32,000: raw at the bf16 bar, the colour
masks the twin's on all but 1e-3, the tape's embeddings and pads, the
gradients, demb and dvemb rel L2 1e-2 of the CPU twin on the kernel
forward's colour mask, bit-equal repeats.
MultiRes on the render kernels: B3's pts mode on the wide pack at B3's bars
(up to its shared-memory bound S = 256, past which it refuses); B9 at B6's
bars with its recomputed forward bit-equal to the B3 launch, bf16 rel L2
1e-2 and bit-equal repeats; the fused phase-2 step against the plain
route's at the phase-2 bars. B10 bit-equal to B2 + torch.sort and to its
twin (sorted and unsorted uniforms and depths, ragged shapes, a broadcast
row of uniforms); B11 (fused_time_net_pts with input grads) at B6's bars,
dx bit-equal to B6's forward; in bf16 at both of its pads.
The reverse sweep's products on the tensor cores (csrc/tc_gemm.cuh: bf16 B1,
B4, B5 and B9, B6's backward, B11's and B7's with demb) are
held by the bf16 bars above, at the T-NeRF, D-NeRF and every MultiRes
level's widths, and at ragged shapes (rows not a multiple of 128, live
input columns not a multiple of 64): gradients (and demb, d pts) rel L2
1e-2 of the twin, bit-equal repeats. The input cotangent's product alone
(tc_demb, 64- and 128-column pads) against the SIMT product it replaced:
within 2^-15 of the sum of the absolute products (and of the added-to
value), the columns past the live ones untouched, bit-equal repeats. B4's bf16 forward on the tensor cores
(csrc/tc_render.cuh with the T-NeRF traits) at B3's bf16 bars at ragged
shapes and W 128 / 256, its rgb at a PSNR of 40 dB or more against the
fp32 route's render. B1's and B4's bf16 train-mode forward on the tensor
cores (render_loss_tc_kernel): rgb, acc, depth and the weights bit-equal
to the bf16 render_pass launch, bit-equal repeats, gradients rel L2 1e-2
of the twin, at S = 64 and 192 and ragged rows. The
MultiRes pyramid's resize: its forward bit-equal to F.interpolate's and its
fixed-order backward bit-equal across launches at phase 2's sizes. K steps
per dispatch: the K-step route's CUDA-graph replays bit-equal to
uncaptured one-step dispatches for every training step (the kernel steps,
the eager steps, the fp32 warm step, the plain D-NeRF step), the device
learning rate equal to the schedule in fp32, launches counted per replay,
a checkpoint's Adam state moved onto the card.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from swnerf_torch.models import DirectTemporalNeRF, DNeRFConfig, TNeRF, TNeRFConfig, VanillaNeRF, VanillaNeRFConfig
from swnerf_torch.ops.embedding import positional_encoding
from swnerf_torch.ops.kernels import build, launches
from swnerf_torch.ops.kernels import render_loss as b1
from swnerf_torch.ops.kernels import render_pass as b3
from swnerf_torch.ops.kernels import sample_pdf as b2
from swnerf_torch.ops.kernels import time_net as b6
from swnerf_torch.ops.kernels import trunk as b7
from swnerf_torch.ops.kernels.render_pass import field_mlp
from swnerf_torch.render.fused_eval import canonical_params

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


B2_CASES = {  # n rays, m bins, s samples
    "det": (4099, 63, 128), "random": (4099, 63, 128), "sorted": (20000, 63, 128), "ragged": (19237, 47, 100),
    "broadcast_u": (20000, 63, 128), "step_1024": (1024, 63, 128), "step_500": (500, 63, 128),
    "one_weight": (4099, 2, 128), "m1024": (3000, 1024, 256), "one_sample": (4099, 63, 1),
    "inf_nan": (4099, 63, 128),
}


def _same_bits(a, b):
    """Bit-equal, NaN equal to NaN."""
    return a.shape == b.shape and bool(((a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())).all())


@pytest.mark.parametrize("mode", list(B2_CASES))
def test_b2_bit_exact(dev, mode):
    """B2 bit-equal to its twin, one launch, and again bit for bit on a
    second call: linspace u (row stride 0), random and sorted u, a ragged
    shape (N = 19,237, not a multiple of a block's rays; 47 bins; S = 100,
    not a multiple of a lane's batch), one row of random u broadcast with
    row stride 0, the training steps' 1,024 and 500 rays (two rays a warp),
    one weight (M = 2), M = 1024 (two rays a warp, past 48 KB of shared
    memory), S = 1, and rows with a +inf and a NaN weight (NaN where the
    twin is NaN). The weights are strided (row stride M + 1, as the
    callers slice them); a third of the rays have zero weights past column
    5 (the denom < 1e-5 guard)."""
    n, m, s = B2_CASES[mode]
    bins, w, u = _pdf_inputs(dev, n, m, s)
    if mode == "det":
        u = torch.linspace(0, 1, s, device=dev).expand(n, s)
    elif mode == "sorted":
        u = torch.sort(u, -1).values
    elif mode == "broadcast_u":
        u = u[:1].expand(n, s)
    elif mode == "inf_nan":
        w[0, m // 2] = float("inf")
        w[1, m // 2] = float("nan")
    assert w.stride(0) == m + 1 and u.stride(0) == (0 if mode in ("det", "broadcast_u") else s)
    before = launches["sample_pdf"]
    got = b2.sample_pdf(bins, w, u)
    assert launches["sample_pdf"] == before + 1
    again = b2.sample_pdf(bins, w, u)
    torch.cuda.synchronize()
    ref = b2.sample_pdf_plain(bins, w, u)
    assert _same_bits(got, ref) and _same_bits(again, got)
    assert bool(got[:2].isnan().any()) if mode == "inf_nan" else not bool(got.isnan().any())


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
    model = VanillaNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(0), fused=False)
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
    model = VanillaNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(0), fused=False)
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
    model = VanillaNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(0), fused=False)
    packed = b3.pack_params(model.state_dict(), cfg, torch.float32)
    o, d, vd, z, dist = _rays(dev, 16, 8)
    ve = positional_encoding(vd, cfg.nf_views).contiguous()
    with pytest.raises(ValueError):
        b3.render_pass(packed, o, d, ve, z.t().contiguous().t(), dist)
    with pytest.raises(ValueError):
        b3.render_pass(packed, o, d, ve[:, :-1].contiguous(), z, dist)


def _b1_case(dev, kw, n, s, dtype, seed=0):
    cfg = VanillaNeRFConfig(**kw)
    model = VanillaNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(seed), fused=False)
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


def _assert_fp32_grads(got, ref32, ref64, ref64p=None):
    """rel L2 1e-4 against the fp32 reference, or (ReLU mask ties) no
    further from the float64 reference than twice the fp32 one. With
    ``ref64p``, the float64 reference on _jitter-ed weights, the fallback
    also admits twice the distance that perturbation of fp32 size moves the
    float64 reference: the D-NeRF deformation MLP's ReLUs tie often enough
    at D=8 that any two fp32 summation orders land ~1e-3 apart (ROADMAP.md
    Queue C)."""
    r32, rk, rr = _rel_l2(got, ref32), _rel_l2(got, ref64), _rel_l2(ref32, ref64)
    rp = _rel_l2(ref64p, ref64) if ref64p is not None else dict.fromkeys(rr, 0.0)
    bad = {k: (r32[k], rk[k], rr[k], rp[k]) for k in rk if r32[k] > 1e-4 and rk[k] > 2.0 * max(rr[k], rp[k])}
    assert not bad, bad


@pytest.mark.parametrize(
    "kw", [dict(netdepth=3, netwidth=128, skips=(1,), multires=4, multires_views=2), dict()], ids=["small", "flagship"]
)
@pytest.mark.parametrize("n_samples", [7, 8, 64, 192])  # 7: rays x samples per block not a multiple of 4
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
        nets = [VanillaNeRF(cfg, device=device, generator=torch.Generator().manual_seed(s), fused=False).to(dtype)
                for s in (0, 1)]
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
    model = TNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(seed), fused=False)
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


@pytest.mark.parametrize("kw", TNERF_CASES, ids=TNERF_IDS)
@pytest.mark.parametrize("n,s", [(37, 7), (300, 64), (41, 100)], ids=["259rows", "19200rows", "4100rows"])
@pytest.mark.parametrize("white", [True, False])
def test_b4_tc_forward_bf16_matches_plain(dev, kw, n, s, white):
    """bf16 B4 on the tensor cores (tc_render.cuh, T-NeRF traits) at rows
    that fill no 128-row chunk or 1,024-row unit, W 128 and 256: B3's bf16
    bars against the bf16 twin, bit-equal repeats, and its rgb within a
    PSNR of 40 dB of the fp32 route's render (a broken kernel lands near
    10 dB; bf16 rounding near 60)."""
    packed, (o, d, ve, z, dist, noise, _), times = _b4_case(dev, kw, n, s, torch.bfloat16)
    p32, _, _ = _b4_case(dev, kw, n, s, torch.float32)
    before = launches[f"render_pass[tnerf,S={s}]"]
    got = b3.render_pass(packed, o, d, ve, z, dist, noise, white, times)
    again = b3.render_pass(packed, o, d, ve, z, dist, noise, white, times)
    ref = b3.render_pass_plain(packed, o, d, ve, z, dist, noise, white, times)
    f32 = b3.render_pass(p32, o, d, ve, z, dist, noise, white, times)
    torch.cuda.synchronize()
    assert launches[f"render_pass[tnerf,S={s}]"] == before + 3
    diff = (got.rgb - ref.rgb).abs()
    assert diff.max().item() <= 1e-2 and diff.mean().item() <= 1e-3, (diff.max().item(), diff.mean().item())
    assert torch.equal(got.rgb, again.rgb) and torch.equal(got.weights, again.weights)

    def psnr(x):
        return -10.0 * torch.log10(((x.rgb - f32.rgb) ** 2).mean().clamp_min(1e-20)).item()

    assert psnr(got) >= 40.0, (psnr(got), psnr(ref))


@pytest.mark.parametrize("kw", TNERF_CASES, ids=TNERF_IDS)
def test_b4_train_bf16_tc_sweep_matches_plain_and_repeats(dev, kw):
    """bf16 B4's reverse sweep on the tensor cores (ELU' in the dH epilogue,
    the 96-column embedding spill): gradients rel L2 1e-2 of the twin,
    bit-equal repeats, at W 128 and 256."""
    packed, args, times = _b4_case(dev, kw, 300, 64, torch.bfloat16, seed=3)
    _, g1 = b1.render_loss(packed, *args, True, 1.0 / 900, times)
    _, g2 = b1.render_loss(packed, *args, True, 1.0 / 900, times)
    _, gr = b1.render_loss_plain(packed, *args, True, 1.0 / 900, times)
    torch.cuda.synchronize()
    rel = _rel_l2(b1.unpack_tnerf_grads(g1, packed), b1.unpack_tnerf_grads(gr, packed))
    assert max(rel.values()) <= 1e-2, rel
    assert torch.equal(g1[0], g2[0]) and torch.equal(g1[1], g2[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b4_gradients_are_deterministic(dev, dtype):
    packed, args, times = _b4_case(dev, {}, 500, 64, dtype)
    _, (w1, b1_) = b1.render_loss(packed, *args, True, 1.0 / 1500, times)
    _, (w2, b2_) = b1.render_loss(packed, *args, True, 1.0 / 1500, times)
    torch.cuda.synchronize()
    assert torch.equal(w1, w2) and torch.equal(b1_, b2_)


TRAIN_TC_CASES = [
    ("b1", {}, 1024, 64),  # the coarse pass
    ("b1", {}, 512, 192),  # the fine pass
    ("b1", {}, 37, 7),  # 259 rows: no whole 128-row chunk, 18 rays per unit
    ("b1", dict(netdepth=3, netwidth=128, skips=(1,), multires=4, multires_views=2), 3, 43),  # W 128: 129 rows
    ("b4", {}, 500, 64),
    ("b4", {}, 200, 192),
    ("b4", {}, 37, 7),
    ("b4", TNERF_SMALL, 3, 43),  # 129 rows, 36 input columns (the T-NeRF at W=256 keeps the SIMT forward)
]


@pytest.mark.parametrize("kernel, kw, n, s", TRAIN_TC_CASES,
                         ids=["b1-S64", "b1-S192", "b1-259rows", "b1-w128-129rows", "b4-S64", "b4-S192",
                              "b4-259rows", "b4-small-129rows"])
def test_train_tc_forward_equals_the_render_pass_and_repeats(dev, kernel, kw, n, s):
    """bf16 B1 / B4 in train mode, whose forward runs on the tensor cores
    (csrc/tc_render.cuh::render_loss_tc_kernel): rgb, acc, depth and the
    weights equal the bf16 tensor-core render_pass launch on the same inputs
    (noise std 1) bit for bit, sqerr is the squared error of that rgb, two
    launches give bit-equal outputs and gradients, and the gradients lie
    within rel L2 1e-2 of the bf16 twin's."""
    if kernel == "b1":
        packed, args = _b1_case(dev, kw, n, s, torch.bfloat16)
        times, unpack = None, b1.unpack_grads
    else:
        packed, args, times = _b4_case(dev, kw, n, s, torch.bfloat16)
        unpack = b1.unpack_tnerf_grads
    o, d, ve, z, dist, noise, target = args
    scale = 1.0 / (3 * n)
    key = b3.launch_key("render_loss", packed, s)
    before = launches[key]
    got, g1 = b1.render_loss(packed, *args, True, scale, times)
    again, g2 = b1.render_loss(packed, *args, True, scale, times)
    fwd = b3.render_pass(packed, o, d, ve, z, dist, noise, True, times)
    _, gr = b1.render_loss_plain(packed, *args, True, scale, times)
    torch.cuda.synchronize()
    assert launches[key] == before + 2
    for name in ("rgb", "acc", "depth", "weights"):
        assert torch.equal(getattr(got, name), getattr(fwd, name)), name
    for name in b1.RenderLossOutput._fields:
        assert torch.equal(getattr(got, name), getattr(again, name)), name
    torch.testing.assert_close(got.sqerr, ((got.rgb - target) ** 2).sum(-1), rtol=1e-6, atol=0)
    assert torch.equal(g1[0], g2[0]) and torch.equal(g1[1], g2[1])
    rel = _rel_l2(unpack(g1, packed), unpack(gr, packed))
    assert max(rel.values()) <= 1e-2, rel


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
        net = TNeRF(cfg, device=device, generator=torch.Generator().manual_seed(0), fused=False).to(dtype)
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


# ---------------------------------------------------------------- D-NeRF: B6, B3's pts mode, B5

DNERF_SMALL = dict(netdepth=4, netwidth=128, skips=(2,), multires=4, multires_views=2)
DNERF_CASES = [DNERF_SMALL, dict()]
DNERF_IDS = ["small", "full"]


def _dnerf_case(dev, kw, n, s, seed=0):
    """A D-NeRF field with seeded weights and deformed sample positions
    pts = o + d*z + a small offset, per-ray times (a quarter at 0), view
    embeddings, noise std 1 and targets."""
    cfg = DNeRFConfig(**kw)
    model = DirectTemporalNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(seed))
    o, d, vd, z, dist = _rays(dev, n, s, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]
           + 0.05 * torch.randn((n, s, 3), generator=g, device=dev)).contiguous()
    times = torch.rand((n,), generator=g, device=dev)
    times[: n // 4] = 0.0
    ve = positional_encoding(vd, cfg.nf_views).contiguous()
    noise = torch.randn(z.shape, generator=g, device=dev)
    target = torch.rand((n, 3), generator=g, device=dev)
    return cfg, model.state_dict(), pts, times, (ve, z, dist, noise, target)


def _time_grads(grads, packed):
    return b6.unpack_time_grads(grads, packed)


def _jitter(w, seed=0):
    """w * (1 + 2^-20 N(0, 1)): a perturbation of the size of the rounding
    that an fp32 dot product of length 256 accumulates (2^-24 sqrt(256))."""
    g = torch.Generator(device=w.device).manual_seed(seed)
    return w * (1 + 2.0**-20 * torch.randn(w.shape, generator=g, device=w.device, dtype=w.dtype))


@pytest.mark.parametrize("kw", DNERF_CASES, ids=DNERF_IDS)
@pytest.mark.parametrize("n_samples", [8, 64, 192])
def test_b6_fp32_matches_plain(dev, kw, n_samples):
    cfg, sd, pts, times, _ = _dnerf_case(dev, kw, 300, n_samples)
    packed = b6.pack_time_params(sd, cfg, torch.float32)
    g = torch.randn(pts.shape, generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    before = launches["time_net"]
    dx, grads = b6.time_net_fwd_bwd(packed, pts, times, g)
    torch.cuda.synchronize()
    assert launches["time_net"] == before + 1
    torch.testing.assert_close(dx, b6.time_net_plain(packed, pts, times), atol=1e-5, rtol=0)
    torch.testing.assert_close(b6.time_net(packed, pts, times), dx, atol=0, rtol=0)
    ref = b6.time_net_plain_bwd(packed, pts, times, g)
    p64 = dataclasses.replace(packed, weights=packed.weights.double())
    ref64 = b6.time_net_plain_bwd(p64, pts.double(), times.double(), g.double())
    p64p = dataclasses.replace(p64, weights=_jitter(p64.weights))
    ref64p = b6.time_net_plain_bwd(p64p, pts.double(), times.double(), g.double())
    _assert_fp32_grads(_time_grads(grads, packed), _time_grads(ref, packed), _time_grads(ref64, p64),
                            _time_grads(ref64p, p64))


@pytest.mark.parametrize("n_samples", [64, 192])
def test_b6_bf16_matches_plain_and_repeats(dev, n_samples):
    cfg, sd, pts, times, _ = _dnerf_case(dev, {}, 500, n_samples)
    packed = b6.pack_time_params(sd, cfg, torch.bfloat16)
    g = torch.randn(pts.shape, generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    before = launches["time_net[bwd]"]
    dx, (w1, b1_) = b6.time_net_fwd_bwd(packed, pts, times, g)
    assert launches["time_net[bwd]"] == before + 1
    _, (w2, b2_) = b6.time_net_fwd_bwd(packed, pts, times, g)
    ref = b6.time_net_plain_bwd(packed, pts, times, g)
    torch.cuda.synchronize()
    assert (dx - b6.time_net_plain(packed, pts, times)).abs().max().item() <= 1e-2
    rel = _rel_l2(_time_grads((w1, b1_), packed), _time_grads(ref, packed))
    assert max(rel.values()) <= 1e-2, rel
    assert torch.equal(w1, w2) and torch.equal(b1_, b2_)


def test_b6_autograd_function_on_the_card(dev):
    """time_net_autograd launches B6 forward (with its scratch) and backward
    and hands the kernel's gradients to the parameters."""
    cfg = DNeRFConfig(**DNERF_SMALL)
    model = DirectTemporalNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(3))
    params = dict(model.named_parameters())
    _, _, pts, times, _ = _dnerf_case(dev, DNERF_SMALL, 64, 16)
    g = torch.randn(pts.shape, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    before = launches["time_net[bwd]"]
    dx = b6.time_net_autograd(b6.pack_time_params(params, cfg, torch.float32), torch.float32, pts, times)
    (dx * g).sum().backward()
    torch.cuda.synchronize()
    assert launches["time_net[bwd]"] == before + 1
    detached = b6.pack_time_params(model.state_dict(), cfg, torch.float32)
    dx2, grads = b6.time_net_fwd_bwd(detached, pts, times, g)
    assert torch.equal(dx.detach(), dx2)
    for k, v in b6.unpack_time_grads(grads, detached).items():
        assert torch.equal(params[k].grad, v), k


@pytest.mark.parametrize("kw", DNERF_CASES, ids=DNERF_IDS)
@pytest.mark.parametrize("n_samples", [8, 64, 192])
@pytest.mark.parametrize("white", [True, False])
def test_b3_pts_fp32_matches_plain(dev, kw, n_samples, white):
    cfg, sd, pts, _, (ve, z, dist, noise, _) = _dnerf_case(dev, kw, 300, n_samples)
    packed = b3.pack_params(canonical_params(sd), cfg, torch.float32)
    before = launches[f"render_pass[pts,S={n_samples}]"]
    got = b3.render_pass(packed, None, None, ve, z, dist, noise, white, None, pts)
    ref = b3.render_pass_plain(packed, None, None, ve, z, dist, noise, white, None, pts)
    torch.cuda.synchronize()
    assert launches[f"render_pass[pts,S={n_samples}]"] == before + 1
    torch.testing.assert_close(got.rgb, ref.rgb, atol=1e-4, rtol=0)
    torch.testing.assert_close(got.acc, ref.acc, atol=1e-4, rtol=0)
    torch.testing.assert_close(got.depth, ref.depth, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(got.weights, ref.weights, atol=1e-4, rtol=0)


@pytest.mark.parametrize("n_samples", [64, 192])
def test_b3_pts_bf16_matches_plain(dev, n_samples):
    cfg, sd, pts, _, (ve, z, dist, _, _) = _dnerf_case(dev, {}, 512, n_samples)
    packed = b3.pack_params(canonical_params(sd), cfg, torch.bfloat16)
    got = b3.render_pass(packed, None, None, ve, z, dist, None, True, None, pts)
    ref = b3.render_pass_plain(packed, None, None, ve, z, dist, None, True, None, pts)
    torch.cuda.synchronize()
    diff = (got.rgb - ref.rgb).abs()
    assert diff.max().item() <= 1e-2 and diff.mean().item() <= 1e-3


def _b5_grads(grads, dpts, packed):
    return dict(b1.unpack_grads(grads, packed), dpts=dpts)


@pytest.mark.parametrize("kw", DNERF_CASES, ids=DNERF_IDS)
@pytest.mark.parametrize("n_samples", [8, 64, 192])
@pytest.mark.parametrize("white", [True, False])
def test_b5_fp32_matches_plain(dev, kw, n_samples, white):
    cfg, sd, pts, _, args = _dnerf_case(dev, kw, 300, n_samples)
    packed = b3.pack_params(canonical_params(sd), cfg, torch.float32)
    scale = 1.0 / (3 * 300)
    before = launches[f"render_loss[pts,S={n_samples}]"]
    got, gg, dp = b1.render_loss_pts(packed, pts, *args, white, scale)
    ref, gr, dr = b1.render_loss_pts_plain(packed, pts, *args, white, scale)
    torch.cuda.synchronize()
    assert launches[f"render_loss[pts,S={n_samples}]"] == before + 1
    torch.testing.assert_close(got.rgb, ref.rgb, atol=1e-4, rtol=0)
    torch.testing.assert_close(got.acc, ref.acc, atol=1e-4, rtol=0)
    torch.testing.assert_close(got.depth, ref.depth, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(got.weights, ref.weights, atol=1e-4, rtol=0)
    torch.testing.assert_close(got.sqerr, ref.sqerr, atol=1e-7, rtol=1e-4)
    p64 = dataclasses.replace(packed, weights=packed.weights.double())
    _, g64, d64 = b1.render_loss_pts_plain(p64, pts.double(), *(x.double() for x in args), white, scale)
    p64p = dataclasses.replace(p64, weights=_jitter(p64.weights))
    _, g64p, d64p = b1.render_loss_pts_plain(p64p, pts.double(), *(x.double() for x in args), white, scale)
    _assert_fp32_grads(_b5_grads(gg, dp, packed), _b5_grads(gr, dr, packed), _b5_grads(g64, d64, p64),
                            _b5_grads(g64p, d64p, p64))


@pytest.mark.parametrize("n_samples", [64, 192])
def test_b5_bf16_matches_plain_and_repeats(dev, n_samples):
    cfg, sd, pts, _, args = _dnerf_case(dev, {}, 500, n_samples)
    packed = b3.pack_params(canonical_params(sd), cfg, torch.bfloat16)
    got, gg, dp = b1.render_loss_pts(packed, pts, *args, True, 1.0 / 1500)
    _, gg2, dp2 = b1.render_loss_pts(packed, pts, *args, True, 1.0 / 1500)
    ref, gr, dr = b1.render_loss_pts_plain(packed, pts, *args, True, 1.0 / 1500)
    torch.cuda.synchronize()
    diff = (got.rgb - ref.rgb).abs()
    assert diff.max().item() <= 1e-2 and diff.mean().item() <= 1e-3
    rel = _rel_l2(_b5_grads(gg, dp, packed), _b5_grads(gr, dr, packed))
    assert max(rel.values()) <= 1e-2, rel
    assert torch.equal(gg[0], gg2[0]) and torch.equal(gg[1], gg2[1]) and torch.equal(dp, dp2)


def test_b5_b6_reject_bad_inputs(dev):
    cfg, sd, pts, times, (ve, z, dist, noise, target) = _dnerf_case(dev, DNERF_SMALL, 16, 8)
    packed = b3.pack_params(canonical_params(sd), cfg, torch.float32)
    with pytest.raises(ValueError):
        b1.render_loss_pts(packed, pts[:, :4].contiguous(), ve, z, dist, noise, target, True, 1.0)
    with pytest.raises(ValueError):
        b1.render_loss_pts(packed, pts.transpose(0, 1).contiguous().transpose(0, 1), ve, z, dist, noise, target,
                           True, 1.0)
    tn = b6.pack_time_params(sd, cfg, torch.float32)
    with pytest.raises(ValueError):
        b6.time_net(tn, pts, times[:8].contiguous())


def test_dnerf_kernel_step_matches_eager_step(dev):
    """One kernel D-NeRF train step (B6, B3's pts mode, B5, B2; fp32
    operands; shared model, TV on) against the eager autograd step from the
    same state and draws; the eager step in float64 on the CPU is the
    reference of the fallbacks."""
    from swnerf_torch.render.core import Draws, Rays, RenderConfig, make_draws
    from swnerf_torch.train.fused_step import make_fused_dnerf_step
    from swnerf_torch.train.loop import init_train_state, make_dnerf_train_step

    cfg = DNeRFConfig(netdepth=6, netwidth=128, skips=(4,), multires=10, multires_views=4)
    rcfg = RenderConfig(n_samples=32, n_importance=64, perturb=1.0, white_bkgd=True, raw_noise_std=1.0,
                        coarse_contributes=False)
    o, d, vd, _, _ = _rays(dev, 256, 8)
    g = torch.Generator(device=dev).manual_seed(2)
    times = torch.rand((256, 1), generator=g, device=dev)
    times[:64] = 0.0
    rays = Rays(o, d, vd, torch.full((256,), 2.0, device=dev), torch.full((256,), 6.0, device=dev), times)
    target = torch.rand((256, 3), generator=g, device=dev)
    draws = make_draws(rcfg, 256, torch.Generator(device=dev).manual_seed(3), dev)

    def state(device, dtype=torch.float32):  # the plain route: the eager step is the reference
        net = DirectTemporalNeRF(cfg, device=device, generator=torch.Generator().manual_seed(0), fused=False)
        return init_train_state(net.to(dtype), None, 5e-4, 500)

    def grads(st):
        return {k: p.grad for k, p in st.coarse.named_parameters()}

    sk, se, s64, s64p = state(dev), state(dev), state("cpu", torch.float64), state("cpu", torch.float64)
    with torch.no_grad():
        for p in s64p.coarse.parameters():
            p.copy_(_jitter(p))
    before = (launches["render_loss[pts,S=96]"], launches["time_net[bwd]"])
    mk = make_fused_dnerf_step(cfg, rcfg, add_tv_loss=True, tv_loss_weight=1e-2, compute_dtype=torch.float32)(
        sk, rays, target, 0.4, draws=draws)
    me = make_dnerf_train_step(rcfg, True, 1e-2)(se, rays, target, 0.4, draws=draws)
    cpu64 = lambda x: None if x is None else x.cpu().double()  # noqa: E731
    m64, m64p = (make_dnerf_train_step(rcfg, True, 1e-2)(st, Rays(*(cpu64(x) for x in rays)), cpu64(target), 0.4,
                                                          draws=Draws(*(cpu64(x) for x in draws))) for st in (s64, s64p))
    torch.cuda.synchronize()
    assert (launches["render_loss[pts,S=96]"], launches["time_net[bwd]"]) == (before[0] + 1, before[1] + 1)
    lk, le, l64, l64p = (m["total_loss"].item() for m in (mk, me, m64, m64p))
    assert abs(lk - le) <= 1e-5 * abs(le) or abs(lk - l64) <= 2 * max(abs(le - l64), abs(l64p - l64)), (lk, le, l64)
    _assert_fp32_grads(grads(sk), grads(se), grads(s64), grads(s64p))


# ---------------------------------------------------------------- MultiRes: B7 and the widened B6

DNERF_CKPT = Path(__file__).resolve().parents[1] / "benchmarks" / "round5_artifacts" / "full_dnerf_800k" / "800000.tar"
MR_BASE = dict(netdepth=8, netwidth=256, skips=(4,))
MR_LEVELS = {
    "level0": dict(MR_BASE, multires=20, multires_time=8, multires_views=20),
    "level1": dict(MR_BASE, multires=10, multires_time=4, multires_views=10),
    "identity": dict(MR_BASE, multires=-1, multires_time=-1, multires_views=-1, i_embed=-1),
}


def _b7_case(dev, level, n=300, s=16, seed=0):
    """A level's canonical trunk with seeded weights, its embedded positions
    and per-sample view embeddings (fp32, on the card) and a cotangent."""
    cfg = DNeRFConfig(**MR_LEVELS[level])
    model = DirectTemporalNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(seed))
    o, d, vd, z, _ = _rays(dev, n, s, seed)
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    emb = positional_encoding(pts, cfg.nf_pts).contiguous()
    vemb = positional_encoding(vd, cfg.nf_views)[:, None, :].expand(n, s, -1).reshape(n * s, -1).contiguous()
    g = torch.randn((n * s, 4), generator=torch.Generator(device=dev).manual_seed(seed + 1), device=dev)
    return cfg, model._occ.state_dict(), emb, vemb, g


def _b7_grads(grads, demb, packed):
    return dict(b7.unpack_trunk_grads(grads, packed), demb=demb)


@pytest.mark.parametrize("level", list(MR_LEVELS))
def test_b7_fp32_matches_plain(dev, level):
    cfg, sd, emb, vemb, g = _b7_case(dev, level)
    packed = b7.pack_trunk_params(sd, cfg, torch.float32)
    before = (launches["trunk"], launches["trunk[bwd]"])
    raw, grads, demb, _ = b7.trunk_fwd_bwd(packed, emb, vemb, g)
    torch.cuda.synchronize()
    assert (launches["trunk"], launches["trunk[bwd]"]) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(raw, b7.trunk_plain(packed, emb, vemb), atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(b7.trunk(packed, emb, vemb), raw, atol=0, rtol=0)
    ref, dref, _ = b7.trunk_plain_bwd(packed, emb, vemb, g)
    p64 = dataclasses.replace(packed, weights=packed.weights.double())
    g64, d64, _ = b7.trunk_plain_bwd(p64, emb.double(), vemb.double(), g.double())
    g64p, d64p, _ = b7.trunk_plain_bwd(dataclasses.replace(p64, weights=_jitter(p64.weights)), emb.double(),
                                       vemb.double(), g.double())
    _assert_fp32_grads(_b7_grads(grads, demb, packed), _b7_grads(ref, dref, packed), _b7_grads(g64, d64, p64),
                       _b7_grads(g64p, d64p, p64))


@pytest.mark.parametrize("level", ["level0", "level1", "identity"])
def test_b7_bf16_matches_plain_and_repeats(dev, level):
    cfg, sd, emb, vemb, g = _b7_case(dev, level, n=500, s=64)
    packed = b7.pack_trunk_params(sd, cfg, torch.bfloat16)
    raw, grads, demb, _ = b7.trunk_fwd_bwd(packed, emb, vemb, g)
    _, grads2, demb2, _ = b7.trunk_fwd_bwd(packed, emb, vemb, g)
    ref = b7.trunk_plain(packed, emb, vemb)
    gr, dr, _ = b7.trunk_plain_bwd(packed, emb, vemb, g)
    torch.cuda.synchronize()
    assert (raw - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()
    rel = _rel_l2(_b7_grads(grads, demb, packed), _b7_grads(gr, dr, packed))
    assert max(rel.values()) <= 1e-2, rel
    assert torch.equal(grads[0], grads2[0]) and torch.equal(grads[1], grads2[1]) and torch.equal(demb, demb2)


def test_b7_view_cotangent_and_autograd_on_the_card(dev):
    """dvemb when asked (fp32, against the twin), and trunk_autograd: B7's
    forward with its scratch and its backward hand the kernel's gradients
    and demb to the parameters and the embedding."""
    cfg, sd, emb, vemb, g = _b7_case(dev, "level1", n=64, s=8)
    packed = b7.pack_trunk_params(sd, cfg, torch.float32)
    _, _, _, dv = b7.trunk_fwd_bwd(packed, emb, vemb, g, need_demb=False, need_dvemb=True)
    _, _, dv_ref = b7.trunk_plain_bwd(packed, emb, vemb, g, need_demb=False, need_dvemb=True)
    torch.testing.assert_close(dv, dv_ref, atol=1e-5, rtol=1e-4)
    model = DirectTemporalNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    occ = dict(model._occ.named_parameters())
    e = emb.clone().requires_grad_(True)
    before = launches["trunk[bwd]"]
    raw = b7.trunk_autograd(b7.pack_trunk_params(occ, cfg, torch.float32), torch.float32, e, vemb)
    (raw * g).sum().backward()
    torch.cuda.synchronize()
    assert launches["trunk[bwd]"] == before + 1
    detached = b7.pack_trunk_params(model._occ.state_dict(), cfg, torch.float32)
    raw2, grads, demb, _ = b7.trunk_fwd_bwd(detached, emb, vemb, g)
    assert torch.equal(raw.detach(), raw2) and torch.equal(e.grad, demb)
    for k, v in b7.unpack_trunk_grads(grads, detached).items():
        assert torch.equal(occ[k].grad, v), k
    with pytest.raises(ValueError):
        b7.trunk(detached, emb[:, :5].contiguous(), vemb)


@pytest.mark.parametrize("level", list(MR_LEVELS))
def test_b6_level_widths_fp32_matches_plain(dev, level):
    cfg = DNeRFConfig(**MR_LEVELS[level])
    model = DirectTemporalNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(2))
    _, _, pts, times, _ = _dnerf_case(dev, DNERF_SMALL, 300, 16)
    packed = b6.pack_time_params(model.state_dict(), cfg, torch.float32)
    assert packed.cin_pad == (144 if level == "level0" else 96)
    g = torch.randn(pts.shape, generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    dx, grads = b6.time_net_fwd_bwd(packed, pts, times, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(dx, b6.time_net_plain(packed, pts, times), atol=1e-5, rtol=0)
    ref = b6.time_net_plain_bwd(packed, pts, times, g)
    p64 = dataclasses.replace(packed, weights=packed.weights.double())
    ref64 = b6.time_net_plain_bwd(p64, pts.double(), times.double(), g.double())
    ref64p = b6.time_net_plain_bwd(dataclasses.replace(p64, weights=_jitter(p64.weights)), pts.double(),
                                   times.double(), g.double())
    _assert_fp32_grads(*(_time_grads(x, packed) for x in (grads, ref, ref64, ref64p)))


@pytest.mark.parametrize("level", ["level0", "level1", "identity"])
def test_b6_level_widths_bf16_matches_plain_and_repeats(dev, level):
    cfg = DNeRFConfig(**MR_LEVELS[level])
    model = DirectTemporalNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(2))
    _, _, pts, times, _ = _dnerf_case(dev, DNERF_SMALL, 500, 64)
    packed = b6.pack_time_params(model.state_dict(), cfg, torch.bfloat16)
    g = torch.randn(pts.shape, generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    dx, (w1, b1_) = b6.time_net_fwd_bwd(packed, pts, times, g)
    _, (w2, b2_) = b6.time_net_fwd_bwd(packed, pts, times, g)
    ref = b6.time_net_plain_bwd(packed, pts, times, g)
    torch.cuda.synchronize()
    assert (dx - b6.time_net_plain(packed, pts, times)).abs().max().item() <= 1e-2
    rel = _rel_l2(_time_grads((w1, b1_), packed), _time_grads(ref, packed))
    assert max(rel.values()) <= 1e-2, rel
    assert torch.equal(w1, w2) and torch.equal(b1_, b2_)


SWEEP_RAGGED = [
    ("b1", dict(), 37, 7),  # 259 rows; 63 live input columns of 64
    ("b1", dict(netdepth=3, netwidth=128, skips=(1,), multires=4, multires_views=2), 3, 43),  # W 128: 129 rows
    ("b1", dict(), 5, 192),  # 960 rows: whole 64-row stages, not whole 128-row tiles
    ("b6", dict(MR_BASE, multires=20, multires_time=8, multires_views=20), 37, 7),  # 140 of 144 input rows
    ("b6", dict(MR_BASE, multires=20, multires_time=8, multires_views=20, netwidth=128), 3, 43),
    ("b6", dict(), 41, 13),  # D-NeRF: 84 of 96 input rows, 533 rows
    ("b6", dict(MR_BASE, multires=-1, multires_time=-1, multires_views=-1, i_embed=-1), 1, 1),  # one row, 4 columns
    ("b4", dict(), 37, 7),  # 259 rows; 84 live input columns of 96, 27 view columns of 32
    ("b4", dict(TNERF_SMALL, net_dim=256), 3, 43),  # W 256: 129 rows, 36 input columns
    ("b7", "level0", 37, 7),  # 259 rows; 123 live columns of 128: demb over them
    ("b7", "level1", 3, 43),  # 129 rows; 63 live columns
    ("b7", "identity", 1, 1),  # one row, 3 columns
    ("b5", dict(), 37, 7),  # 259 rows; 63 live input columns of 64: demb over them
    ("b5", DNERF_SMALL, 3, 7),  # W 128: 21 rows, 27 input columns
    ("b9", "level0", 37, 7),  # wide: 259 rows, 123 of 128 columns
    ("b9", "level1", 3, 7),  # wide: 21 rows, 63 of 128 columns
    ("b9", "identity", 19, 7),  # narrow: 133 rows, 3 of 64 columns
]


@pytest.mark.parametrize("kernel, kw, n, s", SWEEP_RAGGED,
                         ids=["b1-259rows", "b1-w128-129rows", "b1-960rows", "b6-level0-259rows",
                              "b6-level0-w128-129rows", "b6-dnerf-533rows", "b6-identity-1row", "b4-259rows",
                              "b4-w256-129rows", "b7-level0-259rows", "b7-level1-129rows", "b7-identity-1row",
                              "b5-259rows", "b5-w128-21rows", "b9-level0-259rows", "b9-level1-21rows",
                              "b9-identity-133rows"])
def test_tc_sweep_ragged_shapes(dev, kernel, kw, n, s):
    """The tensor-core sweep (csrc/tc_gemm.cuh) at row counts that fill no
    128-row tile or dW stage, and input widths that fill no 64-column atom:
    bf16 gradients (B7: and demb; B5, B9: and d pts) within rel L2 1e-2 of
    the twin, bit-equal repeats. B5, B9: a tensor whose twin, summed on the
    CPU, itself lies further than 5e-3 from the card's twin is held to
    twice that distance instead (b5-259rows' alpha bias: a sum of d sigma
    that cancels, whose bf16 rounding flips with the forward's fp32 order,
    so the twin on the CPU lands as far from the card's twin as the kernel
    does; both distances are printed)."""
    bar = {}
    if kernel in ("b5", "b9"):
        if kernel == "b5":
            cfg, sd, pts, _, args = _dnerf_case(dev, kw, n, s)
            packed = b3.pack_params(canonical_params(sd), cfg, torch.bfloat16)
            run, plain, rest = b1.render_loss_pts, b1.render_loss_pts_plain, (True, 1.0 / (3 * n))
        else:
            cfg, sd, pts, args, gct = _wide_case(dev, kw, n, s)
            packed = b3.pack_params(sd, cfg, torch.bfloat16)
            run, plain, rest = b1.render_loss_ext, b1.render_loss_ext_plain, (gct, True)
            assert packed.wide == (kw != "identity")
        _, g1, d1 = run(packed, pts, *args, *rest)
        _, g2, d2 = run(packed, pts, *args, *rest)
        _, gr, dr = plain(packed, pts, *args, *rest)
        rel = _rel_l2(_b5_grads(g1, d1, packed), _b5_grads(gr, dr, packed))
        assert torch.equal(d1, d2)
        pc = dataclasses.replace(packed, weights=packed.weights.cpu(), biases=packed.biases.cpu())
        cpu_rest = (x.cpu() if torch.is_tensor(x) else x for x in rest)
        _, gc, dc = plain(pc, pts.cpu(), *(x.cpu() for x in args), *cpu_rest)
        own = _rel_l2(_b5_grads(gc, dc, pc), _b5_grads(gr, dr, packed))
        bar = {k: 2 * v for k, v in own.items() if v > 5e-3}
        worst = max(rel, key=rel.get)
        print(f"{kernel} {n}x{s}: max rel L2 {rel[worst]:.3e} ({worst}; the CPU twin's {own[worst]:.3e}), "
              f"the CPU twin's max {max(own.values()):.3e}")
    elif kernel == "b4":
        packed, args, times = _b4_case(dev, kw, n, s, torch.bfloat16)
        _, g1 = b1.render_loss(packed, *args, True, 1.0 / (3 * n), times)
        _, g2 = b1.render_loss(packed, *args, True, 1.0 / (3 * n), times)
        _, gr = b1.render_loss_plain(packed, *args, True, 1.0 / (3 * n), times)
        rel = _rel_l2(b1.unpack_tnerf_grads(g1, packed), b1.unpack_tnerf_grads(gr, packed))
    elif kernel == "b7":
        cfg, sd, emb, vemb, g = _b7_case(dev, kw, n=n, s=s)
        packed = b7.pack_trunk_params(sd, cfg, torch.bfloat16)
        _, g1, d1, _ = b7.trunk_fwd_bwd(packed, emb, vemb, g)
        _, g2, d2, _ = b7.trunk_fwd_bwd(packed, emb, vemb, g)
        gr, dr, _ = b7.trunk_plain_bwd(packed, emb, vemb, g)
        rel = _rel_l2(_b7_grads(g1, d1, packed), _b7_grads(gr, dr, packed))
        assert torch.equal(d1, d2)
    elif kernel == "b1":
        packed, args = _b1_case(dev, kw, n, s, torch.bfloat16)
        _, g1 = b1.render_loss(packed, *args, True, 1.0 / (3 * n))
        _, g2 = b1.render_loss(packed, *args, True, 1.0 / (3 * n))
        _, gr = b1.render_loss_plain(packed, *args, True, 1.0 / (3 * n))
        rel = _rel_l2(b1.unpack_grads(g1, packed), b1.unpack_grads(gr, packed))
    else:
        cfg, sd, pts, times, _ = _dnerf_case(dev, kw, n, s)
        packed = b6.pack_time_params(sd, cfg, torch.bfloat16)
        g = torch.randn(pts.shape, generator=torch.Generator(device=dev).manual_seed(7), device=dev)
        _, g1 = b6.time_net_fwd_bwd(packed, pts, times, g)
        _, g2 = b6.time_net_fwd_bwd(packed, pts, times, g)
        rel = _rel_l2(_time_grads(g1, packed), _time_grads(b6.time_net_plain_bwd(packed, pts, times, g), packed))
    torch.cuda.synchronize()
    assert all(v <= bar.get(k, 1e-2) for k, v in rel.items()), (rel, bar)
    assert torch.equal(g1[0], g2[0]) and torch.equal(g1[1], g2[1])


def _demb_probe(tc, dz, w_emb, cin, out, add):
    """render_loss.cu::render_loss_demb_probe: out[:P * cin] (fp32 [P, cin])
    = (add: out +) dz w_emb^T over the live columns, on the tensor cores
    (tc) or on the SIMT product; returns the launcher's code."""
    import ctypes

    fn = build.load("render_loss").render_loss_demb_probe
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, i, i, i, ctypes.c_longlong, p, p, p, i, p]
    return fn(int(tc), dz.shape[1], w_emb.shape[0], cin, dz.shape[0], dz.data_ptr(), w_emb.data_ptr(),
              out.data_ptr(), int(add), torch.cuda.current_stream().cuda_stream)


@pytest.mark.parametrize("add", [False, True], ids=["store", "add"])
@pytest.mark.parametrize("rows", [1, 259, 8257])
@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("cin_pad,cin", [(64, 63), (128, 123)], ids=["pad64", "pad128"])
def test_tc_demb_matches_the_simt_product(dev, cin_pad, cin, width, rows, add):
    """The input cotangent's product on the tensor cores
    (gemm_common.cuh::tc_demb: the skip layer's store, layer 0's add) against
    the SIMT gemm_act it replaced, at row counts that fill no 128-row tile:
    within 2^-15 of the sum of the absolute products plus the added-to
    value (K = W deep: the tensor cores' k16 steps and the SIMT FMA chain
    each stay well inside it), a guard past the last row untouched,
    bit-equal repeats. The pad rows of the packed matrix are zero, as
    pack_params leaves them."""
    g = torch.Generator(device=dev).manual_seed(rows + width)
    dz = torch.randn((rows, width), generator=g, device=dev).bfloat16()
    w = torch.randn((cin_pad, width), generator=g, device=dev)
    w[cin:] = 0.0
    w = w.bfloat16().contiguous()
    n = rows * cin
    start = torch.randn(n + 64, generator=g, device=dev)
    start[n:] = 12345.0

    def run(tc):
        out = start.clone()
        assert _demb_probe(tc, dz, w, cin, out, add) == 0
        return out

    got, ref, again = run(True), run(False), run(True)
    torch.cuda.synchronize()
    assert torch.equal(got[n:], start[n:]) and torch.equal(ref[n:], start[n:])
    scale = (dz.float().abs() @ w.float().abs().t())[:, :cin].reshape(-1)
    if add:
        scale = scale + start[:n].abs()
    assert bool(((got[:n] - ref[:n]).abs() <= 2.0**-15 * scale).all()), (got[:n] - ref[:n]).abs().max().item()
    assert torch.equal(got, again)


def _mr_pair(dev, level, seed=0, head=1e-3):
    """The same level field on the kernel route (fp32 operands) and on the
    plain route, its deformation head scaled by ``head`` (small dx)."""
    cfg = DNeRFConfig(**MR_LEVELS[level])
    kern = DirectTemporalNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(seed),
                              compute_dtype=torch.float32)
    with torch.no_grad():
        kern._time_out.weight.mul_(head)
        kern._time_out.bias.mul_(head)
    plain = DirectTemporalNeRF(cfg, device=dev, fused=False)
    plain.load_state_dict(kern.state_dict())
    assert kern.fused_time and kern.fused_trunk and not plain.fused_time
    return kern, plain


@pytest.mark.parametrize("level", list(MR_LEVELS))
def test_dnerf_field_kernel_route_matches_plain_route(dev, level):
    """A level field's forward and backward on its kernel route (B6 and B7
    with fp32 operands, one launch each way) against the plain route on the
    same weights: raw and dx atol 1e-4 / 1e-5, gradients at the fallback
    bar (the plain route in float64 on the CPU as its reference); without
    autograd the route runs the forward-only launches. At level 0 the
    deformation head is zero (dx = 0 exactly, its gradients still formed):
    with any dx, x + dx rounds to a neighbouring fp32 value in a row or two
    of 3,200 depending on dx's last bit, and the 2^19 encoding turns that
    ulp (4.8e-7 near |x| = 4) into 0.25 rad (measured on an H100 at a head
    of 1e-3: 7 of 12,800 raw values off by up to 9.7e-3)."""
    kern, plain = _mr_pair(dev, level, head=0.0 if level == "level0" else 1e-3)
    o, d, vd, z, _ = _rays(dev, 200, 16, 3)
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).contiguous()
    t = torch.rand((200, 1), generator=torch.Generator(device=dev).manual_seed(4), device=dev)
    t[:50] = 0.0
    g = torch.randn((200, 16, 4), generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    names = ("time_net", "time_net[bwd]", "trunk", "trunk[bwd]")
    before = [launches[k] for k in names]
    raw, aux = kern(pts, vd, t)
    (raw * g).sum().backward()
    torch.cuda.synchronize()
    assert [launches[k] - b for k, b in zip(names, before)] == [1, 1, 1, 1]
    rp, ap = plain(pts, vd, t)
    (rp * g).sum().backward()
    p64 = DirectTemporalNeRF(kern.cfg, device="cpu", fused=False)
    p64.load_state_dict(kern.state_dict())
    p64 = p64.double()
    r64, _ = p64(pts.double().cpu(), vd.double().cpu(), t.double().cpu())
    (r64 * g.double().cpu()).sum().backward()
    torch.testing.assert_close(aux["dx"], ap["dx"], atol=1e-5, rtol=0)
    torch.testing.assert_close(raw, rp, atol=1e-4, rtol=1e-4)
    grads = {k: p.grad for k, p in kern.named_parameters()}
    _assert_fp32_grads(grads, {k: p.grad for k, p in plain.named_parameters()},
                       {k: p.grad for k, p in p64.named_parameters()})
    with torch.no_grad():
        before = [launches[k] for k in names]
        raw_nograd, _ = kern(pts, vd, t)
        torch.cuda.synchronize()
    assert [launches[k] - b for k, b in zip(names, before)] == [1, 0, 1, 0]
    assert torch.equal(raw_nograd, raw.detach())


@pytest.mark.parametrize("level", ["dnerf", "level0"])
@pytest.mark.parametrize("dtype", [torch.float32, None], ids=["fp32", "default_bf16"])
def test_nerf_original_kernel_route_matches_plain_route(dev, level, dtype):
    """``--nerf_type original`` on the card: ``NeRFOriginal(fused=None)``
    runs B7 without input gradients (bf16 operands by default, fp32 as the
    parity mode), one launch each way, the forward-only launch without
    autograd. Against ``fused=False`` on the same weights: fp32 raw atol /
    rtol 1e-4 and gradients at the fallback bar (the float64 plain route on
    the CPU); bf16 raw within 1e-2 of its largest value and gradients rel L2
    1e-2 of B7's bf16 twin. The no-grad forward: fp32 bit-equal to the
    autograd forward; bf16 (B7 on the tensor cores, whose sum order differs
    from the train-mode launch's) within 1e-2 of the twin's largest value
    and bit-equal to a second no-grad call. A no-grad render of 256 rays, 32 samples: fp32
    rgb atol 1e-4; bf16 against the fp32 plain route max |drgb| 2e-2, mean
    2e-3 (phase 24's bf16 bar, five of bf16's unit roundoffs, on rgb). The
    D-NeRF configuration renders with the canonical weights of the round-5
    800000.tar: on seeded weights its raw values reach the hundreds, where
    bf16's relative rounding moves a colour logit by O(1) (one pixel 0.64
    apart on an H100)."""
    from swnerf_torch.models.dnerf import NeRFOriginal, make_dnerf_model
    from swnerf_torch.render.core import RenderConfig, make_rays_from_camera, render_image
    from swnerf_torch.train.checkpoint import dnerf_state_dict, load_tar

    cfg = DNeRFConfig(**({} if level == "dnerf" else MR_LEVELS[level]))
    assert make_dnerf_model("original", cfg, dev).fused  # the trainers' model: the kernel route by default
    kern = NeRFOriginal(cfg, dev, torch.Generator().manual_seed(3), compute_dtype=dtype)
    if level == "dnerf":
        sd = dnerf_state_dict(load_tar(str(DNERF_CKPT))["network_fn_state_dict"])
        kern.load_state_dict({k[len("_occ."):]: v for k, v in sd.items() if k.startswith("_occ.")})
    plain = make_dnerf_model("original", cfg, dev, fused=False)
    plain.load_state_dict(kern.state_dict())
    assert kern.fused and not plain.fused
    o, d, vd, z, _ = _rays(dev, 200, 16, 3)
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).contiguous()
    t = torch.full((200, 1), 0.5, device=dev)
    g = torch.randn((200, 16, 4), generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    names = ("trunk", "trunk[bwd]")
    before = [launches[k] for k in names]
    raw, aux = kern(pts, vd, t)
    (raw * g).sum().backward()
    torch.cuda.synchronize()
    assert [launches[k] - b for k, b in zip(names, before)] == [1, 1]
    assert torch.equal(aux["dx"], torch.zeros_like(pts))
    rp, _ = plain(pts, vd, t)
    (rp * g).sum().backward()
    grads = {k: p.grad for k, p in kern.named_parameters()}
    if dtype == torch.float32:
        p64 = make_dnerf_model("original", cfg, "cpu", fused=False)
        p64.load_state_dict(kern.state_dict())
        p64 = p64.double()
        r64, _ = p64(pts.double().cpu(), vd.double().cpu(), t.double().cpu())
        (r64 * g.double().cpu()).sum().backward()
        torch.testing.assert_close(raw, rp, atol=1e-4, rtol=1e-4)
        _assert_fp32_grads(grads, {k: p.grad for k, p in plain.named_parameters()},
                           {k: p.grad for k, p in p64.named_parameters()})
    else:
        packed = b7.pack_trunk_params(kern.state_dict(), cfg, torch.bfloat16)
        emb = positional_encoding(pts, cfg.nf_pts).reshape(-1, cfg.input_ch).contiguous()
        vemb = positional_encoding(vd, cfg.nf_views)[:, None, :].expand(200, 16, -1).reshape(3200, -1).contiguous()
        ref = b7.trunk_plain(packed, emb, vemb).reshape(200, 16, 4)
        gr, _, _ = b7.trunk_plain_bwd(packed, emb, vemb, g.reshape(-1, 4), need_demb=False)
        assert (raw - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()
        rel = _rel_l2(grads, b7.unpack_trunk_grads(gr, packed))
        assert max(rel.values()) <= 1e-2, rel
    with torch.no_grad():
        before = [launches[k] for k in names]
        raw_nograd, _ = kern(pts, vd, t)
        raw_nograd2, _ = kern(pts, vd, t)
        torch.cuda.synchronize()
    assert [launches[k] - b for k, b in zip(names, before)] == [2, 0]
    if dtype == torch.float32:
        assert torch.equal(raw_nograd, raw.detach())
    else:  # the bf16 forward-only launch runs on the tensor cores: another sum order than train mode's
        assert (raw_nograd - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()
        assert torch.equal(raw_nograd, raw_nograd2)
    c2w = torch.eye(4)[:3].numpy()
    c2w[2, 3] = 4.0
    rays = make_rays_from_camera(16, 16, 20.0, c2w, 2.0, 6.0, device=dev, time=0.5)
    rcfg = RenderConfig(n_samples=32, white_bkgd=True)
    with torch.no_grad():
        rk = render_image(kern, rays, rcfg)["rgb"]
        rpl = render_image(plain, rays, rcfg)["rgb"]
    drgb = (rk - rpl).abs()
    if dtype == torch.float32:
        assert drgb.max().item() <= 1e-4
    else:
        assert drgb.max().item() <= 2e-2 and drgb.mean().item() <= 2e-3, (drgb.max().item(), drgb.mean().item())


def test_multires_phase2_step_kernel_route_matches_plain_route(dev):
    """One MultiRes phase-2 step over the 4 levels at full width (patches of
    32/16/8/4 pixels, 16 samples, jitter from one generator) on the kernel
    route against the plain route from the same weights and draws: every
    metric rel 1e-4, every level's gradients at the fallback bar (the plain
    route in float64 on the CPU as its reference)."""
    from swnerf_torch.ops.pyramid import generate_laplacian_pyramid
    from swnerf_torch.pipelines.run_multires import make_phase2_step
    from swnerf_torch.render.core import Draws, RenderConfig, make_draws
    from swnerf_torch.train.loop import init_train_state

    rcfg = RenderConfig(n_samples=16, perturb=1.0, white_bkgd=True)
    levels = ["level0", "level1", "level1", "identity"]
    pairs = [_mr_pair(dev, lv, seed=l) for l, lv in enumerate(levels)]
    size = 64
    pyr_hwf = [[size // 2**l, size // 2**l, 80.0 / 2**l] for l in range(4)]
    patch_sizes = [32, 16, 8, 4]
    g = torch.Generator(device=dev).manual_seed(6)
    images = torch.rand((1, size, size, 3), generator=g, device=dev)
    lap = generate_laplacian_pyramid(images, levels=4)
    pixels = [torch.stack(torch.meshgrid(torch.arange(8 // 2**l, 8 // 2**l + ps, device=dev),
                                         torch.arange(8 // 2**l, 8 // 2**l + ps, device=dev), indexing="ij"), -1)
              .reshape(-1, 2) for l, ps in enumerate(patch_sizes)]
    targets = [lap[l][0, 8 // 2**l : 8 // 2**l + ps, 8 // 2**l : 8 // 2**l + ps] for l, ps in enumerate(patch_sizes)]
    pose = torch.eye(4, device=dev)[:3]
    pose[2, 3] = 4.0
    draws = [make_draws(rcfg, ps * ps, g, dev) for ps in patch_sizes]
    step = make_phase2_step(rcfg, pyr_hwf, patch_sizes, 2.0, 6.0)

    def run(models, device, dtype):
        states = [init_train_state(m, None, 5e-4, 250) for m in models]
        cast = lambda x: x.to(device=device, dtype=dtype)  # noqa: E731
        m = step(states, [p.to(device) for p in pixels], [cast(t) for t in targets], cast(images[0, 8:40, 8:40]),
                 cast(pose), 0.4, 1.0, draws=[Draws(cast(d.t_rand), None, None, None) for d in draws])
        return m, [{k: p.grad for k, p in s.coarse.named_parameters()} for s in states]

    before = launches["trunk[bwd]"]
    mk, gk = run([k for k, _ in pairs], dev, torch.float32)
    torch.cuda.synchronize()
    assert launches["trunk[bwd]"] == before + 4
    mp, gp = run([p for _, p in pairs], dev, torch.float32)
    cpu64 = []
    for k, _ in pairs:
        m = DirectTemporalNeRF(k.cfg, device="cpu", fused=False)
        m.load_state_dict(k.state_dict())
        cpu64.append(m.double())
    _, g64 = run(cpu64, "cpu", torch.float64)
    for key in mk:
        assert mk[key].item() == pytest.approx(mp[key].item(), rel=1e-4), key
    for a, b, c in zip(gk, gp, g64):
        _assert_fp32_grads(a, b, c)


# ---------------------------------------------------------------- B7', B8 and the fields' kernel routes

REPO = Path(__file__).resolve().parents[1]
VANILLA_CKPT = REPO / "benchmarks" / "full_scale" / "logs" / "full_nerf_200k" / "010000.tar"
TNERF_CKPT = REPO / "benchmarks" / "round5_artifacts" / "full_tnerf_800k" / "800000.tar"
CAM = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 4.0]], np.float32)  # 4 units up +z, looking down -z


def _b7p_case(dev, kw, n=300, s=16, seed=0):
    """A seeded T-NeRF, its [embed(x) | embed(t)] and view embeddings per
    sample (fp32, on the card) and a cotangent."""
    cfg = TNeRFConfig(**kw)
    model = TNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(seed), fused=False)
    o, d, vd, z, _ = _rays(dev, n, s, seed)
    pts = o[:, None, :] + d[:, None, :] * z[..., None]
    t = torch.rand((n, 1, 1), generator=torch.Generator(device=dev).manual_seed(seed), device=dev).expand(n, s, 1)
    emb = torch.cat([positional_encoding(pts, cfg.nf_pts), positional_encoding(t, cfg.nf_time)], -1)
    vemb = positional_encoding(vd, cfg.nf_views)[:, None, :].expand(n, s, -1)
    g = torch.randn((n * s, 4), generator=torch.Generator(device=dev).manual_seed(seed + 1), device=dev)
    return cfg, model.state_dict(), emb.reshape(n * s, -1).contiguous(), vemb.reshape(n * s, -1).contiguous(), g


def _b8_case(dev, n=300, s=16, seed=0):
    """010000.tar's fine network (D=8, W=256, multires 10/4), positions and
    per-sample view directions [n*s, 3] and a cotangent."""
    from swnerf_torch.train.checkpoint import load_tar, vanilla_state_dict

    cfg = VanillaNeRFConfig()
    sd = vanilla_state_dict(load_tar(str(VANILLA_CKPT))["network_fine_state_dict"])
    o, d, vd, z, _ = _rays(dev, n, s, seed)
    o = o * torch.tensor([1.0, 1.0, 0.0], device=dev)  # rays through the object: x, y in N(0, 0.3), from z = 0
    pts = (o[:, None, :] + d[:, None, :] * (z[..., None] - 4.0) * 0.4).reshape(-1, 3).contiguous()
    vdp = vd[:, None, :].expand(n, s, 3).reshape(-1, 3).contiguous()
    g = torch.randn((n * s, 4), generator=torch.Generator(device=dev).manual_seed(seed + 1), device=dev)
    return cfg, {k: v.to(dev) for k, v in sd.items()}, pts, vdp, g


def _in_grads(grads, d0, d1, packed, names):
    return dict(b7.unpack_trunk_grads(grads, packed), **{names[0]: d0, names[1]: d1})


@pytest.mark.parametrize("kw", TNERF_CASES, ids=TNERF_IDS)
def test_b7p_fp32_matches_plain(dev, kw):
    """B7' (fp32) against its twin: raw atol/rtol 1e-4, the parameter
    gradients, demb and dvemb at the fallback bar (the colour ReLU's mask can
    tie at a logit of 0, as B4's does), one launch each way, the
    forward-only launch bit-equal to train mode."""
    cfg, sd, emb, vemb, g = _b7p_case(dev, kw)
    packed = b7.pack_tnerf_trunk_params(sd, cfg, torch.float32)
    before = (launches["trunk[tnerf]"], launches["trunk[tnerf,bwd]"])
    raw, grads, demb, dvemb = b7.trunk_fwd_bwd(packed, emb, vemb, g, True, True)
    torch.cuda.synchronize()
    assert (launches["trunk[tnerf]"], launches["trunk[tnerf,bwd]"]) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(raw, b7.trunk_plain(packed, emb, vemb), atol=1e-4, rtol=1e-4)
    assert torch.equal(b7.trunk(packed, emb, vemb), raw) and (raw[:, :3] >= 0).all()
    names = ("demb", "dvemb")
    ref = b7.trunk_plain_bwd(packed, emb, vemb, g, True, True)
    p64 = dataclasses.replace(packed, weights=packed.weights.double())
    g64 = b7.trunk_plain_bwd(p64, emb.double(), vemb.double(), g.double(), True, True)
    g64p = b7.trunk_plain_bwd(dataclasses.replace(p64, weights=_jitter(p64.weights)), emb.double(), vemb.double(),
                              g.double(), True, True)
    _assert_fp32_grads(_in_grads(grads, demb, dvemb, packed, names), _in_grads(*ref, packed, names),
                       _in_grads(*g64, p64, names), _in_grads(*g64p, p64, names))


def test_b7p_bf16_matches_plain_and_repeats(dev):
    """B7' (bf16, the T-NeRF config) against its bf16 twin: raw within 1e-2
    of its largest value, gradients rel L2 1e-2, bit-equal repeats."""
    cfg, sd, emb, vemb, g = _b7p_case(dev, {}, n=500, s=64)
    packed = b7.pack_tnerf_trunk_params(sd, cfg, torch.bfloat16)
    raw, grads, demb, _ = b7.trunk_fwd_bwd(packed, emb, vemb, g)
    _, grads2, demb2, _ = b7.trunk_fwd_bwd(packed, emb, vemb, g)
    ref = b7.trunk_plain(packed, emb, vemb)
    gr, dr, _ = b7.trunk_plain_bwd(packed, emb, vemb, g)
    torch.cuda.synchronize()
    assert (raw - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()
    rel = _rel_l2(_b7_grads(grads, demb, packed), _b7_grads(gr, dr, packed))
    assert max(rel.values()) <= 1e-2, rel
    assert torch.equal(grads[0], grads2[0]) and torch.equal(grads[1], grads2[1]) and torch.equal(demb, demb2)


def test_b8_fp32_matches_plain(dev):
    """B8 (fp32) on 010000.tar's fine network against its twin: raw
    atol/rtol 1e-4, the parameter gradients, d pts and d viewdirs at the
    fallback bar, one launch each way, the forward-only launch bit-equal."""
    cfg, sd, pts, vd, g = _b8_case(dev)
    packed = b7.pack_trunk_params(sd, cfg, torch.float32)
    before = (launches["trunk[raw]"], launches["trunk[raw,bwd]"])
    raw, grads, dpts, dvd = b7.field_raw_fwd_bwd(packed, pts, vd, g)
    torch.cuda.synchronize()
    assert (launches["trunk[raw]"], launches["trunk[raw,bwd]"]) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(raw, b7.field_raw_plain(packed, pts, vd), atol=1e-4, rtol=1e-4)
    assert torch.equal(b7.field_raw(packed, pts, vd), raw)
    names = ("dpts", "dviewdirs")
    ref = b7.field_raw_plain_bwd(packed, pts, vd, g)
    p64 = dataclasses.replace(packed, weights=packed.weights.double())
    g64 = b7.field_raw_plain_bwd(p64, pts.double(), vd.double(), g.double())
    g64p = b7.field_raw_plain_bwd(dataclasses.replace(p64, weights=_jitter(p64.weights)), pts.double(), vd.double(),
                                  g.double())
    _assert_fp32_grads(_in_grads(grads, dpts, dvd, packed, names), _in_grads(*ref, packed, names),
                       _in_grads(*g64, p64, names), _in_grads(*g64p, p64, names))
    with pytest.raises(ValueError):  # B8 takes positions [P, 3], not embeddings
        b7.field_raw(packed, positional_encoding(pts, 10).contiguous(), vd)


def test_b8_bf16_matches_plain_and_repeats(dev):
    """B8 (bf16): raw within 1e-2 of its largest value, gradients and input
    cotangents rel L2 1e-2 of the bf16 twin, bit-equal repeats."""
    cfg, sd, pts, vd, g = _b8_case(dev, n=500, s=64)
    packed = b7.pack_trunk_params(sd, cfg, torch.bfloat16)
    raw, grads, dpts, dvd = b7.field_raw_fwd_bwd(packed, pts, vd, g)
    _, grads2, dpts2, _ = b7.field_raw_fwd_bwd(packed, pts, vd, g)
    ref = b7.field_raw_plain(packed, pts, vd)
    gr, dr, dvr = b7.field_raw_plain_bwd(packed, pts, vd, g)
    torch.cuda.synchronize()
    assert (raw - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()
    names = ("dpts", "dviewdirs")
    rel = _rel_l2(_in_grads(grads, dpts, dvd, packed, names), _in_grads(gr, dr, dvr, packed, names))
    assert max(rel.values()) <= 1e-2, rel
    assert torch.equal(grads[0], grads2[0]) and torch.equal(grads[1], grads2[1]) and torch.equal(dpts, dpts2)


TC_ROWS = [1, 127, 129, 8256, 204800]  # 204,800: one mesh tile (2,048 points x 100 views)
TC_PADS = {"narrow": dict(multires=10, multires_views=4), "wide": dict(multires=20, multires_views=20)}


def _tc_field(dev, pad, width, rows, seed=0):
    """A seeded vanilla field (D=8, W=width, skip 4) at the narrow pads (63 /
    27 columns: the mesh sweep's) or the wide ones (123 / 123: MultiRes level
    0's), packed in bf16, and ``rows`` seeded positions in [-2, 2]^3 with unit
    view directions (fp32, on the card)."""
    cfg = VanillaNeRFConfig(netwidth=width, **TC_PADS[pad])
    model = VanillaNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(seed), fused=False)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    pts = torch.rand((rows, 3), generator=g, device=dev) * 4 - 2
    vd = torch.nn.functional.normalize(torch.randn((rows, 3), generator=g, device=dev), dim=-1)
    return cfg, b7.pack_trunk_params(model.state_dict(), cfg, torch.bfloat16), pts, vd


def _assert_tc_raw(got, again, ref):
    """raw within 1e-2 (max) and 1e-3 (mean) of the twin's largest value;
    a repeat bit-equal."""
    scale = ref.abs().max().item()
    d = (got - ref).abs()
    assert d.max().item() <= 1e-2 * scale and d.mean().item() <= 1e-3 * scale, (d.max().item(), d.mean().item(),
                                                                                 scale)
    assert torch.equal(got, again)


@pytest.mark.parametrize("rows", TC_ROWS)
@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("pad", list(TC_PADS))
def test_b7_tc_forward_matches_plain(dev, pad, width, rows):
    """B7's bf16 forward-only launch (the tensor cores, csrc/trunk.cu::
    trunk_tc_kernel) against trunk_plain at both pads, W 128 and 256, D=8
    with skip 4, from one row to one mesh tile: _assert_tc_raw's bars, one
    launch a call."""
    cfg, packed, pts, vd = _tc_field(dev, pad, width, rows)
    emb = positional_encoding(pts, cfg.nf_pts).contiguous()
    vemb = positional_encoding(vd, cfg.nf_views).contiguous()
    before = launches["trunk"]
    got, again = b7.trunk(packed, emb, vemb), b7.trunk(packed, emb, vemb)
    torch.cuda.synchronize()
    assert launches["trunk"] == before + 2
    _assert_tc_raw(got, again, b7.trunk_plain(packed, emb, vemb))


@pytest.mark.parametrize("rows", TC_ROWS)
@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("pad", list(TC_PADS))
def test_b8_tc_forward_matches_plain(dev, pad, width, rows):
    """B8's bf16 forward-only launch (the encodes in the block, the tensor
    cores) against field_raw_plain at the same cases and bars as B7's."""
    cfg, packed, pts, vd = _tc_field(dev, pad, width, rows, seed=2)
    before = launches["trunk[raw]"]
    got, again = b7.field_raw(packed, pts, vd), b7.field_raw(packed, pts, vd)
    torch.cuda.synchronize()
    assert launches["trunk[raw]"] == before + 2
    _assert_tc_raw(got, again, b7.field_raw_plain(packed, pts, vd))


TRAIN_ROWS = [1, 127, 129, 32000, 65536]


def _rows_case(rows):
    """(rays, samples per ray) giving ``rows``: 64 samples where they divide."""
    return (rows // 64, 64) if rows % 64 == 0 else (rows, 1)


def _tape(scratch, P):
    """The first two regions of a trunk train-mode scratch (csrc/trunk.cu::
    carve): the embedding and the view embedding, bf16 [P, 128] each."""
    nb = 2 * P * 128
    off = -(-nb // 256) * 256
    return (scratch[:nb].view(torch.bfloat16).view(P, 128).clone(),
            scratch[off:off + nb].view(torch.bfloat16).view(P, 128).clone())


@pytest.mark.parametrize("rows", TRAIN_ROWS)
@pytest.mark.parametrize("level", list(MR_LEVELS))
def test_b7_bf16_train_mode_at_ragged_rows(dev, level, rows):
    """B7's bf16 train-mode forward (trunk_fwd_kernel: with its forward on
    the tensor cores its gradients leave the card's bar on tc_rounding.py's
    cases, PERF.md §6) and its backward with demb and dvemb (the tensor
    cores: tc_demb, tc_dvemb) at each MultiRes level, from one row to phase
    2's 65,536: raw within 1e-2 of the twin's largest value, the gradients,
    demb and dvemb rel L2 1e-2 of the twin summed on the CPU, bit-equal
    repeats, one launch each way per call. The CPU twin, not the card's:
    at 127 and 129 rows a pre-activation within fp32 rounding of 0 flips
    a ReLU mask between the card twin's order and the others, which moves
    a lower layer's gradient by ~2e-2 (the kernel's distance from the
    card's twin is printed beside)."""
    n, s = _rows_case(rows)
    cfg, sd, emb, vemb, g = _b7_case(dev, level, n=n, s=s, seed=rows)
    packed = b7.pack_trunk_params(sd, cfg, torch.bfloat16)
    before = (launches["trunk"], launches["trunk[bwd]"])
    raw, grads, demb, dvemb = b7.trunk_fwd_bwd(packed, emb, vemb, g, True, True)
    assert (launches["trunk"], launches["trunk[bwd]"]) == (before[0] + 1, before[1] + 1)
    raw2, grads2, demb2, dvemb2 = b7.trunk_fwd_bwd(packed, emb, vemb, g, True, True)
    ref = b7.trunk_plain(packed, emb, vemb)
    gr, dr, dvr = b7.trunk_plain_bwd(packed, emb, vemb, g, True, True)
    torch.cuda.synchronize()
    assert (raw - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()
    names = ("demb", "dvemb")
    pc = dataclasses.replace(packed, weights=packed.weights.cpu(), biases=packed.biases.cpu())
    ref = {k: v.to(dev) for k, v in
           _in_grads(*b7.trunk_plain_bwd(pc, emb.cpu(), vemb.cpu(), g.cpu(), True, True), pc, names).items()}
    got = _in_grads(grads, demb, dvemb, packed, names)
    rel = _rel_l2(got, ref)
    card = _rel_l2(got, _in_grads(gr, dr, dvr, packed, names))
    worst = max(rel, key=rel.get)
    print(f"B7 {level} {rows} rows: max rel L2 {rel[worst]:.3e} ({worst}) from the CPU twin, "
          f"{max(card.values()):.3e} from the card's")
    assert max(rel.values()) <= 1e-2, rel
    assert torch.equal(raw, raw2) and all(torch.equal(a, b) for a, b in zip(
        (*grads, demb, dvemb), (*grads2, demb2, dvemb2)))


@pytest.mark.parametrize("rows", TRAIN_ROWS)
@pytest.mark.parametrize("level", list(MR_LEVELS))
def test_b7_bf16_train_mode_raw_is_the_ordered_twin(dev, level, rows):
    """B7's bf16 train-mode raw (trunk_fwd_kernel: fp32 FMAs in order, one
    accumulator an output, csrc/mlp_common.cuh::mm_ring) bit-equal to
    trunk_ordered, which repeats that order in torch ops on the card, at each
    MultiRes level from one row to phase 2's 65,536."""
    n, s = _rows_case(rows)
    cfg, sd, emb, vemb, _ = _b7_case(dev, level, n=n, s=s, seed=rows)
    packed = b7.pack_trunk_params(sd, cfg, torch.bfloat16)
    raw = b7._launch_fwd(packed, emb, vemb, b7._scratch(packed, rows, dev))
    ref = b7.trunk_ordered(packed, emb, vemb)
    torch.cuda.synchronize()
    assert torch.equal(raw, ref), (raw - ref).abs().max().item()


@pytest.mark.parametrize("rows", TRAIN_ROWS)
@pytest.mark.parametrize("pad", list(TC_PADS))
def test_b8_bf16_train_mode_at_ragged_rows(dev, pad, rows):
    """B8's bf16 train-mode forward (trunk_fwd_kernel: with its forward on
    the tensor cores its gradients leave the bars, PERF.md §6) and its
    backward with d pts and d viewdirs (the tensor cores: tc_demb,
    tc_dvemb) at the narrow pads (63 / 27 columns) and the wide ones (123 /
    123), W=256, from one row to 65,536: raw within 1e-2 of the twin's
    largest value and of the forward-only launch's (the tensor cores); the
    tape's embeddings are the twin's rounded ones (all but 1e-3 of them bit
    for bit, the rest one bf16 ulp off) with the column of ones at cin and
    zeros past the live columns up to the scratch's 128; the gradients and
    input cotangents rel L2 1e-2 of the twin summed on the CPU, as
    test_b7_bf16_train_mode_at_ragged_rows holds B7 (the distance from the
    card's twin printed beside); bit-equal repeats; one launch each way per
    call."""
    cfg, packed, pts, vd = _tc_field(dev, pad, 256, rows, seed=3)
    g = torch.randn((rows, 4), generator=torch.Generator(device=dev).manual_seed(rows), device=dev)
    before = (launches["trunk[raw]"], launches["trunk[raw,bwd]"])
    sc = b7._scratch(packed, rows, dev, raw=True)
    raw = b7._launch_fwd(packed, pts, vd, sc, raw=True)
    emb_t, vemb_t = _tape(sc, rows)
    grads, dpts, dvd = b7._launch_bwd(packed, rows, g, sc, True, True, (pts, vd))
    assert (launches["trunk[raw]"], launches["trunk[raw,bwd]"]) == (before[0] + 1, before[1] + 1)
    raw2, grads2, dpts2, dvd2 = b7.field_raw_fwd_bwd(packed, pts, vd, g)
    ref = b7.field_raw_plain(packed, pts, vd)
    gr, dr, dvr = b7.field_raw_plain_bwd(packed, pts, vd, g)
    lp, lv = packed.n_freqs
    emb, vemb = b7._padded(packed, positional_encoding(pts, lp), positional_encoding(vd, lv))
    torch.cuda.synchronize()
    assert torch.equal(raw, raw2)
    assert (raw - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()
    assert (raw - b7.field_raw(packed, pts, vd)).abs().max().item() <= 1e-2 * ref.abs().max().item()
    cin, cv = packed.cin, packed.input_ch_views
    for tape, want in ((emb_t[:, :cin], emb[:, :cin]), (vemb_t[:, :cv], vemb[:, :cv])):
        # the kernel's sinf / cosf and torch's may part by an fp32 ulp, which
        # moves a rare bf16 rounding by one bf16 ulp
        assert (tape != want).float().mean().item() <= 1e-3
        torch.testing.assert_close(tape.float(), want.float(), rtol=2.0**-7, atol=1e-6)
    assert bool((emb_t[:, cin] == 1).all()) and not emb_t[:, cin + 1:].any() and not vemb_t[:, cv:].any()
    names = ("dpts", "dviewdirs")
    pc = dataclasses.replace(packed, weights=packed.weights.cpu(), biases=packed.biases.cpu())
    cpu = _in_grads(*b7.field_raw_plain_bwd(pc, pts.cpu(), vd.cpu(), g.cpu()), pc, names)
    got = _in_grads(grads, dpts, dvd, packed, names)
    rel = _rel_l2(got, cpu)
    card = _rel_l2(got, _in_grads(gr, dr, dvr, packed, names))
    print(f"B8 {pad} {rows} rows: max rel L2 {max(rel.values()):.3e} ({max(rel, key=rel.get)}) from the CPU twin, "
          f"{max(card.values()):.3e} from the card's")
    assert max(rel.values()) <= 1e-2, rel
    assert all(torch.equal(a, b) for a, b in zip((*grads, dpts, dvd), (*grads2, dpts2, dvd2)))


B7P_TILES = {"tile": dict(), "wide": dict(multires=12, multires_views=10)}  # 84 / 27 and 100 / 63 columns
B7P_ROWS = [1, 127, 32000]


def _b7p_rows_case(dev, tile, width, rows, seed):
    """_b7p_case at W=width, the T-NeRF config's 84 / 27 columns (B7''s
    96 / 64-column tiles) or 100 / 63 (the wide 128 / 128 tiles), ``rows``
    rows, packed in bf16."""
    n, s = _rows_case(rows)
    cfg, sd, emb, vemb, g = _b7p_case(dev, dict(B7P_TILES[tile], net_dim=width), n=n, s=s, seed=seed)
    return b7.pack_tnerf_trunk_params(sd, cfg, torch.bfloat16), emb, vemb, g


@pytest.mark.parametrize("rows", B7P_ROWS)
@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("tile", list(B7P_TILES))
def test_b7p_tc_forward_matches_plain(dev, tile, width, rows):
    """B7''s bf16 forward-only launch (the tensor cores: csrc/trunk.cu::
    trunk_tc_kernel with ELU in the epilogues and the colour lanes clipped)
    against trunk_plain at both tiles, W 128 and 256, from one row to an
    eager step's 32,000: _assert_tc_raw's bars (within 1e-2 of the twin's
    largest |raw|, a repeat bit-equal), raw rgb >= 0, one launch a call."""
    packed, emb, vemb, _ = _b7p_rows_case(dev, tile, width, rows, seed=rows)
    before = launches["trunk[tnerf]"]
    got, again = b7.trunk(packed, emb, vemb), b7.trunk(packed, emb, vemb)
    torch.cuda.synchronize()
    assert launches["trunk[tnerf]"] == before + 2
    assert bool((got[:, :3] >= 0).all())
    _assert_tc_raw(got, again, b7.trunk_plain(packed, emb, vemb))


def _b7p_twin_bwd(packed, emb, vemb, g, mask):
    """trunk_plain_bwd with demb and dvemb, the colour cotangent masked by
    ``mask`` [P, 3] (the kernel forward's raw rgb > 0, i.e. its u > 0) in
    place of the twin's own logits > 0; on the tensors' device."""
    e, v = b7._padded(packed, emb, vemb)
    hs, feat, hv, _, _ = field_mlp(packed, e, v)
    gm = torch.cat([torch.where(mask, g[:, :3], torch.zeros_like(g[:, :3])), g[:, 3:]], -1)
    return b1.field_reverse_plain(packed, e, v, hs, feat, hv, gm, True, True)


@pytest.mark.parametrize("rows", B7P_ROWS)
@pytest.mark.parametrize("width", [128, 256])
def test_b7p_bf16_train_mode_at_ragged_rows(dev, width, rows):
    """B7''s bf16 train-mode forward (the tensor cores at W=128, the SIMT
    body at W=256: tc_rounding.py --backward b7p, PERF.md §6) and its
    backward on the tensor cores (field_reverse's TC branch with ELU' from
    the stored outputs, demb over the 128-column pad, dvemb) at the T-NeRF
    config's widths, W 128 and 256, from one row to 32,000: raw within 1e-2
    of the twin's largest value and rgb >= 0; the colour masks (raw rgb > 0)
    the twin's on all but 1e-3 of them; the tape's embeddings the twin's
    rounded ones with the column of ones at cin and zeros past the live
    columns up to the scratch's 128; the gradients, demb and dvemb rel L2
    1e-2 of the twin summed on the CPU on the kernel forward's colour mask,
    which the backward reads (a logit within rounding of 0 flips a mask
    between any two forwards, and one flip moves the colour bias's gradient
    by ~1e-2 at 32,000 rows of a random cotangent: with the twin's own mask
    the SIMT forward at W=256 lands 1.427e-2 from both twins; that distance
    and the flips are printed); bit-equal repeats; one launch each way per
    call."""
    packed, emb, vemb, g = _b7p_rows_case(dev, "tile", width, rows, seed=rows)
    before = (launches["trunk[tnerf]"], launches["trunk[tnerf,bwd]"])
    sc = b7._scratch(packed, rows, dev)
    raw = b7._launch_fwd(packed, emb, vemb, sc)
    emb_t, vemb_t = _tape(sc, rows)
    grads, demb, dvemb = b7._launch_bwd(packed, rows, g, sc, True, True)
    assert (launches["trunk[tnerf]"], launches["trunk[tnerf,bwd]"]) == (before[0] + 1, before[1] + 1)
    raw2, grads2, demb2, dvemb2 = b7.trunk_fwd_bwd(packed, emb, vemb, g, True, True)
    ref = b7.trunk_plain(packed, emb, vemb)
    e, v = b7._padded(packed, emb, vemb)
    torch.cuda.synchronize()
    assert torch.equal(raw, raw2) and bool((raw[:, :3] >= 0).all())
    assert (raw - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()
    mask = raw[:, :3] > 0
    flips = (mask != (ref[:, :3] > 0)).sum().item()
    assert flips <= 1e-3 * mask.numel(), flips
    cin, cv = packed.cin, packed.input_ch_views
    assert torch.equal(emb_t[:, :cin].float(), e[:, :cin]) and torch.equal(vemb_t[:, :cv].float(), v[:, :cv])
    assert bool((emb_t[:, cin] == 1).all()) and not emb_t[:, cin + 1:].any() and not vemb_t[:, cv:].any()
    names = ("demb", "dvemb")
    pc = dataclasses.replace(packed, weights=packed.weights.cpu(), biases=packed.biases.cpu())
    cpu = _in_grads(*_b7p_twin_bwd(pc, emb.cpu(), vemb.cpu(), g.cpu(), mask.cpu()), pc, names)
    own = _in_grads(*b7.trunk_plain_bwd(pc, emb.cpu(), vemb.cpu(), g.cpu(), True, True), pc, names)
    got = _in_grads(grads, demb, dvemb, packed, names)
    rel = _rel_l2(got, cpu)
    print(f"B7' W={width} {rows} rows: max rel L2 {max(rel.values()):.3e} ({max(rel, key=rel.get)}) from the CPU "
          f"twin on the kernel's colour mask, {max(_rel_l2(got, own).values()):.3e} on the twin's own; {flips} of "
          f"{mask.numel()} colour masks flipped")
    assert max(rel.values()) <= 1e-2, rel
    assert all(torch.equal(a, b) for a, b in zip((*grads, demb, dvemb), (*grads2, demb2, dvemb2)))


B8_TRAIN_WEIGHTS = ("010000.tar", "seeded", "seeded, wide pads")


@pytest.mark.parametrize("weights", B8_TRAIN_WEIGHTS)
def test_b8_bf16_train_mode_holds_the_forward_bar_on_the_training_path(dev, weights):
    """B8's bf16 train-mode forward (trunk_fwd_kernel) and backward (the
    tensor cores, demb and dvemb) on the training path's case at its size,
    tc_rounding.py --backward b8's: 500 rays x 64 samples through the
    object (ray seed 8), on 010000.tar's fine weights or seeded ones (the
    vanilla widths, or the wide pads 123 / 123), raw through the composite
    (noise std 1) to the squared error's cotangent against a seeded target,
    each side's cotangent from its own raw: the gradients, d pts and d
    viewdirs within 5e-3 rel L2 (tests/test_torch_tc_backward.py's
    FORWARD_BAR) of the bf16 twin's. There the forward on the tensor core's
    own chain put the seeded weights' at 8.4e-3 (PERF.md §6)."""
    from swnerf_torch.ops.kernels.tc_model import composite
    from swnerf_torch.train.checkpoint import load_tar, vanilla_state_dict

    n, s = 500, 64
    cfg = VanillaNeRFConfig(**(TC_PADS["wide"] if weights.endswith("wide pads") else {}))
    if weights == "010000.tar":
        sd = vanilla_state_dict(load_tar(str(VANILLA_CKPT))["network_fine_state_dict"])
    else:
        sd = VanillaNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(0), fused=False).state_dict()
    packed = b7.pack_trunk_params({k: v.to(dev) for k, v in sd.items()}, cfg, torch.bfloat16)
    o, d, vd, z, dist = _rays(dev, n, s, 8)
    g = torch.Generator(device=dev).manual_seed(8)  # past _rays' draws (o, d, z), as tc_rounding.py draws on
    torch.randn((n, 3), generator=g, device=dev), torch.randn((n, 3), generator=g, device=dev)
    torch.rand((n, s), generator=g, device=dev)
    loss = (z, dist, torch.randn((n, s), generator=g, device=dev), True,
            torch.rand((n, 3), generator=g, device=dev), 1.0 / (3 * n))
    o = o * torch.tensor([1.0, 1.0, 0.0], device=dev)
    pts = (o[:, None, :] + d[:, None, :] * (z[..., None] - 4.0) * 0.4).reshape(-1, 3).contiguous()
    vdp = vd[:, None, :].expand(n, s, 3).reshape(-1, 3).contiguous()
    before = (launches["trunk[raw]"], launches["trunk[raw,bwd]"])
    sc = b7._scratch(packed, n * s, dev, raw=True)
    raw = b7._launch_fwd(packed, pts, vdp, sc, raw=True)
    grads, dpts, dvd = b7._launch_bwd(packed, n * s, composite(raw[:, 3], raw[:, :3], *loss)[1].float().contiguous(),
                                      sc, True, True, (pts, vdp))
    assert (launches["trunk[raw]"], launches["trunk[raw,bwd]"]) == (before[0] + 1, before[1] + 1)
    ref = b7.field_raw_plain(packed, pts, vdp)
    gr, dr, dvr = b7.field_raw_plain_bwd(packed, pts, vdp, composite(ref[:, 3], ref[:, :3], *loss)[1].float())
    names = ("dpts", "dviewdirs")
    rel = _rel_l2(_in_grads(grads, dpts, dvd, packed, names), _in_grads(gr, dr, dvr, packed, names))
    print(f"B8 {weights}, training path, {n * s} rows: max rel L2 {max(rel.values()):.3e} "
          f"({max(rel, key=rel.get)})")
    assert max(rel.values()) <= 5e-3, rel


def _field_route_check(kern, plain, inputs, g, names, dtype, twin_grads, render, tc=False):
    """Forward + backward (one launch each way), the no-grad forward (one
    forward-only launch, bit-equal to the autograd forward; with ``tc``, B7 /
    B8's bf16 forward-only launch on the tensor cores, whose sum order
    differs from train mode's: held to the plain route at the bf16 raw bar
    and bit-equal to a second no-grad call), a no-grad render. fp32: raw atol/rtol
    1e-4 and the gradients rel L2 1e-3 of the plain route (ReLU ties at D=8
    move single tensors past 1e-4, ROADMAP Queue C), rgb 1e-4. bf16: raw
    within 1e-2 of the plain fp32 route's largest value, the gradients rel
    L2 1e-2 of the bf16 twin's (``twin_grads()``: the same function in torch
    ops, rounded where the kernel rounds), the render's rgb within 2e-2 of
    the plain route's (mean 2e-3)."""
    before = [launches[k] for k in names]
    raw = kern(*inputs)
    (raw * g).sum().backward()
    torch.cuda.synchronize()
    assert [launches[k] - b for k, b in zip(names, before)] == [1, 1]
    rp = plain(*inputs)
    (rp * g).sum().backward()
    grads = {k: p.grad for k, p in kern.named_parameters()}
    if dtype == torch.float32:
        torch.testing.assert_close(raw, rp, atol=1e-4, rtol=1e-4)
        rel = _rel_l2(grads, {k: p.grad for k, p in plain.named_parameters()})
        assert max(rel.values()) <= 1e-3, rel
    else:
        assert (raw - rp).abs().max().item() <= 1e-2 * rp.abs().max().item()
        rel = _rel_l2(grads, twin_grads())
        assert max(rel.values()) <= 1e-2, rel
    with torch.no_grad():
        before = [launches[k] for k in names]
        raw_nograd = kern(*inputs)
        torch.cuda.synchronize()
        assert [launches[k] - b for k, b in zip(names, before)] == [1, 0]
        if tc:
            assert (raw_nograd - rp).abs().max().item() <= 1e-2 * rp.abs().max().item()
            assert torch.equal(kern(*inputs), raw_nograd)
        else:
            assert torch.equal(raw_nograd, raw.detach())
    rk, rpl = render()
    drgb = (rk - rpl).abs()
    bar = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 2e-3)
    assert drgb.max().item() <= bar[0] and drgb.mean().item() <= bar[1], (drgb.max().item(), drgb.mean().item())


@pytest.mark.parametrize("raw_route", [False, True], ids=["b7", "b8"])
@pytest.mark.parametrize("dtype", [torch.float32, None], ids=["fp32", "default_bf16"])
def test_vanilla_field_kernel_route_matches_plain_route(dev, raw_route, dtype, monkeypatch):
    """VanillaNeRF(fused=None) on the card (B7; B8 under SWNERF_FUSED_RAW=1)
    against fused=False, 010000.tar's fine weights: _field_route_check's
    bars, a 16x16 render of 32 samples."""
    from swnerf_torch.render.core import RenderConfig, make_rays_from_camera, render_image

    monkeypatch.setenv("SWNERF_FUSED_RAW", "1" if raw_route else "0")
    cfg, sd, pts, vd, _ = _b8_case(dev, n=200, s=16, seed=3)
    kern = VanillaNeRF(cfg, device=dev, compute_dtype=dtype)
    plain = VanillaNeRF(cfg, device=dev, fused=False)
    kern.load_state_dict(sd)
    plain.load_state_dict(sd)
    assert kern.fused and kern.uses_field_raw() is raw_route and not plain.fused
    g = torch.randn((200, 16, 4), generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    names = ("trunk[raw]", "trunk[raw,bwd]") if raw_route else ("trunk", "trunk[bwd]")
    rays = make_rays_from_camera(16, 16, 20.0, CAM, 2.0, 6.0,
                                 device=dev)

    def render():
        with torch.no_grad():
            rc = RenderConfig(n_samples=32, white_bkgd=True)
            return render_image(kern, rays, rc)["rgb"], render_image(plain, rays, rc)["rgb"]

    def twin_grads():
        packed = b7.pack_trunk_params(sd, cfg, torch.bfloat16)
        gg = g.reshape(-1, 4)
        if raw_route:
            grads = b7.field_raw_plain_bwd(packed, pts, vd, gg, False, False)[0]
        else:
            emb, vemb = positional_encoding(pts, cfg.nf_pts), positional_encoding(vd, cfg.nf_views)
            grads = b7.trunk_plain_bwd(packed, emb, vemb, gg, False, False)[0]
        return b7.unpack_trunk_grads(grads, packed)

    _field_route_check(kern, plain, (pts.reshape(200, 16, 3), vd.reshape(200, 16, 3)[:, 0]), g, names, dtype,
                       twin_grads, render, tc=dtype is None)


@pytest.mark.parametrize("dtype", [torch.float32, None], ids=["fp32", "default_bf16"])
def test_tnerf_field_kernel_route_matches_plain_route(dev, dtype):
    """TNeRF(fused=None) on the card (B7') against fused=False with the
    round-5 800000.tar weights: _field_route_check's bars, a 16x16 render
    at time 0.5."""
    from swnerf_torch.render.core import RenderConfig, make_rays_from_camera, render_image
    from swnerf_torch.train.checkpoint import load_tar, tnerf_state_dict

    cfg = TNeRFConfig()
    sd = tnerf_state_dict(load_tar(str(TNERF_CKPT))["network_fn_state_dict"])
    kern = TNeRF(cfg, device=dev, compute_dtype=dtype)
    plain = TNeRF(cfg, device=dev, fused=False)
    kern.load_state_dict(sd)
    plain.load_state_dict(sd)
    assert kern.fused and not plain.fused
    o, d, vd, z, _ = _rays(dev, 200, 16, 4)
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).contiguous()
    t = torch.full((200, 1), 0.5, device=dev)
    g = torch.randn((200, 16, 4), generator=torch.Generator(device=dev).manual_seed(6), device=dev)
    rays = make_rays_from_camera(16, 16, 20.0, CAM, 2.0, 6.0,
                                 device=dev, time=0.5)

    def render():
        with torch.no_grad():
            rc = RenderConfig(n_samples=32, white_bkgd=True)
            return render_image(kern, rays, rc)["rgb"], render_image(plain, rays, rc)["rgb"]

    def twin_grads():
        packed = b7.pack_tnerf_trunk_params(kern.state_dict(), cfg, torch.bfloat16)
        emb = torch.cat([positional_encoding(pts, cfg.nf_pts),
                         positional_encoding(t[:, None, :].expand(200, 16, 1), cfg.nf_time)], -1).reshape(3200, -1)
        vemb = positional_encoding(vd, cfg.nf_views)[:, None, :].expand(200, 16, -1).reshape(3200, -1)
        grads = b7.trunk_plain_bwd(packed, emb, vemb, g.reshape(-1, 4), False, False)[0]
        return b7.unpack_trunk_grads(grads, packed)

    _field_route_check(kern, plain, (pts, vd, t), g, ("trunk[tnerf]", "trunk[tnerf,bwd]"), dtype, twin_grads, render)


# ---------------------------------------------------------------- MultiRes on the render kernels: B3 wide, B9;
# B10; B11


def _wide_case(dev, level, n, s, seed=0):
    """A MultiRes level's canonical field (D=8, W=256) at given sample
    positions (o + d*z plus a small offset), its view embedding, noise std 1
    and seeded per-ray cotangents of (rgb, acc, depth)."""
    cfg = DNeRFConfig(**MR_LEVELS[level])
    model = DirectTemporalNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(seed), fused=False)
    o, d, vd, z, dist = _rays(dev, n, s, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]
           + 0.05 * torch.randn((n, s, 3), generator=g, device=dev)).contiguous()
    ve = positional_encoding(vd, cfg.nf_views).contiguous()
    noise = torch.randn((n, s), generator=g, device=dev)
    gct = torch.randn((n, 5), generator=g, device=dev)
    return cfg, canonical_params(model.state_dict()), pts, (ve, z, dist, noise), gct


@pytest.mark.parametrize("level", ["level0", "level1"])
@pytest.mark.parametrize("n_samples", [8, 64, 192, 256])
def test_b3_wide_fp32_matches_plain(dev, level, n_samples):
    """B3's pts mode on the wide pack (128 / 128 rows) at B3's fp32 bars, up
    to the shared-memory bound S = 256; S = 257 is refused."""
    cfg, sd, pts, (ve, z, dist, noise), _ = _wide_case(dev, level, 200, n_samples)
    packed = b3.pack_params(sd, cfg, torch.float32)
    assert packed.wide
    key = f"render_pass[pts,wide,S={n_samples}]"
    before = launches[key]
    got = b3.render_pass(packed, None, None, ve, z, dist, noise, True, None, pts)
    ref = b3.render_pass_plain(packed, None, None, ve, z, dist, noise, True, None, pts)
    torch.cuda.synchronize()
    assert launches[key] == before + 1
    torch.testing.assert_close(got.rgb, ref.rgb, atol=1e-4, rtol=0)
    torch.testing.assert_close(got.acc, ref.acc, atol=1e-4, rtol=0)
    torch.testing.assert_close(got.depth, ref.depth, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(got.weights, ref.weights, atol=1e-4, rtol=0)
    if n_samples == 256:
        big = torch.cat([z, z[:, -1:]], -1).contiguous()
        with pytest.raises(ValueError, match="fits 256 at most"):
            b3.render_pass(packed, None, None, ve, big, big, None, True, None,
                           torch.cat([pts, pts[:, -1:]], 1).contiguous())


def test_render_block_sample_limits(dev):
    """The most samples per ray that render_pass.cu and render_loss.cu take,
    from their own shared-memory layout: the wide family at W=256 fits 256
    in fp32 (forward only) and 225 in train mode (B9: the ring block's fp32
    tiles and two buffers of raw lanes, the same in both operand types);
    bf16 forward only, W=128 and the narrow families fit the cap of 1024.
    check_samples refuses beyond."""
    for tnerf, wide in ((0, 0), (1, 0), (0, 1)):
        for bf16 in (0, 1):
            for W in (128, 256):
                want = ((256 if bf16 == 0 else 1024), 225) if (wide, W) == (1, 256) else (1024, 1024)
                got = tuple(b3.max_samples(name, tnerf, bf16, wide, W) for name in ("render_pass", "render_loss"))
                assert got == want, (tnerf, wide, bf16, W)
    assert b3.max_samples("render_pass", 0, 0, 0, 192) == 0  # no such width
    cfg, sd, _, _, _ = _wide_case(dev, "level1", 1, 8)
    packed = b3.pack_params(sd, cfg, torch.float32)
    b3.check_samples(b1.NAME, packed, 225, "render_loss_ext")
    with pytest.raises(ValueError, match="fits 225 at most"):
        b3.check_samples(b1.NAME, packed, 226, "render_loss_ext")


@pytest.mark.parametrize("level", ["level0", "level1"])
def test_b3_wide_bf16_matches_plain(dev, level):
    cfg, sd, pts, (ve, z, dist, _), _ = _wide_case(dev, level, 512, 64)
    packed = b3.pack_params(sd, cfg, torch.bfloat16)
    got = b3.render_pass(packed, None, None, ve, z, dist, None, True, None, pts)
    ref = b3.render_pass_plain(packed, None, None, ve, z, dist, None, True, None, pts)
    torch.cuda.synchronize()
    diff = (got.rgb - ref.rgb).abs()
    assert diff.max().item() <= 1e-2 and diff.mean().item() <= 1e-3


def _b9_grads(grads, dpts, packed):
    return dict(b1.unpack_grads(grads, packed), dpts=dpts)


@pytest.mark.parametrize("level", list(MR_LEVELS))
@pytest.mark.parametrize("n_samples", [8, 64, 192])
@pytest.mark.parametrize("white", [True, False])
def test_b9_fp32_matches_plain(dev, level, n_samples, white):
    """B9 (the external-cotangent backward, narrow at the identity level and
    wide at levels 0-1) against its twin: its recomputed forward bit-equal
    to the B3 launch, the parameter gradients and d pts at B6's fallback
    bar (float64 twin, and on jittered weights)."""
    cfg, sd, pts, args, gct = _wide_case(dev, level, 300, n_samples)
    packed = b3.pack_params(sd, cfg, torch.float32)
    key = b1.ext_launch_key(packed, n_samples)
    before = launches[key]
    fwd, gg, dp = b1.render_loss_ext(packed, pts, *args, gct, white)
    _, gr, dr = b1.render_loss_ext_plain(packed, pts, *args, gct, white)
    b3out = b3.render_pass(packed, None, None, args[0], args[1], args[2], args[3], white, None, pts)
    torch.cuda.synchronize()
    assert launches[key] == before + 1
    for k in ("rgb", "acc", "depth", "weights"):
        assert torch.equal(getattr(fwd, k), getattr(b3out, k)), k
    p64 = dataclasses.replace(packed, weights=packed.weights.double())
    a64 = [x.double() for x in args]
    _, g64, d64 = b1.render_loss_ext_plain(p64, pts.double(), *a64, gct.double(), white)
    _, g64p, d64p = b1.render_loss_ext_plain(dataclasses.replace(p64, weights=_jitter(p64.weights)), pts.double(),
                                             *a64, gct.double(), white)
    _assert_fp32_grads(_b9_grads(gg, dp, packed), _b9_grads(gr, dr, packed), _b9_grads(g64, d64, p64),
                       _b9_grads(g64p, d64p, p64))


@pytest.mark.parametrize("level", ["level0", "level1", "identity"])
def test_b9_bf16_matches_plain_and_repeats(dev, level):
    cfg, sd, pts, args, gct = _wide_case(dev, level, 500, 64)
    packed = b3.pack_params(sd, cfg, torch.bfloat16)
    fwd, gg, dp = b1.render_loss_ext(packed, pts, *args, gct, True)
    _, gg2, dp2 = b1.render_loss_ext(packed, pts, *args, gct, True)
    ref, gr, dr = b1.render_loss_ext_plain(packed, pts, *args, gct, True)
    torch.cuda.synchronize()
    assert (fwd.rgb - ref.rgb).abs().max().item() <= 1e-2
    rel = _rel_l2(_b9_grads(gg, dp, packed), _b9_grads(gr, dr, packed))
    assert max(rel.values()) <= 1e-2, rel
    assert torch.equal(gg[0], gg2[0]) and torch.equal(gg[1], gg2[1]) and torch.equal(dp, dp2)


def test_render_outputs_autograd_on_the_card(dev):
    """render_outputs_autograd launches B3's pts mode forward and B9 as its
    backward (once each) and hands B9's gradients to the parameters and the
    positions; the outputs are B3's, the weights carry no gradient."""
    cfg, sd, pts, (ve, z, dist, noise), gct = _wide_case(dev, "level1", 64, 32)
    leaves = {k: v.clone().requires_grad_(True) for k, v in sd.items()}
    packed = b3.pack_params(leaves, cfg, torch.float32)
    p = pts.clone().requires_grad_(True)
    keys = ("render_pass[pts,wide,S=32]", "render_loss[ext,wide,S=32]")
    before = [launches[k] for k in keys]
    out = b1.render_outputs_autograd(packed, torch.float32, p, ve, z, dist, noise, True)
    loss = (out["rgb"] * gct[:, :3]).sum() + (out["acc"] * gct[:, 3]).sum() + (out["depth"] * gct[:, 4]).sum()
    loss.backward()
    torch.cuda.synchronize()
    assert [launches[k] - b for k, b in zip(keys, before)] == [1, 1] and not out["weights"].requires_grad
    detached = b3.pack_params(sd, cfg, torch.float32)
    _, grads, dpts = b1.render_loss_ext(detached, pts, ve, z, dist, noise, gct, True)
    assert torch.equal(p.grad, dpts)
    for k, v in b1.unpack_grads(grads, detached).items():
        torch.testing.assert_close(leaves[k].grad, v, rtol=1e-6, atol=1e-12)


B10_CASES = {  # n rays, m bins (m + 1 coarse depths), s samples
    "det": (20000, 63, 128), "sorted": (20000, 63, 128), "random": (20000, 63, 128),
    "unsorted_z": (20000, 63, 128), "ragged": (19237, 47, 100), "broadcast_u": (20000, 63, 128),
}


@pytest.mark.parametrize("mode", list(B10_CASES))
def test_b10_matches_b2_and_sort(dev, mode):
    """B10 bit-equal to B2 + torch.sort(torch.cat(...)) and to its twin, for
    linspace (row stride 0), sorted and unsorted uniforms (the sort path),
    unsorted coarse depths, a ragged shape (S = 100, not a multiple of 32;
    48 depths; N not a multiple of the 64 rays a block takes) and one row
    of unsorted uniforms broadcast with row stride 0. A third of the rays
    have zero weights past column 5."""
    n, m, s = B10_CASES[mode]
    g = torch.Generator(device=dev).manual_seed(1)
    z = torch.sort(torch.rand((n, m + 1), generator=g, device=dev) * 4 + 2, -1).values
    bins = (0.5 * (z[:, 1:] + z[:, :-1])).contiguous()
    w = torch.rand((n, m + 1), generator=g, device=dev)
    w[: n // 3, 5:] = 0.0
    u = torch.rand((n, s), generator=g, device=dev)
    if mode == "det":
        u = torch.linspace(0.0, 1.0, s, device=dev).expand(n, s)
    elif mode in ("sorted", "ragged"):
        u = torch.sort(u, -1).values
    elif mode == "unsorted_z":
        u = torch.sort(u, -1).values
        z = torch.gather(z, 1, torch.argsort(torch.rand(z.shape, generator=g, device=dev), -1))
    elif mode == "broadcast_u":
        u = u[:1].expand(n, s)
    assert u.stride(0) == (0 if mode in ("det", "broadcast_u") else s)
    before = launches["sample_pdf_merge"]
    got = b2.sample_pdf_merge(z, bins, w[:, 1:-1], u)
    ref = torch.sort(torch.cat([z, b2.sample_pdf(bins, w[:, 1:-1], u)], -1), -1).values
    torch.cuda.synchronize()
    assert launches["sample_pdf_merge"] == before + 1 and got.shape == (n, m + 1 + s)
    assert torch.equal(got, ref) and torch.equal(got, b2.sample_pdf_merge_plain(z, bins, w[:, 1:-1], u))


@pytest.mark.parametrize("level", list(MR_LEVELS))
def test_b11_fp32_matches_plain(dev, level):
    """fused_time_net_pts(need_input_grads=True): dx bit-equal to B6's
    forward, the parameter gradients, d pts and d times at B6's fallback
    bar; without input grads it launches B6's backward."""
    cfg = DNeRFConfig(**MR_LEVELS[level])
    model = DirectTemporalNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(2), fused=False)
    packed = b6.pack_time_params(model.state_dict(), cfg, torch.float32)
    o, d, _, z, _ = _rays(dev, 300, 64, 3)
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).contiguous()
    times = torch.rand((300,), generator=torch.Generator(device=dev).manual_seed(4), device=dev)
    g = torch.randn(pts.shape, generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    leaf = dataclasses.replace(packed, weights=packed.weights.clone().requires_grad_(True),
                               biases=packed.biases.clone().requires_grad_(True))
    p, t = pts.clone().requires_grad_(True), times.clone().requires_grad_(True)
    before = (launches["time_net[pts,bwd]"], launches["time_net[bwd]"])
    dx = b6.fused_time_net_pts(leaf, p, t, need_input_grads=True)
    (dx * g).sum().backward()
    torch.cuda.synchronize()
    assert (launches["time_net[pts,bwd]"], launches["time_net[bwd]"]) == (before[0] + 1, before[1])
    assert torch.equal(dx.detach(), b6.time_net(packed, pts, times))

    def named(grads, dpts, dtimes, pk):
        return dict(b6.unpack_time_grads(grads, pk), dpts=dpts, dtimes=dtimes)

    ref = b6.time_net_plain_bwd(packed, pts, times, g, True)
    p64 = dataclasses.replace(packed, weights=packed.weights.double())
    r64 = b6.time_net_plain_bwd(p64, pts.double(), times.double(), g.double(), True)
    r64p = b6.time_net_plain_bwd(dataclasses.replace(p64, weights=_jitter(p64.weights)), pts.double(),
                                 times.double(), g.double(), True)
    _assert_fp32_grads(named((leaf.weights.grad, leaf.biases.grad), p.grad, t.grad, packed), named(*ref, packed),
                       named(*r64, p64), named(*r64p, p64))
    x = pts.clone().requires_grad_(True)
    (b6.fused_time_net_pts(leaf, x, times) * g).sum().backward()
    torch.cuda.synchronize()
    assert launches["time_net[bwd]"] == before[1] + 1 and x.grad is None


@pytest.mark.parametrize("level", ["dnerf", "level0"])
def test_b11_bf16_matches_plain_and_repeats(dev, level):
    """bf16 fused_time_net_pts(need_input_grads=True), its dW, dH and demb
    products on the tensor cores at the D-NeRF config's 96-column pad (84
    live) and MultiRes level 0's 144 (140 live), 500 rays x 64: the
    gradients, d pts and d times within rel L2 1e-2 of the bf16 twin, and a
    second run bit-equal."""
    cfg = DNeRFConfig() if level == "dnerf" else DNeRFConfig(**MR_LEVELS["level0"])
    model = DirectTemporalNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(6), fused=False)
    packed = b6.pack_time_params(model.state_dict(), cfg, torch.bfloat16)
    assert packed.cin_pad == (96 if level == "dnerf" else 144)
    o, d, _, z, _ = _rays(dev, 500, 64, 7)
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).contiguous()
    times = torch.rand((500,), generator=torch.Generator(device=dev).manual_seed(8), device=dev)
    g = torch.randn(pts.shape, generator=torch.Generator(device=dev).manual_seed(9), device=dev)
    outs = []
    for _ in range(2):
        leaf = dataclasses.replace(packed, weights=packed.weights.float().requires_grad_(True),
                                   biases=packed.biases.clone().requires_grad_(True))
        p, t = pts.clone().requires_grad_(True), times.clone().requires_grad_(True)
        (b6.fused_time_net_pts(leaf, p, t, True, torch.bfloat16) * g).sum().backward()
        outs.append((leaf.weights.grad, leaf.biases.grad, p.grad, t.grad))
    ref = b6.time_net_plain_bwd(packed, pts, times, g, True)
    torch.cuda.synchronize()
    rel = _rel_l2(dict(b6.unpack_time_grads(outs[0][:2], packed), dpts=outs[0][2], dtimes=outs[0][3]),
                  dict(b6.unpack_time_grads(ref[0], packed), dpts=ref[1], dtimes=ref[2]))
    assert max(rel.values()) <= 1e-2, rel
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_multires_fused_phase2_step_matches_plain_route(dev):
    """One fused phase-2 step (B6, B3's pts mode and B9 on every level, fp32
    operands) against the plain route's step from the same weights and
    draws, at full width on 32/16/8/4-pixel patches: every metric rel 1e-4,
    every level's gradients at the fallback bar (the plain route in float64
    on the CPU as its reference); B9 launches once per level."""
    from swnerf_torch.ops.pyramid import generate_laplacian_pyramid
    from swnerf_torch.pipelines.run_multires import make_phase2_step
    from swnerf_torch.render.core import Draws, RenderConfig, make_draws
    from swnerf_torch.train.loop import init_train_state

    rcfg = RenderConfig(n_samples=16, perturb=1.0, white_bkgd=True)
    levels = ["level0", "level1", "level1", "identity"]
    pairs = [_mr_pair(dev, lv, seed=l) for l, lv in enumerate(levels)]
    size = 64
    pyr_hwf = [[size // 2**l, size // 2**l, 80.0 / 2**l] for l in range(4)]
    patch_sizes = [32, 16, 8, 4]
    g = torch.Generator(device=dev).manual_seed(7)
    images = torch.rand((1, size, size, 3), generator=g, device=dev)
    lap = generate_laplacian_pyramid(images, levels=4)
    pixels = [torch.stack(torch.meshgrid(torch.arange(8 // 2**l, 8 // 2**l + ps, device=dev),
                                         torch.arange(8 // 2**l, 8 // 2**l + ps, device=dev), indexing="ij"), -1)
              .reshape(-1, 2) for l, ps in enumerate(patch_sizes)]
    targets = [lap[l][0, 8 // 2**l : 8 // 2**l + ps, 8 // 2**l : 8 // 2**l + ps] for l, ps in enumerate(patch_sizes)]
    pose = torch.eye(4, device=dev)[:3]
    pose[2, 3] = 4.0
    draws = [make_draws(rcfg, ps * ps, g, dev) for ps in patch_sizes]

    def run(models, device, dtype, fused):
        step = make_phase2_step(rcfg, pyr_hwf, patch_sizes, 2.0, 6.0, fused=fused,
                                compute_dtype=torch.float32 if fused else None)
        states = [init_train_state(m, None, 5e-4, 250) for m in models]
        cast = lambda x: x.to(device=device, dtype=dtype)  # noqa: E731
        m = step(states, [p.to(device) for p in pixels], [cast(t) for t in targets], cast(images[0, 8:40, 8:40]),
                 cast(pose), 0.4, 1.0, draws=[Draws(cast(d.t_rand), None, None, None) for d in draws])
        return m, [{k: p.grad for k, p in s.coarse.named_parameters()} for s in states]

    keys = ["render_loss[ext,wide,S=16]", "render_loss[ext,S=16]"]
    before = [launches[k] for k in keys]
    mk, gk = run([k for k, _ in pairs], dev, torch.float32, True)  # the fused step packs their parameters
    torch.cuda.synchronize()
    assert [launches[k] - b for k, b in zip(keys, before)] == [3, 1]
    mp, gp = run([p for _, p in pairs], dev, torch.float32, False)
    cpu64 = []
    for _, p in pairs:
        m = DirectTemporalNeRF(p.cfg, device="cpu", fused=False)
        m.load_state_dict(p.state_dict())
        cpu64.append(m.double())
    _, g64 = run(cpu64, "cpu", torch.float64, False)
    for key in mk:
        assert mk[key].item() == pytest.approx(mp[key].item(), rel=1e-4), key
    for a, b, c in zip(gk, gp, g64):
        _assert_fp32_grads(a, b, c)


# ---------------------------------------------------------------- the bf16 tensor-core bodies: B6's forward, B3


@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("level", ["level0", "identity"])
@pytest.mark.parametrize("shape", [(37, 7), (3, 43), (129, 64)], ids=["259rows", "129rows", "8256rows"])
def test_b6_tc_bf16_matches_plain_and_train_mode(dev, width, level, shape):
    """B6's bf16 forward (csrc/tc_chunk.cuh) at row counts that fill no
    64- or 128-row chunk, at MultiRes level 0's widths (Lx = 20, Lt = 8: 144
    padded rows) and the identity level (Lx = Lt = 0: 96), W 128 and 256:
    dx within 1e-2 of the bf16 twin, repeats bit-equal, and the
    forward-only launch bit-equal to the train-mode one."""
    n, s = shape
    cfg, sd, pts, times, _ = _dnerf_case(dev, dict(MR_LEVELS[level], netwidth=width), n, s)
    packed = b6.pack_time_params(sd, cfg, torch.bfloat16)
    assert packed.cin_pad == (144 if level == "level0" else 96) and packed.W == width
    g = torch.randn(pts.shape, generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    dx = b6.time_net(packed, pts, times)
    dx2 = b6.time_net(packed, pts, times)
    dx_train, _ = b6.time_net_fwd_bwd(packed, pts, times, g)
    ref = b6.time_net_plain(packed, pts, times)
    torch.cuda.synchronize()
    assert (dx - ref).abs().max().item() <= 1e-2
    assert torch.equal(dx, dx2) and torch.equal(dx, dx_train)


def _b3_tc_case(dev, family, n, s):
    """(packed bf16 field, render_pass arguments) of one B3 family: a vanilla
    field from rays, a D-NeRF canonical field in pts mode, MultiRes level 0's
    in pts mode at the wide pads; noise std 1. A "+ordered" family is the
    training path's launch of the same (the SIMT body)."""
    family = family.split("+")[0]
    if family == "pts_wide":
        cfg, sd, pts, (ve, z, dist, noise), _ = _wide_case(dev, "level0", n, s)
        return b3.pack_params(sd, cfg, torch.bfloat16), (None, None, ve, z, dist, noise), pts
    if family == "pts":
        cfg, sd, pts, _, (ve, z, dist, noise, _) = _dnerf_case(dev, {}, n, s)
        return b3.pack_params(canonical_params(sd), cfg, torch.bfloat16), (None, None, ve, z, dist, noise), pts
    cfg = VanillaNeRFConfig()
    model = VanillaNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(0), fused=False)
    o, d, vd, z, dist = _rays(dev, n, s)
    ve = positional_encoding(vd, cfg.nf_views).contiguous()
    noise = torch.randn(z.shape, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    return b3.pack_params(model.state_dict(), cfg, torch.bfloat16), (o, d, ve, z, dist, noise), None


# (samples per ray, rays): each ray count leaves the last work unit's last
# 128-row chunk partly filled (S=1: 300 rows past two full units; S=63 and
# S=64: one ray of two; S=192: one ray of two, 1.5 chunks; S=1024: whole).
B3_TC_SHAPES = [(1, 300), (63, 41), (64, 41), (192, 21), (1024, 5)]


@pytest.mark.parametrize("family", ["rays", "pts", "pts_wide", "pts+ordered", "pts_wide+ordered"])
@pytest.mark.parametrize("s,n", B3_TC_SHAPES, ids=[f"S{s}" for s, _ in B3_TC_SHAPES])
@pytest.mark.parametrize("white", [True, False])
def test_b3_tc_bf16_matches_plain(dev, family, s, n, white):
    """B3's bf16 body (csrc/tc_render.cuh) in each mode, and the training
    path's ordered pts launch (the SIMT body), up to the 1,024 samples per
    ray every bf16 family takes: rgb within max 1e-2 / mean 1e-3 of the bf16
    twin, acc likewise, and repeats bit-equal."""
    packed, (o, d, ve, z, dist, noise), pts = _b3_tc_case(dev, family, n, s)
    ordered = family.endswith("+ordered")
    got = b3.render_pass(packed, o, d, ve, z, dist, noise, white, None, pts, ordered=ordered)
    again = b3.render_pass(packed, o, d, ve, z, dist, noise, white, None, pts, ordered=ordered)
    ref = b3.render_pass_plain(packed, o, d, ve, z, dist, noise, white, None, pts)
    torch.cuda.synchronize()
    for k in ("rgb", "acc"):
        diff = (getattr(got, k) - getattr(ref, k)).abs()
        assert diff.max().item() <= 1e-2 and diff.mean().item() <= 1e-3, (k, diff.max().item())
    for k in ("rgb", "acc", "depth", "weights"):
        assert torch.equal(getattr(got, k), getattr(again, k)), k


@pytest.mark.parametrize("family", ["pts_wide", "pts"])
@pytest.mark.parametrize("s,n", [(64, 41), (192, 21)], ids=["S64", "S192"])
def test_b9_forward_is_the_training_b3_launch(dev, family, s, n):
    """B9's bf16 forward recompute: its rgb, acc, depth and weights
    bit-equal to the training path's B3 launch (``ordered``, the SIMT body)
    at the wide and the narrow pads, with half-filled chunks; the serving
    launch (tensor cores) differs from it."""
    packed, (_, _, ve, z, dist, noise), pts = _b3_tc_case(dev, family, n, s)
    gct = torch.randn((n, 5), generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    fwd, _, _ = b1.render_loss_ext(packed, pts, ve, z, dist, noise, gct, True)
    out = b3.render_pass(packed, None, None, ve, z, dist, noise, True, None, pts, ordered=True)
    serve = b3.render_pass(packed, None, None, ve, z, dist, noise, True, None, pts)
    torch.cuda.synchronize()
    for k in ("rgb", "acc", "depth", "weights"):
        assert torch.equal(getattr(fwd, k), getattr(out, k)), k
    assert not torch.equal(serve.weights, out.weights)


@pytest.mark.parametrize("s,n", [(64, 41), (192, 21)], ids=["S64", "S192"])
def test_b5_forward_is_the_ordered_b3_launch(dev, s, n):
    """B5's bf16 forward (render_loss_fwd_kernel, the SIMT train-mode body):
    its rgb, acc, depth and weights bit-equal to B3's ordered pts launch (the
    SIMT forward-only body, csrc/render_pass.cu) on the same positions,
    view embeddings and noise, as B9's are."""
    cfg, sd, pts, _, (ve, z, dist, noise, target) = _dnerf_case(dev, {}, n, s)
    packed = b3.pack_params(canonical_params(sd), cfg, torch.bfloat16)
    fwd, _, _ = b1.render_loss_pts(packed, pts, ve, z, dist, noise, target, True, 1.0 / (3 * n))
    out = b3.render_pass(packed, None, None, ve, z, dist, noise, True, None, pts, ordered=True)
    torch.cuda.synchronize()
    for k in ("rgb", "acc", "depth", "weights"):
        assert torch.equal(getattr(fwd, k), getattr(out, k)), k


# ---------------------------------------------------------------- the pyramid's resize


@pytest.mark.parametrize("n_in,n_out", [(25, 50), (50, 100), (100, 200), (200, 100), (25, 12)],
                         ids=["25to50", "50to100", "100to200", "200to100", "25to12"])
def test_pyramid_resize_backward_repeats_on_the_card(dev, n_in, n_out):
    """MultiRes phase 2's resize on the card: the forward bit-equal to
    F.interpolate's, the fixed-order backward bit-equal across two launches
    and within atol 1e-5 / rtol 1e-6 of F.interpolate's own (atomic)
    backward; and the reconstruction's backward at phase 2's four levels
    (200x200, 32 images) bit-equal across two launches."""
    from swnerf_torch.ops import pyramid as tp

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((4, n_in, n_in, 3), generator=g, device=dev)
    ct = torch.randn((4, n_out, n_out, 3), generator=g, device=dev)
    assert torch.equal(tp._resize(x, n_out, n_out), tp._interpolate(x, n_out, n_out))
    grads = []
    for fn in (tp._resize, tp._resize, tp._interpolate):
        xx = x.clone().requires_grad_(True)
        (fn(xx, n_out, n_out) * ct).sum().backward()
        grads.append(xx.grad)
    torch.cuda.synchronize()
    assert torch.equal(grads[0], grads[1])
    torch.testing.assert_close(grads[0], grads[2], atol=1e-5, rtol=1e-6)
    bands = [torch.rand((32, 200 >> i, 200 >> i, 3), generator=g, device=dev) for i in range(4)]
    ct = torch.randn((32, 200, 200, 3), generator=g, device=dev)
    out = []
    for _ in range(2):
        bb = [b.clone().requires_grad_(True) for b in bands]
        (tp.reconstruct_from_pyramid(bb) * ct).sum().backward()
        out.append([b.grad for b in bb])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*out))


# ---------------------------------------------------------------- K steps per dispatch (CUDA-graph replays)

KSTEP_KINDS = ["vanilla", "vanilla_pool", "vanilla_ndc_pool", "tnerf", "dnerf_tv",  # the kernel steps
               "vanilla_eager", "vanilla_warm", "tnerf_eager", "dnerf_eager", "dnerf_plain"]  # the eager steps


def _kstep_case(dev, kind, start=0, steps=12):
    """A fresh train state (seeded weights, ``start`` updates done) and
    ``run(state, j, k, generator, record=None)``, its train step's K-step
    route on rows ``j .. j+k-1`` of ``steps`` rows of host draws made up
    front: a 32 x 32 scene of four random frames, 256 rays a step, perturbed
    depths and density noise (drawn from ``generator``). The kinds: the
    kernel steps; the eager steps with the fields on their kernel routes
    (B7, B7', B6 + B7), run_nerf's fp32 warm step (``_warm``) and the
    D-NeRF's plain fp32 fields (``_plain``); ``vanilla_ndc_pool`` is the
    LLFF pool step, its rays projected to NDC inside the step."""
    from swnerf_torch.pipelines.common import Scene, make_image_scan_step, make_pool_scan_step
    from swnerf_torch.pipelines.run_dnerf import make_dnerf_scan_step
    from swnerf_torch.render.core import RenderConfig
    from swnerf_torch.train.fused_step import make_fused_dnerf_step, make_fused_tnerf_step, make_fused_train_step
    from swnerf_torch.train.loop import init_train_state, make_dnerf_train_step, make_train_step

    eager = kind.endswith(("_eager", "_warm", "_plain"))
    rng = np.random.default_rng(0)
    n, size = 4, 32
    poses = np.stack([np.eye(4, dtype=np.float32) for _ in range(n)])
    poses[:, :3, 3] = rng.standard_normal((n, 3)) * 0.2 + np.array([0.0, 0.0, 4.0])
    images = rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)
    K_ = np.array([[30.0, 0, 0.5 * size], [0, 30.0, 0.5 * size], [0, 0, 1]])
    times = np.linspace(0, 1, n, dtype=np.float32)
    scene = Scene(images=images, poses=poses, render_poses=poses, H=size, W=size, focal=30.0, K=K_, near=2.0,
                  far=6.0, i_train=np.arange(n), i_val=np.arange(0), i_test=np.arange(0), times=times)
    img_i = rng.integers(0, n, (steps,)).astype(np.int64)
    pixels = rng.integers(0, size, (steps, 256, 2)).astype(np.int64)
    neighbor = rng.uniform(0, 1, (steps,)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    images_d, poses_d, times_d = (torch.from_numpy(x).to(dev) for x in (images, poses[:, :3, :4], times))
    if kind.startswith("vanilla"):
        cfg = VanillaNeRFConfig(netdepth=6, netwidth=128, skips=(4,), multires=10, multires_views=4)
        rcfg = RenderConfig(n_samples=32, n_importance=64, perturb=1.0, white_bkgd=True, raw_noise_std=1.0)
        if kind == "vanilla_ndc_pool":  # the LLFF step: NDC rays inside the step, 64 + 64 samples, no background
            rcfg = RenderConfig(n_samples=64, n_importance=64, perturb=1.0, white_bkgd=False, raw_noise_std=1.0)
            scene = dataclasses.replace(scene, ndc=True, near=0.0, far=1.0)
        state = init_train_state(VanillaNeRF(cfg, device=dev, generator=gen),
                                 VanillaNeRF(cfg, device=dev, generator=gen), 5e-4, 250, step=start,
                                 graphs=True)
        step = make_fused_train_step(cfg, rcfg, fcfg=cfg) if not eager else make_train_step(
            rcfg, compute_dtype=torch.float32 if kind == "vanilla_warm" else None)
        if kind.endswith("_pool"):
            pool = torch.from_numpy(rng.standard_normal((4096, 3, 3)).astype(np.float32)).to(dev)
            pool[:, 0] = pool[:, 0] * 0.2 + torch.tensor([0.0, 0.0, 4.0], device=dev)
            pool[:, 1, 2] = -pool[:, 1, 2].abs() - 1.0
            pool[:, 2] = pool[:, 2].abs().clamp(max=1.0)
            idx = rng.integers(0, 4096, (steps, 256)).astype(np.int64)
            fn = make_pool_scan_step(step, rcfg, scene)
            return state, lambda st, j, k, g, record=None: fn(st, pool, idx[j:j + k], g, record)
        fn = make_image_scan_step(step, rcfg, scene)
        return state, lambda st, j, k, g, record=None: fn(
            st, images_d, poses_d, img_i[j:j + k], pixels[j:j + k], g, record)
    if kind == "tnerf":
        cfg = TNeRFConfig(**TNERF_SMALL)
        rcfg = RenderConfig(n_samples=64, perturb=1.0, white_bkgd=True, raw_noise_std=1.0)
        state = init_train_state(TNeRF(cfg, device=dev, generator=gen), None, 5e-4, 250, step=start, graphs=True)
        step = make_train_step(rcfg) if eager else make_fused_tnerf_step(cfg, rcfg)
        fn = make_dnerf_scan_step(step, rcfg, scene, pass_neighbor=False)
    else:
        cfg = DNeRFConfig(netdepth=6, netwidth=128, skips=(4,), multires=10, multires_views=4)
        rcfg = RenderConfig(n_samples=32, n_importance=32, perturb=1.0, white_bkgd=True, raw_noise_std=1.0)
        model = DirectTemporalNeRF(cfg, device=dev, generator=gen, fused=False if kind == "dnerf_plain" else None)
        state = init_train_state(model, None, 5e-4, 250, step=start, graphs=True)
        step = make_dnerf_train_step(rcfg, True, 1e-2) if eager else make_fused_dnerf_step(
            cfg, rcfg, add_tv_loss=True, tv_loss_weight=1e-2)
        fn = make_dnerf_scan_step(step, rcfg, scene)
    return state, lambda st, j, k, g, record=None: fn(
        st, images_d, poses_d, times_d, img_i[j:j + k], pixels[j:j + k], neighbor[j:j + k], g, record)


def _train_state_tensors(state):
    out = {f"{i}.{k}": v for i, m in enumerate(state.modules()) for k, v in m.state_dict().items()}
    for p, st in state.optimizer.state.items():
        for k, v in st.items():
            out[f"adam.{id(p)}.{k}"] = v
    return list(out.values())


@pytest.mark.parametrize("kind", KSTEP_KINDS)
def test_kstep_replays_equal_uncaptured_steps(dev, kind):
    """Seven train steps as one chunk (the first uncaptured, then a capture
    replayed six times) and as seven one-step chunks (never captured) from
    the same state, draws and generator seed: parameters, Adam's moments and
    counts, the device count, the host step, each step's metrics and the
    launch counts bit-equal. A further chunk of three replays the same
    graph and stays equal. The eager steps' torch ops (cuBLAS products,
    ``torch.sort``, the composite) give the same bits captured."""
    runs = []
    for chunks in ((7, 3), (1,) * 10):
        state, run = _kstep_case(dev, kind, start=5)
        g = torch.Generator(device=dev).manual_seed(11)
        launches.clear()
        metrics, j = [], 0
        for k in chunks:
            m = run(state, j, k, g)
            metrics.append({key: v.clone() for key, v in m.items()})
            j += k
        torch.cuda.synchronize()
        runs.append((state, metrics, dict(launches), g.get_state()))
    (sa, ma, la, ga), (sb, mb, lb, gb) = runs
    assert sa.step == sb.step == 15 and int(sa.count) == int(sb.count) == 15
    assert all(torch.equal(a, b) for a, b in zip(_train_state_tensors(sa), _train_state_tensors(sb)))
    for a, b in ((ma[0], mb[6]), (ma[1], mb[9])):
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert la == lb and sum(la.values()) > 0
    assert torch.equal(ga, gb)


def test_device_lr_follows_the_schedule(dev):
    """Each captured step's learning rate is exp_decay_schedule at the
    update count, rounded to fp32, from a resumed count of 123,456."""
    from swnerf_torch.train.loop import exp_decay_schedule

    state, run = _kstep_case(dev, "vanilla", start=123456)
    lrs = []
    g = torch.Generator(device=dev).manual_seed(1)
    run(state, 0, 6, g, lambda j: lrs.append(state.lr.clone()))
    run(state, 6, 3, g, lambda j: lrs.append(state.lr.clone()))
    torch.cuda.synchronize()
    sched = exp_decay_schedule(5e-4, 250)
    want = [torch.tensor(sched(123456 + j), dtype=torch.float32) for j in range(9)]
    assert all(torch.equal(a.cpu(), b) for a, b in zip(lrs, want)) and len(lrs) == 9
    assert state.step == 123465 and int(state.count) == 123465


def test_launches_count_each_replay(dev):
    """launches counts what the graph launches: each replay adds the counts
    its capture recorded (B1 twice and B2 once a vanilla kernel step), and
    the device runs, by torch.profiler's trace, the same kernels of the
    port in four replays as in four uncaptured steps."""
    from torch.profiler import ProfilerActivity, profile

    from swnerf_torch.ops.kernels import traced_launches

    state, run = _kstep_case(dev, "vanilla")
    g = torch.Generator(device=dev).manual_seed(1)
    launches.clear()
    run(state, 0, 5, g)
    assert dict(launches) == {"render_loss[S=32]": 5, "render_loss[S=96]": 5, "sample_pdf": 5}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as replays:
        run(state, 5, 4, g)
        torch.cuda.synchronize()
    assert dict(launches) == {"render_loss[S=32]": 9, "render_loss[S=96]": 9, "sample_pdf": 9}
    plain, run_plain = _kstep_case(dev, "vanilla")
    for j in range(5):
        run_plain(plain, j, 1, g)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as steps:
        for j in range(5, 9):
            run_plain(plain, j, 1, g)
        torch.cuda.synchronize()
    traced = traced_launches(replays.key_averages())
    assert traced == traced_launches(steps.key_averages())
    assert traced["sample_pdf_kernel"] == 4 and sum(traced.values()) >= 12


def test_resumed_capturable_adam_moves_its_counts_to_the_card(dev, tmp_path):
    """A checkpoint's Adam state (counts on the CPU, a float learning rate,
    torch's default Adam) loads into a trainer's fused, capturable Adam on
    the card: the counts on the card, the groups reading the device
    learning rate."""
    from swnerf_torch.train.checkpoint import load_tar, save_tar

    state, run = _kstep_case(dev, "vanilla", start=40)
    run(state, 0, 2, torch.Generator(device=dev).manual_seed(1))
    sd = state.optimizer.state_dict()
    for group in sd["param_groups"]:
        group["lr"], group["capturable"], group["fused"] = 1e-3, False, None
    save_tar(str(tmp_path / "x.tar"), {"optimizer_state_dict": sd})
    fresh, run_fresh = _kstep_case(dev, "vanilla", start=0)
    fresh.optimizer.load_state_dict(load_tar(str(tmp_path / "x.tar"))["optimizer_state_dict"])
    fresh.set_step(42)
    for group in fresh.optimizer.param_groups:
        assert group["capturable"] and group["fused"] and group["lr"] is fresh.lr
        assert all(fresh.optimizer.state[p]["step"].device.type == "cuda" for p in group["params"])
    assert int(fresh.count) == 42
    run_fresh(fresh, 0, 3, torch.Generator(device=dev).manual_seed(1))  # an uncaptured step, then replays
    assert int(fresh.count) == fresh.step == 45
    assert all(float(fresh.optimizer.state[p]["step"]) == 5 for p in fresh.optimizer.param_groups[0]["params"])
    assert all(torch.isfinite(p).all() for p in fresh.coarse.parameters())


# ---------------------------------------------------------------- the LLFF path's shapes (NDC rays)


def _ndc_rays(dev, n, seed=0):
    """Rays of a forward-facing camera (a 504 x 504 frame, focal 453.6)
    projected to NDC as the LLFF path projects them: near 0, far 1, and 64
    depths each, jittered."""
    from swnerf_torch.ops.rays import ndc_rays
    from swnerf_torch.ops.sampling import sample_along_rays

    g = torch.Generator(device=dev).manual_seed(seed)
    pix = torch.rand((n, 2), generator=g, device=dev) * 504
    d = torch.stack([(pix[:, 1] - 252) / 453.6, -(pix[:, 0] - 252) / 453.6, -torch.ones(n, device=dev)], -1)
    o = torch.randn((n, 3), generator=g, device=dev) * 0.1
    vd = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o, d = ndc_rays(504, 504, 453.6, 1.0, o, d)
    z = sample_along_rays(torch.zeros(n, device=dev), torch.ones(n, device=dev), 64, 1.0, generator=g)
    return o.contiguous(), d.contiguous(), vd, z.contiguous(), g


def _ndc_fine_z(dev, packed, o, d, ve, z, g):
    """The fine pass's 64 + 64 depths: B2 on the coarse twin's weights."""
    from swnerf_torch.ops.sampling import merge_z_vals

    w = b3.render_pass_plain(packed, o, d, ve, z, _dists(z, d), None, False).weights
    u = torch.rand((z.shape[0], 64), generator=g, device=dev)
    return merge_z_vals(z, b2.sample_pdf((0.5 * (z[:, 1:] + z[:, :-1])).contiguous(), w[:, 1:-1], u)).contiguous()


def _dists(z, d):
    from swnerf_torch.render.fused_eval import _dists_scaled

    return _dists_scaled(z, d).contiguous()


def test_b2_ndc_64_samples_bit_exact(dev):
    """B2 at the LLFF path's 63 bins -> 64 samples on NDC depths, linspace
    (serving) and random (training) u: bit-equal to its twin."""
    n = 20000
    _, _, _, z, g = _ndc_rays(dev, n)
    bins = (0.5 * (z[:, 1:] + z[:, :-1])).contiguous()
    w64 = torch.rand((n, 64), generator=g, device=dev)
    w64[: n // 4, 20:] = 0.0
    for u in (torch.linspace(0.0, 1.0, 64, device=dev).expand(n, 64), torch.rand((n, 64), generator=g, device=dev)):
        got, ref = b2.sample_pdf(bins, w64[:, 1:-1], u), b2.sample_pdf_plain(bins, w64[:, 1:-1], u)
        torch.cuda.synchronize()
        assert _same_bits(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [32768, 24640], ids=["chunk", "ragged"])
def test_b3_ndc_s128_matches_plain(dev, dtype, n):
    """B3 from rays at S = 64 and 128 (64 + 64) on NDC rays, at the serving
    chunk and the ragged last chunk of a 504 x 504 frame: fp32 atol 1e-4 on
    rgb / acc and rtol 1e-4 on depth; bf16 mean |drgb| <= 1e-3 over every
    ray and max |drgb| <= 1e-2 over the rays whose last sample did not flip.
    The last interval is 1e10 long, so there a density of +1e-5 or -1e-5
    makes the sample opaque or empty; bf16 rounding moves such a density
    across 0 (the bf16 twin against the fp32 twin: 66 of 32,768 rays of
    seed 0's coarse net, up to 0.55 in rgb; the kernel against the bf16
    twin: 2), on NDC and Blender rays alike (ROADMAP.md Queue C). A flip
    (the last weight moved by more than 0.5) must sit at the kink (the
    twin's last density within 1e-3 of 0) and stay under 0.1% of the
    rays."""
    cfg = VanillaNeRFConfig()
    coarse, fine = (VanillaNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(s), fused=False)
                    for s in (0, 1))
    o, d, vd, z, g = _ndc_rays(dev, n)
    ve = positional_encoding(vd, cfg.nf_views).contiguous()
    zf = _ndc_fine_z(dev, b3.pack_params(coarse.state_dict(), cfg, torch.float32), o, d, ve, z, g)
    for model, zz in ((coarse, z), (fine, zf)):
        S = zz.shape[1]
        packed = b3.pack_params(model.state_dict(), cfg, dtype)
        before = launches[f"render_pass[S={S}]"]
        got = b3.render_pass(packed, o, d, ve, zz, _dists(zz, d), None, False)
        ref = b3.render_pass_plain(packed, o, d, ve, zz, _dists(zz, d), None, False)
        torch.cuda.synchronize()
        assert launches[f"render_pass[S={S}]"] == before + 1
        if dtype == torch.float32:
            torch.testing.assert_close(got.rgb, ref.rgb, atol=1e-4, rtol=0)
            torch.testing.assert_close(got.acc, ref.acc, atol=1e-4, rtol=0)
            torch.testing.assert_close(got.depth, ref.depth, atol=1e-5, rtol=1e-4)
        else:
            diff = (got.rgb - ref.rgb).abs()
            last = b3.field_forward(packed, o, d, ve, zz, None, None).sigma.reshape(n, S)[:, -1]
            flip = (got.weights[:, -1] - ref.weights[:, -1]).abs() > 0.5
            assert diff.mean().item() <= 1e-3 and diff[~flip].max().item() <= 1e-2, S
            assert flip.sum().item() <= n // 1000 and bool((last[flip].abs() < 1e-3).all()), S


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b1_ndc_s128_matches_plain(dev, dtype):
    """B1 in train mode on a fern step's shape (1,024 NDC rays, noise std 1,
    no background) at S = 64 and 128: fp32 at the output bars and the fp32
    gradient bar (with the float64 fallback), bf16 rgb max 1e-2 / mean
    1e-3 and gradients rel L2 1e-2; two launches give bit-equal
    gradients."""
    cfg = VanillaNeRFConfig()
    coarse, fine = (VanillaNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(s), fused=False)
                    for s in (2, 3))
    n = 1024
    o, d, vd, z, g = _ndc_rays(dev, n, seed=1)
    ve = positional_encoding(vd, cfg.nf_views).contiguous()
    zf = _ndc_fine_z(dev, b3.pack_params(coarse.state_dict(), cfg, torch.float32), o, d, ve, z, g)
    target = torch.rand((n, 3), generator=g, device=dev)
    scale = 1.0 / (3 * n)
    for model, zz in ((coarse, z), (fine, zf)):
        packed = b3.pack_params(model.state_dict(), cfg, dtype)
        noise = torch.randn(zz.shape, generator=g, device=dev)
        args = (o, d, ve, zz, _dists(zz, d), noise, target)
        before = launches[f"render_loss[S={zz.shape[1]}]"]
        got, gg = b1.render_loss(packed, *args, False, scale)
        ref, gr = b1.render_loss_plain(packed, *args, False, scale)
        _, gg2 = b1.render_loss(packed, *args, False, scale)
        torch.cuda.synchronize()
        assert launches[f"render_loss[S={zz.shape[1]}]"] == before + 2
        assert torch.equal(gg[0], gg2[0]) and torch.equal(gg[1], gg2[1])
        if dtype == torch.float32:
            torch.testing.assert_close(got.rgb, ref.rgb, atol=1e-4, rtol=0)
            torch.testing.assert_close(got.acc, ref.acc, atol=1e-4, rtol=0)
            torch.testing.assert_close(got.depth, ref.depth, atol=1e-5, rtol=1e-4)
            torch.testing.assert_close(got.sqerr, ref.sqerr, atol=1e-7, rtol=1e-4)
            p64 = dataclasses.replace(packed, weights=packed.weights.double())
            _, g64 = b1.render_loss_plain(p64, *(x.double() for x in args), False, scale)
            _assert_fp32_grads(b1.unpack_grads(gg, packed), b1.unpack_grads(gr, packed), b1.unpack_grads(g64, p64))
        else:
            diff = (got.rgb - ref.rgb).abs()
            assert diff.max().item() <= 1e-2 and diff.mean().item() <= 1e-3
            rel = _rel_l2(b1.unpack_grads(gg, packed), b1.unpack_grads(gr, packed))
            assert max(rel.values()) <= 1e-2, rel


def test_kstep_ndc_pool_k20_equals_one_step_dispatches(dev):
    """The LLFF pool step (NDC rays inside the captured step) as one chunk
    of 20 (one uncaptured step, a capture, 19 replays) and as 20 one-step
    chunks from the same state, draws and generator: parameters, Adam, the
    counts, the last metrics and the launches bit-equal."""
    runs = []
    for chunks in ((20,), (1,) * 20):
        state, run = _kstep_case(dev, "vanilla_ndc_pool", steps=20)
        g = torch.Generator(device=dev).manual_seed(11)
        launches.clear()
        j = 0
        for k in chunks:
            m = run(state, j, k, g)
            j += k
        torch.cuda.synchronize()
        runs.append((state, {key: v.clone() for key, v in m.items()}, dict(launches)))
    (sa, ma, la), (sb, mb, lb) = runs
    assert sa.step == sb.step == 20 and int(sa.count) == int(sb.count) == 20
    assert all(torch.equal(a, b) for a, b in zip(_train_state_tensors(sa), _train_state_tensors(sb)))
    assert set(ma) == set(mb) and all(torch.equal(ma[k], mb[k]) for k in ma)
    assert la == lb == {"render_loss[S=64]": 20, "render_loss[S=128]": 20, "sample_pdf": 20}


# ---------------------------------------------------------------- the native snapshot and LPIPS on the card


def test_native_round_trip_of_a_capturable_adam_state(dev, tmp_path):
    """A trainer's state on the card (fused, capturable Adam, its counts and
    learning rate on the device) three K-step updates in: its native
    snapshot restores into a fresh state with the same weights, moments and
    counts bit for bit, the counts on the card and the groups reading the
    device learning rate; three more steps from each give the same bits."""
    from swnerf_torch.train import checkpoint as ck

    state, run = _kstep_case(dev, "vanilla", start=40)
    run(state, 0, 3, torch.Generator(device=dev).manual_seed(1))
    path = str(tmp_path / "000043.msgpack")
    ck.save_native(path, ck.native_state(state), {"global_step": state.step})
    fresh, _ = _kstep_case(dev, "vanilla", start=0)
    saved, extra = ck.load_native(path, ck.native_state(fresh), {"global_step": 0})
    ck.restore_native_state(fresh, saved, int(extra["global_step"]))
    assert fresh.step == int(fresh.count) == 43
    assert all(torch.equal(a, b) for a, b in zip(_train_state_tensors(state), _train_state_tensors(fresh)))
    for group in fresh.optimizer.param_groups:
        assert group["capturable"] and group["fused"] and group["lr"] is fresh.lr
        assert all(fresh.optimizer.state[p]["step"].device.type == "cuda" for p in group["params"])
    for st in (state, fresh):
        _, run = _kstep_case(dev, "vanilla", start=0)
        run(st, 3, 3, torch.Generator(device=dev).manual_seed(2))
    assert all(torch.equal(a, b) for a, b in zip(_train_state_tensors(state), _train_state_tensors(fresh)))


@pytest.mark.parametrize("net,size", [("alex", 400), ("vgg", 128)])
def test_lpips_on_the_card_against_the_cpu(dev, tmp_path, net, size):
    """LPIPS on seeded weights on the card within 1e-4 of the CPU's (TF32
    off: fp32 convolutions on both)."""
    from swnerf_torch.utils import lpips as lpips_torch

    convs, feature_idx, taps, _ = lpips_torch.NETS[net]
    g = torch.Generator().manual_seed(0)
    sd = {}
    for (cin, cout, k, _, _), fi in zip(convs, feature_idx):
        sd[f"features.{fi}.weight"] = torch.randn((cout, cin, k, k), generator=g) * (2.0 / (cin * k * k)) ** 0.5
        sd[f"features.{fi}.bias"] = torch.randn((cout,), generator=g) * 0.01
    bb, ln = lpips_torch.NET_FILES[net]
    torch.save(sd, str(tmp_path / bb))
    torch.save({f"lin{i}.model.1.weight": torch.rand((1, convs[t][1], 1, 1), generator=g) for i, t in enumerate(taps)},
               str(tmp_path / ln))
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = lpips_torch.LPIPS(net, weights_dir=str(tmp_path), device=dev).score(a, b)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    want = lpips_torch.LPIPS(net, weights_dir=str(tmp_path), device="cpu").score(a, b)
    assert want > 0 and abs(got - want) <= 1e-4, (got, want)


@pytest.mark.parametrize("kind", ["vanilla", "vanilla_raw", "dnerf", "tnerf", "vanilla_fine"])
def test_fused_export_launches_the_kernels(dev, kind, monkeypatch):
    """A fused artifact (seeded fields, bf16 operands as export_model's
    --export_fused builds them) on the card: its graph calls the swnerf::
    ops (``vanilla_fine``: with a fine pass, whose resample is B2), each
    call launches its kernel (counted in ``launches``), and its
    render is the eager kernel route's bit for bit (NaN where NaN); on the
    CPU the same artifact runs the twins."""
    from swnerf_torch.pipelines.export_model import export_fields
    from swnerf_torch.render.core import Rays, RenderConfig, render_rays
    from swnerf_torch.utils.export import export_renderer, kernel_ops, load_renderer

    monkeypatch.setenv("SWNERF_FUSED_RAW", "1" if kind == "vanilla_raw" else "0")
    g = torch.Generator(device=dev).manual_seed(0)
    if kind.startswith("vanilla"):
        field = VanillaNeRF(VanillaNeRFConfig(netdepth=4, netwidth=128, skips=(1,), multires=6, multires_views=2),
                            device=dev, generator=g)
        keys = {"trunk[raw]" if kind == "vanilla_raw" else "trunk": 1}
        if kind == "vanilla_fine":
            keys = {"trunk": 2, "sample_pdf": 1}
    elif kind == "dnerf":
        field = DirectTemporalNeRF(DNeRFConfig(netdepth=4, netwidth=128, skips=(1,), multires=6, multires_views=2),
                                   device=dev, generator=g)
        keys = {"time_net": 1, "trunk": 1}
    else:
        field = TNeRF(TNeRFConfig(netdepth=6, net_dim=128, skip_layer=4, multires=6, multires_views=2), device=dev,
                      generator=g)
        keys = {"trunk[tnerf]": 1}
    (fused,) = [f for f in export_fields(field, None, True, dev) if f is not None]
    fine = field if kind == "vanilla_fine" else None  # the coarse architecture on the same params
    rcfg = RenderConfig(n_samples=16, n_importance=16 if fine is not None else 0, white_bkgd=True)
    n = 1000
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g, device=dev), dim=-1)
    o = torch.zeros((n, 3), device=dev)
    o[:, 2] = 4.0
    t = torch.rand((n, 1), generator=g, device=dev)
    rays = Rays(o, d, d, torch.full((n,), 2.0, device=dev), torch.full((n,), 6.0, device=dev),
                t if kind in ("dnerf", "tnerf") else None)
    params = {"coarse": {k: p.detach() for k, p in field.named_parameters()}, "fine": None}
    params["fine"] = None if fine is None else params["coarse"]
    art = load_renderer(export_renderer(fused, params, rcfg, n, platforms=["cpu", "cuda"]))
    assert set(kernel_ops(art.program("cuda"))) == {f"swnerf.{k.split('[')[0]}.default" for k in keys}
    call = (lambda r, p: art(p, r.origins, r.directions, r.viewdirs, r.near, r.far,
                             *(() if r.times is None else (r.times,))))
    launches.clear()
    got = call(rays, params)
    torch.cuda.synchronize()
    assert dict(launches) == keys
    with torch.no_grad():
        want = render_rays(field, rays, rcfg.eval_mode(), fine_model=fine)  # the field's own kernel route (bf16)
    for k, a in zip(("rgb", "disp", "acc", "depth"), got):
        b = want[k]
        assert bool(torch.all((a == b) | (torch.isnan(a) & torch.isnan(b)))), k
    cpu_params = {k: None if p is None else {n: v.cpu() for n, v in p.items()} for k, p in params.items()}
    cpu = call(Rays(*(None if x is None else x.cpu() for x in rays)), cpu_params)
    assert (cpu[0] - got[0].cpu()).abs().max().item() <= 2e-2  # the twins at bf16 against the tensor cores
