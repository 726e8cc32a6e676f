"""What the tensor-core reverse sweep of B1 and B6 should give, on the CPU.

``csrc/tc_gemm.cuh`` runs bf16 B1's and B6's backward products on the
tensor cores, which add each k16 step to an fp32 sum rounded toward zero
(``swnerf_torch/ops/kernels/tc_model.py``, the model ``tc_rounding.py``
holds against the card). Here the bf16 twins' backward runs on that model
at D=8, W 128 and 256, a few hundred rows, seeds 0-3, from the twins' own
forward: its gradients must land within rel L2 2e-3 of the twins' (the
card's bar is 1e-2). The control: the same model on the *forward* (as the
tensor-core forward B9 once had), with the twin's backward, lands further
from the twin than the backward on the model does, because a rounding
flip in a stored activation moves a ReLU mask for the whole sweep. That is
why the forwards stay on the SIMT body. Torch only; no card, no JAX.
"""

import numpy as np
import pytest
import torch

from swnerf_torch.models import DirectTemporalNeRF, DNeRFConfig, VanillaNeRF, VanillaNeRFConfig
from swnerf_torch.ops.embedding import positional_encoding
from swnerf_torch.ops.kernels import render_loss as b1
from swnerf_torch.ops.kernels import render_pass as b3
from swnerf_torch.ops.kernels import tc_model
from swnerf_torch.ops.kernels import time_net as b6

BAR = 2e-3


def _rel_l2(got, ref):
    return {k: ((got[k].double() - ref[k].double()).norm() / ref[k].double().norm().clamp_min(1e-300)).item()
            for k in ref}


def _b1_inputs(width, seed, n=10, s=30):
    """A seeded bf16 vanilla field (D=8, skip 4, multires 10 / 4) and the
    twin's forward tape on n x s jittered samples, with the raw cotangent of
    the squared error (noise std 1: the sigma > 0 mask is exercised)."""
    cfg = VanillaNeRFConfig(netwidth=width)
    model = VanillaNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(seed), fused=False)
    packed = b3.pack_params(model.state_dict(), cfg, torch.bfloat16)
    rng = np.random.default_rng(seed)
    o = torch.from_numpy(rng.normal(0.0, 0.3, (n, 3)) + [0.0, 0.0, 4.0]).float()
    d = torch.from_numpy(rng.normal(0.0, 1.0, (n, 3))).float()
    d[:, 2] = -d[:, 2].abs() - 1.0
    z = torch.from_numpy(np.sort(rng.uniform(2.0, 6.0, (n, s)), -1)).float()
    dist = torch.cat([z[:, 1:] - z[:, :-1], torch.full((n, 1), 1e10)], -1) * torch.linalg.norm(d, dim=-1, keepdim=True)
    ve = positional_encoding(d / torch.linalg.norm(d, dim=-1, keepdim=True), cfg.nf_views)
    noise = torch.from_numpy(rng.normal(0.0, 1.0, (n, s))).float()
    target = torch.from_numpy(rng.uniform(0.0, 1.0, (n, 3))).float()
    fwd = b3.field_forward(packed, o, d, ve, z)
    args = (z, dist, noise, True, target, 1.0 / (3 * n))
    _, graw = tc_model.composite(fwd.sigma, fwd.logits, *args)
    return packed, fwd, graw.float(), args


@pytest.mark.parametrize("mode", ["rz", "rn", "exact"])
def test_product_model_one_step_and_chain(mode):
    """One k16 step is the exact sum of 16 bf16 products rounded once in the
    mode; a chain of 64 steps stays within one fp32 ulp a step of the exact
    sum; rz never rounds away from zero."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(32, 1024))).to(torch.bfloat16).double()
    b = torch.from_numpy(rng.normal(size=(1024, 24))).to(torch.bfloat16).double()
    exact = a[:, :16] @ b[:16]
    one = tc_model.product(a[:, :16], b[:16], None, mode)
    want = exact if mode == "exact" else tc_model.rnd32(exact, mode)
    assert torch.equal(one, want)
    if mode == "rz":
        assert bool((one.abs() <= exact.abs()).all())
    chain, ref = tc_model.product(a, b, None, mode), a @ b
    bound = 64 * tc_model.ulp32(ref.abs() + (a.abs() @ b.abs()))
    assert bool(((chain - ref).abs() <= bound).all())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("width", [128, 256])
def test_b1_sweep_on_the_tensor_core_model_holds_the_twin(width, seed):
    """bf16 B1's reverse sweep with its large products on the rz model
    against the twin's (render_loss.field_reverse_plain) on the same tape."""
    packed, fwd, graw, _ = _b1_inputs(width, seed)
    ref, _, _ = b1.field_reverse_plain(packed, fwd.emb, fwd.vemb, fwd.hs, fwd.feat, fwd.hv, graw)
    got = tc_model.sweep_field(packed, fwd.emb, fwd.vemb, fwd.hs, fwd.feat, fwd.hv, graw, "rz")
    rel = _rel_l2(b1.unpack_grads(tuple(x.float() for x in got), packed), b1.unpack_grads(ref, packed))
    assert max(rel.values()) <= BAR, rel
    exact = tc_model.sweep_field(packed, fwd.emb, fwd.vemb, fwd.hs, fwd.feat, fwd.hv, graw, "exact")
    rel_exact = _rel_l2(b1.unpack_grads(tuple(x.float() for x in exact), packed), b1.unpack_grads(ref, packed))
    assert max(rel_exact.values()) <= BAR, rel_exact  # the twin's fp32 sums are that close to exact ones


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("width", [128, 256])
def test_b6_sweep_on_the_tensor_core_model_holds_the_twin(width, seed):
    """bf16 B6's backward (no input cotangents) with its trunk's products on
    the rz model against time_net_plain_bwd, D=8 at D-NeRF's encoding
    (84 of 96 input rows), 12 rays x 25 samples."""
    cfg = DNeRFConfig(netwidth=width)
    model = DirectTemporalNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(seed), fused=False)
    packed = b6.pack_time_params(model.state_dict(), cfg, torch.bfloat16)
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.uniform(-1.5, 1.5, (12, 25, 3))).float()
    times = torch.from_numpy(rng.uniform(0.0, 1.0, 12)).float()
    g = torch.from_numpy(rng.normal(size=(12, 25, 3))).float()
    ref = b6.time_net_plain_bwd(packed, pts, times, g)
    emb, hs, _ = b6._forward(packed, pts, times)
    got = tc_model.sweep_time_net(packed, emb, hs, g, "rz")
    rel = _rel_l2(b6.unpack_time_grads(tuple(x.float() for x in got), packed), b6.unpack_time_grads(ref, packed))
    assert max(rel.values()) <= BAR, rel


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_on_the_model_lands_further_than_the_backward(seed):
    """The control, at multires 10 (D=8, W=256): the forward on the rz model
    (stored activations, feat, hv, sigma and the logits all from it) run
    through the twin's composite and backward lands further from the twin's
    gradients than the backward on the model from the twin's forward."""
    packed, fwd, graw, args = _b1_inputs(256, seed, n=12, s=32)
    ref, _, _ = b1.field_reverse_plain(packed, fwd.emb, fwd.vemb, fwd.hs, fwd.feat, fwd.hv, graw)
    ref = b1.unpack_grads(ref, packed)
    bwd = tc_model.sweep_field(packed, fwd.emb, fwd.vemb, fwd.hs, fwd.feat, fwd.hv, graw, "rz")
    d_bwd = max(_rel_l2(b1.unpack_grads(tuple(x.float() for x in bwd), packed), ref).values())
    hs, feat, hv, sigma, logits = tc_model.field_forward_model(packed, fwd.emb, fwd.vemb, "rz")
    _, graw_m = tc_model.composite(sigma, logits, *args)
    fw, _, _ = b1.field_reverse_plain(packed, fwd.emb, fwd.vemb, [h.float() for h in hs], feat.float(), hv.float(),
                                      graw_m.float())
    d_fwd = max(_rel_l2(b1.unpack_grads(fw, packed), ref).values())
    assert d_fwd > d_bwd, (d_fwd, d_bwd)
