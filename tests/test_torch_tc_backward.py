"""What the tensor-core reverse sweep of B1, B4, B5, B6, B7, B7', B8, B9
and B11 should give, on the CPU.

``csrc/tc_gemm.cuh`` runs bf16 B1's, B4's, B5's, B6's, B7's and B9's
backward products (the input cotangent demb of B5, B7 and B9 too) on the
tensor cores, which add each k16 step to an fp32 sum rounded toward zero
(``swnerf_torch/ops/kernels/tc_model.py``, the model ``tc_rounding.py``
holds against the card). Here the bf16 twins' backward runs on that model
at D=8, W 128 and 256 (B4: the T-NeRF at W=128, 84 of 96 input columns,
ELU; B5: the D-NeRF canonical field, 63 of 64 input columns, demb carried
to d pts; B7 and B9: MultiRes levels 0, 1 and identity at W=256), a few
hundred rows, seeds 0-3, from the twins' own forward: its gradients (and
demb, d pts) must land within rel L2 2e-3 of the twins' (B5: 3e-3; the
card's bar is 1e-2). The control: the same model on the *forward* (as the
tensor-core forward B9 once had), with the twin's backward, lands further
from the twin than the backward on the model does, because a rounding
flip in a stored activation moves a ReLU mask for the whole sweep. So a
forward moves onto the tensor cores only where the forward, the composite
and the sweep all on the model still hold half the card's bar: B1 (W 128
and 256) and B4 here, within 5e-3 of the twin's gradients, which is why
their train-mode forwards run csrc/tc_render.cuh's body in bf16 (B5's
lands 1.04e-2 on the card's model, tc_rounding.py, and stays SIMT). B7
and B8 on the training path's case (raw through the composite): each with
its SIMT forward (the twin's) and its backward with demb and dvemb on the
model within 5e-3 (B8 at 10 rays x 30 samples and at the card's 500 x 64
too), and with its forward on the rz model or on tc_model.product's folds
further from the twin (B7 on the card's 32,000 rows past 1e-2; B8 past
5e-3 at 500 x 64 on the chain, on a seed here on the fold per atom and on
a ragged card case on the fold per step: both stay SIMT). B7' (the T-NeRF
field kernel, ELU and the colour ReLU, W 128 and 256): its backward with
demb and dvemb on the model from the twin's forward within the card's
1e-2, and at W=128 its train-mode forward on the rz chain too, the
composite's colour mask from that forward, within FORWARD_BAR on the
training path's case (which is why that forward runs on the tensor cores
at W=128; at W=256 it stays SIMT, tc_rounding.py --backward b7p). The fold
group of tc_model.product: G=1 is the per-step fold, G=1 and 4 bounded by
rz and rn. B11 (the deformation net's backward with d pts and d times, D=4,
W=128, at the 96- and 144-column pads): its sweep and demb on the model
from the bf16 twin's forward within BAR, and the fp32 twin against the JAX
package's fused_time_net_pts VJP in interpret mode. No card; JAX only for
that last check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swnerf_torch.models import DirectTemporalNeRF, DNeRFConfig, TNeRF, TNeRFConfig, VanillaNeRF, VanillaNeRFConfig
from swnerf_torch.ops.embedding import positional_encoding
from swnerf_torch.ops.kernels import render_loss as b1
from swnerf_torch.ops.kernels import render_pass as b3
from swnerf_torch.ops.kernels import tc_model
from swnerf_torch.ops.kernels import time_net as b6
from swnerf_torch.ops.kernels import trunk as b7
from swnerf_torch.ops.kernels.render_pass import field_mlp
from swnerf_torch.render.fused_eval import canonical_params
from swnerf_tpu.models.dnerf import DNeRFConfig as JaxConfig
from swnerf_tpu.models.dnerf import init_time_net_params
from swnerf_tpu.ops.pallas.raymarch import fused_time_net_pts as jax_fused_time_net_pts

BAR = 2e-3


def _rel_l2(got, ref):
    return {k: ((got[k].double() - ref[k].double()).norm() / ref[k].double().norm().clamp_min(1e-300)).item()
            for k in ref}


def _seeded_rays(rng, n, s, nf_views):
    """n rays toward the origin from numpy's generator: origins, directions,
    the view embedding, s sorted samples in [2, 6] and their dists."""
    o = torch.from_numpy(rng.normal(0.0, 0.3, (n, 3)) + [0.0, 0.0, 4.0]).float()
    d = torch.from_numpy(rng.normal(0.0, 1.0, (n, 3))).float()
    d[:, 2] = -d[:, 2].abs() - 1.0
    z = torch.from_numpy(np.sort(rng.uniform(2.0, 6.0, (n, s)), -1)).float()
    dist = torch.cat([z[:, 1:] - z[:, :-1], torch.full((n, 1), 1e10)], -1) * torch.linalg.norm(d, dim=-1, keepdim=True)
    ve = positional_encoding(d / torch.linalg.norm(d, dim=-1, keepdim=True), nf_views)
    return o, d, ve, z, dist


def _b1_case(width, seed, n=10, s=30):
    """A seeded bf16 vanilla field (D=8, skip 4, multires 10 / 4) and B1's
    inputs on n x s jittered samples (noise std 1: the sigma > 0 mask is
    exercised): packed, (o, d, ve, z, dist, noise, target), loss_scale."""
    cfg = VanillaNeRFConfig(netwidth=width)
    model = VanillaNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(seed), fused=False)
    packed = b3.pack_params(model.state_dict(), cfg, torch.bfloat16)
    rng = np.random.default_rng(seed)
    o, d, ve, z, dist = _seeded_rays(rng, n, s, cfg.nf_views)
    noise = torch.from_numpy(rng.normal(0.0, 1.0, (n, s))).float()
    target = torch.from_numpy(rng.uniform(0.0, 1.0, (n, 3))).float()
    return packed, (o, d, ve, z, dist, noise, target), 1.0 / (3 * n)


def _b1_inputs(width, seed, n=10, s=30):
    """_b1_case's field and the twin's forward tape on its samples, with the
    raw cotangent of the squared error."""
    packed, (o, d, ve, z, dist, noise, target), scale = _b1_case(width, seed, n, s)
    fwd = b3.field_forward(packed, o, d, ve, z)
    args = (z, dist, noise, True, target, scale)
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
    got, _, _ = tc_model.sweep_field(packed, fwd.emb, fwd.vemb, fwd.hs, fwd.feat, fwd.hv, graw, "rz")
    rel = _rel_l2(b1.unpack_grads(tuple(x.float() for x in got), packed), b1.unpack_grads(ref, packed))
    assert max(rel.values()) <= BAR, rel
    exact, _, _ = tc_model.sweep_field(packed, fwd.emb, fwd.vemb, fwd.hs, fwd.feat, fwd.hv, graw, "exact")
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



B11_PADS = {  # D=4, W=128, skip 2: the D-NeRF pad (84 of 96 columns) and MultiRes level 0's (140 of 144)
    "dnerf96": dict(netdepth=4, netwidth=128, skips=(2,), multires=10, multires_views=4),
    "level0_144": dict(netdepth=4, netwidth=128, skips=(2,), multires=20, multires_time=8, multires_views=4),
}


def _time_tree_to_port(tree):
    """A JAX time-net tree {"layers": [{"w", "b"}], "out"} -> the port's
    ``_time.*`` state-dict keys, ``[out, in]``."""
    out = {}
    for name, lyr in [(f"_time.{i}", lyr) for i, lyr in enumerate(tree["layers"])] + [("_time_out", tree["out"])]:
        out[f"{name}.weight"] = torch.tensor(np.asarray(lyr["w"]).T)
        out[f"{name}.bias"] = torch.tensor(np.asarray(lyr["b"]))
    return out


@pytest.mark.parametrize("pad", list(B11_PADS))
def test_b11_sweep_with_demb_on_the_tensor_core_model_holds_the_twin(pad):
    """bf16 B11's backward (fused_time_net_pts with need_input_grads) with
    its trunk's products and demb on the rz model (tc_demb over the whole
    96- or 144-column pad: the skip layer's product stored, layer 0's added
    to nearest) against time_net_plain_bwd(need_input_grads=True): the
    gradients, d pts and d times (demb carried through the encode, whose
    backward multiplies it by up to 2^19 at level 0), seeds 0-3, 12 rays x
    25 samples in [-1.2, 1.2]^3, within BAR (2e-3) rel L2. Seeds 0-3
    printed 2.0e-7 to 2.3e-5 at the D-NeRF pad and 2.4e-7 to 1.3e-4 at
    level 0. The twin itself, in fp32, against raymarch.py's
    fused_time_net_pts VJP (_plain_raw_call, interpret mode) on 11 rays x 8
    samples: dx atol 1e-5 (rtol 5e-4), every gradient, d pts and d times
    within 1e-4 * max|g| + 1e-7 (test_torch_dnerf_kernels.py's bar; level
    0's positions scaled by 2^-10 there, where the Pallas encode's cos(u) =
    sin(u + pi/2) holds to fp32)."""
    kw = B11_PADS[pad]
    cfg = DNeRFConfig(**kw)
    for seed in range(4):
        model = DirectTemporalNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(seed), fused=False)
        packed = b6.pack_time_params(model.state_dict(), cfg, torch.bfloat16)
        assert (packed.cin, packed.cin_pad) == ((84, 96) if pad == "dnerf96" else (140, 144))
        rng = np.random.default_rng(seed)
        pts = torch.from_numpy(rng.uniform(-1.2, 1.2, (12, 25, 3))).float()
        times = torch.from_numpy(rng.uniform(0.0, 1.0, 12)).float()
        g = torch.from_numpy(rng.normal(size=(12, 25, 3))).float()
        ref, dpts, dtimes = b6.time_net_plain_bwd(packed, pts, times, g, need_input_grads=True)
        emb, hs, _ = b6._forward(packed, pts, times)
        got, demb = tc_model.sweep_time_net(packed, emb, hs, g, "rz", need_demb=True)
        assert demb.shape == (300, packed.cin)
        mp, mt = b6.encode_xt_backward(pts, times, demb.float(), packed.n_freqs, packed.n_freqs_time)
        rel = _rel_l2(dict(b6.unpack_time_grads(tuple(x.float() for x in got), packed), dpts=mp, dtimes=mt),
                      dict(b6.unpack_time_grads(ref, packed), dpts=dpts, dtimes=dtimes))
        print(f"B11 {pad} seed {seed}: max rel L2 {max(rel.values()):.3e} ({max(rel, key=rel.get)})")
        assert max(rel.values()) <= BAR, (seed, rel)

    jcfg = JaxConfig(**kw)
    tp = jax.tree.map(np.asarray, init_time_net_params(jax.random.PRNGKey(6), jcfg))
    rng = np.random.default_rng(6)
    x = (rng.uniform(-1.2, 1.2, (11, 8, 3)) * (1.0 if pad == "dnerf96" else 2.0**-10)).astype(np.float32)
    t = rng.uniform(0.0, 1.0, 11).astype(np.float32)
    g = rng.standard_normal((11, 8, 3)).astype(np.float32)

    def f(p, xx, tt):
        return jax_fused_time_net_pts(p, jcfg, xx, tt, block=64, interpret=True, compute_dtype=jnp.float32,
                                      need_input_grads=True)

    jdx, vjp = jax.vjp(f, tp, jnp.asarray(x), jnp.asarray(t[:, None, None]))
    gp, gx, gt = vjp(jnp.asarray(g))
    p32 = b6.pack_time_params(_time_tree_to_port(tp), cfg, torch.float32)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    np.testing.assert_allclose(b6.time_net_plain(p32, xt, tt).numpy(), np.asarray(jdx), atol=1e-5, rtol=5e-4)
    grads, dpts, dtimes = b6.time_net_plain_bwd(p32, xt, tt, torch.from_numpy(g), need_input_grads=True)
    got = dict(b6.unpack_time_grads(grads, p32), dpts=dpts, dtimes=dtimes)
    want = dict(_time_tree_to_port(jax.tree.map(np.asarray, gp)), dpts=torch.tensor(np.asarray(gx)),
                dtimes=torch.tensor(np.asarray(gt).reshape(11)))
    for k, r in want.items():
        err = (got[k].double() - r.double()).abs().max().item()
        assert err <= 1e-4 * r.double().abs().max().item() + 1e-7, (k, err)

def _b4_case(seed, n=10, s=30):
    """A seeded bf16 T-NeRF (D=8, W=128, multires 10 / 4) and B4's inputs on
    n x s jittered samples with per-ray times: packed, (o, d, ve, z, dist,
    noise, target), times, loss_scale."""
    cfg = TNeRFConfig()
    model = TNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(seed), fused=False)
    packed = b3.pack_tnerf_params(model.state_dict(), cfg, torch.bfloat16)
    rng = np.random.default_rng(seed)
    o, d, ve, z, dist = _seeded_rays(rng, n, s, cfg.nf_views)
    times = torch.from_numpy(rng.uniform(0.0, 1.0, n)).float()
    noise = torch.from_numpy(rng.normal(0.0, 1.0, (n, s))).float()
    target = torch.from_numpy(rng.uniform(0.0, 1.0, (n, 3))).float()
    return packed, (o, d, ve, z, dist, noise, target), times, 1.0 / (3 * n)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_b4_sweep_on_the_tensor_core_model_holds_the_twin(seed):
    """bf16 B4's reverse sweep (the T-NeRF: D=8, W=128, multires 10 / 4, so
    84 of 96 input columns and 27 of 32 view columns; ELU' from the stored
    outputs, the colour ReLU's mask in the raw cotangent) with its large
    products on the rz model against render_loss.field_reverse_plain, 10
    rays x 30 samples."""
    packed, (o, d, ve, z, dist, noise, target), times, _ = _b4_case(seed)
    assert (packed.cin, packed.cin_pad, packed.arch) == (84, 96, "tnerf")
    n = z.shape[0]
    fwd = b3.field_forward(packed, o, d, ve, z, times)
    _, graw = tc_model.composite(fwd.sigma, fwd.logits, z, dist, noise, True, target, 1.0 / (3 * n), rgb_relu=True)
    assert bool((graw[:, :3] == 0).any()) and bool((fwd.hs[0] < 0).any())  # the masks and ELU's tail are live
    ref, _, _ = b1.field_reverse_plain(packed, fwd.emb, fwd.vemb, fwd.hs, fwd.feat, fwd.hv, graw.float())
    got, _, _ = tc_model.sweep_field(packed, fwd.emb, fwd.vemb, fwd.hs, fwd.feat, fwd.hv, graw.float(), "rz")
    rel = _rel_l2(b1.unpack_tnerf_grads(tuple(x.float() for x in got), packed), b1.unpack_tnerf_grads(ref, packed))
    assert max(rel.values()) <= BAR, rel


# The bar of the train-mode forwards on the model: half the card's 1e-2.
FORWARD_BAR = 5e-3


def _forward_and_sweep_on_the_model(packed, fwd, args, mode="rz", rgb_relu=False):
    """The bf16 train-mode launch of B1 / B4 with the forward's products on
    the model too (csrc/tc_render.cuh's train-mode body): the stored
    activations, feat, hv, sigma and the logits from
    tc_model.field_forward_model (ELU as elu_tc for the T-NeRF), then the
    composite's raw cotangent, then the sweep on the model; the packed
    gradients as fp32."""
    hs, feat, hv, sigma, logits = tc_model.field_forward_model(packed, fwd.emb, fwd.vemb, mode)
    _, graw = tc_model.composite(sigma, logits, *args, rgb_relu=rgb_relu)
    got, _, _ = tc_model.sweep_field(packed, fwd.emb, fwd.vemb, hs, feat, hv, graw.float(), mode)
    return tuple(x.float() for x in got)


def _assert_forward_bar(tag, run, ref, mode=("rz", 1)):
    """Every gradient tensor of ``run(mode, group)`` (a dict: the forward,
    the cotangent and the sweep on the model, the sweep on rz where the
    forward folds) within FORWARD_BAR of the twin's (``ref``). Where the
    same chain with exact sums (float64, no k16 rounding: ``run("exact",
    1)``) itself lies further than FORWARD_BAR from the twin, the twin's own
    fp32 order has flipped a ReLU mask that any other order flips too (a
    pre-activation within fp32 rounding of 0), and that tensor is held to
    twice the exact chain's distance instead, as the card's ragged tests
    hold the twin's own spread; both are printed."""
    rel = _rel_l2(run(*mode), ref)
    worst = max(rel, key=rel.get)
    bar = {}
    text = f"{tag}, forward too: max rel L2 {rel[worst]:.3e} ({worst})"
    if rel[worst] > FORWARD_BAR:
        own = _rel_l2(run("exact", 1), ref)
        bar = {k: 2 * v for k, v in own.items() if v > FORWARD_BAR}
        text += f"; exact sums {own[worst]:.3e}"
    print(text)
    assert all(v <= bar.get(k, FORWARD_BAR) for k, v in rel.items()), (rel, bar)


def _render_run(unpack, packed, fwd, args, rgb_relu=False):
    """B1's / B4's train-mode launch on the model (sweep on the same mode),
    for _assert_forward_bar."""
    def run(mode, group):
        return unpack(_forward_and_sweep_on_the_model(packed, fwd, args, mode, rgb_relu), packed)
    return run


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("width", [128, 256])
def test_b1_forward_and_sweep_on_the_tensor_core_model_hold_the_twin(width, seed):
    """bf16 B1 with its forward on the tensor cores as well as its sweep:
    the gradients of the forward, composite and sweep on the rz model lie
    within FORWARD_BAR (5e-3, half the card's 1e-2 bar) rel L2 of the twin's
    (render_loss_plain), D=8, 10 rays x 30 samples. Seeds 0-3 printed
    1.2e-6 to 1.3e-4 at W=128 but seed 3 and 1.5e-4 to 2.5e-4 at W=256; W=128
    seed 3 printed 3.95e-2 on pts_linears.3.weight, as far as the exact
    sums land (one ReLU of layer 4 sits within the twin's fp32 rounding of
    0), which _assert_forward_bar's fallback holds."""
    packed, (o, d, ve, z, dist, noise, target), scale = _b1_case(width, seed)
    _, ref = b1.render_loss_plain(packed, o, d, ve, z, dist, noise, target, True, scale)
    fwd = b3.field_forward(packed, o, d, ve, z)
    _assert_forward_bar(f"B1 W={width} seed {seed}",
                        _render_run(b1.unpack_grads, packed, fwd, (z, dist, noise, True, target, scale)),
                        b1.unpack_grads(ref, packed))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_b4_forward_and_sweep_on_the_tensor_core_model_hold_the_twin(seed):
    """bf16 B4 (the T-NeRF at D=8, W=128, ELU) with its forward on the
    tensor cores as well as its sweep: forward (ELU as elu_tc), composite
    (the colour ReLU's mask) and sweep on the rz model, within FORWARD_BAR
    (5e-3, half the card's 1e-2 bar) rel L2 of the twin's gradients, 10 rays
    x 30 samples. Seeds 0-3 printed 8.7e-5 to 1.3e-3."""
    packed, (o, d, ve, z, dist, noise, target), times, scale = _b4_case(seed)
    _, ref = b1.render_loss_plain(packed, o, d, ve, z, dist, noise, target, True, scale, times)
    fwd = b3.field_forward(packed, o, d, ve, z, times)
    _assert_forward_bar(f"B4 seed {seed}",
                        _render_run(b1.unpack_tnerf_grads, packed, fwd, (z, dist, noise, True, target, scale), True),
                        b1.unpack_tnerf_grads(ref, packed))


B7_LEVELS = {
    "level0": dict(multires=20, multires_time=8, multires_views=20),
    "level1": dict(multires=10, multires_time=4, multires_views=10),
    "identity": dict(multires=-1, multires_time=-1, multires_views=-1, i_embed=-1),
}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("level", list(B7_LEVELS))
def test_b7_sweep_with_demb_on_the_tensor_core_model_holds_the_twin(level, seed):
    """bf16 B7's backward with its input cotangent (the MultiRes canonical
    trunk at D=8, W=256; level 0 at 123 of 128 columns) with its large
    products and demb on the rz model against trunk_plain_bwd, on the
    well-conditioned inputs of tests/test_torch_multires_kernels.py
    (positions in [-1.2, 1.2]^3), 300 rows."""
    cfg = DNeRFConfig(netdepth=8, netwidth=256, skips=(4,), **B7_LEVELS[level])
    model = DirectTemporalNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(seed), fused=False)
    packed = b7.pack_trunk_params(model._occ.state_dict(), cfg, torch.bfloat16)
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.uniform(-1.2, 1.2, (300, 3))).float()
    vd = torch.from_numpy(rng.standard_normal((300, 3))).float()
    emb = positional_encoding(pts, cfg.nf_pts)
    vemb = positional_encoding(vd / torch.linalg.norm(vd, dim=-1, keepdim=True), cfg.nf_views)
    g = torch.from_numpy(rng.standard_normal((300, 4))).float()
    (gw, gb), demb, _ = b7.trunk_plain_bwd(packed, emb, vemb, g)
    e, v = b7._padded(packed, emb, vemb)
    hs, feat, hv, _, _ = field_mlp(packed, e, v)
    (mw, mb), mdemb, _ = tc_model.sweep_field(packed, e, v, hs, feat, hv, g, "rz", need_demb=True)
    assert mdemb.shape == demb.shape == (300, packed.cin)
    ref = dict(b7.unpack_trunk_grads((gw, gb), packed), demb=demb)
    got = dict(b7.unpack_trunk_grads((mw.float(), mb.float()), packed), demb=mdemb)
    rel = _rel_l2(got, ref)
    assert max(rel.values()) <= BAR, rel


def _pts_inputs(cfg, seed, n=10, s=30):
    """A seeded D-NeRF canonical field packed for B5 / B9 (bf16; the wide
    pads where its embeddings need them) and n x s sample positions as the
    card's tests make them (o + d z plus a jitter of std 0.05), the view
    embedding, z, dists, noise std 1 and the numpy generator."""
    model = DirectTemporalNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(seed), fused=False)
    packed = b3.pack_params(canonical_params(model.state_dict()), cfg, torch.bfloat16)
    rng = np.random.default_rng(seed)
    o = torch.from_numpy(rng.normal(0.0, 0.3, (n, 3)) + [0.0, 0.0, 4.0]).float()
    d = torch.from_numpy(rng.normal(0.0, 1.0, (n, 3))).float()
    d[:, 2] = -d[:, 2].abs() - 1.0
    z = torch.from_numpy(np.sort(rng.uniform(2.0, 6.0, (n, s)), -1)).float()
    dist = torch.cat([z[:, 1:] - z[:, :-1], torch.full((n, 1), 1e10)], -1) * torch.linalg.norm(d, dim=-1, keepdim=True)
    pts = (o[:, None, :] + d[:, None, :] * z[..., None] + torch.from_numpy(rng.normal(0.0, 0.05, (n, s, 3)))).float()
    ve = positional_encoding(d / torch.linalg.norm(d, dim=-1, keepdim=True), cfg.nf_views)
    noise = torch.from_numpy(rng.normal(0.0, 1.0, (n, s))).float()
    return packed, pts, (ve, z, dist, noise), rng


def _pts_sweep_distance(packed, pts, ve, z, dist, noise, **loss):
    """B5's / B9's sweep with demb on the rz model against the twin's
    (field_reverse_plain with need_demb), both from the twin's forward and
    the composite's raw cotangent of ``loss`` (target and loss_scale, or the
    external gct), both carried to d pts by encode_backward: the per-tensor
    rel L2 over the unpacked gradients and d pts."""
    fwd = b3.field_forward(packed, None, None, ve, z, None, pts)
    _, graw = tc_model.composite(fwd.sigma, fwd.logits, z, dist, noise, **loss)
    graw = graw.float()
    x = pts.reshape(-1, 3)
    gr, dr, _ = b1.field_reverse_plain(packed, fwd.emb, fwd.vemb, fwd.hs, fwd.feat, fwd.hv, graw, need_demb=True)
    (mw, mb), md, _ = tc_model.sweep_field(packed, fwd.emb, fwd.vemb, fwd.hs, fwd.feat, fwd.hv, graw, "rz",
                                           need_demb=True)
    assert md.shape == dr.shape == (x.shape[0], packed.cin)
    ref = dict(b1.unpack_grads(gr, packed), dpts=b1.encode_backward(x, dr, packed.n_freqs))
    got = dict(b1.unpack_grads((mw.float(), mb.float()), packed),
               dpts=b1.encode_backward(x, md.float(), packed.n_freqs))
    return _rel_l2(got, ref)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("width", [128, 256])
def test_b5_sweep_with_demb_on_the_tensor_core_model_holds_the_twin(width, seed):
    """bf16 B5's reverse sweep (the D-NeRF canonical field at D=8, 63 of 64
    input columns: demb over the 64-column pad, the skip layer's product
    stored, layer 0's added) with its large products and demb on the rz
    model against the twin's, its gradients and d pts, 10 rays x 30 samples
    with the squared error's cotangent on a white background. Bar 3e-3:
    seeds 0-3 printed 2.4e-7 to 3.2e-4 at W=128 and 1.9e-4 to 2.9e-3 at
    W=256, the largest at seed 3 on layer 0's weights (the exact model
    there: 3.5e-5), where the k16 steps' rounding toward zero moves a few
    dz values across a bf16 boundary on the way down the trunk."""
    packed, pts, (ve, z, dist, noise), rng = _pts_inputs(DNeRFConfig(netwidth=width), seed)
    assert (packed.cin, packed.cin_pad, packed.wide) == (63, 64, False)
    target = torch.from_numpy(rng.uniform(0.0, 1.0, (10, 3))).float()
    rel = _pts_sweep_distance(packed, pts, ve, z, dist, noise, white=True, target=target, loss_scale=1.0 / 30)
    print(f"B5 W={width} seed {seed}: max rel L2 {max(rel.values()):.3e} ({max(rel, key=rel.get)})")
    assert max(rel.values()) <= 3e-3, rel


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("level", list(B7_LEVELS))
def test_b9_sweep_on_the_tensor_core_model_holds_the_twin(level, seed):
    """bf16 B9's reverse sweep (the MultiRes canonical field at D=8,
    W=256: wide at levels 0 and 1, 123 and 63 of 128 input columns; narrow
    at the identity level, 3 of 64) with its large products and demb on the
    rz model against the twin's, its gradients and d pts, from a seeded
    external cotangent gct [N, 5] of (rgb, acc, depth) on a white and on a
    black background, 10 rays x 30 samples. Bar 2e-3: seeds 0-3 printed
    2.1e-7 to 2.3e-4 at level 0, 6.4e-5 to 1.7e-3 at level 1 and 2.1e-6 to
    1.1e-4 at the identity level."""
    cfg = DNeRFConfig(netdepth=8, netwidth=256, skips=(4,), **B7_LEVELS[level])
    packed, pts, args, rng = _pts_inputs(cfg, seed)
    assert packed.wide == (level != "identity")
    gct = torch.from_numpy(rng.normal(size=(10, 5))).float()
    for white in (True, False):
        rel = _pts_sweep_distance(packed, pts, *args, white=white, gct=gct)
        print(f"B9 {level} seed {seed} white={white}: max rel L2 {max(rel.values()):.3e} ({max(rel, key=rel.get)})")
        assert max(rel.values()) <= BAR, (white, rel)


@pytest.mark.parametrize("lo,hi", [(-30.0, -0.5), (-0.5, 0.0), (-1e-3, 0.0), (0.0, 8.0)],
                         ids=["tail", "poly", "near0", "positive"])
def test_tensor_core_elu_is_expm1_to_bf16(lo, hi):
    """The tensor-core epilogue's ELU (tc_chunk.cuh::elu_tc, twin
    tc_model.elu_tc) on a dense fp32 grid: within 4e-7 relative (or 1e-12
    absolute) of expm1 in float64, and rounded to bf16 it equals fp32
    expm1f rounded to bf16 on all but 1e-3 of the grid (those within
    ~3e-7 of a bf16 rounding boundary), never more than one bf16 ulp off."""
    z = torch.linspace(lo, hi, 200_001, dtype=torch.float32)
    got = tc_model.elu_tc(z)
    ref = torch.where(z > 0, z.double(), torch.expm1(z.double()))
    err = (got.double() - ref).abs()
    assert bool((err <= 4e-7 * ref.abs() + 1e-12).all()), err.max().item()
    q_got = got.to(torch.bfloat16)
    q_ref = torch.where(z > 0, z, torch.expm1(z)).to(torch.bfloat16)
    differ = q_got != q_ref
    assert differ.double().mean().item() <= 1e-3
    ulp = tc_model.ulp32(q_ref.float()) * 2.0**16  # bf16's ulp: fp32's times 2^16
    assert bool(((q_got.double() - q_ref.double()).abs() <= ulp + 1e-300).all())


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_on_the_model_lands_further_than_the_backward(seed):
    """The control, at multires 10 (D=8, W=256): the forward on the rz model
    (stored activations, feat, hv, sigma and the logits all from it) run
    through the twin's composite and backward lands further from the twin's
    gradients than the backward on the model from the twin's forward."""
    packed, fwd, graw, args = _b1_inputs(256, seed, n=12, s=32)
    ref, _, _ = b1.field_reverse_plain(packed, fwd.emb, fwd.vemb, fwd.hs, fwd.feat, fwd.hv, graw)
    ref = b1.unpack_grads(ref, packed)
    bwd, _, _ = tc_model.sweep_field(packed, fwd.emb, fwd.vemb, fwd.hs, fwd.feat, fwd.hv, graw, "rz")
    d_bwd = max(_rel_l2(b1.unpack_grads(tuple(x.float() for x in bwd), packed), ref).values())
    hs, feat, hv, sigma, logits = tc_model.field_forward_model(packed, fwd.emb, fwd.vemb, "rz")
    _, graw_m = tc_model.composite(sigma, logits, *args)
    fw, _, _ = b1.field_reverse_plain(packed, fwd.emb, fwd.vemb, [h.float() for h in hs], feat.float(), hv.float(),
                                      graw_m.float())
    d_fwd = max(_rel_l2(b1.unpack_grads(fw, packed), ref).values())
    assert d_fwd > d_bwd, (d_fwd, d_bwd)


def _fold_per_step(X, Wm):
    """The fold of every k16 step, written out: each step's exact sum
    rounded toward zero, then to the even of it and its neighbour away from
    zero, then added to the fp32 sum at nearest."""
    acc = None
    for k0 in range(0, X.shape[1], 16):
        t = tc_model.rnd32(X[:, k0:k0 + 16] @ Wm[k0:k0 + 16], "rz")
        t = tc_model.rnd32(t + torch.sign(t) * 0.5 * tc_model.ulp32(t), "rn")
        acc = t if acc is None else tc_model.rnd32(acc + t, "rn")
    return acc


def test_fold_group_one_is_the_per_step_fold_and_four_is_bounded_by_rz_and_rn():
    """tc_model.product's fold group: G=1 is bit-equal to the per-step fold;
    G=1 and G=4 (one chain toward zero per 64-deep atom, then the fold) land
    within rz's mean |error| against the exact sum and within twice rn's,
    and their mean error toward zero is under a quarter of rz's, over a
    1,024-deep product of bf16 values (printed, relative to the mean
    |exact|: mean |error| rz 1.08e-6, rn 1.26e-7, fold G=1 1.39e-7, G=4
    9.3e-8, fewer roundings at the master sum's magnitude; toward zero rz
    9.5e-7, the folds and rn below 2e-8). The fold's step to the even
    neighbour away from zero is the bits' odd-to-even step, as a kernel
    would take it (u + (u & 1) on the fp32 bits)."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=(64, 1024))).to(torch.bfloat16).double()
    b = torch.from_numpy(rng.normal(size=(1024, 48))).to(torch.bfloat16).double()
    assert torch.equal(tc_model.product(a, b, None, "fold"), _fold_per_step(a, b))
    assert torch.equal(tc_model.product(a, b, None, "fold", 1), tc_model.product(a, b, None, "fold"))
    exact = a @ b
    err = {f"{m}{g}": tc_model.product(a, b, None, m, g) - exact
           for m, g in (("rz", 1), ("fold", 4), ("fold", 1), ("rn", 1))}
    scale = exact.abs().mean().item()
    mean_abs = {m: e.abs().mean().item() / scale for m, e in err.items()}
    toward_zero = {m: -(e * torch.sign(exact)).mean().item() / scale for m, e in err.items()}
    print(mean_abs, toward_zero)
    assert max(mean_abs["fold4"], mean_abs["fold1"]) <= min(mean_abs["rz1"], 2 * mean_abs["rn1"]), mean_abs
    assert max(abs(toward_zero["fold4"]), abs(toward_zero["fold1"])) <= 0.25 * toward_zero["rz1"], toward_zero
    t = tc_model.rnd32(torch.from_numpy(rng.normal(size=4096)), "rz")
    folded = tc_model.rnd32(t + torch.sign(t) * 0.5 * tc_model.ulp32(t), "rn")
    bits = t.float().view(torch.int32)
    assert torch.equal(folded.float().view(torch.int32), bits + (bits & 1))


# The train-mode forward of B7 and B8 on the card: both stay on the SIMT
# body, whose fp32 FMAs in order are the twin's own forward ("twin");
# tc_rounding.py and these tests chose it, PERF.md §6.
B7_TRAIN_MODE = ("twin", 1)
B8_TRAIN_MODE = ("twin", 1)


def _trunk_train_run(packed, e, v, loss, to_inputs=None, rgb_relu=False):
    """run(mode, group) for _assert_forward_bar: B7's / B8's / B7''s bf16
    train-mode forward (``mode`` "twin": the twin's own,
    render_pass.field_mlp; else on the model, tc_model.field_forward_model
    at the padded embeddings e, v), the composite's raw cotangent of the
    squared error (``loss``: z, dist, noise, white, target, loss_scale;
    ``rgb_relu``, B7': the colour ReLU and its mask from the forward's
    logits), the sweep on the rz model (the card's; exact with the exact
    forward) with demb and dvemb (tc_demb, tc_dvemb); with ``to_inputs``
    (B8) both carried to the inputs' cotangents."""
    def run(mode, group):
        fwd = field_mlp(packed, e, v) if mode == "twin" else tc_model.field_forward_model(packed, e, v, mode, group)
        hs, feat, hv, sigma, logits = fwd
        _, graw = tc_model.composite(sigma, logits, *loss, rgb_relu=rgb_relu)
        grads, demb, dvemb = tc_model.sweep_field(packed, e, v, hs, feat, hv, graw.float(),
                                                  "exact" if mode == "exact" else "rz", need_demb=True,
                                                  need_dvemb=True)
        grads = b7.unpack_trunk_grads(tuple(x.float() for x in grads), packed)
        if to_inputs is None:
            return dict(grads, demb=demb.float(), dvemb=dvemb.float())
        return dict(grads, **to_inputs(demb.float(), dvemb.float()))
    return run


def _trunk_rays(rng, n, s, nf_views, through_object=False):
    """n x s sample positions on _seeded_rays (MultiRes phase 1's
    geometry; ``through_object``: the card's B8 case, rays from z = 0 at a
    scale of 0.4), per-sample unit view directions and the squared error's
    loss arguments for tc_model.composite (noise std 1, a seeded target)."""
    o, d, _, z, dist = _seeded_rays(rng, n, s, nf_views)
    if through_object:
        o = o * torch.tensor([1.0, 1.0, 0.0])
        pts = o[:, None, :] + d[:, None, :] * (z[..., None] - 4.0) * 0.4
    else:
        pts = o[:, None, :] + d[:, None, :] * z[..., None]
    vd = (d / torch.linalg.norm(d, dim=-1, keepdim=True))[:, None, :].expand(n, s, 3)
    noise = torch.from_numpy(rng.normal(0.0, 1.0, (n, s))).float()
    target = torch.from_numpy(rng.uniform(0.0, 1.0, (n, 3))).float()
    return pts.reshape(-1, 3).contiguous(), vd.reshape(-1, 3).contiguous(), (z, dist, noise, True, target, 1.0 / (3 * n))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("level", list(B7_LEVELS))
def test_b7_train_mode_and_sweep_with_dvemb_on_the_tensor_core_model_hold_the_twin(level, seed):
    """bf16 B7 as it trains on the card: its train-mode forward on the SIMT
    body (the twin's own, B7_TRAIN_MODE), then its backward with demb and
    dvemb on the rz model (tc_dvemb new), on the training path's case
    (MultiRes phase 1's geometry at the level's widths, D=8, W=256, raw
    through the composite to the squared error's cotangent; 10 rays x 30
    samples): within FORWARD_BAR of the twin's gradients, demb and dvemb
    (trunk_plain, the composite, trunk_plain_bwd) through
    _assert_forward_bar."""
    cfg = DNeRFConfig(netdepth=8, netwidth=256, skips=(4,), **B7_LEVELS[level])
    model = DirectTemporalNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(seed), fused=False)
    packed = b7.pack_trunk_params(model._occ.state_dict(), cfg, torch.bfloat16)
    pts, vd, loss = _trunk_rays(np.random.default_rng(seed), 10, 30, cfg.nf_views)
    emb, vemb = positional_encoding(pts, cfg.nf_pts), positional_encoding(vd, cfg.nf_views)
    raw = b7.trunk_plain(packed, emb, vemb)
    _, graw = tc_model.composite(raw[:, 3], raw[:, :3], *loss)
    grads, demb, dvemb = b7.trunk_plain_bwd(packed, emb, vemb, graw.float(), True, True)
    ref = dict(b7.unpack_trunk_grads(grads, packed), demb=demb, dvemb=dvemb)
    e, v = b7._padded(packed, emb, vemb)
    _assert_forward_bar(f"B7 {level} seed {seed}", _trunk_train_run(packed, e, v, loss), ref, B7_TRAIN_MODE)


def _b8_train_case(seed, n, s):
    """B8's training-path case (the vanilla field at D=8, W=256, multires
    10 / 4, seeded weights; the card test's rays through the object, n x s
    samples): the twin's gradients, d pts and d viewdirs (field_raw_plain,
    the composite, field_raw_plain_bwd) and the run of _trunk_train_run."""
    cfg = VanillaNeRFConfig()
    model = VanillaNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(seed), fused=False)
    packed = b7.pack_trunk_params(model.state_dict(), cfg, torch.bfloat16)
    pts, vd, loss = _trunk_rays(np.random.default_rng(seed), n, s, cfg.nf_views, through_object=True)
    raw = b7.field_raw_plain(packed, pts, vd)
    _, graw = tc_model.composite(raw[:, 3], raw[:, :3], *loss)
    grads, dpts, dvd = b7.field_raw_plain_bwd(packed, pts, vd, graw.float())
    ref = dict(b7.unpack_trunk_grads(grads, packed), dpts=dpts, dviewdirs=dvd)
    lp, lv = packed.n_freqs
    e, v = b7._padded(packed, positional_encoding(pts, lp), positional_encoding(vd, lv))

    def to_inputs(demb, dvemb):
        return dict(dpts=b1.encode_backward(pts, demb, lp), dviewdirs=b1.encode_backward(vd, dvemb, lv))

    return ref, _trunk_train_run(packed, e, v, loss, to_inputs)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_b8_forward_and_sweep_on_the_tensor_core_model_hold_the_twin(seed):
    """bf16 B8 (the vanilla field at D=8, W=256, multires 10 / 4, seeded
    weights) as it trains on the card: its train-mode forward on the SIMT
    body (B8_TRAIN_MODE), then its backward on the rz model with demb and
    dvemb (tc_dvemb), carried through the encode's
    backward to d pts and d viewdirs, on the training path's case (the card
    test's rays through the object, raw through the composite to the
    squared error's cotangent; 10 rays x 30 samples): within FORWARD_BAR of
    the twin's (field_raw_plain_bwd) through _assert_forward_bar."""
    ref, run = _b8_train_case(seed, 10, 30)
    _assert_forward_bar(f"B8 seed {seed}", run, ref, B8_TRAIN_MODE)


def test_b8_forward_and_sweep_on_the_tensor_core_model_hold_the_twin_at_the_cards_rows():
    """The same at the training path's size on the card, 500 rays x 64
    samples (32,000 rows, seed 0), where the sweep's roundings add up:
    B8_TRAIN_MODE's forward and the rz sweep within FORWARD_BAR of the twin
    (on tc_rounding.py's case on the card the tensor core's own chain for
    the forward lands at 8.5e-3, PERF.md §6)."""
    ref, run = _b8_train_case(0, 500, 64)
    _assert_forward_bar("B8 seed 0, 500 x 64", run, ref, B8_TRAIN_MODE)


def test_b8_forward_on_every_tensor_core_accumulation_lands_further_than_the_simt_forward():
    """Why B8's train-mode forward stays SIMT (B8_TRAIN_MODE), the control
    on the training path's case at 10 rays x 30 samples, seeds 0-3: on the
    worst seed, the gradients, d pts and d viewdirs with the forward on the
    rz model, on a fold every 4 k16 steps or on a fold every step land
    further from the twin's than with the SIMT forward (the twin's own),
    the sweep on the rz model after each; the fold every 4 steps past
    FORWARD_BAR. On the card the chain lands past it at 500 x 64 and the
    fold every step past 1e-2 on a ragged case (PERF.md §6)."""
    modes = (B8_TRAIN_MODE, ("rz", 1), ("fold", 4), ("fold", 1))
    dist = dict.fromkeys(modes, 0.0)
    for seed in range(4):
        ref, run = _b8_train_case(seed, 10, 30)
        for m in modes:
            dist[m] = max(dist[m], max(_rel_l2(run(*m), ref).values()))
    print(dist)
    assert all(dist[m] > dist[B8_TRAIN_MODE] for m in modes if m != B8_TRAIN_MODE), dist
    assert dist[("fold", 4)] > FORWARD_BAR, dist


@pytest.mark.parametrize("seed", [0, 1])
def test_b7_forward_on_every_tensor_core_accumulation_lands_further_than_the_simt_forward(seed):
    """Why B7's train-mode forward stays SIMT (B7_TRAIN_MODE), the control
    at MultiRes level 0 on the training path's case: with the forward on
    the rz model, on a fold every 4 k16 steps or on a fold every step
    (tc_model.product), the gradients land further from the twin's than
    with the SIMT forward (the twin's own), the sweep on the rz model after
    each. On the card's 32,000 rows (tc_rounding.py --backward b7, PERF.md
    §6) all three, and exact sums too, land past its 1e-2 bar there."""
    cfg = DNeRFConfig(netdepth=8, netwidth=256, skips=(4,), **B7_LEVELS["level0"])
    model = DirectTemporalNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(seed), fused=False)
    packed = b7.pack_trunk_params(model._occ.state_dict(), cfg, torch.bfloat16)
    pts, vd, loss = _trunk_rays(np.random.default_rng(seed), 10, 30, cfg.nf_views)
    emb, vemb = positional_encoding(pts, cfg.nf_pts), positional_encoding(vd, cfg.nf_views)
    raw = b7.trunk_plain(packed, emb, vemb)
    _, graw = tc_model.composite(raw[:, 3], raw[:, :3], *loss)
    grads, demb, dvemb = b7.trunk_plain_bwd(packed, emb, vemb, graw.float(), True, True)
    ref = dict(b7.unpack_trunk_grads(grads, packed), demb=demb, dvemb=dvemb)
    run = _trunk_train_run(packed, *b7._padded(packed, emb, vemb), loss)
    dist = {m: max(_rel_l2(run(*m), ref).values()) for m in (B7_TRAIN_MODE, ("rz", 1), ("fold", 4), ("fold", 1))}
    print(dist)
    assert all(dist[m] > dist[B7_TRAIN_MODE] for m in dist if m != B7_TRAIN_MODE), dist


def _b7p_case(width, seed, n=10, s=30):
    """B7''s case (the T-NeRF field at D=8, W=width, multires 10 / 4: 84 of
    128 input columns, 27 view columns; seeded weights, bf16) on the
    training path's geometry (_trunk_rays, a seeded time per ray): packed,
    the embeddings [embed(x) | embed(t)] and embed(d), the squared error's
    loss arguments for tc_model.composite and the numpy generator."""
    cfg = TNeRFConfig(net_dim=width)
    model = TNeRF(cfg, device="cpu", generator=torch.Generator().manual_seed(seed), fused=False)
    packed = b7.pack_tnerf_trunk_params(model.state_dict(), cfg, torch.bfloat16)
    rng = np.random.default_rng(seed)
    pts, vd, loss = _trunk_rays(rng, n, s, cfg.nf_views)
    t = torch.from_numpy(rng.uniform(0.0, 1.0, (n, 1, 1))).float().expand(n, s, 1).reshape(-1, 1)
    emb = torch.cat([positional_encoding(pts, cfg.nf_pts), positional_encoding(t, cfg.nf_time)], -1)
    return packed, emb, positional_encoding(vd, cfg.nf_views), loss, rng


def _colour_masked(g, logits):
    """The cotangent of raw with its colour columns masked by logits > 0, as
    B7''s backward masks them (trunk.cu::cotangent_kernel)."""
    return torch.cat([torch.where(logits > 0, g[:, :3], torch.zeros_like(g[:, :3])), g[:, 3:]], -1)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("width", [128, 256])
def test_b7p_sweep_with_demb_and_dvemb_on_the_tensor_core_model_holds_the_twin(width, seed):
    """bf16 B7''s backward on the tensor cores (field_reverse's TC branch:
    ELU' from the stored outputs, the colour mask from the forward's logits,
    demb over the 128-column pad, dvemb over the view rows') on the rz model
    (tc_model.sweep_field with need_demb and need_dvemb) from the twin's own
    forward, against trunk_plain_bwd on a random cotangent, 300 rows: the
    gradients, demb and dvemb within the card's 1e-2 bar (printed: 3e-4 to
    1.6e-3 at 10 x 30 rows)."""
    packed, emb, vemb, _, rng = _b7p_case(width, seed)
    assert (packed.cin, packed.input_ch_views, packed.arch) == (84, 27, "tnerf")
    g = torch.from_numpy(rng.standard_normal((emb.shape[0], 4))).float()
    (gw, gb), demb, dvemb = b7.trunk_plain_bwd(packed, emb, vemb, g, True, True)
    e, v = b7._padded(packed, emb, vemb)
    hs, feat, hv, _, logits = field_mlp(packed, e, v)
    assert bool((logits <= 0).any()) and bool((hs[0] < 0).any())  # the colour mask and ELU's tail are live
    (mw, mb), mdemb, mdvemb = tc_model.sweep_field(packed, e, v, hs, feat, hv, _colour_masked(g, logits), "rz",
                                                   need_demb=True, need_dvemb=True)
    assert mdemb.shape == demb.shape and mdvemb.shape == dvemb.shape == (300, 27)
    ref = dict(b7.unpack_trunk_grads((gw, gb), packed), demb=demb, dvemb=dvemb)
    got = dict(b7.unpack_trunk_grads((mw.float(), mb.float()), packed), demb=mdemb.float(), dvemb=mdvemb.float())
    rel = _rel_l2(got, ref)
    print(f"B7' W={width} seed {seed}: max rel L2 {max(rel.values()):.3e} ({max(rel, key=rel.get)})")
    assert max(rel.values()) <= 1e-2, rel


# B7''s bf16 train-mode forward by width: the tensor cores' rz chain at W=128
# (trunk.cu::train_on_tc), the SIMT body (the twin's own order) at W=256,
# where every accumulation lands past FORWARD_BAR on tc_rounding.py
# --backward b7p's random cotangent (rz 8.1e-3; PERF.md §6).
B7P_TRAIN_MODE = {128: ("rz", 1), 256: ("twin", 1)}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_b7p_train_mode_forward_on_the_tensor_core_model_holds_the_twin(seed):
    """bf16 B7' as it trains on the card at W=128, the T-NeRF config's
    width: its train-mode forward on the tensor cores' chain (rz,
    B7P_TRAIN_MODE), the composite's colour ReLU and its mask from that
    forward's logits, then its backward with demb and dvemb on the rz model,
    on the training path's case (10 rays x 30 samples, a time per ray):
    within FORWARD_BAR of the twin's gradients, demb and dvemb (trunk_plain,
    the composite, trunk_plain_bwd) through _assert_forward_bar. On the
    card's 32,000 rows with 800000.tar the model printed 3.26e-3 (train)
    and 2.91e-3 (random cotangent)."""
    packed, emb, vemb, loss, _ = _b7p_case(128, seed)
    raw = b7.trunk_plain(packed, emb, vemb)
    _, graw = tc_model.composite(raw[:, 3], raw[:, :3], *loss, rgb_relu=True)
    grads, demb, dvemb = b7.trunk_plain_bwd(packed, emb, vemb, graw.float(), True, True)
    ref = dict(b7.unpack_trunk_grads(grads, packed), demb=demb, dvemb=dvemb)
    e, v = b7._padded(packed, emb, vemb)
    _assert_forward_bar(f"B7' W=128 seed {seed}", _trunk_train_run(packed, e, v, loss, rgb_relu=True), ref,
                        B7P_TRAIN_MODE[128])

