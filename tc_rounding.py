#!/usr/bin/env python3
"""How the bf16 tensor-core products round, on the card, and what that does
to B9's and B1's gradients.

Models the fp32 sums of a bf16 product as the tensor core's k16 steps, each
the exact sum of 16 products (float64 here) added to the accumulator and
rounded to fp32 (swnerf_torch/ops/kernels/tc_model.py, which the CPU tests
share): ``rz`` rounds each step toward zero, ``rn`` to nearest;
``fold`` takes each step from zero, toward zero, then the even of it and
its neighbour away from zero, and adds it to an fp32 accumulator to
nearest (an unbiased fold); ``exact`` sums in float64. On MultiRes fields
(D=8, W=256, seeded weights) at the levels given, it prints

- per layer of B6's trunk (csrc/tc_chunk.cuh's chain; its train-mode
  forward keeps each layer's bf16 output), how many outputs each model
  misses, computed from the kernel's own inputs;
- how far B3's serving launch (the same chain) lies from each model's
  forward (max |rgb|);
- the gradients' distance (max rel L2 over the unpacked tensors and d pts)
  from the bf16 twin on the card: of B9 (the SIMT body, fp32 FMAs in
  order), of the twin summed on the CPU, and of each model's forward run
  through the twin's backward, which is what B9 would give on that
  product.

With ``--backward``, B1 instead (the vanilla flagship, D=8, W=256, seeded
weights, S=64 and S=192; its bf16 reverse sweep runs on the tensor cores,
csrc/tc_gemm.cuh): the gradients' distance from the bf16 twin of B1 on the
card, of each model with only the backward's products on it (the twin's
forward, tc_model.sweep_field), and of each model with the forward's
products on it too (tc_model.field_forward_model, then the sweep). That
last number says whether B1's forward can move onto the tensor cores under
the 1e-2 bar. ``--backward b4`` does the same for B4 (the T-NeRF flagship,
D=8, W=128, multires 10 / 4, ELU, seeded weights, S=64; its bf16 reverse
sweep runs on the tensor cores with ELU' in the dH epilogue), and
``--backward b7`` for B7's backward with the input cotangent demb at the
MultiRes levels given (D=8, W=256, seeded weights, rays x samples rows on
[-1.2, 1.2]^3, and the training path's case: MultiRes phase 1's 500 rays x
64 samples with raw through the composite, noise std 1, to the squared
error's cotangent against a seeded target, for the twin, the card and each
model alike): the card's gradients and demb against the bf16 twin, the rz
sweep (tc_model.sweep_field with need_demb) on the twin's forward
("backward only"), and on B7's train-mode forward on the model in each of
rz, fold G=4, fold G=1, rn and exact (tc_model.field_forward_model; the
sweep after it on the rz model, as the card's), which says which forward
accumulation holds the bar. ``b8`` does the same for B8 at the vanilla
widths (D=8, W=256, multires 10 / 4) on 010000.tar's fine weights and on
seeded weights, and at the wide pads (multires 20 / 20, 123 / 123 columns)
on seeded weights, rays through the object (the card test's geometry), a
random cotangent and the training path's: the sweep with demb and dvemb,
both carried through the encode's backward to d pts and d viewdirs. ``b5`` is B5
(the D-NeRF canonical field, D=8, W=256, multires 10 / 4, seeded weights,
S=192; its sweep with demb over the 64-column pad runs on the tensor cores),
``b9`` B9 at the MultiRes levels given (the phase-1 case below, rays x
samples, a seeded cotangent of (rgb, acc, depth)): the card's gradients and
d pts against the bf16 twin, each model's (tc_model.sweep_field with
need_demb, carried to d pts) with the twin's forward, and (B5) with the
forward on the model too. ``b7p`` is B7' (the T-NeRF field kernel, ELU and
the colour ReLU; its bf16 backward on the tensor cores with demb and
dvemb) as ``b7``: on chip_smoke.py phase 26's 32,000 rows (500 pixels of
train view 61 of phase 11's scene, written to a temporary directory, x 64
jittered samples) with the round-5 ``800000.tar`` (W=128) and a seeded
W=256 T-NeRF, a random cotangent and the training path's (raw through the
composite with the colour ReLU to the squared error against the pixels),
each masked by the forward's own colour logits > 0, as the kernel's
backward masks them.

    python3 tc_rounding.py [--levels level0 level1 identity] [--rays 500]
    python3 tc_rounding.py --backward [b1] [b4] [b5] [b7] [b7p] [b8] [b9] [--rays 500] [--samples 64] [--levels ...]

Needs a CUDA device; builds the kernels at first use.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

LEVELS = {
    "level0": dict(multires=20, multires_time=8, multires_views=20),
    "level1": dict(multires=10, multires_time=4, multires_views=10),
    "identity": dict(multires=-1, multires_time=-1, multires_views=-1, i_embed=-1),
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--levels", nargs="+", default=list(LEVELS), choices=list(LEVELS))
    ap.add_argument("--rays", type=int, default=500)
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--backward", nargs="*", choices=["b1", "b4", "b5", "b7", "b7p", "b8", "b9"], default=None,
                    help="kernels with the reverse sweep on the tensor cores (no value: b1)")
    a = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch

    if not torch.cuda.is_available():
        print("tc_rounding: needs a CUDA device", file=sys.stderr)
        return 1
    from swnerf_torch.ops.kernels import render_loss as b1
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.kernels import time_net as b6
    from swnerf_torch.ops.kernels.tc_model import composite, field_forward_model, product, rnd32

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    def b6_layers(model, pts):
        """B6's train-mode forward on a scratch this function keeps: the
        packed deformation MLP, its bf16 embedding and each layer's output,
        carved as time_net.cu::carve carves them."""
        N, S, _ = pts.shape
        packed = b6.pack_time_params(model.state_dict(), model.cfg, torch.bfloat16)
        times = torch.rand((N,), generator=torch.Generator(device=dev).manual_seed(5), device=dev)
        M = N * S
        scratch = b6._scratch(packed, M, dev)
        b6._launch_fwd(packed, pts, times, scratch)
        torch.cuda.synchronize()
        CIN, W, ldw = packed.cin_pad, packed.W, packed.W + 8  # PADC
        emb = scratch[: 2 * M * CIN].view(torch.bfloat16).view(M, CIN)[:, : packed.cin].double()
        off = -(-2 * M * CIN // 256) * 256
        hstride = -(-2 * M * ldw // 256) * 256
        hs = [scratch[off + k * hstride: off + k * hstride + 2 * M * ldw].view(torch.bfloat16).view(M, ldw)[:, :W]
              .double() for k in range(packed.D)]
        return packed, emb, hs

    print(f"tc_rounding: {torch.cuda.get_device_name(0)}, {a.rays} rays x {a.samples} samples")
    if a.backward is not None:
        for kernel in a.backward or ["b1"]:
            if kernel == "b1":
                backward_b1(a.rays, dev)
            elif kernel == "b4":
                backward_b4(a.rays, dev)
            elif kernel == "b5":
                backward_b5(a.rays, dev)
            elif kernel == "b7":
                backward_b7(a.rays, a.samples, a.levels, dev)
            elif kernel == "b7p":
                backward_b7p(dev)
            elif kernel == "b8":
                backward_b8(a.rays, a.samples, dev)
            else:
                backward_b9(a.rays, a.samples, a.levels, dev)
        return 0
    for level in a.levels:
        model, packed, args = _mr_case(level, a.rays, a.samples, dev)
        pts, ve, z, dist, noise, gct = args
        N, S = z.shape
        P = N * S
        def names(gg, dp):
            return {k: v.to(dev) for k, v in dict(b1.unpack_grads(gg, packed), dpts=dp).items()}

        _, gr, dr = b1.render_loss_ext_plain(packed, *args, True)
        twin = names(gr, dr)

        def dist_to_twin(got):
            return max(((got[k].double() - twin[k].double()).norm() / twin[k].double().norm()).item() for k in twin)

        fwd = b3.field_forward(packed, None, None, ve, z, None, pts)
        emb, vemb = fwd.emb.double(), fwd.vemb.double()
        tn, temb, hk = b6_layers(model, pts)
        m = {k: v.double() for k, v in tn.matrices().items()}
        bv = {k: v.double() for k, v in tn.bias_vectors().items()}
        misses = {md: [] for md in ("rz", "rn", "exact")}
        for i in range(tn.D):
            x = temb if i == 0 else hk[i - 1]
            for md in misses:
                first = product(temb, m[f"pts{i}_emb"][: tn.cin], None, md) if i == tn.skip + 1 else None
                w0 = m[f"pts{i}"][: x.shape[1]]
                zz = product(x, w0, first, md) + bv[f"pts{i}"]
                h = torch.relu(zz if md == "exact" else rnd32(zz, "rn")).to(torch.bfloat16).double()
                misses[md].append(int((h != hk[i]).sum()))
        print(f"[{level}] B6's trunk ({tn.cin} inputs), {hk[0].numel()} outputs per layer, missed by the model on the "
              f"kernel's own inputs: " + "; ".join(f"{md} {v}" for md, v in misses.items()))
        grads = b1.render_loss_ext(packed, *args, True)
        serve = b3.render_pass(packed, None, None, ve, z, dist, None, True, None, pts)
        pc = dataclasses.replace(packed, weights=packed.weights.cpu(), biases=packed.biases.cpu())
        _, gc, dc = b1.render_loss_ext_plain(pc, *(x.cpu() for x in args), True)
        print(f"[{level}] gradients and d pts, max rel L2 from the bf16 twin: B9 {dist_to_twin(names(*grads[1:])):.3e}"
              f"; the twin summed on the CPU {dist_to_twin(names(gc, dc)):.3e}")
        for mode in ("rz", "rn", "fold", "exact"):
            hs, feat, hv, sigma, logits = field_forward_model(packed, emb, vemb, mode)
            rgb_map, _ = composite(sigma, logits, z, dist, None, True, gct=gct)
            _, graw = composite(sigma, logits, z, dist, noise, True, gct=gct)
            g2, demb, _ = b1.field_reverse_plain(packed, emb.float(), vemb.float(), [h.float() for h in hs],
                                                  feat.float(), hv.float(), graw.float(), need_demb=True)
            d2 = b1.encode_backward(pts.reshape(P, 3), demb, packed.n_freqs).reshape(N, S, 3)
            print(f"[{level}] model {mode:5s}: the serving B3 launch's rgb within "
                  f"{(serve.rgb.double() - rgb_map).abs().max().item():.3e} of its forward; its gradients "
                  f"{dist_to_twin(names(g2, d2)):.3e} from the twin's")
        torch.cuda.empty_cache()
    return 0


def _mr_case(level, n, s, dev, seed=0):
    """tests/test_torch_cuda.py::_wide_case: a MultiRes level's canonical
    field (seeded), jittered sample positions, the view embedding, noise std
    1 and a cotangent of (rgb, acc, depth): (model, bf16 pack, (pts, ve, z,
    dist, noise, gct))."""
    import torch

    from swnerf_torch.models import DirectTemporalNeRF, DNeRFConfig
    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.render.fused_eval import canonical_params

    cfg = DNeRFConfig(netdepth=8, netwidth=256, skips=(4,), **LEVELS[level])
    model = DirectTemporalNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(seed), fused=False)
    o, d, z, dist, _ = _rays(n, s, dev, seed)
    vd = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]
           + 0.05 * torch.randn((n, s, 3), generator=g, device=dev)).contiguous()
    ve = positional_encoding(vd, cfg.nf_views).contiguous()
    noise = torch.randn((n, s), generator=g, device=dev)
    gct = torch.randn((n, 5), generator=g, device=dev)
    return model, b3.pack_params(canonical_params(model.state_dict()), cfg, torch.bfloat16), (pts, ve, z, dist,
                                                                                               noise, gct)


def _pts_models(packed, pts, ve, z, dist, noise, dist_to_twin, forward_too, **loss):
    """Per model, the distance from the twin of B5's / B9's sweep with demb
    on it (tc_model.sweep_field, d pts through encode_backward) from the
    twin's forward and, with forward_too, from the forward on the model."""
    from swnerf_torch.ops.kernels import render_loss as b1
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.kernels.tc_model import composite, field_forward_model, sweep_field

    x = pts.reshape(-1, 3)
    fwd = b3.field_forward(packed, None, None, ve, z, None, pts)

    def sweep(emb, vemb, hs, feat, hv, sigma, logits, mode):
        _, graw = composite(sigma, logits, z, dist, noise, **loss)
        grads, demb, _ = sweep_field(packed, emb, vemb, hs, feat, hv, graw.float(), mode, need_demb=True)
        return dist_to_twin(tuple(t.float() for t in grads), b1.encode_backward(x, demb.float(), packed.n_freqs))

    line = []
    for mode in ("rz", "rn", "exact"):
        text = f"model {mode}: backward only {sweep(*fwd, mode):.3e}"
        if forward_too:
            model_fwd = field_forward_model(packed, fwd.emb, fwd.vemb, mode)
            text += f", forward too {sweep(fwd.emb, fwd.vemb, *model_fwd, mode):.3e}"
        line.append(text)
    return line


def backward_b5(n: int, dev) -> int:
    """B5's gradients and d pts with its sweep on the tensor cores, on the
    card and under each model, against the bf16 twin (module docstring)."""
    import torch

    from swnerf_torch.models import DirectTemporalNeRF, DNeRFConfig
    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import render_loss as b1
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.render.fused_eval import canonical_params

    cfg = DNeRFConfig()
    model = DirectTemporalNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(0), fused=False)
    packed = b3.pack_params(canonical_params(model.state_dict()), cfg, torch.bfloat16)
    o, d, z, dist, g = _rays(n, 192, dev, 192)
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]
           + 0.05 * torch.randn(z.shape + (3,), generator=g, device=dev)).contiguous()
    ve = positional_encoding(d / torch.linalg.norm(d, dim=-1, keepdim=True), cfg.nf_views).contiguous()
    noise = torch.randn(z.shape, generator=g, device=dev)
    target = torch.rand((n, 3), generator=g, device=dev)
    scale = 1.0 / (3 * n)
    _, tg, td = b1.render_loss_pts_plain(packed, pts, ve, z, dist, noise, target, True, scale)
    twin = dict(b1.unpack_grads(tg, packed), dpts=td.reshape(-1, 3))

    def dist_to_twin(grads, dpts):
        got = dict(b1.unpack_grads(grads, packed), dpts=dpts.reshape(-1, 3))
        return max(((got[k].double() - twin[k].double()).norm() / twin[k].double().norm()).item() for k in twin)

    _, card, dcard = b1.render_loss_pts(packed, pts, ve, z, dist, noise, target, True, scale)
    line = [f"the card {dist_to_twin(card, dcard):.3e}"]
    line += _pts_models(packed, pts, ve, z, dist, noise, dist_to_twin, True, white=True, target=target,
                        loss_scale=scale)
    print(f"[B5 S=192] {n} rays, W={packed.W}, {packed.cin} of {packed.cin_pad} input columns, gradients and d pts "
          "max rel L2 from the bf16 twin: " + "; ".join(line))
    torch.cuda.empty_cache()
    return 0


def backward_b9(n: int, s: int, levels, dev) -> int:
    """B9's gradients and d pts with its sweep on the tensor cores, on the
    card and under each model, against the bf16 twin (module docstring)."""
    import torch

    from swnerf_torch.ops.kernels import render_loss as b1

    for level in levels:
        _, packed, (pts, ve, z, dist, noise, gct) = _mr_case(level, n, s, dev)
        _, tg, td = b1.render_loss_ext_plain(packed, pts, ve, z, dist, noise, gct, True)
        twin = dict(b1.unpack_grads(tg, packed), dpts=td.reshape(-1, 3))

        def dist_to_twin(grads, dpts):
            got = dict(b1.unpack_grads(grads, packed), dpts=dpts.reshape(-1, 3))
            return max(((got[k].double() - twin[k].double()).norm() / twin[k].double().norm()).item() for k in twin)

        _, card, dcard = b1.render_loss_ext(packed, pts, ve, z, dist, noise, gct, True)
        line = [f"the card {dist_to_twin(card, dcard):.3e}"]
        line += _pts_models(packed, pts, ve, z, dist, noise, dist_to_twin, False, white=True, gct=gct)
        print(f"[B9 {level}] {n} x {s} rows, wide={packed.wide}, {packed.cin} of {packed.cin_pad} input columns, "
              "gradients and d pts max rel L2 from the bf16 twin: " + "; ".join(line))
        torch.cuda.empty_cache()
    return 0


def backward_b1(n: int, dev) -> int:
    """B1's gradients with the reverse sweep on the tensor cores, on the card
    and under each model, against the bf16 twin (module docstring)."""
    import torch

    from swnerf_torch.models import VanillaNeRF, VanillaNeRFConfig
    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import render_loss as b1
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.kernels.tc_model import composite, field_forward_model, sweep_field

    cfg = VanillaNeRFConfig()
    model = VanillaNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(0), fused=False)
    packed = b3.pack_params(model.state_dict(), cfg, torch.bfloat16)
    for s in (64, 192):
        o, d, z, dist, g = _rays(n, s, dev, s)
        ve = positional_encoding(d / torch.linalg.norm(d, dim=-1, keepdim=True), cfg.nf_views).contiguous()
        noise = torch.randn((n, s), generator=g, device=dev)
        target = torch.rand((n, 3), generator=g, device=dev)
        scale = 1.0 / (3 * n)
        _, twin = b1.render_loss_plain(packed, o, d, ve, z, dist, noise, target, True, scale)
        twin = b1.unpack_grads(twin, packed)

        def dist_to_twin(grads):
            got = b1.unpack_grads(tuple(x.float() for x in grads), packed)
            return max(((got[k].double() - twin[k].double()).norm() / twin[k].double().norm()).item() for k in twin)

        _, card = b1.render_loss(packed, o, d, ve, z, dist, noise, target, True, scale)
        line = [f"the card {dist_to_twin(card):.3e}"]
        fwd = b3.field_forward(packed, o, d, ve, z)
        args = (z, dist, noise, True, target, scale)
        _, graw = composite(fwd.sigma, fwd.logits, *args)
        for mode in ("rz", "rn", "exact"):
            bwd, _, _ = sweep_field(packed, fwd.emb, fwd.vemb, fwd.hs, fwd.feat, fwd.hv, graw.float(), mode)
            hs, feat, hv, sigma, logits = field_forward_model(packed, fwd.emb, fwd.vemb, mode)
            _, graw_m = composite(sigma, logits, *args)
            both, _, _ = sweep_field(packed, fwd.emb, fwd.vemb, hs, feat, hv, graw_m.float(), mode)
            line.append(f"model {mode}: backward only {dist_to_twin(bwd):.3e}, forward too {dist_to_twin(both):.3e}")
        print(f"[B1 S={s}] {n} rays, gradients max rel L2 from the bf16 twin: " + "; ".join(line))
        torch.cuda.empty_cache()
    return 0


def _rays(n, s, dev, seed):
    """n seeded rays toward the origin, s sorted samples in [2, 6], dists."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    o = torch.randn((n, 3), generator=g, device=dev) * 0.3 + torch.tensor([0.0, 0.0, 4.0], device=dev)
    d = torch.randn((n, 3), generator=g, device=dev)
    d[:, 2] = -d[:, 2].abs() - 1.0
    z = torch.sort(torch.rand((n, s), generator=g, device=dev) * 4 + 2, -1).values.contiguous()
    dist = torch.cat([z[:, 1:] - z[:, :-1], torch.full((n, 1), 1e10, device=dev)], -1)
    dist = (dist * torch.linalg.norm(d, dim=-1, keepdim=True)).contiguous()
    return o, d, z, dist, g


def backward_b4(n: int, dev) -> int:
    """B4's gradients with the reverse sweep on the tensor cores, on the card
    and under each model, against the bf16 twin (module docstring)."""
    import torch

    from swnerf_torch.models import TNeRF, TNeRFConfig
    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import render_loss as b1
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.kernels.tc_model import composite, field_forward_model, sweep_field

    cfg = TNeRFConfig()
    model = TNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(0), fused=False)
    packed = b3.pack_tnerf_params(model.state_dict(), cfg, torch.bfloat16)
    o, d, z, dist, g = _rays(n, 64, dev, 64)
    ve = positional_encoding(d / torch.linalg.norm(d, dim=-1, keepdim=True), cfg.nf_views).contiguous()
    times = torch.rand((n,), generator=g, device=dev)
    noise = torch.randn(z.shape, generator=g, device=dev)
    target = torch.rand((n, 3), generator=g, device=dev)
    scale = 1.0 / (3 * n)
    _, twin = b1.render_loss_plain(packed, o, d, ve, z, dist, noise, target, True, scale, times)
    twin = b1.unpack_tnerf_grads(twin, packed)

    def dist_to_twin(grads):
        got = b1.unpack_tnerf_grads(tuple(x.float() for x in grads), packed)
        return max(((got[k].double() - twin[k].double()).norm() / twin[k].double().norm()).item() for k in twin)

    _, card = b1.render_loss(packed, o, d, ve, z, dist, noise, target, True, scale, times)
    line = [f"the card {dist_to_twin(card):.3e}"]
    fwd = b3.field_forward(packed, o, d, ve, z, times)
    args = (z, dist, noise, True, target, scale)
    _, graw = composite(fwd.sigma, fwd.logits, *args, rgb_relu=True)
    for mode in ("rz", "rn", "exact"):
        bwd, _, _ = sweep_field(packed, fwd.emb, fwd.vemb, fwd.hs, fwd.feat, fwd.hv, graw.float(), mode)
        hs, feat, hv, sigma, logits = field_forward_model(packed, fwd.emb, fwd.vemb, mode)
        _, graw_m = composite(sigma, logits, *args, rgb_relu=True)
        both, _, _ = sweep_field(packed, fwd.emb, fwd.vemb, hs, feat, hv, graw_m.float(), mode)
        line.append(f"model {mode}: backward only {dist_to_twin(bwd):.3e}, forward too {dist_to_twin(both):.3e}")
    print(f"[B4 S=64] {n} rays, W={packed.W}, {packed.cin} of {packed.cin_pad} input columns, gradients max rel L2 "
          "from the bf16 twin: " + "; ".join(line))
    torch.cuda.empty_cache()
    return 0


# The forward's accumulations the trunk kernels (B7, B8) can run in train
# mode, cheapest first: (label, tc_model mode, fold group). The sweep after
# each is the card's, on the rz model.
FORWARD_MODES = (("rz", "rz", 1), ("fold G=4", "fold", 4), ("fold G=1", "fold", 1), ("rn", "rn", 1),
                 ("exact", "exact", 1))


def _trunk_rows(packed, e, v, cot_of, sweep_to, dist_to_twin, need_dvemb):
    """Per forward mode (FORWARD_MODES), the distance from the twin of the
    gradients (and the input cotangents, ``sweep_to``) of the trunk's
    forward on the model, the cotangent it gives (``cot_of(sigma,
    logits)``), and the sweep on the rz model; first the rz sweep from the
    twin's own forward ("backward only")."""
    from swnerf_torch.ops.kernels.render_pass import field_mlp
    from swnerf_torch.ops.kernels.tc_model import field_forward_model, sweep_field

    def swept(fwd):
        hs, feat, hv, sigma, logits = fwd
        out = sweep_field(packed, e, v, hs, feat, hv, cot_of(sigma, logits), "rz", need_demb=True,
                          need_dvemb=need_dvemb)
        return dist_to_twin(*sweep_to(*out))

    line = [f"backward only {swept(field_mlp(packed, e, v)):.3e}"]
    for label, mode, group in FORWARD_MODES:
        line.append(f"forward {label} {swept(field_forward_model(packed, e, v, mode, group)):.3e}")
    return line


def backward_b7(n: int, s: int, levels, dev) -> int:
    """B7's gradients and demb, its backward on the tensor cores, on the card
    and with each forward mode on the model, against the bf16 twin, on two
    cases per level (module docstring)."""
    import torch

    from swnerf_torch.models import DirectTemporalNeRF, DNeRFConfig
    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import trunk as b7
    from swnerf_torch.ops.kernels.tc_model import composite

    for level in levels:
        cfg = DNeRFConfig(netdepth=8, netwidth=256, skips=(4,), **LEVELS[level])
        model = DirectTemporalNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(0), fused=False)
        packed = b7.pack_trunk_params(model._occ.state_dict(), cfg, torch.bfloat16)
        P = n * s
        # the random cotangent on points of [-1.2, 1.2]^3
        g = torch.Generator(device=dev).manual_seed(1)
        pts = torch.rand((P, 3), generator=g, device=dev) * 2.4 - 1.2
        vd = torch.randn((n, 3), generator=g, device=dev)
        vd = (vd / torch.linalg.norm(vd, dim=-1, keepdim=True))[:, None, :].expand(n, s, 3).reshape(P, 3)
        cases = [("random cotangent", positional_encoding(pts, cfg.nf_pts).contiguous(),
                  positional_encoding(vd, cfg.nf_views).contiguous(), None,
                  torch.randn((P, 4), generator=g, device=dev))]
        # the training path's: MultiRes phase 1's rays x samples, raw through
        # the composite (noise std 1) to the squared error's cotangent
        o, d, z, dist, g = _rays(n, s, dev, 7)
        pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(P, 3)
        vd = (d / torch.linalg.norm(d, dim=-1, keepdim=True))[:, None, :].expand(n, s, 3).reshape(P, 3)
        loss = (z, dist, torch.randn((n, s), generator=g, device=dev), True,
                torch.rand((n, 3), generator=g, device=dev), 1.0 / (3 * n))
        cases.append(("training path", positional_encoding(pts, cfg.nf_pts).contiguous(),
                      positional_encoding(vd, cfg.nf_views).contiguous(), loss, None))
        for name, emb, vemb, loss, cot in cases:
            def cot_of(sigma, logits, cot=cot, loss=loss):
                return cot if loss is None else composite(sigma, logits, *loss)[1].float()

            raw = b7.trunk_plain(packed, emb, vemb)
            gt, dt, _ = b7.trunk_plain_bwd(packed, emb, vemb, cot_of(raw[:, 3], raw[:, :3]))
            twin = dict(b7.unpack_trunk_grads(gt, packed), demb=dt)

            def dist_to_twin(grads, demb):
                got = dict(b7.unpack_trunk_grads(tuple(x.float() for x in grads), packed), demb=demb.float())
                return max(((got[k].double() - twin[k].double()).norm() / twin[k].double().norm()).item()
                           for k in twin)

            sc = b7._scratch(packed, P, dev)
            rk = b7._launch_fwd(packed, emb, vemb, sc)
            card, dcard, _ = b7._launch_bwd(packed, P, cot_of(rk[:, 3], rk[:, :3]).contiguous(), sc, True, False)
            line = [f"the card {dist_to_twin(card, dcard):.3e}"]
            e, v = b7._padded(packed, emb, vemb)
            line += _trunk_rows(packed, e, v, cot_of, lambda gr, de, _: (gr, de), dist_to_twin, False)
            print(f"[B7 {level}, {name}] {P} rows, {packed.cin} of {packed.cin_pad} input columns, gradients and "
                  "demb max rel L2 from the bf16 twin, the sweep on the rz model: " + "; ".join(line))
            del sc
            torch.cuda.empty_cache()
    return 0


def backward_b7p(dev) -> int:
    """B7''s gradients, demb and dvemb, its backward on the tensor cores, on
    the card and with each forward mode on the model, against the bf16
    twin: 800000.tar's weights and a seeded W=256 T-NeRF on phase 26's
    rows, a random cotangent and the training path's (module docstring)."""
    import shutil
    import tempfile

    import torch

    import chip_smoke
    from swnerf_torch.models import TNeRF, TNeRFConfig
    from swnerf_torch.ops.kernels import trunk as b7
    from swnerf_torch.ops.kernels.tc_model import composite
    from swnerf_torch.train.checkpoint import load_tar, tnerf_state_dict

    tmp = Path(tempfile.mkdtemp(prefix="tc_rounding_b7p_"))
    try:
        data = chip_smoke.phase11_scene(dev, tmp / "scene")
        cfg = TNeRFConfig()
        emb, vemb, cot, loss = chip_smoke.b7p_rows(dev, data, cfg)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    P = emb.shape[0]
    wide = TNeRFConfig(net_dim=256)
    weights = {"800000.tar": (cfg, {k: v.to(dev) for k, v in tnerf_state_dict(
                   load_tar(str(chip_smoke.TNERF_CKPT))["network_fn_state_dict"]).items()}),
               "seeded W=256": (wide, TNeRF(wide, device=dev, generator=torch.Generator().manual_seed(0),
                                            fused=False).state_dict())}
    for wname, (c, sd) in weights.items():
        packed = b7.pack_tnerf_trunk_params(sd, c, torch.bfloat16)
        for name, lo in (("random cotangent", None), ("training path", loss)):
            def cot_of(sigma, logits, lo=lo):
                """The cotangent of raw, masked by the forward's colour logits > 0."""
                if lo is not None:
                    return composite(sigma, logits, *lo, rgb_relu=True)[1].float()
                return torch.cat([torch.where(logits > 0, cot[:, :3], torch.zeros_like(cot[:, :3])), cot[:, 3:]], -1)

            raw = b7.trunk_plain(packed, emb, vemb)
            gt, dt, dvt = b7.trunk_plain_bwd(packed, emb, vemb, cot_of(raw[:, 3], raw[:, :3]), True, True)
            twin = dict(b7.unpack_trunk_grads(gt, packed), demb=dt, dvemb=dvt)

            def dist_to_twin(grads, demb, dvemb):
                got = dict(b7.unpack_trunk_grads(tuple(x.float() for x in grads), packed), demb=demb.float(),
                           dvemb=dvemb.float())
                return max(((got[k].double() - twin[k].double()).norm() / twin[k].double().norm()).item()
                           for k in twin)

            sc = b7._scratch(packed, P, dev)
            rk = b7._launch_fwd(packed, emb, vemb, sc)
            card, dcard, dvcard = b7._launch_bwd(packed, P, cot_of(rk[:, 3], rk[:, :3]).contiguous(), sc, True, True)
            line = [f"the card {dist_to_twin(card, dcard, dvcard):.3e}"]
            e, v = b7._padded(packed, emb, vemb)
            line += _trunk_rows(packed, e, v, cot_of, lambda gr, de, dv: (gr, de, dv), dist_to_twin, True)
            print(f"[B7' {wname}, {name}] {P} rows, W={packed.W}, {packed.cin} / {packed.input_ch_views} of 128 input "
                  "columns, gradients, demb and dvemb max rel L2 from the bf16 twin, the sweep on the rz model: "
                  + "; ".join(line))
            del sc
            torch.cuda.empty_cache()
    return 0


def backward_b8(n: int, s: int, dev) -> int:
    """B8's gradients, d pts and d viewdirs, its backward on the tensor cores
    (demb and dvemb), on the card and with each forward mode on the model,
    against the bf16 twin: the vanilla widths on 010000.tar's fine weights
    and on seeded weights, a random cotangent (the card test's case) and the
    training path's (module docstring)."""
    import torch

    from swnerf_torch.models import VanillaNeRF, VanillaNeRFConfig
    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import trunk as b7
    from swnerf_torch.ops.kernels.render_loss import encode_backward
    from swnerf_torch.ops.kernels.tc_model import composite
    from swnerf_torch.train.checkpoint import load_tar, vanilla_state_dict

    cfg, wide = VanillaNeRFConfig(), VanillaNeRFConfig(multires=20, multires_views=20)
    ckpt = Path(__file__).resolve().parent / "benchmarks" / "full_scale" / "logs" / "full_nerf_200k" / "010000.tar"

    def seeded(c):
        return VanillaNeRF(c, device=dev, generator=torch.Generator().manual_seed(0), fused=False).state_dict()

    weights = {"010000.tar": (cfg, {k: v.to(dev) for k, v in
                                    vanilla_state_dict(load_tar(str(ckpt))["network_fine_state_dict"]).items()}),
               "seeded": (cfg, seeded(cfg)), "seeded, wide pads": (wide, seeded(wide))}
    P = n * s
    o, d, z, dist, g = _rays(n, s, dev, 8)
    o = o * torch.tensor([1.0, 1.0, 0.0], device=dev)  # rays through the object, as the card test's
    pts = (o[:, None, :] + d[:, None, :] * (z[..., None] - 4.0) * 0.4).reshape(P, 3).contiguous()
    vd = (d / torch.linalg.norm(d, dim=-1, keepdim=True))[:, None, :].expand(n, s, 3).reshape(P, 3).contiguous()
    loss = (z, dist, torch.randn((n, s), generator=g, device=dev), True, torch.rand((n, 3), generator=g, device=dev),
            1.0 / (3 * n))
    cot = torch.randn((P, 4), generator=g, device=dev)
    for wname, (c, sd) in weights.items():
        packed = b7.pack_trunk_params(sd, c, torch.bfloat16)
        lp, lv = packed.n_freqs
        for name, lo in (("random cotangent", None), ("training path", loss)):
            def cot_of(sigma, logits, lo=lo):
                return cot if lo is None else composite(sigma, logits, *lo)[1].float()

            raw = b7.field_raw_plain(packed, pts, vd)
            gt, dpt, dvt = b7.field_raw_plain_bwd(packed, pts, vd, cot_of(raw[:, 3], raw[:, :3]))
            twin = dict(b7.unpack_trunk_grads(gt, packed), dpts=dpt, dviewdirs=dvt)

            def dist_to_twin(grads, dp, dv):
                got = dict(b7.unpack_trunk_grads(tuple(x.float() for x in grads), packed), dpts=dp, dviewdirs=dv)
                return max(((got[k].double() - twin[k].double()).norm() / twin[k].double().norm()).item()
                           for k in twin)

            def to_inputs(grads, demb, dvemb):
                return grads, encode_backward(pts, demb.float(), lp), encode_backward(vd, dvemb.float(), lv)

            sc = b7._scratch(packed, P, dev, raw=True)
            rk = b7._launch_fwd(packed, pts, vd, sc, raw=True)
            card, dpc, dvc = b7._launch_bwd(packed, P, cot_of(rk[:, 3], rk[:, :3]).contiguous(), sc, True, True,
                                            (pts, vd))
            line = [f"the card {dist_to_twin(card, dpc, dvc):.3e}"]
            e, v = b7._padded(packed, positional_encoding(pts, lp), positional_encoding(vd, lv))
            line += _trunk_rows(packed, e, v, cot_of, to_inputs, dist_to_twin, True)
            print(f"[B8 {wname}, {name}] {P} rows, {packed.cin} / {packed.input_ch_views} of 128 input columns, "
                  "gradients, d pts and d viewdirs max rel L2 from the bf16 twin, the sweep on the rz model: "
                  + "; ".join(line))
            del sc
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
