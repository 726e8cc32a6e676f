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
[-1.2, 1.2]^3): the card's gradients and demb against the bf16 twin, and
each model's (tc_model.sweep_trunk) on the twin's forward.

    python3 tc_rounding.py [--levels level0 level1 identity] [--rays 500]
    python3 tc_rounding.py --backward [b1] [b4] [b7] [--rays 500] [--levels ...]

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
    ap.add_argument("--backward", nargs="*", choices=["b1", "b4", "b7"], default=None,
                    help="kernels with the reverse sweep on the tensor cores (no value: b1)")
    a = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch

    if not torch.cuda.is_available():
        print("tc_rounding: needs a CUDA device", file=sys.stderr)
        return 1
    from swnerf_torch.models import DirectTemporalNeRF, DNeRFConfig
    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import render_loss as b1
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.kernels import time_net as b6
    from swnerf_torch.ops.kernels.tc_model import composite, field_forward_model, product, rnd32
    from swnerf_torch.render.fused_eval import canonical_params

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    def case(level, n, s, seed=0):
        """tests/test_torch_cuda.py::_wide_case: the canonical field, jittered
        sample positions, the view embedding, noise std 1 and a cotangent."""
        cfg = DNeRFConfig(netdepth=8, netwidth=256, skips=(4,), **LEVELS[level])
        model = DirectTemporalNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(seed), fused=False)
        g = torch.Generator(device=dev).manual_seed(seed)
        o = torch.randn((n, 3), generator=g, device=dev) * 0.3 + torch.tensor([0.0, 0.0, 4.0], device=dev)
        d = torch.randn((n, 3), generator=g, device=dev)
        d[:, 2] = -d[:, 2].abs() - 1.0
        z = torch.sort(torch.rand((n, s), generator=g, device=dev) * 4 + 2, -1).values.contiguous()
        dist = torch.cat([z[:, 1:] - z[:, :-1], torch.full((n, 1), 1e10, device=dev)], -1)
        dist = (dist * torch.linalg.norm(d, dim=-1, keepdim=True)).contiguous()
        vd = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        pts = (o[:, None, :] + d[:, None, :] * z[..., None]
               + 0.05 * torch.randn((n, s, 3), generator=g, device=dev)).contiguous()
        ve = positional_encoding(vd, cfg.nf_views).contiguous()
        noise = torch.randn((n, s), generator=g, device=dev)
        gct = torch.randn((n, 5), generator=g, device=dev)
        return model, b3.pack_params(canonical_params(model.state_dict()), cfg, torch.bfloat16), (pts, ve, z, dist,
                                                                                                   noise, gct)

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
            else:
                backward_b7(a.rays, a.samples, a.levels, dev)
        return 0
    for level in a.levels:
        model, packed, args = case(level, a.rays, a.samples)
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
            bwd = sweep_field(packed, fwd.emb, fwd.vemb, fwd.hs, fwd.feat, fwd.hv, graw.float(), mode)
            hs, feat, hv, sigma, logits = field_forward_model(packed, fwd.emb, fwd.vemb, mode)
            _, graw_m = composite(sigma, logits, *args)
            both = sweep_field(packed, fwd.emb, fwd.vemb, hs, feat, hv, graw_m.float(), mode)
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
        bwd = sweep_field(packed, fwd.emb, fwd.vemb, fwd.hs, fwd.feat, fwd.hv, graw.float(), mode)
        hs, feat, hv, sigma, logits = field_forward_model(packed, fwd.emb, fwd.vemb, mode)
        _, graw_m = composite(sigma, logits, *args, rgb_relu=True)
        both = sweep_field(packed, fwd.emb, fwd.vemb, hs, feat, hv, graw_m.float(), mode)
        line.append(f"model {mode}: backward only {dist_to_twin(bwd):.3e}, forward too {dist_to_twin(both):.3e}")
    print(f"[B4 S=64] {n} rays, W={packed.W}, {packed.cin} of {packed.cin_pad} input columns, gradients max rel L2 "
          "from the bf16 twin: " + "; ".join(line))
    torch.cuda.empty_cache()
    return 0


def backward_b7(n: int, s: int, levels, dev) -> int:
    """B7's gradients and demb with its backward on the tensor cores, on the
    card and under each model, against the bf16 twin (module docstring)."""
    import torch

    from swnerf_torch.models import DirectTemporalNeRF, DNeRFConfig
    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import trunk as b7
    from swnerf_torch.ops.kernels.render_pass import field_mlp
    from swnerf_torch.ops.kernels.tc_model import sweep_trunk

    for level in levels:
        cfg = DNeRFConfig(netdepth=8, netwidth=256, skips=(4,), **LEVELS[level])
        model = DirectTemporalNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(0), fused=False)
        packed = b7.pack_trunk_params(model._occ.state_dict(), cfg, torch.bfloat16)
        g = torch.Generator(device=dev).manual_seed(1)
        P = n * s
        pts = torch.rand((P, 3), generator=g, device=dev) * 2.4 - 1.2
        vd = torch.randn((n, 3), generator=g, device=dev)
        vd = (vd / torch.linalg.norm(vd, dim=-1, keepdim=True))[:, None, :].expand(n, s, 3).reshape(P, 3)
        emb = positional_encoding(pts, cfg.nf_pts).contiguous()
        vemb = positional_encoding(vd, cfg.nf_views).contiguous()
        cot = torch.randn((P, 4), generator=g, device=dev)
        gt, dt, _ = b7.trunk_plain_bwd(packed, emb, vemb, cot)
        twin = dict(b7.unpack_trunk_grads(gt, packed), demb=dt)

        def dist_to_twin(grads, demb):
            got = dict(b7.unpack_trunk_grads(tuple(x.float() for x in grads), packed), demb=demb)
            return max(((got[k].double() - twin[k].double()).norm() / twin[k].double().norm()).item() for k in twin)

        _, card, dcard, _ = b7.trunk_fwd_bwd(packed, emb, vemb, cot)
        line = [f"the card {dist_to_twin(card, dcard):.3e}"]
        e, v = b7._padded(packed, emb, vemb)
        hs, feat, hv, _, _ = field_mlp(packed, e, v)
        for mode in ("rz", "rn", "exact"):
            line.append(f"model {mode} {dist_to_twin(*sweep_trunk(packed, e, v, hs, feat, hv, cot, mode)):.3e}")
        print(f"[B7 {level}] {P} rows, {packed.cin} of {packed.cin_pad} input columns, gradients and demb max rel "
              "L2 from the bf16 twin: " + "; ".join(line))
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
