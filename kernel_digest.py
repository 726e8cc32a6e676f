#!/usr/bin/env python3
"""Digest and time the kernels of one checkout of swnerf_torch on the card:
B2 sample_pdf, B3 render_pass (vanilla, from rays, and its pts mode), B1
render_loss (vanilla), B4 (T-NeRF, both modes), B5 render_loss_pts, B6
time_net (forward, and forward with backward), B7 trunk (the ReLU family:
forward only, and train-mode forward with backward) and, where the checkout
has them, B7' (the ELU T-NeRF trunk: train mode with backward, and forward
only at the serving chunk's 2.1M rows), B8 (the trunk with the encode in
the kernel; forward only at a mesh tile, and train mode with backward),
B7's forward only at MultiRes level 0's widths, the mesh sweep
(extract_mesh.sample_grid at 128^3 x 100 views, one timed run), B3's pts
mode at the MultiRes widths, B9 (the external-cotangent backward, wide and
narrow), B10 (sample + merge) and B11
(the deformation MLP's backward with input cotangents, at the D-NeRF pad's
96,000 rows and MultiRes level 0's 32,000), on seeded inputs at
the main paths' shapes. Two checkouts whose digests agree give
bit-equal outputs; run both in one call, in turns, to compare their times on
one card:

    python3 kernel_digest.py --root <checkout> [--reps N]

Prints one JSON line: the card, its SM clock after the run, and per
kernel and operand type the sha256 of its outputs (a train-mode entry:
``fwd``, of its forward outputs, and ``grads``, of its gradients and input
cotangents) and its mean milliseconds per launch (CUDA events, after a
warm-up; the train-mode entries of B5, B7, B8 and B9 also ``fwd_ms``, their
SIMT forward's device ms alone from torch.profiler; B6's entries also
``ms_bwd``, the backward launch alone; B2's and B10's also ``alone_ms``, queued behind a
sleep, and at a training step's 1,024 rays the wrapper's host microseconds
a call, ``step_host_us``, and B2's ``step_alone_ms``; the forward-only
entries of B6, B7, B7' and B8 also ``host_us``, the wrapper's host
microseconds a call at 1,024 to 1,536 rows). B6's train mode
runs at the D-NeRF widths and at MultiRes level 0's (144 input rows,
32,000 rows). Needs a CUDA device;
builds the checkout's kernels at first use.

    python3 kernel_digest.py --diff <run.json> <run.json> ...

compares saved runs (each the printed line, or a file holding it) digest by
digest against the first, and prints the entries that differ.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path


DIGESTS = ("sha256", "fwd", "grads")


def diff(paths) -> int:
    """Print, per later run, the digests that differ from the first run's."""
    runs = []
    for p in paths:
        lines = [ln for ln in Path(p).read_text().splitlines() if ln.startswith('{"root"')]
        runs.append(json.loads(lines[-1]))
    base = runs[0]["kernels"]
    for path, run in zip(paths[1:], runs[1:]):
        kern = run["kernels"]
        differ = [f"{name} {d}" for name in base for d in DIGESTS
                  if d in base[name] and name in kern and kern[name].get(d) != base[name][d]]
        n = sum(d in v for v in base.values() for d in DIGESTS)
        print(f"{path} against {paths[0]}: {len(differ)} of {n} digests differ" + "".join(f"\n  {x}" for x in differ))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent), help="the checkout to load")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--diff", nargs="+", metavar="RUN", help="compare saved runs instead of running")
    a = ap.parse_args()
    if a.diff:
        return diff(a.diff)
    sys.path.insert(0, str(Path(a.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("kernel_digest: needs a CUDA device", file=sys.stderr)
        return 1
    from swnerf_torch.models import DirectTemporalNeRF, DNeRFConfig, TNeRF, TNeRFConfig, VanillaNeRF, VanillaNeRFConfig
    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import build
    from swnerf_torch.ops.kernels import render_loss as b1
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.kernels import sample_pdf as b2
    from swnerf_torch.ops.kernels import time_net as b6
    from swnerf_torch.ops.kernels import trunk as b7
    from swnerf_torch.render.fused_eval import canonical_params

    assert Path(b3.__file__).resolve().is_relative_to(Path(a.root).resolve()), b3.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    build.build()

    def rays(n, s, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        o = torch.randn((n, 3), generator=g, device=dev) * 0.3 + torch.tensor([0.0, 0.0, 4.0], device=dev)
        d = torch.randn((n, 3), generator=g, device=dev)
        d[:, 2] = -d[:, 2].abs() - 1.0
        z = torch.sort(torch.rand((n, s), generator=g, device=dev) * 4 + 2, -1).values.contiguous()
        dist = torch.cat([z[:, 1:] - z[:, :-1], torch.full((n, 1), 1e10, device=dev)], -1)
        dist = (dist * torch.linalg.norm(d, dim=-1, keepdim=True)).contiguous()
        vd = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        noise = torch.randn((n, s), generator=g, device=dev)
        target = torch.rand((n, 3), generator=g, device=dev)
        times = torch.rand((n,), generator=g, device=dev)
        return o, d, vd, z, dist, noise, target, times

    def train(res, grads, ms, fn=None, **extra):
        """A train-mode entry: the forward outputs' and the gradients' digests
        apart; with fn (the timed call), also ``fwd_ms``, the SIMT train-mode
        forward's own device ms a call."""
        out = {"fwd": digest(res), "grads": digest(grads), "ms": ms, **extra}
        if fn is not None:
            out["fwd_ms"] = fwd_ms(fn)
        return out

    def fwd_ms(fn, reps=5):
        """Device ms a call of the SIMT train-mode forwards (trunk_fwd_kernel,
        render_loss_fwd_kernel) inside fn, from torch.profiler's CUDA
        activity over ``reps`` calls (after 32 short spins, which keep the
        window's first records), or None where fn runs neither."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(32):
                torch.cuda._sleep(100_000)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum((getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0))
                 for e in prof.key_averages() if "trunk_fwd_kernel" in e.key or "render_loss_fwd_kernel" in e.key)
        return us / 1e3 / reps if us else None

    def digest(out):
        h = hashlib.sha256()
        for x in out:
            if isinstance(x, (tuple, list)):
                x = torch.cat([y.reshape(-1) for y in x])
            h.update(x.detach().contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(a.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / a.reps

    def alone(fn, reps=50):
        """As timed, with the launches queued behind a ~0.1 s sleep kernel:
        the device's time alone, without the host's time to issue them."""
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def host_us(fn, reps=200):
        """Host microseconds a call: the wall time to issue ``reps`` calls."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / reps * 1e6

    def b6_train(packed, pts, times, cot):
        """B6's train-mode forward and backward: digests, the pair's time and
        the backward launch's alone (on the forward's scratch)."""
        dx, grads = b6.time_net_fwd_bwd(packed, pts, times, cot)
        m = pts.shape[0] * pts.shape[1]
        sc = b6._scratch(packed, m, dev)
        b6._launch_fwd(packed, pts, times, sc)
        g = cot.reshape(m, 3).contiguous()
        ms_bwd = timed(lambda: b6._launch_bwd(packed, m, g, sc))
        return train([dx], list(grads), timed(lambda: b6.time_net_fwd_bwd(packed, pts, times, cot)), ms_bwd=ms_bwd)

    def b11_train(packed, pts, times, cot):
        """B11: B6's train-mode forward on B11's scratch, then the backward
        with d pts and d times: digests, and the backward launch's time."""
        m = pts.shape[0] * pts.shape[1]
        sc = b6._din_scratch(packed, m, dev)
        dx = b6._launch_fwd(packed, pts, times, sc)
        g = cot.reshape(m, 3).contiguous()
        res = b6._launch_bwd_din(packed, pts, times, g, sc)
        return train([dx], [*res[0], res[1], res[2]], timed(lambda: b6._launch_bwd_din(packed, pts, times, g, sc)))

    out = {}
    vcfg, tcfg = VanillaNeRFConfig(), TNeRFConfig()
    vsd = VanillaNeRF(vcfg, device=dev, generator=torch.Generator().manual_seed(0)).state_dict()
    tsd = TNeRF(tcfg, device=dev, generator=torch.Generator().manual_seed(1)).state_dict()
    dcfg = DNeRFConfig()
    dsd = DirectTemporalNeRF(dcfg, device=dev, generator=torch.Generator().manual_seed(3)).state_dict()
    canon = {k[len("_occ."):]: v for k, v in dsd.items() if k.startswith("_occ.")}

    g = torch.Generator(device=dev).manual_seed(2)
    bins = torch.sort(torch.rand((32768, 63), generator=g, device=dev) * 4 + 2, -1).values
    w = torch.rand((32768, 64), generator=g, device=dev)[:, 1:-1]
    u = torch.linspace(0.0, 1.0, 128, device=dev).expand(32768, 128)
    step = (bins[:1024], w[:1024], u[:1024])  # a vanilla training step's rays
    out["sample_pdf"] = {"sha256": digest([b2.sample_pdf(bins, w, u)]), "ms": timed(lambda: b2.sample_pdf(bins, w, u)),
                         "alone_ms": alone(lambda: b2.sample_pdf(bins, w, u)),
                         "step_alone_ms": alone(lambda: b2.sample_pdf(*step)),
                         "step_host_us": host_us(lambda: b2.sample_pdf(*step))}
    if hasattr(b2, "sample_pdf_merge"):  # B10, on the coarse depths the bins are the midpoints of
        zc = torch.cat([bins[:, :1] - 0.01, 0.5 * (bins[:, 1:] + bins[:, :-1]), bins[:, -1:] + 0.01], -1)
        zc = torch.sort(zc, -1).values.contiguous()
        out["sample_pdf_merge"] = {"sha256": digest([b2.sample_pdf_merge(zc, bins, w, u)]),
                                   "ms": timed(lambda: b2.sample_pdf_merge(zc, bins, w, u)),
                                   "alone_ms": alone(lambda: b2.sample_pdf_merge(zc, bins, w, u)),
                                   "step_host_us": host_us(lambda: b2.sample_pdf_merge(zc[:1024], *step))}

    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        pv = b3.pack_params(vsd, vcfg, dtype)
        pt = b3.pack_tnerf_params(tsd, tcfg, dtype)
        for s in (64, 192):
            o, d, vd, z, dist, noise, target, _ = rays(32768, s, s)
            ve = positional_encoding(vd, vcfg.nf_views).contiguous()
            args = (pv, o, d, ve, z, dist, None, True)
            out[f"render_pass[S={s}] {tag}"] = {"sha256": digest(b3.render_pass(*args)),
                                                "ms": timed(lambda: b3.render_pass(*args))}
            o, d, vd, z, dist, noise, target, _ = rays(1024, s, 10 + s)
            ve = positional_encoding(vd, vcfg.nf_views).contiguous()
            args = (pv, o, d, ve, z, dist, noise, target, True, 1.0 / 3072)
            res, grads = b1.render_loss(*args)
            out[f"render_loss[S={s}] {tag}"] = train(list(res), list(grads), timed(lambda: b1.render_loss(*args)))
        o, d, vd, z, dist, noise, target, t = rays(32768, 64, 3)
        ve = positional_encoding(vd, tcfg.nf_views).contiguous()
        args = (pt, o, d, ve, z, dist, None, True, t)
        out[f"render_pass[tnerf,S=64] {tag}"] = {"sha256": digest(b3.render_pass(*args)),
                                                 "ms": timed(lambda: b3.render_pass(*args))}
        o, d, vd, z, dist, noise, target, t = rays(500, 64, 4)
        ve = positional_encoding(vd, tcfg.nf_views).contiguous()
        args = (pt, o, d, ve, z, dist, noise, target, True, 1.0 / 1500, t)
        res, grads = b1.render_loss(*args)
        out[f"render_loss[tnerf,S=64] {tag}"] = train(list(res), list(grads), timed(lambda: b1.render_loss(*args)))
        # D-NeRF (its main paths' shapes): B3's pts mode at the serving chunk, B5 at
        # 500 x 192, B6 forward at the serving chunk's fine rows and forward
        # with backward at the TV pair's 2 x 500 x 192 rows
        pc = b3.pack_params(canon, dcfg, dtype)
        pt6 = b6.pack_time_params(dsd, dcfg, dtype)
        for s in (64, 192):
            o, d, vd, z, dist, noise, target, t = rays(32768, s, 20 + s)
            pts = (o[:, None, :] + d[:, None, :] * z[..., None]).contiguous()
            ve = positional_encoding(vd, dcfg.nf_views).contiguous()
            args = (pc, None, None, ve, z, dist, None, True, None, pts)
            out[f"render_pass[pts,S={s}] {tag}"] = {"sha256": digest(b3.render_pass(*args)),
                                                    "ms": timed(lambda: b3.render_pass(*args))}
            if s == 192:
                out[f"time_net {tag}"] = {"sha256": digest([b6.time_net(pt6, pts, t)]),
                                          "ms": timed(lambda: b6.time_net(pt6, pts, t)),
                                          "host_us": host_us(lambda: b6.time_net(pt6, pts[:8], t[:8]))}
        o, d, vd, z, dist, noise, target, t = rays(500, 192, 5)
        pts = (o[:, None, :] + d[:, None, :] * z[..., None]).contiguous()
        ve = positional_encoding(vd, dcfg.nf_views).contiguous()
        args = (pc, pts, ve, z, dist, noise, target, True, 1.0 / 1500)
        res, grads, dpts = b1.render_loss_pts(*args)
        out[f"render_loss[pts,S=192] {tag}"] = train(list(res), list(grads) + [dpts],
                                                     timed(lambda: b1.render_loss_pts(*args)),
                                                     lambda: b1.render_loss_pts(*args))
        pair, t2 = torch.cat([pts, pts]).contiguous(), torch.cat([t, torch.full_like(t, 0.41)]).contiguous()
        cot = torch.randn(pair.shape, generator=torch.Generator(device=dev).manual_seed(6), device=dev)
        out[f"time_net+bwd {tag}"] = b6_train(pt6, pair, t2, cot)
        if hasattr(b6, "_launch_bwd_din"):  # B11 at the D-NeRF pad (84 of 96 columns), 96,000 rows
            out[f"time_net[pts,bwd,dnerf] {tag}"] = b11_train(pt6, pts, t, cot[:500])
        # B6 at MultiRes level 0's widths (Lx 20, Lt 8: 144 input rows), one
        # phase-1 step's 500 x 64 rows
        m0 = DirectTemporalNeRF(DNeRFConfig(multires=20, multires_time=8, multires_views=20), device=dev,
                                generator=torch.Generator().manual_seed(14))
        pm0 = b6.pack_time_params(m0.state_dict(), m0.cfg, dtype)
        o, d, vd, z, dist, noise, target, t = rays(500, 64, 15)
        pts = (o[:, None, :] + d[:, None, :] * z[..., None]).contiguous()
        cot = torch.randn(pts.shape, generator=torch.Generator(device=dev).manual_seed(16), device=dev)
        out[f"time_net+bwd[multires] {tag}"] = b6_train(pm0, pts, t, cot)
        # B7 (ReLU) at the vanilla widths (63 / 27 columns): forward only at a
        # mesh tile's 204,800 rows, train mode with the backward (and demb) at
        # 65,536 rows; at MultiRes level 0's widths (123 / 123) at 32,000 rows
        g7 = torch.Generator(device=dev).manual_seed(7)
        mcfg = DNeRFConfig(multires=20, multires_views=20)
        msd = VanillaNeRF(mcfg, device=dev, generator=torch.Generator().manual_seed(8)).state_dict()
        for name, cfg7, sd7, rows in (("trunk", vcfg, vsd, 65536), ("trunk[multires]", mcfg, msd, 32000)):
            p7 = b7.pack_trunk_params(sd7, cfg7, dtype)
            emb = torch.rand((rows, cfg7.input_ch), generator=g7, device=dev) * 2 - 1
            vemb = torch.rand((rows, cfg7.input_ch_views), generator=g7, device=dev) * 2 - 1
            gr7 = torch.randn((rows, 4), generator=g7, device=dev)
            res7 = b7.trunk_fwd_bwd(p7, emb, vemb, gr7, True, False)
            out[f"{name}+bwd {tag}"] = train([res7[0]], [*res7[1], res7[2]],
                                             timed(lambda: b7.trunk_fwd_bwd(p7, emb, vemb, gr7, True, False)),
                                             lambda: b7.trunk_fwd_bwd(p7, emb, vemb, gr7, True, False))
            if name == "trunk[multires]":  # forward only at the wide pads
                out[f"trunk[multires] {tag}"] = {"sha256": digest([b7.trunk(p7, emb, vemb)]),
                                                 "ms": timed(lambda: b7.trunk(p7, emb, vemb))}
            if name == "trunk":
                big = torch.rand((204800, cfg7.input_ch), generator=g7, device=dev) * 2 - 1
                bigv = torch.rand((204800, cfg7.input_ch_views), generator=g7, device=dev) * 2 - 1
                out[f"trunk {tag}"] = {"sha256": digest([b7.trunk(p7, big, bigv)]),
                                       "ms": timed(lambda: b7.trunk(p7, big, bigv)),
                                       "host_us": host_us(lambda: b7.trunk(p7, big[:1024], bigv[:1024]))}
        if hasattr(b7, "pack_tnerf_trunk_params"):  # B7' and B8
            pt7 = b7.pack_tnerf_trunk_params(tsd, tcfg, dtype)
            emb = torch.rand((32000, pt7.cin), generator=g7, device=dev) * 2 - 1
            vemb = torch.rand((32000, pt7.input_ch_views), generator=g7, device=dev) * 2 - 1
            gr7 = torch.randn((32000, 4), generator=g7, device=dev)
            res7 = b7.trunk_fwd_bwd(pt7, emb, vemb, gr7, False, False)
            out[f"trunk[tnerf]+bwd {tag}"] = train([res7[0]], list(res7[1]),
                                                   timed(lambda: b7.trunk_fwd_bwd(pt7, emb, vemb, gr7, False, False)))
            gs = torch.Generator(device=dev).manual_seed(17)  # the serving chunk's rows
            big = torch.rand((32768 * 64, pt7.cin), generator=gs, device=dev) * 2 - 1
            bigv = torch.rand((32768 * 64, pt7.input_ch_views), generator=gs, device=dev) * 2 - 1
            out[f"trunk[tnerf] {tag}"] = {"sha256": digest([b7.trunk(pt7, big, bigv)]),
                                          "ms": timed(lambda: b7.trunk(pt7, big, bigv)),
                                          "host_us": host_us(lambda: b7.trunk(pt7, big[:1024], bigv[:1024]))}
            del big, bigv
            p8 = b7.pack_trunk_params(vsd, vcfg, dtype)
            pts = torch.rand((32000, 3), generator=g7, device=dev) * 4 - 2
            vd = torch.nn.functional.normalize(torch.randn((32000, 3), generator=g7, device=dev), dim=-1)
            res8 = b7.field_raw_fwd_bwd(p8, pts, vd, gr7, True, True)
            out[f"trunk[raw]+bwd {tag}"] = train([res8[0]], [*res8[1], res8[2], res8[3]],
                                                 timed(lambda: b7.field_raw_fwd_bwd(p8, pts, vd, gr7, True, True)),
                                                 lambda: b7.field_raw_fwd_bwd(p8, pts, vd, gr7, True, True))
            # B8 forward only at a mesh tile: 2,048 points x 100 directions
            g8 = torch.Generator(device=dev).manual_seed(13)
            tile = (torch.rand((2048, 3), generator=g8, device=dev) * 4 - 2)[None].expand(100, 2048, 3)
            dirs = torch.nn.functional.normalize(torch.randn((100, 3), generator=g8, device=dev), dim=-1)
            tp, tv = tile.reshape(-1, 3).contiguous(), dirs[:, None, :].expand(100, 2048, 3).reshape(-1, 3).contiguous()
            out[f"trunk[raw,mesh] {tag}"] = {"sha256": digest([b7.field_raw(p8, tp, tv)]),
                                             "ms": timed(lambda: b7.field_raw(p8, tp, tv)),
                                             "host_us": host_us(lambda: b7.field_raw(p8, tp[:1024], tv[:1024]))}
        if hasattr(b1, "render_loss_ext"):  # B3 wide, B9, B11 at the MultiRes level-0 widths (and B9 narrow)
            wcfg = DNeRFConfig(multires=20, multires_views=20, multires_time=8)
            ncfg = DNeRFConfig(multires=-1, multires_views=-1, multires_time=-1, i_embed=-1)
            for name, cfg9, seed in (("wide", wcfg, 9), ("narrow", ncfg, 10)):
                m9 = DirectTemporalNeRF(cfg9, device=dev, generator=torch.Generator().manual_seed(seed), fused=False)
                p9 = b3.pack_params(canonical_params(m9.state_dict()), cfg9, dtype)
                o, d, vd, z, dist, noise, target, t = rays(1024, 64, 30 + seed)
                pts = (o[:, None, :] + d[:, None, :] * z[..., None]).contiguous()
                ve = positional_encoding(vd, cfg9.nf_views).contiguous()
                gct = torch.randn((1024, 5), generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
                args9 = (p9, pts, ve, z, dist, noise, gct, True)
                res9, g9, dp9 = b1.render_loss_ext(*args9)
                out[f"render_loss[ext,{name},S=64] {tag}"] = train(list(res9), list(g9) + [dp9],
                                                                   timed(lambda: b1.render_loss_ext(*args9)),
                                                                   lambda: b1.render_loss_ext(*args9))
                if name == "wide":
                    o, d, vd, z, dist, noise, target, t = rays(32768, 64, 40)
                    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).contiguous()
                    ve = positional_encoding(vd, cfg9.nf_views).contiguous()
                    args3 = (p9, None, None, ve, z, dist, None, True, None, pts)
                    out[f"render_pass[pts,wide,S=64] {tag}"] = {"sha256": digest(b3.render_pass(*args3)),
                                                                "ms": timed(lambda: b3.render_pass(*args3))}
                    t11 = b6.pack_time_params(m9.state_dict(), cfg9, dtype)
                    o, d, vd, z, dist, noise, target, t = rays(500, 64, 41)
                    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).contiguous()
                    cot = torch.randn(pts.shape, generator=torch.Generator(device=dev).manual_seed(12), device=dev)
                    out[f"time_net[pts,bwd] {tag}"] = b11_train(t11, pts, t, cot)
        torch.cuda.empty_cache()

    # the mesh sweep through extract_mesh.sample_grid on the field's default
    # route (B7, bf16): 128^3 points over [-2, 2]^3 x 100 views, 1,024 tiles;
    # one sweep after a warm-up at 32^3, timed on the host clock
    from swnerf_torch.pipelines.extract_mesh import sample_grid

    model = VanillaNeRF(vcfg, device=dev, generator=torch.Generator().manual_seed(0))
    bounds = ((-2.0, 2.0),) * 3
    sample_grid(model, bounds, 32, 100)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    density, colors, _ = sample_grid(model, bounds, 128, 100)
    out["mesh_sweep bf16"] = {"sha256": digest([torch.from_numpy(density), torch.from_numpy(colors)]),
                              "ms": 1e3 * (time.perf_counter() - t0)}

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"root": a.root, "card": smi, "clock": clock, "kernels": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
