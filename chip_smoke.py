#!/usr/bin/env python3
"""Smoke test of swnerf_torch on one NVIDIA card: build the CUDA kernels,
hold each against its plain PyTorch twin, render test views of the trained
vanilla NeRF through the real CLI, and time the kernels.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  1. the card's name and power limit, torch and CUDA versions;
  2. build the kernels from swnerf_torch/csrc (nvcc, sm_90a);
  3. B2 sample_pdf vs its twin at N=160,000, M=63, S=128: bit-exact;
  4. B3 render_pass vs its twin with the 010000.tar weights (D=8, W=256) on
     4,096 rays of test view 0, S=64 and S=192: fp32 atol 1e-4 (rgb, acc),
     rtol 1e-4 (depth); bf16 max |drgb| <= 1e-2, mean <= 1e-3;
  5. the main path: ``run_nerf --render_only --render_test --testskip 5``
     on benchmarks/full_scale (5 test frames, 400x400, 64+128 samples,
     bf16 kernels), launch counts, PSNR/SSIM, and frame 0 re-rendered by the
     plain twins in fp32 (|dPSNR| <= 0.1 dB);
  6. each kernel against its twin again at the main path's chunk shape
     (32,768 rays, bf16), its time there beside its bound, a per-stage
     breakdown of one frame, and the JSON lines.

Exits non-zero without a CUDA device, and when the package is missing.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FULL = ROOT / "benchmarks" / "full_scale"
CONFIG = FULL / "full_nerf_200k.txt"
DATADIR = FULL / "data_nerf_400"
CKPT = FULL / "logs" / "full_nerf_200k" / "010000.tar"

# H100 SXM data sheet, dense: HBM bandwidth and peak rates by operand type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}


def fail(msg: str) -> None:
    raise SystemExit(f"FAILED: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def load_models(dev):
    import torch

    from swnerf_torch.models import VanillaNeRF, VanillaNeRFConfig
    from swnerf_torch.train.checkpoint import load_tar, vanilla_state_dict

    ckpt = load_tar(str(CKPT))
    cfg = VanillaNeRFConfig()
    coarse, fine = VanillaNeRF(cfg, device=dev), VanillaNeRF(cfg, device=dev)
    coarse.load_state_dict(vanilla_state_dict(ckpt["network_fn_state_dict"]))
    fine.load_state_dict(vanilla_state_dict(ckpt["network_fine_state_dict"]))
    return cfg, coarse.eval(), fine.eval()


def view0_rays(dev):
    import numpy as np

    from swnerf_torch.render.core import make_rays_from_camera

    with open(DATADIR / "transforms_test.json") as f:
        meta = json.load(f)
    c2w = np.array(meta["frames"][0]["transform_matrix"], np.float32)
    H = W = 400
    focal = 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    return make_rays_from_camera(H, W, K, c2w[:3, :4], 2.0, 6.0, device=dev)


def pass_inputs(rays, cfg, n_samples):
    """Inputs of one B3 pass as the eval pass forms them."""
    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.sampling import sample_along_rays
    from swnerf_torch.render.fused_eval import _dists_scaled

    o, d = rays.origins.contiguous(), rays.directions.contiguous()
    ve = positional_encoding(rays.viewdirs, cfg.nf_views).contiguous()
    z = sample_along_rays(rays.near, rays.far, n_samples, 0.0).contiguous()
    return o, d, ve, z, _dists_scaled(z, d)


def fine_z(z64, w64, n_importance=128):
    import torch

    from swnerf_torch.ops.kernels.sample_pdf import sample_pdf_plain
    from swnerf_torch.ops.sampling import merge_z_vals

    n = z64.shape[0]
    z_mid = 0.5 * (z64[:, 1:] + z64[:, :-1])
    u = torch.linspace(0.0, 1.0, n_importance, device=z64.device).expand(n, n_importance)
    return merge_z_vals(z64, sample_pdf_plain(z_mid, w64[:, 1:-1], u))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain twins in true fp32
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[1 versions] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")

    from swnerf_torch.ops.kernels import build, launches
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.kernels import sample_pdf as b2

    # ---- 2. build
    t0 = time.perf_counter()
    libs = build.build()
    print(f"[2 build] {len(libs)} libraries in {time.perf_counter() - t0:.2f} s (nvcc, sm_90a, one process each)")
    for name, path in libs.items():
        log = (path.parent / "build.log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[2 ptxas {name}] {line.strip()}")

    # ---- 3. B2 vs plain at a full frame of rays
    n, m, s = 160_000, 63, 128
    g = torch.Generator(device=dev).manual_seed(0)
    z64 = torch.linspace(2.0, 6.0, m + 1, device=dev).expand(n, m + 1)
    bins = (0.5 * (z64[:, 1:] + z64[:, :-1])).contiguous()
    w64 = torch.rand((n, m + 1), generator=g, device=dev)
    w64[: n // 4, 10:] = 0.0  # empty space: the denom < 1e-5 guard
    weights = w64[:, 1:-1]  # strided, as the eval pass passes it
    b2_err = 0.0
    for mode in ("det", "random"):
        u = (torch.linspace(0.0, 1.0, s, device=dev).expand(n, s) if mode == "det"
             else torch.rand((n, s), generator=g, device=dev))
        got, ref = b2.sample_pdf(bins, weights, u), b2.sample_pdf_plain(bins, weights, u)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        b2_err = max(b2_err, err)
        print(f"[3 B2 {mode}] N={n} M={m} S={s} bit_exact={torch.equal(got, ref)} max|d|={err:.3e}")
        if err > 1e-6:
            fail(f"B2 {mode}: max |d| {err} > 1e-6")

    # ---- 4. B3 vs plain, real weights, 4096 rays of test view 0
    cfg, coarse, fine = load_models(dev)
    rays = view0_rays(dev)
    idx = torch.arange(4096, device=dev) * 39  # spread over the frame: object and background
    rays4k = type(rays)(*(x[idx] for x in rays))
    b3_err = {}
    o, d, ve, z, dist = pass_inputs(rays4k, cfg, 64)
    p32 = b3.pack_params(coarse.state_dict(), cfg, torch.float32)
    w_plain = b3.render_pass_plain(p32, o, d, ve, z, dist, None, True).weights
    zf = fine_z(z, w_plain).contiguous()
    cases = {64: (coarse, z), 192: (fine, zf)}
    for S, (model, zz) in cases.items():
        distz = b3_dists(zz, d)
        for dtype in (torch.float32, torch.bfloat16):
            packed = b3.pack_params(model.state_dict(), cfg, dtype)
            got = b3.render_pass(packed, o, d, ve, zz, distz, None, True)
            ref = b3.render_pass_plain(packed, o, d, ve, zz, distz, None, True)
            torch.cuda.synchronize()
            drgb = (got.rgb - ref.rgb).abs()
            dacc = (got.acc - ref.acc).abs().max().item()
            ddep = (got.depth - ref.depth).abs().max().item()
            # rtol 1e-4 on depth, with atol 1e-5 for the background rays
            # whose depth (= sum w*z with acc ~ 0) is ~0.
            depth_ok = torch.allclose(got.depth, ref.depth, rtol=1e-4, atol=1e-5)
            dw = (got.weights - ref.weights).abs().max().item()
            tag = "fp32" if dtype == torch.float32 else "bf16"
            print(f"[4 B3 {tag} S={S}] max|drgb|={drgb.max().item():.3e} mean|drgb|={drgb.mean().item():.3e} "
                  f"max|dacc|={dacc:.3e} max|ddepth|={ddep:.3e} depth_within_rtol={depth_ok} max|dw|={dw:.3e}")
            if dtype == torch.float32:
                if drgb.max().item() > 1e-4 or dacc > 1e-4 or not depth_ok:
                    fail(f"B3 fp32 S={S} outside atol 1e-4 (rgb, acc) / rtol 1e-4 (depth)")
            else:
                b3_err[S] = drgb.max().item()
                if drgb.max().item() > 1e-2 or drgb.mean().item() > 1e-3:
                    fail(f"B3 bf16 S={S}: max |drgb| > 1e-2 or mean > 1e-3")

    # ---- 5. main path through the CLI
    from swnerf_torch.pipelines import run_nerf

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        argv = [
            "--config", str(CONFIG), "--render_only", "--render_test", "--testskip", "5", "--device", "cuda",
            "--basedir", str(tmp), "--datadir", str(DATADIR), "--ft_path", str(CKPT),
        ]
        launches.clear()
        t0 = time.perf_counter()
        savedir = Path(run_nerf.main(argv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launches)
        metrics = json.loads((savedir / "metrics.json").read_text())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[5 main] launches {json.dumps(counts, sort_keys=True)} (5 frames), CLI wall {wall:.2f} s")
    for key in ("render_pass[S=64]", "render_pass[S=192]", "sample_pdf"):
        if counts.get(key, 0) <= 0:
            fail(f"the main path launched no {key}")
    secs = metrics["seconds_per_frame"]
    timed = secs[1:]  # frame 0 is the warm-up
    per_frame = sum(timed) / len(timed)
    rays_per_frame = 400 * 400
    print(f"[5 main] seconds per frame {[round(x, 4) for x in secs]}")
    print(f"[5 main] after warm-up: {per_frame * 1e3:.1f} ms/frame, {rays_per_frame / per_frame:.4g} rays/s, "
          f"{rays_per_frame * (64 + 192) / per_frame:.4g} samples/s")
    for i, (p, q) in enumerate(zip(metrics["psnr"], metrics["ssim"])):
        print(f"[5 main] frame {i}: PSNR {p:.3f} dB SSIM {q:.4f}")
    mean_psnr = sum(metrics["psnr"]) / len(metrics["psnr"])
    print(f"[5 main] mean PSNR {mean_psnr:.3f} dB")
    if not mean_psnr >= 30.0:
        fail(f"mean PSNR {mean_psnr} < 30 dB")

    # frame 0 again, plain twins in fp32 on the card
    from swnerf_torch.pipelines.common import load_scene
    from swnerf_torch.render.core import RenderConfig, render_image
    from swnerf_torch.render.fused_eval import make_vanilla_eval_pass
    from swnerf_torch.utils.config import config_parser
    from swnerf_torch.utils.metrics import calculate_metrics

    args = config_parser().parse_args(argv)
    scene = load_scene(args)
    rcfg = RenderConfig(n_samples=64, n_importance=128, white_bkgd=True)
    plain = make_vanilla_eval_pass(cfg, compute_dtype=torch.float32, plain=True)
    out = render_image(coarse, rays, rcfg, chunk=8192, fine_model=fine, eval_pass=plain)
    psnr_plain = calculate_metrics(scene.images[scene.i_test[0]], out["rgb"].reshape(400, 400, 3).cpu().numpy())[0]
    dpsnr = abs(psnr_plain - metrics["psnr"][0])
    print(f"[5 plain fp32] frame 0 PSNR {psnr_plain:.3f} dB, |dPSNR| vs bf16 kernels {dpsnr:.4f} dB")
    if dpsnr > 0.1:
        fail(f"|dPSNR| {dpsnr} > 0.1 dB")
    del out

    # ---- 6. each kernel against its twin and timed at the main path's
    # shapes (the first 32768-ray chunk of view 0, bf16 operands)
    chunk = rays.slice(0, args.chunk)
    o, d, ve, z, dist = pass_inputs(chunk, cfg, 64)
    pc, pf = b3.pack_params(coarse.state_dict(), cfg), b3.pack_params(fine.state_dict(), cfg)
    res_c = b3.render_pass(pc, o, d, ve, z, dist, None, True)
    n = z.shape[0]
    z_mid = (0.5 * (z[:, 1:] + z[:, :-1])).contiguous()
    u = torch.linspace(0.0, 1.0, 128, device=dev).expand(n, 128)
    wsl = res_c.weights[:, 1:-1]
    zs = b2.sample_pdf(z_mid, wsl, u)
    err = (zs - b2.sample_pdf_plain(z_mid, wsl, u)).abs().max().item()
    print(f"[6 check] sample_pdf N={n}: max|d|={err:.3e}")
    if err > 1e-6:
        fail(f"B2 at the main path's shape: max |d| {err} > 1e-6")
    b2_err = max(b2_err, err)
    from swnerf_torch.ops.sampling import merge_z_vals

    zf = merge_z_vals(z, zs)
    distf = b3_dists(zf, d)
    kernels = []

    b2_bytes = 4 * (z_mid.numel() + n * 62 + 128 + n * 128)  # det u: one row
    b2_ops = n * 128 * 63  # compares of the search, the dominant count
    kernels.append(entry(
        "sample_pdf", "swnerf_torch/csrc/sample_pdf.cu", "swnerf_tpu/ops/pallas/sample_pdf.py:37",
        counts.get("sample_pdf", 0), b2_err,
        cuda_ms(lambda: b2.sample_pdf(z_mid, wsl, u), 50),
        cuda_ms(lambda: b2.sample_pdf_plain(z_mid, wsl, u), 5),
        b2_bytes, b2_ops, "fp32",
    ))
    for S, packed, zz, dd in ((64, pc, z, dist), (192, pf, zf, distf)):
        got = b3.render_pass(packed, o, d, ve, zz, dd, None, True)
        ref = b3.render_pass_plain(packed, o, d, ve, zz, dd, None, True)
        drgb = (got.rgb - ref.rgb).abs()
        print(f"[6 check] render_pass[S={S}] bf16 N={n}: max|drgb|={drgb.max().item():.3e} "
              f"mean|drgb|={drgb.mean().item():.3e}")
        if drgb.max().item() > 1e-2 or drgb.mean().item() > 1e-3:
            fail(f"B3 bf16 S={S} at the main path's shape: max |drgb| > 1e-2 or mean > 1e-3")
        del got, ref
        flops = 2 * packed.macs_per_sample * n * S
        nbytes = 4 * (6 * n + ve.numel() + 2 * zz.numel() + 5 * n + zz.numel()) + packed.weights.numel() * 2
        kernels.append(entry(
            f"render_pass[S={S}]", "swnerf_torch/csrc/render_pass.cu", "swnerf_tpu/ops/pallas/render_fused.py:276",
            counts.get(f"render_pass[S={S}]", 0), max(b3_err[S], drgb.max().item()),
            cuda_ms(lambda: b3.render_pass(packed, o, d, ve, zz, dd, None, True), 3),
            cuda_ms(lambda: b3.render_pass_plain(packed, o, d, ve, zz, dd, None, True), 2),
            nbytes, flops, "bf16",
        ))
        torch.cuda.empty_cache()
    for k in kernels:
        print(f"[6 kernel] {k['name']}: {k['ms']:.3f} ms/launch (plain {k['plain_ms']:.3f} ms), bound "
              f"{k['bound_ms']:.4f} ms by {k['bound_by']} -> {100 * k['bound_ms'] / k['ms']:.2f}% of the bound, "
              f"{k['launches']} launches in 5 frames")
    # The fp32 parity mode (not on the main path) against the fp32 SIMT peak.
    pf32 = b3.pack_params(fine.state_dict(), cfg, torch.float32)
    ms32 = cuda_ms(lambda: b3.render_pass(pf32, o, d, ve, zf, distf, None, True), 3)
    bound32 = 2 * pf32.macs_per_sample * zf.numel() / PEAK_FLOPS["fp32"] * 1e3
    print(f"[6 kernel] render_pass[S=192] fp32 operands: {ms32:.3f} ms/launch, fp32 bound {bound32:.3f} ms "
          f"-> {100 * bound32 / ms32:.2f}% of the bound")

    # per-stage breakdown of one frame (device time by stage, events per chunk)
    stages = frame_breakdown(rays, cfg, pc, pf, args.chunk)
    total = sum(stages.values())
    print("[6 breakdown] frame 0, device ms by stage: " + ", ".join(
        f"{k} {v:.2f} ({100 * v / total:.1f}%)" for k, v in stages.items()))
    print(f"[6 breakdown] stage sum {total:.1f} ms vs timed frame {per_frame * 1e3:.1f} ms")

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


def b3_dists(z, d):
    from swnerf_torch.render.fused_eval import _dists_scaled

    return _dists_scaled(z, d).contiguous()


def entry(name, source, replaces, launches, err, ms, plain_ms, nbytes, ops, kind):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[kind] * 1e3
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None,
    }


def frame_breakdown(rays, cfg, pc, pf, chunk):
    """Device milliseconds of each eval-pass stage over one frame, chunk by
    chunk as render_image runs it (CUDA events around each stage)."""
    import torch

    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.kernels import sample_pdf as b2
    from swnerf_torch.ops.sampling import merge_z_vals

    names = ("rays+z", "coarse B3", "B2", "sort merge", "fine B3", "disp")
    acc = dict.fromkeys(names, 0.0)
    n_all = rays.origins.shape[0]
    for start in range(0, n_all, chunk):
        tile = rays.slice(start, min(n_all, start + chunk))
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        o, d, ve, z, dist = pass_inputs(tile, cfg, 64)
        ev[1].record()
        res = b3.render_pass(pc, o, d, ve, z, dist, None, True)
        ev[2].record()
        n = z.shape[0]
        z_mid = (0.5 * (z[:, 1:] + z[:, :-1])).contiguous()
        u = torch.linspace(0.0, 1.0, 128, device=z.device).expand(n, 128)
        zs = b2.sample_pdf(z_mid, res.weights[:, 1:-1], u)
        ev[3].record()
        zf = merge_z_vals(z, zs)
        ev[4].record()
        res = b3.render_pass(pf, o, d, ve, zf, b3_dists(zf, d), None, True)
        ev[5].record()
        _ = 1.0 / torch.maximum(torch.full_like(res.depth, 1e-10), res.depth / res.acc)
        ev[6].record()
        torch.cuda.synchronize()
        for i, k in enumerate(names):
            acc[k] += ev[i].elapsed_time(ev[i + 1])
    return acc


if __name__ == "__main__":
    sys.exit(main())
