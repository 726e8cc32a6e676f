#!/usr/bin/env python3
"""Smoke test of swnerf_torch on one NVIDIA card: build the CUDA kernels,
hold each against its plain PyTorch twin, render test views of the trained
vanilla NeRF, T-NeRF and D-NeRF and resume their training through the real
CLIs, train a MultiRes D-NeRF from scratch through its CLI, drive the
fields' kernel routes (the eager steps, renders with no eval pass), extract
meshes from the trained vanilla NeRF and solve their metric scale, render
and train MultiRes on the render kernels, run the resample merge and the
deformation MLP's input cotangents, and time the kernels.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  1. the card's name and power limit, torch and CUDA versions;
  2. build the kernels from swnerf_torch/csrc (nvcc, sm_90a); the
     tensor-core kernels' registers and spill bytes from build.log (a spill
     fails);
  3. B2 sample_pdf vs its twin at N=160,000, M=63, S=128: bit-exact;
  4. B3 render_pass vs its twin with the 010000.tar weights (D=8, W=256) on
     4,096 rays of test view 0, S=64 and S=192: fp32 atol 1e-4 (rgb, acc),
     rtol 1e-4 (depth); bf16 max |drgb| <= 1e-2, mean <= 1e-3;
  5. the main path: ``run_nerf --render_only --render_test --testskip 5``
     on benchmarks/full_scale (5 test frames, 400x400, 64+128 samples,
     bf16 kernels), launch counts, PSNR/SSIM, and frame 0 re-rendered by the
     plain twins in fp32 (|dPSNR| <= 0.1 dB);
  6. each kernel against its twin again at the main path's chunk shape
     (32,768 rays, bf16), its time there beside its bound and a per-stage
     breakdown of one frame; B3's composite and heads' shares of its blocks'
     clock cycles (csrc/tc_chunk.cuh::g_prof);
  7. B1 render_loss vs its twin with the 010000.tar weights on 1024 seeded
     pixels of train view r_0 (coarse S=64 jittered, fine S=192 from a B2
     pass), noise std 1: fp32 rgb/acc within 1e-4, depth and sqerr rtol
     1e-4 (atol 1e-5 / 1e-7), gradients rel L2 1e-4 (or, on ReLU ties, no
     further from the float64 twin than twice the fp32 twin, PERF.md); bf16
     rgb max 1e-2 / mean 1e-3, gradients rel L2 1e-2; bit-equal repeats;
     bf16 B1's time beside its bound, its device time by kernel family
     (the SIMT forward, the reverse sweep's tensor-core products, the split
     reductions, the SIMT heads; torch.profiler) and the sweep's large
     products as bf16 torch.matmul calls (cuBLAS, summed: the yardstick);
  8. the kernel train step vs the eager autograd step from the same state
     and draws: fp32 loss rel 1e-5, gradients as in 7 (float64 eager step as
     the reference); bf16 loss rel 1e-2;
  9. the training main path: ``run_nerf`` resumed from 010000.tar for 200
     full-width bf16 steps (train PSNR >= 30 dB at every print, checkpoints
     010100/010200 with Adam step 10200, B1 and B2 launch counts), ms per
     step, rays/s, samples/s and a per-stage breakdown of one step, B1's
     stages beside their bounds;
 10. test frame 0 rendered from 010200.tar through the serving path:
     >= 30 dB and within 0.5 dB of phase 5's frame 0;
 11. the T-NeRF scene: the dynamic 400x400 textured Blender scene the
     round-5 800000.tar was trained on (seed 0, 100/5/25 views, 128 GT
     samples), written by the port's writer on the card;
 12. B4 against its twin with the 800000.tar weights (D=8, W=128): forward
     on 4,096 rays of test view 0 at its frame time, S=64 (fp32 rgb/acc atol
     1e-4, depth rtol 1e-4; bf16, on the tensor cores, max |drgb| <= 1e-2,
     mean <= 1e-3); train mode on 500 seeded pixels of a train view, noise
     std 1 (fp32 sqerr rtol 1e-4, gradients rel L2 1e-4 with the float64
     fallback of phase 7 on mask ties; bf16, its reverse sweep on the tensor
     cores, gradients rel L2 1e-2; bit-equal repeats); B4's times at the main
     paths' shapes, the train launch's device time by kernel family (its SIMT
     forward, the sweep's tensor-core products, ...) and the sweep's large
     products as bf16 torch.matmul calls (as phase 7); the forward beside
     B3 on a seeded vanilla field of the same width, depth and rows (ReLU,
     no time columns) and its composite and heads' shares of the cycles;
 13. the kernel T-NeRF step against the eager step, same state and draws:
     fp32 loss rel 1e-5, gradients as in 12; bf16 loss rel 1e-2;
 14. the T-NeRF serving main path: ``run_tnerf --render_only --render_test``
     from a copy of 800000.tar (25 frames, 400x400, 64 samples, bf16 B4):
     ms per frame, PSNR/SSIM (mean >= 20.5 dB on the reference evaluator's
     scale, see unit_range_psnr), frame 0 by the fp32 twin within 0.1 dB,
     the B4 launch count, a per-stage breakdown of a frame;
 15. the T-NeRF training main path: ``run_tnerf`` resumed from that copy for
     1,000 bf16 steps (train PSNR >= 19 dB at every print, 800500.tar and
     801000.tar with their Adam steps, 1,000 B4 train launches), ms per
     step, rays/s, samples/s and a per-stage breakdown of a step;
 16. test frame 0 from 801000.tar through the serving path: >= 20 dB (the
     reference evaluator's scale) and within 0.5 dB of phase 14's frame 0;
 17. B6 (the D-NeRF deformation MLP, forward and backward) against its twin
     with the round-5 D-NeRF 800000.tar weights on the coarse (S=64) and
     fine (S=192) points of 500 seeded pixels of a train view of phase 11's
     scene: fp32 dx atol 1e-5, gradients rel L2 1e-4 (the float64 fallback
     of phase 7, which also admits the distance a perturbation of fp32 size
     moves the float64 twin: the ReLUs tie, check_fp32_grads); bf16 dx
     max 1e-2, gradients rel L2 1e-2; bit-equal repeats; B6's backward at
     the TV pair's rows beside its bound, by kernel family and against its
     sweep's products on cuBLAS (as phase 7);
 18. B3's pts mode and B5 against their twins on pts + dx of those rays,
     noise std 1: outputs as in phase 7, gradients and dpts as in phase 17,
     bf16 1e-2, bit-equal repeats; then B6 and B3's pts mode against their
     twins at the serving path's chunk shape (32,768 rays), and the times;
     B6's head share and B3's composite share there (as in phase 6);
 19. the kernel D-NeRF step against the eager step from the same state and
     draws (TV on): fp32 loss rel 1e-5 (or phase 17's fallback), gradients as
     in phase 17 (the float64 eager step on the CPU as the reference); bf16
     loss rel 1e-2;
 20. the D-NeRF serving main path: ``run_dnerf --render_only --render_test
     --testskip 5`` from a copy of 800000.tar (test frames 0/5/10/15/20,
     400x400, 64 + 128 samples, bf16): ms per frame, rays/s, samples/s, the
     B6/B3/B2 launch counts; each frame, rendered again at the reference
     evaluator's 32 + 32 samples, within 0.5 dB of the reference's
     per-frame PSNR on its scale, and at 64 + 128 no more than 0.5 dB
     below it; frame 5 by the fp32 twins within 0.1 dB; a per-stage
     breakdown of a frame;
 21. the D-NeRF training main path: ``run_dnerf`` resumed from that copy for
     200 bf16 steps with the config's flags (train PSNR >= 34 dB at every
     print, 800100.tar and 800200.tar with Adam step 800200, the B5 and B6
     launch counts), ms per step, rays/s, samples/s, a per-stage breakdown
     (the backward's stage beside B6's backward bound);
 22. test frame 5 from 800200.tar through the serving path, within 0.5 dB
     of phase 20's;
 23. MultiRes: B7 (the field trunk on embedded inputs, forward and backward
     with the position embedding's cotangent) and the widened B6 against
     their twins at the per-level widths of configs/multires/lego.txt (D=8,
     W=256; (20, 8, 20), (10, 4, 10), identity; seeded weights) on 500
     seeded pixels of a train view of phase 11's scene, 64 jittered samples:
     fp32 raw atol 1e-4 / rtol 1e-4 and dx atol 1e-5, gradients (and demb)
     at phase 17's bar; bf16 raw within 1e-2 of its largest value, dx 1e-2,
     gradients rel L2 1e-2; bit-equal repeats; the forward-only launches
     (the test render's) at the same bars and bit-equal to the train-mode
     ones, but for B7's in bf16 (the tensor cores): at the bf16 raw bar and
     bit-equal to a repeat; B7's bf16 backward (with demb) runs its sweep on
     the tensor cores; the last 500 rays of the test render's 2.1M-row
     chunk against the twins at the bf16 bars; then their times at each
     level's rows, B6's and B7's backward at level 0 as in phase 17;
 24. one phase-1 step (level 0) and one phase-2 step (all four levels) on
     the kernel route against the plain route, same weights and draws: fp32
     loss rel 1e-5, gradients at phase 17's bar; bf16 loss rel 2e-2;
 25. the MultiRes main path: ``run_multires --config configs/multires/lego.txt``
     on phase 11's scene (200x200 after half_res) from scratch with
     --raw_noise_std 1 (live densities), 100 phase-1 steps per level and
     100 phase-2 steps with the global term from iteration 100 on, the test
     set reconstructed at 200: each level's phase-1 loss falls from its
     first print to its last, the phase-2 loss moves, the global PSNR is
     finite, 000100.tar and 000200.tar carry the per-level keys, B6 and B7
     launched; ms per phase-1 step (per level), per phase-2 step and per
     reconstructed test frame; test frames 0/5/10/15/20 from 000200.tar
     reconstructed by the bf16 kernels within 0.1 dB (mean PSNR) of the fp32
     plain route, and not equal to it; a digest of 000200.tar (every tensor's
     bytes, the keys in order: two runs on one card print the same one), and
     the pyramid reconstruction's backward at phase 2's patch sizes bit-equal
     across two launches (F.interpolate's own, atomic backward: whether its
     two launches differ, printed);
 26. B7' (the ELU T-NeRF trunk on embedded inputs) against its twin with the
     800000.tar weights on one eager step's rows (500 seeded pixels of a
     train view x 64 jittered samples = 32,000 rows): fp32 raw within 1e-5
     of its largest value, the gradients and the embeddings' cotangents at
     phase 17's bar; bf16 raw within 1e-2 of its largest value, gradients
     rel L2 1e-2; bit-equal repeats; the forward-only launch bit-equal to
     the train-mode one; the serving chunk's last 32,000 rows at the bf16
     bar; times at 32,000 rows (forward, backward) and at the 2.1M-row
     chunk;
 27. B8 (the trunk with the encode in the kernel) against its twin with
     010000.tar's fine weights on 1024 rays x 192 jittered samples, the
     same bars (its bf16 forward-only launch, on the tensor cores, at the
     bf16 raw bar and bit-equal to a repeat), d pts and d viewdirs at the
     fp32 bar; times at 32,000 rows; the forward-only launch at one mesh
     tile (2,048 points x 100 views = 204,800 rows) within 1e-2 of the
     twin's largest raw, and its time;
 28. the fields' kernel routes through the CLIs: run_nerf resumed from
     010000.tar for 200 eager steps (SWNERF_FUSED_STEP=0: B7), then again
     under SWNERF_FUSED_RAW=1 (B8), >= 30 dB at every print; test frame 0
     through the fields (SWNERF_FUSED_EVAL=0) within 0.1 dB of phase 5's
     B3 frame; run_tnerf resumed from 800000.tar for 200 eager steps (B7'),
     >= 19 dB at every print and no B4 launch; run_tnerf --render_only
     --testskip 5 through B4 and through B7' (SWNERF_FUSED_EVAL=0), mean
     PSNRs within 0.1 dB; run_dnerf for 10 steps under SWNERF_FUSED=0: the
     fp32 plain route, no field kernel launched;
 29. the SW mesh chain at the drill recipe: extract_mesh on 010000.tar,
     128^3 points x 100 views over [-2, 2]^3, threshold 25, through B7
     (bf16, the default), B8 (SWNERF_FUSED_RAW=1) and the plain fp32 route
     (SWNERF_FUSED=0): each kernel mesh's vertex and face counts within 2%
     of the plain mesh's, bounding boxes within one voxel (4/127), the
     symmetric mean nearest-vertex distance under 0.25 voxel; ms for the
     sweep and for marching + OBJ write, 1,024 launches per kernel sweep;
     B7's time at the sweep's tile; the B7 sweep's device ms split per tile
     with CUDA events (encode, weight packing, embedding copy, B7, rest);
 30. the metric-scale solve without cv2: a 0.5-unit square marker
     projected into the capture's train poses, calculate_3d_corners ->
     marker_edge_lengths -> scale -> alignment_matrix -> transform_mesh on
     the B7 mesh: the scale real_length / 0.5 within 1e-4 relative, the
     marker normal onto +z within 1e-6;
 31. B3's pts mode at the MultiRes widths (levels 0-2: 123 / 123 and 63 / 63
     columns on 128-row pads) and B9 (the external-cotangent backward of the
     fused phase 2; levels 0-2 wide, the identity level narrow) against
     their twins with 000200.tar's per-level weights on 1,024 seeded pixels
     x 64 jittered samples of train view 37, noise std 1, seeded non-zero
     cotangents of rgb, acc and depth: fp32 outputs at phase 18's bars,
     gradients and d pts at phase 17's; bf16 outputs within 1e-2, gradients
     rel L2 1e-2; bit-equal repeats; B9's recomputed forward bit-equal to
     the B3 launch; B3 wide at the test render's 32,768-ray chunk (level 0,
     000200.tar's and seeded weights, whose rgb does not saturate) at the
     same bars (bf16 depth atol and rtol 1e-2); times there and at phase 2's level-0
     rows (1,024 x 64); B9's gradients on seeded level-0 weights beside the
     bf16 twin's own distance from itself summed on the CPU (printed);
 32. the MultiRes test render of 000200.tar through render_testset on test
     frames 0/5/10/15/20: levels 0-2 through the D-NeRF eval pass, level 3
     through its fields, against SWNERF_FUSED_EVAL=0 (every level through
     its fields): each of levels 0-2's frames within max 1e-2, mean 1e-3,
     mean PSNR of the reconstructions within 0.1 dB, 20 B3-wide launches,
     ms per reconstructed frame on both routes;
 33. the fused phase 2: one step over the four levels with fused=True
     against the field-route step, same weights (phase 24's seeded ones:
     000200.tar's saturated levels give noise gradients) and draws: fp32
     loss rel 1e-5, gradients at phase 17's bar; bf16 loss rel 2e-2; then
     run_multires resumed from 000200.tar for 100 phase-2 steps under
     SWNERF_FUSED_MULTIRES=1 and under the default: the loss moves, the
     global PSNR is finite, B9 once per level per step; in 000300.tar every
     level's weights moved, its Adam first moment is more than 10 times what
     stale momentum alone leaves, and the two routes' moves are within
     2-fold at each level whose fp32 routes agree within 0.1 (rel L2) on
     000200.tar's weights (at least one does); ms per phase-2 step on both
     routes and their idle shares (torch.profiler);
 34. B10 at phase 3's shape on 010000.tar's coarse weights: bit-equal to
     B2 + torch.sort for linspace and sorted random uniforms, the twin
     bit-equal, B2's unsorted rows counted; run_nerf --render_only under
     SWNERF_PDF_MERGE=1 with phase 5's PSNRs exactly; 50 vanilla and 50
     D-NeRF kernel steps under the switch at phases 9 / 21's floors; B10's
     time beside B2 + torch.sort;
 35. B11 (fused_time_net_pts with input cotangents) against its twin with
     the D-NeRF 800000.tar deformation weights on phase 17's points and at
     MultiRes level 0's widths: dx bit-equal to B6's forward, fp32
     gradients, d pts and d times at phase 17's bar, bf16 rel L2 1e-2;
     times; then the [tc] lines: each bf16 tensor-core launch's TFLOP/s and
     share of its bound (B3, B6, B7 and B8 at the mesh tile, B7 at the
     MultiRes test chunk), B3's composite and the heads' shares of the
     blocks' cycles, the vanilla and D-NeRF ms per frame, the mesh sweep;
     then the JSON lines.

Exits non-zero without a CUDA device, and when the package is missing.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import statistics
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
TNERF_DIR = ROOT / "benchmarks" / "round5_artifacts" / "full_tnerf_800k"
TNERF_CONFIG = TNERF_DIR / "config.txt"
TNERF_CKPT = TNERF_DIR / "800000.tar"
TNERF_SIZE = 400  # the frame size of the scene 800000.tar was trained on
DNERF_DIR = ROOT / "benchmarks" / "round5_artifacts" / "full_dnerf_800k"
DNERF_CONFIG = DNERF_DIR / "config.txt"
DNERF_CKPT = DNERF_DIR / "800000.tar"  # trained on the same scene as the T-NeRF one
DNERF_RESULT = ROOT / "benchmarks" / "round5_artifacts" / "result_full_dnerf_800k.json"
DNERF_FRAMES = (0, 5, 10, 15, 20)  # the test frames --testskip 5 keeps

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


# The bf16 tensor-core launches (csrc/tc_chunk.cuh) and what the run learns
# of them, printed together before the JSON lines: registers and spills
# from build.log, TFLOP/s and share of bound per launch, B3's composite and
# the narrow heads' share of the blocks' cycles, the frames' ms.
TC_LAUNCHES = ("render_pass[S=64]", "render_pass[S=192]", "render_pass[tnerf,S=64]", "render_pass[pts,S=64]",
               "render_pass[pts,S=192]",
               "render_pass[pts,wide]", "time_net", "time_net[multires]", "trunk[mesh]", "trunk[raw,mesh]")
TC_SUMMARY: dict = {}


def tc_ptxas(libs) -> None:
    """Registers and spill bytes of the tensor-core kernels (the bf16 B6
    forward, B3's body, B7 / B8's forward-only launch, the weight-image
    packer, the reverse sweep's dW and dH products of B1 and B6) from each
    library's build.log; fails on a spill."""
    import re

    for name in ("time_net", "render_pass", "render_loss", "trunk"):
        entry_name = None
        for line in (libs[name].parent / "build.log").read_text().splitlines():
            if "Compiling entry function" in line:
                entry_name = line.split("'")[1] if "'" in line else line
                continue
            tc_names = r"time_net_tc_kernel|trunk_tc_kernel|tc13render_kernel|tc11pack_kernel|sweep_d[wh]_kernel"
            if not entry_name or not re.search(tc_names, entry_name):
                continue
            kernel = re.sub(r"^.*?(time_net_tc_kernel|trunk_tc_kernel|render_kernel|pack_kernel|sweep_d[wh]_kernel)",
                            r"\1", entry_name)[:60]
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                print(f"[2 tc ptxas {name}] {kernel}: {m.group(1)} / {m.group(2)} bytes spill stores / loads")
                if int(m.group(1)) or int(m.group(2)):
                    fail(f"{name}: {kernel} spills")
            m = re.search(r"Used (\d+) registers", line)
            if m:
                note = ("two warpgroups, every thread copies and both multiply" if kernel.startswith("sweep") else
                        "setmaxnreg: 56 for the producer warpgroup, 224 for the consumers")
                print(f"[2 tc ptxas {name}] {kernel}: {m.group(1)} registers at launch ({note})")


def tc_shares(lib_name: str, fn) -> tuple:
    """B3's composite and the narrow heads' shares of the blocks' clock
    cycles during one ``fn()`` of a tensor-core kernel of ``lib_name``
    (``<lib>_profile``: tc_chunk.cuh::g_prof, per block the cycles of the
    first composite thread, which overlaps the products, and of warpgroup
    1's first thread in the heads and in all)."""
    import ctypes

    import torch

    from swnerf_torch.ops.kernels import build

    hook = getattr(build.load(lib_name), f"{lib_name}_profile")
    hook.restype, hook.argtypes = None, [ctypes.c_void_p]
    buf = torch.zeros(3 * torch.cuda.get_device_properties(0).multi_processor_count, dtype=torch.int64,
                      device="cuda")
    hook(buf.data_ptr())
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        hook(None)
    comp, head, total = buf.view(-1, 3).sum(0).tolist()
    return comp / total, head / total


def tc_summary(kernels) -> None:
    for k in kernels:
        if k["name"] in TC_LAUNCHES and k["bound_by"] == "operations":
            share = k["bound_ms"] / k["ms"]
            print(f"[tc] {k['name']}: {k['ms']:.3f} ms/launch, {share * PEAK_FLOPS['bf16'] / 1e12:.1f} TFLOP/s, "
                  f"{100 * share:.2f}% of its bound ({k['bound_ms']:.4f} ms)")
    for key, value in TC_SUMMARY.items():
        print(f"[tc] {key}: {value}")


def load_models(dev):
    import torch

    from swnerf_torch.models import VanillaNeRF, VanillaNeRFConfig
    from swnerf_torch.train.checkpoint import load_tar, vanilla_state_dict

    ckpt = load_tar(str(CKPT))
    cfg = VanillaNeRFConfig()
    coarse, fine = VanillaNeRF(cfg, device=dev, fused=False), VanillaNeRF(cfg, device=dev, fused=False)
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

    t_start = time.perf_counter()
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
    tc_ptxas(libs)

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
    rays4k = type(rays)(*(None if x is None else x[idx] for x in rays))
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
    TC_SUMMARY["vanilla serving (phase 5)"] = f"{per_frame * 1e3:.1f} ms per frame"
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
        comp, head = tc_shares("render_pass", lambda: b3.render_pass(packed, o, d, ve, zz, dd, None, True))
        TC_SUMMARY[f"render_pass[S={S}] at the serving chunk"] = (
            f"composite busy {100 * comp:.2f}% (overlapped with the products), alpha + rgb heads {100 * head:.2f}% "
            "of the blocks' cycles")
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
    stages, first = frame_breakdown(rays, cfg, pc, pf, args.chunk)
    total = sum(stages.values())
    print("[6 breakdown] frame 0, device ms by stage (second pass): " + ", ".join(
        f"{k} {v:.2f} ({100 * v / total:.1f}%)" for k, v in stages.items()))
    print(f"[6 breakdown] stage sum {total:.1f} ms vs timed frame {per_frame * 1e3:.1f} ms; the first pass, "
          f"right after empty_cache: sum {sum(first.values()):.1f} ms, " + ", ".join(
              f"{k} {v:.2f}" for k, v in first.items()))
    del pc, pf, res_c, zf, distf
    torch.cuda.empty_cache()

    # ---- 7. B1 against its twin; 8. the kernel step against the eager step
    b1_rows = phase7_b1(dev, cfg, coarse, fine)
    phase8_steps(dev, cfg, coarse, fine)

    # ---- 9. the training main path; 10. the trained checkpoint serves
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        train_counts, ckpt = phase9_train(dev, cfg, coarse, fine, tmp)
        phase10_serve(tmp, ckpt, metrics["psnr"][0])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    kernels[0]["launches"] += train_counts.get("sample_pdf", 0)  # B2 runs on both main paths
    for S, row in b1_rows.items():
        kernels.append(entry(
            f"render_loss[S={S}]", "swnerf_torch/csrc/render_loss.cu", "swnerf_tpu/ops/pallas/render_fused.py:276",
            train_counts.get(f"render_loss[S={S}]", 0), *row,
        ))
    for k in kernels[len(kernels) - len(b1_rows):]:
        print(f"[6 kernel] {k['name']}: {k['ms']:.3f} ms/launch (plain {k['plain_ms']:.3f} ms), bound "
              f"{k['bound_ms']:.4f} ms by {k['bound_by']} -> {100 * k['bound_ms'] / k['ms']:.2f}% of the bound, "
              f"{k['launches']} launches in 200 train steps")

    # ---- 11-16. T-NeRF: scene, B4 against its twin, the kernel step, the
    # serving and training main paths, and the trained checkpoint serves
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tnerf_"))
    try:
        kernels += tnerf_phases(dev, tmp)
        # ---- 17-22. D-NeRF on the same scene: B6, B3's pts mode and B5
        # against their twins, the kernel step, serving, training, and the
        # trained checkpoint serves
        kernels += dnerf_phases(dev, tmp, tmp / "data_dyn_400")
        # ---- 23-25. MultiRes on the same scene: B7 and the widened B6
        # against their twins, the steps against the plain route, the CLI
        kernels += multires_phases(dev, tmp, tmp / "data_dyn_400")
        # ---- 26-30. B7' and B8 against their twins, the fields' kernel
        # routes through the CLIs, the SW mesh chain and its metric scale
        kernels += field_phases(dev, tmp, tmp / "data_dyn_400", metrics["psnr"][0])
        # ---- 31-35. MultiRes on the render kernels (B3's pts mode at its
        # widths, B9: the test render and the fused phase 2), B10, B11
        kernels += render_kernel_phases(dev, tmp, tmp / "data_dyn_400", metrics["psnr"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    tc_summary(kernels)
    print(f"[chip_smoke] every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


def b3_dists(z, d):
    from swnerf_torch.render.fused_eval import _dists_scaled

    return _dists_scaled(z, d).contiguous()


def bound(nbytes, ops, kind):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[kind] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def entry(name, source, replaces, launches, err, ms, plain_ms, nbytes, ops, kind):
    bound_ms, bound_by = bound(nbytes, ops, kind)
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }


# B1's and B6's backward by kernel family (kernel_split): the forward, the
# reverse sweep's tensor-core products (csrc/tc_gemm.cuh), the split
# reductions, the SIMT heads and narrow products.
SWEEP_FAMILIES = (("forward", ("render_loss_fwd", "time_net_fwd", "time_net_tc")),
                  ("tensor-core products", ("sweep_dw", "sweep_dh")),
                  ("split reductions", ("reduce_kernel", "colsum")),
                  ("SIMT products and heads", ("gemm_kernel", "head_bwd", "round_cotangent")))


def kernel_split(fn, families=SWEEP_FAMILIES):
    """Device ms of one ``fn()`` by kernel family (torch.profiler's CUDA
    activity, after a warm-up), or None when it records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by = dict.fromkeys([f for f, _ in families] + ["other"], 0.0)
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us and str(evt.device_type).endswith("CUDA"):
            by[next((f for f, keys in families if any(k in evt.key for k in keys)), "other")] += us / 1e3
    return by if sum(by.values()) > 0 else None


def sweep_products(W, D, skip, cin_pad, cv_pad=None, demb=False):
    """The reverse sweep's large products, as ("dw", in, out) for dW = X^T
    dZ and ("dh", out, in) for dH = dZ W^T: per trunk layer its dW and
    (above layer 0) its dH, the embedding rows' dW at layer 0 and the skip
    layer (with demb, B7, also dz W_emb^T there); with cv_pad (B1, B4, B7)
    first the view layer's two dW, d feat, the feature dW and the top
    layer's dH."""
    out = []
    if cv_pad is not None:
        out += [("dw", W, W // 2), ("dw", cv_pad, W // 2), ("dh", W // 2, W), ("dw", W, W), ("dh", W, W)]
    for i in range(D - 1, -1, -1):
        if i in (0, skip + 1):
            out.append(("dw", cin_pad, W))
            if demb:
                out.append(("dh", W, cin_pad))
        if i > 0:
            out += [("dw", W, W), ("dh", W, W)]
    return out


def library_sweep_ms(P, products, dev):
    """The products at P rows as bf16 torch.matmul calls (cuBLAS) on seeded
    operands, each timed with CUDA events: (sum of ms, multiply-adds). The
    port never calls them; they are the sweep's yardstick."""
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    total, macs = 0.0, 0
    for kind, a, b in products:
        if kind == "dw":  # [a, P] @ [P, b]: both operands row-major over P, as the spills are
            x = torch.randn((P, a), generator=g, device=dev).bfloat16()
            z = torch.randn((P, b), generator=g, device=dev).bfloat16()
            total += cuda_ms(lambda: torch.matmul(x.t(), z), 5)
        else:  # [P, a] @ [a, b]: the packed [b][a] matrix, transposed
            z = torch.randn((P, a), generator=g, device=dev).bfloat16()
            w = torch.randn((b, a), generator=g, device=dev).bfloat16()
            total += cuda_ms(lambda: torch.matmul(z, w.t()), 5)
        macs += P * a * b
    return total, macs


def report_sweep(tag, name, fn, ms, bound_ms, P, products, dev):
    """Prints a bf16 B1 / B6-backward launch's time beside its bound, its
    device time by kernel family and its sweep's large products on cuBLAS;
    returns (family split or None, the cuBLAS sum)."""
    split = kernel_split(fn)
    lib, macs = library_sweep_ms(P, products, dev)
    parts = ("not measured (torch.profiler recorded no device time)" if split is None
             else ", ".join(f"{k} {v:.3f}" for k, v in split.items() if v))
    print(f"[{tag} sweep] {name}: {ms:.3f} ms per launch, bound {bound_ms:.4f} ms ({100 * bound_ms / ms:.2f}%); "
          f"device ms by family: {parts}; its {len(products)} large products at {P} rows: bound "
          f"{2 * macs / PEAK_FLOPS['bf16'] * 1e3:.4f} ms, as bf16 torch.matmul calls (cuBLAS, summed) {lib:.3f} ms")
    TC_SUMMARY[f"{name}, the sweep's products on cuBLAS"] = f"{lib:.3f} ms beside the launch's {ms:.3f} ms"
    return split, lib


def frame_breakdown(rays, cfg, pc, pf, chunk):
    """Device milliseconds of each eval-pass stage over one frame, chunk by
    chunk as render_image runs it (CUDA events around each stage), twice:
    returns the second pass's stages, then the first's. The first pass runs
    right after the allocator's cache was emptied; where the host falls
    behind and the device drains, the idle time lands in the stage that
    waits (B2's, there), which the second pass does not see."""
    import torch

    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.kernels import sample_pdf as b2
    from swnerf_torch.ops.sampling import merge_z_vals

    names = ("rays+z", "coarse B3", "B2", "sort merge", "fine B3", "disp")
    reps = [dict.fromkeys(names, 0.0) for _ in range(2)]
    n_all = rays.origins.shape[0]
    for acc in reps:
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
    return reps[1], reps[0]


# ---------------------------------------------------------------- training phases


def train_view_rays(dev, n, seed):
    """``n`` seeded random pixels of train view r_0: rays (``build_rays``)
    and the white-composited target colours."""
    import numpy as np
    import torch

    from swnerf_torch.ops.rays import get_rays_at
    from swnerf_torch.render.core import build_rays
    from swnerf_torch.utils.png import read_png

    with open(DATADIR / "transforms_train.json") as f:
        meta = json.load(f)
    frame = meta["frames"][0]
    img = read_png(str(DATADIR / (frame["file_path"] + ".png"))).astype(np.float32) / 255.0
    img = img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])
    H, W = img.shape[:2]
    focal = 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    g = torch.Generator(device=dev).manual_seed(seed)
    pix = torch.stack([torch.randint(0, H, (n,), generator=g, device=dev),
                       torch.randint(0, W, (n,), generator=g, device=dev)], -1)
    c2w = torch.tensor(frame["transform_matrix"], dtype=torch.float32, device=dev)[:3, :4]
    o, d = get_rays_at(pix, H, W, K, c2w)
    target = torch.as_tensor(img, device=dev)[pix[:, 0], pix[:, 1]].contiguous()
    return build_rays(o, d, 2.0, 6.0), target


def rel_l2(got, ref):
    """Per-tensor ||got - ref|| / ||ref||, in float64."""
    return {k: ((got[k].double().cpu() - ref[k].double().cpu()).norm()
                / ref[k].double().cpu().norm().clamp_min(1e-300)).item() for k in ref}


def check_fp32_grads(tag, kern, ref32, ref64, ref64p=None):
    """The fp32 gradient bar: each tensor within rel L2 1e-4 of the fp32
    reference, or, where the two fp32 computations disagree on a ReLU mask,
    no further from the float64 reference than twice the fp32 reference is.
    At D=8 a few of the ~1e8 trunk pre-activations can sit within fp32
    rounding of 0; two summation orders then disagree on those masks and the
    lower trunk's gradients move by far more than 1e-4 (ROADMAP.md Queue C).
    With ``ref64p`` (the float64 reference on weights perturbed at fp32's
    size, see jitter) the fallback also admits twice the distance that
    perturbation moves the float64 reference: the D-NeRF deformation MLP's
    ReLUs tie often enough that two fp32 orders land ~1e-3 apart."""
    r32, rk, rr = rel_l2(kern, ref32), rel_l2(kern, ref64), rel_l2(ref32, ref64)
    rp = rel_l2(ref64p, ref64) if ref64p is not None else dict.fromkeys(rr, 0.0)
    print(f"[{tag}] rel L2 vs fp32 reference: max {max(r32.values()):.3e} ({max(r32, key=r32.get)}), "
          f"heads max {max(v for k, v in r32.items() if 'pts_linears' not in k):.3e}")
    print(f"[{tag}] rel L2 vs float64 reference: kernel max {max(rk.values()):.3e}, "
          f"fp32 reference max {max(rr.values()):.3e}"
          + (f", float64 under an fp32-sized perturbation max {max(rp.values()):.3e}" if ref64p is not None else ""))
    bad = {k: (r32[k], rk[k], rr[k], rp[k]) for k in rk if r32[k] > 1e-4 and rk[k] > 2.0 * max(rr[k], rp[k])}
    if bad:
        fail(f"{tag}: gradients off the fp32 reference and further from the float64 one than fp32 moves it: {bad}")


def phase7_b1(dev, cfg, coarse, fine):
    """B1 against its twin on the main path's shapes; returns, per S, the
    [6 kernel] row fields (max_abs_err, ms, plain_ms, bytes, ops, kind)."""
    import torch

    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import render_loss as b1
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.kernels import sample_pdf as b2
    from swnerf_torch.ops.sampling import merge_z_vals, sample_along_rays

    rays, target = train_view_rays(dev, 1024, seed=0)
    n = 1024
    scale = 1.0 / (3 * n)
    g = torch.Generator(device=dev).manual_seed(1)
    o, d = rays.origins, rays.directions
    ve = positional_encoding(rays.viewdirs, cfg.nf_views).contiguous()
    z64 = sample_along_rays(rays.near, rays.far, 64, 1.0, generator=g).contiguous()
    noise64 = torch.randn(z64.shape, generator=g, device=dev)  # std 1: the sigma > 0 mask is exercised
    pc32 = b3.pack_params(coarse.state_dict(), cfg, torch.float32)
    w64 = b1.render_loss_plain(pc32, o, d, ve, z64, b3_dists(z64, d), noise64, target, True, scale)[0].weights
    u = torch.rand((n, 128), generator=g, device=dev)
    zf = merge_z_vals(z64, b2.sample_pdf((0.5 * (z64[:, 1:] + z64[:, :-1])).contiguous(), w64[:, 1:-1], u))
    zf = zf.contiguous()
    noise192 = torch.randn(zf.shape, generator=g, device=dev)
    rows = {}
    for S, model, zz, nz in ((64, coarse, z64, noise64), (192, fine, zf, noise192)):
        args = (o, d, ve, zz, b3_dists(zz, d), nz, target)
        sd = model.state_dict()
        # fp32 operands: kernel vs twin, the float64 twin as the conditioning reference
        p32 = b3.pack_params(sd, cfg, torch.float32)
        got, gk = b1.render_loss(p32, *args, True, scale)
        ref, gr = b1.render_loss_plain(p32, *args, True, scale)
        p64 = b3.pack_params(sd, cfg, torch.float64)
        _, g64 = b1.render_loss_plain(p64, *(x.double() for x in args), True, scale)
        torch.cuda.synchronize()
        drgb = (got.rgb - ref.rgb).abs().max().item()
        dacc = (got.acc - ref.acc).abs().max().item()
        depth_ok = torch.allclose(got.depth, ref.depth, rtol=1e-4, atol=1e-5)
        # sqerr: rel 1e-4, with atol 1e-7 for the rays whose error is ~0
        sq_ok = torch.allclose(got.sqerr, ref.sqerr, rtol=1e-4, atol=1e-7)
        print(f"[7 B1 fp32 S={S}] max|drgb|={drgb:.3e} max|dacc|={dacc:.3e} "
              f"max|ddepth|={(got.depth - ref.depth).abs().max().item():.3e} depth_within_rtol={depth_ok} "
              f"max|dsqerr|={(got.sqerr - ref.sqerr).abs().max().item():.3e} sqerr_within_rtol={sq_ok} "
              f"max|dw|={(got.weights - ref.weights).abs().max().item():.3e}")
        if drgb > 1e-4 or dacc > 1e-4 or not depth_ok or not sq_ok:
            fail(f"B1 fp32 S={S} outputs outside rgb/acc 1e-4, depth and sqerr rtol 1e-4 (atol 1e-5 / 1e-7)")
        check_fp32_grads(f"7 B1 fp32 S={S}", b1.unpack_grads(gk, p32), b1.unpack_grads(gr, p32),
                         b1.unpack_grads(g64, p64))
        _, gk2 = b1.render_loss(p32, *args, True, scale)
        torch.cuda.synchronize()
        if not (torch.equal(gk[0], gk2[0]) and torch.equal(gk[1], gk2[1])):
            fail(f"B1 fp32 S={S}: two launches gave different gradients")
        del gr, g64, gk2
        # bf16 operands (the main path's): kernel vs the bf16 twin
        p16 = b3.pack_params(sd, cfg, torch.bfloat16)
        got, gk = b1.render_loss(p16, *args, True, scale)
        ref, gr = b1.render_loss_plain(p16, *args, True, scale)
        _, gk2 = b1.render_loss(p16, *args, True, scale)
        torch.cuda.synchronize()
        diff = (got.rgb - ref.rgb).abs()
        rel = rel_l2(b1.unpack_grads(gk, p16), b1.unpack_grads(gr, p16))
        same = torch.equal(gk[0], gk2[0]) and torch.equal(gk[1], gk2[1])
        print(f"[7 B1 bf16 S={S}] max|drgb|={diff.max().item():.3e} mean|drgb|={diff.mean().item():.3e} "
              f"grads max rel L2={max(rel.values()):.3e} ({max(rel, key=rel.get)}) repeat bit-equal={same}")
        if diff.max().item() > 1e-2 or diff.mean().item() > 1e-3 or max(rel.values()) > 1e-2 or not same:
            fail(f"B1 bf16 S={S}: rgb max > 1e-2, mean > 1e-3, gradient rel L2 > 1e-2 or repeats differ")
        nbytes = (4 * (6 * n + ve.numel() + 3 * zz.numel() + 3 * n) + 2 * p16.weights.numel() + 4 * p16.biases.numel()
                  + 4 * (4 * n + zz.numel()) + 4 * (p16.weights.numel() + p16.biases.numel()))
        flops = 2 * b1.train_macs_per_sample(p16) * zz.numel()
        ms = cuda_ms(lambda: b1.render_loss(p16, *args, True, scale), 5)
        plain_ms = cuda_ms(lambda: b1.render_loss_plain(p16, *args, True, scale), 2)
        rows[S] = (diff.max().item(), ms, plain_ms, nbytes, flops, "bf16")
        report_sweep("7", f"render_loss[S={S}] bf16", lambda: b1.render_loss(p16, *args, True, scale), ms,
                     bound(nbytes, flops, "bf16")[0], zz.numel(),
                     sweep_products(p16.W, p16.D, p16.skip, p16.cin_pad, p16.cv_pad), dev)
        del gk, gr, gk2, got, ref
        torch.cuda.empty_cache()
    return rows


def _fresh_state(cfg, coarse, fine, device, dtype=None):
    from swnerf_torch.models import VanillaNeRF
    from swnerf_torch.train.loop import init_train_state

    def copy(model):
        m = VanillaNeRF(cfg, device=device, fused=False)  # the eager step's reference: plain torch
        m.load_state_dict(model.state_dict())
        return m.to(dtype) if dtype is not None else m

    return init_train_state(copy(coarse), copy(fine), 5e-4, 500, step=10000)


def _grads(state):
    return {f"{net}.{k}": p.grad.detach().clone() for net, m in (("coarse", state.coarse), ("fine", state.fine))
            for k, p in m.named_parameters()}


def phase8_steps(dev, cfg, coarse, fine):
    """The kernel step (B1, B2) against the eager autograd step, same state
    and draws; the eager step in float64 on the CPU is the reference for the
    gradient bar of check_fp32_grads."""
    import torch

    from swnerf_torch.render.core import Draws, RenderConfig, Rays, make_draws
    from swnerf_torch.train.fused_step import make_fused_train_step
    from swnerf_torch.train.loop import make_train_step

    rays, target = train_view_rays(dev, 1024, seed=2)
    rcfg = RenderConfig(n_samples=64, n_importance=128, perturb=1.0, white_bkgd=True, raw_noise_std=1.0)
    draws = make_draws(rcfg, 1024, torch.Generator(device=dev).manual_seed(3), dev)
    sk, se = _fresh_state(cfg, coarse, fine, dev), _fresh_state(cfg, coarse, fine, dev)
    mk = make_fused_train_step(cfg, rcfg, fcfg=cfg, compute_dtype=torch.float32)(sk, rays, target, draws=draws)
    me = make_train_step(rcfg)(se, rays, target, draws=draws)
    torch.cuda.synchronize()
    s64 = _fresh_state(cfg, coarse, fine, "cpu", torch.float64)
    cpu64 = lambda x: None if x is None else x.detach().cpu().double()  # noqa: E731
    make_train_step(rcfg)(s64, Rays(*(cpu64(x) for x in rays)), cpu64(target), draws=Draws(*(cpu64(x) for x in draws)))
    dloss = abs(mk["total_loss"].item() - me["total_loss"].item()) / me["total_loss"].item()
    print(f"[8 step fp32] total_loss kernel {mk['total_loss'].item():.7f} eager {me['total_loss'].item():.7f} "
          f"rel {dloss:.3e}; psnr {mk['psnr'].item():.4f} vs {me['psnr'].item():.4f}")
    if dloss > 1e-5:
        fail(f"kernel step loss rel {dloss} > 1e-5")
    check_fp32_grads("8 step fp32", _grads(sk), _grads(se), _grads(s64))
    sb = _fresh_state(cfg, coarse, fine, dev)
    mb = make_fused_train_step(cfg, rcfg, fcfg=cfg, compute_dtype=torch.bfloat16)(sb, rays, target, draws=draws)
    dl16 = abs(mb["total_loss"].item() - me["total_loss"].item()) / me["total_loss"].item()
    print(f"[8 step bf16] total_loss kernel {mb['total_loss'].item():.7f} vs fp32 eager: rel {dl16:.3e}")
    if dl16 > 1e-2:
        fail(f"bf16 kernel step loss rel {dl16} > 1e-2")
    del sk, se, s64, sb
    torch.cuda.empty_cache()


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self):
        for st in self.streams:
            st.flush()


def phase9_train(dev, cfg, coarse, fine, tmp):
    """The training main path through the CLI: 200 steps resumed from
    010000.tar. Returns its launch counts and the last checkpoint's path."""
    import torch

    from swnerf_torch.ops.kernels import launches
    from swnerf_torch.pipelines import run_nerf
    from swnerf_torch.train.checkpoint import load_tar

    argv = [
        "--config", str(CONFIG), "--ft_path", str(CKPT), "--basedir", str(tmp), "--datadir", str(DATADIR),
        "--device", "cuda", "--i_print", "50", "--i_weights", "100",
    ]
    os.environ["SWNERF_MAX_ITERS"] = "10201"
    buf = io.StringIO()
    try:
        launches.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
            res = run_nerf.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launches)
    finally:
        os.environ.pop("SWNERF_MAX_ITERS", None)
    out = buf.getvalue()
    exp = tmp / "full_nerf_200k"
    print(f"[9 train] launches {json.dumps(counts, sort_keys=True)} (200 steps), CLI wall {wall:.2f} s")
    if f"Reloading from {CKPT}" not in out or "kernel train step" not in out or min(res["step_ms"]) != 10001:
        fail("the training run did not resume from 010000.tar at 10000 on the kernel step")
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    psnrs = [(r["step"], r["psnr"]) for r in recs if "psnr" in r]
    print(f"[9 train] train PSNR at the prints: {psnrs}")
    if len(psnrs) != 4 or min(p for _, p in psnrs) < 30.0:
        fail(f"train PSNR below 30 dB at a print (or not 4 prints): {psnrs}")
    for i in (10100, 10200):
        ck = load_tar(str(exp / f"{i:06d}.tar"))
        steps = {int(e["step"]) for e in ck["optimizer_state_dict"]["state"].values()}
        keys = set(ck)
        print(f"[9 train] {i:06d}.tar keys {sorted(keys)} Adam step {steps}")
        if keys != {"global_step", "network_fn_state_dict", "network_fine_state_dict", "optimizer_state_dict"} \
                or steps != {i} or ck["global_step"] != i:
            fail(f"{i:06d}.tar: keys {keys}, Adam steps {steps}")
    b1_count = counts.get("render_loss[S=64]", 0) + counts.get("render_loss[S=192]", 0)
    if b1_count < 400 or counts.get("sample_pdf", 0) < 200:
        fail(f"the training main path launched B1 {b1_count} and B2 {counts.get('sample_pdf', 0)} times")
    quiet = {i: ms for i, ms in res["step_ms"].items() if i % 50 and (i - 1) % 50}
    med = statistics.median(quiet.values())
    spr = 1024 * (64 + 192)
    print(f"[9 train] ms per step, median of {len(quiet)} steps that neither print nor save (CUDA events): "
          f"{med:.3f} ms (min {min(quiet.values()):.3f}, max {max(quiet.values()):.3f}); "
          f"{1024 / med * 1e3:.4g} rays/s, {spr / med * 1e3:.4g} samples/s")
    stages = step_breakdown(dev, cfg, coarse, fine)
    total = sum(stages.values())
    print("[9 breakdown] one step, device ms by stage: " + ", ".join(
        f"{k} {v:.3f} ({100 * v / total:.1f}%)" for k, v in stages.items()))
    print(f"[9 breakdown] stage sum {total:.2f} ms vs median step {med:.2f} ms")
    from swnerf_torch.ops.kernels import render_loss as b1
    from swnerf_torch.ops.kernels import render_pass as b3

    macs = b1.train_macs_per_sample(b3.pack_params(fine.state_dict(), cfg))
    print("[9 breakdown] " + ", ".join(
        f"{k} {stages[k]:.3f} ms against its bound {2 * macs * 1024 * s / PEAK_FLOPS['bf16'] * 1e3:.4f} ms"
        for k, s in (("coarse B1", 64), ("fine B1", 192))))
    return counts, exp / "010200.tar"


def step_breakdown(dev, cfg, coarse, fine):
    """Device milliseconds of each stage of one kernel train step (bf16, the
    CLI's step), CUDA events between stages, after one warm-up step. The
    stages are those of train/fused_step.py, written out here."""
    import numpy as np
    import torch

    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import render_loss as b1
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.kernels import sample_pdf as b2
    from swnerf_torch.ops.rays import get_rays_at
    from swnerf_torch.ops.sampling import merge_z_vals, sample_along_rays
    from swnerf_torch.pipelines.common import ImageSampler, Scene
    from swnerf_torch.render.core import RenderConfig, build_rays, make_draws
    from swnerf_torch.train.fused_step import _set_grads

    rays, _ = train_view_rays(dev, 1, seed=0)
    with open(DATADIR / "transforms_train.json") as f:
        meta = json.load(f)
    H = W = 400
    focal = 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    poses = np.array([fr["transform_matrix"] for fr in meta["frames"][:1]], np.float32)
    scene = Scene(images=np.zeros((1, H, W, 3), np.float32), poses=poses, render_poses=poses, H=H, W=W, focal=focal,
                  K=K, near=2.0, far=6.0, i_train=np.arange(1), i_val=np.arange(0), i_test=np.arange(0))
    images = torch.rand((1, H, W, 3), device=dev)
    poses_dev = torch.as_tensor(poses[:, :3, :4], device=dev)
    sampler = ImageSampler(scene, 1024, 0, 0.5)
    rcfg = RenderConfig(n_samples=64, n_importance=128, perturb=1.0, white_bkgd=True)
    state = _fresh_state(cfg, coarse, fine, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    names = ("host sampler", "rays + z", "pack coarse", "coarse B1", "B2", "sort", "pack fine", "fine B1",
             "unpack + Adam")
    acc = dict.fromkeys(names, 0.0)
    for rep in range(2):  # the first is the warm-up
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        torch.cuda.synchronize()
        ev[0].record()
        img_i, pixels = sampler.next(20000)
        pixels = torch.as_tensor(pixels, device=dev)
        ev[1].record()
        o, d = get_rays_at(pixels, H, W, K, poses_dev[img_i])
        target = images[img_i][pixels[:, 0], pixels[:, 1]].contiguous()
        r = build_rays(o, d, 2.0, 6.0)
        draws = make_draws(rcfg, 1024, g, dev)
        z = sample_along_rays(r.near, r.far, 64, 1.0, t_rand=draws.t_rand).contiguous()
        ve = positional_encoding(r.viewdirs, cfg.nf_views).contiguous()
        ev[2].record()
        state.zero_grad()
        pk = b3.pack_params(state.coarse.state_dict(), cfg, torch.bfloat16)
        ev[3].record()
        oc, gc = b1.render_loss(pk, r.origins, r.directions, ve, z, b3_dists(z, r.directions), None, target, True,
                                1.0 / 3072)
        ev[4].record()
        zs = b2.sample_pdf((0.5 * (z[:, 1:] + z[:, :-1])).contiguous(), oc.weights[:, 1:-1], draws.u)
        ev[5].record()
        zf = merge_z_vals(z, zs).contiguous()
        ev[6].record()
        pkf = b3.pack_params(state.fine.state_dict(), cfg, torch.bfloat16)
        ev[7].record()
        _, gf = b1.render_loss(pkf, r.origins, r.directions, ve, zf, b3_dists(zf, r.directions), None, target, True,
                               1.0 / 3072)
        ev[8].record()
        _set_grads(state.coarse, b1.unpack_grads(gc, pk))
        _set_grads(state.fine, b1.unpack_grads(gf, pkf))
        state.apply_update()
        ev[9].record()
        torch.cuda.synchronize()
        if rep:
            for i, k in enumerate(names):
                acc[k] = ev[i].elapsed_time(ev[i + 1])
    return acc


def phase10_serve(tmp, ckpt, psnr_before):
    """Test frame 0 rendered from the trained checkpoint by the serving CLI."""
    from swnerf_torch.pipelines import run_nerf

    argv = [
        "--config", str(CONFIG), "--render_only", "--render_test", "--testskip", "25", "--device", "cuda",
        "--basedir", str(tmp / "serve"), "--datadir", str(DATADIR), "--ft_path", str(ckpt),
    ]
    metrics = json.loads((Path(run_nerf.main(argv)) / "metrics.json").read_text())
    psnr = metrics["psnr"][0]
    print(f"[10 serve] frame 0 from {ckpt.name}: PSNR {psnr:.3f} dB SSIM {metrics['ssim'][0]:.4f}; "
          f"from 010000.tar {psnr_before:.3f} dB (delta {psnr - psnr_before:+.3f} dB)")
    if not psnr >= 30.0 or abs(psnr - psnr_before) > 0.5:
        fail(f"frame 0 from {ckpt.name}: {psnr} dB (< 30 dB or more than 0.5 dB from {psnr_before})")


# ---------------------------------------------------------------- T-NeRF phases


def tnerf_phases(dev, tmp):
    """Phases 11-16. Returns the [kernel] rows of B4 in its two modes."""
    import torch

    from swnerf_torch.models import TNeRF, TNeRFConfig
    from swnerf_torch.train.checkpoint import load_tar, tnerf_state_dict

    data = phase11_scene(dev, tmp / "data_dyn_400")
    cfg = TNeRFConfig()
    model = TNeRF(cfg, device=dev, fused=False)
    model.load_state_dict(tnerf_state_dict(load_tar(str(TNERF_CKPT))["network_fn_state_dict"]))
    model.eval()
    rows = phase12_b4(dev, cfg, model, data)
    phase13_step(dev, cfg, model, data)
    del model
    torch.cuda.empty_cache()
    exp = tmp / "logs" / "full_tnerf_800k"  # the config's expname: the copy is the newest .tar there
    exp.mkdir(parents=True)
    shutil.copy(TNERF_CKPT, exp / "800000.tar")
    serve_counts, psnr0 = phase14_serve(dev, cfg, tmp, data)
    train_counts = phase15_train(dev, cfg, tmp, data)
    phase16_serve(tmp, data, psnr0)
    rows["render_pass"]["launches"] = serve_counts.get("render_pass[tnerf,S=64]", 0)
    rows["render_loss"]["launches"] = train_counts.get("render_loss[tnerf,S=64]", 0)
    for k in rows.values():
        print(f"[12 kernel] {k['name']}: {k['ms']:.3f} ms/launch (plain {k['plain_ms']:.3f} ms), bound "
              f"{k['bound_ms']:.4f} ms by {k['bound_by']} -> {100 * k['bound_ms'] / k['ms']:.2f}% of the bound, "
              f"{k['launches']} launches on its main path")
    return list(rows.values())


def tnerf_args(tmp, data, *extra):
    return ["--config", str(TNERF_CONFIG), "--basedir", str(tmp / "logs"), "--datadir", str(data),
            "--device", "cuda", *extra]


def phase11_scene(dev, root):
    """The scene of benchmarks/tpu_full_scale.py:115-129, written by the
    port: write_blender_scene(n_train=100, n_val=5, n_test=25, size=400,
    dynamic=True, scene="textured", white_bkgd=True), seed 0, 128 samples."""
    import torch

    from swnerf_torch.data.synthetic import write_blender_scene

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    write_blender_scene(str(root), n_train=100, n_val=5, n_test=25, size=TNERF_SIZE, dynamic=True,
                        scene="textured", white_bkgd=True, device=dev)
    torch.cuda.synchronize()
    print(f"[11 scene] dynamic textured {TNERF_SIZE}x{TNERF_SIZE}, 100/5/25 views, 128 GT samples: written in "
          f"{time.perf_counter() - t0:.2f} s")
    return root


def gt_image(data, split, index):
    """(frame metadata, white-composited image [H, W, 3]) of one view of the
    written scene."""
    import numpy as np

    from swnerf_torch.utils.png import read_png

    with open(data / f"transforms_{split}.json") as f:
        meta = json.load(f)
    frame = meta["frames"][index]
    img = read_png(str(data / (frame["file_path"] + ".png"))).astype(np.float32) / 255.0
    return meta, frame, img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])


def unit_range_psnr(psnrs, data):
    """The CLI's per-test-frame PSNRs (metrics.json: skimage's, whose data
    range is the ground truth's max - min) on the scale of the evaluator that
    logged the reference's 21.60 dB (benchmarks/parity_vs_torch.py:445,
    data_range=1.0). The MSE is the same, so the two differ by
    -20 log10(max - min): about 1.1 dB on this scene, whose darkest colour
    is sigmoid(-2) = 0.12. T-NeRF's colours lie in [0, 1], so the
    evaluator's clip changes nothing."""
    import math

    out = []
    for i, p in enumerate(psnrs):
        img = gt_image(data, "test", i)[2]
        out.append(p - 20.0 * math.log10(float(img.max() - img.min())))
    return out


def frame_rays(dev, data, split, index):
    """All rays of one view of the written scene at its frame time, and its
    white-composited image [H*W, 3]."""
    import numpy as np
    import torch

    from swnerf_torch.render.core import make_rays_from_camera

    meta, frame, img = gt_image(data, split, index)
    H, W = img.shape[:2]
    focal = 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    c2w = np.array(frame["transform_matrix"], np.float32)[:3, :4]
    rays = make_rays_from_camera(H, W, K, c2w, 2.0, 6.0, device=dev, time=float(frame["time"]))
    return rays, torch.as_tensor(img.reshape(-1, 3), device=dev)


def tnerf_pass_inputs(rays, cfg, z):
    from swnerf_torch.ops.embedding import positional_encoding

    o, d = rays.origins.contiguous(), rays.directions.contiguous()
    ve = positional_encoding(rays.viewdirs, cfg.nf_views).contiguous()
    return o, d, ve, z.contiguous(), b3_dists(z, d), rays.times.reshape(-1).contiguous()


def phase12_b4(dev, cfg, model, data):
    """B4 against its twin in both modes and operand types, and its times at
    the main paths' shapes. Returns the two [kernel] rows (launches filled
    in by the main paths)."""
    import torch

    from swnerf_torch.ops.kernels import render_loss as b1
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.sampling import sample_along_rays

    sd = model.state_dict()
    rays, _ = frame_rays(dev, data, "test", 0)
    idx = torch.arange(4096, device=dev) * (TNERF_SIZE**2 // 4096)  # spread over the frame: objects and background
    r4k = type(rays)(*(x[idx] for x in rays))
    o, d, ve, z, dist, t = tnerf_pass_inputs(r4k, cfg, sample_along_rays(r4k.near, r4k.far, 64, 0.0))
    fwd_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        packed = b3.pack_tnerf_params(sd, cfg, dtype)
        got = b3.render_pass(packed, o, d, ve, z, dist, None, True, t)
        ref = b3.render_pass_plain(packed, o, d, ve, z, dist, None, True, t)
        torch.cuda.synchronize()
        drgb = (got.rgb - ref.rgb).abs()
        dacc = (got.acc - ref.acc).abs().max().item()
        depth_ok = torch.allclose(got.depth, ref.depth, rtol=1e-4, atol=1e-5)
        tag = "fp32" if dtype == torch.float32 else "bf16"
        print(f"[12 B4 fwd {tag}] N=4096 S=64 t={float(t[0]):.3f}: max|drgb|={drgb.max().item():.3e} "
              f"mean|drgb|={drgb.mean().item():.3e} max|dacc|={dacc:.3e} "
              f"max|ddepth|={(got.depth - ref.depth).abs().max().item():.3e} depth_within_rtol={depth_ok} "
              f"max|dw|={(got.weights - ref.weights).abs().max().item():.3e}")
        if dtype == torch.float32:
            if drgb.max().item() > 1e-4 or dacc > 1e-4 or not depth_ok:
                fail("B4 forward fp32 outside atol 1e-4 (rgb, acc) / rtol 1e-4 (depth)")
        else:
            fwd_err = drgb.max().item()
            if fwd_err > 1e-2 or drgb.mean().item() > 1e-3:
                fail("B4 forward bf16: max |drgb| > 1e-2 or mean > 1e-3")

    # train mode: 500 seeded pixels of train view 37 at its frame time, noise std 1
    n, scale = 500, 1.0 / 1500
    rays, img = frame_rays(dev, data, "train", 37)
    g = torch.Generator(device=dev).manual_seed(0)
    sel = torch.randint(0, img.shape[0], (n,), generator=g, device=dev)
    r500 = type(rays)(*(x[sel] for x in rays))
    target = img[sel].contiguous()
    z = sample_along_rays(r500.near, r500.far, 64, 1.0, generator=g)
    noise = torch.randn(z.shape, generator=g, device=dev)
    o, d, ve, z, dist, t = tnerf_pass_inputs(r500, cfg, z)
    args = (o, d, ve, z, dist, noise, target)
    p32 = b3.pack_tnerf_params(sd, cfg, torch.float32)
    got, gk = b1.render_loss(p32, *args, True, scale, t)
    ref, gr = b1.render_loss_plain(p32, *args, True, scale, t)
    p64 = b3.pack_tnerf_params(sd, cfg, torch.float64)
    _, g64 = b1.render_loss_plain(p64, *(x.double() for x in args), True, scale, t.double())
    torch.cuda.synchronize()
    drgb = (got.rgb - ref.rgb).abs().max().item()
    sq_ok = torch.allclose(got.sqerr, ref.sqerr, rtol=1e-4, atol=1e-7)
    depth_ok = torch.allclose(got.depth, ref.depth, rtol=1e-4, atol=1e-5)
    print(f"[12 B4 train fp32] N=500 S=64 t={float(t[0]):.4f}: max|drgb|={drgb:.3e} "
          f"max|dsqerr|={(got.sqerr - ref.sqerr).abs().max().item():.3e} sqerr_within_rtol={sq_ok} "
          f"depth_within_rtol={depth_ok}")
    if drgb > 1e-4 or not sq_ok or not depth_ok:
        fail("B4 train fp32 outputs outside rgb 1e-4, sqerr rtol 1e-4 (atol 1e-7), depth rtol 1e-4")
    check_fp32_grads("12 B4 train fp32", b1.unpack_tnerf_grads(gk, p32), b1.unpack_tnerf_grads(gr, p32),
                     b1.unpack_tnerf_grads(g64, p64))
    _, gk2 = b1.render_loss(p32, *args, True, scale, t)
    torch.cuda.synchronize()
    if not (torch.equal(gk[0], gk2[0]) and torch.equal(gk[1], gk2[1])):
        fail("B4 train fp32: two launches gave different gradients")
    p16 = b3.pack_tnerf_params(sd, cfg, torch.bfloat16)
    got, gk = b1.render_loss(p16, *args, True, scale, t)
    ref, gr = b1.render_loss_plain(p16, *args, True, scale, t)
    _, gk2 = b1.render_loss(p16, *args, True, scale, t)
    torch.cuda.synchronize()
    diff = (got.rgb - ref.rgb).abs()
    rel = rel_l2(b1.unpack_tnerf_grads(gk, p16), b1.unpack_tnerf_grads(gr, p16))
    same = torch.equal(gk[0], gk2[0]) and torch.equal(gk[1], gk2[1])
    print(f"[12 B4 train bf16] max|drgb|={diff.max().item():.3e} mean|drgb|={diff.mean().item():.3e} "
          f"grads max rel L2={max(rel.values()):.3e} ({max(rel, key=rel.get)}) repeat bit-equal={same}")
    if diff.max().item() > 1e-2 or diff.mean().item() > 1e-3 or max(rel.values()) > 1e-2 or not same:
        fail("B4 train bf16: rgb max > 1e-2, mean > 1e-3, gradient rel L2 > 1e-2 or repeats differ")
    train_ms = cuda_ms(lambda: b1.render_loss(p16, *args, True, scale, t), 20)
    train_row = entry(
        "render_loss[tnerf,S=64]", "swnerf_torch/csrc/render_loss.cu", "swnerf_tpu/ops/pallas/render_fused.py:276",
        0, diff.max().item(), train_ms,
        cuda_ms(lambda: b1.render_loss_plain(p16, *args, True, scale, t), 5),
        4 * (7 * n + ve.numel() + 3 * z.numel() + 3 * n) + 2 * p16.weights.numel() + 4 * p16.biases.numel()
        + 4 * (4 * n + z.numel()) + 4 * (p16.weights.numel() + p16.biases.numel()),
        2 * b1.train_macs_per_sample(p16) * z.numel(), "bf16",
    )
    report_sweep("12", "render_loss[tnerf,S=64] bf16", lambda: b1.render_loss(p16, *args, True, scale, t), train_ms,
                 train_row["bound_ms"], z.numel(), sweep_products(p16.W, p16.D, p16.skip, p16.cin_pad, p16.cv_pad), dev)

    # forward at the serving path's shape: the first 32,768-ray chunk of test view 0
    rays, _ = frame_rays(dev, data, "test", 0)
    chunk = rays.slice(0, 32768)
    o, d, ve, z, dist, t = tnerf_pass_inputs(chunk, cfg, sample_along_rays(chunk.near, chunk.far, 64, 0.0))
    got = b3.render_pass(p16, o, d, ve, z, dist, None, True, t)
    ref = b3.render_pass_plain(p16, o, d, ve, z, dist, None, True, t)
    drgb = (got.rgb - ref.rgb).abs()
    print(f"[12 check] render_pass[tnerf,S=64] bf16 N=32768: max|drgb|={drgb.max().item():.3e} "
          f"mean|drgb|={drgb.mean().item():.3e}")
    if drgb.max().item() > 1e-2 or drgb.mean().item() > 1e-3:
        fail("B4 forward bf16 at the serving shape: max |drgb| > 1e-2 or mean > 1e-3")
    del got, ref
    nc = z.shape[0]
    fwd_row = entry(
        "render_pass[tnerf,S=64]", "swnerf_torch/csrc/render_pass.cu", "swnerf_tpu/ops/pallas/render_fused.py:276",
        0, max(fwd_err, drgb.max().item()),
        cuda_ms(lambda: b3.render_pass(p16, o, d, ve, z, dist, None, True, t), 10),
        cuda_ms(lambda: b3.render_pass_plain(p16, o, d, ve, z, dist, None, True, t), 3),
        4 * (7 * nc + ve.numel() + 2 * z.numel() + 5 * nc + z.numel()) + 2 * p16.weights.numel(),
        2 * p16.macs_per_sample * z.numel(), "bf16",
    )
    comp, head = tc_shares("render_pass", lambda: b3.render_pass(p16, o, d, ve, z, dist, None, True, t))
    TC_SUMMARY["render_pass[tnerf,S=64] at the serving chunk"] = (
        f"composite busy {100 * comp:.2f}% (overlapped with the products), alpha + rgb heads {100 * head:.2f}% "
        "of the blocks' cycles")
    # the same body on a seeded vanilla field of the same width and depth
    # (ReLU, no time columns, 63 input columns: one atom) at the same rows
    from swnerf_torch.models import VanillaNeRF, VanillaNeRFConfig

    vcfg = VanillaNeRFConfig(netdepth=8, netwidth=128)
    pv = b3.pack_params(VanillaNeRF(vcfg, device=dev, generator=torch.Generator().manual_seed(0),
                                    fused=False).state_dict(), vcfg, torch.bfloat16)
    vms = cuda_ms(lambda: b3.render_pass(pv, o, d, ve, z, dist, None, True), 10)
    print(f"[12 times] B4 forward (bf16, tensor cores) at the serving chunk: {fwd_row['ms']:.3f} ms "
          f"({2 * p16.macs_per_sample * z.numel() / fwd_row['ms'] / 1e9:.2f} TFLOP/s); B3 on a vanilla field at the "
          f"same W=128, D=8 and rows (ReLU, no time columns, {pv.cin} input columns): {vms:.3f} ms "
          f"({2 * pv.macs_per_sample * z.numel() / vms / 1e9:.2f} TFLOP/s)")
    del pv
    torch.cuda.empty_cache()
    return {"render_pass": fwd_row, "render_loss": train_row}


def phase13_step(dev, cfg, model, data):
    """The kernel T-NeRF step (B4) against the eager autograd step from the
    same state and draws; the eager step in float64 on the CPU is the
    gradient reference of check_fp32_grads."""
    import torch

    from swnerf_torch.models import TNeRF
    from swnerf_torch.render.core import Draws, Rays, RenderConfig, make_draws
    from swnerf_torch.train.fused_step import make_fused_tnerf_step
    from swnerf_torch.train.loop import init_train_state, make_train_step

    rays, img = frame_rays(dev, data, "train", 61)
    g = torch.Generator(device=dev).manual_seed(2)
    sel = torch.randint(0, img.shape[0], (500,), generator=g, device=dev)
    rays = Rays(*(x[sel] for x in rays))
    target = img[sel].contiguous()
    rcfg = RenderConfig(n_samples=64, perturb=1.0, white_bkgd=True, raw_noise_std=1.0)
    draws = make_draws(rcfg, 500, torch.Generator(device=dev).manual_seed(3), dev)

    def fresh(device, dtype=torch.float32):
        m = TNeRF(cfg, device=device, fused=False)  # the eager step's reference: plain torch
        m.load_state_dict(model.state_dict())
        return init_train_state(m.to(dtype), None, 5e-4, 500, step=800000)

    def grads(st):
        return {k: p.grad.detach().clone() for k, p in st.coarse.named_parameters()}

    sk, se, s64 = fresh(dev), fresh(dev), fresh("cpu", torch.float64)
    mk = make_fused_tnerf_step(cfg, rcfg, compute_dtype=torch.float32)(sk, rays, target, draws=draws)
    me = make_train_step(rcfg)(se, rays, target, draws=draws)
    cpu64 = lambda x: None if x is None else x.detach().cpu().double()  # noqa: E731
    make_train_step(rcfg)(s64, Rays(*(cpu64(x) for x in rays)), cpu64(target), draws=Draws(*(cpu64(x) for x in draws)))
    torch.cuda.synchronize()
    dloss = abs(mk["loss"].item() - me["loss"].item()) / me["loss"].item()
    print(f"[13 step fp32] loss kernel {mk['loss'].item():.7f} eager {me['loss'].item():.7f} rel {dloss:.3e}; "
          f"psnr {mk['psnr'].item():.4f} vs {me['psnr'].item():.4f}")
    if dloss > 1e-5:
        fail(f"kernel T-NeRF step loss rel {dloss} > 1e-5")
    check_fp32_grads("13 step fp32", grads(sk), grads(se), grads(s64))
    sb = fresh(dev)
    mb = make_fused_tnerf_step(cfg, rcfg, compute_dtype=torch.bfloat16)(sb, rays, target, draws=draws)
    dl16 = abs(mb["loss"].item() - me["loss"].item()) / me["loss"].item()
    print(f"[13 step bf16] loss kernel {mb['loss'].item():.7f} vs fp32 eager: rel {dl16:.3e}")
    if dl16 > 1e-2:
        fail(f"bf16 kernel T-NeRF step loss rel {dl16} > 1e-2")
    del sk, se, s64, sb
    torch.cuda.empty_cache()


def phase14_serve(dev, cfg, tmp, data):
    """The serving main path through run_tnerf: 25 test frames at their
    times. Returns its launch counts and frame 0's PSNR."""
    import torch

    from swnerf_torch.ops.kernels import launches
    from swnerf_torch.pipelines import run_tnerf
    from swnerf_torch.render.core import RenderConfig, render_image
    from swnerf_torch.render.fused_eval import make_tnerf_eval_pass
    from swnerf_torch.utils.metrics import calculate_metrics

    launches.clear()
    t0 = time.perf_counter()
    savedir = Path(run_tnerf.main(tnerf_args(tmp, data, "--render_only", "--render_test")))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launches)
    metrics = json.loads((savedir / "metrics.json").read_text())
    print(f"[14 main] launches {json.dumps(counts, sort_keys=True)} (25 frames), CLI wall {wall:.2f} s")
    if counts.get("render_pass[tnerf,S=64]", 0) <= 0:
        fail("the T-NeRF serving path launched no render_pass[tnerf,S=64]")
    secs = metrics["seconds_per_frame"]
    per_frame = sum(secs[1:]) / len(secs[1:])  # frame 0 is the warm-up
    print(f"[14 main] seconds per frame {[round(x, 4) for x in secs]}")
    n_rays = TNERF_SIZE**2
    print(f"[14 main] frames 1-24: {per_frame * 1e3:.2f} ms/frame, {n_rays / per_frame:.4g} rays/s, "
          f"{n_rays * 64 / per_frame:.4g} samples/s")
    unit = unit_range_psnr(metrics["psnr"], data)
    for i, (p, u, q) in enumerate(zip(metrics["psnr"], unit, metrics["ssim"])):
        print(f"[14 main] frame {i}: PSNR {p:.3f} dB (data range 1: {u:.3f} dB) SSIM {q:.4f}")
    mean_psnr, mean_unit = sum(metrics["psnr"]) / len(unit), sum(unit) / len(unit)
    print(f"[14 main] mean PSNR {mean_psnr:.3f} dB (data range 1: {mean_unit:.3f} dB; the reference run logged "
          f"21.596), mean SSIM {sum(metrics['ssim']) / len(unit):.4f} over {len(unit)} frames")
    if len(unit) != 25 or not mean_unit >= 20.5:
        fail(f"mean PSNR {mean_unit} (data range 1) < 20.5 dB (or not 25 frames)")

    # frame 0 again, the fp32 twin on the card
    from swnerf_torch.models import TNeRF
    from swnerf_torch.train.checkpoint import load_tar, tnerf_state_dict

    model = TNeRF(cfg, device=dev, fused=False)
    model.load_state_dict(tnerf_state_dict(load_tar(str(TNERF_CKPT))["network_fn_state_dict"]))
    rays, img = frame_rays(dev, data, "test", 0)
    plain = make_tnerf_eval_pass(cfg, compute_dtype=torch.float32, plain=True)
    out = render_image(model, rays, RenderConfig(n_samples=64, white_bkgd=True), chunk=8192, eval_pass=plain)
    hw3 = (TNERF_SIZE, TNERF_SIZE, 3)
    psnr_plain = calculate_metrics(img.reshape(hw3).cpu().numpy(), out["rgb"].reshape(hw3).cpu().numpy())[0]
    dpsnr = abs(psnr_plain - metrics["psnr"][0])
    print(f"[14 plain fp32] frame 0 PSNR {psnr_plain:.3f} dB, |dPSNR| vs bf16 B4 {dpsnr:.4f} dB")
    if dpsnr > 0.1:
        fail(f"|dPSNR| {dpsnr} > 0.1 dB")
    del out

    stages = tnerf_frame_breakdown(dev, cfg, model, rays)
    total = sum(stages.values())
    print("[14 breakdown] frame 0, device ms by stage: " + ", ".join(
        f"{k} {v:.2f} ({100 * v / total:.1f}%)" for k, v in stages.items()))
    print(f"[14 breakdown] stage sum {total:.2f} ms vs timed frame {per_frame * 1e3:.2f} ms")
    del model
    torch.cuda.empty_cache()
    return counts, unit[0]


def tnerf_frame_breakdown(dev, cfg, model, rays, chunk=32768):
    """Device milliseconds of each stage of the T-NeRF eval pass over one
    frame, chunk by chunk as render_image runs it (after one warm-up)."""
    import torch

    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.sampling import sample_along_rays

    packed = b3.pack_tnerf_params(model.state_dict(), cfg, torch.bfloat16)
    names = ("rays + z + view embedding", "B4", "disp")
    acc = dict.fromkeys(names, 0.0)
    n_all = rays.origins.shape[0]
    for rep in range(2):
        for start in range(0, n_all, chunk):
            tile = rays.slice(start, min(n_all, start + chunk))
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
            ev[0].record()
            o, d, ve, z, dist, t = tnerf_pass_inputs(tile, cfg, sample_along_rays(tile.near, tile.far, 64, 0.0))
            ev[1].record()
            res = b3.render_pass(packed, o, d, ve, z, dist, None, True, t)
            ev[2].record()
            _ = 1.0 / torch.maximum(torch.full_like(res.depth, 1e-10), res.depth / res.acc)
            ev[3].record()
            torch.cuda.synchronize()
            if rep:
                for i, k in enumerate(names):
                    acc[k] += ev[i].elapsed_time(ev[i + 1])
    return acc


def phase15_train(dev, cfg, tmp, data):
    """The training main path through run_tnerf: 1,000 bf16 steps resumed
    from the copy of 800000.tar. Returns its launch counts."""
    import torch

    from swnerf_torch.ops.kernels import launches
    from swnerf_torch.pipelines import run_tnerf
    from swnerf_torch.train.checkpoint import load_tar

    os.environ["SWNERF_MAX_ITERS"] = "801001"
    buf = io.StringIO()
    try:
        launches.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
            res = run_tnerf.main(tnerf_args(tmp, data, "--i_print", "100", "--i_weights", "500"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launches)
    finally:
        os.environ.pop("SWNERF_MAX_ITERS", None)
    out = buf.getvalue()
    exp = tmp / "logs" / "full_tnerf_800k"
    print(f"[15 train] launches {json.dumps(counts, sort_keys=True)} (1000 steps), CLI wall {wall:.2f} s")
    if "Reloading from" not in out or "kernel T-NeRF train step" not in out or min(res["step_ms"]) != 800001:
        fail("the T-NeRF training run did not resume from 800000.tar at 800000 on the kernel step")
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    psnrs = [(r["step"], round(r["psnr"], 3)) for r in recs if "psnr" in r]
    print(f"[15 train] train PSNR at the prints: {psnrs}")
    if len(psnrs) != 10 or min(p for _, p in psnrs) < 19.0:
        fail(f"train PSNR below 19 dB at a print (or not 10 prints): {psnrs}")
    for i in (800500, 801000):
        ck = load_tar(str(exp / f"{i:06d}.tar"))
        steps = {int(e["step"]) for e in ck["optimizer_state_dict"]["state"].values()}
        print(f"[15 train] {i:06d}.tar keys {sorted(ck)} Adam step {steps} "
              f"({len(ck['optimizer_state_dict']['state'])} entries)")
        if set(ck) != {"global_step", "network_fn_state_dict", "optimizer_state_dict"} or steps != {i} \
                or ck["global_step"] != i:
            fail(f"{i:06d}.tar: keys {set(ck)}, Adam steps {steps}")
    if counts.get("render_loss[tnerf,S=64]", 0) != 1000:
        fail(f"the T-NeRF training path launched B4 {counts.get('render_loss[tnerf,S=64]', 0)} times, not 1000")
    quiet = {i: ms for i, ms in res["step_ms"].items() if i % 100 and (i - 1) % 100}
    med = statistics.median(quiet.values())
    print(f"[15 train] ms per step, median of {len(quiet)} steps that neither print nor save (CUDA events): "
          f"{med:.4f} ms (min {min(quiet.values()):.4f}, max {max(quiet.values()):.4f}); "
          f"{500 / med * 1e3:.4g} rays/s, {500 * 64 / med * 1e3:.4g} samples/s")
    stages = tnerf_step_breakdown(dev, cfg, data)
    total = sum(stages.values())
    print("[15 breakdown] one step, device ms by stage: " + ", ".join(
        f"{k} {v:.4f} ({100 * v / total:.1f}%)" for k, v in stages.items()))
    print(f"[15 breakdown] stage sum {total:.3f} ms vs median step {med:.3f} ms")
    return counts


def tnerf_step_breakdown(dev, cfg, data):
    """Device milliseconds of each stage of one kernel T-NeRF step (bf16, the
    CLI's step), CUDA events between stages, after one warm-up step. The
    stages are those of train/fused_step.py::make_fused_tnerf_step and
    pipelines/common.py::make_time_image_step, written out here."""
    import numpy as np
    import torch

    from swnerf_torch.models import TNeRF
    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import render_loss as b1
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.rays import get_rays_at
    from swnerf_torch.ops.sampling import sample_along_rays
    from swnerf_torch.pipelines.common import ImageSampler, Scene
    from swnerf_torch.render.core import RenderConfig, build_rays, make_draws
    from swnerf_torch.train.fused_step import _set_grads
    from swnerf_torch.train.loop import init_train_state

    with open(data / "transforms_train.json") as f:
        meta = json.load(f)
    H = W = TNERF_SIZE
    focal = 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    poses = np.array([fr["transform_matrix"] for fr in meta["frames"]], np.float32)
    n_views = poses.shape[0]
    scene = Scene(images=np.zeros((n_views, 1, 1, 3), np.float32), poses=poses, render_poses=poses, H=H, W=W,
                  focal=focal, K=K, near=2.0, far=6.0, i_train=np.arange(n_views), i_val=np.arange(0),
                  i_test=np.arange(0))
    images = torch.rand((n_views, H, W, 3), device=dev)
    poses_dev = torch.as_tensor(poses[:, :3, :4], device=dev)
    times = torch.linspace(0, 1, n_views, device=dev)
    sampler = ImageSampler(scene, 500, 0, 0.5)
    rcfg = RenderConfig(n_samples=64, perturb=1.0, white_bkgd=True, raw_noise_std=1.0)
    state = init_train_state(TNeRF(cfg, device=dev, fused=False), None, 5e-4, 500)
    g = torch.Generator(device=dev).manual_seed(0)
    names = ("host sampler + pixel upload", "rays + z + draws", "pack weights", "B4 train", "unpack + Adam")
    acc = dict.fromkeys(names, 0.0)
    for rep in range(2):  # the first is the warm-up
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        torch.cuda.synchronize()
        ev[0].record()
        img_i, pixels = sampler.next(1000)
        pixels = torch.as_tensor(pixels, device=dev)
        ev[1].record()
        o, d = get_rays_at(pixels, H, W, K, poses_dev[img_i])
        target = images[img_i][pixels[:, 0], pixels[:, 1]].contiguous()
        r = build_rays(o, d, 2.0, 6.0, times=times[img_i].reshape(1, 1).expand(500, 1).contiguous())
        draws = make_draws(rcfg, 500, g, dev)
        z = sample_along_rays(r.near, r.far, 64, 1.0, t_rand=draws.t_rand).contiguous()
        ve = positional_encoding(r.viewdirs, cfg.nf_views).contiguous()
        ev[2].record()
        state.zero_grad()
        pk = b3.pack_tnerf_params(state.coarse.state_dict(), cfg, torch.bfloat16)
        ev[3].record()
        _, gr = b1.render_loss(pk, r.origins, r.directions, ve, z, b3_dists(z, r.directions),
                               draws.noise0.contiguous(), target, True, 1.0 / 1500, r.times.reshape(-1).contiguous())
        ev[4].record()
        _set_grads(state.coarse, b1.unpack_tnerf_grads(gr, pk))
        state.apply_update()
        ev[5].record()
        torch.cuda.synchronize()
        if rep:
            for i, k in enumerate(names):
                acc[k] = ev[i].elapsed_time(ev[i + 1])
    return acc


def phase16_serve(tmp, data, psnr_before):
    """Test frame 0 rendered from the trained 801000.tar by the serving CLI
    (--testskip 25 keeps test frame 0 only)."""
    from swnerf_torch.pipelines import run_tnerf

    savedir = Path(run_tnerf.main(tnerf_args(tmp, data, "--render_only", "--render_test", "--testskip", "25")))
    metrics = json.loads((savedir / "metrics.json").read_text())
    psnr = unit_range_psnr(metrics["psnr"], data)[0]
    print(f"[16 serve] frame 0 from 801000.tar ({savedir.name}): PSNR {psnr:.3f} dB on data range 1 "
          f"({metrics['psnr'][0]:.3f} dB in metrics.json) SSIM {metrics['ssim'][0]:.4f}; from 800000.tar "
          f"{psnr_before:.3f} dB (delta {psnr - psnr_before:+.3f} dB)")
    if savedir.name != "renderonly_test_801000" or not psnr >= 20.0 or abs(psnr - psnr_before) > 0.5:
        fail(f"frame 0 from 801000.tar: {psnr} dB (< 20 dB or more than 0.5 dB from {psnr_before})")


# ---------------------------------------------------------------- D-NeRF phases


def dnerf_phases(dev, tmp, data):
    """Phases 17-22 on phase 11's scene. Returns the [kernel] rows of B6
    (forward, backward), B3's pts mode and B5."""
    import torch

    from swnerf_torch.models import DirectTemporalNeRF
    from swnerf_torch.pipelines.run_dnerf import _model_config
    from swnerf_torch.train.checkpoint import dnerf_state_dict, load_tar
    from swnerf_torch.utils.config import config_parser_dnerf

    args = config_parser_dnerf().parse_args(["--config", str(DNERF_CONFIG)])
    cfg = _model_config(args, args.netdepth, args.netwidth)  # D=8, W=256, skip 4, multires 10/4
    model = DirectTemporalNeRF(cfg, device=dev)
    model.load_state_dict(dnerf_state_dict(load_tar(str(DNERF_CKPT))["network_fn_state_dict"]))
    model.eval()
    inputs = dnerf_train_inputs(dev, cfg, model.state_dict(), data)
    rows = phase17_b6(dev, cfg, model.state_dict(), inputs)
    rows.update(phase18_pts(dev, cfg, model.state_dict(), inputs, data))
    phase19_step(dev, cfg, model, data)
    del model, inputs
    torch.cuda.empty_cache()
    exp = tmp / "logs" / "full_dnerf_800k"  # the config's expname: the copy is the newest .tar there
    exp.mkdir(parents=True)
    shutil.copy(DNERF_CKPT, exp / "800000.tar")
    serve_counts, psnr5 = phase20_serve(dev, cfg, tmp, data)
    train_counts = phase21_train(dev, cfg, tmp, data)
    phase22_serve(tmp, data, psnr5)
    for k, row in rows.items():
        row["launches"] = serve_counts.get(k, 0) + train_counts.get(k, 0)
        print(f"[18 kernel] {row['name']}: {row['ms']:.3f} ms/launch (plain {row['plain_ms']:.3f} ms), bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']} -> {100 * row['bound_ms'] / row['ms']:.2f}% of the "
              f"bound, {serve_counts.get(k, 0)} launches serving 5 frames, {train_counts.get(k, 0)} in 200 steps")
    return list(rows.values())


def dnerf_args(tmp, data, *extra):
    return ["--config", str(DNERF_CONFIG), "--basedir", str(tmp / "logs"), "--datadir", str(data),
            "--device", "cuda", *extra]


def jitter(w, seed=0):
    """w * (1 + 2^-20 N(0, 1)): a perturbation of the size of the rounding
    that an fp32 dot product of length 256 accumulates (2^-24 sqrt(256))."""
    import torch

    g = torch.Generator(device=w.device).manual_seed(seed)
    return w * (1 + 2.0**-20 * torch.randn(w.shape, generator=g, device=w.device, dtype=w.dtype))


def dnerf_train_inputs(dev, cfg, sd, data):
    """500 seeded pixels of train view 37 at its frame time: the coarse
    points (S=64, jittered), the fine points (S=192, from a B2 pass on the
    fp32 twins' coarse weights), their dx by the fp32 B6 twin, noise std 1,
    the view embedding and the target colours."""
    import torch

    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.kernels import sample_pdf as b2
    from swnerf_torch.ops.kernels import time_net as b6
    from swnerf_torch.ops.sampling import merge_z_vals, sample_along_rays
    from swnerf_torch.render.fused_eval import canonical_params

    n = 500
    rays, img = frame_rays(dev, data, "train", 37)
    g = torch.Generator(device=dev).manual_seed(0)
    sel = torch.randint(0, img.shape[0], (n,), generator=g, device=dev)
    r = type(rays)(*(x[sel] for x in rays))
    o, d = r.origins, r.directions
    t = r.times.reshape(-1).contiguous()
    ve = positional_encoding(r.viewdirs, cfg.nf_views).contiguous()
    tn32 = b6.pack_time_params(sd, cfg, torch.float32)
    canon32 = b3.pack_params(canonical_params(sd), cfg, torch.float32)
    z64 = sample_along_rays(r.near, r.far, 64, 1.0, generator=g).contiguous()
    noise64 = torch.randn(z64.shape, generator=g, device=dev)
    pts_c = (o[:, None, :] + d[:, None, :] * z64[..., None]).contiguous()
    dx_c = b6.time_net_plain(tn32, pts_c, t)
    w64 = b3.render_pass_plain(canon32, None, None, ve, z64, b3_dists(z64, d), noise64, True, None,
                               (pts_c + dx_c).contiguous()).weights
    u = torch.rand((n, 128), generator=g, device=dev)
    zf = merge_z_vals(z64, b2.sample_pdf((0.5 * (z64[:, 1:] + z64[:, :-1])).contiguous(), w64[:, 1:-1], u))
    zf = zf.contiguous()
    noise192 = torch.randn(zf.shape, generator=g, device=dev)
    pts_f = (o[:, None, :] + d[:, None, :] * zf[..., None]).contiguous()
    return {
        "times": t, "ve": ve, "d": d, "target": img[sel].contiguous(),
        64: (pts_c, dx_c, z64, noise64), 192: (pts_f, b6.time_net_plain(tn32, pts_f, t), zf, noise192),
    }


def phase17_b6(dev, cfg, sd, inputs):
    """B6 against its twin on the coarse and fine points; its times (forward
    at the serving chunk's fine shape, backward at the TV pair's 2 x 500 x
    192 rows). Returns its two [kernel] rows."""
    import dataclasses

    import torch

    from swnerf_torch.ops.kernels import time_net as b6

    t = inputs["times"]
    g = torch.Generator(device=dev).manual_seed(4)
    err16 = 0.0
    for S in (64, 192):
        pts = inputs[S][0]
        cot = torch.randn(pts.shape, generator=g, device=dev)
        p32 = b6.pack_time_params(sd, cfg, torch.float32)
        dx, gk = b6.time_net_fwd_bwd(p32, pts, t, cot)
        _, gk2 = b6.time_net_fwd_bwd(p32, pts, t, cot)
        ref = b6.time_net_plain(p32, pts, t)
        gr = b6.time_net_plain_bwd(p32, pts, t, cot)
        p64 = dataclasses.replace(p32, weights=p32.weights.double())
        g64 = b6.time_net_plain_bwd(p64, pts.double(), t.double(), cot.double())
        g64p = b6.time_net_plain_bwd(dataclasses.replace(p64, weights=jitter(p64.weights)), pts.double(),
                                     t.double(), cot.double())
        torch.cuda.synchronize()
        ddx = (dx - ref).abs().max().item()
        same = torch.equal(gk[0], gk2[0]) and torch.equal(gk[1], gk2[1])
        print(f"[17 B6 fp32 S={S}] rows {pts.shape[0] * S}: max|ddx|={ddx:.3e} (max|dx| "
              f"{ref.abs().max().item():.3e}) repeat bit-equal={same}")
        if ddx > 1e-5 or not same:
            fail(f"B6 fp32 S={S}: max |ddx| {ddx} > 1e-5 or repeats differ")
        check_fp32_grads(f"17 B6 fp32 S={S}", *(b6.unpack_time_grads(x, p32) for x in (gk, gr, g64, g64p)))
        p16 = b6.pack_time_params(sd, cfg, torch.bfloat16)
        dx, gk = b6.time_net_fwd_bwd(p16, pts, t, cot)
        _, gk2 = b6.time_net_fwd_bwd(p16, pts, t, cot)
        ref, gr = b6.time_net_plain(p16, pts, t), b6.time_net_plain_bwd(p16, pts, t, cot)
        torch.cuda.synchronize()
        ddx = (dx - ref).abs().max().item()
        rel = rel_l2(b6.unpack_time_grads(gk, p16), b6.unpack_time_grads(gr, p16))
        same = torch.equal(gk[0], gk2[0]) and torch.equal(gk[1], gk2[1])
        print(f"[17 B6 bf16 S={S}] max|ddx|={ddx:.3e} grads max rel L2={max(rel.values()):.3e} "
              f"({max(rel, key=rel.get)}) repeat bit-equal={same}")
        if ddx > 1e-2 or max(rel.values()) > 1e-2 or not same:
            fail(f"B6 bf16 S={S}: max |ddx| > 1e-2, gradient rel L2 > 1e-2 or repeats differ")
        err16 = max(err16, ddx)
        del gk, gk2, gr, g64, g64p
    torch.cuda.empty_cache()

    # the backward at the TV pair's shape: the fine points at t and at a neighbour time
    p16 = b6.pack_time_params(sd, cfg, torch.bfloat16)
    pts = inputs[192][0]
    pair = torch.cat([pts, pts]).contiguous()
    t2 = torch.cat([t, torch.full_like(t, 0.41)]).contiguous()
    m = pair.shape[0] * pair.shape[1]
    cot = torch.randn((m, 3), generator=g, device=dev)
    scratch = b6._scratch(p16, m, dev)
    b6._launch_fwd(p16, pair, t2, scratch)
    bwd_ms = cuda_ms(lambda: b6._launch_bwd(p16, m, cot, scratch), 10)
    bwd_plain = cuda_ms(lambda: b6.time_net_plain_bwd(p16, pair, t2, cot), 2)
    bwd_row = entry(
        "time_net[bwd]", "swnerf_torch/csrc/time_net.cu", "swnerf_tpu/ops/pallas/raymarch.py:480", 0, err16,
        bwd_ms, bwd_plain, 4 * (3 * m + 3 * m + pair.shape[0]) + 2 * p16.weights.numel() + 4 * p16.weights.numel(),
        2 * p16.bwd_macs_per_row * m, "bf16",
    )
    report_sweep("17", "time_net[bwd] bf16, the TV pair", lambda: b6._launch_bwd(p16, m, cot, scratch), bwd_ms,
                 bwd_row["bound_ms"], m, sweep_products(p16.W, p16.D, p16.skip, p16.cin_pad), dev)
    del scratch
    torch.cuda.empty_cache()
    return {"time_net[bwd]": bwd_row}


def phase18_pts(dev, cfg, sd, inputs, data):
    """B3's pts mode and B5 against their twins on pts + dx of the phase 17
    rays; then B6 and B3's pts mode at the serving chunk's shapes. Returns
    the [kernel] rows of B6's forward, B3's pts mode (S=64, 192) and B5."""
    import dataclasses

    import torch

    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import render_loss as b1
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.kernels import sample_pdf as b2
    from swnerf_torch.ops.kernels import time_net as b6
    from swnerf_torch.ops.sampling import merge_z_vals, sample_along_rays
    from swnerf_torch.render.fused_eval import canonical_params

    n, scale = 500, 1.0 / 1500
    ve, d, target = inputs["ve"], inputs["d"], inputs["target"]
    canon = canonical_params(sd)
    fwd_err, rows = {}, {}
    for S in (64, 192):
        pts, dx, z, noise = inputs[S]
        warped = (pts + dx).contiguous()
        dist = b3_dists(z, d)
        for dtype in (torch.float32, torch.bfloat16):
            packed = b3.pack_params(canon, cfg, dtype)
            got = b3.render_pass(packed, None, None, ve, z, dist, noise, True, None, warped)
            ref = b3.render_pass_plain(packed, None, None, ve, z, dist, noise, True, None, warped)
            torch.cuda.synchronize()
            drgb = (got.rgb - ref.rgb).abs()
            dacc = (got.acc - ref.acc).abs().max().item()
            depth_ok = torch.allclose(got.depth, ref.depth, rtol=1e-4, atol=1e-5)
            tag = "fp32" if dtype == torch.float32 else "bf16"
            print(f"[18 B3 pts {tag} S={S}] max|drgb|={drgb.max().item():.3e} mean|drgb|={drgb.mean().item():.3e} "
                  f"max|dacc|={dacc:.3e} depth_within_rtol={depth_ok}")
            if dtype == torch.float32:
                if drgb.max().item() > 1e-4 or dacc > 1e-4 or not depth_ok:
                    fail(f"B3 pts fp32 S={S} outside atol 1e-4 (rgb, acc) / rtol 1e-4 (depth)")
            else:
                fwd_err[S] = drgb.max().item()
                if drgb.max().item() > 1e-2 or drgb.mean().item() > 1e-3:
                    fail(f"B3 pts bf16 S={S}: max |drgb| > 1e-2 or mean > 1e-3")

        args = (ve, z, dist, noise, target)
        p32 = b3.pack_params(canon, cfg, torch.float32)
        got, gk, dk = b1.render_loss_pts(p32, warped, *args, True, scale)
        ref, gr, dr = b1.render_loss_pts_plain(p32, warped, *args, True, scale)
        p64 = dataclasses.replace(p32, weights=p32.weights.double())
        a64 = tuple(x.double() for x in args)
        _, g64, d64 = b1.render_loss_pts_plain(p64, warped.double(), *a64, True, scale)
        _, g64p, d64p = b1.render_loss_pts_plain(dataclasses.replace(p64, weights=jitter(p64.weights)),
                                                 warped.double(), *a64, True, scale)
        _, gk2, dk2 = b1.render_loss_pts(p32, warped, *args, True, scale)
        torch.cuda.synchronize()
        drgb = (got.rgb - ref.rgb).abs().max().item()
        sq_ok = torch.allclose(got.sqerr, ref.sqerr, rtol=1e-4, atol=1e-7)
        depth_ok = torch.allclose(got.depth, ref.depth, rtol=1e-4, atol=1e-5)
        same = torch.equal(gk[0], gk2[0]) and torch.equal(gk[1], gk2[1]) and torch.equal(dk, dk2)
        print(f"[18 B5 fp32 S={S}] max|drgb|={drgb:.3e} max|dsqerr|={(got.sqerr - ref.sqerr).abs().max().item():.3e} "
              f"sqerr_within_rtol={sq_ok} depth_within_rtol={depth_ok} max|ddpts|={(dk - dr).abs().max().item():.3e} "
              f"(max|dpts| {dr.abs().max().item():.3e}) repeat bit-equal={same}")
        if drgb > 1e-4 or not sq_ok or not depth_ok or not same:
            fail(f"B5 fp32 S={S}: outputs outside rgb 1e-4, sqerr/depth rtol 1e-4, or repeats differ")
        check_fp32_grads(f"18 B5 fp32 S={S}", *(dict(b1.unpack_grads(gg, pp), dpts=dd) for gg, dd, pp in (
            (gk, dk, p32), (gr, dr, p32), (g64, d64, p64), (g64p, d64p, p64))))
        del g64, g64p, gr, gk2
        p16 = b3.pack_params(canon, cfg, torch.bfloat16)
        got, gk, dk = b1.render_loss_pts(p16, warped, *args, True, scale)
        ref, gr, dr = b1.render_loss_pts_plain(p16, warped, *args, True, scale)
        _, gk2, dk2 = b1.render_loss_pts(p16, warped, *args, True, scale)
        torch.cuda.synchronize()
        diff = (got.rgb - ref.rgb).abs()
        rel = rel_l2(dict(b1.unpack_grads(gk, p16), dpts=dk), dict(b1.unpack_grads(gr, p16), dpts=dr))
        same = torch.equal(gk[0], gk2[0]) and torch.equal(gk[1], gk2[1]) and torch.equal(dk, dk2)
        print(f"[18 B5 bf16 S={S}] max|drgb|={diff.max().item():.3e} mean|drgb|={diff.mean().item():.3e} "
              f"grads and dpts max rel L2={max(rel.values()):.3e} ({max(rel, key=rel.get)}) repeat bit-equal={same}")
        if diff.max().item() > 1e-2 or diff.mean().item() > 1e-3 or max(rel.values()) > 1e-2 or not same:
            fail(f"B5 bf16 S={S}: rgb max > 1e-2, mean > 1e-3, gradient rel L2 > 1e-2 or repeats differ")
        if S == 192:  # the training main path's B5 launch: shared model, fine pass only
            nbytes = (4 * (3 * warped.numel() // 3 * 3 + ve.numel() + 3 * z.numel() + 3 * n)
                      + 2 * p16.weights.numel() + 4 * p16.biases.numel()
                      + 4 * (4 * n + z.numel() + warped.numel()) + 4 * (p16.weights.numel() + p16.biases.numel()))
            rows["render_loss[pts,S=192]"] = entry(
                "render_loss[pts,S=192]", "swnerf_torch/csrc/render_loss.cu",
                "swnerf_tpu/ops/pallas/render_fused.py:276", 0, diff.max().item(),
                cuda_ms(lambda: b1.render_loss_pts(p16, warped, *args, True, scale), 20),
                cuda_ms(lambda: b1.render_loss_pts_plain(p16, warped, *args, True, scale), 5),
                nbytes, 2 * b1.pts_train_macs_per_sample(p16) * z.numel(), "bf16",
            )
        del gk, gk2, gr, got, ref
        torch.cuda.empty_cache()

    # the serving path's chunk: the first 32,768 rays of test frame 5 at its time, bf16
    rays, _ = frame_rays(dev, data, "test", 5)
    chunk = rays.slice(0, 32768)
    o, d = chunk.origins.contiguous(), chunk.directions.contiguous()
    t = chunk.times.reshape(-1).contiguous()
    ve = positional_encoding(chunk.viewdirs, cfg.nf_views).contiguous()
    tn16, c16 = b6.pack_time_params(sd, cfg), b3.pack_params(canon, cfg)
    z = sample_along_rays(chunk.near, chunk.far, 64, 0.0).contiguous()
    nc = z.shape[0]
    serve = {}
    for S in (64, 192):
        pts = (o[:, None, :] + d[:, None, :] * z[..., None]).contiguous()
        dx = b6.time_net(tn16, pts, t)
        ddx = (dx - b6.time_net_plain(tn16, pts, t)).abs().max().item()
        warped = (pts + dx).contiguous()
        dist = b3_dists(z, d)
        got = b3.render_pass(c16, None, None, ve, z, dist, None, True, None, warped)
        ref = b3.render_pass_plain(c16, None, None, ve, z, dist, None, True, None, warped)
        drgb = (got.rgb - ref.rgb).abs()
        print(f"[18 check] time_net bf16 rows {pts.shape[0] * S}: max|ddx|={ddx:.3e}; render_pass[pts,S={S}] bf16 "
              f"N={nc}: max|drgb|={drgb.max().item():.3e} mean|drgb|={drgb.mean().item():.3e}")
        if ddx > 1e-2 or drgb.max().item() > 1e-2 or drgb.mean().item() > 1e-3:
            fail(f"B6 / B3 pts bf16 S={S} at the serving shape: max |ddx| > 1e-2, max |drgb| > 1e-2 or mean > 1e-3")
        serve[S] = (pts, warped, z, dist, max(fwd_err[S], drgb.max().item()), ddx)
        if S == 64:
            u = torch.linspace(0.0, 1.0, 128, device=dev).expand(nc, 128)
            zs = b2.sample_pdf((0.5 * (z[:, 1:] + z[:, :-1])).contiguous(), got.weights[:, 1:-1], u)
            z = merge_z_vals(z, zs).contiguous()
        del got, ref
    for S, (pts, warped, zz, dist, err, _) in serve.items():
        rows[f"render_pass[pts,S={S}]"] = entry(
            f"render_pass[pts,S={S}]", "swnerf_torch/csrc/render_pass.cu", "swnerf_tpu/ops/pallas/render_fused.py:276",
            0, err, cuda_ms(lambda: b3.render_pass(c16, None, None, ve, zz, dist, None, True, None, warped), 3),
            cuda_ms(lambda: b3.render_pass_plain(c16, None, None, ve, zz, dist, None, True, None, warped), 2),
            4 * (warped.numel() + ve.numel() + 2 * zz.numel() + 5 * nc + zz.numel()) + 2 * c16.weights.numel(),
            2 * c16.macs_per_sample * zz.numel(), "bf16",
        )
        torch.cuda.empty_cache()
    pts, _, _, _, _, ddx = serve[192]
    _, head = tc_shares("time_net", lambda: b6.time_net(tn16, pts, t))
    TC_SUMMARY["time_net at the serving chunk's fine rows"] = f"head {100 * head:.2f}% of the blocks' cycles"
    pts64, warped64, z64, dist64 = serve[64][:4]
    comp, head = tc_shares("render_pass", lambda: b3.render_pass(c16, None, None, ve, z64, dist64, None, True, None,
                                                                 warped64))
    TC_SUMMARY["render_pass[pts,S=64] at the serving chunk"] = (
        f"composite busy {100 * comp:.2f}% (overlapped with the products), alpha + rgb heads {100 * head:.2f}% "
            "of the blocks' cycles")
    del pts64, warped64, z64, dist64
    m = pts.shape[0] * pts.shape[1]
    rows["time_net"] = entry(
        "time_net", "swnerf_torch/csrc/time_net.cu", "swnerf_tpu/ops/pallas/raymarch.py:470", 0, ddx,
        cuda_ms(lambda: b6.time_net(tn16, pts, t), 3), cuda_ms(lambda: b6.time_net_plain(tn16, pts, t), 2),
        4 * (3 * m + nc + 3 * m) + 2 * tn16.weights.numel(), 2 * tn16.macs_per_row * m, "bf16",
    )
    del serve
    torch.cuda.empty_cache()
    return rows


def phase19_step(dev, cfg, model, data):
    """The kernel D-NeRF step (B6, B3's pts mode, B5, B2; shared model, TV
    on, noise std 1) against the eager autograd step from the same state and
    draws; the eager step in float64 on the CPU (and once more on weights
    perturbed at fp32's size) is the reference of the fallbacks."""
    import torch

    from swnerf_torch.models import DirectTemporalNeRF
    from swnerf_torch.ops.kernels import launches
    from swnerf_torch.render.core import Draws, Rays, RenderConfig, make_draws
    from swnerf_torch.train.fused_step import make_fused_dnerf_step
    from swnerf_torch.train.loop import init_train_state, make_dnerf_train_step

    rays, img = frame_rays(dev, data, "train", 61)
    g = torch.Generator(device=dev).manual_seed(2)
    sel = torch.randint(0, img.shape[0], (500,), generator=g, device=dev)
    rays = Rays(*(x[sel] for x in rays))
    target = img[sel].contiguous()
    rcfg = RenderConfig(n_samples=64, n_importance=128, perturb=1.0, white_bkgd=True, raw_noise_std=1.0,
                        coarse_contributes=False)
    draws = make_draws(rcfg, 500, torch.Generator(device=dev).manual_seed(3), dev)
    t_n, tv_w = 0.41, 1e-4  # a neighbour time between frames; the config's TV weight

    def fresh(device=dev, dtype=torch.float32, perturb=False):  # the plain route: the eager step is the reference
        m = DirectTemporalNeRF(cfg, device=device, fused=False)
        m.load_state_dict(model.state_dict())
        m = m.to(dtype)
        if perturb:
            with torch.no_grad():
                for p in m.parameters():
                    p.copy_(jitter(p))
        return init_train_state(m, None, 5e-4, 500, step=800000)

    def grads(st):
        return {k: p.grad.detach().clone() for k, p in st.coarse.named_parameters()}

    def eager(st, device=dev, dtype=torch.float32):
        cast = lambda x: None if x is None else x.to(device=device, dtype=dtype)  # noqa: E731
        return make_dnerf_train_step(rcfg, True, tv_w)(st, Rays(*(cast(x) for x in rays)), cast(target), t_n,
                                                       draws=Draws(*(cast(x) for x in draws)))

    # the float64 references run on the CPU: B2 (which the eager step reaches on the card) takes fp32
    sk, se = fresh(), fresh()
    s64, s64p = fresh("cpu", torch.float64), fresh("cpu", torch.float64, True)
    launches.clear()
    mk = make_fused_dnerf_step(cfg, rcfg, add_tv_loss=True, tv_loss_weight=tv_w, compute_dtype=torch.float32)(
        sk, rays, target, t_n, draws=draws)
    counts = dict(launches)
    me, m64, m64p = eager(se), eager(s64, "cpu", torch.float64), eager(s64p, "cpu", torch.float64)
    torch.cuda.synchronize()
    lk, le, l64, l64p = (m["total_loss"].item() for m in (mk, me, m64, m64p))
    dloss = abs(lk - le) / le
    print(f"[19 step fp32] launches {json.dumps(counts, sort_keys=True)}; total_loss kernel {lk:.8f} eager {le:.8f} "
          f"rel {dloss:.3e}; float64 eager {l64:.8f} (perturbed {l64p:.8f}); tv kernel {mk['tv'].item():.4e} eager "
          f"{me['tv'].item():.4e}; psnr {mk['psnr'].item():.4f} vs {me['psnr'].item():.4f}")
    if dloss > 1e-5 and abs(lk - l64) > 2 * max(abs(le - l64), abs(l64p - l64)):
        fail(f"kernel D-NeRF step loss rel {dloss} > 1e-5, and further from the float64 step than fp32 moves it")
    check_fp32_grads("19 step fp32", grads(sk), grads(se), grads(s64), grads(s64p))
    del sk, s64, s64p
    sb = fresh()
    mb = make_fused_dnerf_step(cfg, rcfg, add_tv_loss=True, tv_loss_weight=tv_w, compute_dtype=torch.bfloat16)(
        sb, rays, target, t_n, draws=draws)
    dl16 = abs(mb["total_loss"].item() - le) / le
    print(f"[19 step bf16] total_loss kernel {mb['total_loss'].item():.8f} vs fp32 eager: rel {dl16:.3e}")
    if dl16 > 1e-2:
        fail(f"bf16 kernel D-NeRF step loss rel {dl16} > 1e-2")
    del se, sb
    torch.cuda.empty_cache()


def dnerf_unit_psnr(psnrs, data, frames):
    """unit_range_psnr for the test frames ``frames`` (``--testskip`` keeps a
    stride of the test split)."""
    import math

    out = []
    for p, i in zip(psnrs, frames):
        img = gt_image(data, "test", i)[2]
        out.append(p - 20.0 * math.log10(float(img.max() - img.min())))
    return out


def phase20_serve(dev, cfg, tmp, data):
    """The D-NeRF serving main path through run_dnerf: test frames 0, 5,
    10, 15 and 20 at their times. Returns its launch counts and frame 5's
    PSNR (data range 1)."""
    import torch

    from swnerf_torch.models import DirectTemporalNeRF
    from swnerf_torch.ops.kernels import launches
    from swnerf_torch.pipelines import run_dnerf
    from swnerf_torch.render.core import RenderConfig, render_image
    from swnerf_torch.render.fused_eval import make_dnerf_eval_pass
    from swnerf_torch.train.checkpoint import dnerf_state_dict, load_tar
    from swnerf_torch.utils.metrics import calculate_metrics

    launches.clear()
    t0 = time.perf_counter()
    savedir = Path(run_dnerf.main(dnerf_args(tmp, data, "--render_only", "--render_test", "--testskip", "5")))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launches)
    metrics = json.loads((savedir / "metrics.json").read_text())
    print(f"[20 main] launches {json.dumps(counts, sort_keys=True)} (5 frames), CLI wall {wall:.2f} s")
    for key in ("time_net", "render_pass[pts,S=64]", "render_pass[pts,S=192]", "sample_pdf"):
        if counts.get(key, 0) <= 0:
            fail(f"the D-NeRF serving path launched no {key}")
    secs = metrics["seconds_per_frame"]
    per_frame = sum(secs[1:]) / len(secs[1:])  # frame 0 is the warm-up
    n_rays = TNERF_SIZE**2
    print(f"[20 main] seconds per frame {[round(x, 4) for x in secs]}")
    print(f"[20 main] frames 5-20: {per_frame * 1e3:.2f} ms/frame, {n_rays / per_frame:.4g} rays/s, "
          f"{n_rays * (64 + 192) / per_frame:.4g} samples/s (canonical samples)")
    TC_SUMMARY["D-NeRF serving (phase 20)"] = f"{per_frame * 1e3:.2f} ms per frame"
    ref = json.loads(DNERF_RESULT.read_text())["test_frames"]
    unit = dnerf_unit_psnr(metrics["psnr"], data, DNERF_FRAMES)
    for i, p, u, q in zip(DNERF_FRAMES, metrics["psnr"], unit, metrics["ssim"]):
        print(f"[20 main] test frame {i}: PSNR {p:.3f} dB (data range 1: {u:.3f} dB; the reference {ref[i]:.3f}, "
              f"delta {u - ref[i]:+.3f}) SSIM {q:.4f}")
    print(f"[20 main] mean PSNR (data range 1) {sum(unit) / len(unit):.3f} dB over frames {DNERF_FRAMES}; the "
          f"reference's mean over them {sum(ref[i] for i in DNERF_FRAMES) / 5:.3f} dB")

    model = DirectTemporalNeRF(cfg, device=dev)
    model.load_state_dict(dnerf_state_dict(load_tar(str(DNERF_CKPT))["network_fn_state_dict"]))
    model.eval()
    # The reference's per-frame values were taken at its evaluator's own sample counts
    # (benchmarks/parity_vs_torch.py::eval_ckpt, PARITY_SAMPLES = 32: 32 + 32): the like-for-like
    # render, through the same bf16 eval pass, is held within 0.5 dB of them; the CLI's 64 + 128
    # samples must not fall more than 0.5 dB below them.
    ep16 = make_dnerf_eval_pass(cfg)
    at32 = []
    for i in DNERF_FRAMES:
        rays, img = frame_rays(dev, data, "test", i)
        out = render_image(model, rays, RenderConfig(n_samples=32, n_importance=32, white_bkgd=True), chunk=32768,
                           eval_pass=ep16)
        hw3 = (TNERF_SIZE, TNERF_SIZE, 3)
        at32.append(calculate_metrics(img.reshape(hw3).cpu().numpy(), out["rgb"].reshape(hw3).cpu().numpy())[0])
    at32 = dnerf_unit_psnr(at32, data, DNERF_FRAMES)
    print(f"[20 main] at 32 + 32 samples (the reference evaluator's), data range 1: "
          f"{[round(x, 3) for x in at32]} vs the reference {[round(ref[i], 3) for i in DNERF_FRAMES]} "
          f"(deltas {[round(x - ref[i], 3) for x, i in zip(at32, DNERF_FRAMES)]})")
    bad = [i for i, u, a in zip(DNERF_FRAMES, unit, at32) if not (abs(a - ref[i]) <= 0.5 and u >= ref[i] - 0.5)]
    if len(unit) != 5 or bad:
        fail(f"test frames {bad}: at 32 + 32 samples more than 0.5 dB from the reference's PSNR, or at 64 + 128 "
             f"more than 0.5 dB below it")

    # frame 5 again, the fp32 twins on the card
    rays, img = frame_rays(dev, data, "test", 5)
    plain = make_dnerf_eval_pass(cfg, compute_dtype=torch.float32, plain=True)
    out = render_image(model, rays, RenderConfig(n_samples=64, n_importance=128, white_bkgd=True), chunk=8192,
                       eval_pass=plain)
    hw3 = (TNERF_SIZE, TNERF_SIZE, 3)
    psnr_plain = calculate_metrics(img.reshape(hw3).cpu().numpy(), out["rgb"].reshape(hw3).cpu().numpy())[0]
    dpsnr = abs(psnr_plain - metrics["psnr"][1])
    print(f"[20 plain fp32] test frame 5 PSNR {psnr_plain:.3f} dB, |dPSNR| vs the bf16 kernels {dpsnr:.4f} dB")
    if dpsnr > 0.1:
        fail(f"|dPSNR| {dpsnr} > 0.1 dB")
    del out
    torch.cuda.empty_cache()
    stages = dnerf_frame_breakdown(dev, cfg, model, rays)
    total = sum(stages.values())
    print("[20 breakdown] test frame 5, device ms by stage: " + ", ".join(
        f"{k} {v:.2f} ({100 * v / total:.1f}%)" for k, v in stages.items()))
    print(f"[20 breakdown] stage sum {total:.2f} ms vs timed frame {per_frame * 1e3:.2f} ms")
    del model
    torch.cuda.empty_cache()
    return counts, unit[1]


def dnerf_frame_breakdown(dev, cfg, model, rays, chunk=32768):
    """Device milliseconds of each stage of the D-NeRF eval pass
    (render/fused_eval.py::DNeRFEvalPass, written out) over one frame, chunk
    by chunk as render_image runs it, after one warm-up."""
    import torch

    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.kernels import sample_pdf as b2
    from swnerf_torch.ops.kernels import time_net as b6
    from swnerf_torch.ops.sampling import merge_z_vals, sample_along_rays
    from swnerf_torch.render.fused_eval import canonical_params

    sd = model.state_dict()
    canon, tnet = b3.pack_params(canonical_params(sd), cfg), b6.pack_time_params(sd, cfg)
    names = ("rays + z + view embedding", "coarse B6", "coarse mask + warp", "coarse B3 pts", "B2", "sort merge",
             "fine B6", "fine mask + warp", "fine B3 pts", "disp")
    acc = dict.fromkeys(names, 0.0)
    n_all = rays.origins.shape[0]
    for rep in range(2):
        for start in range(0, n_all, chunk):
            tile = rays.slice(start, min(n_all, start + chunk))
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
            ev[0].record()
            o, d = tile.origins.contiguous(), tile.directions.contiguous()
            ve = positional_encoding(tile.viewdirs, cfg.nf_views).contiguous()
            t = tile.times.reshape(-1).contiguous()
            z = sample_along_rays(tile.near, tile.far, 64, 0.0).contiguous()
            ev[1].record()

            def one(zz, k):  # B6, the t == 0 mask and the warp, B3's pts mode; events k, k + 1, k + 2
                pts = (o[:, None, :] + d[:, None, :] * zz[..., None]).contiguous()
                dx = b6.time_net(tnet, pts, t)
                ev[k].record()
                warped = (pts + torch.where((t == 0.0)[:, None, None], torch.zeros_like(dx), dx)).contiguous()
                ev[k + 1].record()
                res = b3.render_pass(canon, None, None, ve, zz, b3_dists(zz, d), None, True, None, warped)
                ev[k + 2].record()
                return res

            res = one(z, 2)
            n = z.shape[0]
            u = torch.linspace(0.0, 1.0, 128, device=dev).expand(n, 128)
            zs = b2.sample_pdf((0.5 * (z[:, 1:] + z[:, :-1])).contiguous(), res.weights[:, 1:-1], u)
            ev[5].record()
            zf = merge_z_vals(z, zs).contiguous()
            ev[6].record()
            res = one(zf, 7)
            _ = 1.0 / torch.maximum(torch.full_like(res.depth, 1e-10), res.depth / res.acc)
            ev[10].record()
            torch.cuda.synchronize()
            if rep:
                for i, k in enumerate(names):
                    acc[k] += ev[i].elapsed_time(ev[i + 1])
    return acc


def phase21_train(dev, cfg, tmp, data):
    """The D-NeRF training main path through run_dnerf: 200 bf16 steps
    resumed from the copy of 800000.tar with the config's flags. Returns its
    launch counts."""
    import torch

    from swnerf_torch.ops.kernels import launches
    from swnerf_torch.pipelines import run_dnerf
    from swnerf_torch.train.checkpoint import load_tar

    os.environ["SWNERF_MAX_ITERS"] = "800201"
    buf = io.StringIO()
    try:
        launches.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
            res = run_dnerf.main(dnerf_args(tmp, data, "--i_print", "50", "--i_weights", "100"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launches)
    finally:
        os.environ.pop("SWNERF_MAX_ITERS", None)
    out = buf.getvalue()
    exp = tmp / "logs" / "full_dnerf_800k"
    print(f"[21 train] launches {json.dumps(counts, sort_keys=True)} (200 steps), CLI wall {wall:.2f} s")
    if "Reloading from" not in out or "kernel D-NeRF train step" not in out or min(res["step_ms"]) != 800001:
        fail("the D-NeRF training run did not resume from 800000.tar at 800000 on the kernel step")
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    psnrs = [(r["step"], round(r["psnr"], 3), r["tv"]) for r in recs if "psnr" in r]
    print(f"[21 train] (step, train PSNR, TV term) at the prints: {psnrs}")
    if len(psnrs) != 4 or min(p for _, p, _ in psnrs) < 34.0:
        fail(f"train PSNR below 34 dB at a print (or not 4 prints): {psnrs}")
    for i in (800100, 800200):
        ck = load_tar(str(exp / f"{i:06d}.tar"))
        steps = {int(e["step"]) for e in ck["optimizer_state_dict"]["state"].values()}
        print(f"[21 train] {i:06d}.tar keys {sorted(ck)} Adam step {steps} "
              f"({len(ck['optimizer_state_dict']['state'])} entries)")
        if set(ck) != {"global_step", "network_fn_state_dict", "optimizer_state_dict"} or steps != {i} \
                or ck["global_step"] != i:
            fail(f"{i:06d}.tar: keys {set(ck)}, Adam steps {steps}")
    want = {"render_loss[pts,S=192]": 200, "time_net[bwd]": 200, "render_pass[pts,S=64]": 200, "time_net": 400,
            "sample_pdf": 200}
    if any(counts.get(k, 0) != v for k, v in want.items()):
        fail(f"the D-NeRF training path's launches {counts} are not {want}")
    quiet = {i: ms for i, ms in res["step_ms"].items() if i % 50 and (i - 1) % 50}
    med = statistics.median(quiet.values())
    print(f"[21 train] ms per step, median of {len(quiet)} steps that neither print nor save (CUDA events): "
          f"{med:.3f} ms (min {min(quiet.values()):.3f}, max {max(quiet.values()):.3f}); "
          f"{500 / med * 1e3:.4g} rays/s, {500 * (64 + 192) / med * 1e3:.4g} samples/s (canonical samples)")
    stages = dnerf_step_breakdown(dev, cfg, data)
    total = sum(stages.values())
    print("[21 breakdown] one step, device ms by stage: " + ", ".join(
        f"{k} {v:.3f} ({100 * v / total:.1f}%)" for k, v in stages.items()))
    print(f"[21 breakdown] stage sum {total:.2f} ms vs median step {med:.2f} ms")
    from swnerf_torch.models import DirectTemporalNeRF
    from swnerf_torch.ops.kernels import time_net as b6

    p6 = b6.pack_time_params(DirectTemporalNeRF(cfg, device=dev).state_dict(), cfg)
    bwd = [k for k in stages if k.startswith("backward")]
    print(f"[21 breakdown] {bwd[0]} {stages[bwd[0]]:.3f} ms; B6's backward over the TV pair's 2 x 500 x 192 rows "
          f"at its bound: {2 * p6.bwd_macs_per_row * 192000 / PEAK_FLOPS['bf16'] * 1e3:.4f} ms")
    return counts


def dnerf_step_breakdown(dev, cfg, data):
    """Device milliseconds of each stage of one kernel D-NeRF step (bf16,
    the CLI's step: train/fused_step.py::make_fused_dnerf_step for the shared
    model with the TV loss, written out), CUDA events between stages, after
    one warm-up step."""
    import dataclasses

    import torch

    from swnerf_torch.models import DirectTemporalNeRF
    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import render_loss as b1
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.kernels import time_net as b6
    from swnerf_torch.ops.sampling import sample_along_rays, sample_pdf_merge
    from swnerf_torch.render.core import RenderConfig, make_draws
    from swnerf_torch.render.fused_eval import canonical_params
    from swnerf_torch.train.checkpoint import dnerf_state_dict, load_tar
    from swnerf_torch.train.loop import init_train_state

    rays, img = frame_rays(dev, data, "train", 37)
    model = DirectTemporalNeRF(cfg, device=dev)
    model.load_state_dict(dnerf_state_dict(load_tar(str(DNERF_CKPT))["network_fn_state_dict"]))
    state = init_train_state(model, None, 5e-4, 500, step=800000)
    rcfg = RenderConfig(n_samples=64, n_importance=128, perturb=1.0, white_bkgd=True, raw_noise_std=1.0,
                        coarse_contributes=False)
    g = torch.Generator(device=dev).manual_seed(0)
    names = ("pixels + rays", "z + draws + view embedding", "pack (autograd)", "coarse B6", "coarse B3 pts",
             "B2 + sort", "B6 pair (train)", "B5", "TV + loss", "backward (B6 bwd, packing)", "Adam")
    acc = dict.fromkeys(names, 0.0)
    bf = torch.bfloat16
    for rep in range(2):  # the first is the warm-up
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        torch.cuda.synchronize()
        ev[0].record()
        sel = torch.randint(0, img.shape[0], (500,), generator=g, device=dev)
        r = type(rays)(*(x[sel] for x in rays))
        target = img[sel].contiguous()
        o, d = r.origins, r.directions
        t = r.times.reshape(-1).contiguous()
        ev[1].record()
        draws = make_draws(rcfg, 500, g, dev)
        z = sample_along_rays(r.near, r.far, 64, 1.0, t_rand=draws.t_rand).contiguous()
        ve = positional_encoding(r.viewdirs, cfg.nf_views).contiguous()
        ev[2].record()
        state.zero_grad()
        params = dict(state.coarse.named_parameters())
        canon = b3.pack_params(canonical_params(params), cfg, torch.float32)
        tnet = b6.pack_time_params(params, cfg, torch.float32)
        ev[3].record()
        pts = (o[:, None, :] + d[:, None, :] * z[..., None]).contiguous()
        run = dataclasses.replace(tnet, weights=tnet.weights.detach().to(bf), biases=tnet.biases.detach())
        dx = b6.time_net(run, pts, t)
        ev[4].record()
        c16 = dataclasses.replace(canon, weights=canon.weights.detach().to(bf), biases=canon.biases.detach())
        out = b3.render_pass(c16, None, None, ve, z, b3_dists(z, d), draws.noise0.contiguous(), True, None,
                             (pts + dx).contiguous())
        ev[5].record()
        zf = sample_pdf_merge(z, out.weights, 128, det=False, u=draws.u).contiguous()
        ev[6].record()
        pf = (o[:, None, :] + d[:, None, :] * zf[..., None]).contiguous()
        t2 = torch.cat([t, torch.full_like(t, 0.41)])
        dx2 = b6.time_net_autograd(tnet, bf, torch.cat([pf, pf]), t2)
        ev[7].record()
        loss, _ = b1.render_loss_pts_autograd(canon, bf, (pf + dx2[:500]).contiguous(), ve, zf, b3_dists(zf, d),
                                              draws.noise1.contiguous(), target, True, 1.0 / 1500)
        ev[8].record()
        loss = loss + torch.sum((dx2[:500] - dx2[500:]) ** 2) * 1e-4
        ev[9].record()
        loss.backward()
        ev[10].record()
        state.apply_update()
        ev[11].record()
        torch.cuda.synchronize()
        if rep:
            for i, k in enumerate(names):
                acc[k] = ev[i].elapsed_time(ev[i + 1])
    del state, model
    torch.cuda.empty_cache()
    return acc


def phase22_serve(tmp, data, psnr_before):
    """Test frame 5 rendered from the trained 800200.tar by the serving CLI
    (--testskip 5: frames 0, 5, 10, 15, 20)."""
    from swnerf_torch.pipelines import run_dnerf

    savedir = Path(run_dnerf.main(dnerf_args(tmp, data, "--render_only", "--render_test", "--testskip", "5")))
    metrics = json.loads((savedir / "metrics.json").read_text())
    unit = dnerf_unit_psnr(metrics["psnr"], data, DNERF_FRAMES)
    print(f"[22 serve] from 800200.tar ({savedir.name}), data range 1: frames {DNERF_FRAMES} "
          f"{[round(u, 3) for u in unit]}; test frame 5 {unit[1]:.3f} dB vs {psnr_before:.3f} dB from 800000.tar "
          f"(delta {unit[1] - psnr_before:+.3f} dB)")
    if savedir.name != "renderonly_test_800200" or abs(unit[1] - psnr_before) > 0.5:
        fail(f"test frame 5 from 800200.tar: {unit[1]} dB, more than 0.5 dB from {psnr_before}")


# ---------------------------------------------------------------- MultiRes phases

MULTIRES_CONFIG = ROOT / "configs" / "multires" / "lego.txt"
MR_FRAMES = (0, 5, 10, 15, 20)  # test frames held to the fp32 plain route in phase 25
MR_NOISE = ("--raw_noise_std", "1")  # phase 25's one change to the config: live densities (phase25_train)


def multires_phases(dev, tmp, data):
    """Phases 23-25 on phase 11's scene. Returns the [kernel] rows of B7
    and of B6's MultiRes instantiation (forward, backward), with the launch
    counts of the MultiRes main path."""
    rows = phase23_kernels(dev, data)
    phase24_steps(dev, data)
    counts = phase25_train(dev, tmp, data)
    counter = {"time_net[multires]": "time_net", "time_net[multires,bwd]": "time_net[bwd]",
               "trunk[multires]": "trunk", "trunk[multires,bwd]": "trunk[bwd]"}
    for k, row in rows.items():
        row["launches"] = counts.get(counter.get(k, k), 0)
        print(f"[23 kernel] {row['name']}: {row['ms']:.3f} ms/launch (plain {row['plain_ms']:.3f} ms), bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']} -> {100 * row['bound_ms'] / row['ms']:.2f}% of the "
              f"bound, {row['launches']} launches on the MultiRes main path")
    return list(rows.values())


def mr_args(*extra):
    from swnerf_torch.utils.config import config_parser_dnerf

    return config_parser_dnerf().parse_args(["--config", str(MULTIRES_CONFIG), *extra])


def mr_level_model(dev, level, seed, **kw):
    """A MultiRes level's field at the config's full width (D=8, W=256, skip
    4) with seeded weights."""
    import torch

    from swnerf_torch.models import DirectTemporalNeRF
    from swnerf_torch.pipelines import run_multires as mr

    cfg = mr._level_cfg(mr_args(), mr.CHANNEL_LIST[level])
    return DirectTemporalNeRF(cfg, device=dev, generator=torch.Generator().manual_seed(seed), **kw)


def phase23_kernels(dev, data):
    """B7 and the widened B6 against their twins at each level's widths on
    the phase-1 shape (500 rays x 64 samples = 32,000 rows), then their
    times at each level's rows. Returns B7's two [kernel] rows."""
    import dataclasses

    import torch

    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import time_net as b6
    from swnerf_torch.ops.kernels import trunk as b7
    from swnerf_torch.ops.sampling import sample_along_rays

    rays, _ = frame_rays(dev, data, "train", 37)
    g = torch.Generator(device=dev).manual_seed(0)
    sel = torch.randint(0, rays.origins.shape[0], (1024,), generator=g, device=dev)
    r = type(rays)(*(x[sel] for x in rays))
    z = sample_along_rays(r.near, r.far, 64, 1.0, generator=g)
    pts_all = (r.origins[:, None, :] + r.directions[:, None, :] * z[..., None]).contiguous()  # up to 65,536 rows
    t_all = r.times.reshape(-1).contiguous()
    pts, t = pts_all[:500], t_all[:500]  # the checks: the phase-1 shape
    P = pts.shape[0] * pts.shape[1]
    err16 = {"time_net": 0.0, "trunk": 0.0}
    cases = {}
    for level in (0, 1, 3):
        model = mr_level_model(dev, level, seed=level)
        cfg, sd, occ = model.cfg, model.state_dict(), model._occ.state_dict()
        cot = torch.randn(pts.shape, generator=g, device=dev)
        # B6 at the level's (Lx, Lt)
        p32 = b6.pack_time_params(sd, cfg, torch.float32)
        dx, gk = b6.time_net_fwd_bwd(p32, pts, t, cot)
        _, gk2 = b6.time_net_fwd_bwd(p32, pts, t, cot)
        ref, gr = b6.time_net_plain(p32, pts, t), b6.time_net_plain_bwd(p32, pts, t, cot)
        p64 = dataclasses.replace(p32, weights=p32.weights.double())
        g64 = b6.time_net_plain_bwd(p64, pts.double(), t.double(), cot.double())
        g64p = b6.time_net_plain_bwd(dataclasses.replace(p64, weights=jitter(p64.weights)), pts.double(), t.double(),
                                     cot.double())
        dxf = b6.time_net(p32, pts, t)  # the forward-only launch the test render runs
        torch.cuda.synchronize()
        ddx = (dx - ref).abs().max().item()
        same = torch.equal(gk[0], gk2[0]) and torch.equal(gk[1], gk2[1])
        fwd_same = torch.equal(dxf, dx)
        print(f"[23 B6 fp32 level {level}] input {p32.cin} of {p32.cin_pad} rows: max|ddx|={ddx:.3e} "
              f"(max|dx| {ref.abs().max().item():.3e}) repeat bit-equal={same}; forward-only launch max|ddx|="
              f"{(dxf - ref).abs().max().item():.3e}, bit-equal to train mode={fwd_same}")
        if ddx > 1e-5 or not same or not fwd_same:
            fail(f"B6 fp32 level {level}: max |ddx| {ddx} > 1e-5, repeats differ or the forward-only launch differs "
                 "from the train-mode one")
        check_fp32_grads(f"23 B6 fp32 level {level}", *(b6.unpack_time_grads(x, p32) for x in (gk, gr, g64, g64p)))
        p16 = b6.pack_time_params(sd, cfg, torch.bfloat16)
        dx16, gk = b6.time_net_fwd_bwd(p16, pts, t, cot)
        _, gk2 = b6.time_net_fwd_bwd(p16, pts, t, cot)
        ref16, gr = b6.time_net_plain(p16, pts, t), b6.time_net_plain_bwd(p16, pts, t, cot)
        dxf = b6.time_net(p16, pts, t)
        torch.cuda.synchronize()
        ddx = (dx16 - ref16).abs().max().item()
        rel = rel_l2(b6.unpack_time_grads(gk, p16), b6.unpack_time_grads(gr, p16))
        same = torch.equal(gk[0], gk2[0]) and torch.equal(gk[1], gk2[1])
        fwd_same = torch.equal(dxf, dx16)
        print(f"[23 B6 bf16 level {level}] max|ddx|={ddx:.3e} grads max rel L2={max(rel.values()):.3e} "
              f"({max(rel, key=rel.get)}) repeat bit-equal={same}; forward-only launch max|ddx|="
              f"{(dxf - ref16).abs().max().item():.3e}, bit-equal to train mode={fwd_same}")
        if ddx > 1e-2 or max(rel.values()) > 1e-2 or not same or not fwd_same:
            fail(f"B6 bf16 level {level}: max |ddx| > 1e-2, gradient rel L2 > 1e-2, repeats differ or the forward-only "
                 "launch differs from the train-mode one")
        err16["time_net"] = max(err16["time_net"], ddx)
        del gk, gk2, gr, g64, g64p

        # B7 at the embedded warped positions and the view embedding
        emb = positional_encoding((pts + ref).reshape(P, 3), cfg.nf_pts).contiguous()
        vemb = positional_encoding(r.viewdirs[:500], cfg.nf_views)[:, None, :].expand(500, 64, -1).reshape(P, -1)
        vemb = vemb.contiguous()
        graw = torch.randn((P, 4), generator=g, device=dev)
        c32 = b7.pack_trunk_params(occ, cfg, torch.float32)
        raw, gk, dk, _ = b7.trunk_fwd_bwd(c32, emb, vemb, graw)
        _, gk2, dk2, _ = b7.trunk_fwd_bwd(c32, emb, vemb, graw)
        rref = b7.trunk_plain(c32, emb, vemb)
        gr, dr, _ = b7.trunk_plain_bwd(c32, emb, vemb, graw)
        c64 = dataclasses.replace(c32, weights=c32.weights.double())
        g64, d64, _ = b7.trunk_plain_bwd(c64, emb.double(), vemb.double(), graw.double())
        g64p, d64p, _ = b7.trunk_plain_bwd(dataclasses.replace(c64, weights=jitter(c64.weights)), emb.double(),
                                           vemb.double(), graw.double())
        rawf = b7.trunk(c32, emb, vemb)  # the forward-only launch the test render runs
        torch.cuda.synchronize()
        draw = (raw - rref).abs().max().item()
        raw_ok = torch.allclose(raw, rref, atol=1e-4, rtol=1e-4)
        same = torch.equal(gk[0], gk2[0]) and torch.equal(gk[1], gk2[1]) and torch.equal(dk, dk2)
        fwd_same = torch.equal(rawf, raw)
        print(f"[23 B7 fp32 level {level}] emb {c32.cin} of 128, vemb {c32.input_ch_views} of 128: "
              f"max|draw|={draw:.3e} (max|raw| {rref.abs().max().item():.3e}) within atol/rtol 1e-4={raw_ok} "
              f"max|ddemb|={(dk - dr).abs().max().item():.3e} repeat bit-equal={same}; forward-only launch "
              f"max|draw|={(rawf - rref).abs().max().item():.3e}, bit-equal to train mode={fwd_same}")
        if not raw_ok or not same or not fwd_same:
            fail(f"B7 fp32 level {level}: raw outside atol/rtol 1e-4, repeats differ or the forward-only launch "
                 "differs from the train-mode one")
        check_fp32_grads(f"23 B7 fp32 level {level}", *(dict(b7.unpack_trunk_grads(gg, pp), demb=dd) for gg, dd, pp in (
            (gk, dk, c32), (gr, dr, c32), (g64, d64, c64), (g64p, d64p, c64))))
        del gk, gk2, gr, g64, g64p
        c16 = b7.pack_trunk_params(occ, cfg, torch.bfloat16)
        raw, gk, dk, _ = b7.trunk_fwd_bwd(c16, emb, vemb, graw)
        _, gk2, dk2, _ = b7.trunk_fwd_bwd(c16, emb, vemb, graw)
        rref = b7.trunk_plain(c16, emb, vemb)
        gr, dr, _ = b7.trunk_plain_bwd(c16, emb, vemb, graw)
        rawf, rawf2 = b7.trunk(c16, emb, vemb), b7.trunk(c16, emb, vemb)  # the tensor-core launch
        torch.cuda.synchronize()
        draw = (raw - rref).abs().max().item()
        drawf = (rawf - rref).abs().max().item()
        scale = rref.abs().max().item()
        rel = rel_l2(dict(b7.unpack_trunk_grads(gk, c16), demb=dk), dict(b7.unpack_trunk_grads(gr, c16), demb=dr))
        same = torch.equal(gk[0], gk2[0]) and torch.equal(gk[1], gk2[1]) and torch.equal(dk, dk2)
        fwd_same = torch.equal(rawf, rawf2)
        print(f"[23 B7 bf16 level {level}] max|draw|={draw:.3e} (max|raw| {scale:.3e}) grads and demb max rel "
              f"L2={max(rel.values()):.3e} ({max(rel, key=rel.get)}) repeat bit-equal={same}; forward-only launch "
              f"(tensor cores) max|draw|={drawf:.3e}, repeat bit-equal={fwd_same}")
        if max(draw, drawf) > 1e-2 * scale or max(rel.values()) > 1e-2 or not same or not fwd_same:
            fail(f"B7 bf16 level {level}: raw (train mode or forward only) beyond 1e-2 of its largest value, "
                 "gradient rel L2 > 1e-2 or repeats differ")
        err16["trunk"] = max(err16["trunk"], draw, drawf)
        cases[level] = (p16, c16, cfg)
        del gk, gk2, gr
        torch.cuda.empty_cache()

    # times, bf16 (the main path's operands): every level's phase-1 rows
    # (32,000) and its phase-2 patch rows (32^2, 16^2, 8^2, 4^2 rays x 64),
    # on the sample positions (unwarped) of the 1,024 rays
    rows = {}
    vd_all = r.viewdirs
    for level, (p16, c16, cfg) in cases.items():
        emb_all = positional_encoding(pts_all.reshape(-1, 3), cfg.nf_pts).contiguous()
        vemb_all = positional_encoding(vd_all, cfg.nf_views)[:, None, :].expand(1024, 64, -1).reshape(65536, -1)
        vemb_all = vemb_all.contiguous()
        graw_all = torch.randn((65536, 4), generator=g, device=dev)
        cot_all = torch.randn((65536, 3), generator=g, device=dev)
        for n_rows in sorted({P, (32 >> level) ** 2 * 64}):
            e, v, gg = emb_all[:n_rows], vemb_all[:n_rows], graw_all[:n_rows]
            sc = b7._scratch(c16, n_rows, dev)
            fwd = cuda_ms(lambda: b7._launch_fwd(c16, e, v, sc), 10)
            bwd = cuda_ms(lambda: b7._launch_bwd(c16, n_rows, gg, sc, True, False), 10)
            n_rays = n_rows // 64
            pp, tt, cc = pts_all[:n_rays], t_all[:n_rays], cot_all[:n_rows]
            sc6 = b6._scratch(p16, n_rows, dev)
            f6 = cuda_ms(lambda: b6._launch_fwd(p16, pp, tt, sc6), 10)
            b6ms = cuda_ms(lambda: b6._launch_bwd(p16, n_rows, cc, sc6), 10)
            print(f"[23 times level {level}] {n_rows} rows, bf16: B7 forward (train mode) {fwd:.3f} ms, backward "
                  f"(with demb) {bwd:.3f} ms; B6 forward (train mode) {f6:.3f} ms, backward {b6ms:.3f} ms")
            if level == 0 and n_rows == P:  # the [kernel] rows: level 0, phase 1
                nw, nb = c16.weights.numel(), c16.biases.numel()
                rows["trunk[multires]"] = entry(
                    "trunk[multires]", "swnerf_torch/csrc/trunk.cu", "swnerf_tpu/ops/pallas/raymarch.py:435", 0,
                    err16["trunk"], fwd, cuda_ms(lambda: b7.trunk_plain(c16, e, v), 3),
                    4 * (e.numel() + v.numel() + 4 * n_rows) + 2 * nw + 4 * nb, 2 * c16.macs_per_row * n_rows, "bf16")
                rows["trunk[multires,bwd]"] = entry(
                    "trunk[multires,bwd]", "swnerf_torch/csrc/trunk.cu", "swnerf_tpu/ops/pallas/raymarch.py:446", 0,
                    err16["trunk"], bwd, cuda_ms(lambda: b7.trunk_plain_bwd(c16, e, v, gg), 3),
                    4 * (4 * n_rows + e.numel()) + 2 * nw + 4 * (nw + nb), 2 * c16.bwd_macs_per_row() * n_rows, "bf16")
                report_sweep("23", "trunk[multires,bwd] bf16 (with demb), level 0",
                             lambda: b7._launch_bwd(c16, n_rows, gg, sc, True, False), bwd,
                             rows["trunk[multires,bwd]"]["bound_ms"], n_rows,
                             sweep_products(c16.W, c16.D, c16.skip, c16.cin_pad, c16.cv_pad, demb=True), dev)
                # B6's MultiRes rows: its 144-row instantiation at the same
                # rows; the D-NeRF rows keep the 96-row code at its shapes
                nw6, nb6 = p16.weights.numel(), p16.biases.numel()
                rows["time_net[multires]"] = entry(
                    "time_net[multires]", "swnerf_torch/csrc/time_net.cu", "swnerf_tpu/ops/pallas/raymarch.py:470", 0,
                    err16["time_net"], f6, cuda_ms(lambda: b6.time_net_plain(p16, pp, tt), 3),
                    4 * (3 * n_rows + n_rays + 3 * n_rows) + 2 * nw6 + 4 * nb6, 2 * p16.macs_per_row * n_rows, "bf16")
                rows["time_net[multires,bwd]"] = entry(
                    "time_net[multires,bwd]", "swnerf_torch/csrc/time_net.cu",
                    "swnerf_tpu/ops/pallas/raymarch.py:480", 0, err16["time_net"], b6ms,
                    cuda_ms(lambda: b6.time_net_plain_bwd(p16, pp, tt, cc), 3),
                    4 * (3 * n_rows + 3 * n_rows + n_rays) + 2 * nw6 + 4 * (nw6 + nb6),
                    2 * p16.bwd_macs_per_row * n_rows, "bf16")
                report_sweep("23", "time_net[multires,bwd] bf16, level 0",
                             lambda: b6._launch_bwd(p16, n_rows, cc, sc6), b6ms,
                             rows["time_net[multires,bwd]"]["bound_ms"], n_rows,
                             sweep_products(p16.W, p16.D, p16.skip, p16.cin_pad), dev)
                print(f"[23 B6 level 0] {p16.macs_per_row} / {p16.bwd_macs_per_row} MACs per row: forward "
                      f"{2 * p16.macs_per_row * n_rows / f6 / 1e9:.2f} TFLOP/s, backward "
                      f"{2 * p16.bwd_macs_per_row * n_rows / b6ms / 1e9:.2f} TFLOP/s; B7 {c16.macs_per_row} / "
                      f"{c16.bwd_macs_per_row()} MACs per row: forward {2 * c16.macs_per_row * n_rows / fwd / 1e9:.2f}"
                      f" TFLOP/s, backward {2 * c16.bwd_macs_per_row() * n_rows / bwd / 1e9:.2f} TFLOP/s")
            del sc, sc6
        torch.cuda.empty_cache()
    # the test render's chunk at level 0, forward only: 32,768 rays x 64 samples
    p16, c16, cfg0 = cases[0]
    big_pts = pts_all.repeat(32, 1, 1).contiguous()
    big_t = t_all.repeat(32).contiguous()
    big_emb = positional_encoding(big_pts.reshape(-1, 3), cfg0.nf_pts).contiguous()
    big_vemb = positional_encoding(vd_all, cfg0.nf_views)[:, None, :].expand(1024, 64, -1).reshape(65536, -1)
    big_vemb = big_vemb.repeat(32, 1).contiguous()
    # the chunk's last 500 rays (the last blocks of the launch) against the
    # twins, at the bf16 bars above, before the times
    raw_big, dx_big = b7.trunk(c16, big_emb, big_vemb)[-P:], b6.time_net(p16, big_pts, big_t)[-500:]
    rref = b7.trunk_plain(c16, big_emb[-P:], big_vemb[-P:])
    dref = b6.time_net_plain(p16, big_pts[-500:], big_t[-500:])
    torch.cuda.synchronize()
    draw, ddx = (raw_big - rref).abs().max().item(), (dx_big - dref).abs().max().item()
    print(f"[23 check level 0] the test render's chunk, forward only, bf16, its last {P} rows against the twins: B7 "
          f"max|draw|={draw:.3e} (max|raw| {rref.abs().max().item():.3e}), B6 max|ddx|={ddx:.3e}")
    if draw > 1e-2 * rref.abs().max().item() or ddx > 1e-2:
        fail("B7 or B6 at the test render's chunk: raw beyond 1e-2 of its largest value or max |ddx| > 1e-2")
    del raw_big, dx_big, rref, dref
    f7 = cuda_ms(lambda: b7.trunk(c16, big_emb, big_vemb), 3)
    f6 = cuda_ms(lambda: b6.time_net(p16, big_pts, big_t), 3)
    bound7 = 2 * c16.macs_per_row * big_emb.shape[0] / PEAK_FLOPS["bf16"] * 1e3
    TC_SUMMARY["trunk[multires] forward only at the test render's chunk (wide pads)"] = (
        f"{f7:.3f} ms/launch, {2 * c16.macs_per_row * big_emb.shape[0] / f7 / 1e9:.1f} TFLOP/s, "
        f"{100 * bound7 / f7:.2f}% of its bound ({bound7:.4f} ms)")
    # the slow path of sinf/cosf: B6 at level 0 against the same launch with the encode's arguments small
    small = (big_pts * 2.0**-19).contiguous()
    f6s = cuda_ms(lambda: b6.time_net(p16, small, big_t), 3)
    print(f"[23 times level 0] the test render's chunk, {big_emb.shape[0]} rows, forward only, bf16: B7 {f7:.3f} ms "
          f"({2 * c16.macs_per_row * big_emb.shape[0] / f7 / 1e9:.2f} TFLOP/s), B6 {f6:.3f} ms; B6 on the same rows "
          f"scaled by 2^-19 (the encode's arguments below 1 rad, sinf/cosf's fast path): {f6s:.3f} ms, so the slow "
          f"path of the 2^19 arguments costs {f6 - f6s:.3f} ms ({100 * (f6 - f6s) / f6:.1f}%)")
    del big_emb, big_vemb, cases
    torch.cuda.empty_cache()
    return rows


def phase24_steps(dev, data):
    """One phase-1 step at level 0 (500 rays, TV on) and one phase-2 step over
    the four levels (patches of 32/16/8/4 pixels at the centre, the global
    term on) on the kernel route against the plain route, from the same
    weights and draws; the plain route in float64 (and on weights perturbed
    at fp32's size) as the reference of check_fp32_grads' fallback. The
    deformation heads are scaled by 1e-3: at level 0 the encode reaches
    2^19 |x|, and a dx of O(1) would carry its fp32 rounding into the
    canonical input as ~0.05 rad, a difference of conditioning, not of the
    kernels (tests/test_torch_multires.py); dx of O(1e-3) leaves the
    comparison well conditioned."""
    import torch

    from swnerf_torch.models import DirectTemporalNeRF
    from swnerf_torch.ops.pyramid import generate_laplacian_pyramid
    from swnerf_torch.pipelines import run_multires as mr
    from swnerf_torch.pipelines.common import load_scene, make_time_image_step
    from swnerf_torch.render.core import Draws, Rays, RenderConfig, make_draws
    from swnerf_torch.train.loop import init_train_state, make_dnerf_train_step

    args = mr_args("--datadir", str(data), "--device", "cuda")
    args.dataset_type = "blender_dnerf"
    scene = load_scene(args)
    rcfg = RenderConfig(n_samples=64, perturb=1.0, white_bkgd=True)

    def models(dtype=torch.float32):
        """Per level: (kernel route, plain route fp32, plain float64, plain
        float64 perturbed), from one seeded set of weights."""
        out = []
        for level in range(4):
            kern = mr_level_model(dev, level, seed=10 + level, compute_dtype=dtype)
            with torch.no_grad():
                kern._time_out.weight.mul_(1e-3)
                kern._time_out.bias.mul_(1e-3)
            plains = []
            for pdt, perturb in ((torch.float32, False), (torch.float64, False), (torch.float64, True)):
                m = DirectTemporalNeRF(kern.cfg, device=dev, fused=False)
                m.load_state_dict(kern.state_dict())
                m = m.to(pdt)
                if perturb:
                    with torch.no_grad():
                        for p in m.parameters():
                            p.copy_(jitter(p))
                plains.append(m)
            out.append((kern, *plains))
        return out

    def grads(st):
        return {k: p.grad.detach().clone() for k, p in st.coarse.named_parameters()}

    # phase 1, level 0: the CLI's step on 500 pixels of train view 37
    images = torch.as_tensor(scene.images, device=dev)
    poses = torch.as_tensor(scene.poses[:, :3, :4], device=dev)
    times = torch.as_tensor(scene.times, device=dev)
    pix = torch.randint(0, scene.H, (500, 2), generator=torch.Generator().manual_seed(1)).numpy()

    def phase1(model, dtype):
        st = init_train_state(model, None, 5e-4, 250)
        gen = torch.Generator(device=dev).manual_seed(3)
        cast = lambda x: None if x is None else x.to(dtype)  # noqa: E731

        def step(s, rays, target, nt, generator):  # the float64 step takes the fp32 rays, cast
            draws = make_draws(rcfg, rays.origins.shape[0], generator, dev)
            return make_dnerf_train_step(rcfg, True, 1e-3)(s, Rays(*(cast(x) for x in rays)), cast(target), nt,
                                                           draws=Draws(*(cast(x) for x in draws)))

        m = make_time_image_step(step, rcfg, scene, pass_neighbor=True)(st, images, poses, times, 37, pix, 0.41, gen)
        return m["total_loss"].item(), grads(st)

    sets = models()
    (lk, gk), (lp, gp), (l64, g64), (l64p, g64p) = (phase1(m, dt) for m, dt in zip(
        sets[0], (torch.float32, torch.float32, torch.float64, torch.float64)))
    torch.cuda.synchronize()
    dl = abs(lk - lp) / lp
    print(f"[24 phase 1 fp32 level 0] total_loss kernel route {lk:.8f} plain {lp:.8f} rel {dl:.3e}; float64 {l64:.8f}"
          f" (perturbed {l64p:.8f})")
    if dl > 1e-5 and abs(lk - l64) > 2 * max(abs(lp - l64), abs(l64p - l64)):
        fail(f"phase-1 step loss rel {dl} > 1e-5, and further from the float64 step than fp32 moves it")
    check_fp32_grads("24 phase 1 fp32 level 0", gk, gp, g64, g64p)
    # bf16: 2e-2, five of bf16's unit roundoffs (2^-8); a broken operand path
    # lands O(1) away. On these seeded weights level 0 measures 1.35e-2 on an
    # H100 (PERF.md): its 123- and 140-column encodings round to bf16 at
    # every layer.
    l16, _ = phase1(models(torch.bfloat16)[0][0], torch.float32)
    print(f"[24 phase 1 bf16 level 0] total_loss {l16:.8f} vs the fp32 plain route: rel {abs(l16 - lp) / lp:.3e}")
    if abs(l16 - lp) / lp > 2e-2:
        fail(f"bf16 phase-1 step loss rel {abs(l16 - lp) / lp} > 2e-2")

    # phase 2: every level's centre patch of train view 37, global weight 1
    L = 4
    pyr_hwf = [[scene.H // 2**l, scene.W // 2**l, scene.focal / 2**l] for l in range(L)]
    patch_sizes = [32, 16, 8, 4]
    coords = [(10 << (L - 1 - l), 10 << (L - 1 - l)) for l in range(L)]  # (80, 80) at level 0 .. (10, 10)
    with torch.no_grad():
        lap = generate_laplacian_pyramid(images[37:38], levels=L)
    pixels = [torch.stack(torch.meshgrid(torch.arange(y, y + ps, device=dev), torch.arange(x, x + ps, device=dev),
                                         indexing="ij"), -1).reshape(-1, 2) for (y, x), ps in zip(coords, patch_sizes)]
    targets = [lap[l][0, y : y + ps, x : x + ps] for l, ((y, x), ps) in enumerate(zip(coords, patch_sizes))]
    full = images[37, 80:112, 80:112]
    gen = torch.Generator(device=dev).manual_seed(4)
    draws = [make_draws(rcfg, ps * ps, gen, dev) for ps in patch_sizes]
    step = mr.make_phase2_step(rcfg, pyr_hwf, patch_sizes, scene.near, scene.far)
    sets = models()  # fresh weights: each phase-1 step above applied its own Adam update

    def phase2(ms, dtype):
        states = [init_train_state(m, None, 5e-4, 250) for m in ms]
        cast = lambda x: x.to(dtype)  # noqa: E731
        m = step(states, pixels, [cast(x) for x in targets], cast(full), cast(poses[37]), float(scene.times[37]), 1.0,
                 draws=[Draws(cast(d.t_rand), None, None, None) for d in draws])
        return m, [grads(s) for s in states]

    (mk, gk), (mp, gp), (m64, g64), (m64p, g64p) = (phase2([s[i] for s in sets], dt) for i, dt in enumerate(
        (torch.float32, torch.float32, torch.float64, torch.float64)))
    torch.cuda.synchronize()
    lk, lp, l64, l64p = (m["total_loss"].item() for m in (mk, mp, m64, m64p))
    dl = abs(lk - lp) / lp
    print(f"[24 phase 2 fp32] total_loss kernel route {lk:.8f} plain {lp:.8f} rel {dl:.3e} (global loss "
          f"{mk['global_loss'].item():.6f} vs {mp['global_loss'].item():.6f}); float64 {l64:.8f} (perturbed {l64p:.8f})")
    if dl > 1e-5 and abs(lk - l64) > 2 * max(abs(lp - l64), abs(l64p - l64)):
        fail(f"phase-2 step loss rel {dl} > 1e-5, and further from the float64 step than fp32 moves it")
    for l in range(L):
        check_fp32_grads(f"24 phase 2 fp32 level {l}", gk[l], gp[l], g64[l], g64p[l])
    m16, _ = phase2([s[0] for s in models(torch.bfloat16)], torch.float32)
    d16 = abs(m16["total_loss"].item() - lp) / lp
    print(f"[24 phase 2 bf16] total_loss {m16['total_loss'].item():.8f} vs the fp32 plain route: rel {d16:.3e}")
    if d16 > 2e-2:
        fail(f"bf16 phase-2 step loss rel {d16} > 2e-2")
    del sets
    torch.cuda.empty_cache()


def phase25_train(dev, tmp, data):
    """The MultiRes main path through run_multires (module docstring, phase
    25). Returns its launch counts."""
    import numpy as np
    import torch

    from swnerf_torch.models import DirectTemporalNeRF
    from swnerf_torch.ops.kernels import launches
    from swnerf_torch.ops.pyramid import reconstruct_from_pyramid
    from swnerf_torch.pipelines import run_multires as mr
    from swnerf_torch.pipelines.common import load_scene, render_path
    from swnerf_torch.train.loop import mse_to_psnr

    # --raw_noise_std 1 (MR_NOISE): without density noise every level's loss
    # on this scene stopped within 20 steps at the all-white render's, a
    # density below zero takes no gradient through its ReLU, and the
    # quality bars below compared two white images.
    argv = ["--config", str(MULTIRES_CONFIG), "--basedir", str(tmp / "mr_logs"), "--datadir", str(data),
            "--device", "cuda", "--global_optimization_epoch", "100", "--i_testset", "200", "--i_weights", "100",
            *MR_NOISE]
    env = dict(SWNERF_PHASE1_ITERS="100", SWNERF_MAX_ITERS="201")
    os.environ.update(env)
    try:
        launches.clear()
        t0 = time.perf_counter()
        res = mr.train(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launches)
    finally:
        for k in env:
            os.environ.pop(k, None)
    exp = tmp / "mr_logs" / "lego"
    print(f"[25 train] launches {json.dumps(counts, sort_keys=True)}, CLI wall {wall:.2f} s")
    for k in ("time_net", "time_net[bwd]", "trunk", "trunk[bwd]"):
        if counts.get(k, 0) <= 0:
            fail(f"the MultiRes main path launched no {k}")
    for level in range(4):
        losses = res["phase1_loss"][level]
        ms = res["phase1_step_ms"][level]
        quiet = [v for i, v in ms.items() if i % 20 and (i - 1) % 20]
        print(f"[25 phase 1 level {level}] loss at the prints {[round(x, 6) for x in losses]}; ms per step, median of "
              f"{len(quiet)} steps that do not print (CUDA events): {statistics.median(quiet):.3f} "
              f"(min {min(quiet):.3f}, max {max(quiet):.3f})")
        if not losses[-1] < losses[0]:
            fail(f"level {level}'s phase-1 loss did not fall: {losses}")
    quiet = [v for i, v in res["phase2_step_ms"].items() if i % 20 and (i - 1) % 20 and i % 100 and (i - 1) % 100]
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    gpsnr = [(r["step"], round(r["global_psnr"], 3)) for r in recs if "global_psnr" in r]
    totals = [(r["step"], r["total_loss"]) for r in recs if "total_loss" in r]
    print(f"[25 phase 2] ms per step, median of {len(quiet)} steps that neither print nor save: "
          f"{statistics.median(quiet):.3f} (min {min(quiet):.3f}, max {max(quiet):.3f}); 87,040 rows a step; global "
          f"PSNR at the prints {gpsnr}; total loss at the prints {[(i, round(v, 6)) for i, v in totals]}")
    if not gpsnr or not all(np.isfinite(p) for _, p in gpsnr):
        fail(f"the global PSNR is not finite: {gpsnr}")
    if len({v for _, v in totals}) < 2:
        fail(f"the phase-2 loss did not move: {totals}")
    print(f"[25 test set] {res['test_frame_ms']:.1f} ms per reconstructed test frame (every level's 64-sample render, "
          "levels 0-2 through the eval pass: B6 + B3's pts mode, level 3 through B6 + B7, and the reconstruction, "
          "25 frames)")
    for i in (100, 200):
        ck = torch.load(str(exp / f"{i:06d}.tar"), map_location="cpu", weights_only=True)
        keys = sorted(ck)
        steps = {l: {int(e["step"]) for e in ck[f"optimizer_{l}"]["state"].values()} for l in range(4)}
        print(f"[25 train] {i:06d}.tar keys {keys}, Adam steps per level {steps}")
        if set(ck) != {"global_step", *(f"{k}_{l}" for k in ("network_fn", "optimizer") for l in range(4))} or \
                any(s != {100 + i} for s in steps.values()):
            fail(f"{i:06d}.tar: keys {keys}, Adam steps {steps}")

    # 000200.tar reconstructed by the bf16 kernels and by the fp32 plain route
    args = mr_args("--datadir", str(data), "--basedir", str(tmp / "mr_logs"), "--device", "cuda", *MR_NOISE)
    args.dataset_type = "blender_dnerf"
    scene = load_scene(args)
    args.dataset_type = "blender"
    _, states, pyr_hwf, rcfg, start = mr.create_multires(args, scene, dev)
    idx = scene.i_test[list(MR_FRAMES)]
    psnr, recons, renders = {}, {}, {}
    for route in ("bf16 kernels", "fp32 plain"):
        levels = []
        for l, st in enumerate(states):
            model = st.coarse
            if route == "fp32 plain":
                model = DirectTemporalNeRF(st.coarse.cfg, device=dev, fused=False)
                model.load_state_dict(st.coarse.state_dict())
            rgbs, _, _ = render_path(model, None, scene.poses[idx], mr.level_scene(scene, pyr_hwf[l]), rcfg, args.chunk,
                                     times=scene.times[idx])
            levels.append(torch.as_tensor(rgbs))
        renders[route] = levels
        recons[route] = reconstruct_from_pyramid(levels).clamp(0.0, 1.0)
        gt = torch.as_tensor(scene.images[idx])
        psnr[route] = [mse_to_psnr(torch.mean((recons[route][k] - gt[k]) ** 2).item()) for k in range(len(idx))]
    mean = {k: sum(v) / len(v) for k, v in psnr.items()}
    d = abs(mean["bf16 kernels"] - mean["fp32 plain"])
    dlev = [(a - b).abs().max().item() for a, b in zip(renders["bf16 kernels"], renders["fp32 plain"])]
    drec = (recons["bf16 kernels"] - recons["fp32 plain"]).abs()
    print(f"[25 test set] from {start:06d}.tar, test frames {MR_FRAMES} at 200x200, reconstructed PSNR (data range "
          f"1): bf16 kernels {[round(x, 3) for x in psnr['bf16 kernels']]} (mean {mean['bf16 kernels']:.4f} dB), fp32 "
          f"plain route {[round(x, 3) for x in psnr['fp32 plain']]} (mean {mean['fp32 plain']:.4f} dB): |delta| "
          f"{d:.4f} dB; max |bf16 - fp32| per level's render {[f'{x:.3e}' for x in dlev]}, in the reconstruction "
          f"{drec.max().item():.3e} (mean {drec.mean().item():.3e})")
    if start != 200 or d > 0.1:
        fail(f"the bf16 reconstruction of 000200.tar is {d} dB from the fp32 plain route (> 0.1 dB)")
    if drec.max().item() == 0.0:
        fail("the bf16 and fp32 reconstructions are equal: the 0.1 dB bar saw no bf16 error (saturated frames)")
    print(f"[25 digest] 000200.tar: {ckpt_digest(exp / '000200.tar')} (sha256 of every tensor's bytes, keys in order; "
          "000100.tar: " + ckpt_digest(exp / "000100.tar") + ")")
    pyramid_repeats(dev)
    multires_breakdown(dev, scene, states, pyr_hwf, rcfg, args)
    del states
    torch.cuda.empty_cache()
    return counts


def ckpt_digest(path) -> str:
    """sha256 over a checkpoint's contents: every tensor's dtype, shape and
    bytes and every other value's repr, walking the keys in sorted order."""
    import hashlib

    import torch

    h = hashlib.sha256()

    def walk(key, v):
        h.update(str(key).encode())
        if isinstance(v, torch.Tensor):
            t = v.detach().cpu().contiguous()
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        elif isinstance(v, dict):
            for k in sorted(v, key=str):
                walk(k, v[k])
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                walk(i, x)
        else:
            h.update(repr(v).encode())

    walk("", torch.load(str(path), map_location="cpu", weights_only=True))
    return h.hexdigest()[:16]


def pyramid_repeats(dev):
    """The pyramid reconstruction's backward at phase 2's patch sizes (32,
    16, 8, 4; ops/pyramid.py's fixed-order backward) launched twice on one
    seeded cotangent: bit-equal, and the forward bit-equal to F.interpolate's.
    Beside it, the same with F.interpolate's own backward (atomics), whose
    two launches may differ: printed, not held."""
    import torch

    from swnerf_torch.ops import pyramid as tp

    g = torch.Generator(device=dev).manual_seed(0)
    bands = [torch.rand((1, 32 >> l, 32 >> l, 3), generator=g, device=dev) for l in range(4)]
    ct = torch.randn((1, 32, 32, 3), generator=g, device=dev)

    def grads(resize):
        saved, tp._resize = tp._resize, resize
        try:
            bb = [b.clone().requires_grad_(True) for b in bands]
            out = tp.reconstruct_from_pyramid(bb)
            (out * ct).sum().backward()
            torch.cuda.synchronize()
            return out.detach(), [b.grad for b in bb]
        finally:
            tp._resize = saved

    (o1, g1), (o2, g2) = grads(tp._resize), grads(tp._resize)
    (o3, g3), (_, g4) = grads(tp._interpolate), grads(tp._interpolate)
    same = all(torch.equal(a, b) for a, b in zip(g1, g2))
    atomic_same = all(torch.equal(a, b) for a, b in zip(g3, g4))
    dmax = max((a - b).abs().max().item() for a, b in zip(g1, g3))
    print(f"[25 pyramid] the reconstruction at phase 2's patches: forward bit-equal to F.interpolate's="
          f"{torch.equal(o1, o3) and torch.equal(o1, o2)}; fixed-order backward, two launches bit-equal={same}; "
          f"F.interpolate's own backward, two launches bit-equal={atomic_same}; the two backwards max|d|={dmax:.3e}")
    if not same or not torch.equal(o1, o3):
        fail("the pyramid's fixed-order backward differs between two launches, or its forward from F.interpolate's")
    if dmax > 1e-5:
        fail(f"the pyramid's fixed-order backward is {dmax} from F.interpolate's (> 1e-5)")


def _device_us(evt):
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0)


def multires_breakdown(dev, scene, states, pyr_hwf, rcfg, args):
    """Device time by kernel family over 10 phase-1 steps at level 0 and 10
    phase-2 steps (the CLI's steps on 000200.tar's levels, after 3 warm-up
    steps each), from torch.profiler's CUDA activity, against the host
    clock around the steps (synchronized): the device's idle share."""
    import numpy as np
    import torch

    from swnerf_torch.ops.pyramid import generate_laplacian_pyramid
    from swnerf_torch.pipelines import run_multires as mr
    from swnerf_torch.pipelines.common import ImageSampler, make_time_image_step, pick_neighbor_time
    from swnerf_torch.train.loop import make_dnerf_train_step

    images = torch.as_tensor(scene.images, device=dev)
    poses = torch.as_tensor(scene.poses[:, :3, :4], device=dev)
    times = torch.as_tensor(scene.times, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    rng = np.random.default_rng(7)
    lscene = mr.level_scene(scene, pyr_hwf[0], scene.images)
    sampler = ImageSampler(lscene, args.N_rand, 0, 0.5)
    p1 = make_time_image_step(make_dnerf_train_step(rcfg, True, args.tv_loss_weight), rcfg, lscene,
                              pass_neighbor=True)

    def phase1(i):
        img_i, pix = sampler.next(i)
        p1(states[0], images, poses, times, img_i, pix, pick_neighbor_time(rng, scene.times, img_i), gen)

    with torch.no_grad():
        lap = generate_laplacian_pyramid(images, levels=4)
    patch_sizes = [32, 16, 8, 4]
    p2 = mr.make_phase2_step(rcfg, pyr_hwf, patch_sizes, scene.near, scene.far)

    def phase2(i):
        coords = mr.initialize_patches(rng, pyr_hwf, i)
        img_i = int(rng.choice(scene.i_train))
        pixels = [torch.stack(torch.meshgrid(torch.arange(y, y + ps, device=dev), torch.arange(x, x + ps, device=dev),
                                             indexing="ij"), -1).reshape(-1, 2)
                  for (y, x), ps in zip(coords, patch_sizes)]
        targets = [lap[l][img_i, y : y + ps, x : x + ps] for l, ((y, x), ps) in enumerate(zip(coords, patch_sizes))]
        y0, x0 = coords[0]
        p2(states, pixels, targets, images[img_i, y0 : y0 + 32, x0 : x0 + 32], poses[img_i],
           float(scene.times[img_i]), 1.0, gen)

    families = (("B7 forward", ("trunk_fwd",)), ("B6 forward", ("time_net_fwd", "time_net_tc")),
                ("B6/B7 backward, tensor-core products", ("sweep_dw", "sweep_dh")),
                ("B6/B7 backward SIMT GEMMs and reductions", ("gemm_kernel", "reduce_kernel", "colsum", "head_bwd",
                                                              "cotangent_kernel", "round_cotangent")))
    for name, step in (("phase 1, level 0", phase1), ("phase 2", phase2)):
        profile_steps("25", name, step, families)


def profile_steps(tag, name, step, families):
    """Device time by kernel family (``families``: (name, key substrings))
    over 10 calls of ``step(i)`` after 3 warm-up calls, from torch.profiler's
    CUDA activity, against the host clock around the calls (synchronized):
    prints the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        step(1000 + i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(10):
            step(2000 + i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 10
    by = dict.fromkeys([f for f, _ in families] + ["other device work (PyTorch)"], 0.0)
    for evt in prof.key_averages():
        us = _device_us(evt)
        if not us or not str(evt.device_type).endswith("CUDA"):  # kernels only, not the ops that launch them
            continue
        fam = next((f for f, keys in families if any(k in evt.key for k in keys)), "other device work (PyTorch)")
        by[fam] += us / 1e3 / 10
    busy = sum(by.values())
    if busy == 0.0:
        print(f"[{tag} breakdown] {name}: torch.profiler recorded no device time; wall {wall:.3f} ms per step")
        return
    print(f"[{tag} breakdown] {name}, device ms per step by kernel family (torch.profiler, 10 steps): " + ", ".join(
        f"{k} {v:.3f} ({100 * v / busy:.1f}%)" for k, v in by.items()) + f"; busy {busy:.3f} of {wall:.3f} ms "
        f"wall per step: idle share {100 * (1 - busy / wall):.1f}%")


# ---------------------------------------------------------------- the fields' kernel routes and the mesh chain


@contextlib.contextmanager
def env(**values):
    """os.environ with ``values`` set (None: unset) inside the block."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def field_phases(dev, tmp, data, psnr_b3_frame0):
    """Phases 26-30. Returns the [kernel] rows of B7' and B8, and B7's at
    the mesh sweep's shape, with their main paths' launch counts."""
    rows = phase26_b7p(dev, data)
    rows.update(phase27_b8(dev))
    counts = phase28_routes(dev, tmp, data, psnr_b3_frame0)
    mesh_rows, mesh_counts = phase29_mesh(dev, tmp)
    rows.update(mesh_rows)
    # launches: B7' on the eager T-NeRF step (train mode, its backward) and
    # the T-NeRF render with no eval pass (forward only); B8 on the eager
    # vanilla step under SWNERF_FUSED_RAW=1 and in the B8 mesh sweep; B7 in
    # the default mesh sweep
    src = {"trunk[tnerf]": counts["tnerf step"], "trunk[tnerf,bwd]": counts["tnerf step"],
           "trunk[tnerf,render]": counts["tnerf render"], "trunk[raw]": counts["vanilla step B8"],
           "trunk[raw,bwd]": counts["vanilla step B8"], "trunk[raw,mesh]": mesh_counts["B8"],
           "trunk[mesh]": mesh_counts["B7"]}
    key = {"trunk[tnerf,render]": "trunk[tnerf]", "trunk[raw,mesh]": "trunk[raw]", "trunk[mesh]": "trunk"}
    for name, row in rows.items():
        row["launches"] = src[name].get(key.get(name, name), 0)
        print(f"[30 kernel] {name}: {row['ms']:.3f} ms/launch (plain {row['plain_ms']:.3f} ms), bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']} -> {100 * row['bound_ms'] / row['ms']:.2f}% of the "
              f"bound, {row['launches']} launches on its main path")
    return list(rows.values())


def hold_to_twin(tag, packed, x, xv, graw, raw):
    """One field trunk kernel (B7' on embeddings, or B8 on positions and
    view directions: ``raw``) against its twin on the same inputs: fp32 raw
    within 1e-5 of its largest value (the trained densities reach the
    hundreds, where fp32's ulp is ~6e-5), the gradients and both input cotangents
    at check_fp32_grads' bar (float64 twin, and on weights perturbed at fp32's
    size); bf16 raw within 1e-2 of its largest value and the gradients within
    rel L2 1e-2; bit-equal repeats, and the forward-only launch bit-equal to
    the train-mode one, in both types, except B7 / B8's bf16 forward-only
    launch (the tensor cores, a different sum order): it is held to the twin
    at the bf16 bar and to a second launch bit for bit. ``packed`` is fp32;
    returns (the bf16 packing, max |d raw| in bf16, both launches)."""
    import dataclasses

    import torch

    from swnerf_torch.ops.kernels import trunk as b7

    fwd_bwd = b7.field_raw_fwd_bwd if raw else b7.trunk_fwd_bwd
    fwd = b7.field_raw if raw else b7.trunk
    plain = b7.field_raw_plain if raw else b7.trunk_plain
    plain_bwd = b7.field_raw_plain_bwd if raw else b7.trunk_plain_bwd
    names = ("dpts", "dviewdirs") if raw else ("demb", "dvemb")

    def gdict(grads, pk, d0, d1):
        return dict(b7.unpack_trunk_grads(grads, pk), **{names[0]: d0, names[1]: d1})

    err16 = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        pk = dataclasses.replace(packed, weights=packed.weights.to(dtype))
        out, gk, d0, d1 = fwd_bwd(pk, x, xv, graw, True, True)
        _, gk2, d02, d12 = fwd_bwd(pk, x, xv, graw, True, True)
        ref = plain(pk, x, xv)
        gr, r0, r1 = plain_bwd(pk, x, xv, graw, True, True)
        outf, outf2 = fwd(pk, x, xv), fwd(pk, x, xv)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in ((gk[0], gk2[0]), (gk[1], gk2[1]), (d0, d02), (d1, d12)))
        # B7 / B8's bf16 forward-only launch runs on the tensor cores: held to
        # the twin at the bf16 bar, and to itself bit for bit, instead
        tc = dtype == torch.bfloat16 and packed.arch == "vanilla"
        fwd_same = torch.equal(outf, outf2) if tc else torch.equal(outf, out)
        draw = (out - ref).abs().max().item()
        if tc:
            draw = max(draw, (outf - ref).abs().max().item())
        scale = ref.abs().max().item()
        kind = "fp32" if dtype == torch.float32 else "bf16"
        if dtype == torch.float32:
            print(f"[{tag} {kind}] max|draw|={draw:.3e} (max|raw| {scale:.3e}: {draw / scale:.2e} of it) repeat "
                  f"bit-equal={same}; forward-only launch bit-equal to train mode={fwd_same}")
            if draw > 1e-5 * scale or not same or not fwd_same:
                fail(f"{tag} fp32: raw beyond 1e-5 of its largest value, repeats differ or the forward-only launch "
                     "differs from the train-mode one")
            p64 = dataclasses.replace(packed, weights=packed.weights.double())
            g64 = plain_bwd(p64, x.double(), xv.double(), graw.double(), True, True)
            g64p = plain_bwd(dataclasses.replace(p64, weights=jitter(p64.weights)), x.double(), xv.double(),
                             graw.double(), True, True)
            check_fp32_grads(f"{tag} {kind}", gdict(gk, pk, d0, d1), gdict(gr, pk, r0, r1),
                             gdict(g64[0], p64, *g64[1:]), gdict(g64p[0], p64, *g64p[1:]))
        else:
            rel = rel_l2(gdict(gk, pk, d0, d1), gdict(gr, pk, r0, r1))
            err16 = draw
            what = "forward-only launch (tensor cores) repeat bit-equal" if tc else \
                "forward-only launch bit-equal to train mode"
            print(f"[{tag} {kind}] max|draw|={draw:.3e} (max|raw| {scale:.3e}{', both launches' if tc else ''}) grads "
                  f"and input cotangents max rel L2={max(rel.values()):.3e} ({max(rel, key=rel.get)}) repeat "
                  f"bit-equal={same}; {what}={fwd_same}")
            if draw > 1e-2 * scale or max(rel.values()) > 1e-2 or not same or not fwd_same:
                fail(f"{tag} bf16: raw beyond 1e-2 of its largest value, gradient rel L2 > 1e-2, repeats differ or "
                     f"the {what} check failed")
            pk16 = pk
        del gk, gk2, gr
        torch.cuda.empty_cache()
    return pk16, err16


def trunk_rows(prefix, pk16, x, xv, graw, raw, err, source_line, bwd_line):
    """The forward and backward [kernel] rows of one field trunk kernel at
    the rows of x (bf16, train-mode forward as the eager steps run it)."""
    from swnerf_torch.ops.kernels import trunk as b7

    n = x.shape[0]
    sc = b7._scratch(pk16, n, x.device, raw)
    fwd = cuda_ms(lambda: b7._launch_fwd(pk16, x, xv, sc, raw), 10)
    bwd = cuda_ms(lambda: b7._launch_bwd(pk16, n, graw, sc, False, False, (x, xv) if raw else None), 10)
    plain, plain_bwd = (b7.field_raw_plain, b7.field_raw_plain_bwd) if raw else (b7.trunk_plain, b7.trunk_plain_bwd)
    nw, nb = pk16.weights.numel(), pk16.biases.numel()
    in_bytes = 4 * (x.numel() + xv.numel())
    bwd_name = f"{prefix[:-1]},bwd]"  # trunk[tnerf] -> trunk[tnerf,bwd]
    rows = {
        prefix: entry(prefix, "swnerf_torch/csrc/trunk.cu", f"swnerf_tpu/ops/pallas/raymarch.py:{source_line}", 0, err,
                      fwd, cuda_ms(lambda: plain(pk16, x, xv), 3), in_bytes + 16 * n + 2 * nw + 4 * nb,
                      2 * pk16.macs_per_row * n, "bf16"),
        bwd_name: entry(bwd_name, "swnerf_torch/csrc/trunk.cu", f"swnerf_tpu/ops/pallas/raymarch.py:{bwd_line}", 0,
                        err, bwd, cuda_ms(lambda: plain_bwd(pk16, x, xv, graw, False, False), 3),
                        in_bytes + 16 * n + 2 * nw + 4 * (nw + nb), 2 * pk16.bwd_macs_per_row(False, False) * n,
                        "bf16"),
    }
    del sc
    return rows


def phase26_b7p(dev, data):
    """B7' against its twin with the round-5 T-NeRF 800000.tar weights on
    one eager step's rows (500 seeded pixels of train view 61 at its frame
    time x 64 jittered samples = 32,000 rows): hold_to_twin's bars. Then its
    times there (train-mode forward, backward) and forward only at the
    serving chunk (32,768 rays x 64 samples = 2.1M rows)."""
    import torch

    from swnerf_torch.models import TNeRF, TNeRFConfig
    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import trunk as b7
    from swnerf_torch.ops.sampling import sample_along_rays
    from swnerf_torch.train.checkpoint import load_tar, tnerf_state_dict

    cfg = TNeRFConfig()
    model = TNeRF(cfg, device=dev, fused=False)
    model.load_state_dict(tnerf_state_dict(load_tar(str(TNERF_CKPT))["network_fn_state_dict"]))
    p32 = b7.pack_tnerf_trunk_params(model.state_dict(), cfg, torch.float32)

    def inputs(rays, z):
        n, s = z.shape
        pts = rays.origins[:, None, :] + rays.directions[:, None, :] * z[..., None]
        t = rays.times.reshape(n, 1, 1).expand(n, s, 1)
        emb = torch.cat([positional_encoding(pts, cfg.nf_pts), positional_encoding(t, cfg.nf_time)], -1)
        vemb = positional_encoding(rays.viewdirs, cfg.nf_views)[:, None, :].expand(n, s, cfg.dir_feat)
        return emb.reshape(n * s, -1).contiguous(), vemb.reshape(n * s, -1).contiguous()

    rays, img = frame_rays(dev, data, "train", 61)
    g = torch.Generator(device=dev).manual_seed(8)
    sel = torch.randint(0, img.shape[0], (500,), generator=g, device=dev)
    r = type(rays)(*(x[sel] for x in rays))
    emb, vemb = inputs(r, sample_along_rays(r.near, r.far, 64, 1.0, generator=g))
    graw = torch.randn((emb.shape[0], 4), generator=g, device=dev)
    print(f"[26 B7'] {emb.shape[0]} rows, emb {p32.cin} of 128, vemb {p32.input_ch_views} of 128, D={p32.D}, "
          f"W={p32.W}; colour logits > 0: {(b7.trunk_plain(p32, emb, vemb)[:, :3] > 0).float().mean().item():.3f}")
    p16, err = hold_to_twin("26 B7'", p32, emb, vemb, graw, False)
    rows = trunk_rows("trunk[tnerf]", p16, emb, vemb, graw, False, err, 435, 446)
    rays, _ = frame_rays(dev, data, "test", 0)
    chunk = rays.slice(0, 32768)
    big, bigv = inputs(chunk, sample_along_rays(chunk.near, chunk.far, 64, 0.0))
    out, ref = b7.trunk(p16, big[-32000:], bigv[-32000:]), b7.trunk_plain(p16, big[-32000:], bigv[-32000:])
    draw = (out - ref).abs().max().item()
    print(f"[26 B7' check] the serving chunk's last 32,000 rows, forward only, bf16: max|draw|={draw:.3e} "
          f"(max|raw| {ref.abs().max().item():.3e})")
    if draw > 1e-2 * ref.abs().max().item():
        fail("B7' bf16 at the serving chunk: raw beyond 1e-2 of its largest value")
    n = big.shape[0]
    nw, nb = p16.weights.numel(), p16.biases.numel()
    rows["trunk[tnerf,render]"] = entry(
        "trunk[tnerf,render]", "swnerf_torch/csrc/trunk.cu", "swnerf_tpu/ops/pallas/raymarch.py:435", 0, draw,
        cuda_ms(lambda: b7.trunk(p16, big, bigv), 3), cuda_ms(lambda: b7.trunk_plain(p16, big, bigv), 2),
        4 * (big.numel() + bigv.numel()) + 16 * n + 2 * nw + 4 * nb, 2 * p16.macs_per_row * n, "bf16")
    for k, row in rows.items():
        print(f"[26 times] {k}: {row['ms']:.3f} ms, {100 * row['bound_ms'] / row['ms']:.2f}% of the bf16 bound "
              f"({p16.macs_per_row} MACs per row forward, {p16.bwd_macs_per_row(False, False)} backward)")
    del big, bigv, model
    torch.cuda.empty_cache()
    return rows


def phase27_b8(dev):
    """B8 against its twin with 010000.tar's fine weights on 1024 rays of
    train view r_0 x 192 jittered samples (196,608 rows; d pts and d
    viewdirs at the fp32 bar): hold_to_twin's bars. Then its times at
    32,000 rows (train-mode forward, backward), and the forward-only launch
    at one mesh tile (2,048 points x 100 views = 204,800 rows) held to its
    twin (raw within 1e-2 of its largest value) and timed."""
    import torch

    from swnerf_torch.models import VanillaNeRF, VanillaNeRFConfig
    from swnerf_torch.ops.kernels import trunk as b7
    from swnerf_torch.ops.sampling import sample_along_rays
    from swnerf_torch.pipelines.extract_mesh import fibonacci_sphere
    from swnerf_torch.train.checkpoint import load_tar, vanilla_state_dict

    cfg = VanillaNeRFConfig()
    fine = VanillaNeRF(cfg, device=dev, fused=False)
    fine.load_state_dict(vanilla_state_dict(load_tar(str(CKPT))["network_fine_state_dict"]))
    p32 = b7.pack_trunk_params(fine.state_dict(), cfg, torch.float32)
    rays, _ = train_view_rays(dev, 1024, seed=9)
    g = torch.Generator(device=dev).manual_seed(9)
    z = sample_along_rays(rays.near, rays.far, 192, 1.0, generator=g)
    pts = (rays.origins[:, None, :] + rays.directions[:, None, :] * z[..., None]).reshape(-1, 3).contiguous()
    vd = rays.viewdirs[:, None, :].expand(1024, 192, 3).reshape(-1, 3).contiguous()
    graw = torch.randn((pts.shape[0], 4), generator=g, device=dev)
    print(f"[27 B8] {pts.shape[0]} rows, encoded in the kernel at {p32.n_freqs} frequencies ({p32.cin} and "
          f"{p32.input_ch_views} columns), D={p32.D}, W={p32.W}")
    p16, err = hold_to_twin("27 B8", p32, pts, vd, graw, True)
    rows = trunk_rows("trunk[raw]", p16, pts[:32000].contiguous(), vd[:32000].contiguous(), graw[:32000].contiguous(),
                      True, err, 556, 569)
    # one mesh tile: 2,048 grid points x 100 fibonacci directions
    ax = torch.linspace(-2.0, 2.0, 128, device=dev)
    grid = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)[64 * 128 * 128:][:2048]
    dirs = torch.as_tensor(fibonacci_sphere(100), device=dev)
    tp = grid[None].expand(100, 2048, 3).reshape(-1, 3).contiguous()
    tv = dirs[:, None, :].expand(100, 2048, 3).reshape(-1, 3).contiguous()
    n = tp.shape[0]
    out, ref = b7.field_raw(p16, tp, tv), b7.field_raw_plain(p16, tp, tv)
    draw = (out - ref).abs().max().item()
    print(f"[27 B8 check] one mesh tile ({n} rows), forward only (tensor cores), bf16: max|draw|={draw:.3e} (max|raw| "
          f"{ref.abs().max().item():.3e})")
    if draw > 1e-2 * ref.abs().max().item():
        fail("B8 bf16 at the mesh tile: raw beyond 1e-2 of its largest value")
    del out, ref
    nw, nb = p16.weights.numel(), p16.biases.numel()
    rows["trunk[raw,mesh]"] = entry(
        "trunk[raw,mesh]", "swnerf_torch/csrc/trunk.cu", "swnerf_tpu/ops/pallas/raymarch.py:556", 0, draw,
        cuda_ms(lambda: b7.field_raw(p16, tp, tv), 5), cuda_ms(lambda: b7.field_raw_plain(p16, tp, tv), 2),
        4 * (tp.numel() + tv.numel()) + 16 * n + 2 * nw + 4 * nb, 2 * p16.macs_per_row * n, "bf16")
    for k, row in rows.items():
        print(f"[27 times] {k}: {row['ms']:.3f} ms, {100 * row['bound_ms'] / row['ms']:.2f}% of the bf16 bound")
    del fine
    torch.cuda.empty_cache()
    return rows


def _train_cli(run, argv, envs, exp, prints, floor, tag):
    """One trainer CLI run under ``envs``: its output, launch counts, train
    PSNRs at the prints (each >= ``floor``) and its median step (ms) over
    the steps that neither print nor save."""
    import torch

    from swnerf_torch.ops.kernels import launches

    buf = io.StringIO()
    with env(**envs):
        launches.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
            res = run(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(launches)
    out = buf.getvalue()
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    psnrs = [(r["step"], round(r["psnr"], 3)) for r in recs if "psnr" in r]
    every = int(argv[argv.index("--i_print") + 1])
    quiet = {i: ms for i, ms in res["step_ms"].items() if i % every and (i - 1) % every}
    med = statistics.median(quiet.values())
    print(f"[{tag}] launches {json.dumps(counts, sort_keys=True)}, CLI wall {wall:.2f} s; train PSNR at the prints "
          f"{psnrs}; ms per step, median of {len(quiet)} steps that do not print (CUDA events): {med:.3f}")
    if "eager autograd train step" not in out:
        fail(f"{tag}: the run did not take the eager step")
    if len(psnrs) != prints or min(p for _, p in psnrs) < floor:
        fail(f"{tag}: train PSNR below {floor} dB at a print (or not {prints} prints): {psnrs}")
    return counts


def phase28_routes(dev, tmp, data, psnr_b3_frame0):
    """The fields' kernel routes through the CLIs:
    - run_nerf resumed from 010000.tar for 200 eager steps
      (SWNERF_FUSED_STEP=0: B7 in the fields), then again under
      SWNERF_FUSED_RAW=1 (B8), each >= 30 dB at every print;
    - run_nerf --render_only, test frame 0 with SWNERF_FUSED_EVAL=0 (the
      fields through B7), within 0.1 dB of phase 5's frame 0 (the B3 eval
      pass);
    - run_tnerf resumed from 800000.tar for 200 eager steps (B7'), >= 19 dB
      at every print, B4 not launched;
    - run_tnerf --render_only --testskip 5 with the eval pass (B4) and with
      SWNERF_FUSED_EVAL=0 (B7'): mean PSNRs within 0.1 dB;
    - run_dnerf resumed from its 800000.tar for 10 steps under SWNERF_FUSED=0:
      the fp32 plain route, no field kernel launched (B2, sample_pdf, has
      its own switch in the JAX package, SWNERF_PALLAS_SAMPLE_PDF).
    Returns the launch counts of the paths that run B7' and B8."""
    import torch

    from swnerf_torch.ops.kernels import launches
    from swnerf_torch.pipelines import run_dnerf, run_nerf, run_tnerf

    counts = {}
    for tag, extra in (("vanilla step B7", {}), ("vanilla step B8", {"SWNERF_FUSED_RAW": "1"})):
        base = tmp / tag.replace(" ", "_")
        argv = ["--config", str(CONFIG), "--ft_path", str(CKPT), "--basedir", str(base), "--datadir", str(DATADIR),
                "--device", "cuda", "--i_print", "50", "--i_weights", "100000"]
        c = _train_cli(run_nerf.main, argv, dict(SWNERF_FUSED_STEP="0", SWNERF_MAX_ITERS="10201", **extra),
                       base / "full_nerf_200k", 4, 30.0, f"28 {tag}")
        kern, kern_bwd, other = ("trunk[raw]", "trunk[raw,bwd]", "trunk") if extra else ("trunk", "trunk[bwd]",
                                                                                         "trunk[raw]")
        if c.get(kern, 0) < 400 or c.get(kern_bwd, 0) < 400 or c.get(other, 0) or \
                any(k.startswith("render_loss") for k in c):
            fail(f"28 {tag}: launches {c}")
        counts[tag] = c
    argv = ["--config", str(CONFIG), "--render_only", "--render_test", "--testskip", "25", "--device", "cuda",
            "--basedir", str(tmp / "serve_b7"), "--datadir", str(DATADIR), "--ft_path", str(CKPT)]
    with env(SWNERF_FUSED_EVAL="0"):
        launches.clear()
        t0 = time.perf_counter()
        savedir = Path(run_nerf.main(argv))
        torch.cuda.synchronize()
        c = dict(launches)
    m = json.loads((savedir / "metrics.json").read_text())
    d = m["psnr"][0] - psnr_b3_frame0
    print(f"[28 vanilla render B7] test frame 0 through the fields (SWNERF_FUSED_EVAL=0): PSNR {m['psnr'][0]:.3f} dB, "
          f"the B3 eval pass {psnr_b3_frame0:.3f} dB (delta {d:+.4f}); {m['seconds_per_frame'][0]:.3f} s for the "
          f"frame; launches {json.dumps(c, sort_keys=True)}; wall {time.perf_counter() - t0:.2f} s")
    if abs(d) > 0.1 or c.get("trunk", 0) <= 0 or any(k.startswith("render_pass") for k in c):
        fail(f"28 vanilla render B7: |dPSNR| {abs(d)} > 0.1 dB, or launches {c}")

    base = tmp / "tnerf_eager"
    argv = ["--config", str(TNERF_CONFIG), "--ft_path", str(TNERF_CKPT), "--basedir", str(base), "--datadir", str(data),
            "--device", "cuda", "--i_print", "50", "--i_weights", "100000"]
    c = _train_cli(run_tnerf.main, argv, dict(SWNERF_FUSED_STEP="0", SWNERF_MAX_ITERS="800201"),
                   base / "full_tnerf_800k", 4, 19.0, "28 tnerf step B7'")
    if c.get("trunk[tnerf]", 0) < 200 or c.get("trunk[tnerf,bwd]", 0) < 200 or c.get("render_loss[tnerf,S=64]", 0):
        fail(f"28 tnerf step B7': launches {c}")
    counts["tnerf step"] = c
    psnr = {}
    for tag, envs in (("B4 eval pass", {}), ("B7' (SWNERF_FUSED_EVAL=0)", {"SWNERF_FUSED_EVAL": "0"})):
        argv = ["--config", str(TNERF_CONFIG), "--ft_path", str(TNERF_CKPT), "--basedir", str(tmp / "tnerf_serve"),
                "--datadir", str(data), "--device", "cuda", "--render_only", "--render_test", "--testskip", "5"]
        with env(**envs):
            launches.clear()
            savedir = Path(run_tnerf.main(argv))
            torch.cuda.synchronize()
            c = dict(launches)
        m = json.loads((savedir / "metrics.json").read_text())
        psnr[tag] = m["psnr"]
        secs = m["seconds_per_frame"]
        print(f"[28 tnerf render {tag}] PSNR {[round(p, 4) for p in m['psnr']]} (mean {sum(m['psnr']) / len(secs):.4f}"
              f" dB), {1e3 * sum(secs[1:]) / len(secs[1:]):.2f} ms per frame after the first; launches "
              f"{json.dumps(c, sort_keys=True)}")
        if envs:
            counts["tnerf render"] = c
            if c.get("trunk[tnerf]", 0) <= 0 or any(k.startswith("render_pass") for k in c):
                fail(f"28 tnerf render B7': launches {c}")
    means = [sum(v) / len(v) for v in psnr.values()]
    print(f"[28 tnerf render] mean PSNR B4 {means[0]:.4f} dB, B7' {means[1]:.4f} dB: |delta| "
          f"{abs(means[0] - means[1]):.4f} dB")
    if abs(means[0] - means[1]) > 0.1 or len(psnr["B4 eval pass"]) != 5:
        fail("28 tnerf render: B7''s mean PSNR more than 0.1 dB from the B4 eval pass's (or not 5 frames)")

    base = tmp / "dnerf_plain"
    argv = ["--config", str(DNERF_CONFIG), "--ft_path", str(DNERF_CKPT), "--basedir", str(base), "--datadir",
            str(data), "--device", "cuda", "--i_print", "5", "--i_weights", "100000"]
    buf = io.StringIO()
    with env(SWNERF_FUSED="0", SWNERF_MAX_ITERS="800011"):
        launches.clear()
        with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
            res = run_dnerf.main(argv)
        torch.cuda.synchronize()
        c = dict(launches)
    print(f"[28 dnerf SWNERF_FUSED=0] 10 steps, launches {json.dumps(c, sort_keys=True)} (B2 follows its own switch, "
          f"as the JAX package's Pallas sample_pdf does), last metrics {res['metrics']}")
    if set(c) - {"sample_pdf"} or "eager autograd train step" not in buf.getvalue():
        fail(f"28 dnerf SWNERF_FUSED=0: the plain route launched {c} or did not take the eager step")
    return counts


MESH_BOUNDS = "[[-2.0,2.0],[-2.0,2.0],[-2.0,2.0]]"  # the drill recipe's (benchmarks/tpu_sw_chain.py:158-160)
MESH_VOXEL = 4.0 / 127


def phase29_mesh(dev, tmp):
    """The SW mesh chain at the drill recipe (benchmarks/tpu_sw_chain.py):
    extract_mesh on 010000.tar's fine network, 128^3 points x 100 views
    over [-2, 2]^3, threshold 25, three times: the B7 route (bf16, the
    default), the B8 route (SWNERF_FUSED_RAW=1) and the plain fp32 route
    (SWNERF_FUSED=0). Each kernel mesh against the plain one: vertex and
    face counts within 2%, bounding boxes within one voxel, the symmetric
    mean nearest-vertex distance under 0.25 voxel. Then the metric-scale
    solve without cv2 on the B7 mesh (phase 30's checks). Returns B7's mesh
    [kernel] row and the launch counts by route."""
    import numpy as np
    import torch
    from scipy.spatial import cKDTree

    from swnerf_torch.ops.kernels import launches
    from swnerf_torch.pipelines import extract_mesh
    from swnerf_torch.utils.mesh import load_obj

    routes = {"B7": {}, "B8": {"SWNERF_FUSED_RAW": "1"}, "plain fp32": {"SWNERF_FUSED": "0"}}
    meshes, counts = {}, {}
    for name, envs in routes.items():
        argv = ["--config", str(CONFIG), "--ft_path", str(CKPT), "--basedir", str(tmp / f"mesh_{len(meshes)}"),
                "--device", "cuda", "--resolution", "128", "--threshold", "25"]
        with env(SWNERF_MESH_BOUNDS=MESH_BOUNDS, SWNERF_MESH_VIEWS="100", **envs):
            launches.clear()
            res = extract_mesh.main(argv)
            counts[name] = dict(launches)
        v, f, _ = load_obj(res["path"])
        meshes[name] = (v, f, res)
        print(f"[29 mesh {name}] {res['verts']} vertices, {res['faces']} faces; sweep {1e3 * res['sweep_s']:.1f} ms "
              f"(128^3 x 100 = {128**3 * 100} rows, synchronized), marching {1e3 * res['march_s']:.1f} ms + OBJ write "
              f"{1e3 * res['write_s']:.1f} ms; launches {json.dumps(counts[name], sort_keys=True)}")
    if counts["B7"] != {"trunk": 1024} or counts["B8"] != {"trunk[raw]": 1024} or counts["plain fp32"]:
        fail(f"29 mesh: the sweeps' launches {counts} (want 1,024 B7 tiles, 1,024 B8 tiles, none)")
    pv, pf, _ = meshes["plain fp32"]
    tree = cKDTree(pv)
    for name in ("B7", "B8"):
        v, f, _ = meshes[name]
        dn, df = abs(len(v) - len(pv)) / len(pv), abs(len(f) - len(pf)) / len(pf)
        dbox = max(np.abs(v.min(0) - pv.min(0)).max(), np.abs(v.max(0) - pv.max(0)).max())
        near = 0.5 * (tree.query(v)[0].mean() + cKDTree(v).query(pv)[0].mean())
        print(f"[29 mesh {name} vs plain fp32] vertices {len(v)} vs {len(pv)} ({100 * dn:.3f}%), faces {len(f)} vs "
              f"{len(pf)} ({100 * df:.3f}%), bounding boxes within {dbox:.4e} ({dbox / MESH_VOXEL:.3f} voxel), "
              f"symmetric mean nearest-vertex distance {near:.4e} ({near / MESH_VOXEL:.4f} voxel)")
        if len(pv) < 1000 or dn > 0.02 or df > 0.02 or dbox > MESH_VOXEL or near > 0.25 * MESH_VOXEL:
            fail(f"29 mesh {name}: outside the bars against the plain fp32 mesh")
    phase30_scale(meshes["B7"][2]["path"], tmp)

    # B7 at the sweep's tile, forward only (bf16): 2,048 points x 100 views
    from swnerf_torch.models import VanillaNeRF, VanillaNeRFConfig
    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import trunk as b7
    from swnerf_torch.train.checkpoint import load_tar, vanilla_state_dict

    cfg = VanillaNeRFConfig()
    fine = VanillaNeRF(cfg, device=dev, fused=False)
    fine.load_state_dict(vanilla_state_dict(load_tar(str(CKPT))["network_fine_state_dict"]))
    p16 = b7.pack_trunk_params(fine.state_dict(), cfg, torch.bfloat16)
    ax = torch.linspace(-2.0, 2.0, 128, device=dev)
    grid = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)[64 * 128 * 128:][:2048]
    dirs = torch.as_tensor(extract_mesh.fibonacci_sphere(100), device=dev)
    emb = positional_encoding(grid, cfg.nf_pts)[None].expand(100, 2048, cfg.input_ch).reshape(-1, cfg.input_ch)
    vemb = positional_encoding(dirs, cfg.nf_views)[:, None, :].expand(100, 2048, cfg.input_ch_views)
    emb, vemb = emb.contiguous(), vemb.reshape(-1, cfg.input_ch_views).contiguous()
    out, ref = b7.trunk(p16, emb, vemb), b7.trunk_plain(p16, emb, vemb)
    draw = (out - ref).abs().max().item()
    print(f"[29 B7 check] one mesh tile (204,800 rows), forward only, bf16: max|draw|={draw:.3e} "
          f"(max|raw| {ref.abs().max().item():.3e})")
    if draw > 1e-2 * ref.abs().max().item():
        fail("B7 bf16 at the mesh tile: raw beyond 1e-2 of its largest value")
    n = emb.shape[0]
    nw, nb = p16.weights.numel(), p16.biases.numel()
    row = entry("trunk[mesh]", "swnerf_torch/csrc/trunk.cu", "swnerf_tpu/ops/pallas/raymarch.py:435", 0, draw,
                cuda_ms(lambda: b7.trunk(p16, emb, vemb), 5), cuda_ms(lambda: b7.trunk_plain(p16, emb, vemb), 2),
                4 * (emb.numel() + vemb.numel()) + 16 * n + 2 * nw + 4 * nb, 2 * p16.macs_per_row * n, "bf16")
    sweep_bound = 1024 * row["bound_ms"]
    print(f"[29 times] trunk[mesh]: {row['ms']:.3f} ms per tile, {100 * row['bound_ms'] / row['ms']:.2f}% of the bf16 "
          f"bound ({p16.macs_per_row} MACs per row); 1,024 tiles at the bound: {sweep_bound:.1f} ms, measured sweep "
          f"{1e3 * meshes['B7'][2]['sweep_s']:.1f} ms")
    del emb, vemb
    torch.cuda.empty_cache()
    split, wall = sweep_split(fine, cfg)
    total = sum(split.values())
    print(f"[29 sweep split] the B7 sweep's 1,024 tiles as query_views runs them, weights packed at every tile (as "
          f"apply_field does outside trunk.packed_once; sample_grid packs once): device ms by step, CUDA events per "
          f"tile: " + ", ".join(
              f"{k} {v:.1f} ({100 * v / total:.1f}%)" for k, v in split.items()) + f"; sum {total:.1f} ms, host clock "
          f"{1e3 * wall:.1f} ms; the sweep through extract_mesh (one packing) "
          f"{1e3 * meshes['B7'][2]['sweep_s']:.1f} ms")
    TC_SUMMARY["B7 mesh sweep (phase 29)"] = (
        f"{1e3 * meshes['B7'][2]['sweep_s']:.1f} ms for 1,024 tiles through extract_mesh; per tile "
        f"{split['B7 launch'] / 1024:.3f} ms in the B7 launch, {split['weight packing'] / 1024:.3f} ms packing when "
        "packed per tile")
    del fine
    torch.cuda.empty_cache()
    return {"trunk[mesh]": row}, counts


def sweep_split(fine, cfg):
    """The B7 mesh sweep of phase 29 (128^3 points over [-2, 2]^3 x 100 views
    in 2,048-point tiles, bf16) split per tile with CUDA events, in the steps
    VanillaNeRF.query_views and trunk.apply_field take: the encode of the
    points and the directions, the weight packing (pack_trunk_params at
    every tile), the copy of the broadcast embeddings to contiguous rows, the
    B7 launch, and the rest (the mean over the views, the store, and the
    device's idle time between the steps). Returns (device ms by step, summed
    over the tiles; the host clock's seconds for the loop)."""
    import numpy as np
    import torch

    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import trunk as b7
    from swnerf_torch.pipelines.extract_mesh import fibonacci_sphere

    dev = next(fine.parameters()).device
    ax = np.linspace(-2.0, 2.0, 128)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    pts = torch.as_tensor(np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1).astype(np.float32), device=dev)
    dirs = torch.as_tensor(fibonacci_sphere(100), device=dev)
    V, C = dirs.shape[0], 2048
    params = dict(fine.named_parameters())
    out = torch.empty((pts.shape[0], 4), device=dev)
    steps = ("encode", "weight packing", "embedding copy", "B7 launch")
    tiles = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for start in range(0, pts.shape[0], C):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            pe, ve = positional_encoding(pts[start : start + C], cfg.nf_pts), positional_encoding(dirs, cfg.nf_views)
            ev[1].record()
            packed = b7.pack_trunk_params(params, cfg, torch.bfloat16)
            ev[2].record()
            x = pe[None].expand(V, C, pe.shape[-1]).reshape(-1, pe.shape[-1])
            xv = ve[:, None, :].expand(V, C, ve.shape[-1]).reshape(-1, ve.shape[-1]).contiguous()
            ev[3].record()
            raw = b7.trunk(packed, x, xv)
            ev[4].record()
            out[start : start + C] = raw.reshape(V, C, 4).mean(0)
            tiles.append(ev)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    split = {k: sum(ev[i].elapsed_time(ev[i + 1]) for ev in tiles) for i, k in enumerate(steps)}
    split["rest"] = tiles[0][0].elapsed_time(end) - sum(split.values())
    return split, wall


def phase30_scale(mesh_path, tmp):
    """The metric-scale solve without cv2 (transform_mesh after detection):
    a 0.5-unit square marker on the z = 0 plane, its corners projected
    exactly into the capture's train poses (pinhole, zero distortion; the
    OpenGL poses turned to +z forward as benchmarks/tpu_sw_chain.py:67-71
    does), then calculate_3d_corners -> marker_edge_lengths -> scale ->
    alignment_matrix -> transform_mesh on the B7 mesh: the scale is
    real_length / 0.5 within 1e-4 relative, the marker normal maps to +z
    within 1e-6, and the transformed mesh is the mesh scaled and turned."""
    import numpy as np

    from swnerf_torch.pipelines import transform_mesh as tm
    from swnerf_torch.utils.mesh import load_obj

    with open(DATADIR / "transforms_train.json") as f:
        meta = json.load(f)
    H = W = 400
    focal = 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))
    e = 0.5
    world = np.array([[-e / 2, e / 2, 0.0], [e / 2, e / 2, 0.0], [e / 2, -e / 2, 0.0], [-e / 2, -e / 2, 0.0]])
    flip = np.diag([1.0, -1.0, -1.0])
    info = []
    for fr in meta["frames"]:
        c2w_gl = np.array(fr["transform_matrix"], np.float64)
        R, t = c2w_gl[:3, :3] @ flip, c2w_gl[:3, 3]
        cam = (world - t) @ R  # R^T (p - t), row-wise
        if (cam[:, 2] <= 1e-6).any():
            continue
        px = focal * cam[:, :2] / cam[:, 2:] + np.array([W / 2.0, H / 2.0])
        if px.min() < 8 or px.max() > W - 8:
            continue
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = R, t
        info.append({"frame": {"transform_matrix": c2w.tolist()}, "id": 7, "corners": px})
    real = 0.05
    t0 = time.perf_counter()
    corners = tm.calculate_3d_corners(info, (focal, focal, W / 2.0, H / 2.0, 0.0, 0.0, 0.0, 0.0))
    mean_len, lengths = tm.marker_edge_lengths(corners)
    scale = real / mean_len
    T = tm.alignment_matrix(corners)
    out = str(tmp / "transformed_mesh.obj")
    tm.transform_mesh(mesh_path, out, scale, T)
    wall = time.perf_counter() - t0
    normal = np.cross(corners[1] - corners[0], corners[2] - corners[0])
    n2 = T[:3, :3] @ (normal / np.linalg.norm(normal))
    v, _, _ = load_obj(mesh_path)
    v2, _, _ = load_obj(out)
    moved = np.abs(v2 - (scale * v.astype(np.float64)) @ T[:3, :3].T).max()
    rel = abs(scale - real / e) / (real / e)
    print(f"[30 scale] {len(info)} of {len(meta['frames'])} train poses see the marker; corners "
          f"{np.round(corners, 6).tolist()}; edges {[round(x, 8) for x in lengths]}; scale {scale:.8f} (want "
          f"{real / e}: rel {rel:.2e}); marker normal -> {np.round(n2, 9).tolist()}; transformed mesh within "
          f"{moved:.2e} of T (s v); solve + transform {1e3 * wall:.1f} ms")
    if len(info) < 3 or rel > 1e-4 or np.abs(n2 - [0.0, 0.0, 1.0]).max() > 1e-6 or moved > 1e-5 * max(1.0, scale):
        fail("30 scale: the metric-scale solve missed the known scale, the +z alignment or the transform")


# ---------------------------------------------------------------- MultiRes on the render kernels; B10; B11

MR_CKPT_ITER = 200  # phase 25's last checkpoint, 000200.tar


def render_kernel_phases(dev, tmp, data, psnr5):
    """Phases 31-35 on phase 25's 000200.tar (the MultiRes run from scratch,
    live densities), phase 11's scene and phase 5's PSNRs. Returns the
    [kernel] rows of B3's pts mode at the MultiRes widths, B9 (wide and
    narrow), B10 and B11, with their paths' launch counts."""
    import torch

    from swnerf_torch.pipelines import run_multires as mr
    from swnerf_torch.pipelines.common import load_scene

    args = mr_args("--datadir", str(data), "--basedir", str(tmp / "mr_logs"), "--device", "cuda", *MR_NOISE)
    args.dataset_type = "blender_dnerf"
    scene = load_scene(args)
    args.dataset_type = "blender"
    _, states, pyr_hwf, rcfg, start = mr.create_multires(args, scene, dev)
    if start != MR_CKPT_ITER:
        fail(f"phases 31-33 need {MR_CKPT_ITER:06d}.tar, found {start}")
    t0 = time.perf_counter()

    def done(phase):
        nonlocal t0
        print(f"[{phase} done] in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()

    rows = phase31_b3w_b9(dev, data, states)
    done(31)
    serve = phase32_testset(dev, args, scene, states, pyr_hwf, rcfg)
    done(32)
    del states
    torch.cuda.empty_cache()
    train = phase33_fused(dev, tmp, data, scene, pyr_hwf)
    done(33)
    rows.update(phase34_b10(dev, tmp, data, psnr5))
    done(34)
    rows.update(phase35_b11(dev, data))
    done(35)
    rows["render_pass[pts,wide]"]["launches"] = serve.get("render_pass[pts,wide,S=64]", 0) + \
        train.get("render_pass[pts,wide,S=64]", 0)
    rows["render_loss[ext,wide]"]["launches"] = train.get("render_loss[ext,wide,S=64]", 0)
    rows["render_loss[ext]"]["launches"] = train.get("render_loss[ext,S=64]", 0)
    for name, row in rows.items():
        print(f"[35 kernel] {name}: {row['ms']:.3f} ms/launch (plain {row['plain_ms']:.3f} ms"
              + (f", library {row['library_ms']:.3f} ms" if row["library_ms"] is not None else "")
              + f"), bound {row['bound_ms']:.4f} ms by {row['bound_by']} -> "
              f"{100 * row['bound_ms'] / row['ms']:.2f}% of the bound, {row['launches']} launches on its path")
    return list(rows.values())


def mr_inputs(dev, data, states, n=1024, seed=0):
    """``n`` seeded pixels of train view 37 at its frame time x 64 jittered
    samples, noise std 1, a seeded per-ray cotangent of (rgb, acc, depth)
    (all non-zero), and per level of ``states``: the warped positions
    (pts + dx by the level's fp32 B6 twin, the t == 0 mask) and the view
    embedding."""
    import torch

    from swnerf_torch.ops.embedding import positional_encoding
    from swnerf_torch.ops.kernels import time_net as b6
    from swnerf_torch.ops.sampling import sample_along_rays

    rays, _ = frame_rays(dev, data, "train", 37)
    g = torch.Generator(device=dev).manual_seed(seed)
    sel = torch.randint(0, rays.origins.shape[0], (n,), generator=g, device=dev)
    r = type(rays)(*(x[sel] for x in rays))
    z = sample_along_rays(r.near, r.far, 64, 1.0, generator=g).contiguous()
    pts = (r.origins[:, None, :] + r.directions[:, None, :] * z[..., None]).contiguous()
    t = r.times.reshape(-1).contiguous()
    noise = torch.randn(z.shape, generator=g, device=dev)
    gct = torch.randn((n, 5), generator=g, device=dev)
    levels = []
    for st in states:
        cfg = st.coarse.cfg
        dx = b6.time_net_plain(b6.pack_time_params(st.coarse.state_dict(), cfg, torch.float32), pts, t)
        if cfg.zero_canonical:
            dx = torch.where((t == 0.0)[:, None, None], torch.zeros_like(dx), dx)
        levels.append(((pts + dx).contiguous(), positional_encoding(r.viewdirs, cfg.nf_views).contiguous()))
    return {"z": z, "dist": b3_dists(z, r.directions), "noise": noise, "gct": gct, "pts": pts, "times": t,
            "levels": levels}


def phase31_b3w_b9(dev, data, states):
    """B3's pts mode at the MultiRes widths (levels 0-2) and B9 (levels 0-3,
    narrow at the identity level) against their twins with 000200.tar's
    per-level weights on 1,024 pixels x 64 samples; then their times at the
    test render's chunk (32,768 rays x 64, level 0) and phase 2's level-0
    rows (1,024 x 64). Returns the [kernel] rows."""
    import dataclasses

    import torch

    from swnerf_torch.ops.kernels import render_loss as b1
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.render.fused_eval import canonical_params

    inp = mr_inputs(dev, data, states)
    z, dist, noise, gct = inp["z"], inp["dist"], inp["noise"], inp["gct"]
    err16 = {"b3": 0.0, "b9": 0.0, "b9n": 0.0}
    packs = {}
    for level, st in enumerate(states):
        cfg = st.coarse.cfg
        canon = canonical_params(st.coarse.state_dict())
        warped, ve = inp["levels"][level]
        for dtype in (torch.float32, torch.bfloat16):
            tag = "fp32" if dtype == torch.float32 else "bf16"
            packed = b3.pack_params(canon, cfg, dtype)
            packs[(level, tag)] = (packed, warped, ve)
            got = b3.render_pass(packed, None, None, ve, z, dist, noise, True, None, warped)
            if level < 3:  # B3 at the wide widths: the test render's levels
                ref = b3.render_pass_plain(packed, None, None, ve, z, dist, noise, True, None, warped)
                torch.cuda.synchronize()
                drgb = (got.rgb - ref.rgb).abs()
                dacc = (got.acc - ref.acc).abs().max().item()
                depth_ok = torch.allclose(got.depth, ref.depth, rtol=1e-4, atol=1e-5)
                print(f"[31 B3 wide {tag} level {level}] {packed.cin} / {packed.input_ch_views} of {packed.cin_pad} / "
                      f"{packed.cv_pad} rows: max|drgb|={drgb.max().item():.3e} mean|drgb|={drgb.mean().item():.3e} "
                      f"max|dacc|={dacc:.3e} depth_within_rtol={depth_ok}")
                if dtype == torch.float32 and (drgb.max().item() > 1e-4 or dacc > 1e-4 or not depth_ok):
                    fail(f"B3 wide fp32 level {level} outside atol 1e-4 (rgb, acc) / rtol 1e-4 (depth)")
                if dtype == torch.bfloat16:
                    err16["b3"] = max(err16["b3"], drgb.max().item())
                    if drgb.max().item() > 1e-2:
                        fail(f"B3 wide bf16 level {level}: max |drgb| > 1e-2")
                del ref
            # the training path's B3 launch (bf16: the SIMT body, as B9 recomputes it)
            train = b3.render_pass(packed, None, None, ve, z, dist, noise, True, None, warped, ordered=True)
            fwd, gk, dk = b1.render_loss_ext(packed, warped, ve, z, dist, noise, gct, True)
            _, gk2, dk2 = b1.render_loss_ext(packed, warped, ve, z, dist, noise, gct, True)
            _, gr, dr = b1.render_loss_ext_plain(packed, warped, ve, z, dist, noise, gct, True)
            torch.cuda.synchronize()
            same = torch.equal(gk[0], gk2[0]) and torch.equal(gk[1], gk2[1]) and torch.equal(dk, dk2)
            fwd_same = all(torch.equal(getattr(fwd, k), getattr(train, k)) for k in ("rgb", "acc", "depth", "weights"))
            print(f"[31 B9 {tag} level {level}] wide={packed.wide}: recomputed forward bit-equal to the training "
                  f"path's B3 launch={fwd_same}, repeat bit-equal={same}, max|ddpts|={(dk - dr).abs().max().item():.3e} "
                  f"(max|dpts| {dr.abs().max().item():.3e})")
            if not same or not fwd_same:
                fail(f"B9 {tag} level {level}: repeats differ or its forward differs from the B3 launch")
            if dtype == torch.float32:
                p64 = dataclasses.replace(packed, weights=packed.weights.double())
                a64 = [x.double() for x in (ve, z, dist, noise)]
                _, g64, d64 = b1.render_loss_ext_plain(p64, warped.double(), *a64, gct.double(), True)
                _, g64p, d64p = b1.render_loss_ext_plain(dataclasses.replace(p64, weights=jitter(p64.weights)),
                                                         warped.double(), *a64, gct.double(), True)
                check_fp32_grads(f"31 B9 fp32 level {level}", *(
                    dict(b1.unpack_grads(gg, pp), dpts=dd)
                    for gg, dd, pp in ((gk, dk, packed), (gr, dr, packed), (g64, d64, p64), (g64p, d64p, p64))))
                del g64, g64p
            else:
                rel = rel_l2(dict(b1.unpack_grads(gk, packed), dpts=dk), dict(b1.unpack_grads(gr, packed), dpts=dr))
                drgb = (fwd.rgb - b3.render_pass_plain(packed, None, None, ve, z, dist, noise, True, None,
                                                       warped).rgb).abs().max().item()
                print(f"[31 B9 bf16 level {level}] max|drgb|={drgb:.3e} grads and dpts max rel L2="
                      f"{max(rel.values()):.3e} ({max(rel, key=rel.get)})")
                if drgb > 1e-2 or max(rel.values()) > 1e-2:
                    fail(f"B9 bf16 level {level}: rgb beyond 1e-2 or gradient rel L2 > 1e-2")
                key = "b9n" if level == 3 else "b9"
                err16[key] = max(err16[key], drgb)
            del gk, gk2, gr, fwd, got, train
            torch.cuda.empty_cache()

    # B9's bf16 gradients on seeded, unsaturated weights (levels 0, 1 and the
    # identity level; 000200.tar's level 0 saturates) held at the bar, beside
    # the twin's distance from itself summed in another order (the same bf16
    # twin on the CPU): the gradients' sensitivity to fp32 summation order
    # (PERF.md §6)
    n9 = 256
    for level in (0, 1, 3):
        model = mr_level_model(dev, level, seed=10, fused=False)
        pk = b3.pack_params(canonical_params(model.state_dict()), model.cfg, torch.bfloat16)
        warped_l, ve_l = inp["levels"][level]
        args = [x[:n9].contiguous() for x in (warped_l, ve_l, z, dist, noise, gct)]
        _, gk, dk = b1.render_loss_ext(pk, *args, True)
        _, gr, dr = b1.render_loss_ext_plain(pk, *args, True)
        pkc = dataclasses.replace(pk, weights=pk.weights.cpu(), biases=pk.biases.cpu())
        _, gc, dc = b1.render_loss_ext_plain(pkc, *(x.cpu() for x in args), True)
        ref = dict(b1.unpack_grads(gr, pk), dpts=dr)
        kern = rel_l2(dict(b1.unpack_grads(gk, pk), dpts=dk), ref)
        twin = rel_l2(dict(b1.unpack_grads(gc, pkc), dpts=dc), ref)
        print(f"[31 B9 bf16 seeded level {level}] {n9} x 64 rows: the kernel's gradients and d pts within max rel L2 "
              f"{max(kern.values()):.3e} ({max(kern, key=kern.get)}) of the CUDA twin (bar 1e-2); the same twin "
              f"summed on the CPU within {max(twin.values()):.3e} ({max(twin, key=twin.get)})")
        if max(kern.values()) > 1e-2:
            fail(f"B9 bf16 on seeded level-{level} weights: gradient rel L2 > 1e-2")
        del gk, gr, gc, pk, pkc, model
        torch.cuda.empty_cache()

    # B3 wide at the test render's chunk (level 0, 32,768 rays x 64: 32
    # copies of the 1,024 rays) against its twin, on 000200.tar's weights and
    # on seeded ones (mr_level_model, seed 10), whose outputs do not saturate
    # as 000200.tar's do (ROADMAP Queue C); then the times, bf16: B3 there,
    # B9 at phase 2's rows
    p16, warped, ve = packs[(0, "bf16")]
    big = [x.repeat(32, *([1] * (x.dim() - 1))).contiguous() for x in (warped, ve, z, dist)]
    nb = big[2].numel()
    seeded = canonical_params(mr_level_model(dev, 0, seed=10, fused=False).state_dict())
    for weights, canon in (("000200.tar", canonical_params(states[0].coarse.state_dict())), ("seeded", seeded)):
        for dtype in (torch.float32, torch.bfloat16):
            tag = "fp32" if dtype == torch.float32 else "bf16"
            pk = b3.pack_params(canon, states[0].coarse.cfg, dtype)
            got = b3.render_pass(pk, None, None, big[1], big[2], big[3], None, True, None, big[0])
            ref = b3.render_pass_plain(pk, None, None, big[1], big[2], big[3], None, True, None, big[0])
            torch.cuda.synchronize()
            drgb = (got.rgb - ref.rgb).abs()
            dacc = (got.acc - ref.acc).abs().max().item()
            depth_ok = torch.allclose(got.depth, ref.depth, rtol=1e-4 if tag == "fp32" else 1e-2,
                                      atol=1e-5 if tag == "fp32" else 1e-2)
            live = ((ref.rgb > 1e-3) & (ref.rgb < 1 - 1e-3)).float().mean().item()
            print(f"[31 B3 wide {tag} level 0, {weights}] the test render's chunk (32,768 x 64): max|drgb|="
                  f"{drgb.max().item():.3e} mean|drgb|={drgb.mean().item():.3e} max|dacc|={dacc:.3e} "
                  f"depth_within_rtol={depth_ok}; share of rgb values inside (1e-3, 1 - 1e-3): {live:.4f}")
            bar = 1e-4 if tag == "fp32" else 1e-2
            if drgb.max().item() > bar or dacc > bar or not depth_ok:
                fail(f"B3 wide {tag} at the test render's chunk ({weights}): rgb or acc beyond {bar}, or depth "
                     f"beyond {'rtol 1e-4' if tag == 'fp32' else 'atol and rtol 1e-2'}")
            if tag == "bf16":
                err16["b3"] = max(err16["b3"], drgb.max().item(), dacc)
            if weights == "seeded" and live < 0.1:
                fail(f"31: the seeded weights' rgb is saturated ({live:.4f} of it live): the comparison sees nothing")
            if tag == "bf16":  # the training path's launch, on the SIMT body
                got = b3.render_pass(pk, None, None, big[1], big[2], big[3], None, True, None, big[0], ordered=True)
                du = (got.rgb - ref.rgb).abs()
                print(f"[31 B3 wide bf16 level 0, {weights}, ordered] max|drgb|={du.max().item():.3e} "
                      f"mean|drgb|={du.mean().item():.3e}")
                if du.max().item() > 1e-2 or du.mean().item() > 1e-3:
                    fail(f"B3 wide bf16, ordered, at the test render's chunk ({weights}): max |drgb| > 1e-2 or "
                         "mean > 1e-3")
                err16["b3"] = max(err16["b3"], du.max().item())
            del got, ref
    torch.cuda.empty_cache()
    rows = {}
    b3ms = cuda_ms(lambda: b3.render_pass(p16, None, None, big[1], big[2], big[3], None, True, None, big[0]), 5)
    b3plain = cuda_ms(lambda: b3.render_pass_plain(p16, None, None, big[1], big[2], big[3], None, True, None,
                                                   big[0]), 2)
    comp, head = tc_shares("render_pass", lambda: b3.render_pass(p16, None, None, big[1], big[2], big[3], None,
                                                                 True, None, big[0]))
    TC_SUMMARY["render_pass[pts,wide] at the test render's chunk"] = (
        f"composite busy {100 * comp:.2f}% (overlapped with the products), alpha + rgb heads {100 * head:.2f}% "
            "of the blocks' cycles")
    b3ms_o = cuda_ms(lambda: b3.render_pass(p16, None, None, big[1], big[2], big[3], None, True, None, big[0],
                                            ordered=True), 3)
    small = b3.render_pass(p16, None, None, ve, z, dist, noise, True, None, warped)
    b3small = cuda_ms(lambda: b3.render_pass(p16, None, None, ve, z, dist, noise, True, None, warped), 20)
    b3small_o = cuda_ms(lambda: b3.render_pass(p16, None, None, ve, z, dist, noise, True, None, warped,
                                               ordered=True), 20)
    nw, nbias = p16.weights.numel(), p16.biases.numel()
    rows["render_pass[pts,wide]"] = entry(
        "render_pass[pts,wide]", "swnerf_torch/csrc/render_pass.cu", "swnerf_tpu/ops/pallas/render_fused.py:276",
        0, err16["b3"], b3ms, b3plain,
        4 * (3 * nb + big[1].numel() + 2 * nb + 5 * big[2].shape[0] + nb) + 2 * nw + 4 * nbias,
        2 * p16.macs_per_sample * nb, "bf16")
    del big, small
    torch.cuda.empty_cache()
    print(f"[31 times] B3 wide level 0 ({p16.macs_per_sample} MACs per sample): the test render's chunk "
          f"(32,768 x 64) {b3ms:.3f} ms ({2 * p16.macs_per_sample * nb / b3ms / 1e9:.2f} TFLOP/s); phase 2's "
          f"1,024 x 64 rows {b3small:.3f} ms; the training path's ordered launch (SIMT) {b3ms_o:.3f} "
          f"and {b3small_o:.3f} ms")
    for key, level, n_rays in (("render_loss[ext,wide]", 0, 1024), ("render_loss[ext]", 3, 16)):
        pk, wp, vv = packs[(level, "bf16")]
        args = (pk, wp[:n_rays].contiguous(), vv[:n_rays].contiguous(), z[:n_rays].contiguous(),
                dist[:n_rays].contiguous(), noise[:n_rays].contiguous(), gct[:n_rays].contiguous(), True)
        ms = cuda_ms(lambda: b1.render_loss_ext(*args), 20)
        plain = cuda_ms(lambda: b1.render_loss_ext_plain(*args), 5)
        rows_n = n_rays * 64
        macs = b1.pts_train_macs_per_sample(pk)
        nbytes = (4 * (3 * rows_n + args[2].numel() + 3 * rows_n + 5 * n_rays) + 2 * pk.weights.numel()
                  + 4 * pk.biases.numel() + 4 * (5 * n_rays + rows_n + 3 * rows_n)
                  + 4 * (pk.weights.numel() + pk.biases.numel()))
        rows[key] = entry(key, "swnerf_torch/csrc/render_loss.cu", "swnerf_tpu/ops/pallas/render_fused.py:276", 0,
                          err16["b9n" if level == 3 else "b9"], ms, plain, nbytes, 2 * macs * rows_n, "bf16")
        print(f"[31 times] B9 level {level} ({macs} MACs per sample), {n_rays} x 64 rows: {ms:.3f} ms "
              f"({2 * macs * rows_n / ms / 1e9:.2f} TFLOP/s); twin {plain:.3f} ms")
    return rows


def phase32_testset(dev, args, scene, states, pyr_hwf, rcfg):
    """The MultiRes test render of 000200.tar through run_multires'
    render_testset on test frames 0/5/10/15/20 (phase 25's CLI render ran
    all 25 through the eval pass): levels 0-2 through the D-NeRF eval pass
    (B6, then B3's pts mode at the MultiRes widths), level 3 through its
    fields; then again with SWNERF_FUSED_EVAL=0 (every level through its
    fields, the route the eval pass replaces). Levels 0-2's frames before the reconstruction
    within max 1e-2, mean 1e-3 (phase 4's bf16 bars); mean PSNR within 0.1
    dB; B3-wide launches; ms per reconstructed frame. Returns the eval-pass
    render's launch counts."""
    import dataclasses

    import torch

    from swnerf_torch.ops.kernels import launches
    from swnerf_torch.pipelines import run_multires as mr
    from swnerf_torch.train.loop import mse_to_psnr

    scene = dataclasses.replace(scene, i_test=scene.i_test[list(MR_FRAMES)])
    gt = torch.as_tensor(scene.images[scene.i_test])
    n = len(MR_FRAMES)
    out, counts = {}, {}
    for route, fused_eval in (("eval pass", "1"), ("fields", "0")):
        with env(SWNERF_FUSED_EVAL=fused_eval):
            passes = mr.make_level_eval_passes(states, dev)
            launches.clear()
            recon, ms, frames = mr.render_testset(args, scene, states, pyr_hwf, rcfg, MR_CKPT_ITER, passes)
            torch.cuda.synchronize()
            counts[route] = dict(launches)
        rec = torch.as_tensor(recon)
        psnr = [mse_to_psnr(torch.mean((rec[k] - gt[k]) ** 2).item()) for k in range(n)]
        out[route] = (rec, psnr, ms, [p is not None for p in passes], frames)
        print(f"[32 test set] {route}: eval passes per level {out[route][3]}; launches "
              f"{json.dumps(counts[route], sort_keys=True)} ({n} frames); {ms:.1f} ms per reconstructed frame; "
              f"frames {MR_FRAMES} reconstructed PSNR {[round(x, 3) for x in psnr]} (mean {sum(psnr) / len(psnr):.4f})")
    (ra, pa, ma, la, fa), (rb, pb, mb, lb, fb) = out["eval pass"], out["fields"]
    for level in range(3):  # each eval-pass level's frames before the reconstruction: bf16 B3 wide against B7
        dl = (fa[level] - fb[level]).abs()
        live = ((fb[level] > 1e-3) & (fb[level] < 1 - 1e-3)).float().mean().item()
        print(f"[32 test set] level {level} frames {tuple(fa[level].shape)}, eval pass against the fields: max|d|="
              f"{dl.max().item():.3e} mean|d|={dl.mean().item():.3e}; share of values inside (1e-3, 1 - 1e-3): "
              f"{live:.4f}")
        if dl.max().item() > 1e-2 or dl.mean().item() > 1e-3:
            fail(f"32: level {level}'s frames through the eval pass beyond max 1e-2 / mean 1e-3 of its fields'")
    d = abs(sum(pa) / len(pa) - sum(pb) / len(pb))
    drec = (ra - rb).abs()
    n_wide = counts["eval pass"].get("render_pass[pts,wide,S=64]", 0)
    print(f"[32 test set] eval pass against the fields: |delta mean PSNR| {d:.4f} dB, max |delta| in the "
          f"reconstruction {drec.max().item():.3e} (mean {drec.mean().item():.3e}); {ma:.1f} against {mb:.1f} ms per "
          f"reconstructed frame; B3 wide launched {n_wide} times")
    if la != [True, True, True, False] or any(lb) or d > 0.1:
        fail(f"32: eval passes {la} / {lb}, or the reconstructions {d} dB apart (> 0.1)")
    if n_wide != n * 4 or counts["fields"].get("render_pass[pts,wide,S=64]", 0) or \
            counts["eval pass"].get("trunk", 0) != n:
        fail(f"32: B3 wide launched {n_wide} times (want {n * 4}: 2 + 1 + 1 chunks a frame), or level 3 did not "
             "render through its fields alone (B7 once a frame)")
    return counts["eval pass"]


def phase33_fused(dev, tmp, data, scene, pyr_hwf):
    """The fused phase 2: one step over the four levels with fused=True (B6,
    B3's pts mode, B9) against the field-route step (B6, B7), from the same
    weights (phase 24's) and draws (the plain route in float64 the
    reference of the fallback); then run_multires resumed from 000200.tar
    for 100 phase-2 steps under SWNERF_FUSED_MULTIRES=1 and under the
    default (the field route), each through the CLI: every level's weights
    move and its Adam sees gradients (level_moves), and the two routes move
    each level by norms within 2-fold of each other where the level's
    gradients are signal (its fp32 routes agree within 0.1 on 000200.tar's
    weights); and the device's idle share of each step from
    torch.profiler. Returns the fused run's launch counts."""
    import numpy as np
    import torch

    from swnerf_torch.ops.pyramid import generate_laplacian_pyramid
    from swnerf_torch.pipelines import run_multires as mr
    from swnerf_torch.render.core import Draws, RenderConfig, make_draws
    from swnerf_torch.train.checkpoint import dnerf_state_dict, load_tar
    from swnerf_torch.train.loop import init_train_state

    ckpt = load_tar(str(tmp / "mr_logs" / "lego" / f"{MR_CKPT_ITER:06d}.tar"))
    rcfg = RenderConfig(n_samples=64, perturb=1.0, raw_noise_std=1.0, white_bkgd=True)
    images = torch.as_tensor(scene.images, device=dev)
    poses = torch.as_tensor(scene.poses[:, :3, :4], device=dev)
    L, patch_sizes = 4, [32, 16, 8, 4]
    coords = [(10 << (L - 1 - l), 10 << (L - 1 - l)) for l in range(L)]
    with torch.no_grad():
        lap = generate_laplacian_pyramid(images[37:38], levels=L)
    pixels = [torch.stack(torch.meshgrid(torch.arange(y, y + ps, device=dev), torch.arange(x, x + ps, device=dev),
                                         indexing="ij"), -1).reshape(-1, 2) for (y, x), ps in zip(coords, patch_sizes)]
    targets = [lap[l][0, y : y + ps, x : x + ps] for l, ((y, x), ps) in enumerate(zip(coords, patch_sizes))]
    full = images[37, 80:112, 80:112]
    gen = torch.Generator(device=dev).manual_seed(5)
    draws = [make_draws(rcfg, ps * ps, gen, dev) for ps in patch_sizes]

    def models(fused_route, dtype=torch.float32, perturb=False, compute_dtype=torch.float32):
        """Phase 24's weights: per level seeded (10 + level), the
        deformation head scaled by 1e-3. On 000200.tar's saturated levels
        (ROADMAP Queue C) the fp32 deformation gradients of level 0 are
        noise: on an H100 both routes' worst tensor lay 300-600 times its
        norm from the float64 step's, so the bar would compare noise."""
        out = []
        for l in range(L):
            m = mr_level_model(dev, l, seed=10 + l, fused=fused_route, compute_dtype=compute_dtype)
            with torch.no_grad():
                m._time_out.weight.mul_(1e-3)
                m._time_out.bias.mul_(1e-3)
            m = m.to(dtype)
            if perturb:
                with torch.no_grad():
                    for p in m.parameters():
                        p.copy_(jitter(p))
            out.append(m)
        return out

    def step(ms, fused, device=dev, dtype=torch.float32, compute_dtype=None):
        states = [init_train_state(m, None, 5e-4, 250) for m in ms]
        cast = lambda x: None if x is None else x.to(device=device, dtype=dtype)  # noqa: E731
        fn = mr.make_phase2_step(rcfg, pyr_hwf, patch_sizes, scene.near, scene.far, fused=fused,
                                 compute_dtype=compute_dtype)
        m = fn(states, [p.to(device) for p in pixels], [cast(x) for x in targets], cast(full), cast(poses[37]),
               float(scene.times[37]), 1.0, draws=[Draws(cast(d.t_rand), cast(d.noise0), None, None) for d in draws])
        return m, [{k: p.grad.detach().clone() for k, p in s.coarse.named_parameters()} for s in states]

    from swnerf_torch.ops.kernels import launches

    launches.clear()
    mk, gk = step(models(False), True, compute_dtype=torch.float32)
    torch.cuda.synchronize()
    one = dict(launches)
    mf, gf = step(models(None), False)
    m64, g64 = step(models(False, torch.float64), False, dtype=torch.float64)
    m64p, g64p = step(models(False, torch.float64, perturb=True), False, dtype=torch.float64)
    torch.cuda.synchronize()
    lk, lf, l64, l64p = (m["total_loss"].item() for m in (mk, mf, m64, m64p))
    dl = abs(lk - lf) / lf
    print(f"[33 step fp32] launches of the fused step {json.dumps(one, sort_keys=True)}; total_loss fused {lk:.8f} "
          f"field route {lf:.8f} rel {dl:.3e} (global {mk['global_loss'].item():.6f} vs "
          f"{mf['global_loss'].item():.6f}); float64 plain {l64:.8f} (perturbed {l64p:.8f})")
    if one.get("render_loss[ext,wide,S=64]", 0) != 3 or one.get("render_loss[ext,S=64]", 0) != 1:
        fail(f"33: the fused step launched B9 {one} (want once per level)")
    if dl > 1e-5 and abs(lk - l64) > 2 * max(abs(lf - l64), abs(l64p - l64)):
        fail(f"33: fused step loss rel {dl} > 1e-5, and further from the float64 step than fp32 moves it")
    for l in range(L):
        check_fp32_grads(f"33 step fp32 level {l}", gk[l], gf[l], g64[l], g64p[l])
    del gk, gf, g64, g64p
    m16, _ = step(models(False), True)  # the card's default operands: bf16
    d16 = abs(m16["total_loss"].item() - lf) / lf
    print(f"[33 step bf16] total_loss {m16['total_loss'].item():.8f} vs the fp32 field route: rel {d16:.3e}")
    if d16 > 2e-2:
        fail(f"33: bf16 fused step loss rel {d16} > 2e-2")

    # On 000200.tar's own weights the two fp32 routes agree only at the
    # levels whose gradients are signal: at a saturated level they are
    # rounding noise (ROADMAP Queue C), and so are the CLI runs' moves there.
    def tar_models(fused_route):
        out = []
        for l in range(L):
            m = mr_level_model(dev, l, seed=0, fused=fused_route, compute_dtype=torch.float32)
            m.load_state_dict(dnerf_state_dict(ckpt[f"network_fn_{l}"]))
            out.append(m)
        return out

    _, gk = step(tar_models(False), True, compute_dtype=torch.float32)
    _, gf = step(tar_models(None), False)
    agree = [sum((gk[l][k].double() - gf[l][k].double()).norm().item() ** 2 for k in gf[l]) ** 0.5
             / sum(gf[l][k].double().norm().item() ** 2 for k in gf[l]) ** 0.5 for l in range(L)]
    print(f"[33 step fp32, 000200.tar] per level, the fused step's gradients from the field route's (rel L2 over the "
          f"level): {[f'{a:.3e}' for a in agree]}")
    del gk, gf
    torch.cuda.empty_cache()

    # the CLI, resumed from 000200.tar for 100 phase-2 steps (phase 1 skipped), each route from its own copy
    def level_moves(lego):
        """Per level: the L2 norm of the parameters' move from 000200.tar to
        000300.tar, and the norm of Adam's first moment at 000300.tar over
        0.9^100 times its norm at 000200.tar (1 if no gradient came: the
        resumed optimizer state would still move the weights)."""
        a, b = (load_tar(str(lego / f"{i:06d}.tar")) for i in (MR_CKPT_ITER, MR_CKPT_ITER + 100))
        out = []
        for l in range(L):
            pa, pb = a[f"network_fn_{l}"], b[f"network_fn_{l}"]
            move = sum(((pb[k].double() - pa[k].double()) ** 2).sum().item() for k in pa) ** 0.5
            m = [sum((x["exp_avg"].double() ** 2).sum().item() for x in c[f"optimizer_{l}"]["state"].values()) ** 0.5
                 for c in (a, b)]
            out.append((move, m[1] / (0.9**100 * m[0])))
        return out

    res, moves = {}, {}
    for route, mode in (("fused", "1"), ("field", "0")):
        base = tmp / f"mr33_{route}"
        (base / "lego").mkdir(parents=True)
        shutil.copy(tmp / "mr_logs" / "lego" / f"{MR_CKPT_ITER:06d}.tar", base / "lego")
        argv = ["--config", str(MULTIRES_CONFIG), "--basedir", str(base), "--datadir", str(data), "--device",
                "cuda", "--global_optimization_epoch", "100", "--i_testset", "100000", "--i_video", "100000",
                "--i_weights", "100", *MR_NOISE]
        with env(SWNERF_FUSED_MULTIRES=mode, SWNERF_PHASE1_ITERS="0", SWNERF_MAX_ITERS=str(MR_CKPT_ITER + 101)):
            launches.clear()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
                r = mr.train(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(launches)
        recs = [json.loads(line) for line in (base / "lego" / "metrics.jsonl").read_text().splitlines()]
        gpsnr = [(x["step"], round(x["global_psnr"], 3)) for x in recs if "global_psnr" in x]
        totals = [(x["step"], x["total_loss"]) for x in recs if "total_loss" in x]
        quiet = [v for i, v in r["phase2_step_ms"].items() if i % 20 and (i - 1) % 20 and i % 100 and (i - 1) % 100]
        res[route] = (counts, statistics.median(quiet), buf.getvalue())
        print(f"[33 train {route}] launches {json.dumps(counts, sort_keys=True)}, CLI wall {wall:.2f} s; ms per "
              f"phase-2 step, median of {len(quiet)} steps that neither print nor save: {statistics.median(quiet):.3f}"
              f" (min {min(quiet):.3f}, max {max(quiet):.3f}); global PSNR at the prints {gpsnr}; total loss {totals}")
        if not gpsnr or not all(np.isfinite(p) for _, p in gpsnr) or len({v for _, v in totals}) < 2:
            fail(f"33 {route}: the global PSNR is not finite or the loss did not move: {gpsnr}, {totals}")
        if not (base / "lego" / f"{MR_CKPT_ITER + 100:06d}.tar").exists():
            fail(f"33 {route}: no {MR_CKPT_ITER + 100:06d}.tar")
        moves[route] = level_moves(base / "lego")
        print(f"[33 train {route}] per level, |params(300) - params(200)| and Adam's first moment at 300 over the "
              f"0.9^100 of 200's that stale momentum alone leaves: "
              f"{[(f'{mv:.4e}', f'{mo:.3e}') for mv, mo in moves[route]]}")
        if not all(mv > 0 and mo > 10 for mv, mo in moves[route]):
            fail(f"33 {route}: a level did not move, or no gradient reached its Adam: {moves[route]}")
    ratio = [f[0] / g[0] for f, g in zip(moves["fused"], moves["field"])]
    signal = [a < 0.1 for a in agree]
    print(f"[33 train] per level, the fused run's move over the field route's: {[round(r, 4) for r in ratio]}; "
          f"held to 2-fold at the levels whose fp32 routes agree within 0.1 on 000200.tar: {signal}")
    if not any(signal) or not all(0.5 <= r <= 2.0 for r, sg in zip(ratio, signal) if sg):
        fail(f"33: the fused and field runs moved a level with signal gradients by norms more than 2-fold apart, "
             f"or no level has them: {ratio}, {agree}")
    counts = res["fused"][0]
    if "fused phase 2 on levels [0, 1, 2, 3]" not in res["fused"][2] or counts.get("render_loss[ext,wide,S=64]", 0) \
            != 300 or counts.get("render_loss[ext,S=64]", 0) != 100 or res["field"][0].get("render_loss[ext,S=64]"):
        fail(f"33: the fused run launched B9 {counts} (want 300 wide + 100 narrow: once per level per step)")
    print(f"[33 train] ms per phase-2 step: fused {res['fused'][1]:.3f}, field route {res['field'][1]:.3f}")
    phase2_profile(dev, scene, pyr_hwf, ckpt)
    return counts


def phase2_profile(dev, scene, pyr_hwf, ckpt):
    """Device time by kernel family over 10 phase-2 steps on each route
    (after 3 warm-up steps), from torch.profiler, against the host clock
    around the steps: the device's idle share (multires_breakdown's)."""
    import numpy as np
    import torch

    from swnerf_torch.models import make_dnerf_model
    from swnerf_torch.ops.pyramid import generate_laplacian_pyramid
    from swnerf_torch.pipelines import run_multires as mr
    from swnerf_torch.render.core import RenderConfig
    from swnerf_torch.train.checkpoint import dnerf_state_dict
    from swnerf_torch.train.loop import init_train_state

    images = torch.as_tensor(scene.images, device=dev)
    poses = torch.as_tensor(scene.poses[:, :3, :4], device=dev)
    rcfg = RenderConfig(n_samples=64, perturb=1.0, raw_noise_std=1.0, white_bkgd=True)
    with torch.no_grad():
        lap = generate_laplacian_pyramid(images, levels=4)
    patch_sizes = [32, 16, 8, 4]
    families = (("B9 forward", ("render_loss_fwd",)), ("B3 wide / B3 pts forward", ("render_pass_kernel", "render_kernel<")),
                ("B7 forward", ("trunk_fwd",)), ("B6 forward", ("time_net_fwd", "time_net_tc")),
                ("B6 backward, tensor-core products", ("sweep_dw", "sweep_dh")),
                ("backward SIMT GEMMs and reductions", ("gemm_kernel", "reduce_kernel", "colsum", "head_bwd",
                                                        "cotangent_kernel", "round_cotangent", "encode_bwd")))
    for route in (True, False):
        states = []
        for l in range(4):
            cfg = mr._level_cfg(mr_args(), mr.CHANNEL_LIST[l])
            m = make_dnerf_model("direct_temporal", cfg, dev)
            m.load_state_dict(dnerf_state_dict(ckpt[f"network_fn_{l}"]))
            states.append(init_train_state(m, None, 5e-4, 250))
        fn = mr.make_phase2_step(rcfg, pyr_hwf, patch_sizes, scene.near, scene.far, fused=route)
        rng = np.random.default_rng(7)
        gen = torch.Generator(device=dev).manual_seed(7)

        def one(i):
            coords = mr.initialize_patches(rng, pyr_hwf, i)
            img_i = int(rng.choice(scene.i_train))
            pixels = [torch.stack(torch.meshgrid(torch.arange(y, y + ps, device=dev),
                                                 torch.arange(x, x + ps, device=dev), indexing="ij"), -1).reshape(-1, 2)
                      for (y, x), ps in zip(coords, patch_sizes)]
            targets = [lap[l][img_i, y : y + ps, x : x + ps] for l, ((y, x), ps) in enumerate(zip(coords, patch_sizes))]
            y0, x0 = coords[0]
            fn(states, pixels, targets, images[img_i, y0 : y0 + 32, x0 : x0 + 32], poses[img_i],
               float(scene.times[img_i]), 1.0, gen)

        profile_steps("33", f"phase 2, {'fused' if route else 'field route'}", one, families)
        del states
        torch.cuda.empty_cache()


def phase34_b10(dev, tmp, data, psnr5):
    """B10 at phase 3's shape (160,000 rays of test view 0, 63 bins, 128
    samples) on 010000.tar's coarse weights (the coarse B3 pass's): bit-equal
    to B2 + torch.sort for linspace and for sorted random uniforms, the twin
    bit-equal to the kernel, B2's unsorted rows counted; then the serving
    main path under SWNERF_PDF_MERGE=1 (PSNRs equal to phase 5's), 50
    vanilla and 50 D-NeRF kernel steps under the switch (train PSNR at
    phases 9 / 21's floors), and B10's time beside B2 + torch.sort. Returns
    B10's [kernel] row with its launches there."""
    import torch

    from swnerf_torch.ops import sampling
    from swnerf_torch.ops.kernels import launches
    from swnerf_torch.ops.kernels import render_pass as b3
    from swnerf_torch.ops.kernels import sample_pdf as b2
    from swnerf_torch.pipelines import run_dnerf, run_nerf

    cfg, coarse, _ = load_models(dev)
    rays = view0_rays(dev)
    pc = b3.pack_params(coarse.state_dict(), cfg)
    ws, zs = [], []
    for start in range(0, 160_000, 32768):
        o, d, ve, z, dist = pass_inputs(rays.slice(start, min(160_000, start + 32768)), cfg, 64)
        ws.append(b3.render_pass(pc, o, d, ve, z, dist, None, True).weights)
        zs.append(z)
    w64, z64 = torch.cat(ws), torch.cat(zs).contiguous()
    del ws, zs
    n = z64.shape[0]
    bins = (0.5 * (z64[:, 1:] + z64[:, :-1])).contiguous()
    wsl = w64[:, 1:-1]
    err = 0.0
    for mode in ("det", "sorted random"):
        u = (torch.linspace(0.0, 1.0, 128, device=dev).expand(n, 128) if mode == "det"
             else sampling.sorted_uniforms(n, 128, torch.Generator(device=dev).manual_seed(3), dev))
        got = b2.sample_pdf_merge(z64, bins, wsl, u)
        samples = b2.sample_pdf(bins, wsl, u)
        ref = torch.sort(torch.cat([z64, samples], -1), -1).values
        twin = b2.sample_pdf_merge_plain(z64, bins, wsl, u)
        torch.cuda.synchronize()
        unsorted = int((samples[:, 1:] < samples[:, :-1]).any(-1).sum().item())
        print(f"[34 B10 {mode}] N={n} M=63 S=128: bit-equal to B2 + torch.sort={torch.equal(got, ref)}, twin "
              f"bit-equal={torch.equal(twin, got)}; B2 rows not sorted for sorted u: {unsorted} of {n}")
        if not torch.equal(got, ref) or not torch.equal(twin, got):
            fail(f"B10 {mode}: differs from B2 + torch.sort or from its twin")
        err = max(err, (got - ref).abs().max().item())
    u = torch.linspace(0.0, 1.0, 128, device=dev).expand(n, 128)
    frame_ms = cuda_ms(lambda: b2.sample_pdf_merge(z64, bins, wsl, u), 20)
    frame_lib = cuda_ms(lambda: torch.sort(torch.cat([z64, b2.sample_pdf(bins, wsl, u)], -1), -1).values, 20)
    chunk = slice(0, 32768)
    zc, bc, wc, uc = z64[chunk], bins[chunk], wsl[chunk], u[chunk]
    ms = cuda_ms(lambda: b2.sample_pdf_merge(zc, bc, wc, uc), 50)
    plain = cuda_ms(lambda: b2.sample_pdf_merge_plain(zc, bc, wc, uc), 5)
    lib = cuda_ms(lambda: torch.sort(torch.cat([zc, b2.sample_pdf(bc, wc, uc)], -1), -1).values, 50)
    step_rows = {}
    for name, nr in (("vanilla step", 1024), ("D-NeRF step", 500)):
        uu = sampling.sorted_uniforms(nr, 128, torch.Generator(device=dev).manual_seed(4), dev)
        a = (z64[:nr], bins[:nr], wsl[:nr], uu)
        step_rows[name] = (cuda_ms(lambda: b2.sample_pdf_merge(*a), 50),
                           cuda_ms(lambda: torch.sort(torch.cat([a[0], b2.sample_pdf(*a[1:])], -1), -1).values, 50))
    print(f"[34 times] B10 per frame (160,000 rays, one launch) {frame_ms:.3f} ms against B2 + torch.sort "
          f"{frame_lib:.3f} ms; per 32,768-ray chunk {ms:.4f} against {lib:.4f} ms (twin {plain:.3f}); per step "
          + ", ".join(f"{k} {a:.4f} against {b:.4f} ms" for k, (a, b) in step_rows.items()))
    nc = zc.shape[0]
    row = entry("sample_pdf_merge", "swnerf_torch/csrc/sample_pdf.cu", "swnerf_tpu/ops/pallas/sample_pdf.py:155",
                0, err, ms, plain, 4 * (nc * 63 + nc * 62 + 128 + nc * 64 + nc * 192), nc * 128 * 63, "fp32")
    row["library_ms"] = lib
    del z64, bins, w64, u
    torch.cuda.empty_cache()

    # the serving main path under the switch: det uniforms make z_all, and so every PSNR, bit-equal
    base = tmp / "pdf_merge"
    argv = ["--config", str(CONFIG), "--render_only", "--render_test", "--testskip", "5", "--device", "cuda",
            "--basedir", str(base), "--datadir", str(DATADIR), "--ft_path", str(CKPT)]
    with env(SWNERF_PDF_MERGE="1"):
        launches.clear()
        metrics = json.loads((Path(run_nerf.main(argv)) / "metrics.json").read_text())
        serve = dict(launches)
    print(f"[34 serve] SWNERF_PDF_MERGE=1: launches {json.dumps(serve, sort_keys=True)} (5 frames); PSNR "
          f"{metrics['psnr']} against phase 5's {psnr5}")
    if metrics["psnr"] != psnr5 or serve.get("sample_pdf_merge", 0) != 25 or serve.get("sample_pdf", 0):
        fail("34: the PSNRs under SWNERF_PDF_MERGE=1 differ from phase 5's, or B10 did not replace B2 (25 launches)")
    # 50 vanilla and 50 D-NeRF kernel steps under the switch
    counts = {}
    with env(SWNERF_PDF_MERGE="1", SWNERF_MAX_ITERS="10051"):
        launches.clear()
        res = run_nerf.main(["--config", str(CONFIG), "--ft_path", str(CKPT), "--basedir", str(base), "--datadir",
                             str(DATADIR), "--device", "cuda", "--i_print", "25", "--i_weights", "100000"])
        counts["vanilla"] = dict(launches)
    recs = [json.loads(x) for x in (base / "full_nerf_200k" / "metrics.jsonl").read_text().splitlines()]
    pv = [(r["step"], round(r["psnr"], 3)) for r in recs if "psnr" in r]
    exp = base / "logs" / "full_dnerf_800k"
    exp.mkdir(parents=True)
    shutil.copy(DNERF_CKPT, exp / "800000.tar")
    with env(SWNERF_PDF_MERGE="1", SWNERF_MAX_ITERS="800051"):
        launches.clear()
        res_d = run_dnerf.main(["--config", str(DNERF_CONFIG), "--basedir", str(base / "logs"), "--datadir",
                                str(data), "--device", "cuda", "--i_print", "25", "--i_weights", "100000"])
        counts["dnerf"] = dict(launches)
    recs = [json.loads(x) for x in (exp / "metrics.jsonl").read_text().splitlines()]
    pd = [(r["step"], round(r["psnr"], 3)) for r in recs if "psnr" in r]
    med = {k: statistics.median(v for i, v in r["step_ms"].items() if i % 25 and (i - 1) % 25)
           for k, r in (("vanilla", res), ("dnerf", res_d))}
    print(f"[34 train] SWNERF_PDF_MERGE=1: vanilla launches {json.dumps(counts['vanilla'], sort_keys=True)}, train "
          f"PSNR {pv}, {med['vanilla']:.3f} ms per step; D-NeRF launches {json.dumps(counts['dnerf'], sort_keys=True)}"
          f", train PSNR {pd}, {med['dnerf']:.3f} ms per step")
    if len(pv) != 2 or min(p for _, p in pv) < 30.0 or len(pd) != 2 or min(p for _, p in pd) < 34.0:
        fail(f"34: train PSNR under SWNERF_PDF_MERGE=1 below the floors (30 / 34 dB): {pv}, {pd}")
    if any(c.get("sample_pdf_merge", 0) != 50 or c.get("sample_pdf", 0) for c in counts.values()):
        fail(f"34: the steps under SWNERF_PDF_MERGE=1 launched B10 / B2 {counts} (want 50 B10 each, no B2)")
    row["launches"] = serve["sample_pdf_merge"] + sum(c["sample_pdf_merge"] for c in counts.values())
    return {"sample_pdf_merge": row}


def phase35_b11(dev, data):
    """B11 (fused_time_net_pts with input cotangents) against its twin with
    the D-NeRF 800000.tar deformation weights on phase 17's points (500
    rays x 64 and x 192) and at MultiRes level 0's widths (seeded weights,
    500 rays x 64): dx bit-equal to B6's forward; fp32 gradients, d pts and
    d times at phase 17's bar; bf16 rel L2 1e-2; times. Its entry point has
    no product caller: this phase drives it, each point set once, and those
    launches are its row's. Returns B11's [kernel] row."""
    import dataclasses

    import torch

    from swnerf_torch.models import DirectTemporalNeRF
    from swnerf_torch.ops.kernels import launches
    from swnerf_torch.ops.kernels import time_net as b6
    from swnerf_torch.pipelines.run_dnerf import _model_config
    from swnerf_torch.train.checkpoint import dnerf_state_dict, load_tar
    from swnerf_torch.utils.config import config_parser_dnerf

    args = config_parser_dnerf().parse_args(["--config", str(DNERF_CONFIG)])
    cfg = _model_config(args, args.netdepth, args.netwidth)
    sd = dnerf_state_dict(load_tar(str(DNERF_CKPT))["network_fn_state_dict"])
    sd = {k: v.to(dev) for k, v in sd.items()}
    inputs = dnerf_train_inputs(dev, cfg, sd, data)
    lvl0 = mr_level_model(dev, 0, seed=35, fused=False)
    g = torch.Generator(device=dev).manual_seed(11)
    rays, _ = frame_rays(dev, data, "train", 37)
    sel = torch.randint(0, rays.origins.shape[0], (500,), generator=g, device=dev)
    from swnerf_torch.ops.sampling import sample_along_rays

    r = type(rays)(*(x[sel] for x in rays))
    z = sample_along_rays(r.near, r.far, 64, 1.0, generator=g)
    cases = [(f"D-NeRF S={S}", cfg, sd, inputs[S][0], inputs["times"]) for S in (64, 192)]
    cases.append(("MultiRes level 0", lvl0.cfg, lvl0.state_dict(),
                  (r.origins[:, None, :] + r.directions[:, None, :] * z[..., None]).contiguous(),
                  r.times.reshape(-1).contiguous()))
    cots = [torch.randn(c[3].shape, generator=g, device=dev) for c in cases]

    def drive(packed, pts, times, cot, dtype):
        leaf = dataclasses.replace(packed, weights=packed.weights.detach().float().clone().requires_grad_(True),
                                   biases=packed.biases.detach().clone().requires_grad_(True))
        p, t = pts.clone().requires_grad_(True), times.clone().requires_grad_(True)
        dx = b6.fused_time_net_pts(leaf, p, t, need_input_grads=True, dtype=dtype)
        (dx * cot).sum().backward()
        return dx.detach(), (leaf.weights.grad, leaf.biases.grad), p.grad, t.grad

    launches.clear()  # the path: the entry point, once per point set (bf16, the card's operands)
    for (_, c, s, pts, times), cot in zip(cases, cots):
        drive(b6.pack_time_params(s, c, torch.float32), pts, times, cot, torch.bfloat16)
    torch.cuda.synchronize()
    path = dict(launches)
    print(f"[35 B11 path] launches {json.dumps(path, sort_keys=True)}")
    if path.get("time_net[pts,bwd]", 0) != 3 or path.get("time_net", 0) != 3 or path.get("time_net[bwd]", 0):
        fail(f"35: fused_time_net_pts launched {path} (want B6's forward and B11's backward 3 times each)")

    def named(grads, dpts, dtimes, pk):
        return dict(b6.unpack_time_grads(grads, pk), dpts=dpts, dtimes=dtimes)

    err16, row = 0.0, None
    for (tag, c, s, pts, times), cot in zip(cases, cots):
        p32 = b6.pack_time_params(s, c, torch.float32)
        dx, gk, dpk, dtk = drive(p32, pts, times, cot, torch.float32)
        dx2, gk2, dpk2, dtk2 = drive(p32, pts, times, cot, torch.float32)
        ref = b6.time_net_plain_bwd(p32, pts, times, cot, True)
        p64 = dataclasses.replace(p32, weights=p32.weights.double())
        r64 = b6.time_net_plain_bwd(p64, pts.double(), times.double(), cot.double(), True)
        r64p = b6.time_net_plain_bwd(dataclasses.replace(p64, weights=jitter(p64.weights)), pts.double(),
                                     times.double(), cot.double(), True)
        torch.cuda.synchronize()
        fwd_same = torch.equal(dx, b6.time_net(p32, pts, times))
        same = all(torch.equal(a, b) for a, b in zip((*gk, dpk, dtk), (*gk2, dpk2, dtk2)))
        print(f"[35 B11 fp32 {tag}] {p32.cin} of {p32.cin_pad} rows: dx bit-equal to B6's forward={fwd_same}, "
              f"repeat bit-equal={same}, max|ddpts|={(dpk - ref[1]).abs().max().item():.3e} (max|dpts| "
              f"{ref[1].abs().max().item():.3e}), max|ddtimes|={(dtk - ref[2]).abs().max().item():.3e} (max|dtimes| "
              f"{ref[2].abs().max().item():.3e})")
        if not fwd_same or not same:
            fail(f"B11 fp32 {tag}: dx differs from B6's forward or repeats differ")
        check_fp32_grads(f"35 B11 fp32 {tag}", named(gk, dpk, dtk, p32), named(*ref, p32), named(*r64, p64),
                         named(*r64p, p64))
        del r64, r64p
        p16 = b6.pack_time_params(s, c, torch.bfloat16)
        dx16, gk, dpk, dtk = drive(p16, pts, times, cot, torch.bfloat16)
        ref = b6.time_net_plain_bwd(p16, pts, times, cot, True)
        torch.cuda.synchronize()
        rel = rel_l2(named(gk, dpk, dtk, p16), named(*ref, p16))
        print(f"[35 B11 bf16 {tag}] max|ddx|={(dx16 - b6.time_net_plain(p16, pts, times)).abs().max().item():.3e} "
              f"grads, dpts, dtimes max rel L2={max(rel.values()):.3e} ({max(rel, key=rel.get)})")
        if max(rel.values()) > 1e-2:
            fail(f"B11 bf16 {tag}: gradient rel L2 > 1e-2")
        err16 = max(err16, (dx16 - b6.time_net_plain(p16, pts, times)).abs().max().item())
        if tag == "D-NeRF S=192":  # the row: the TV pair's rows of the D-NeRF step, as B6's backward row
            M = pts.shape[0] * pts.shape[1]
            sc = b6._din_scratch(p16, M, dev)
            b6._launch_fwd(p16, pts, times, sc)
            g2 = cot.reshape(M, 3).contiguous()
            ms = cuda_ms(lambda: b6._launch_bwd_din(p16, pts, times, g2, sc), 10)
            b6ms = cuda_ms(lambda: b6._launch_bwd(p16, M, g2, sc), 10)
            plain = cuda_ms(lambda: b6.time_net_plain_bwd(p16, pts, times, cot, True), 3)
            nw, nb = p16.weights.numel(), p16.biases.numel()
            row = entry("time_net[pts,bwd]", "swnerf_torch/csrc/time_net.cu", "swnerf_tpu/ops/pallas/raymarch.py:519",
                        0, err16, ms, plain, 4 * (3 * M + pts.shape[0] + 3 * M) + 2 * nw + 4 * (nw + nb + 3 * M
                                                                                              + pts.shape[0]),
                        2 * p16.din_macs_per_row * M, "bf16")
            print(f"[35 times] B11 backward, {M} rows ({p16.din_macs_per_row} MACs per row): {ms:.3f} ms "
                  f"({2 * p16.din_macs_per_row * M / ms / 1e9:.2f} TFLOP/s) against B6's backward {b6ms:.3f} ms "
                  f"(no input cotangent); twin {plain:.3f} ms")
            del sc
        torch.cuda.empty_cache()
    row["launches"] = path["time_net[pts,bwd]"]
    row["max_abs_err"] = err16
    return {"time_net[pts,bwd]": row}


if __name__ == "__main__":
    sys.exit(main())
