"""Shared pipeline machinery (port of ``swnerf_tpu/pipelines/common.py``):
dataset dispatch, path rendering and the eval-metrics dump of
``--render_only``. This slice loads Blender scenes; the other loaders, the
ray samplers of training and the mp4 writer are later slices (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from swnerf_torch.render.core import RenderConfig, make_rays_from_camera, render_image
from swnerf_torch.utils.media import write_png
from swnerf_torch.utils.metrics import LPIPS_UNAVAILABLE_NOTE, calculate_metrics


@dataclasses.dataclass
class Scene:
    """Loaded dataset + camera/bounds metadata."""

    images: np.ndarray  # [N, H, W, 3] float32 (already background-composited)
    poses: np.ndarray  # [N, 4, 4]
    render_poses: np.ndarray
    H: int
    W: int
    focal: float
    K: np.ndarray  # [3, 3]
    near: float
    far: float
    i_train: np.ndarray
    i_val: np.ndarray
    i_test: np.ndarray
    ndc: bool = False


def _composite_background(images: np.ndarray, white_bkgd: bool) -> np.ndarray:
    if images.shape[-1] == 4:
        if white_bkgd:
            return images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
        return images[..., :3]
    return images


def load_scene(args) -> Scene:
    """Dataset dispatch (reference run.py:431-511); Blender only so far."""
    if args.dataset_type != "blender":
        raise NotImplementedError(
            f"dataset_type {args.dataset_type!r} is not ported yet (ROADMAP.md Queue A, other loaders)"
        )
    from swnerf_torch.data.blender import load_blender_data

    images, poses, render_poses, hwf, (i_train, i_val, i_test) = load_blender_data(
        args.datadir, args.half_res, args.testskip
    )
    images = _composite_background(images, args.white_bkgd)
    H, W, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
    K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]], dtype=np.float64)
    if getattr(args, "render_test", False):
        render_poses = np.array(poses[i_test])
    return Scene(
        images=np.asarray(images, np.float32),
        poses=np.asarray(poses, np.float32),
        render_poses=np.asarray(render_poses, np.float32),
        H=H, W=W, focal=focal, K=K, near=2.0, far=6.0,
        i_train=np.asarray(i_train), i_val=np.asarray(i_val), i_test=np.asarray(i_test),
    )


def render_path(
    model,
    fine_model,
    poses: np.ndarray,
    scene: Scene,
    cfg: RenderConfig,
    chunk: int,
    savedir: Optional[str] = None,
    render_factor: int = 0,
    eval_pass=None,
) -> Tuple[np.ndarray, np.ndarray, List[float]]:
    """Render a pose path (reference render_path run.py:172-219) on the
    model's device. Returns (rgbs [T, H, W, 3], disps [T, H, W], seconds per
    frame); on a card each frame is timed between two synchronizations."""
    H, W, K = scene.H, scene.W, scene.K.copy()
    if render_factor != 0:
        H, W = H // render_factor, W // render_factor
        K = K / render_factor
        K[2, 2] = 1.0
    device = next(model.parameters()).device
    ecfg = cfg.eval_mode()
    rgbs, disps, seconds = [], [], []
    for i, c2w in enumerate(poses):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        rays = make_rays_from_camera(
            H, W, K, c2w[:3, :4], scene.near, scene.far, use_viewdirs=ecfg.use_viewdirs, ndc=scene.ndc,
            device=device,
        )
        out = render_image(model, rays, ecfg, chunk=chunk, fine_model=fine_model, eval_pass=eval_pass)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - t0)
        rgb = out["rgb"].reshape(H, W, 3).cpu().numpy()
        disp = out["disp"].reshape(H, W).cpu().numpy()
        rgbs.append(rgb)
        disps.append(disp)
        if savedir is not None:
            write_png(os.path.join(savedir, f"{i:03d}.png"), rgb)
        print(f"render_path {i}/{len(poses)} {seconds[-1]:.3f}s", flush=True)
    return np.stack(rgbs), np.stack(disps), seconds


def render_only(model, fine_model, scene: Scene, cfg: RenderConfig, args, start: int, eval_pass=None) -> str:
    """The --render_only path (run.py:557-596): render the test poses or
    the spiral path, write PNGs, and metrics.json when the ground truth is
    known. metrics.json also records each frame's render seconds."""
    suffix = "test" if args.render_test else "path"
    savedir = os.path.join(args.basedir, args.expname, f"renderonly_{suffix}_{start:06d}")
    os.makedirs(savedir, exist_ok=True)
    rgbs, _, seconds = render_path(
        model, fine_model, scene.render_poses, scene, cfg, chunk=args.chunk, savedir=savedir,
        render_factor=args.render_factor, eval_pass=eval_pass,
    )
    payload = {"seconds_per_frame": seconds}
    if args.render_test and args.render_factor == 0:
        gt = scene.images[scene.i_test]
        metrics = [calculate_metrics(g, p) for g, p in zip(gt, rgbs)]
        payload.update(
            psnr=[m[0] for m in metrics], ssim=[m[1] for m in metrics], lpips=[m[2] for m in metrics],
            lpips_note=LPIPS_UNAVAILABLE_NOTE,
        )
    with open(os.path.join(savedir, "metrics.json"), "w") as f:
        json.dump(payload, f, indent=4)
    return savedir
