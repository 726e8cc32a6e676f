"""Blender synthetic dataset loaders (port of ``swnerf_tpu/data/blender.py``).

Static (``:90-117`` there): transforms_{split}.json (or an 80/10/10 split
of one transforms.json), RGBA / 255, focal from camera_angle_x, a 360-pose
render path, testskip stride on val/test. Dynamic (``:120-160``): the same
with a per-frame ``time`` (default: a linspace over the split), times that
must start at 0, ``testskip`` on every split (the reference's quirk, kept),
and a render path from transforms_render.json or a 40-pose orbit with
render times ``linspace(0, 1)``.

PNGs are decoded by the port's own reader (``utils/png.py``), not imageio.
``half_res`` resizes each image to (W // 2, H // 2) with
``utils/images.py::area_resize``: cv2's INTER_AREA where cv2 imports, as the
JAX loader's ``_resize_area``, else its numpy twin, which gives cv2's bytes
where H and W are even (an odd size takes its float64 fractional path).
"""

from __future__ import annotations

import json
import os

import numpy as np

from swnerf_torch.data.cameras import spherical_orbit
from swnerf_torch.utils.images import area_resize
from swnerf_torch.utils.png import read_pngs


def _read_split_metas(basedir: str):
    metas = {}
    for s in ("train", "val", "test"):
        path = os.path.join(basedir, f"transforms_{s}.json")
        if os.path.exists(path):
            with open(path) as fp:
                metas[s] = json.load(fp)
        else:
            metas[s] = None
    if all(m is None for m in metas.values()):
        with open(os.path.join(basedir, "transforms.json")) as fp:
            meta = json.load(fp)
        frames = meta["frames"]
        n = len(frames)
        a, b = int(0.8 * n), int(0.9 * n)
        shared = {k: v for k, v in meta.items() if k != "frames"}
        metas = {
            "train": {**shared, "frames": frames[:a]},
            "val": {**shared, "frames": frames[a:b]},
            "test": {**shared, "frames": frames[b:]},
        }
    return metas


def _load_frames(basedir: str, frames):
    imgs = read_pngs([os.path.join(basedir, frame["file_path"] + ".png") for frame in frames])
    poses = [np.array(frame["transform_matrix"]) for frame in frames]
    return (np.array(imgs) / 255.0).astype(np.float32), np.array(poses).astype(np.float32)


def _frame_times(frames) -> np.ndarray:
    denom = max(len(frames) - 1, 1)
    return np.array([frame.get("time", float(t) / denom) for t, frame in enumerate(frames)], dtype=np.float32)


def _half_res(imgs: np.ndarray, H: int, W: int, focal: float):
    H, W, focal = H // 2, W // 2, focal / 2.0
    return np.stack([area_resize(img, (W, H)) for img in imgs]).astype(np.float32), H, W, focal


def load_blender_data(basedir: str, half_res: bool = False, testskip: int = 1):
    """Returns (imgs [N, H, W, 4], poses [N, 4, 4], render_poses,
    [H, W, focal], i_split)."""
    metas = _read_split_metas(basedir)
    all_imgs, all_poses, counts = [], [], [0]
    meta = None
    for s in ("train", "val", "test"):
        meta = metas[s]
        skip = 1 if (s == "train" or testskip == 0) else testskip
        imgs, poses = _load_frames(basedir, meta["frames"][::skip])
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(poses)

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)

    H, W = imgs[0].shape[:2]
    camera_angle_x = float(meta["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
    render_poses = spherical_orbit(360)

    if half_res:
        imgs, H, W, focal = _half_res(imgs, H, W, focal)

    return imgs, poses, render_poses, [H, W, focal], i_split


def load_blender_dynamic_data(basedir: str, half_res: bool = False, testskip: int = 1):
    """Returns (imgs [N, H, W, 4], poses [N, 4, 4], times [N],
    render_poses, render_times, [H, W, focal], i_split)."""
    metas = _read_split_metas(basedir)
    all_imgs, all_poses, all_times, counts = [], [], [], [0]
    meta = None
    for s in ("train", "val", "test"):
        meta = metas[s]
        frames = meta["frames"][::testskip]
        imgs, poses = _load_frames(basedir, frames)
        times = _frame_times(frames)
        if times[0] != 0:
            raise ValueError(f"{s} split: time must start at 0, got {times[0]}")
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(poses)
        all_times.append(times)

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)
    times = np.concatenate(all_times, 0)

    H, W = imgs[0].shape[:2]
    camera_angle_x = float(meta["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)

    render_path = os.path.join(basedir, "transforms_render.json")
    if os.path.exists(render_path):
        with open(render_path) as fp:
            rmeta = json.load(fp)
        render_poses = np.array([np.array(f["transform_matrix"]) for f in rmeta["frames"]], dtype=np.float32)
    else:
        render_poses = spherical_orbit(40)
    render_times = np.linspace(0.0, 1.0, render_poses.shape[0]).astype(np.float32)

    if half_res:
        imgs, H, W, focal = _half_res(imgs, H, W, focal)

    return imgs, poses, times, render_poses, render_times, [H, W, focal], i_split
