"""Custom ("SW" capture) dataset loader (port of ``swnerf_tpu/data/custom.py``,
numpy only).

One transforms.json with ``fl_x`` / ``fl_y`` / ``cx`` / ``cy`` intrinsics
and ``file_path`` entries with their extension; an 80/10/10 split of the
frames shuffled by ``random.Random(seed)`` (the JAX loader's seeded split:
the same seed gives the same split); RGB padded to RGBA; under ``half_res``
the images area-resized to half and the intrinsics halved; a z-up orbit as
the render path.
"""

from __future__ import annotations

import json
import os
import random

import numpy as np

from swnerf_torch.data.cameras import spherical_orbit
from swnerf_torch.utils.images import area_resize, read_images


def load_custom_data(basedir: str, half_res: bool = False, testskip: int = 1, seed: int = 0):
    """Returns (imgs [N, H, W, 4], poses [N, 4, 4], render_poses, K [3, 3],
    [H, W, (fl_x + fl_y) / 2], i_split)."""
    with open(os.path.join(basedir, "transforms.json")) as fp:
        meta = json.load(fp)

    frames = list(meta["frames"])
    random.Random(seed).shuffle(frames)

    n = len(frames)
    a = int(0.8 * n)
    b = a + int(0.1 * n)
    splits = {"train": frames[:a], "val": frames[a:b], "test": frames[b:]}

    all_imgs, all_poses, counts = [], [], [0]
    for s in ("train", "val", "test"):
        skip = testskip if s == "test" else 1
        chosen = splits[s][::skip]
        imgs = []
        for img in read_images([os.path.join(basedir, frame["file_path"]) for frame in chosen]):
            if img.shape[-1] == 3:
                img = np.concatenate([img, np.full((*img.shape[:2], 1), 255, dtype=img.dtype)], axis=-1)
            imgs.append(img)
        imgs = (np.array(imgs) / 255.0).astype(np.float32)
        poses = np.array([np.array(frame["transform_matrix"]) for frame in chosen]).astype(np.float32)
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(poses)

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)

    H, W = imgs[0].shape[:2]
    fl_x, fl_y = meta["fl_x"], meta["fl_y"]
    cx, cy = meta["cx"], meta["cy"]

    if half_res:
        H, W = H // 2, W // 2
        fl_x, fl_y, cx, cy = fl_x / 2.0, fl_y / 2.0, cx / 2.0, cy / 2.0
        imgs = np.stack([area_resize(img, (W, H)) for img in imgs]).astype(np.float32)

    K = np.array([[fl_x, 0, cx], [0, fl_y, cy], [0, 0, 1]])
    render_poses = spherical_orbit(360, z_up=True)
    return imgs, poses, render_poses, K, [H, W, (fl_x + fl_y) * 0.5], i_split
