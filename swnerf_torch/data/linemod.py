"""LINEMOD dataset loader (port of ``swnerf_tpu/data/linemod.py``, numpy
only).

Per-split transforms_{split}.json with absolute ``file_path`` entries, K
from the test split's first ``intrinsic_matrix``, near / far the floor /
ceil over the train and test splits' metadata, a 40-pose orbit as the
render path, the testskip stride on val and test.

Under ``half_res`` the port departs from the JAX loader in two places,
both recorded as its defects (ROADMAP.md Queue C): K is halved with the
images (the JAX loader halves the focal but returns the full-resolution
K, which the trainer then uses), and the images keep their channels (the
JAX loader resizes into a 3-channel buffer, so RGBA frames fail there).
"""

from __future__ import annotations

import json
import os

import numpy as np

from swnerf_torch.data.cameras import spherical_orbit
from swnerf_torch.utils.images import area_resize, read_images


def load_linemod_data(basedir: str, half_res: bool = False, testskip: int = 1):
    """Returns (imgs [N, H, W, C], poses [N, 4, 4], render_poses,
    [H, W, focal], K [3, 3], i_split, near, far)."""
    metas = {}
    for s in ("train", "val", "test"):
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            metas[s] = json.load(fp)

    all_imgs, all_poses, counts = [], [], [0]
    for s in ("train", "val", "test"):
        skip = 1 if (s == "train" or testskip == 0) else testskip
        frames = metas[s]["frames"][::skip]
        imgs = (np.array(read_images([frame["file_path"] for frame in frames])) / 255.0).astype(np.float32)
        poses = np.array([np.array(frame["transform_matrix"]) for frame in frames]).astype(np.float32)
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(poses)

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)

    H, W = imgs[0].shape[:2]
    K = np.array(metas["test"]["frames"][0]["intrinsic_matrix"], dtype=np.float64)
    focal = float(K[0][0])

    render_poses = spherical_orbit(40)

    if half_res:
        H, W, focal = H // 2, W // 2, focal / 2.0
        K = K.copy()
        K[:2, :] /= 2.0
        imgs = np.stack([area_resize(img, (W, H)) for img in imgs]).astype(np.float32)

    near = float(np.floor(min(metas["train"]["near"], metas["test"]["near"])))
    far = float(np.ceil(max(metas["train"]["far"], metas["test"]["far"])))
    return imgs, poses, render_poses, [H, W, focal], K, i_split, near, far
