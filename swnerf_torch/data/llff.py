"""LLFF forward-facing (or 360) capture loader (port of
``swnerf_tpu/data/llff.py``, numpy only).

``poses_bounds.npy`` holds per image a 3x5 [down, right, back | t | hwf]
matrix and [near, far] depth bounds. At ``factor`` > 1 the images come from
the ``images_{factor}/`` cache, which :func:`_minify` builds from
``images/`` with an area resize and writes as PNG (the reference's
``mogrify`` writes the same layout, so either cache is reused). Then the
column reorder, the ``bd_factor`` rescale, recentering, spherify for 360
captures, the spiral render path and the holdout view nearest the mean.

Images are read with ``utils/images.py::read_images``: PNG with
``utils/png.py``, JPEG (real captures ship ``images/`` as JPEG) through
cv2, where a missing cv2 raises ``NotImplementedError``. The cache is
written as PNG either way, as the JAX ``_minify`` writes it.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from swnerf_torch.data.cameras import normalize, poses_avg, recenter_poses, render_path_spiral, spherify_poses
from swnerf_torch.utils.images import area_resize, list_images, read_images
from swnerf_torch.utils.png import write_png_bytes


def _minify(basedir: str, factor: int) -> str:
    """Build (or reuse) the ``images_{factor}/`` cache: each image of
    ``images/`` area-resized to (W // factor, H // factor), as PNG."""
    imgdir = os.path.join(basedir, f"images_{factor}")
    if os.path.exists(imgdir):
        return imgdir
    srcs = list_images(os.path.join(basedir, "images"))
    imgs = read_images(srcs)
    os.makedirs(imgdir)
    for src, img in zip(srcs, imgs):
        H, W = img.shape[:2]
        name = os.path.splitext(os.path.basename(src))[0] + ".png"
        write_png_bytes(os.path.join(imgdir, name), area_resize(img, (W // factor, H // factor)))
    return imgdir


def _load_data(basedir: str, factor: Optional[int] = None):
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = poses_arr[:, -2:].transpose([1, 0])

    if factor is not None and factor != 1:
        imgdir = _minify(basedir, factor)
    else:
        factor = 1
        imgdir = os.path.join(basedir, "images")

    imgfiles = list_images(imgdir)
    if poses.shape[-1] != len(imgfiles):
        raise ValueError(f"Mismatch between imgs {len(imgfiles)} and poses {poses.shape[-1]}")

    raw = read_images(imgfiles)
    poses[:2, 4, :] = np.array(raw[0].shape[:2]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] * 1.0 / factor

    imgs = np.stack([img[..., :3] / 255.0 for img in raw], -1)
    return poses, bds, imgs


def load_llff_data(
    basedir: str,
    factor: int = 8,
    recenter: bool = True,
    bd_factor: Optional[float] = 0.75,
    spherify: bool = False,
    path_zflat: bool = False,
):
    """Returns (images [N, H, W, 3], poses [N, 3, 5] with the hwf column,
    bds [N, 2], render_poses, i_test: the view nearest the mean pose)."""
    poses, bds, imgs = _load_data(basedir, factor=factor)

    # [down, right, back] -> [right, up, back], the image axis first.
    poses = np.concatenate([poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    images = np.moveaxis(imgs, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds = bds * sc

    if recenter:
        poses = recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = spherify_poses(poses, bds)
    else:
        c2w = poses_avg(poses)
        up = normalize(poses[:, :3, 1].sum(0))

        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)

        tt = poses[:, :3, 3]
        rads = np.percentile(np.abs(tt), 90, 0)
        c2w_path = c2w
        n_views, n_rots = 120, 2
        if path_zflat:
            zloc = -close_depth * 0.1
            c2w_path[:3, 3] = c2w_path[:3, 3] + zloc * c2w_path[:3, 2]
            rads[2] = 0.0
            n_rots, n_views = 1, n_views // 2
        render_poses = render_path_spiral(c2w_path, up, rads, focal, zrate=0.5, rots=n_rots, n=n_views)

    render_poses = np.array(render_poses).astype(np.float32)

    c2w = poses_avg(poses)
    dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
    i_test = int(np.argmin(dists))

    return images.astype(np.float32), poses.astype(np.float32), bds, render_poses, i_test
