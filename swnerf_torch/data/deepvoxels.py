"""DeepVoxels dataset loader (port of ``swnerf_tpu/data/deepvoxels.py``,
numpy only).

``{train,validation,test}/<scene>/``: an intrinsics.txt (focal and centre
rescaled to the 512-pixel target side), one 4x4 pose per .txt file (the y
and z axes flipped), rgb/*.png; the testskip stride on validation and test;
the test poses as the render path.
"""

from __future__ import annotations

import os

import numpy as np

from swnerf_torch.utils.images import read_images


def _parse_intrinsics(filepath: str, trgt_sidelength: int):
    with open(filepath) as f:
        focal, cx, cy = list(map(float, f.readline().split()))[:3]
        grid_barycenter = np.array(list(map(float, f.readline().split())))
        near_plane = float(f.readline())
        scale = float(f.readline())
        height, width = map(float, f.readline().split())
        try:
            world2cam = bool(int(f.readline()))
        except (ValueError, TypeError):
            world2cam = False

    cx = cx / width * trgt_sidelength
    cy = cy / height * trgt_sidelength
    focal = trgt_sidelength / height * focal
    full_intrinsic = np.array([[focal, 0.0, cx, 0.0], [0.0, focal, cy, 0.0], [0.0, 0.0, 1, 0], [0, 0, 0, 1]])
    return full_intrinsic, grid_barycenter, scale, near_plane, world2cam


def _dir2poses(posedir: str) -> np.ndarray:
    flip = np.array([[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1.0]])
    poses = []
    for f in sorted(os.listdir(posedir)):
        if not f.endswith("txt"):
            continue
        with open(os.path.join(posedir, f)) as fp:
            nums = fp.read().split()
        poses.append(np.array([float(x) for x in nums]).reshape(4, 4))
    poses = np.stack(poses, 0) @ flip
    return poses[:, :3, :4].astype(np.float32)


def _load_rgb_dir(d: str, stride: int = 1) -> np.ndarray:
    files = [os.path.join(d, f) for f in sorted(os.listdir(d)) if f.endswith("png")]
    return (np.stack(read_images(files[::stride]), 0) / 255.0).astype(np.float32)


def load_dv_data(scene: str = "cube", basedir: str = "/data/deepvoxels", testskip: int = 8):
    """Returns (imgs [N, 512, 512, C], poses [N, 3, 4], render_poses,
    [H, W, focal], i_split)."""
    H = W = 512
    base = os.path.join(basedir, "train", scene)

    full_intrinsic, _, _, _, _ = _parse_intrinsics(os.path.join(base, "intrinsics.txt"), H)
    focal = full_intrinsic[0, 0]

    poses = _dir2poses(os.path.join(base, "pose"))
    testposes = _dir2poses(os.path.join(basedir, "test", scene, "pose"))[::testskip]
    valposes = _dir2poses(os.path.join(basedir, "validation", scene, "pose"))[::testskip]

    imgs = _load_rgb_dir(os.path.join(base, "rgb"))
    testimgs = _load_rgb_dir(os.path.join(basedir, "test", scene, "rgb"), testskip)
    valimgs = _load_rgb_dir(os.path.join(basedir, "validation", scene, "rgb"), testskip)

    all_imgs = [imgs, valimgs, testimgs]
    counts = np.cumsum([0] + [x.shape[0] for x in all_imgs])
    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]

    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate([poses, valposes, testposes], 0)
    render_poses = testposes
    return imgs, poses, render_poses, [H, W, focal], i_split
