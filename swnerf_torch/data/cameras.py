"""Camera path helpers (port of ``swnerf_tpu/data/cameras.py``, numpy
only): the 360-degree spherical orbit of the Blender, LINEMOD and custom
loaders, and the LLFF average-pose, recenter, spiral and spherify
machinery."""

from __future__ import annotations

import numpy as np


def _trans_t(t: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def _rot_phi(phi: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(phi), np.sin(phi)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def _rot_theta(th: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(th), np.sin(th)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, -s, s, c
    return m


_FLIP_YUP = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float32)
_FLIP_ZUP = np.array([[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]], dtype=np.float32)


def pose_spherical(theta: float, phi: float, radius: float, z_up: bool = False) -> np.ndarray:
    """Camera-to-world at (theta, phi) degrees on a radius-R orbit
    (``z_up=False``: the Blender convention)."""
    c2w = _trans_t(radius)
    c2w = _rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta / 180.0 * np.pi) @ c2w
    return (_FLIP_ZUP if z_up else _FLIP_YUP) @ c2w


def spherical_orbit(n: int, phi: float = -30.0, radius: float = 4.0, z_up: bool = False) -> np.ndarray:
    """n poses over a full orbit (the loaders' render_poses paths)."""
    thetas = np.linspace(-180.0, 180.0, n + 1)[:-1]
    return np.stack([pose_spherical(t, phi, radius, z_up) for t in thetas])


# ----------------------------------------------------------------------------
# LLFF pose machinery (``swnerf_tpu/data/cameras.py:76-183``, after the
# Fyusion/LLFF recipe that the reference's load_llff.py:126-241 vendors; its
# constants, such as the [0.1, 0.2, 0.3] cross-product seed, are part of it)
# ----------------------------------------------------------------------------


def normalize(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x)


def viewmatrix(z: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    vec2 = normalize(z)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def poses_avg(poses: np.ndarray) -> np.ndarray:
    """The average camera [3, 5] (its hwf column from the first pose)."""
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([viewmatrix(vec2, up, center), hwf], 1)


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """The poses in the frame of their average camera."""
    out = poses.copy()
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = np.concatenate([poses_avg(poses)[:3, :4], bottom], -2)
    hom = np.concatenate([poses[:, :3, :4], np.tile(bottom[None], [poses.shape[0], 1, 1])], -2)
    out[:, :3, :4] = (np.linalg.inv(c2w) @ hom)[:, :3, :4]
    return out


def render_path_spiral(c2w, up, radii, focal, zrate, rots, n):
    """``n`` poses [3, 5] on a spiral of ``rots`` turns around ``c2w``,
    looking at the point ``focal`` in front of it."""
    poses = []
    radii = np.array(list(radii) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, n + 1)[:-1]:
        eye = np.dot(c2w[:3, :4], np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]) * radii)
        look = normalize(eye - np.dot(c2w[:3, :4], np.array([0, 0, -focal, 1.0])))
        poses.append(np.concatenate([viewmatrix(look, up, eye), hwf], 1))
    return np.stack(poses)


def spherify_poses(poses: np.ndarray, bds: np.ndarray):
    """A 360-degree inward-facing capture moved onto the unit sphere around
    the point nearest every camera axis, with a 120-view ring path.
    Returns (poses, render_poses, bds), each pose [3, 5]."""

    def to_homogeneous(p):
        return np.concatenate([p, np.tile(np.reshape(np.eye(4)[-1], [1, 1, 4]), [p.shape[0], 1, 1])], 1)

    cam_axes = poses[:, :3, 2:3]
    cam_origins = poses[:, :3, 3:4]

    # The point nearest every camera axis (least squares).
    proj = np.eye(3) - cam_axes * np.transpose(cam_axes, [0, 2, 1])
    rhs = -proj @ cam_origins
    center = np.squeeze(-np.linalg.inv((np.transpose(proj, [0, 2, 1]) @ proj).mean(0)) @ rhs.mean(0))
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = normalize(up)
    vec1 = normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], 1)

    poses_reset = np.linalg.inv(to_homogeneous(c2w[None])) @ to_homogeneous(poses[:, :3, :4])
    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))

    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    centroid = np.mean(poses_reset[:, :3, 3], 0)
    ring_height = centroid[2]
    ring_radius = np.sqrt(rad**2 - ring_height**2)

    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        eye = np.array([ring_radius * np.cos(th), ring_radius * np.sin(th), ring_height])
        up = np.array([0, 0, -1.0])
        vec2 = normalize(eye)
        vec0 = normalize(np.cross(vec2, up))
        vec1 = normalize(np.cross(vec2, vec0))
        new_poses.append(np.stack([vec0, vec1, vec2, eye], 1))
    new_poses = np.stack(new_poses, 0)

    hwf = poses[0, :3, -1:]
    new_poses = np.concatenate([new_poses, np.broadcast_to(hwf, new_poses[:, :3, -1:].shape)], -1)
    poses_reset = np.concatenate(
        [poses_reset[:, :3, :4], np.broadcast_to(hwf, poses_reset[:, :3, -1:].shape)], -1
    )
    return poses_reset, new_poses, bds
