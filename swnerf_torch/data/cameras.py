"""Camera path helpers (port of ``swnerf_tpu/data/cameras.py``: the
360-degree spherical orbit; the LLFF pose machinery comes with the LLFF
loader)."""

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
