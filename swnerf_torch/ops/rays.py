"""Ray generation and NDC projection (port of ``swnerf_tpu/ops/rays.py``).

OpenGL-style camera (x right, y up, looking down -z); ``focal_or_K`` is a
scalar focal length or a 3x3 intrinsic matrix.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def _pixel_dirs(i, j, H, W, focal_or_K, stack, ones_like, asarr):
    if isinstance(focal_or_K, (float, int)):
        f = float(focal_or_K)
        return stack([(i - W * 0.5) / f, -(j - H * 0.5) / f, -ones_like(i)], -1)
    K = asarr(focal_or_K)
    return stack([(i - K[0][2]) / K[0][0], -(j - K[1][2]) / K[1][1], -ones_like(i)], -1)


def get_rays(
    H: int,
    W: int,
    focal_or_K,
    c2w: Union[torch.Tensor, np.ndarray],
    device: Optional[torch.device] = None,
):
    """World-space rays for every pixel: ``(rays_o, rays_d)``, each [H, W, 3]."""
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=device)
    i, j = torch.meshgrid(
        torch.arange(W, dtype=torch.float32, device=c2w.device),
        torch.arange(H, dtype=torch.float32, device=c2w.device),
        indexing="xy",
    )
    dirs = _pixel_dirs(
        i, j, H, W, focal_or_K, torch.stack, torch.ones_like,
        lambda k: torch.as_tensor(k, dtype=torch.float32, device=c2w.device),
    )
    # Elementwise broadcast-sum, as the reference does: no matmul precision
    # mode can touch the fp32 rotation.
    rays_d = torch.sum(dirs[..., None, :] * c2w[:3, :3], -1)
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def get_rays_at(pixels: torch.Tensor, H: int, W: int, focal_or_K, c2w: torch.Tensor):
    """Rays at given pixels only: ``pixels`` [N, 2] integer (row, col) =
    (y, x); returns ``(rays_o, rays_d)``, each [N, 3], on ``c2w``'s device,
    in fp32 (float64 for a float64 ``c2w``: the float64 reference runs).
    The full H x W grid is never built (training samples a few pixels)."""
    dtype = torch.float64 if isinstance(c2w, torch.Tensor) and c2w.dtype == torch.float64 else torch.float32
    c2w = torch.as_tensor(c2w, dtype=dtype)
    j = pixels[:, 0].to(dtype)  # row
    i = pixels[:, 1].to(dtype)  # col
    dirs = _pixel_dirs(
        i, j, H, W, focal_or_K, torch.stack, torch.ones_like,
        lambda k: torch.as_tensor(k, dtype=dtype, device=c2w.device),
    )
    rays_d = torch.sum(dirs[..., None, :] * c2w[:3, :3], -1)
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def get_rays_np(H: int, W: int, focal_or_K, c2w):
    """Numpy twin of :func:`get_rays` for host-side precompute."""
    c2w = np.asarray(c2w)
    i, j = np.meshgrid(
        np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32), indexing="xy"
    )
    dirs = _pixel_dirs(i, j, H, W, focal_or_K, np.stack, np.ones_like, np.asarray)
    rays_d = np.sum(dirs[..., np.newaxis, :] * c2w[:3, :3], -1)
    rays_o = np.broadcast_to(c2w[:3, -1], rays_d.shape)
    return rays_o, rays_d


def ndc_rays(H: int, W: int, focal: float, near: float, rays_o: torch.Tensor, rays_d: torch.Tensor):
    """Shift origins to the near plane and project to NDC (LLFF forward-facing)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (H / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]

    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)
