"""Laplacian image pyramids (batch, NHWC) for the MultiRes trainer (port of
``swnerf_tpu/ops/pyramid.py``).

A 3x3 Gaussian blur (sigma 1, zero padding) then a half-size resize per
level; band i is level i minus the next level resized up to it, the last
band the final low-pass; :func:`reconstruct_from_pyramid` is the exact
inverse and is differentiable (the MultiRes phase-2 loss goes through it).

The resize follows the JAX package's ``jax.image.resize(..., "linear")``,
which antialiases when it shrinks (its triangle kernel is stretched by the
scale and renormalised at the edges) and is plain half-pixel bilinear when
it grows: ``F.interpolate(mode="bilinear", align_corners=False,
antialias=True)`` computes the same, odd sizes (25 -> 12) included
(tests/test_torch_multires.py). The reference PyTorch code resizes without
the antialias; the port follows the JAX package.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F


def gaussian_kernel(kernel_size: int = 3, sigma: float = 1.0, device=None) -> torch.Tensor:
    """Normalized 2-D Gaussian [k, k]."""
    coords = torch.arange(kernel_size, dtype=torch.float32, device=device) - (kernel_size - 1) / 2.0
    g = torch.exp(-(coords[:, None] ** 2 + coords[None, :] ** 2) / (2.0 * sigma**2))
    return g / torch.sum(g)


def gaussian_blur(images: torch.Tensor, kernel_size: int = 3, sigma: float = 1.0) -> torch.Tensor:
    """Depthwise SAME blur (zero padding) on [N, H, W, C]."""
    C = images.shape[-1]
    k = gaussian_kernel(kernel_size, sigma, images.device).to(images.dtype)
    x = images.permute(0, 3, 1, 2)
    out = F.conv2d(x, k.expand(C, 1, kernel_size, kernel_size), padding=kernel_size // 2, groups=C)
    return out.permute(0, 2, 3, 1)


def _resize(images: torch.Tensor, H: int, W: int) -> torch.Tensor:
    x = images.permute(0, 3, 1, 2)
    out = F.interpolate(x, size=(H, W), mode="bilinear", align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


def generate_gaussian_pyramid(images: torch.Tensor, levels: int = 4, kernel_size: int = 3, sigma: float = 1.0
                              ) -> List[torch.Tensor]:
    """[N, H, W, C] -> ``levels`` progressively blurred and halved images,
    finest (the original) first. Level i has spatial size H / 2^i."""
    gauss = [images]
    for _ in range(levels - 1):
        blurred = gaussian_blur(gauss[-1], kernel_size, sigma)
        gauss.append(_resize(blurred, blurred.shape[1] // 2, blurred.shape[2] // 2))
    return gauss


def generate_laplacian_pyramid(images: torch.Tensor, levels: int = 4, kernel_size: int = 3, sigma: float = 1.0
                               ) -> List[torch.Tensor]:
    """[N, H, W, C] -> ``levels`` bands, finest first; band i has spatial
    size H / 2^i; the last band is the low-pass residual."""
    gauss = generate_gaussian_pyramid(images, levels, kernel_size, sigma)
    bands = [gauss[i] - _resize(gauss[i + 1], gauss[i].shape[1], gauss[i].shape[2]) for i in range(levels - 1)]
    return bands + [gauss[levels - 1]]


def reconstruct_from_pyramid(bands: List[torch.Tensor]) -> torch.Tensor:
    """Inverse of :func:`generate_laplacian_pyramid`."""
    out = bands[-1]
    for band in bands[-2::-1]:
        out = _resize(out, band.shape[1], band.shape[2]) + band
    return out
