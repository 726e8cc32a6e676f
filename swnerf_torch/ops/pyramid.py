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

The resize's backward is its own (:class:`_Resize`): ``F.interpolate``'s
antialiased backward on CUDA adds into the input's gradient with atomics,
so two launches on the same cotangent differed in the last bits and a
MultiRes phase 2 (whose global term runs through the reconstruction) did
not repeat run to run. The forward stays ``F.interpolate``'s, bit for bit;
the backward applies the adjoint of the same separable map, G -> A_h^T G
A_w, with the per-axis weight matrices taken once per size pair from
``F.interpolate`` itself, as two fixed-order products.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

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


def _interpolate(images: torch.Tensor, H: int, W: int) -> torch.Tensor:
    x = images.permute(0, 3, 1, 2)
    out = F.interpolate(x, size=(H, W), mode="bilinear", align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


_AXIS: Dict[Tuple[int, int, torch.dtype, str], torch.Tensor] = {}


def axis_matrix(n_in: int, n_out: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """The 1-D resize ``n_in -> n_out`` as ``F.interpolate`` computes it, a
    [n_out, n_in] matrix A (out = A @ in along the axis): the identity basis
    resized along the width (the antialiased CPU kernel mishandles a width of
    one, so both axes take theirs from the width), in float64, cached."""
    key = (n_in, n_out, dtype, str(device))
    if key not in _AXIS:
        eye = torch.eye(n_in, dtype=torch.float64)[None, :, None, :]
        a = F.interpolate(eye, size=(1, n_out), mode="bilinear", align_corners=False, antialias=True)
        _AXIS[key] = a[0, :, 0, :].t().contiguous().to(dtype=dtype, device=device)
    return _AXIS[key]


def resize_backward(g: torch.Tensor, H_in: int, W_in: int) -> torch.Tensor:
    """The adjoint of :func:`_resize` at a cotangent g [N, H, W, C]:
    A_h^T g A_w, two matrix products in a fixed order (no atomics)."""
    N, H, W, C = g.shape
    ah = axis_matrix(H_in, H, g.dtype, g.device)
    aw = axis_matrix(W_in, W, g.dtype, g.device)
    t = torch.matmul(ah.t(), g.reshape(N, H, W * C))  # [N, H_in, W * C]
    t = torch.matmul(aw.t(), t.reshape(N * H_in, W, C))  # [N * H_in, W_in, C]
    return t.reshape(N, H_in, W_in, C)


class _Resize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, images: torch.Tensor, H: int, W: int) -> torch.Tensor:
        ctx.in_hw = images.shape[1], images.shape[2]
        return _interpolate(images, H, W)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return resize_backward(g, *ctx.in_hw), None, None


def _resize(images: torch.Tensor, H: int, W: int) -> torch.Tensor:
    return _Resize.apply(images, H, W)


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
