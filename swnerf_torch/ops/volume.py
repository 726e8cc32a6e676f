"""Volume rendering: raw network outputs -> pixel maps (port of
``swnerf_tpu/ops/volume.py``).

alpha = 1 - exp(-relu(sigma) * dist), exclusive-cumprod transmittance with
the +1e-10 stabilizer, rgb / depth / disparity / accumulation maps,
optional white-background compositing.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class _CumprodNonzero(torch.autograd.Function):
    """``torch.cumprod`` along the last axis of a tensor with no zero entry
    (the transmittance factors ``1 - alpha + 1e-10``), with torch's own
    backward for that case, ``reversed cumsum(out * g) / x``, but without
    torch's test for zeros, which reads a flag on the host: a step captured
    in a CUDA graph may not synchronize, and each uncaptured one waits."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, -1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return (out * g).flip(-1).cumsum(-1).flip(-1).div(x)


class CompositeOutput(NamedTuple):
    rgb: torch.Tensor  # [N, 3]
    disp: torch.Tensor  # [N]
    acc: torch.Tensor  # [N]
    weights: torch.Tensor  # [N, S]
    depth: torch.Tensor  # [N]


def composite(
    raw: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    raw_noise_std: float = 0.0,
    white_bkgd: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> CompositeOutput:
    """Alpha-composite raw ``[N, S, 4]`` (rgb logits + density) along rays.

    With ``raw_noise_std > 0`` density noise is added: ``noise`` [N, S]
    (already scaled by the std) when given, else standard normal draws from
    ``generator`` times ``raw_noise_std``.
    """
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], -1)
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)

    rgb = torch.sigmoid(raw[..., :3])
    sigma = raw[..., 3]
    if raw_noise_std > 0.0:
        if noise is None:
            noise = torch.randn(sigma.shape, generator=generator, dtype=sigma.dtype, device=sigma.device)
            noise = noise * raw_noise_std
        sigma = sigma + noise

    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    trans = _CumprodNonzero.apply(torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], -1))[..., :-1]
    weights = alpha * trans

    rgb_map = torch.sum(weights[..., None] * rgb, -2)
    depth_map = torch.sum(weights * z_vals, -1)
    acc_map = torch.sum(weights, -1)
    # torch.maximum keeps the reference's 0/0 -> NaN.
    disp_map = 1.0 / torch.maximum(torch.full_like(depth_map, 1e-10), depth_map / acc_map)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return CompositeOutput(rgb_map, disp_map, acc_map, weights, depth_map)
