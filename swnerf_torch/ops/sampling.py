"""Along-ray sampling (port of ``swnerf_tpu/ops/sampling.py``): stratified
coarse depths and inverse-CDF importance sampling.

``sample_pdf`` runs the hand-written CUDA kernel (B2,
``ops/kernels/sample_pdf.py``) on CUDA tensors and its plain twin on CPU
tensors. It is non-differentiable on both paths, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from swnerf_torch.ops.kernels import sample_pdf as _b2


def sample_along_rays(
    near: torch.Tensor,
    far: torch.Tensor,
    n_samples: int,
    perturb: float = 0.0,
    lindisp: bool = False,
    generator: Optional[torch.Generator] = None,
    t_rand: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Stratified depth samples per ray: ``[N_rays, n_samples]``.

    ``perturb == 0`` gives the deterministic linspace; otherwise each depth
    is jittered uniformly inside its interval by ``t_rand`` [N, n_samples]
    when given, else by draws from ``generator``.
    """
    near = near.reshape(-1, 1)
    far = far.reshape(-1, 1)
    t_vals = torch.linspace(0.0, 1.0, n_samples, dtype=near.dtype, device=near.device)
    if not lindisp:
        z_vals = near * (1.0 - t_vals) + far * t_vals
    else:
        z_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    z_vals = z_vals.expand(near.shape[0], n_samples)

    if perturb > 0.0:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], -1)
        lower = torch.cat([z_vals[..., :1], mids], -1)
        if t_rand is None:
            t_rand = torch.rand(z_vals.shape, generator=generator, dtype=z_vals.dtype, device=z_vals.device)
        z_vals = lower + (upper - lower) * t_rand
    return z_vals


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    generator: Optional[torch.Generator] = None,
    det: bool = False,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inverse-transform sampling of ``n_samples`` depths per ray.

    Args:
      bins: [N, M] sorted bin edges (the coarse z midpoints).
      weights: [N, M-1] unnormalized bin weights.
      generator: draws the uniforms when ``det=False`` and ``u`` is None.
      det: deterministic linspace(0, 1) uniforms.
      u: optional externally supplied uniforms [N, n_samples].

    Returns:
      samples: [N, n_samples], detached.
    """
    if u is None:
        if det:
            u = torch.linspace(0.0, 1.0, n_samples, dtype=bins.dtype, device=bins.device)
            u = u.expand(bins.shape[0], n_samples)
        else:
            u = torch.rand(
                (bins.shape[0], n_samples), generator=generator, dtype=bins.dtype, device=bins.device
            )
    return _b2.sample_pdf(bins.detach(), weights.detach(), u.detach())


def merge_z_vals(z_vals: torch.Tensor, z_samples: torch.Tensor) -> torch.Tensor:
    """Sorted union of coarse and fine depths (reference run.py:400)."""
    return torch.sort(torch.cat([z_vals, z_samples], -1), -1).values


def sample_pdf_merge(
    z_vals: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    generator: Optional[torch.Generator] = None,
    det: bool = False,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The hierarchical-resample idiom in one call: bins = coarse z
    midpoints, importance-sample ``n_samples`` depths from
    ``weights[..., 1:-1]`` (uniforms ``u`` as in :func:`sample_pdf`), and
    return the sorted union with ``z_vals`` (``[N, M + n_samples]``)."""
    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    z_samples = sample_pdf(z_mid, weights[..., 1:-1], n_samples, generator=generator, det=det, u=u)
    return merge_z_vals(z_vals, z_samples)
