"""Along-ray sampling (port of ``swnerf_tpu/ops/sampling.py``): stratified
coarse depths and inverse-CDF importance sampling.

``sample_pdf`` runs the hand-written CUDA kernel (B2,
``ops/kernels/sample_pdf.py``) on CUDA tensors and its plain twin on CPU
tensors. It is non-differentiable on both paths, as in the reference.
``sample_pdf_merge`` (the resample and its sorted union) is B2 and
``torch.sort``, or under ``SWNERF_PDF_MERGE=1`` kernel B10 in one launch,
as ``ops/sampling.py:190-195`` of the JAX package routes it.
"""

from __future__ import annotations

from typing import Optional

import torch

from swnerf_torch.ops.kernels import sample_pdf as _b2
from swnerf_torch.utils.switches import pdf_merge


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


def sorted_uniforms(n: int, n_samples: int, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """The order statistics of ``n_samples`` iid uniforms per row, drawn
    directly by exponential spacings (``u_(i) = sum(E_1..E_i) /
    sum(E_1..E_{S+1})``, E ~ Exp(1); sample_pdf.py:266-275 of the JAX
    package): sorted, with the distribution of sorted ``torch.rand``. B10's
    draw under ``SWNERF_PDF_MERGE=1``."""
    e = torch.empty((n, n_samples + 1), device=device).exponential_(generator=generator)
    c = torch.cumsum(e, -1)
    return c[:, :-1] / c[:, -1:]


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
    plain: bool = False,
) -> torch.Tensor:
    """The hierarchical-resample idiom in one call: bins = coarse z
    midpoints, importance-sample ``n_samples`` depths from
    ``weights[..., 1:-1]`` (uniforms ``u`` as in :func:`sample_pdf`), and
    return the sorted union with ``z_vals`` (``[N, M + n_samples]``),
    detached. Under ``SWNERF_PDF_MERGE=1`` that is one B10 launch (its twin
    on the CPU), whose random uniforms, where it draws them, are
    :func:`sorted_uniforms`; the union is the same function of the samples
    either way (``det`` gives bit-equal results). ``plain`` runs the
    kernels' twins on any device (the eval passes' plain mode)."""
    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    bins, w = z_mid.detach(), weights[..., 1:-1].detach()
    n = z_vals.shape[0]
    if u is None:
        if det:
            u = torch.linspace(0.0, 1.0, n_samples, dtype=bins.dtype, device=bins.device).expand(n, n_samples)
        elif pdf_merge():
            u = sorted_uniforms(n, n_samples, generator, bins.device)
        else:
            u = torch.rand((n, n_samples), generator=generator, dtype=bins.dtype, device=bins.device)
    u = u.detach()
    if pdf_merge():
        merge = _b2.sample_pdf_merge_plain if plain else _b2.sample_pdf_merge
        return merge(z_vals.detach(), bins, w, u)
    return merge_z_vals(z_vals, (_b2.sample_pdf_plain if plain else _b2.sample_pdf)(bins, w, u))
