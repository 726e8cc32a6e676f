"""The volumetric render core (port of ``swnerf_tpu/render/core.py``).

coarse stratified sampling -> field -> composite
[-> inverse-CDF importance resample -> fine field -> composite]

``render_rays`` is the plain path through the field modules (a D-NeRF
field's deformation ``dx`` comes out with the maps). Its random
numbers come from a ``torch.Generator`` or, as :class:`Draws`, from the
caller (the analog of the JAX package's ``sample_pdf(u=...)``).
``render_image`` renders a whole image in chunks of ``chunk`` rays, through
a forward-only eval pass (``render/fused_eval.py``: kernels B3 and B2, B4
for a T-NeRF, B6 and B3's pts mode for a D-NeRF) when one is given, else
through ``render_rays``. Rays of a time-conditioned field carry their frame
times (``Rays.times``), which the render core hands to the field.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch

from swnerf_torch.device import resolve_device
from swnerf_torch.models.common import Field
from swnerf_torch.ops.rays import get_rays, ndc_rays
from swnerf_torch.ops.sampling import merge_z_vals, sample_along_rays, sample_pdf, sorted_uniforms
from swnerf_torch.ops.volume import composite
from swnerf_torch.parallel.mesh import Rows, all_reduce_rows
from swnerf_torch.utils.switches import pdf_merge


class Rays(NamedTuple):
    """A batch of rays. All leading dims [N]."""

    origins: torch.Tensor  # [N, 3]
    directions: torch.Tensor  # [N, 3] (unnormalized; used for deltas)
    viewdirs: Optional[torch.Tensor]  # [N, 3] unit directions, or None
    near: torch.Tensor  # [N]
    far: torch.Tensor  # [N]
    times: Optional[torch.Tensor] = None  # [N, 1] frame time, or None

    def slice(self, start: int, stop: int) -> "Rays":
        return Rays(*(None if x is None else x[start:stop] for x in self))


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render options."""

    n_samples: int = 64
    n_importance: int = 0
    perturb: float = 1.0
    lindisp: bool = False
    raw_noise_std: float = 0.0
    white_bkgd: bool = False
    use_viewdirs: bool = True
    # With a fine pass: True, the coarse pass contributes rgb0 and its
    # gradients (vanilla; D-NeRF's two models); False, it only guides the
    # sampling, its weights detached (D-NeRF's shared model, run_dnerf.py:445-448).
    coarse_contributes: bool = True

    def eval_mode(self) -> "RenderConfig":
        """Deterministic eval variant (reference render_kwargs_test,
        run.py:302-304): no jitter, no density noise."""
        return dataclasses.replace(self, perturb=0.0, raw_noise_std=0.0)


class Draws(NamedTuple):
    """The random numbers of one train-mode render, in the order the JAX
    key schedule splits them (``render/core.py:104`` there)."""

    t_rand: Optional[torch.Tensor]  # [N, n_samples] stratified jitter (perturb > 0)
    noise0: Optional[torch.Tensor]  # [N, n_samples] coarse density noise, times the std
    u: Optional[torch.Tensor]  # [N, n_importance] importance uniforms (perturb > 0)
    noise1: Optional[torch.Tensor]  # [N, n_samples + n_importance] fine density noise


def make_draws(cfg: RenderConfig, n: int, generator: Optional[torch.Generator], device) -> Draws:
    """Draw what :func:`render_rays` would draw for ``n`` rays, in its
    order; None where the config needs no randomness. Under
    ``SWNERF_PDF_MERGE=1`` the importance uniforms are sorted, drawn as
    order statistics (``sampling.sorted_uniforms``), as B10 needs them."""

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=device)

    def noise(*shape):
        return torch.randn(shape, generator=generator, device=device) * cfg.raw_noise_std

    jitter = cfg.perturb > 0.0
    noisy = cfg.raw_noise_std > 0.0
    fine = cfg.n_importance > 0
    s_all = cfg.n_samples + cfg.n_importance
    return Draws(
        t_rand=rand(n, cfg.n_samples) if jitter else None,
        noise0=noise(n, cfg.n_samples) if noisy else None,
        u=(sorted_uniforms(n, cfg.n_importance, generator, device) if pdf_merge() else rand(n, cfg.n_importance))
        if fine and jitter else None,
        noise1=noise(n, s_all) if fine and noisy else None,
    )


def _apply(field: Field, pts: torch.Tensor, viewdirs, times):
    """A field's ``(raw, dx or None)``: D-NeRF fields return ``(raw, {"dx":
    dx})``, the others raw alone."""
    out = field(pts, viewdirs, times)
    if isinstance(out, tuple):
        return out[0], out[1]["dx"]
    return out, None


def render_rays(
    model: Field,
    rays: Rays,
    cfg: RenderConfig,
    generator: Optional[torch.Generator] = None,
    fine_model: Optional[Field] = None,
    draws: Optional[Draws] = None,
    z_vals: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Render a ray batch through the field modules. Returns per-ray maps:
    rgb, disp, acc, weights, depth, z_vals, raw, and the last pass's
    deformation dx for a D-NeRF field; with a fine pass also z_std and,
    where the coarse pass contributes (``cfg.coarse_contributes``), rgb0,
    disp0, acc0. Random numbers come from ``draws`` when given, else from
    ``generator``. Given ``z_vals`` (the D-NeRF TV re-render), one pass of
    the fine model (else the model) runs there, with the fine noise."""
    if draws is None:
        draws = Draws(None, None, None, None)
    viewdirs = rays.viewdirs if cfg.use_viewdirs else None
    ret: Dict[str, torch.Tensor] = {}
    if z_vals is not None:
        pts = rays.origins[..., None, :] + rays.directions[..., None, :] * z_vals[..., :, None]
        raw, dx = _apply(fine_model if fine_model is not None else model, pts, viewdirs, rays.times)
        out = composite(raw, z_vals, rays.directions, cfg.raw_noise_std, cfg.white_bkgd, generator, draws.noise1)
    else:
        z_vals = sample_along_rays(
            rays.near, rays.far, cfg.n_samples, cfg.perturb, cfg.lindisp, generator=generator, t_rand=draws.t_rand
        )
        pts = rays.origins[..., None, :] + rays.directions[..., None, :] * z_vals[..., :, None]
        raw, dx = _apply(model, pts, viewdirs, rays.times)
        out = composite(raw, z_vals, rays.directions, cfg.raw_noise_std, cfg.white_bkgd, generator, draws.noise0)
        if cfg.n_importance > 0:
            weights = out.weights
            if cfg.coarse_contributes:
                ret.update(rgb0=out.rgb, disp0=out.disp, acc0=out.acc)
            else:
                weights = weights.detach()
            z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
            z_samples = sample_pdf(
                z_mid, weights[..., 1:-1], cfg.n_importance, generator=generator, det=(cfg.perturb == 0.0),
                u=draws.u if cfg.perturb > 0.0 else None,
            )
            z_vals = merge_z_vals(z_vals, z_samples)
            pts = rays.origins[..., None, :] + rays.directions[..., None, :] * z_vals[..., :, None]
            raw, dx = _apply(fine_model if fine_model is not None else model, pts, viewdirs, rays.times)
            out = composite(raw, z_vals, rays.directions, cfg.raw_noise_std, cfg.white_bkgd, generator, draws.noise1)
            ret["z_std"] = torch.std(z_samples, dim=-1, correction=0)

    ret.update(
        rgb=out.rgb, disp=out.disp, acc=out.acc, weights=out.weights, depth=out.depth, z_vals=z_vals, raw=raw
    )
    if dx is not None:
        ret["dx"] = dx
    return ret


def build_rays(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    near: float,
    far: float,
    use_viewdirs: bool = True,
    ndc: bool = False,
    H: int = 0,
    W: int = 0,
    focal: float = 0.0,
    times: Optional[torch.Tensor] = None,
) -> Rays:
    """Pack raw origins/directions into a :class:`Rays` batch (reference
    render() packing, run.py:137-158): viewdirs normalized from the pre-NDC
    directions, optional NDC projection, near/far broadcast, and the
    per-ray frame times [N, 1] of a time-conditioned field."""
    viewdirs = None
    if use_viewdirs:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    if ndc:
        rays_o, rays_d = ndc_rays(H, W, focal, 1.0, rays_o, rays_d)
    n = rays_o.shape[0]
    return Rays(
        origins=rays_o.contiguous(),
        directions=rays_d.contiguous(),
        viewdirs=viewdirs,
        near=torch.full((n,), near, dtype=rays_o.dtype, device=rays_o.device),
        far=torch.full((n,), far, dtype=rays_o.dtype, device=rays_o.device),
        times=times,
    )


def make_rays_from_camera(
    H: int,
    W: int,
    focal_or_K,
    c2w,
    near: float,
    far: float,
    use_viewdirs: bool = True,
    ndc: bool = False,
    device: Optional[torch.device] = None,
    time: Optional[float] = None,
) -> Rays:
    """Full-image ray grid, flattened to [H*W] rays (reference render(),
    run.py:105-158), on ``device`` (default ``cuda``); with ``time`` every
    ray carries that frame time."""
    rays_o, rays_d = get_rays(H, W, focal_or_K, c2w, device=resolve_device(device))
    viewdirs = None
    if use_viewdirs:
        viewdirs = (rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)).reshape(-1, 3)
    if ndc:
        focal = focal_or_K if isinstance(focal_or_K, (int, float)) else focal_or_K[0][0]
        rays_o, rays_d = ndc_rays(H, W, float(focal), 1.0, rays_o, rays_d)
    rays_o = rays_o.reshape(-1, 3).contiguous()
    rays_d = rays_d.reshape(-1, 3).contiguous()
    n = rays_o.shape[0]
    return Rays(
        origins=rays_o,
        directions=rays_d,
        viewdirs=viewdirs,
        near=torch.full((n,), near, dtype=rays_o.dtype, device=rays_o.device),
        far=torch.full((n,), far, dtype=rays_o.dtype, device=rays_o.device),
        times=None if time is None else torch.full((n, 1), time, dtype=rays_o.dtype, device=rays_o.device),
    )


@torch.no_grad()
def render_image(
    model: Field,
    rays: Rays,
    cfg: RenderConfig,
    chunk: int = 8192,
    fine_model: Optional[Field] = None,
    eval_pass=None,
    group=None,
) -> Dict[str, torch.Tensor]:
    """Whole-image render in chunks of ``chunk`` rays, always in eval mode
    (deterministic). Returns rgb [N, 3], disp, acc, depth [N]. An eval pass
    is used only where it takes the rays' times or their absence
    (``supports_times``), as in the JAX package.

    With a ``group`` (``parallel/mesh.py``; ``render/core.py:329-350`` of
    the JAX package shards the eval tiles) each rank renders chunks
    ``host_shard_bounds(n_chunks)`` of the same chunk boundaries, and the
    frame is assembled on every rank by one ``all_reduce`` of a zero-filled
    buffer: the pieces are disjoint, so the frame is bit-equal to one
    process's."""
    cfg = cfg.eval_mode()
    use_pass = (
        eval_pass is not None
        and rays.viewdirs is not None
        and (rays.times is not None) == bool(getattr(eval_pass, "supports_times", False))
    )
    if use_pass:
        packed = eval_pass.pack(model)
        packed_fine = eval_pass.pack(fine_model) if fine_model is not None else None
    outs = []
    n = rays.origins.shape[0]
    starts = list(range(0, n, chunk))
    if group is not None:
        mine = group.rows(len(starts))
        starts = mine.take(starts)
    for start in starts:
        tile = rays.slice(start, min(n, start + chunk))
        if use_pass:
            outs.append(eval_pass(packed, packed_fine, tile, cfg))
        else:
            out = render_rays(model, tile, cfg, fine_model=fine_model)
            outs.append((out["rgb"], out["disp"], out["acc"], out["depth"]))
    if group is None:
        rgb, disp, acc, depth = (torch.cat(parts, 0) for parts in zip(*outs))
        return {"rgb": rgb, "disp": disp, "acc": acc, "depth": depth}
    rows = Rows(mine.lo * chunk, min(n, mine.hi * chunk), n)
    if outs:
        pieces = [torch.cat(parts, 0) for parts in zip(*outs)]
    else:  # more ranks than chunks
        pieces = [torch.empty((0, 3), device=rays.origins.device)] + [torch.empty(0, device=rays.origins.device)] * 3
    rgb, disp, acc, depth = all_reduce_rows(group, pieces, [rows] * 4)
    return {"rgb": rgb, "disp": disp, "acc": acc, "depth": depth}
