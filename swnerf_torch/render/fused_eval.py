"""Forward-only eval rendering through kernels B3 and B2, B4 for a T-NeRF,
or B6 and B3's pts mode for a D-NeRF (port of
``swnerf_tpu/render/fused_eval.py::make_vanilla_eval_pass``,
``make_tnerf_eval_pass`` and ``make_dnerf_eval_pass``).

One render-pass kernel per pass computes encode + trunk + composite; B2
resamples between the passes and ``torch.sort`` merges the depths, or B10
does both under ``SWNERF_PDF_MERGE=1`` (``ops/sampling.py::
sample_pdf_merge``, as the JAX passes call it). The
semantics are the deterministic eval mode of ``render_rays``: linspace z,
no noise, ``det`` resampling, and disp = 1/max(1e-10, depth/acc) with its
0/0 -> NaN kept (computed here with ``torch.maximum``, not in the kernel).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from swnerf_torch.ops.embedding import positional_encoding
from swnerf_torch.ops.kernels import render_pass as b3
from swnerf_torch.ops.kernels import time_net as b6
from swnerf_torch.ops.sampling import sample_along_rays, sample_pdf_merge
from swnerf_torch.render.core import Rays, RenderConfig


def _dists_scaled(z_vals: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
    """deltas * |d| with the reference's trailing 1e10 (ray.py:163-167)."""
    d = z_vals[..., 1:] - z_vals[..., :-1]
    d = torch.cat([d, torch.full_like(d[..., :1], 1e10)], -1)
    return d * torch.linalg.norm(rays_d[..., None, :], dim=-1)


def supports_eval_pass(mcfg, fcfg=None) -> bool:
    """Both passes' architectures fit B3 and share the embedding sizes."""
    if not b3.supports_config(mcfg):
        return False
    return fcfg is None or (
        b3.supports_config(fcfg) and (fcfg.multires, fcfg.multires_views) == (mcfg.multires, mcfg.multires_views)
    )


class VanillaEvalPass:
    """``pack(model)`` once per image, then ``(packed, packed_fine, rays,
    ecfg) -> (rgb, disp, acc, depth)`` per chunk of rays.

    ``compute_dtype`` is B3's operand type (bf16 default, fp32 for parity).
    ``plain=True`` runs the kernels' plain twins on any device, which is how
    a kernel render is checked against plain torch on the card.
    """

    def __init__(self, mcfg, compute_dtype: torch.dtype = torch.bfloat16, plain: bool = False):
        self.mcfg = mcfg
        self.compute_dtype = compute_dtype
        self.plain = plain
        self._render = b3.render_pass_plain if plain else b3.render_pass

    def pack(self, model) -> b3.PackedParams:
        return b3.pack_params(model.state_dict(), model.cfg, self.compute_dtype)

    def __call__(
        self,
        packed: b3.PackedParams,
        packed_fine: Optional[b3.PackedParams],
        rays: Rays,
        ecfg: RenderConfig,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        origins = rays.origins.contiguous()
        directions = rays.directions.contiguous()
        vd_emb = positional_encoding(rays.viewdirs, self.mcfg.nf_views).contiguous()

        def one(p, z):
            return self._render(
                p, origins, directions, vd_emb, z, _dists_scaled(z, directions), None, ecfg.white_bkgd
            )

        z_vals = sample_along_rays(rays.near, rays.far, ecfg.n_samples, 0.0, ecfg.lindisp).contiguous()
        res = one(packed, z_vals)
        if ecfg.n_importance > 0:
            z_all = sample_pdf_merge(z_vals, res.weights, ecfg.n_importance, det=True, plain=self.plain)
            res = one(packed_fine if packed_fine is not None else packed, z_all)
        disp = 1.0 / torch.maximum(torch.full_like(res.depth, 1e-10), res.depth / res.acc)
        return res.rgb, disp, res.acc, res.depth


def make_vanilla_eval_pass(mcfg, compute_dtype: torch.dtype = torch.bfloat16, plain: bool = False) -> VanillaEvalPass:
    return VanillaEvalPass(mcfg, compute_dtype, plain)


class TNeRFEvalPass:
    """``pack(model)`` once per image, then ``(packed, packed_fine, rays,
    ecfg) -> (rgb, disp, acc, depth)`` per chunk of rays: one forward-only
    B4 pass per chunk, the rays' frame times riding with them. Single pass
    (the T-NeRF runner forces ``n_importance`` to 0). ``compute_dtype`` and
    ``plain`` as for :class:`VanillaEvalPass`."""

    supports_times = True

    def __init__(self, mcfg, compute_dtype: torch.dtype = torch.bfloat16, plain: bool = False):
        self.mcfg = mcfg
        self.compute_dtype = compute_dtype
        self._render = b3.render_pass_plain if plain else b3.render_pass

    def pack(self, model) -> b3.PackedParams:
        return b3.pack_tnerf_params(model.state_dict(), model.cfg, self.compute_dtype)

    def __call__(
        self,
        packed: b3.PackedParams,
        packed_fine: Optional[b3.PackedParams],
        rays: Rays,
        ecfg: RenderConfig,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        del packed_fine  # single model
        if ecfg.n_importance:
            raise ValueError("the T-NeRF eval pass is single-pass (n_importance=0)")
        directions = rays.directions.contiguous()
        vd_emb = positional_encoding(rays.viewdirs, self.mcfg.nf_views).contiguous()
        z_vals = sample_along_rays(rays.near, rays.far, ecfg.n_samples, 0.0, ecfg.lindisp).contiguous()
        res = self._render(
            packed, rays.origins.contiguous(), directions, vd_emb, z_vals, _dists_scaled(z_vals, directions), None,
            ecfg.white_bkgd, rays.times.reshape(-1).contiguous(),
        )
        disp = 1.0 / torch.maximum(torch.full_like(res.depth, 1e-10), res.depth / res.acc)
        return res.rgb, disp, res.acc, res.depth


def make_tnerf_eval_pass(mcfg, compute_dtype: torch.dtype = torch.bfloat16, plain: bool = False) -> TNeRFEvalPass:
    return TNeRFEvalPass(mcfg, compute_dtype, plain)


def canonical_params(params, prefix: str = "_occ."):
    """The canonical network's entries of a DirectTemporalNeRF state dict
    (or parameter dict), under the vanilla names ``pack_params`` reads."""
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


def supports_dnerf_eval_pass(mcfg) -> bool:
    """The D-NeRF fields the kernel eval pass covers: the Fourier encoding, a
    canonical trunk B3's pts mode takes (the narrow or the MultiRes widths)
    and a deformation MLP B6 takes."""
    return mcfg.i_embed == 0 and b3.supports_config(mcfg, wide=True) and b6.supports_time_net(mcfg)


class DNeRFEvalPass:
    """``pack(model)`` once per image, then ``(packed, packed_fine, rays,
    ecfg) -> (rgb, disp, acc, depth)`` per chunk of rays, for a
    DirectTemporalNeRF (``make_dnerf_eval_pass``, fused_eval.py:155-219):
    per pass, B6 at the samples ``o + d*z`` and the rays' frame times, the
    ``t == 0`` mask (``zero_canonical``), then B3's pts mode at ``pts + dx``;
    between the passes B2 and ``torch.sort``, as :class:`VanillaEvalPass`.
    ``compute_dtype`` and ``plain`` as there."""

    supports_times = True

    def __init__(self, mcfg, compute_dtype: torch.dtype = torch.bfloat16, plain: bool = False):
        self.mcfg = mcfg
        self.compute_dtype = compute_dtype
        self.plain = plain
        self._render = b3.render_pass_plain if plain else b3.render_pass
        self._time_net = b6.time_net_plain if plain else b6.time_net

    def pack(self, model):
        sd = model.state_dict()
        return (
            b3.pack_params(canonical_params(sd), model.cfg, self.compute_dtype),
            b6.pack_time_params(sd, model.cfg, self.compute_dtype),
            model.cfg.zero_canonical,
        )

    def __call__(self, packed, packed_fine, rays: Rays, ecfg: RenderConfig):
        origins, directions = rays.origins.contiguous(), rays.directions.contiguous()
        vd_emb = positional_encoding(rays.viewdirs, self.mcfg.nf_views).contiguous()
        times = rays.times.reshape(-1).contiguous()

        def one(p, z):
            canon, tnet, zero_canonical = p
            pts = (origins[:, None, :] + directions[:, None, :] * z[..., None]).contiguous()
            dx = self._time_net(tnet, pts, times)
            if zero_canonical:
                dx = torch.where((times == 0.0)[:, None, None], torch.zeros_like(dx), dx)
            return self._render(
                canon, None, None, vd_emb, z, _dists_scaled(z, directions), None, ecfg.white_bkgd, None,
                (pts + dx).contiguous(),
            )

        z_vals = sample_along_rays(rays.near, rays.far, ecfg.n_samples, 0.0, ecfg.lindisp).contiguous()
        res = one(packed, z_vals)
        if ecfg.n_importance > 0:
            z_all = sample_pdf_merge(z_vals, res.weights, ecfg.n_importance, det=True, plain=self.plain).contiguous()
            res = one(packed_fine if packed_fine is not None else packed, z_all)
        disp = 1.0 / torch.maximum(torch.full_like(res.depth, 1e-10), res.depth / res.acc)
        return res.rgb, disp, res.acc, res.depth


def make_dnerf_eval_pass(mcfg, compute_dtype: torch.dtype = torch.bfloat16, plain: bool = False) -> DNeRFEvalPass:
    return DNeRFEvalPass(mcfg, compute_dtype, plain)
