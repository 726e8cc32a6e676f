"""The kernel train steps (port of ``swnerf_tpu/train/fused_step.py``):
vanilla, coarse B1 pass -> B2 importance sample + sorted union -> fine B1
pass -> Adam (``make_fused_train_step``); T-NeRF, one B4 train pass -> Adam
(``make_fused_tnerf_step``).

Gradients come out of the render-loss kernel B1 itself
(``ops/kernels/render_loss.py``), not from autograd: the step writes them
into each parameter's ``.grad`` and runs the optimizer. Random numbers,
sampling and loss are those of the eager ``make_train_step`` (tested against
it). On CUDA tensors B1, B2 and B4 run their kernels (bf16 operands by
default); on CPU tensors, which must be asked for, they run their plain
twins (fp32).
Multi-GPU (``axis_name``/``pmean`` in the JAX step) is a later slice.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from swnerf_torch.ops.embedding import positional_encoding
from swnerf_torch.ops.kernels import render_loss as b1
from swnerf_torch.ops.kernels import render_pass as b3
from swnerf_torch.ops.sampling import sample_along_rays, sample_pdf_merge
from swnerf_torch.render.core import Draws, Rays, RenderConfig, make_draws
from swnerf_torch.render.fused_eval import _dists_scaled
from swnerf_torch.train.loop import TrainState, mse_to_psnr


def _dtype(compute_dtype: Optional[torch.dtype], dev: torch.device) -> torch.dtype:
    return compute_dtype or (torch.bfloat16 if dev.type == "cuda" else torch.float32)


def supports_fused_step(cfg, fcfg, rcfg: RenderConfig) -> bool:
    """B1 covers the flagship family: coarse (+ fine) vanilla rendering with
    fourier embeddings of the same sizes in both passes."""
    ok = b3.supports_config(cfg) and rcfg.use_viewdirs
    if fcfg is not None:
        same_embedding = (fcfg.multires, fcfg.multires_views) == (cfg.multires, cfg.multires_views)
        ok = ok and b3.supports_config(fcfg) and same_embedding
    return ok


def _set_grads(model, grads: Dict[str, torch.Tensor]) -> None:
    for name, p in model.named_parameters():
        g = grads[name]
        p.grad = g if p.grad is None else p.grad + g


def make_fused_train_step(cfg, rcfg: RenderConfig, fcfg=None, compute_dtype: Optional[torch.dtype] = None):
    """Build ``(state, rays, target, generator=None, draws=None) -> metrics``
    with in-kernel gradients. ``cfg``/``fcfg`` are the coarse and fine
    model configs (``state.fine`` None: the coarse net serves both passes
    and its gradients from the two passes add). ``compute_dtype`` is B1's
    operand type; None means bf16 on the card and fp32 on the CPU."""
    fine_cfg = fcfg if fcfg is not None else cfg

    def train_step(
        state: TrainState,
        rays: Rays,
        target: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Draws] = None,
    ) -> Dict[str, torch.Tensor]:
        dev = rays.origins.device
        n = rays.origins.shape[0]
        if draws is None:
            draws = make_draws(rcfg, n, generator, dev)
        dtype = _dtype(compute_dtype, dev)
        scale = 1.0 / (3.0 * n)  # d mse / d sqerr_r
        o, d = rays.origins.contiguous(), rays.directions.contiguous()
        target = target.contiguous()
        vd_emb = positional_encoding(rays.viewdirs, cfg.nf_views).contiguous()

        def noise_of(x):
            return x.contiguous() if rcfg.raw_noise_std > 0.0 and x is not None else None

        def run(model, mcfg, z, noise):
            packed = b3.pack_params(model.state_dict(), mcfg, dtype)
            z = z.contiguous()
            out, grads = b1.render_loss(
                packed, o, d, vd_emb, z, _dists_scaled(z, d).contiguous(), noise, target, rcfg.white_bkgd, scale
            )
            return out, b1.unpack_grads(grads, packed)

        state.zero_grad()
        z_vals = sample_along_rays(rays.near, rays.far, rcfg.n_samples, rcfg.perturb, rcfg.lindisp, t_rand=draws.t_rand)
        outs_c, grads_c = run(state.coarse, cfg, z_vals, noise_of(draws.noise0))
        mse0 = outs_c.sqerr.sum() * scale
        _set_grads(state.coarse, grads_c)
        if rcfg.n_importance > 0:
            det = rcfg.perturb == 0.0
            z_all = sample_pdf_merge(z_vals, outs_c.weights, rcfg.n_importance, det=det, u=None if det else draws.u)
            fine = state.fine if state.fine is not None else state.coarse
            outs_f, grads_f = run(fine, fine_cfg if state.fine is not None else cfg, z_all, noise_of(draws.noise1))
            _set_grads(fine, grads_f)  # the shared net adds the fine pass's gradients
            mse1 = outs_f.sqerr.sum() * scale
            metrics = {"loss": mse1, "psnr": mse_to_psnr(mse1), "psnr0": mse_to_psnr(mse0), "total_loss": mse1 + mse0}
        else:
            metrics = {"loss": mse0, "psnr": mse_to_psnr(mse0), "total_loss": mse0}
        state.apply_update()
        return metrics

    return train_step


def supports_fused_tnerf_step(cfg, rcfg: RenderConfig) -> bool:
    """B4 covers the single time-conditioned pass (the runner forces
    ``n_importance`` to 0, reference run_tnerf.py:329) with Fourier
    embeddings."""
    return b3.supports_tnerf(cfg) and rcfg.n_importance == 0


def make_fused_tnerf_step(cfg, rcfg: RenderConfig, compute_dtype: Optional[torch.dtype] = None):
    """Build ``(state, rays, target, generator=None, draws=None) -> metrics``
    for a T-NeRF: one B4 train pass (the rays' frame times ride
    ``rays.times``), its gradients into ``.grad``, then Adam. Random numbers
    (``Draws``: t_rand, noise0) and loss are those of the eager
    ``make_train_step``. ``compute_dtype`` as for
    :func:`make_fused_train_step`."""

    def train_step(
        state: TrainState,
        rays: Rays,
        target: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Draws] = None,
    ) -> Dict[str, torch.Tensor]:
        dev = rays.origins.device
        n = rays.origins.shape[0]
        if draws is None:
            draws = make_draws(rcfg, n, generator, dev)
        scale = 1.0 / (3.0 * n)  # d mse / d sqerr_r
        d = rays.directions.contiguous()
        state.zero_grad()
        z = sample_along_rays(rays.near, rays.far, rcfg.n_samples, rcfg.perturb, rcfg.lindisp, t_rand=draws.t_rand)
        z = z.contiguous()
        noise = draws.noise0.contiguous() if rcfg.raw_noise_std > 0.0 else None
        packed = b3.pack_tnerf_params(state.coarse.state_dict(), cfg, _dtype(compute_dtype, dev))
        out, grads = b1.render_loss(
            packed, rays.origins.contiguous(), d, positional_encoding(rays.viewdirs, cfg.nf_views).contiguous(), z,
            _dists_scaled(z, d).contiguous(), noise, target.contiguous(), rcfg.white_bkgd, scale,
            rays.times.reshape(-1).contiguous(),
        )
        _set_grads(state.coarse, b1.unpack_tnerf_grads(grads, packed))
        mse0 = out.sqerr.sum() * scale
        state.apply_update()
        return {"loss": mse0, "psnr": mse_to_psnr(mse0), "total_loss": mse0}

    return train_step
