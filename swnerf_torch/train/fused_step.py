"""The kernel train steps (port of ``swnerf_tpu/train/fused_step.py``):
vanilla, coarse B1 pass -> B2 importance sample + sorted union -> fine B1
pass -> Adam (``make_fused_train_step``); T-NeRF, one B4 train pass -> Adam
(``make_fused_tnerf_step``); D-NeRF, the deformation MLP B6 and the
canonical passes (B3's pts mode, B5) composed under autograd with the TV
term -> Adam (``make_fused_dnerf_step``).

The vanilla and T-NeRF gradients come out of the render-loss kernel B1
itself (``ops/kernels/render_loss.py``), not from autograd: the step writes
them into each parameter's ``.grad`` and runs the optimizer. The D-NeRF
step wraps B5 and B6 in ``torch.autograd.Function``s whose backward hands
back the kernels' gradients. Random numbers, sampling and loss are those of
the eager steps (``train/loop.py``; tested against them). On CUDA tensors
the kernels run (bf16 operands by default); on CPU tensors, which must be
asked for, their plain twins (fp32).

Data parallelism (the JAX steps' ``axis_name`` / ``pmean`` under
``shard_map``): a step built with a ``group`` (``parallel/mesh.py``) is
called with the global batch and trains on its rank's rows of it
(``loop.shard_batch``): it draws the global batch's random numbers and
keeps its rows, scales its squared errors
by the global batch (``1 / (3 N_global)``; the D-NeRF TV term, a global
sum, enters unscaled), and after the backward sums every gradient and the
loss terms over the ranks with one all-reduce (``StepReducer``) before
Adam, so the sum is the global-batch gradient, uneven rows included.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from swnerf_torch.ops.embedding import positional_encoding
from swnerf_torch.ops.kernels import render_loss as b1
from swnerf_torch.ops.kernels import render_pass as b3
from swnerf_torch.ops.kernels import time_net as b6
from swnerf_torch.ops.sampling import sample_along_rays, sample_pdf_merge
from swnerf_torch.parallel.mesh import RaysGroup, reducer_for
from swnerf_torch.render.core import Draws, Rays, RenderConfig
from swnerf_torch.render.fused_eval import _dists_scaled, canonical_params
from swnerf_torch.train.loop import TrainState, mse_to_psnr, reduced_metrics, shard_batch, time_like


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


def _params(state: TrainState):
    return [p for m in state.modules() for p in m.parameters()]


def _set_grads(model, grads: Dict[str, torch.Tensor]) -> None:
    for name, p in model.named_parameters():
        g = grads[name]
        p.grad = g if p.grad is None else p.grad + g


def make_fused_train_step(cfg, rcfg: RenderConfig, fcfg=None, compute_dtype: Optional[torch.dtype] = None,
                          group: Optional[RaysGroup] = None):
    """Build ``(state, rays, target, generator=None, draws=None) -> metrics``
    with in-kernel gradients. ``cfg``/``fcfg`` are the coarse
    and fine model configs (``state.fine`` None: the coarse net serves both
    passes and its gradients from the two passes add). ``compute_dtype`` is
    B1's operand type; None means bf16 on the card and fp32 on the CPU.
    ``group``: the rays are the global batch, of which the step trains on
    its rank's rows and reduces as the module docstring says."""
    fine_cfg = fcfg if fcfg is not None else cfg
    reducer = reducer_for(group)

    def train_step(
        state: TrainState,
        rays: Rays,
        target: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Draws] = None,
    ) -> Dict[str, torch.Tensor]:
        dev = rays.origins.device
        rays, target, draws, rows = shard_batch(group, rcfg, rays, target, generator, draws)
        dtype = _dtype(compute_dtype, dev)
        scale = 1.0 / (3.0 * rows.total)  # d mse / d sqerr_r (the global batch's)
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
        terms = [outs_c.sqerr.sum() * scale]
        _set_grads(state.coarse, grads_c)
        if rcfg.n_importance > 0:
            det = rcfg.perturb == 0.0
            z_all = sample_pdf_merge(z_vals, outs_c.weights, rcfg.n_importance, det=det, u=None if det else draws.u)
            fine = state.fine if state.fine is not None else state.coarse
            outs_f, grads_f = run(fine, fine_cfg if state.fine is not None else cfg, z_all, noise_of(draws.noise1))
            _set_grads(fine, grads_f)  # the shared net adds the fine pass's gradients
            terms.append(outs_f.sqerr.sum() * scale)
        if reducer is not None:
            terms = reducer(_params(state), terms)
        if rcfg.n_importance > 0:
            mse0, mse1 = terms
            metrics = {"loss": mse1, "psnr": mse_to_psnr(mse1), "psnr0": mse_to_psnr(mse0), "total_loss": mse1 + mse0}
        else:
            (mse0,) = terms
            metrics = {"loss": mse0, "psnr": mse_to_psnr(mse0), "total_loss": mse0}
        state.apply_update()
        return metrics

    return train_step


def supports_fused_tnerf_step(cfg, rcfg: RenderConfig) -> bool:
    """B4 covers the single time-conditioned pass (the runner forces
    ``n_importance`` to 0, reference run_tnerf.py:329) with Fourier
    embeddings."""
    return b3.supports_tnerf(cfg) and rcfg.n_importance == 0


def make_fused_tnerf_step(cfg, rcfg: RenderConfig, compute_dtype: Optional[torch.dtype] = None,
                          group: Optional[RaysGroup] = None):
    """Build ``(state, rays, target, generator=None, draws=None) -> metrics``
    for a T-NeRF: one B4 train pass (the rays' frame times ride
    ``rays.times``), its gradients into ``.grad``, then Adam. Random numbers
    (``Draws``: t_rand, noise0) and loss are those of the eager
    ``make_train_step``. ``compute_dtype`` and ``group`` as for
    :func:`make_fused_train_step`."""
    reducer = reducer_for(group)

    def train_step(
        state: TrainState,
        rays: Rays,
        target: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Draws] = None,
    ) -> Dict[str, torch.Tensor]:
        dev = rays.origins.device
        rays, target, draws, rows = shard_batch(group, rcfg, rays, target, generator, draws)
        scale = 1.0 / (3.0 * rows.total)  # d mse / d sqerr_r (the global batch's)
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
        if reducer is not None:
            (mse0,) = reducer(_params(state), [mse0])
        state.apply_update()
        return {"loss": mse0, "psnr": mse_to_psnr(mse0), "total_loss": mse0}

    return train_step


def supports_fused_dnerf_step(cfg, fcfg, rcfg: RenderConfig) -> bool:
    """The kernel D-NeRF step covers a DirectTemporalNeRF whose canonical
    trunk B3/B5 take and whose deformation MLP B6 takes, in each model, with
    the same embedding sizes in both."""

    def one(c):
        return b3.supports_config(c) and b6.supports_time_net(c)

    ok = one(cfg) and rcfg.use_viewdirs
    if fcfg is not None:
        same = (fcfg.multires, fcfg.multires_views, fcfg.multires_time) == (
            cfg.multires, cfg.multires_views, cfg.multires_time)
        ok = ok and one(fcfg) and same
    return ok


def make_fused_dnerf_step(cfg, rcfg: RenderConfig, fcfg=None, add_tv_loss: bool = False, tv_loss_weight: float = 0.0,
                          compute_dtype: Optional[torch.dtype] = None, group: Optional[RaysGroup] = None):
    """Build ``(state, rays, target, neighbor_time, generator=None,
    draws=None) -> metrics`` for a DirectTemporalNeRF (``state.fine`` None:
    one model serves both passes), the port of ``make_fused_dnerf_step``
    (fused_step.py:350-620) on one device:

    1. B6 at the coarse points (its dx detached when the coarse pass adds no
       loss term: the shared model);
    2. the coarse canonical pass at ``pts + dx``: B3's pts mode, forward
       only, for the shared model; B5 (with gradients) for two models or a
       coarse-only render;
    3. B2 and a sort (``sample_pdf_merge``) on the coarse weights;
    4. with the TV loss, B6 over 2N rays in one launch: the fine points at
       the rays' times and at ``neighbor_time`` (``dx_pair``);
    5. B5 at ``pts_f + dx_f``;
    6. under autograd: the warp, the ``t == 0`` mask (``zero_canonical``)
       and ``tv = sum((dx_f - dx_n)^2) * tv_loss_weight`` (a global sum);
    7. ``loss.backward()`` runs B6's backward over the pair (B5's gradients
       come from its forward), then Adam.

    The weights are packed by plain torch from the parameters (in their
    dtype: fp32, or float64 for a float64 reference run on the twins), so
    autograd carries the kernels' packed gradients back to them; the kernels
    read them in ``compute_dtype`` (None: bf16 on the card, fp32 on the
    CPU). Random numbers (``Draws``) and loss are those of the eager
    ``make_dnerf_train_step``. ``group`` as for
    :func:`make_fused_train_step`; the TV term's local piece is summed
    (the JAX step pre-scales it by the axis size for its ``pmean``)."""
    fine_cfg = fcfg if fcfg is not None else cfg
    reducer = reducer_for(group)
    coarse_in_loss = rcfg.n_importance == 0 or rcfg.coarse_contributes

    def packs(model, mcfg):
        params = dict(model.named_parameters())
        pdt = next(model.parameters()).dtype  # float32; float64 for a float64 reference run
        return (b3.pack_params(canonical_params(params), mcfg, pdt), b6.pack_time_params(params, mcfg, pdt), mcfg)

    def train_step(state: TrainState, rays: Rays, target: torch.Tensor, neighbor_time,
                   generator: Optional[torch.Generator] = None, draws: Optional[Draws] = None
                   ) -> Dict[str, torch.Tensor]:
        dev = rays.origins.device
        rays, target, draws, rows = shard_batch(group, rcfg, rays, target, generator, draws)
        n = rows.n
        dtype = _dtype(compute_dtype, dev)
        scale = 1.0 / (3.0 * rows.total)  # d mse / d sqerr_r (the global batch's)
        o, d = rays.origins, rays.directions
        target = target.contiguous()
        vd_emb = positional_encoding(rays.viewdirs, cfg.nf_views).contiguous()
        t = rays.times.reshape(-1).contiguous()
        t_n = time_like(t, neighbor_time)

        def noise_of(x):
            return x.contiguous() if rcfg.raw_noise_std > 0.0 and x is not None else None

        def pts_of(z):
            return (o[:, None, :] + d[:, None, :] * z[..., None]).contiguous()

        def masked(dx, times, mcfg):
            if not mcfg.zero_canonical:
                return dx
            return torch.where((times == 0.0)[:, None, None], torch.zeros_like(dx), dx)

        def dx_at(tnet, mcfg, pts, grad: bool = True):
            if grad:
                return masked(b6.time_net_autograd(tnet, dtype, pts, t), t, mcfg)
            run = dataclasses.replace(tnet, weights=tnet.weights.detach().to(dtype), biases=tnet.biases.detach())
            return masked(b6.time_net(run, pts, t), t, mcfg)

        def dx_pair(tnet, mcfg, pts):
            """dx at the rays' times and at the neighbour time, for the same
            points, in one B6 launch over 2N rays."""
            t2 = torch.cat([t, t_n])
            dx2 = masked(b6.time_net_autograd(tnet, dtype, torch.cat([pts, pts]), t2), t2, mcfg)
            return dx2[:n], dx2[n:]

        def canonical_pass(canon, pts, z, noise, grad: bool):
            dists = _dists_scaled(z, d).contiguous()
            if grad:
                return b1.render_loss_pts_autograd(canon, dtype, pts, vd_emb, z, dists, noise, target,
                                                   rcfg.white_bkgd, scale)
            run = dataclasses.replace(canon, weights=canon.weights.detach().to(dtype), biases=canon.biases.detach())
            out = b3.render_pass(run, None, None, vd_emb, z, dists, noise, rcfg.white_bkgd, None, pts)
            return None, out

        state.zero_grad()
        canon_c, tnet_c, _ = packs(state.coarse, cfg)
        z_vals = sample_along_rays(rays.near, rays.far, rcfg.n_samples, rcfg.perturb, rcfg.lindisp,
                                   t_rand=draws.t_rand).contiguous()
        pts_c = pts_of(z_vals)
        dx_n = None
        if rcfg.n_importance == 0 and add_tv_loss:
            dx_c, dx_n = dx_pair(tnet_c, cfg, pts_c)
        else:
            dx_c = dx_at(tnet_c, cfg, pts_c, grad=coarse_in_loss)
        mse0, out_c = canonical_pass(canon_c, (pts_c + dx_c).contiguous(), z_vals, noise_of(draws.noise0),
                                     coarse_in_loss)
        if rcfg.n_importance > 0:
            det = rcfg.perturb == 0.0
            z_all = sample_pdf_merge(z_vals, out_c.weights.detach(), rcfg.n_importance, det=det,
                                     u=None if det else draws.u).contiguous()
            pts_f = pts_of(z_all)
            if state.fine is None:
                canon_f, tnet_f, f_cfg = canon_c, tnet_c, cfg
            else:
                canon_f, tnet_f, f_cfg = packs(state.fine, fine_cfg)
            if add_tv_loss:
                dx_f, dx_n = dx_pair(tnet_f, f_cfg, pts_f)
            else:
                dx_f = dx_at(tnet_f, f_cfg, pts_f)
            img_loss, _ = canonical_pass(canon_f, (pts_f + dx_f).contiguous(), z_all, noise_of(draws.noise1), True)
            img_loss0 = mse0 if coarse_in_loss else None
            dx_used = dx_f
        else:
            img_loss, img_loss0, dx_used = mse0, None, dx_c

        # The reference's order (run_dnerf.py:688-731): img_loss (+ tv) (+ img_loss0).
        loss = img_loss
        terms = {"loss": img_loss}
        if add_tv_loss:
            tv = torch.sum((dx_used - dx_n) ** 2) * tv_loss_weight
            loss = loss + tv
            terms["tv"] = tv
        if img_loss0 is not None:
            loss = loss + img_loss0
            terms["loss0"] = img_loss0
        terms["total_loss"] = loss
        loss.backward()
        return reduced_metrics(state, terms, reducer)

    return train_step
