"""Train state, Adam with the reference's learning-rate decay, and the eager
train step (port of ``swnerf_tpu/train/loop.py``).

The loss is the reference's ``mse(rgb, target) [+ mse(rgb0, target)]``
(nerf/run.py:683-708) and the optimizer is Adam (betas 0.9/0.999, eps 1e-8)
whose learning rate before the n-th update (n updates already done) is
``lrate * 0.1^(n / (lrate_decay * 1000))``, what optax's
``scale_by_learning_rate`` reads in the JAX package.

``make_train_step`` is the autograd step through ``render_rays``: the
reference the kernel steps (``train/fused_step.py``) are held to, and the
path for configurations they do not cover. With a T-NeRF field (no fine
model) and rays that carry their frame times it is also the eager T-NeRF
step, the port of ``swnerf_tpu/pipelines/run_dnerf.py::make_dnerf_step``
without its TV branch: render with times, MSE, autograd, Adam;
``make_dnerf_train_step`` is that step with the TV branch. A step updates the
:class:`TrainState` in place and leaves each parameter's gradient in
``.grad`` until the next step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from swnerf_torch.render.core import Draws, Rays, RenderConfig, make_draws, render_rays


def mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def mse_to_psnr(x):
    """-10 log10(x), on a tensor or a float."""
    if isinstance(x, torch.Tensor):
        return -10.0 * torch.log(x) / math.log(10.0)
    return -10.0 * math.log(x) / math.log(10.0)


def exp_decay_schedule(lrate: float, lrate_decay: int) -> Callable[[int], float]:
    """lr(step) = lrate * 0.1^(step / (lrate_decay * 1000))."""
    decay_steps = float(lrate_decay) * 1000.0

    def schedule(step: int) -> float:
        return lrate * (0.1 ** (step / decay_steps))

    return schedule


def make_optimizer(modules: List[Optional[nn.Module]], lrate: float = 5e-4) -> torch.optim.Adam:
    """Adam (torch defaults, as the reference) over the parameters of
    ``modules`` in order, skipping None: ``[*coarse.parameters(),
    *fine.parameters()]``, the reference's ``grad_vars`` and its checkpoint's
    optimizer-state order."""
    params = [p for m in modules if m is not None for p in m.parameters()]
    return torch.optim.Adam(params, lr=lrate, betas=(0.9, 0.999), eps=1e-8)


@dataclasses.dataclass
class TrainState:
    """Models, optimizer and the count of updates done (``step``)."""

    step: int
    coarse: nn.Module
    fine: Optional[nn.Module]
    optimizer: torch.optim.Adam
    schedule: Callable[[int], float]

    def modules(self) -> List[nn.Module]:
        return [m for m in (self.coarse, self.fine) if m is not None]

    def zero_grad(self) -> None:
        for m in self.modules():
            m.zero_grad(set_to_none=True)

    def apply_update(self) -> None:
        """One Adam update at the scheduled learning rate."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.step += 1


def init_train_state(
    coarse: nn.Module, fine: Optional[nn.Module], lrate: float = 5e-4, lrate_decay: int = 250, step: int = 0
) -> TrainState:
    return TrainState(step, coarse, fine, make_optimizer([coarse, fine], lrate), exp_decay_schedule(lrate, lrate_decay))


def make_train_step(cfg: RenderConfig):
    """Build ``(state, rays, target, generator=None, draws=None) -> metrics``.

    Random numbers come from ``draws`` when given, else from ``generator``
    (as :func:`~swnerf_torch.render.core.make_draws` draws them). Metrics are
    detached tensors: loss (fine MSE), psnr, psnr0 (coarse), total_loss.
    """

    def train_step(
        state: TrainState,
        rays: Rays,
        target: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Draws] = None,
    ) -> Dict[str, torch.Tensor]:
        if draws is None:
            draws = make_draws(cfg, rays.origins.shape[0], generator, rays.origins.device)
        state.zero_grad()
        out = render_rays(state.coarse, rays, cfg, fine_model=state.fine, draws=draws)
        img_loss = mse(out["rgb"], target)
        loss = img_loss
        metrics = {"loss": img_loss.detach(), "psnr": mse_to_psnr(img_loss.detach())}
        if "rgb0" in out:
            img_loss0 = mse(out["rgb0"], target)
            loss = loss + img_loss0
            metrics["psnr0"] = mse_to_psnr(img_loss0.detach())
        metrics["total_loss"] = loss.detach()
        loss.backward()
        state.apply_update()
        return metrics

    return train_step


def make_dnerf_train_step(cfg: RenderConfig, add_tv_loss: bool, tv_loss_weight: float):
    """The eager D-NeRF step (port of ``swnerf_tpu/pipelines/run_dnerf.py::
    make_dnerf_step``): ``(state, rays, target, neighbor_time,
    generator=None, draws=None) -> metrics``. It renders through
    ``render_rays``; with the TV loss it re-renders the same rays at
    ``neighbor_time`` on the first render's (detached) z_vals and adds
    ``sum((dx - dx_neighbour)^2) * tv_loss_weight``; then the MSE terms,
    autograd and Adam. The reference the kernel step
    (``fused_step.make_fused_dnerf_step``) is held to."""

    def train_step(
        state: TrainState,
        rays: Rays,
        target: torch.Tensor,
        neighbor_time: float,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Draws] = None,
    ) -> Dict[str, torch.Tensor]:
        if draws is None:
            draws = make_draws(cfg, rays.origins.shape[0], generator, rays.origins.device)
        state.zero_grad()
        out = render_rays(state.coarse, rays, cfg, fine_model=state.fine, draws=draws)
        img_loss = mse(out["rgb"], target)
        loss = img_loss
        metrics = {"loss": img_loss.detach(), "psnr": mse_to_psnr(img_loss.detach())}
        if add_tv_loss:
            rays_n = rays._replace(times=torch.full_like(rays.times, float(neighbor_time)))
            out_n = render_rays(state.coarse, rays_n, cfg, fine_model=state.fine, draws=draws,
                                z_vals=out["z_vals"].detach())
            tv = torch.sum((out["dx"] - out_n["dx"]) ** 2) * tv_loss_weight
            loss = loss + tv
            metrics["tv"] = tv.detach()
        if "rgb0" in out:
            img_loss0 = mse(out["rgb0"], target)
            loss = loss + img_loss0
            metrics["psnr0"] = mse_to_psnr(img_loss0.detach())
        metrics["total_loss"] = loss.detach()
        loss.backward()
        state.apply_update()
        return metrics

    return train_step
