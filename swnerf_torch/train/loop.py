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

The trainers' states (``init_train_state(graphs=True)``) run, on a card,
torch's fused Adam, ``capturable``, whose learning rate is a device tensor
formed from a device-side update count, so that a step captured in a CUDA
graph (``pipelines/common.py::KStepRoute``) reads the schedule and advances
the count on every replay. A one-step dispatch runs the same Adam, so that
both dispatches give the same bits; the fused kernel's arithmetic does not
depend on ``capturable``. Every other state, and every state on the CPU,
runs torch's default Adam, which the tests hold to optax.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Union

import torch
from torch import nn

from swnerf_torch.parallel.mesh import RaysGroup, Rows, StepReducer, batch_rows, reducer_for
from swnerf_torch.render.core import Draws, Rays, RenderConfig, make_draws, render_rays


def mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def mse_to_psnr(x):
    """-10 log10(x), on a tensor or a float."""
    if isinstance(x, torch.Tensor):
        return -10.0 * torch.log(x) / math.log(10.0)
    return -10.0 * math.log(x) / math.log(10.0)


def exp_decay_schedule(lrate: float, lrate_decay: int) -> Callable:
    """lr(step) = lrate * 0.1^(step / (lrate_decay * 1000)); ``step`` an int,
    or a float64 tensor (the device count), giving a float64 tensor."""
    decay_steps = float(lrate_decay) * 1000.0

    def schedule(step):
        return lrate * (0.1 ** (step / decay_steps))

    return schedule


def make_optimizer(modules: List[Optional[nn.Module]], lrate: Union[float, torch.Tensor] = 5e-4
                   ) -> torch.optim.Adam:
    """Adam (torch defaults, as the reference) over the parameters of
    ``modules`` in order, skipping None: ``[*coarse.parameters(),
    *fine.parameters()]``, the reference's ``grad_vars`` and its checkpoint's
    optimizer-state order. A tensor ``lrate`` makes it fused and
    ``capturable``: its learning rate and update counts live on the device."""
    params = [p for m in modules if m is not None for p in m.parameters()]
    on_device = isinstance(lrate, torch.Tensor)
    return torch.optim.Adam(params, lr=lrate, betas=(0.9, 0.999), eps=1e-8, capturable=on_device,
                            fused=on_device or None)


@dataclasses.dataclass
class TrainState:
    """Models, optimizer and the count of updates done (``step``). With
    ``graphs`` on a card the count lives on the device too (``count``,
    int64), and Adam reads its learning rate from ``lr`` (fp32), which each
    update sets from ``count``:
    a step captured in a CUDA graph then follows the schedule on every
    replay, and whoever replays it advances ``step``, the host's mirror, by
    one a replay. Set the count with :meth:`set_step`."""

    step: int
    coarse: nn.Module
    fine: Optional[nn.Module]
    optimizer: torch.optim.Adam
    schedule: Callable
    count: Optional[torch.Tensor] = None
    lr: Optional[torch.Tensor] = None

    def modules(self) -> List[nn.Module]:
        return [m for m in (self.coarse, self.fine) if m is not None]

    def zero_grad(self) -> None:
        for m in self.modules():
            m.zero_grad(set_to_none=True)

    def set_step(self, n: int) -> None:
        """``step`` and, on a card, the device count (a resume)."""
        self.step = n
        if self.count is not None:
            self.count.fill_(n)

    def apply_update(self) -> None:
        """One Adam update at the scheduled learning rate."""
        if self.count is None:
            for group in self.optimizer.param_groups:
                group["lr"] = self.schedule(self.step)
            self.optimizer.step()
        else:
            self.lr.copy_(self.schedule(self.count.double()))
            self.optimizer.step()
            self.count += 1
        self.step += 1

    def _loaded(self, optimizer: torch.optim.Adam) -> None:
        """After a ``load_state_dict``, which takes the saved groups' ``lr``,
        ``capturable`` and ``fused``: with the device count the groups read
        ``lr`` again and each update count moves to its parameter's device;
        otherwise Adam is torch's default (a checkpoint written by a card's
        trainer says fused and capturable)."""
        for group in optimizer.param_groups:
            group["capturable"] = self.count is not None
            group["fused"] = self.count is not None or None
            if self.count is None:
                continue
            group["lr"] = self.lr
            for p in group["params"]:
                st = optimizer.state.get(p)
                if st and "step" in st:
                    st["step"] = torch.as_tensor(st["step"], dtype=torch.float32).to(p.device)


def init_train_state(
    coarse: nn.Module, fine: Optional[nn.Module], lrate: float = 5e-4, lrate_decay: int = 250, step: int = 0,
    graphs: bool = False,
) -> TrainState:
    """A :class:`TrainState` at ``step``. ``graphs`` (the trainers whose
    steps :class:`~swnerf_torch.pipelines.common.KStepRoute` dispatches): on
    a card, with the fused Adam, device count and learning rate that a
    captured step reads; else, and on the CPU, torch's default Adam."""
    schedule = exp_decay_schedule(lrate, lrate_decay)
    dev = next(coarse.parameters()).device
    count = lr = None
    if graphs and dev.type == "cuda":
        count = torch.tensor(step, dtype=torch.int64, device=dev)
        lr = torch.tensor(schedule(step), dtype=torch.float32, device=dev)
    state = TrainState(step, coarse, fine, make_optimizer([coarse, fine], lrate if lr is None else lr), schedule,
                       count, lr)
    state.optimizer.register_load_state_dict_post_hook(state._loaded)
    return state


def time_like(t: torch.Tensor, value: Union[float, torch.Tensor]) -> torch.Tensor:
    """``t``'s shape filled with ``value``: a Python float, or a 0-d tensor on
    ``t``'s device (the dispatch loop's neighbour time), read there with no
    host synchronization."""
    if isinstance(value, torch.Tensor):
        return value.to(t.dtype).expand_as(t).contiguous()
    return torch.full_like(t, float(value))


@contextlib.contextmanager
def field_operands(modules: List[nn.Module], dtype: Optional[torch.dtype]):
    """Inside the block the fields' kernel route runs ``dtype`` operands
    (their ``compute_dtype``, the parity mode); None changes nothing."""
    if dtype is None:
        yield
        return
    saved = [m.compute_dtype for m in modules]
    for m in modules:
        m.compute_dtype = dtype
    try:
        yield
    finally:
        for m, d in zip(modules, saved):
            m.compute_dtype = d


def reduced_metrics(state: TrainState, terms: Dict[str, torch.Tensor], reducer: Optional[StepReducer]
                    ) -> Dict[str, torch.Tensor]:
    """After a step's backward: sum the gradients and the loss ``terms``
    (``loss``, optional ``tv`` and ``loss0``, ``total_loss``) over the ranks
    where there is a ``reducer``, run Adam, and return the metrics from the
    summed terms: loss, psnr, tv, psnr0, total_loss (detached)."""
    vals = {k: v.detach() for k, v in terms.items()}
    if reducer is not None:
        vals = dict(zip(vals, reducer([p for m in state.modules() for p in m.parameters()], list(vals.values()))))
    metrics = {"loss": vals["loss"], "psnr": mse_to_psnr(vals["loss"])}
    if "tv" in vals:
        metrics["tv"] = vals["tv"]
    if "loss0" in vals:
        metrics["psnr0"] = mse_to_psnr(vals["loss0"])
    metrics["total_loss"] = vals["total_loss"]
    state.apply_update()
    return metrics


def shard_batch(group: Optional[RaysGroup], cfg: RenderConfig, rays: Rays, target: torch.Tensor,
                generator: Optional[torch.Generator], draws: Optional[Draws]):
    """A step's inputs on this rank: the global batch's random numbers
    (``draws``, else drawn from ``generator``, so every rank draws what one
    process would) and this rank's rows of the rays, the target and the
    draws (``parallel/mesh.py::batch_rows``). Returns ``(rays, target,
    draws, rows)``; without a group the inputs as they are and all rows."""
    n = rays.origins.shape[0]
    if draws is None:
        draws = make_draws(cfg, n, generator, rays.origins.device)
    rows = batch_rows(group, n)
    if group is None:
        return rays, target, draws, rows
    return rows.take_fields(rays), rows.take(target), rows.take_fields(draws), rows


def _share(rows: Rows) -> Optional[float]:
    """A rank's share of the global batch, by which its MSE (a mean over its
    rows) is a piece of the global mean; None for the whole batch."""
    return None if rows.n == rows.total else rows.n / rows.total


def _piece(loss: torch.Tensor, share: Optional[float]) -> torch.Tensor:
    return loss if share is None else loss * share


def make_train_step(cfg: RenderConfig, compute_dtype: Optional[torch.dtype] = None, group: Optional[RaysGroup] = None):
    """Build ``(state, rays, target, generator=None, draws=None) -> metrics``.

    Random numbers come from ``draws`` when given, else from ``generator``
    (as :func:`~swnerf_torch.render.core.make_draws` draws them). Metrics are
    detached tensors: loss (fine MSE), psnr, psnr0 (coarse), total_loss.
    ``compute_dtype`` (vanilla fields) sets the fields' operand type for the
    step: fp32 for ``run_nerf``'s warm start on a card, where the fields run
    B7 in bf16 by default. ``group`` (``parallel/mesh.py``; the JAX
    package's ``shard_cli_step``): the rays, target and draws are the global
    batch's, of which the step trains on its rank's rows
    (:func:`shard_batch`); each MSE is weighted by the rows' share of the
    batch, and the gradients and loss terms are summed over the ranks
    before Adam.
    """
    reducer = reducer_for(group)

    def train_step(
        state: TrainState,
        rays: Rays,
        target: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Draws] = None,
    ) -> Dict[str, torch.Tensor]:
        rays, target, draws, rows = shard_batch(group, cfg, rays, target, generator, draws)
        share = _share(rows)
        state.zero_grad()
        with field_operands(state.modules(), compute_dtype):
            out = render_rays(state.coarse, rays, cfg, fine_model=state.fine, draws=draws)
        img_loss = _piece(mse(out["rgb"], target), share)
        loss = img_loss
        terms = {"loss": img_loss}
        if "rgb0" in out:
            img_loss0 = _piece(mse(out["rgb0"], target), share)
            loss = loss + img_loss0
            terms["loss0"] = img_loss0
        terms["total_loss"] = loss
        loss.backward()
        return reduced_metrics(state, terms, reducer)

    return train_step


def make_dnerf_train_step(cfg: RenderConfig, add_tv_loss: bool, tv_loss_weight: float,
                          group: Optional[RaysGroup] = None):
    """The eager D-NeRF step (port of ``swnerf_tpu/pipelines/run_dnerf.py::
    make_dnerf_step``): ``(state, rays, target, neighbor_time,
    generator=None, draws=None) -> metrics``. It renders through
    ``render_rays``; with the TV loss it re-renders the same rays at
    ``neighbor_time`` on the first render's (detached) z_vals and adds
    ``sum((dx - dx_neighbour)^2) * tv_loss_weight``; then the MSE terms,
    autograd and Adam. The reference the kernel step
    (``fused_step.make_fused_dnerf_step``) is held to. ``group`` as for
    :func:`make_train_step`; the TV term, a sum, enters unweighted."""
    reducer = reducer_for(group)

    def train_step(
        state: TrainState,
        rays: Rays,
        target: torch.Tensor,
        neighbor_time: Union[float, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        draws: Optional[Draws] = None,
    ) -> Dict[str, torch.Tensor]:
        rays, target, draws, rows = shard_batch(group, cfg, rays, target, generator, draws)
        share = _share(rows)
        state.zero_grad()
        out = render_rays(state.coarse, rays, cfg, fine_model=state.fine, draws=draws)
        img_loss = _piece(mse(out["rgb"], target), share)
        loss = img_loss
        terms = {"loss": img_loss}
        if add_tv_loss:
            rays_n = rays._replace(times=time_like(rays.times, neighbor_time))
            out_n = render_rays(state.coarse, rays_n, cfg, fine_model=state.fine, draws=draws,
                                z_vals=out["z_vals"].detach())
            tv = torch.sum((out["dx"] - out_n["dx"]) ** 2) * tv_loss_weight
            loss = loss + tv
            terms["tv"] = tv
        if "rgb0" in out:
            img_loss0 = _piece(mse(out["rgb0"], target), share)
            loss = loss + img_loss0
            terms["loss0"] = img_loss0
        terms["total_loss"] = loss
        loss.backward()
        return reduced_metrics(state, terms, reducer)

    return train_step
