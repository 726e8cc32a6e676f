"""D-NeRF fields: a canonical NeRF and a deformation ("time") MLP (port of
``swnerf_tpu/models/dnerf.py``).

* :class:`NeRFOriginal` (``--nerf_type original``): the vanilla trunk with
  kaiming-normal weights (reference model.py:270-272); its forward returns
  ``(raw, {"dx": 0})``.
* :class:`DirectTemporalNeRF` (``--nerf_type direct_temporal``): the
  deformation MLP maps ``[embed(x) | embed(t)]`` to ``dx`` (its skip
  concatenates ``embed(x)`` only, model.py:113-136; torch's default Linear
  init), and the canonical network is queried at ``x + dx``. With
  ``zero_canonical`` the deformation is zero where ``t == 0``, per ray, as
  the JAX package writes the reference's one-time-per-batch branch
  (model.py:142-146); an exact ``dx = 0`` gives the same embedding.

A field's forward returns ``(raw, {"dx": dx})``; the render core carries
``dx`` out for the TV loss. The modules are registered in the reference's
order (``_occ``, ``_time``, ``_time_out``), so a ``.tar``'s
``network_fn_state_dict`` loads as is and torch Adam's state maps onto the
same tensors.

The kernel route (``fused``, as ``make_dnerf_field(cfg, fused=None)``:
models/dnerf.py:182-290 there): the deformation MLP runs kernel B6
(``time_net_autograd``, the positions detached) and the canonical trunk
kernel B7 (``VanillaNeRF.kernel_trunk``) on the embedded ``x + dx``; B7's
input cotangent carries the loss into the deformation net. ``original``
runs B7 without input gradients (its embeddings detached unless
``SWNERF_FUSED_INPUT_GRADS=1``, as ``_trunk_apply`` reads it).
``fused=None`` takes the route where ``utils/switches.py::kernel_route``
holds (a card, ``SWNERF_FUSED`` not 0, ``SWNERF_FUSED_DTYPE=bf16``) for
the configurations the kernels cover (``supports_time_net``,
``supports_trunk``), decided at construction; ``SWNERF_FUSED=0`` or
``SWNERF_FUSED_DTYPE=f32`` give the fp32 plain route. On CPU tensors an
explicit ``fused=True`` runs the kernels' plain twins. Operands are
``switches.operand_dtype``'s (bf16 on the card, fp32 on the CPU); without
autograd (rendering) the forward-only launches run. ``compute_dtype`` is
the parity mode alone, as the fused steps' and eval passes' argument of
that name: the card's checks pass ``torch.float32`` to hold the route
against the plain one. No trainer sets it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from swnerf_torch.device import resolve_device
from swnerf_torch.models.common import Field, dense, init_mlp_stack, kaiming_linear_init
from swnerf_torch.models.vanilla import VanillaNeRF
from swnerf_torch.ops.embedding import embedding_dim, positional_encoding
from swnerf_torch.ops.kernels import time_net as b6
from swnerf_torch.ops.kernels import trunk as b7
from swnerf_torch.utils.switches import kernel_route, operand_dtype


@dataclasses.dataclass(frozen=True)
class DNeRFConfig:
    netdepth: int = 8
    netwidth: int = 256
    skips: Tuple[int, ...] = (4,)
    multires: int = 10  # xyz frequencies; also the time's unless multires_time is set
    multires_views: int = 4
    multires_time: Optional[int] = None
    i_embed: int = 0
    use_viewdirs: bool = True
    output_ch: int = 4
    zero_canonical: bool = True
    # --do_half_precision: bf16-rounded dense inputs and weights on the plain route
    half_precision: bool = False

    @property
    def nf_pts(self) -> int:
        return self.multires if self.i_embed == 0 else -1

    @property
    def nf_views(self) -> int:
        return self.multires_views if self.i_embed == 0 else -1

    @property
    def nf_time(self) -> int:
        if self.i_embed != 0:
            return -1
        return self.multires if self.multires_time is None else self.multires_time

    @property
    def input_ch(self) -> int:
        return embedding_dim(self.nf_pts, 3)

    @property
    def input_ch_views(self) -> int:
        return embedding_dim(self.nf_views, 3) if self.use_viewdirs else 0

    @property
    def input_ch_time(self) -> int:
        return embedding_dim(self.nf_time, 1)


class NeRFOriginal(VanillaNeRF):
    """The canonical network: the vanilla trunk (same parameter names) with
    kaiming init, on ``device`` (default ``cuda``), drawn from
    ``generator``. Its forward ignores the times and returns a zero
    deformation; on the kernel route (``fused``, see the module docstring)
    its trunk runs B7 without input gradients."""

    def __init__(self, cfg: DNeRFConfig, device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None, fused: Optional[bool] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(cfg, device, generator, init=kaiming_linear_init, fused=fused, compute_dtype=compute_dtype)

    def forward(self, pts: torch.Tensor, viewdirs: Optional[torch.Tensor] = None,
                times: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        pts_emb = positional_encoding(pts, self.cfg.nf_pts)
        views_emb = None
        if self.cfg.use_viewdirs:
            ve = positional_encoding(viewdirs, self.cfg.nf_views)
            views_emb = ve[..., None, :].expand(*pts.shape[:-1], ve.shape[-1])
        return self.apply_embedded(pts_emb, views_emb), {"dx": torch.zeros_like(pts)}


class DirectTemporalNeRF(Field):
    """The D-NeRF field on ``device`` (default ``cuda``): ``_occ``, the
    canonical :class:`NeRFOriginal`, then the deformation MLP ``_time``
    (``netdepth`` layers) and ``_time_out`` (W -> 3), drawn from
    ``generator`` in that order. ``fused``: the kernel route;
    ``compute_dtype``: its parity mode (module docstring)."""

    def __init__(self, cfg: DNeRFConfig, device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None, fused: Optional[bool] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        use = kernel_route(device) if fused is None else fused
        self.fused_time = use and b6.supports_time_net(cfg)
        self.fused_trunk = use and b7.supports_trunk(cfg)
        self.compute_dtype = compute_dtype
        # the canonical network: its trunk runs B7 through kernel_trunk below
        self._occ = NeRFOriginal(cfg, device, generator, fused=False, compute_dtype=compute_dtype)
        D, W, in_x = cfg.netdepth, cfg.netwidth, cfg.input_ch
        dims = [(in_x + cfg.input_ch_time, W)] + [((W + in_x, W) if i in cfg.skips else (W, W)) for i in range(D - 1)]
        self._time = nn.ModuleList(init_mlp_stack(dims, generator, device))
        (self._time_out,) = init_mlp_stack([(W, 3)], generator, device)

    def mlp_layout(self) -> Tuple[List[List[str]], List[str]]:
        """The canonical network's under ``_occ.``, then the deformation
        stack ``_time`` and its head ``_time_out``."""
        stacks, heads = self._occ.mlp_layout()
        stacks = [[f"_occ.{n}" for n in s] for s in stacks] + [[f"_time.{i}" for i in range(len(self._time))]]
        return stacks, [f"_occ.{n}" for n in heads] + ["_time_out"]

    def time_net(self, pts_emb: torch.Tensor, time_emb: torch.Tensor) -> torch.Tensor:
        """``apply_time_net``: [embed(x) | embed(t)] -> dx, the skip
        concatenating embed(x) only."""
        h = torch.cat([pts_emb, time_emb], -1)
        half = self.cfg.half_precision
        for i, lyr in enumerate(self._time):
            h = torch.relu(dense(lyr, h, half))
            if i in self.cfg.skips:
                h = torch.cat([pts_emb, h], -1)
        return dense(self._time_out, h, half)

    def forward(self, pts: torch.Tensor, viewdirs: Optional[torch.Tensor], times: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """pts [N, S, 3], viewdirs [N, 3], times [N, 1] (per ray) -> (raw
        [N, S, 4], {"dx": [N, S, 3]})."""
        cfg = self.cfg
        t = times[..., None, :].expand(*pts.shape[:-1], 1)
        dtype = operand_dtype(pts.device, self.compute_dtype)
        if self.fused_time:
            params = dict(self.named_parameters())
            tr = times.reshape(-1)
            if torch.is_grad_enabled():
                pdt = self._time_out.weight.dtype
                dx = b6.time_net_autograd(b6.pack_time_params(params, cfg, pdt), dtype, pts, tr)
            else:
                dx = b6.time_net(b6.pack_time_params(params, cfg, dtype), pts.contiguous(), tr.contiguous())
        else:
            dx = self.time_net(positional_encoding(pts, cfg.nf_pts), positional_encoding(t, cfg.nf_time))
        if cfg.zero_canonical:
            dx = torch.where(t == 0.0, torch.zeros_like(dx), dx)
        views_emb = None
        if cfg.use_viewdirs:
            ve = positional_encoding(viewdirs, cfg.nf_views)
            views_emb = ve[..., None, :].expand(*pts.shape[:-1], ve.shape[-1])
        pts_emb = positional_encoding(pts + dx, cfg.nf_pts)
        if self.fused_trunk:
            return self._occ.kernel_trunk(pts_emb, views_emb, need_input_grads=True), {"dx": dx}
        return self._occ.trunk(pts_emb, views_emb), {"dx": dx}


def make_dnerf_model(kind: str, cfg: DNeRFConfig, device: Optional[torch.device] = None,
                     generator: Optional[torch.Generator] = None, fused: Optional[bool] = None) -> Field:
    """``--nerf_type``: ``original`` (:class:`NeRFOriginal`) or
    ``direct_temporal`` (:class:`DirectTemporalNeRF`); ``fused`` as theirs."""
    if kind == "original":
        return NeRFOriginal(cfg, device, generator, fused=fused)
    if kind == "direct_temporal":
        return DirectTemporalNeRF(cfg, device, generator, fused=fused)
    raise ValueError(f"nerf_type {kind!r} not recognized")
