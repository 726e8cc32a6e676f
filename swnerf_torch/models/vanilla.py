"""Vanilla NeRF MLP field (port of ``swnerf_tpu/models/vanilla.py``).

D=8, W=256 MLP with a skip concat of the embedded input after layer 4; with
view directions, an alpha head off the trunk, a feature layer, one W/2
view-conditioned layer and an rgb head. Parameter names are the reference
checkpoint's keys (``pts_linears.{i}``, ``views_linears.0``,
``feature_linear``, ``alpha_linear``, ``rgb_linear``), so
``load_state_dict`` takes a ``.tar``'s ``network_fn_state_dict`` as is.

The kernel route (``fused``, as ``make_vanilla_field(cfg, fused=None)``:
models/vanilla.py:151-243 there): the trunk runs kernel B7 on the embedded
inputs (``trunk_autograd`` under autograd, the forward-only launch under
``no_grad``), the embeddings detached unless ``SWNERF_FUSED_INPUT_GRADS=1``;
under ``SWNERF_FUSED_RAW=1`` with the Fourier encoding it runs B8 on the
positions and view directions instead (``field_raw_autograd`` /
``field_raw``). ``fused=None`` takes the route where
``utils/switches.py::kernel_route`` holds for the device (a card, the
switches on) and B7 covers the configuration, decided at construction; on
CPU tensors an explicit ``fused=True`` runs the kernels' plain twins.
Operands are ``utils/switches.py::operand_dtype``'s: bf16 on a card,
``compute_dtype`` where given (the parity mode the card's checks use).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn

from swnerf_torch.device import resolve_device
from swnerf_torch.models.common import (
    Field,
    dense,
    density_bias_floor,
    init_mlp_stack,
    safe_init_enabled,
    torch_linear_init,
)
from swnerf_torch.ops.embedding import embedding_dim, positional_encoding
from swnerf_torch.ops.kernels import trunk as b7
from swnerf_torch.utils.switches import input_grads, kernel_route, operand_dtype, raw_route


@dataclasses.dataclass(frozen=True)
class VanillaNeRFConfig:
    netdepth: int = 8
    netwidth: int = 256
    skips: Tuple[int, ...] = (4,)
    multires: int = 10  # positional-encoding freqs for xyz
    multires_views: int = 4  # positional-encoding freqs for view dirs
    i_embed: int = 0  # 0: fourier encoding, -1: identity
    use_viewdirs: bool = True
    output_ch: int = 4  # only used when use_viewdirs=False
    half_precision: bool = False  # bf16-rounded dense inputs and weights (common.dense)

    @property
    def nf_pts(self) -> int:
        return self.multires if self.i_embed == 0 else -1

    @property
    def nf_views(self) -> int:
        return self.multires_views if self.i_embed == 0 else -1

    @property
    def input_ch(self) -> int:
        return embedding_dim(self.nf_pts, 3)

    @property
    def input_ch_views(self) -> int:
        return embedding_dim(self.nf_views, 3) if self.use_viewdirs else 0


class VanillaNeRF(Field):
    """The vanilla field as an ``nn.Module`` on ``device`` (default
    ``cuda``), initialised from ``generator``. ``fused``: the kernel route
    (None: decided from the device and the switches); ``compute_dtype``: its
    parity mode (module docstring)."""

    def __init__(
        self,
        cfg: VanillaNeRFConfig,
        device: Optional[torch.device] = None,
        generator: Optional[torch.Generator] = None,
        init=torch_linear_init,
        fused: Optional[bool] = None,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        use = kernel_route(device) if fused is None else fused
        self.fused = bool(use) and b7.supports_trunk(cfg)
        self.compute_dtype = compute_dtype
        D, W, in_ch = cfg.netdepth, cfg.netwidth, cfg.input_ch
        # Layer i+1 takes W + input_ch when i is a skip (reference model.py:22-23).
        dims = [(in_ch, W)] + [((W + in_ch, W) if i in cfg.skips else (W, W)) for i in range(D - 1)]
        self.pts_linears = nn.ModuleList(init_mlp_stack(dims, generator, device, init))
        if cfg.use_viewdirs:
            self.views_linears = nn.ModuleList(
                init_mlp_stack([(cfg.input_ch_views + W, W // 2)], generator, device, init)
            )
            (self.feature_linear,) = init_mlp_stack([(W, W)], generator, device, init)
            (self.alpha_linear,) = init_mlp_stack([(W, 1)], generator, device, init)
            (self.rgb_linear,) = init_mlp_stack([(W // 2, 3)], generator, device, init)
        else:
            (self.output_linear,) = init_mlp_stack([(W, cfg.output_ch)], generator, device, init)
        if safe_init_enabled():
            if cfg.use_viewdirs:
                density_bias_floor(self.alpha_linear)
            else:
                density_bias_floor(self.output_linear, index=3)

    def mlp_layout(self) -> Tuple[List[List[str]], List[str]]:
        """``pts_linears`` and ``views_linears``; the heads ``feature_linear``,
        ``alpha_linear``, ``rgb_linear`` (``output_linear`` without view
        directions)."""
        stacks = [[f"pts_linears.{i}" for i in range(len(self.pts_linears))]]
        if not self.cfg.use_viewdirs:
            return stacks, ["output_linear"]
        stacks.append([f"views_linears.{i}" for i in range(len(self.views_linears))])
        return stacks, ["feature_linear", "alpha_linear", "rgb_linear"]

    def trunk(self, pts_emb: torch.Tensor, views_emb: Optional[torch.Tensor]) -> torch.Tensor:
        """The MLP on already-embedded inputs (``apply_vanilla_trunk``):
        raw ``[..., 4]`` (or ``[..., output_ch]`` without view directions)."""
        half = self.cfg.half_precision
        h = pts_emb
        for i, lyr in enumerate(self.pts_linears):
            h = torch.relu(dense(lyr, h, half))
            if i in self.cfg.skips:
                h = torch.cat([pts_emb, h], -1)
        if self.cfg.use_viewdirs:
            alpha = dense(self.alpha_linear, h, half)
            h = torch.cat([dense(self.feature_linear, h, half), views_emb], -1)
            for lyr in self.views_linears:
                h = torch.relu(dense(lyr, h, half))
            return torch.cat([dense(self.rgb_linear, h, half), alpha], -1)
        return dense(self.output_linear, h, half)

    def kernel_trunk(self, pts_emb: torch.Tensor, views_emb: torch.Tensor, need_input_grads: bool = False
                     ) -> torch.Tensor:
        """The trunk through B7 (``fused_trunk``): raw [..., 4] at pts_emb
        [..., cin] and views_emb [..., cv]. Under autograd the weights are
        packed differentiably and B7's backward runs; the embeddings keep
        their cotangents with ``need_input_grads`` or
        ``SWNERF_FUSED_INPUT_GRADS=1``, and are detached otherwise."""
        if not (need_input_grads or input_grads()):
            pts_emb, views_emb = pts_emb.detach(), views_emb.detach()
        lead = pts_emb.shape[:-1]
        emb = pts_emb.reshape(-1, pts_emb.shape[-1])
        vemb = views_emb.reshape(-1, views_emb.shape[-1]).contiguous()
        dtype = operand_dtype(emb.device, self.compute_dtype)
        return b7.apply_field(self, b7.pack_trunk_params, dtype, emb, vemb).reshape(*lead, 4)

    def kernel_field_raw(self, pts: torch.Tensor, viewdirs: torch.Tensor) -> torch.Tensor:
        """The field through B8 (``fused_field_raw``): raw [..., 4] at pts
        [..., 3] and per-row view directions [..., 3], the encodes inside
        the kernel. Under autograd B8's backward runs, with d pts and
        d viewdirs where they require gradients."""
        lead = pts.shape[:-1]
        p3 = pts.reshape(-1, 3).contiguous()
        v3 = viewdirs.reshape(-1, 3).contiguous()
        dtype = operand_dtype(p3.device, self.compute_dtype)
        return b7.apply_field(self, b7.pack_trunk_params, dtype, p3, v3, raw=True).reshape(*lead, 4)

    def uses_field_raw(self) -> bool:
        """B8 runs in place of B7: the kernel route, the Fourier encoding and
        ``SWNERF_FUSED_RAW=1`` (read at each call, as the JAX field reads it
        at each trace)."""
        return self.fused and self.cfg.i_embed == 0 and raw_route()

    def apply_embedded(self, pts_emb: torch.Tensor, views_emb: Optional[torch.Tensor]) -> torch.Tensor:
        """raw at embedded inputs through the field's route: B7, or the plain
        trunk."""
        if self.fused:
            return self.kernel_trunk(pts_emb, views_emb)
        return self.trunk(pts_emb, views_emb)

    def forward(
        self, pts: torch.Tensor, viewdirs: Optional[torch.Tensor] = None, times: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """pts [N, S, 3], viewdirs [N, 3] -> raw [N, S, 4]; ``times`` is
        ignored (the render core passes every field the rays' times)."""
        if self.uses_field_raw():
            return self.kernel_field_raw(pts, viewdirs[..., None, :].expand(pts.shape))
        pts_emb = positional_encoding(pts, self.cfg.nf_pts)
        views_emb = None
        if self.cfg.use_viewdirs:
            # Embed per ray, then broadcast along the samples.
            ve = positional_encoding(viewdirs, self.cfg.nf_views)
            views_emb = ve[..., None, :].expand(*pts.shape[:-1], ve.shape[-1])
        return self.apply_embedded(pts_emb, views_emb)

    def query_views(self, pts: torch.Tensor, viewdirs: torch.Tensor) -> torch.Tensor:
        """raw [V, C, 4] at every point pts [C, 3] seen from every direction
        viewdirs [V, 3] (the mesh sweep's tile). The points and the
        directions are each embedded once and the embeddings broadcast, not
        re-encoded per direction; under ``SWNERF_FUSED_RAW=1`` B8 encodes
        both in the kernel."""
        V, C = viewdirs.shape[0], pts.shape[0]
        if self.uses_field_raw():
            return self.kernel_field_raw(pts[None].expand(V, C, 3), viewdirs[:, None, :].expand(V, C, 3))
        pe = positional_encoding(pts, self.cfg.nf_pts)
        ve = positional_encoding(viewdirs, self.cfg.nf_views) if self.cfg.use_viewdirs else None
        return self.apply_embedded(pe[None].expand(V, C, pe.shape[-1]),
                                   None if ve is None else ve[:, None, :].expand(V, C, ve.shape[-1]))
