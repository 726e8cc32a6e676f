"""Vanilla NeRF MLP field (port of ``swnerf_tpu/models/vanilla.py``).

D=8, W=256 MLP with a skip concat of the embedded input after layer 4; with
view directions, an alpha head off the trunk, a feature layer, one W/2
view-conditioned layer and an rgb head. Parameter names are the reference
checkpoint's keys (``pts_linears.{i}``, ``views_linears.0``,
``feature_linear``, ``alpha_linear``, ``rgb_linear``), so
``load_state_dict`` takes a ``.tar``'s ``network_fn_state_dict`` as is.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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
    ``cuda``), initialised from ``generator``."""

    def __init__(
        self,
        cfg: VanillaNeRFConfig,
        device: Optional[torch.device] = None,
        generator: Optional[torch.Generator] = None,
        init=torch_linear_init,
    ):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
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

    def trunk(self, pts_emb: torch.Tensor, views_emb: Optional[torch.Tensor]) -> torch.Tensor:
        """The MLP on already-embedded inputs (``apply_vanilla_trunk``):
        raw ``[..., 4]`` (or ``[..., output_ch]`` without view directions)."""
        h = pts_emb
        for i, lyr in enumerate(self.pts_linears):
            h = torch.relu(dense(lyr, h))
            if i in self.cfg.skips:
                h = torch.cat([pts_emb, h], -1)
        if self.cfg.use_viewdirs:
            alpha = dense(self.alpha_linear, h)
            h = torch.cat([dense(self.feature_linear, h), views_emb], -1)
            for lyr in self.views_linears:
                h = torch.relu(dense(lyr, h))
            return torch.cat([dense(self.rgb_linear, h), alpha], -1)
        return dense(self.output_linear, h)

    def forward(
        self, pts: torch.Tensor, viewdirs: Optional[torch.Tensor] = None, times: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """pts [N, S, 3], viewdirs [N, 3] -> raw [N, S, 4]; ``times`` is
        ignored (the render core passes every field the rays' times)."""
        pts_emb = positional_encoding(pts, self.cfg.nf_pts)
        views_emb = None
        if self.cfg.use_viewdirs:
            # Embed per ray, then broadcast along the samples.
            ve = positional_encoding(viewdirs, self.cfg.nf_views)
            views_emb = ve[..., None, :].expand(*pts.shape[:-1], ve.shape[-1])
        return self.trunk(pts_emb, views_emb)
