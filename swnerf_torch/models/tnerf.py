"""T-NeRF field: one time-conditioned network, no deformation and no fine
pass (port of ``swnerf_tpu/models/tnerf.py``).

Input ``[embed(x) (in_feat) | embed(t) (time_feat)]``, ELU activations, a
skip concatenation of the full (position + time) input after layer
``skip_layer``, separate density and feature heads, a view-conditioned
``net_dim / 2`` layer, and a ReLU'd colour head whose output the compositor
still passes through its sigmoid (the reference's quirk, kept).

The skip index is the reference's: ``i % (skip_layer + 1) == 0`` when the
layers are built and ``i % skip_layer == 0`` in the forward, which agree for
the shipped depth 8 / skip 4. The ``nn.Linear``s are registered in the
``.tar``'s order (``layers.{i}.0``, ``density.0``, ``feature.0``,
``layer_9.0``, ``color.0``), so a checkpoint's ``network_fn_state_dict``
loads as is and torch Adam's state maps onto the same tensors.

The kernel route (``fused``, as ``make_tnerf_field(cfg, fused=None)``:
models/tnerf.py:124-181 there): the field runs kernel B7' on the embedded
inputs (``trunk_autograd`` under autograd, the forward-only launch under
``no_grad``), the embeddings detached unless ``SWNERF_FUSED_INPUT_GRADS=1``.
``fused=None`` takes it where ``utils/switches.py::kernel_route`` holds and
B7' covers the configuration (``supports_tnerf_trunk``), decided at
construction; on CPU tensors an explicit ``fused=True`` runs the twin.
Operands are ``switches.operand_dtype``'s; ``compute_dtype`` is the parity
mode.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from swnerf_torch.device import resolve_device
from swnerf_torch.models.common import Field, dense, density_bias_floor, init_mlp_stack, safe_init_enabled
from swnerf_torch.ops.embedding import embedding_dim, positional_encoding
from swnerf_torch.ops.kernels import trunk as b7
from swnerf_torch.utils.switches import input_grads, kernel_route, operand_dtype


@dataclasses.dataclass(frozen=True)
class TNeRFConfig:
    netdepth: int = 8
    net_dim: int = 128
    skip_layer: int = 4
    multires: int = 10
    multires_views: int = 4
    i_embed: int = 0

    @property
    def nf_pts(self) -> int:
        return self.multires if self.i_embed == 0 else -1

    @property
    def nf_views(self) -> int:
        return self.multires_views if self.i_embed == 0 else -1

    @property
    def nf_time(self) -> int:
        return self.multires if self.i_embed == 0 else -1

    @property
    def in_feat(self) -> int:
        return embedding_dim(self.nf_pts, 3)

    @property
    def dir_feat(self) -> int:
        return embedding_dim(self.nf_views, 3)

    @property
    def time_feat(self) -> int:
        return embedding_dim(self.nf_time, 1)


def _wrapped(lin: nn.Linear) -> nn.Sequential:
    # The reference wraps each Linear in a Sequential: its keys are "<name>.0.*".
    return nn.Sequential(lin)


class TNeRF(Field):
    """The T-NeRF field as an ``nn.Module`` on ``device`` (default
    ``cuda``), initialised from ``generator`` as ``init_tnerf_params``
    draws it (torch ``nn.Linear``'s distribution, layer by layer).
    ``fused``: the kernel route (None: decided from the device and the
    switches); ``compute_dtype``: its parity mode (module docstring)."""

    def __init__(
        self,
        cfg: TNeRFConfig,
        device: Optional[torch.device] = None,
        generator: Optional[torch.Generator] = None,
        fused: Optional[bool] = None,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        use = kernel_route(device) if fused is None else fused
        self.fused = bool(use) and b7.supports_tnerf_trunk(cfg)
        self.compute_dtype = compute_dtype
        nd, in0 = cfg.net_dim, cfg.in_feat + cfg.time_feat
        units = [in0] + [nd] * (cfg.netdepth + 1)
        dims = []
        for i in range(cfg.netdepth):
            fan_in = units[i] + (in0 if i % (cfg.skip_layer + 1) == 0 and i > 0 else 0)
            dims.append((fan_in, units[i + 1]))
        self.layers = nn.ModuleList(_wrapped(lin) for lin in init_mlp_stack(dims, generator, device))
        (density,) = init_mlp_stack([(nd, 1)], generator, device)
        if safe_init_enabled():
            density_bias_floor(density)
        self.density = _wrapped(density)
        self.feature = _wrapped(init_mlp_stack([(nd, nd)], generator, device)[0])
        self.layer_9 = _wrapped(init_mlp_stack([(nd + cfg.dir_feat, nd // 2)], generator, device)[0])
        self.color = _wrapped(init_mlp_stack([(nd // 2, 3)], generator, device)[0])

    def mlp_layout(self) -> Tuple[List[List[str]], List[str]]:
        """The wrapped ``layers.{i}.0``; the heads ``density``, ``feature``,
        ``layer_9``, ``color``."""
        return [[f"layers.{i}.0" for i in range(len(self.layers))]], ["density.0", "feature.0", "layer_9.0", "color.0"]

    def trunk(self, pts_emb: torch.Tensor, views_emb: torch.Tensor, time_emb: torch.Tensor) -> torch.Tensor:
        """The MLP on embedded inputs (``apply_tnerf``): raw ``[..., 4]``
        (rgb after the colour head's ReLU, then sigma), through B7' on the
        kernel route."""
        if self.fused:
            return self.kernel_trunk(pts_emb, views_emb, time_emb)
        inp = torch.cat([pts_emb, time_emb], -1)
        x = inp
        for i, lyr in enumerate(self.layers):
            x = F.elu(dense(lyr[0], x))
            if i % self.cfg.skip_layer == 0 and i > 0:
                x = torch.cat([inp, x], -1)
        sigma = dense(self.density[0], x)
        x = torch.cat([dense(self.feature[0], x), views_emb], -1)
        x = F.elu(dense(self.layer_9[0], x))
        return torch.cat([torch.relu(dense(self.color[0], x)), sigma], -1)

    def kernel_trunk(self, pts_emb: torch.Tensor, views_emb: torch.Tensor, time_emb: torch.Tensor) -> torch.Tensor:
        """The field through B7' (``fused_tnerf``) on ``[pts_emb |
        time_emb]`` and views_emb: raw [..., 4]. Under autograd the weights
        are packed differentiably and B7''s backward runs; the embeddings
        keep their cotangents only under ``SWNERF_FUSED_INPUT_GRADS=1``."""
        if not input_grads():
            pts_emb, views_emb, time_emb = pts_emb.detach(), views_emb.detach(), time_emb.detach()
        lead = pts_emb.shape[:-1]
        emb = torch.cat([pts_emb, time_emb], -1).reshape(-1, self.cfg.in_feat + self.cfg.time_feat)
        vemb = views_emb.reshape(-1, views_emb.shape[-1]).contiguous()
        dtype = operand_dtype(emb.device, self.compute_dtype)
        return b7.apply_field(self, b7.pack_tnerf_trunk_params, dtype, emb, vemb).reshape(*lead, 4)

    def forward(self, pts: torch.Tensor, viewdirs: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
        """pts [N, S, 3], viewdirs [N, 3], times [N, 1] -> raw [N, S, 4]."""
        lead = pts.shape[:-1]
        ve = positional_encoding(viewdirs, self.cfg.nf_views)
        views_emb = ve[..., None, :].expand(*lead, ve.shape[-1])
        t = times[..., None, :].expand(*lead, 1)
        return self.trunk(
            positional_encoding(pts, self.cfg.nf_pts), views_emb, positional_encoding(t, self.cfg.nf_time)
        )
