"""LPIPS (Learned Perceptual Image Patch Similarity) in torch (port of
``swnerf_tpu/utils/lpips_jax.py``).

The reference scores with the ``lpips`` package's pretrained AlexNet / VGG
(nerf/run.py:49-61 LPIPS(alex); d_nerf metrics.ipynb LPIPS-vgg). Nothing is
downloaded here: the weights come from files the user supplies,

  * the backbone: a torchvision ``alexnet`` / ``vgg16`` state dict
    (``features.N.weight`` / ``bias``);
  * the linear heads: the lpips package's ``alex.pth`` / ``vgg.pth``
    (``linN.model.1.weight``, shape [1, C, 1, 1]);

and ``SWNERF_LPIPS_DIR`` names a directory that holds ``{alexnet.pth,
alex.pth}`` and/or ``{vgg16.pth, vgg.pth}`` (:func:`from_env`). Neither
torchvision nor the lpips package is needed.

The computation: the scaling layer, the backbone's ReLU taps, each tap
unit-normalised over channels (eps 1e-10), the squared difference weighted
by the 1x1 head, the spatial mean and the sum over taps. Images go in as
they are, in [0, 1], without ``normalize=True``: the reference's quirk,
which the JAX package keeps. The convolutions and pools are torch's (the JAX
package computes LPIPS outside any Pallas kernel).
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# The scaling layer's constants (richzhang/PerceptualSimilarity lpips.py ScalingLayer).
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)

# (in, out, kernel, stride, padding) of each conv, its index in torchvision's
# ``features`` Sequential, the convs after whose ReLU a feature is tapped,
# and the max pools (kernel, stride) after a conv.
ALEX_CONVS = [(3, 64, 11, 4, 2), (64, 192, 5, 1, 2), (192, 384, 3, 1, 1), (384, 256, 3, 1, 1), (256, 256, 3, 1, 1)]
ALEX_FEATURE_IDX = [0, 3, 6, 8, 10]
ALEX_TAPS = [0, 1, 2, 3, 4]
ALEX_POOLS = {0: (3, 2), 1: (3, 2)}
VGG_CONVS = [
    (3, 64, 3, 1, 1), (64, 64, 3, 1, 1),
    (64, 128, 3, 1, 1), (128, 128, 3, 1, 1),
    (128, 256, 3, 1, 1), (256, 256, 3, 1, 1), (256, 256, 3, 1, 1),
    (256, 512, 3, 1, 1), (512, 512, 3, 1, 1), (512, 512, 3, 1, 1),
    (512, 512, 3, 1, 1), (512, 512, 3, 1, 1), (512, 512, 3, 1, 1),
]
VGG_FEATURE_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
VGG_TAPS = [1, 3, 6, 9, 12]
VGG_POOLS = {1: (2, 2), 3: (2, 2), 6: (2, 2), 9: (2, 2)}

NETS = {
    "alex": (ALEX_CONVS, ALEX_FEATURE_IDX, ALEX_TAPS, ALEX_POOLS),
    "vgg": (VGG_CONVS, VGG_FEATURE_IDX, VGG_TAPS, VGG_POOLS),
}
NET_FILES = {"alex": ("alexnet.pth", "alex.pth"), "vgg": ("vgg16.pth", "vgg.pth")}


class LPIPS(nn.Module):
    """LPIPS(``net``) with weights from a torchvision backbone state dict
    and an lpips head file (explicit paths, or ``weights_dir`` laid out as
    :data:`NET_FILES`), on ``device``. ``forward(img0, img1)``: NCHW float
    images -> [N] distances; :meth:`score` takes HWC (or NHWC) numpy."""

    def __init__(self, net: str = "alex", backbone_path: Optional[str] = None, lin_path: Optional[str] = None,
                 weights_dir: Optional[str] = None, device=None):
        super().__init__()
        if net not in NETS:
            raise ValueError(f"LPIPS net {net!r}: expected one of {sorted(NETS)}")
        if weights_dir is not None:
            bb, ln = NET_FILES[net]
            backbone_path = backbone_path or os.path.join(weights_dir, bb)
            lin_path = lin_path or os.path.join(weights_dir, ln)
        self.net = net
        convs, feature_idx, self.taps, self.pools = NETS[net]
        sd = torch.load(backbone_path, map_location="cpu", weights_only=True)
        self.convs = nn.ModuleList()
        for (cin, cout, k, stride, pad), fi in zip(convs, feature_idx):
            conv = nn.Conv2d(cin, cout, k, stride, pad)
            conv.weight.data.copy_(sd[f"features.{fi}.weight"])
            conv.bias.data.copy_(sd[f"features.{fi}.bias"])
            self.convs.append(conv)
        heads = torch.load(lin_path, map_location="cpu", weights_only=True)
        lins = []
        while f"lin{len(lins)}.model.1.weight" in heads:
            lins.append(heads[f"lin{len(lins)}.model.1.weight"].reshape(-1).float())
        if len(lins) != len(self.taps):
            raise ValueError(f"{lin_path}: {len(lins)} linear heads (linN.model.1.weight) for the "
                             f"{len(self.taps)} taps of {net}")
        for i, w in enumerate(lins):
            self.register_buffer(f"lin{i}", w.reshape(1, -1, 1, 1))
        self.register_buffer("shift", torch.tensor(SHIFT).reshape(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(SCALE).reshape(1, 3, 1, 1))
        self.requires_grad_(False)
        self.to(device or "cpu")

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for i, conv in enumerate(self.convs):
            x = torch.relu(conv(x))
            if i in self.taps:
                feats.append(x)
            if i in self.pools:
                x = F.max_pool2d(x, *self.pools[i])
        return feats

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        f0 = self.features((img0 - self.shift) / self.scale)
        f1 = self.features((img1 - self.shift) / self.scale)
        total = 0.0
        for layer, (a, b) in enumerate(zip(f0, f1)):
            diff = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            val = torch.sum(diff * getattr(self, f"lin{layer}"), dim=1, keepdim=True)
            total = total + torch.mean(val, dim=(2, 3))[:, 0]
        return total

    @torch.no_grad()
    def score(self, gt: np.ndarray, pred: np.ndarray) -> float:
        """HWC (or NHWC) images in [0, 1] -> the (mean) LPIPS distance."""
        dev = self.shift.device
        g, p = (torch.as_tensor(np.asarray(x, np.float32), device=dev) for x in (gt, pred))
        if g.ndim == 3:
            g, p = g[None], p[None]
        return float(self(g.permute(0, 3, 1, 2), p.permute(0, 3, 1, 2)).mean())


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt(torch.sum(x**2, dim=1, keepdim=True)) + eps)


@functools.lru_cache(maxsize=4)
def _cached(net: str, weights_dir: str, device: str) -> LPIPS:
    return LPIPS(net, weights_dir=weights_dir, device=device)


def from_env(net: str = "alex", device="cpu") -> Optional[LPIPS]:
    """:class:`LPIPS` on ``device`` from ``SWNERF_LPIPS_DIR`` when it holds
    ``net``'s two files, else None; one model is kept per (net, directory,
    device)."""
    d = os.environ.get("SWNERF_LPIPS_DIR")
    if not d or net not in NET_FILES:
        return None
    if not all(os.path.exists(os.path.join(d, f)) for f in NET_FILES[net]):
        return None
    return _cached(net, d, str(torch.device(device)))
