"""Evaluation metrics (port of ``swnerf_tpu/utils/metrics.py``): PSNR and
SSIM to skimage's algorithms (uniform 7x7 filter, sample covariance, border
crop), and LPIPS through the port's own implementation
(``utils/lpips.py``) on weights the user supplies in ``SWNERF_LPIPS_DIR``;
without them LPIPS is ``None`` and the callers write
:data:`LPIPS_UNAVAILABLE_NOTE`. The port does not try the ``lpips`` package
(it downloads its backbone, and the card's machine has none).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from swnerf_torch.utils import lpips as lpips_torch

LPIPS_UNAVAILABLE_NOTE = (
    "lpips unavailable: LPIPS needs pretrained AlexNet/VGG weights, which "
    "swnerf_torch does not ship or download; point SWNERF_LPIPS_DIR at a "
    "directory holding torchvision backbone + lpips linear-head state dicts "
    "({alexnet.pth, alex.pth} and/or {vgg16.pth, vgg.pth}, utils/lpips.py) "
    "to populate this column (reference nerf/run.py:49-61 uses LPIPS(alex))."
)


def to8b(x: np.ndarray) -> np.ndarray:
    """[0,1] float -> uint8 (reference utils.py:14)."""
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)


def psnr(gt: np.ndarray, pred: np.ndarray, data_range: Optional[float] = None) -> float:
    """skimage.metrics.peak_signal_noise_ratio semantics."""
    gt = np.asarray(gt, dtype=np.float64)
    pred = np.asarray(pred, dtype=np.float64)
    if data_range is None:
        data_range = gt.max() - gt.min()
    err = np.mean((gt - pred) ** 2)
    return float(10.0 * np.log10((data_range**2) / err))


def _uniform_filter(x: np.ndarray, size: int) -> np.ndarray:
    """Separable moving average, as scipy.ndimage.uniform_filter with the
    default 'reflect' boundary."""
    pad = size // 2
    out = x
    for axis in range(x.ndim):
        padded = np.pad(out, [(pad, pad) if a == axis else (0, 0) for a in range(x.ndim)], mode="reflect")
        c = np.cumsum(padded, axis=axis, dtype=np.float64)
        zero = np.zeros_like(np.take(c, [0], axis=axis))
        c = np.concatenate([zero, c], axis=axis)
        hi = np.take(c, np.arange(size, c.shape[axis]), axis=axis)
        lo = np.take(c, np.arange(0, c.shape[axis] - size), axis=axis)
        out = (hi - lo) / size
    return out


def ssim(
    gt: np.ndarray,
    pred: np.ndarray,
    data_range: Optional[float] = None,
    win_size: int = 7,
    channel_axis: Optional[int] = None,
    K1: float = 0.01,
    K2: float = 0.03,
) -> float:
    """skimage.metrics.structural_similarity with gaussian_weights=False."""
    gt = np.asarray(gt, dtype=np.float64)
    pred = np.asarray(pred, dtype=np.float64)
    if data_range is None:
        data_range = gt.max() - gt.min()
    if channel_axis is not None:
        return float(np.mean([
            ssim(np.take(gt, c, axis=channel_axis), np.take(pred, c, axis=channel_axis),
                 data_range=data_range, win_size=win_size, K1=K1, K2=K2)
            for c in range(gt.shape[channel_axis])
        ]))
    NP = win_size**gt.ndim
    cov_norm = NP / (NP - 1)
    ux = _uniform_filter(gt, win_size)
    uy = _uniform_filter(pred, win_size)
    uxx = _uniform_filter(gt * gt, win_size)
    uyy = _uniform_filter(pred * pred, win_size)
    uxy = _uniform_filter(gt * pred, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / ((ux**2 + uy**2 + C1) * (vx + vy + C2))
    pad = (win_size - 1) // 2
    crop = tuple(slice(pad, s - pad) for s in S.shape)
    return float(S[crop].mean())


def lpips_available(net: str = "alex") -> bool:
    """Does ``SWNERF_LPIPS_DIR`` hold ``net``'s weights (``utils/lpips.py``)?"""
    return lpips_torch.from_env(net) is not None


def lpips(gt: np.ndarray, pred: np.ndarray, net: str = "alex", device="cpu") -> Optional[float]:
    """LPIPS(``net``) of HWC images on ``device``, pred clipped to [0, 1],
    with the weights in ``SWNERF_LPIPS_DIR``; None without them (null in
    metrics.json)."""
    model = lpips_torch.from_env(net, device)
    if model is None:
        return None
    return model.score(np.asarray(gt), np.clip(np.asarray(pred), 0, 1))


def calculate_metrics(gt: np.ndarray, pred: np.ndarray, device="cpu"):
    """Per-frame (psnr, ssim, lpips) — reference calculate_metrics
    (nerf/run.py:49-61): pred clipped to [0,1], data_range from gt; LPIPS
    (alex) on ``device``, None without its weights."""
    pred = np.clip(pred, 0.0, 1.0)
    dr = float(gt.max() - gt.min())
    return (psnr(gt, pred, data_range=dr), ssim(gt, pred, data_range=dr, win_size=7, channel_axis=2),
            lpips(gt, pred, device=device))
