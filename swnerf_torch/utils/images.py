"""Image folders for the loaders, in numpy (no imageio, cv2 or PIL): the
image lister of the LLFF loader (``swnerf_tpu/data/llff.py:30-38``), PNG
reading through ``utils/png.py``, and ``cv2.resize(..., INTER_AREA)`` for
downscaling.

:func:`area_resize` follows OpenCV's area resampling. Where both sizes
divide exactly, each output pixel is the mean of its box: on uint8 a 2x2
box rounds half up, ``(sum + 2) >> 2``, and larger boxes round the float32
``sum * (1 / area)`` half to even, as OpenCV's fast path does, so the bytes
equal OpenCV's. Otherwise each source row and column enters with the share
of it that the output cell covers (OpenCV's ``computeResizeAreaTab``),
summed in float64.

JPEG is not decoded: a folder that must be read and holds JPEG files raises
``NotImplementedError``, naming the file.
"""

from __future__ import annotations

import math
import os
from typing import List, Sequence, Tuple

import numpy as np

from swnerf_torch.utils.png import read_pngs

IMG_EXTS = ("JPG", "jpg", "png", "jpeg", "PNG")


def list_images(d: str) -> List[str]:
    """The image files of folder ``d``, sorted by name."""
    return [os.path.join(d, f) for f in sorted(os.listdir(d)) if any(f.endswith(ex) for ex in IMG_EXTS)]


def read_images(paths: Sequence[str]) -> List[np.ndarray]:
    """Decode PNGs to uint8 arrays [H, W, C]; a JPEG raises NotImplementedError."""
    for p in paths:
        if os.path.splitext(p)[1].lower() in (".jpg", ".jpeg"):
            raise NotImplementedError(
                f"{p}: JPEG decoding is not ported to swnerf_torch; convert the folder's images to PNG "
                "(an LLFF capture can ship its images_<factor>/ cache as PNG)"
            )
    return read_pngs(paths)


def _area_tab(ssize: int, dsize: int) -> np.ndarray:
    """[dsize, ssize] weights: each source index's share of an output cell
    (OpenCV's computeResizeAreaTab, its float32 alphas)."""
    scale = ssize / dsize
    tab = np.zeros((dsize, ssize), np.float64)
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            tab[dx, sx1 - 1] = np.float32((sx1 - fsx1) / cell)
        tab[dx, sx1:sx2] = np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            tab[dx, sx2] = np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return tab


def area_resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Downscale ``img`` [H, W] or [H, W, C] to ``size = (W', H')`` (cv2's
    order), as ``cv2.resize(img, size, interpolation=cv2.INTER_AREA)``, in
    ``img``'s dtype (uint8 or float)."""
    img = np.asarray(img)
    W2, H2 = int(size[0]), int(size[1])
    H, W = img.shape[:2]
    if not (0 < H2 <= H and 0 < W2 <= W):
        raise ValueError(f"area_resize downscales only: {W}x{H} -> {W2}x{H2}")
    flat = img.reshape(H, W, -1)
    C = flat.shape[-1]
    if H % H2 == 0 and W % W2 == 0:
        fy, fx = H // H2, W // W2
        if img.dtype == np.uint8:
            s = flat.reshape(H2, fy, W2, fx, C).astype(np.int64).sum((1, 3))
            if fy == fx == 2 and C in (1, 3, 4):
                out = (s + 2) >> 2
            else:
                out = np.rint(s.astype(np.float32) * np.float32(1.0 / (fy * fx)))
            out = np.clip(out, 0, 255).astype(np.uint8)
        else:
            out = flat.reshape(H2, fy, W2, fx, C).astype(np.float64).mean((1, 3)).astype(img.dtype)
    else:
        ty, tx = _area_tab(H, H2), _area_tab(W, W2)
        out = np.einsum("yh,hwc,xw->yxc", ty, flat.astype(np.float64), tx, optimize=True)
        if img.dtype == np.uint8:
            out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
        else:
            out = out.astype(img.dtype)
    return out.reshape((H2, W2) + img.shape[2:])
