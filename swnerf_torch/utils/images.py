"""Image folders for the loaders: the image lister of the LLFF loader
(``swnerf_tpu/data/llff.py:30-38``), PNG reading through ``utils/png.py``,
JPEG decoding through cv2, and ``cv2.resize(..., INTER_AREA)`` for
downscaling.

JPEG files decode through ``cv2.imdecode(..., IMREAD_UNCHANGED)``, which
leaves an EXIF orientation tag unapplied, as ``imageio.imread`` (the JAX
loaders' reader) does; the channels turn from BGR(A) to RGB(A) and a
grayscale image stays 2-D. Where cv2 does not import, a folder that must be
read and holds JPEG files raises ``NotImplementedError``, naming the file.

:func:`area_resize` resizes float images with cv2's INTER_AREA where cv2
imports, as the JAX loaders do. Without cv2 it follows OpenCV's area
resampling in numpy. Where both sizes divide exactly, each output pixel
sums its box in OpenCV's order: in float32 a 2x2 box of 4 channels (and of
1 channel but for the last ``W' mod 4`` columns, which OpenCV's 4-lane loop
leaves to its scalar tail) as ``((a + b) + (c + d)) * 0.25``, top pair then
bottom pair; every other box (and every float64 one) row by row, four
values at a time added to the running sum, ``sum + (((a + b) + c) + d)``,
times the float32 ``1 / area``. On uint8 (with or without cv2) a 2x2 box
rounds half up, ``(sum + 2) >> 2``, and larger boxes round the float32
``sum * (1 / area)`` half to even, as OpenCV's fast path does, so the bytes
equal OpenCV's. Otherwise each source row and column enters with the share
of it that the output cell covers (OpenCV's ``computeResizeAreaTab``),
summed in float64.
"""

from __future__ import annotations

import math
import os
from typing import List, Sequence, Tuple

import numpy as np

from swnerf_torch.utils.png import read_pngs

IMG_EXTS = ("JPG", "jpg", "png", "jpeg", "PNG")
JPEG_EXTS = (".jpg", ".jpeg")


def _cv2():
    """cv2, or None where it does not import."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def list_images(d: str) -> List[str]:
    """The image files of folder ``d``, sorted by name."""
    return [os.path.join(d, f) for f in sorted(os.listdir(d)) if any(f.endswith(ex) for ex in IMG_EXTS)]


def read_jpeg(path: str) -> np.ndarray:
    """Decode one JPEG to uint8 [H, W, 3] RGB (or [H, W] grayscale, [H, W, 4]
    RGBA), its EXIF orientation not applied, as ``imageio.imread`` gives it."""
    cv2 = _cv2()
    if cv2 is None:
        raise NotImplementedError(
            f"{path}: JPEG decoding needs cv2, which does not import here; convert the folder's images to PNG "
            "(an LLFF capture can ship its images_<factor>/ cache as PNG)"
        )
    img = cv2.imdecode(np.fromfile(path, np.uint8), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise ValueError(f"{path}: cv2 could not decode the file")
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGRA2RGBA if img.shape[-1] == 4 else cv2.COLOR_BGR2RGB)
    return img


def read_images(paths: Sequence[str]) -> List[np.ndarray]:
    """Decode PNGs to uint8 arrays [H, W, C] and JPEGs as :func:`read_jpeg`,
    in the order given."""
    is_jpeg = [os.path.splitext(p)[1].lower() in JPEG_EXTS for p in paths]
    pngs = iter(read_pngs([p for p, j in zip(paths, is_jpeg) if not j]))
    return [read_jpeg(p) if j else next(pngs) for p, j in zip(paths, is_jpeg)]


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


def _box_mean(flat: np.ndarray, fy: int, fx: int) -> np.ndarray:
    """[H, W, C] float -> [H / fy, W / fx, C], each box summed in OpenCV's
    float order (the module docstring) and scaled by ``1 / (fy * fx)``."""
    H, W, C = flat.shape
    H2, W2 = H // fy, W // fx
    box = flat.reshape(H2, fy, W2, fx, C).transpose(0, 2, 1, 3, 4).reshape(H2, W2, fy * fx, C)
    area = fy * fx
    total = np.zeros((H2, W2, C), flat.dtype)
    k = 0
    while k <= area - 4:
        total = total + (((box[:, :, k] + box[:, :, k + 1]) + box[:, :, k + 2]) + box[:, :, k + 3])
        k += 4
    for k in range(k, area):
        total = total + box[:, :, k]
    out = total * flat.dtype.type(np.float32(1.0 / area))
    if flat.dtype == np.float32 and fy == fx == 2 and C in (1, 4):
        pairs = ((box[:, :, 0] + box[:, :, 1]) + (box[:, :, 2] + box[:, :, 3])) * flat.dtype.type(0.25)
        lanes = W2 if C == 4 else W2 - W2 % 4
        out[:, :lanes] = pairs[:, :lanes]
    return out


def area_resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Downscale ``img`` [H, W] or [H, W, C] to ``size = (W', H')`` (cv2's
    order), as ``cv2.resize(img, size, interpolation=cv2.INTER_AREA)``, in
    ``img``'s dtype (uint8 or float): float images through cv2 itself where
    it imports (the module docstring)."""
    img = np.asarray(img)
    W2, H2 = int(size[0]), int(size[1])
    H, W = img.shape[:2]
    if not (0 < H2 <= H and 0 < W2 <= W):
        raise ValueError(f"area_resize downscales only: {W}x{H} -> {W2}x{H2}")
    cv2 = _cv2() if img.dtype != np.uint8 else None
    if cv2 is not None:
        return cv2.resize(img, (W2, H2), interpolation=cv2.INTER_AREA).reshape((H2, W2) + img.shape[2:])
    flat = img.reshape(H, W, -1)
    C = flat.shape[-1]
    if H % H2 == 0 and W % W2 == 0:
        fy, fx = H // H2, W // W2
        if img.dtype == np.uint8:
            # exact integer box sums, the rows of each box first (contiguous)
            s = flat.reshape(H2, fy, W * C).sum(1, dtype=np.int64).reshape(H2, W2, fx, C).sum(2)
            if fy == fx == 2 and C in (1, 3, 4):
                out = (s + 2) >> 2
            else:
                out = np.rint(s.astype(np.float32) * np.float32(1.0 / (fy * fx)))
            out = np.clip(out, 0, 255).astype(np.uint8)
        else:
            out = _box_mean(flat, fy, fx)
    else:
        ty, tx = _area_tab(H, H2), _area_tab(W, W2)
        out = np.einsum("yh,hwc,xw->yxc", ty, flat.astype(np.float64), tx, optimize=True)
        if img.dtype == np.uint8:
            out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
        else:
            out = out.astype(img.dtype)
    return out.reshape((H2, W2) + img.shape[2:])
