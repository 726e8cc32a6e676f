"""PNG reading and writing with the standard library's ``zlib`` and numpy
(no imageio or cv2).

The reader takes 8-bit, non-interlaced grayscale, gray+alpha, RGB and RGBA
images (the Blender scenes are RGBA) and undoes all five row filters. The
Sub, Average and Paeth filters chain each byte to its left neighbour, so
the reader reconstructs one anti-diagonal of pixels at a time: every pixel
on a diagonal depends only on the two diagonals before it, whatever mix of
filters the rows use, and the work per diagonal is vectorized over the
pixels on it and over every image of the same shape in the batch.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type -> channels


def _parse(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """-> (filter types [H] uint8, filtered bytes [H, W, C] uint8)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color, _, _, interlace = ihdr
    if depth != 8 or interlace != 0 or color not in _CHANNELS:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, color type {color}, interlace {interlace}); "
            "only 8-bit non-interlaced gray/RGB/RGBA images are read"
        )
    c = _CHANNELS[color]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(height, 1 + width * c)
    return rows[:, 0].copy(), rows[:, 1:].reshape(height, width, c)


def _unfilter(ftype: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """ftype [B, H], filt [B, H, W, C] -> reconstructed [B, H, W, C] uint8."""
    if ftype.max(initial=0) > 4:
        raise ValueError("PNG row filter type > 4")
    if not ftype.any():  # every row unfiltered (as write_png_bytes writes them)
        return filt.copy()
    B, H, W, C = filt.shape
    out = np.zeros((B, H + 1, W + 1, C), np.int32)  # row 0 / col 0: the zero border
    filt = filt.astype(np.int32)
    for d in range(H + W - 1):
        r = np.arange(max(0, d - W + 1), min(H - 1, d) + 1)
        x = d - r
        a = out[:, r + 1, x]  # left
        b = out[:, r, x + 1]  # up
        c = out[:, r, x]  # up-left
        f = ftype[:, r][..., None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(
            f == 1, a, np.where(f == 2, b, np.where(f == 3, (a + b) >> 1, np.where(f == 4, paeth, 0)))
        )
        out[:, r + 1, x + 1] = (filt[:, r, x] + pred) & 255
    return out[:, 1:, 1:].astype(np.uint8)


def read_pngs(paths: Sequence[str]) -> List[np.ndarray]:
    """Decode PNGs to uint8 arrays [H, W, C], decoding same-shape images together."""
    parsed = [_parse(p) for p in paths]
    groups: Dict[tuple, List[int]] = {}
    for i, (_, filt) in enumerate(parsed):
        groups.setdefault(filt.shape, []).append(i)
    out: List[np.ndarray] = [None] * len(paths)  # type: ignore[list-item]
    for idx in groups.values():
        imgs = _unfilter(np.stack([parsed[i][0] for i in idx]), np.stack([parsed[i][1] for i in idx]))
        for k, i in enumerate(idx):
            out[i] = imgs[k]
    return out


def read_png(path: str) -> np.ndarray:
    """Decode one PNG to a uint8 array [H, W, C]."""
    return read_pngs([path])[0]


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def write_png_bytes(path: str, img: np.ndarray) -> None:
    """Write a uint8 [H, W] or [H, W, C] (C in 1..4) array as a PNG
    (filter 0 on every row)."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    rows = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, W * C)], 1)
    body = (
        _SIGNATURE
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(body)
