"""Image and video output (port of ``swnerf_tpu/utils/media.py``): PNG
frames (reference run.py:210-213) and the spiral and time-sweep videos
(run.py:574,732-733 ``*_rgb.mp4`` / ``*_disp.mp4``).

:func:`write_video` encodes mp4v through cv2 where cv2 imports. Where it
does not (a Python with torch and numpy alone) it writes an animated GIF
with the port's own encoder: a fixed palette (256 greys for grey frames, a
6 x 7 x 6 colour cube otherwise), each pixel its nearest entry, and an LZW
code stream that clears the table before it could grow past 9-bit codes,
so every code is a literal and the stream packs with numpy alone.

In a run of several processes only rank 0 writes (``parallel/multihost.py``):
every rank renders, the primary owns the files.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from swnerf_torch.parallel.multihost import is_primary
from swnerf_torch.utils.metrics import to8b
from swnerf_torch.utils.png import write_png_bytes

# The colour cube: levels per channel (R, G, B); 6 * 7 * 6 = 252 entries.
CUBE = (6, 7, 6)
# Literals between two clear codes: after a clear the decoder's next code is
# 258 and each literal after the first adds one, so 254 literals end at 511,
# the last 9-bit code (GIF's code width grows when the next code reaches 512).
LITERALS_PER_CLEAR = 254


def write_png(path: str, img01: np.ndarray) -> None:
    """Write a [0, 1] float image as an 8-bit PNG (rank 0 only)."""
    if is_primary():
        write_png_bytes(path, to8b(img01))


def write_video(path: str, frames01: np.ndarray, fps: int = 30) -> str:
    """Write [T, H, W, 3] (or [T, H, W]) floats in [0, 1] as an mp4 (cv2's
    mp4v), or, where cv2 does not import, as ``<path stem>.gif``. Returns
    the path written. A cv2 that imports but cannot open the writer raises.
    Rank 0 only: the other ranks write nothing and get ``path`` back."""
    if not is_primary():
        return path
    frames = to8b(np.asarray(frames01))
    if frames.ndim == 3:
        frames = np.repeat(frames[..., None], 3, axis=-1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        import cv2
    except ImportError:
        gif_path = os.path.splitext(path)[0] + ".gif"
        write_gif(gif_path, frames, fps)
        return gif_path
    H, W = frames.shape[1:3]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (W, H))
    if not vw.isOpened():
        raise RuntimeError(f"cv2.VideoWriter could not open {path} (mp4v)")
    for f in frames:
        vw.write(np.ascontiguousarray(f[..., ::-1]))  # RGB -> BGR
    vw.release()
    return path


def palette_for(frames: np.ndarray):
    """The GIF's 256 x 3 palette and whether it is the grey one: greys
    0-255 when every pixel has R = G = B, else the colour cube (the rest of
    the 256 entries black)."""
    if np.array_equal(frames[..., 0], frames[..., 1]) and np.array_equal(frames[..., 0], frames[..., 2]):
        return np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1), True
    levels = [np.round(np.arange(n) * 255.0 / (n - 1)).astype(np.uint8) for n in CUBE]
    r, g, b = np.meshgrid(*levels, indexing="ij")
    pal = np.zeros((256, 3), np.uint8)
    pal[: r.size] = np.stack([r.ravel(), g.ravel(), b.ravel()], -1)
    return pal, False


def quantize(frames: np.ndarray, grey: bool) -> np.ndarray:
    """uint8 [T, H, W, 3] -> palette indices [T, H, W]: the grey value, or
    the nearest level of each channel in the colour cube."""
    if grey:
        return frames[..., 0]
    idx = [np.round(frames[..., c].astype(np.float32) * (n - 1) / 255.0).astype(np.int32) for c, n in enumerate(CUBE)]
    return ((idx[0] * CUBE[1] + idx[1]) * CUBE[2] + idx[2]).astype(np.uint8)


def lzw_literals(indices: np.ndarray) -> bytes:
    """One frame's image data: LZW minimum code size 8, then the 9-bit code
    stream (a clear code before every :data:`LITERALS_PER_CLEAR` literals,
    the end code last) packed LSB first, in sub-blocks of at most 255 bytes."""
    px = indices.reshape(-1).astype(np.uint16)
    n_groups = -(-px.size // LITERALS_PER_CLEAR)
    codes = np.full(px.size + n_groups + 1, 256, np.uint16)  # 256: clear
    at = np.arange(px.size)
    codes[at + at // LITERALS_PER_CLEAR + 1] = px
    codes[-1] = 257  # end of information
    bits = ((codes[:, None] >> np.arange(9, dtype=np.uint16)) & 1).astype(np.uint8).reshape(-1)
    data = np.packbits(bits, bitorder="little").tobytes()
    blocks = [bytes((len(data[k : k + 255]),)) + data[k : k + 255] for k in range(0, len(data), 255)]
    return bytes((8,)) + b"".join(blocks) + b"\x00"


def write_gif(path: str, frames: np.ndarray, fps: int = 30) -> None:
    """uint8 [T, H, W, 3] frames as a looping GIF89a at ``fps`` (the delay
    in hundredths of a second, rounded)."""
    T, H, W = frames.shape[:3]
    pal, grey = palette_for(frames)
    indices = quantize(frames, grey)
    delay = max(1, round(100 / fps))
    out = [b"GIF89a", struct.pack("<HHBBB", W, H, 0xF7, 0, 0), pal.tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]  # loop forever
    for t in range(T):
        out.append(struct.pack("<BBBBHBB", 0x21, 0xF9, 4, 0x04, delay, 0, 0))  # graphic control: keep the frame
        out.append(struct.pack("<BHHHHB", 0x2C, 0, 0, W, H, 0))
        out.append(lzw_literals(indices[t]))
    out.append(b"\x3b")
    with open(path, "wb") as f:
        f.write(b"".join(out))
