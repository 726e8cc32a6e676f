"""Colour-space helpers (port of ``swnerf_tpu/utils/color.py``).

The reference's ``hsv_to_rgb`` (utils.py:239-256) is broken: it builds the
channel selector from ``cat([hi, hi, hi])`` and masks per scalar value,
scrambling channels. This is the correct vectorised conversion with the
same intended surface (h, s, v in [0, 1]), as the JAX package has it.
"""

from __future__ import annotations

import os

import numpy as np


def hsv_to_rgb(h: np.ndarray, s: np.ndarray, v: np.ndarray) -> np.ndarray:
    """h, s, v arrays in [0,1] -> rgb [..., 3] in [0,1]."""
    h = np.asarray(h, np.float64)
    s = np.asarray(s, np.float64)
    v = np.asarray(v, np.float64)
    hi = np.floor(h * 6.0) % 6
    f = h * 6.0 - np.floor(h * 6.0)
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    table = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    sectors = [hi == i for i in range(6)]
    return np.stack([np.select(sectors, [c[ch] for c in table]) for ch in range(3)], -1)


def show(img, path: str, label: str, idx) -> None:
    """Save an image under path/label/idx.png via matplotlib (reference
    utils.py:259-272); matplotlib is imported here only."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = os.path.join(path, label)
    os.makedirs(d, exist_ok=True)
    plt.figure(figsize=(9, 9), dpi=96)
    img = np.asarray(img)
    if img.ndim < 3:
        plt.imshow(img, cmap="viridis")
    else:
        plt.imshow(img)
    plt.axis("off")
    plt.grid(False)
    plt.savefig(os.path.join(d, f"{idx}.png"), bbox_inches="tight")
    plt.close()
