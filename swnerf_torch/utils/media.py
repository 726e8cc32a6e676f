"""Image output (port of ``swnerf_tpu/utils/media.py``: PNG frames; the
mp4 writer comes in a later slice)."""

from __future__ import annotations

import numpy as np

from swnerf_torch.utils.metrics import to8b
from swnerf_torch.utils.png import write_png_bytes


def write_png(path: str, img01: np.ndarray) -> None:
    """Write a [0, 1] float image as an 8-bit PNG."""
    write_png_bytes(path, to8b(img01))
