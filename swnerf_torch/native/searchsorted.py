"""Row-wise searchsorted with row broadcasting (port of
``swnerf_tpu/native/searchsorted.py``), numpy in and numpy out.

API parity with the reference's python shim
(d_nerf/torchsearchsorted/src/torchsearchsorted/searchsorted.py:20-53):
``searchsorted(a [ba, A] sorted, v [bv, V], side)`` with row broadcasting
when ``ba == 1`` or ``bv == 1``; returns int64 [max(ba, bv), V]. The rows are
expanded to ``max(ba, bv)`` and searched by ``torch.searchsorted`` on the
CPU: a host-side helper, not a device kernel.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def native_available() -> bool:
    """Always True: the port needs no compiler for this component."""
    return True


@contextlib.contextmanager
def _threads(n: int):
    """torch's intra-op threads bounded to ``n`` (> 0) inside the block."""
    if n <= 0:
        yield
        return
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def searchsorted(a: np.ndarray, v: np.ndarray, side: str = "left", n_threads: int = 0) -> np.ndarray:
    """Row-wise searchsorted with broadcasting (see module docstring).
    ``n_threads > 0`` bounds torch's intra-op threads for the call."""
    a = np.ascontiguousarray(a, dtype=np.float32)
    v = np.ascontiguousarray(v, dtype=np.float32)
    if a.ndim != 2 or v.ndim != 2:
        raise ValueError("a and v must be 2-D")
    ba, bv = a.shape[0], v.shape[0]
    if not (ba == bv or ba == 1 or bv == 1):
        raise ValueError(f"row mismatch: {ba} vs {bv} (one must be 1 or equal)")
    rows = max(ba, bv)
    ta = torch.from_numpy(a).expand(rows, a.shape[1]).contiguous()
    tv = torch.from_numpy(v).expand(rows, v.shape[1]).contiguous()
    with _threads(n_threads):
        out = torch.searchsorted(ta, tv, right=(side == "right"))
    return out.numpy()
