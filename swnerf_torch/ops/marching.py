"""Iso-surface extraction: vectorized marching tetrahedra (numpy). A copy
of ``swnerf_tpu/ops/marching.py`` (numpy only; the port imports nothing of
the JAX package), kept line for line so both packages cut the same mesh
from the same grid.

Plays the role of ``skimage.measure.marching_cubes`` in the reference mesh
pipeline (nerf/extract_mesh.py:97-105). Marching *tetrahedra* (each grid
cell split into 6 tets around the 0-6 diagonal) needs no 256-entry case
tables, is unambiguous (no hole cases), and vectorizes cleanly; it yields
~2x the triangles of marching cubes for the same grid, with vertices
linearly interpolated on sign-crossing edges at the same iso level. One
``np.unique`` pass dedups shared edge vertices.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

# Cube corner offsets, index 0..7.
_CORNERS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    dtype=np.int64,
)

# Six-tetrahedron decomposition of the cube around the 0-6 diagonal.
_TETS = [(0, 5, 1, 6), (0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6)]


def _case_table():
    """triangles-as-edge-triples for each 4-bit inside mask."""
    table: List[List[Tuple[Tuple[int, int], ...]]] = []
    for mask in range(16):
        inside = [i for i in range(4) if mask >> i & 1]
        outside = [i for i in range(4) if not mask >> i & 1]
        tris: List[Tuple[Tuple[int, int], ...]] = []
        if len(inside) == 1:
            s = inside[0]
            e = [(s, o) for o in outside]
            tris = [(e[0], e[1], e[2])]
        elif len(inside) == 3:
            o = outside[0]
            e = [(s, o) for s in inside]
            tris = [(e[0], e[1], e[2])]
        elif len(inside) == 2:
            s0, s1 = inside
            o0, o1 = outside
            e00, e01, e10, e11 = (s0, o0), (s0, o1), (s1, o0), (s1, o1)
            tris = [(e00, e01, e11), (e00, e11, e10)]
        table.append(tris)
    return table


_CASES = _case_table()


def marching_tetrahedra(
    field: np.ndarray,
    level: float,
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0),
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the ``field == level`` surface.

    Args:
      field: [Nx, Ny, Nz] scalar field.
      level: iso value.
      spacing: grid step per axis (reference passes the linspace steps,
        extract_mesh.py:100-104).
      origin: world coordinate of grid index (0,0,0).

    Returns:
      (verts [V, 3] float32 world coords, faces [F, 3] int32), vertices
      deduplicated across shared edges.
    """
    field = np.asarray(field, dtype=np.float64)
    nx, ny, nz = field.shape
    if min(nx, ny, nz) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    bx, by, bz = np.meshgrid(
        np.arange(nx - 1), np.arange(ny - 1), np.arange(nz - 1), indexing="ij"
    )
    base = np.stack([bx.ravel(), by.ravel(), bz.ravel()], -1)  # [M, 3]
    corner_idx = base[:, None, :] + _CORNERS[None, :, :]  # [M, 8, 3]
    corner_flat = (corner_idx[..., 0] * ny + corner_idx[..., 1]) * nz + corner_idx[..., 2]
    vals = field[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]  # [M, 8]

    # Gather all triangle corner edges as (grid-point-a, grid-point-b) pairs.
    edge_a: List[np.ndarray] = []
    edge_b: List[np.ndarray] = []
    for tet in _TETS:
        tvals = vals[:, list(tet)]  # [M, 4]
        tflat = corner_flat[:, list(tet)]  # [M, 4]
        case = ((tvals > level).astype(np.int8) * (2 ** np.arange(4, dtype=np.int8))).sum(-1)
        for c in range(1, 15):
            tris = _CASES[c]
            if not tris:
                continue
            sel = np.nonzero(case == c)[0]
            if len(sel) == 0:
                continue
            for tri in tris:
                for (a, b) in tri:
                    edge_a.append(tflat[sel, a])
                    edge_b.append(tflat[sel, b])

    if not edge_a:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    # [E] grid-point ids per triangle-corner, E = 3 * n_faces. Triangles were
    # appended corner-major per (case, tri) block; rebuild face order by
    # stacking corners of each block side by side.
    # Simpler: re-collect per-corner arrays in aligned chunks of 3.
    A = []
    B = []
    for i in range(0, len(edge_a), 3):
        A.append(np.stack([edge_a[i], edge_a[i + 1], edge_a[i + 2]], -1))  # [K, 3]
        B.append(np.stack([edge_b[i], edge_b[i + 1], edge_b[i + 2]], -1))
    pa = np.concatenate(A, 0).ravel()  # [3F]
    pb = np.concatenate(B, 0).ravel()

    lo = np.minimum(pa, pb)
    hi = np.maximum(pa, pb)
    keys = lo.astype(np.int64) * (nx * ny * nz) + hi
    uniq_keys, first_idx, inverse = np.unique(keys, return_index=True, return_inverse=True)

    # Interpolate one vertex per unique edge.
    flat = field.ravel()
    ua, ub = pa[first_idx], pb[first_idx]
    va, vb = flat[ua], flat[ub]
    t = np.clip((level - va) / (vb - va), 0.0, 1.0)[:, None]

    def unflatten(f):
        x = f // (ny * nz)
        y = (f // nz) % ny
        z = f % nz
        return np.stack([x, y, z], -1).astype(np.float64)

    spacing = np.asarray(spacing, np.float64)
    origin = np.asarray(origin, np.float64)
    pa3 = unflatten(ua)
    pb3 = unflatten(ub)
    verts = (origin + spacing * (pa3 + t * (pb3 - pa3))).astype(np.float32)
    faces = inverse.reshape(-1, 3).astype(np.int32)
    # Drop degenerate faces (two corners on the same edge).
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts, faces[good]
