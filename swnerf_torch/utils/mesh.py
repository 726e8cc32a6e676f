"""Wavefront OBJ IO with per-vertex colors. A copy of
``swnerf_tpu/utils/mesh.py`` (numpy only): the port writes the same OBJ
text, byte for byte, for the same arrays. It stands in for the reference's
``trimesh.Trimesh(...).export('mesh.obj')`` (extract_mesh.py:124-131,
187-190) and ``trimesh.load`` (transform_mesh.py:26)."""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def save_obj(
    path: str,
    verts: np.ndarray,
    faces: np.ndarray,
    vertex_colors: Optional[np.ndarray] = None,
) -> None:
    """Write ``v x y z [r g b]`` + 1-indexed ``f`` lines (the same extended
    OBJ vertex-color convention trimesh emits)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    lines = []
    if vertex_colors is not None:
        cols = np.clip(np.asarray(vertex_colors, np.float64), 0.0, 1.0)
        for v, c in zip(np.asarray(verts, np.float64), cols):
            lines.append(f"v {v[0]:.8f} {v[1]:.8f} {v[2]:.8f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f}")
    else:
        for v in np.asarray(verts, np.float64):
            lines.append(f"v {v[0]:.8f} {v[1]:.8f} {v[2]:.8f}")
    for f in np.asarray(faces, np.int64) + 1:
        lines.append(f"f {f[0]} {f[1]} {f[2]}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Read verts/faces (+vertex colors if present). Faces may be polygons;
    they are fan-triangulated. v/vt/vn indices like ``f 1/1/1`` supported."""
    verts, colors, faces = [], [], []
    with open(path) as fh:
        for line in fh:
            parts = line.strip().split()
            if not parts:
                continue
            if parts[0] == "v":
                xyz = [float(x) for x in parts[1:4]]
                verts.append(xyz)
                if len(parts) >= 7:
                    colors.append([float(x) for x in parts[4:7]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.int32) if faces else np.zeros((0, 3), np.int32)
    c = np.asarray(colors, np.float32) if len(colors) == len(verts) and colors else None
    return v, f, c
