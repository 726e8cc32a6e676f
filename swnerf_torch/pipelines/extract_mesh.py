"""Mesh extraction CLI (port of ``swnerf_tpu/pipelines/extract_mesh.py``):
a dense density/colour grid queried on the card -> marching tetrahedra ->
coloured ``mesh.obj``::

    python -m swnerf_torch.pipelines.extract_mesh --config <cfg.txt> \\
        [--resolution R] [--threshold T] [--device cuda|cpu]

Usage parity with the reference (``python nerf/extract_mesh.py --config
configs/<scene>.txt --resolution R --threshold T``, README.md:32-41):
fibonacci-sphere view directions (extract_mesh.py:7-25), a dense grid over
the hardcoded bounds [(-1,1), (-1,2), (-4,2)] (extract_mesh.py:157;
``SWNERF_MESH_BOUNDS`` overrides them as JSON), per-point raw (rgb logits,
sigma) averaged over ``SWNERF_MESH_VIEWS`` (default 100) directions
(extract_mesh.py:59-80: the reference averages the network's
pre-activation outputs; kept), the iso-surface at ``--threshold``,
nearest-sample vertex colours (extract_mesh.py:115-121), written to
``<basedir>/<expname>/mesh.obj``.

The sweep runs without autograd in tiles of ``chunk`` points x V views:
each tile is one field call of ``chunk * V`` rows
(``VanillaNeRF.query_views``: the points and the directions are each
encoded once and broadcast), the mean over the views is taken on the card,
and the grid comes to the host once, at the end. The kernel route packs
the weights once per sweep (``trunk.packed_once``). On a card the field's
kernel route runs each tile as one B7 forward-only launch in bf16 (one B8
launch under ``SWNERF_FUSED_RAW=1``); ``SWNERF_FUSED=0`` gives the fp32
plain trunk. The field is the fine network when there is one (reference
extract_mesh.py:176).
"""

from __future__ import annotations

import json
import os
import time
from typing import Tuple

import numpy as np
import torch

from swnerf_torch.device import resolve_device
from swnerf_torch.ops.kernels.trunk import packed_once
from swnerf_torch.ops.marching import marching_tetrahedra
from swnerf_torch.utils.config import config_parser
from swnerf_torch.utils.mesh import save_obj

DEFAULT_BOUNDS = ((-1.0, 1.0), (-1.0, 2.0), (-4.0, 2.0))  # extract_mesh.py:157


def fibonacci_sphere(num_views: int = 100) -> np.ndarray:
    """Evenly distributed unit directions (extract_mesh.py:7-25)."""
    indices = np.arange(0, num_views, dtype=np.float64) + 0.5
    phi = np.arccos(1 - 2 * indices / num_views)
    theta = np.pi * (1 + 5**0.5) * indices
    return np.stack(
        [np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)], 1
    ).astype(np.float32)


@torch.no_grad()
def sample_grid(model, bounds=DEFAULT_BOUNDS, resolution: int = 128, num_views: int = 100, chunk: int = 2048):
    """Mean raw (rgb logits, sigma) over view directions on a dense grid,
    queried on the model's device.

    Returns (density [R,R,R], colors [R,R,R,3], axes (x,y,z) 1-D arrays).
    """
    xs = np.linspace(bounds[0][0], bounds[0][1], resolution)
    ys = np.linspace(bounds[1][0], bounds[1][1], resolution)
    zs = np.linspace(bounds[2][0], bounds[2][1], resolution)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    points = np.stack([X.ravel(), Y.ravel(), Z.ravel()], -1).astype(np.float32)
    n = points.shape[0]
    pad = (-n) % chunk
    dev = next(model.parameters()).device
    pts = torch.as_tensor(np.concatenate([points, np.zeros((pad, 3), np.float32)], 0), device=dev)
    viewdirs = torch.as_tensor(fibonacci_sphere(num_views), device=dev)  # [V, 3]
    out = torch.empty((n + pad, 4), dtype=torch.float32, device=dev)
    with packed_once(model):  # the kernel route packs the weights once, not once a tile
        for start in range(0, n + pad, chunk):
            out[start : start + chunk] = model.query_views(pts[start : start + chunk], viewdirs).mean(0)
    out = out[:n].cpu().numpy()
    density = out[:, 3].reshape(resolution, resolution, resolution)
    colors = out[:, :3].reshape(resolution, resolution, resolution, 3)
    return density, colors, (xs, ys, zs)


def grid_to_mesh(density, colors, axes, density_threshold: float
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Marching tetrahedra at ``density_threshold`` and nearest-sample
    vertex colours (the sigmoid of the mean logits). Returns (verts, faces,
    vertex_colors)."""
    xs, ys, zs = axes
    resolution = density.shape[0]
    spacing = (xs[1] - xs[0], ys[1] - ys[0], zs[1] - zs[0])
    origin = (xs[0], ys[0], zs[0])
    verts, faces = marching_tetrahedra(density, density_threshold, spacing, origin)

    if len(verts):
        idx = np.stack(
            [
                np.clip(np.round((verts[:, i] - origin[i]) / spacing[i]), 0, resolution - 1)
                for i in range(3)
            ],
            -1,
        ).astype(np.int64)
        # Reference colours are pre-sigmoid logits; map through sigmoid for a
        # displayable [0,1] colour (export clips anyway).
        vcol = 1.0 / (1.0 + np.exp(-colors[idx[:, 0], idx[:, 1], idx[:, 2]]))
    else:
        vcol = np.zeros((0, 3), np.float32)
    return verts, faces, vcol


def nerf_to_mesh(
    model,
    bounds=DEFAULT_BOUNDS,
    resolution: int = 128,
    density_threshold: float = 8.0,
    num_views: int = 100,
    chunk: int = 2048,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Grid sample + marching tetrahedra + nearest-sample vertex colours.
    Returns (verts, faces, vertex_colors)."""
    density, colors, axes = sample_grid(model, bounds, resolution, num_views, chunk)
    return grid_to_mesh(density, colors, axes, density_threshold)


def main(argv=None):
    """CLI entry. Returns {"path", "verts", "faces", "sweep_s", "march_s",
    "write_s"}: the OBJ written, its counts, and the host-clock seconds of
    the grid sweep (ending in the copy to the host), of marching + colours
    and of the OBJ write."""
    from swnerf_torch.pipelines.run_nerf import create_vanilla

    args = config_parser().parse_args(argv)
    device = resolve_device(args.device)
    state, _rcfg, _eval_pass, _cfgs = create_vanilla(args, device)
    model = state.fine if state.fine is not None else state.coarse

    bounds = DEFAULT_BOUNDS
    if os.environ.get("SWNERF_MESH_BOUNDS"):
        bounds = tuple(tuple(b) for b in json.loads(os.environ["SWNERF_MESH_BOUNDS"]))
    num_views = int(os.environ.get("SWNERF_MESH_VIEWS", 100))

    t0 = time.perf_counter()
    grid = sample_grid(model, bounds, args.resolution, num_views)
    t1 = time.perf_counter()
    verts, faces, vcol = grid_to_mesh(*grid, density_threshold=args.threshold)
    t2 = time.perf_counter()
    path = os.path.join(args.basedir, args.expname, "mesh.obj")
    save_obj(path, verts, faces, vcol)
    t3 = time.perf_counter()
    print(f"Mesh saved to {path} ({len(verts)} verts, {len(faces)} faces)")
    print(f"sweep {t1 - t0:.3f} s ({args.resolution}^3 points x {num_views} views), marching {t2 - t1:.3f} s, "
          f"OBJ write {t3 - t2:.3f} s")
    return {"path": path, "verts": len(verts), "faces": len(faces), "sweep_s": t1 - t0, "march_s": t2 - t1,
            "write_s": t3 - t2}


if __name__ == "__main__":
    main()
