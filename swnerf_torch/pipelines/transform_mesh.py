"""Metric-scale recovery CLI (port of ``swnerf_tpu/pipelines/transform_mesh.py``,
numpy and scipy, copied): ArUco-marker triangulation -> scale + align ->
``transformed_mesh.obj``::

    python -m swnerf_torch.pipelines.transform_mesh --config <cfg.txt> --real_length L

Usage parity with the reference (``python nerf/transform_mesh.py --config
configs/<scene>.txt --real_length L``, README.md:43-53 /
nerf/transform_mesh.py):

* detect DICT_4X4_1000 markers on the ``images_ori/`` twins of the capture
  frames (transform_mesh.py:248-269), keep the most frequent id (:272-275);
* per frame, cast world-space rays through the 4 marker corners,
  normalized by (fl, c) and undistorted with (k1, k2, p1, p2)
  (:42-60,139-165);
* triangulate each corner by least-squares minimization of point-to-ray
  distances (scipy, :167-189);
* scale = real_length / mean marker edge length (:284-289); rotation aligns
  the marker normal to +z via the Rodrigues formula (:292-318);
* apply scale + 4x4 transform to ``mesh.obj`` -> ``transformed_mesh.obj``.

Host work only, independent of the NeRF itself. Only the detection needs
OpenCV: ``detect_marker_corners`` imports cv2 and raises where it is
missing; everything after it (``calculate_3d_corners`` on) runs without it.
Camera centres use ``-R^T t`` in the reference while ray directions use
``R @ d`` (transform_mesh.py:216,163); the default is the standard c2w
interpretation (origin = t, dir = R @ d), and ``SWNERF_POSE_CONVENTION=
reference`` keeps the reference's. The matplotlib corner viz (:65-135) is
replaced by printed edge lengths.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import List, Tuple

import numpy as np

from swnerf_torch.utils.config import config_parser
from swnerf_torch.utils.mesh import load_obj, save_obj


def undistort_points(points: np.ndarray, k1, k2, p1, p2) -> np.ndarray:
    """Brown radial (k1,k2) + tangential (p1,p2) forward distortion applied
    to normalized points (reference transform_mesh.py:42-60)."""
    x, y = points[:, 0], points[:, 1]
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 * r2
    dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.column_stack([x * radial + dx, y * radial + dy])


def corner_rays(corners: np.ndarray, intrinsics, transform: np.ndarray) -> np.ndarray:
    """World-space unit rays through marker corners. corners: [4, 2] pixels."""
    fl_x, fl_y, cx, cy, k1, k2, p1, p2 = intrinsics
    norm = np.stack([(corners[:, 0] - cx) / fl_x, (corners[:, 1] - cy) / fl_y], -1)
    und = undistort_points(norm, k1, k2, p1, p2)
    rays = np.column_stack([und, np.ones(len(und))])
    rays = rays / np.linalg.norm(rays, axis=1, keepdims=True)
    return (transform[:3, :3] @ rays.T).T


def camera_center(transform: np.ndarray, pose_convention: str = "c2w") -> np.ndarray:
    if pose_convention == "reference":
        return -transform[:3, :3].T @ transform[:3, 3]  # transform_mesh.py:216
    return transform[:3, 3]


def triangulate_point(rays: np.ndarray, origins: np.ndarray) -> np.ndarray:
    """argmin_p sum_i dist(p, ray_i)^2 via scipy least_squares
    (reference transform_mesh.py:167-189, residuals vectorized)."""
    from scipy.optimize import least_squares

    rays = np.asarray(rays, np.float64)
    origins = np.asarray(origins, np.float64)
    rays = rays / np.linalg.norm(rays, axis=1, keepdims=True)

    def residuals(p):
        v = p[None, :] - origins  # [N, 3]
        return np.linalg.norm(np.cross(v, rays), axis=1)

    return least_squares(residuals, origins.mean(0)).x


def detect_marker_corners(datadir: str, frames) -> List[dict]:
    """ArUco DICT_4X4_1000 detection on images_ori/ twins
    (transform_mesh.py:248-269). The one step that needs OpenCV: it raises
    where cv2 (with its aruco module) is missing, and never skips."""
    try:
        import cv2
        import cv2.aruco as aruco
    except ImportError as e:
        raise RuntimeError(
            "transform_mesh: detecting the ArUco markers needs OpenCV (cv2 with cv2.aruco), which this Python "
            "does not have; install it, or give calculate_3d_corners the marker corners found elsewhere"
        ) from e

    dictionary = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_4X4_1000)
    detector = aruco.ArucoDetector(
        dictionary=dictionary, detectorParams=cv2.aruco.DetectorParameters()
    )
    info = []
    for frame in frames:
        path = os.path.join(datadir, frame["file_path"].replace("images/", "images_ori/"))
        image = cv2.imread(path)
        if image is None:
            print(f"Failed to load image at {path}")
            continue
        gray = cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)
        corners, ids, _ = detector.detectMarkers(gray)
        if ids is None:
            continue
        for corner, mid in zip(corners, ids.flatten()):
            info.append({"frame": frame, "id": int(mid), "corners": corner[0]})
    return info


def calculate_3d_corners(frame_info, intrinsics, pose_convention: str = "c2w") -> np.ndarray:
    rays_list, origins = [], []
    for info in frame_info:
        transform = np.array(info["frame"]["transform_matrix"], np.float64)
        rays_list.append(corner_rays(np.asarray(info["corners"], np.float64), intrinsics, transform))
        origins.append(camera_center(transform, pose_convention))
    origins = np.stack(origins)
    return np.stack(
        [
            triangulate_point(np.stack([r[i] for r in rays_list]), origins)
            for i in range(4)
        ]
    )


def marker_edge_lengths(corner_positions: np.ndarray) -> Tuple[float, List[float]]:
    edges = [(0, 1), (1, 2), (2, 3), (3, 0)]
    lengths = [float(np.linalg.norm(corner_positions[i] - corner_positions[j])) for i, j in edges]
    return float(np.mean(lengths)), lengths


def alignment_matrix(corner_positions: np.ndarray) -> np.ndarray:
    """4x4 rotation aligning the marker plane normal with +z (Rodrigues;
    reference transform_mesh.py:292-318)."""
    v1 = corner_positions[1] - corner_positions[0]
    v2 = corner_positions[2] - corner_positions[0]
    normal = np.cross(v1, v2)
    normal = normal / np.linalg.norm(normal)
    z = np.array([0.0, 0.0, 1.0])
    v = np.cross(normal, z)
    c = float(np.dot(normal, z))
    s = float(np.linalg.norm(v))
    out = np.eye(4)
    if s < 1e-12:
        if c < 0:  # anti-parallel: rotate pi about x
            out[1, 1] = out[2, 2] = -1.0
        return out
    k = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    out[:3, :3] = np.eye(3) + k + k @ k * ((1 - c) / (s**2))
    return out


def cal_scale(datadir: str, real_length: float, pose_convention: str = "c2w"):
    """Returns (scale, 4x4 transform). Reference transform_mesh.py:233-290."""
    with open(os.path.join(datadir, "transforms.json")) as f:
        meta = json.load(f)
    intr = tuple(meta[k] for k in ("fl_x", "fl_y", "cx", "cy", "k1", "k2", "p1", "p2"))

    info = detect_marker_corners(datadir, meta["frames"])
    if not info:
        raise RuntimeError("no ArUco markers detected in images_ori/")
    most_common = Counter(i["id"] for i in info).most_common(1)[0][0]
    filtered = [i for i in info if i["id"] == most_common]
    print(f"find ID: {most_common}, in total {len(filtered)} frames")

    corners3d = calculate_3d_corners(filtered, intr, pose_convention)
    mean_len, lengths = marker_edge_lengths(corners3d)
    for i, l in enumerate(lengths):
        print(f"edge {i + 1}: {l:.4f} units")
    print(f"mean edge length: {mean_len:.4f} units")

    scale = real_length / mean_len
    print(f"scale: {scale:.6f}")
    return scale, alignment_matrix(corners3d)


def transform_mesh(input_obj: str, output_obj: str, scale: float, transform: np.ndarray):
    """v' = T @ (s * v) (reference transform_mesh.py:12-41)."""
    verts, faces, colors = load_obj(input_obj)
    verts = verts * scale
    hom = np.hstack([verts, np.ones((len(verts), 1), verts.dtype)])
    verts = (hom @ transform.T)[:, :3]
    save_obj(output_obj, verts, faces, colors)
    print(f"Transformed mesh saved to {output_obj}")


def main(argv=None):
    args = config_parser().parse_args(argv)
    input_obj = os.path.join(args.basedir, args.expname, "mesh.obj")
    output_obj = os.path.join(args.basedir, args.expname, "transformed_mesh.obj")
    convention = os.environ.get("SWNERF_POSE_CONVENTION", "c2w")
    scale, transform = cal_scale(args.datadir, args.real_length, convention)
    transform_mesh(input_obj, output_obj, scale, transform)


if __name__ == "__main__":
    main()
