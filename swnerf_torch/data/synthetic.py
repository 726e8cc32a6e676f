"""Procedural ground-truth scenes (port of ``swnerf_tpu/data/synthetic.py``:
the analytic fields, their dense ground-truth render and the scene
writers of the Blender, LLFF, LINEMOD, DeepVoxels and custom formats), in
torch on a given device.

Each writer draws its camera poses from numpy's ``default_rng(seed)``
exactly as the JAX writer does, keeps its signature and on-disk schema,
renders each view with the port's compositor (row chunks of
:func:`_render_pose_chunked`, so a 512 x 512 view stays small) and writes
8-bit PNGs with the port's own encoder (``utils/png.py``). The fields'
arithmetic is the JAX package's; its values differ from it by float
rounding only, so a written pixel may land one 8-bit level away.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from swnerf_torch.device import resolve_device
from swnerf_torch.ops.volume import composite
from swnerf_torch.render.core import Rays, make_rays_from_camera
from swnerf_torch.utils.png import write_png_bytes


def gt_sphere_raw(pts: torch.Tensor, time: float = 0.0) -> torch.Tensor:
    """Raw (rgb logits, sigma) of a soft coloured sphere of radius 1 that
    moves along +x with ``time``."""
    center = torch.tensor([0.6 * time, 0.0, 0.0], dtype=pts.dtype, device=pts.device)
    r = torch.linalg.norm(pts - center, dim=-1, keepdim=True)
    sigma = 20.0 * torch.sigmoid(20.0 * (1.0 - r))
    rgb_logits = 2.0 * torch.sin(3.0 * (pts - center))
    return torch.cat([rgb_logits, sigma], -1)


def gt_textured_raw(pts: torch.Tensor, time: float = 0.0) -> torch.Tensor:
    """Textured three-object scene: a checkerboard sphere (moving along +x
    with ``time``), a striped rounded box, and a small occluder sphere
    (orbiting with ``time``), with sharp density edges."""
    x = pts[..., 0:1]

    def tensor(v):
        return torch.tensor(v, dtype=pts.dtype, device=pts.device)

    def softplus_density(d, sharp=40.0, peak=80.0):
        return peak * torch.sigmoid(-sharp * d)

    c1 = tensor([-0.65 + 0.4 * time, 0.0, 0.0])
    d1 = torch.linalg.norm(pts - c1, dim=-1, keepdim=True) - 0.8
    sig1 = softplus_density(d1)
    cells = torch.floor(3.0 * (pts - c1))
    checker = torch.remainder(cells[..., 0:1] + cells[..., 1:2] + cells[..., 2:3], 2.0)
    col1 = torch.cat([4.0 * checker - 2.0, -4.0 * checker + 2.0, torch.sin(6.0 * (x - c1[0]))], -1)

    c2 = tensor([0.75, 0.1, -0.1])
    q = torch.abs(pts - c2) - 0.55
    d2 = torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1, keepdim=True) + torch.clamp(
        torch.amax(q, dim=-1, keepdim=True), max=0.0
    )
    sig2 = softplus_density(d2)
    stripes = torch.sin(12.0 * (pts[..., 1:2] + pts[..., 2:3]))
    col2 = torch.cat([2.0 * stripes, 1.5 * torch.ones_like(stripes), -2.0 * stripes], -1)

    ang = 2.0 * np.pi * time
    c3 = tensor([0.5 * np.cos(ang), 0.5 * np.sin(ang), 0.9])
    d3 = torch.linalg.norm(pts - c3, dim=-1, keepdim=True) - 0.3
    sig3 = softplus_density(d3)
    col3 = tensor([-2.0, 2.0, 2.0]) * torch.ones_like(col1)

    sigma = sig1 + sig2 + sig3
    rgb_logits = (sig1 * col1 + sig2 * col2 + sig3 * col3) / (sigma + 1e-6)
    return torch.cat([rgb_logits, sigma], -1)


GT_FIELDS = {"sphere": gt_sphere_raw, "textured": gt_textured_raw}


def render_gt(
    rays: Rays, n_samples: int = 64, white_bkgd: bool = True, time: float = 0.0, scene: str = "sphere"
) -> torch.Tensor:
    """Ground-truth rgb [N, 3] of a ray batch by dense deterministic
    sampling, on the rays' device."""
    t = torch.linspace(0.0, 1.0, n_samples, dtype=rays.origins.dtype, device=rays.origins.device)
    z = rays.near[:, None] * (1 - t) + rays.far[:, None] * t
    pts = rays.origins[:, None, :] + rays.directions[:, None, :] * z[..., None]
    raw = GT_FIELDS[scene](pts, time)
    return composite(raw, z, rays.directions, white_bkgd=white_bkgd).rgb


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """Camera-to-world on a sphere looking at the origin (the JAX writer's
    convention)."""
    th, ph = np.deg2rad(theta_deg), np.deg2rad(phi_deg)
    trans = np.eye(4, dtype=np.float32)
    trans[2, 3] = radius
    rot_phi = np.eye(4, dtype=np.float32)
    rot_phi[1, 1] = rot_phi[2, 2] = np.cos(ph)
    rot_phi[1, 2], rot_phi[2, 1] = -np.sin(ph), np.sin(ph)
    rot_th = np.eye(4, dtype=np.float32)
    rot_th[0, 0] = rot_th[2, 2] = np.cos(th)
    rot_th[0, 2], rot_th[2, 0] = -np.sin(th), np.sin(th)
    c2w = rot_th @ rot_phi @ trans
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float32)
    return flip @ c2w


def write_blender_scene(
    root: str,
    n_train: int = 8,
    n_val: int = 2,
    n_test: int = 2,
    size: int = 32,
    dynamic: bool = False,
    n_samples: int = 128,
    seed: int = 0,
    scene: str = "sphere",
    white_bkgd: bool = True,
    device: Optional[torch.device] = None,
) -> None:
    """Write a renderable Blender-format dataset: the analytic scene imaged
    from spherical poses as transforms_{split}.json + RGBA PNGs (with
    ``dynamic``, frame i of n at time i / (n - 1) and a per-frame ``time``).
    Each view renders on ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    os.makedirs(root, exist_ok=True)
    H = W = size
    focal = 0.9 * W
    camera_angle_x = float(2.0 * np.arctan(0.5 * W / focal))
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i in range(n):
            theta = float(rng.uniform(-180.0, 180.0))
            phi = float(rng.uniform(-60.0, -10.0))
            c2w = pose_spherical(theta, phi, 4.0)
            t = i / max(n - 1, 1) if dynamic else 0.0
            rays = make_rays_from_camera(H, W, float(focal), c2w, near=2.0, far=6.0, device=device)
            rgb = render_gt(rays, n_samples, white_bkgd=white_bkgd, time=t, scene=scene).reshape(H, W, 3)
            rgba = torch.cat([rgb, torch.ones_like(rgb[..., :1])], -1)
            png = (torch.clamp(rgba, 0, 1) * 255).to(torch.uint8).cpu().numpy()
            rel = f"./{split}/r_{i}"
            write_png_bytes(os.path.join(root, rel + ".png"), png)
            frame = {"file_path": rel, "transform_matrix": c2w.tolist()}
            if dynamic:
                frame["time"] = t
            frames.append(frame)
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": camera_angle_x, "frames": frames}, f)


def _render_pose_chunked(H, W, focal, c2w, near, far, n_samples, scene, white_bkgd, device, chunk_rows=64) -> np.ndarray:
    """Ground-truth rgb [H, W, 3] of one view, rendered ``chunk_rows`` rows
    at a time (a one-shot render would hold [H * W, n_samples, 3] at once)."""
    rays = make_rays_from_camera(H, W, float(focal), c2w, near=near, far=far, device=device)
    step = chunk_rows * W
    out = [render_gt(rays.slice(s, s + step), n_samples, white_bkgd=white_bkgd, scene=scene)
           for s in range(0, H * W, step)]
    return torch.cat(out).reshape(H, W, 3).cpu().numpy()


def _png8(rgb: np.ndarray) -> np.ndarray:
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)


def write_llff_scene(
    root: str,
    n_images: int = 24,
    size: int = 64,
    n_samples: int = 192,
    seed: int = 0,
    scene: str = "textured",
    z_dist: float = 4.0,
    device: Optional[torch.device] = None,
) -> None:
    """Write a renderable LLFF forward-facing capture: ``images/`` (and the
    same files as the factor-1 cache ``images_1/``) and ``poses_bounds.npy``,
    per image a flattened 3x5 [down, right, back | t | hwf] matrix and its
    [near, far] bounds. The cameras sit on a jittered grid in a plane at
    distance ``z_dist``, looking at the origin, on a black background."""
    device = resolve_device(device)
    H = W = size
    focal = 0.9 * W
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "images_1"), exist_ok=True)

    side = int(np.ceil(np.sqrt(n_images)))
    rows = []
    for i in range(n_images):
        gx, gy = i % side, i // side
        x = (gx / max(side - 1, 1) - 0.5) * 1.4 + float(rng.uniform(-0.08, 0.08))
        y = (gy / max(side - 1, 1) - 0.5) * 1.4 + float(rng.uniform(-0.08, 0.08))
        z = z_dist + float(rng.uniform(-0.25, 0.25))
        eye = np.array([x, y, z], np.float32)
        back = eye / np.linalg.norm(eye)  # the camera looks at the origin
        right = np.cross([0.0, 1.0, 0.0], back)
        right /= np.linalg.norm(right)
        up = np.cross(back, right)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, back, eye

        # The analytic scenes lie within ~1.5 units of the origin.
        dist = float(np.linalg.norm(eye))
        near_b, far_b = dist - 1.7, dist + 1.7
        png = _png8(_render_pose_chunked(H, W, focal, c2w, near_b, far_b, n_samples, scene, False, device))
        name = f"image{i:03d}.png"
        write_png_bytes(os.path.join(root, "images", name), png)
        write_png_bytes(os.path.join(root, "images_1", name), png)

        # Stored columns [down (-up), right, back, t, hwf]: the loader's
        # column reorder inverts this.
        m = np.stack([-c2w[:3, 1], c2w[:3, 0], c2w[:3, 2], c2w[:3, 3], np.array([H, W, focal], np.float32)], axis=1)
        rows.append(np.concatenate([m.reshape(-1), [near_b, far_b]]))
    np.save(os.path.join(root, "poses_bounds.npy"), np.stack(rows).astype(np.float64))


def write_linemod_scene(
    root: str,
    n_train: int = 4,
    n_val: int = 1,
    n_test: int = 2,
    size: int = 16,
    n_samples: int = 64,
    seed: int = 0,
    scene: str = "sphere",
    device: Optional[torch.device] = None,
) -> np.ndarray:
    """Write a renderable LINEMOD-format dataset: per split a
    transforms_{split}.json with absolute ``file_path`` entries, each
    frame's ``intrinsic_matrix`` and the split's ``near`` / ``far`` (not
    integers: train 2.3 / 5.3, test 2.7 / 5.7, so the loader's floor / ceil
    gives 2 / 6), and 3-channel PNGs. Returns the 3x3 K written."""
    device = resolve_device(device)
    H = W = size
    focal = 0.9 * W
    K = np.array([[focal, 0.0, 0.5 * W], [0.0, focal, 0.5 * H], [0.0, 0.0, 1.0]])
    rng = np.random.default_rng(seed)
    bounds = {"train": (2.3, 5.3), "val": (2.5, 5.5), "test": (2.7, 5.7)}
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i in range(n):
            theta = float(rng.uniform(-180.0, 180.0))
            phi = float(rng.uniform(-60.0, -10.0))
            c2w = pose_spherical(theta, phi, 4.0)
            rgb = _render_pose_chunked(H, W, focal, c2w, 2.0, 6.0, n_samples, scene, True, device)
            path = os.path.abspath(os.path.join(root, split, f"r_{i}.png"))
            write_png_bytes(path, _png8(rgb))
            frames.append({"file_path": path, "transform_matrix": c2w.tolist(), "intrinsic_matrix": K.tolist()})
        near, far = bounds[split]
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"frames": frames, "near": near, "far": far}, f)
    return K


def write_deepvoxels_scene(
    root: str,
    scene_name: str = "cube",
    n_train: int = 3,
    n_val: int = 1,
    n_test: int = 1,
    n_samples: int = 32,
    seed: int = 0,
    scene: str = "sphere",
    device: Optional[torch.device] = None,
) -> None:
    """Write a renderable DeepVoxels-format dataset:
    ``{train,validation,test}/<scene_name>/{intrinsics.txt, pose/*.txt,
    rgb/*.png}`` at the loader's fixed 512 x 512. Each pose file holds
    ``c2w @ flip`` row-major, so the loader's y / z flip gives ``c2w``
    back."""
    device = resolve_device(device)
    H = W = 512
    focal = 0.9 * W
    rng = np.random.default_rng(seed)
    flip = np.array([[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1.0]])
    for split, n in (("train", n_train), ("validation", n_val), ("test", n_test)):
        base = os.path.join(root, split, scene_name)
        os.makedirs(os.path.join(base, "pose"), exist_ok=True)
        os.makedirs(os.path.join(base, "rgb"), exist_ok=True)
        # intrinsics.txt: focal cx cy / barycenter / near / scale / H W / world2cam
        with open(os.path.join(base, "intrinsics.txt"), "w") as f:
            f.write(f"{focal} {0.5 * W} {0.5 * H} 0.\n")
            f.write("0. 0. 0.\n1.\n1.\n")
            f.write(f"{H} {W}\n")
            f.write("0\n")
        for i in range(n):
            theta = float(rng.uniform(-180.0, 180.0))
            phi = float(rng.uniform(-60.0, -10.0))
            c2w = pose_spherical(theta, phi, 4.0)
            rgb = _render_pose_chunked(H, W, focal, c2w, 2.0, 6.0, n_samples, scene, True, device)
            write_png_bytes(os.path.join(base, "rgb", f"{i:04d}.png"), _png8(rgb))
            stored = c2w @ flip
            with open(os.path.join(base, "pose", f"{i:04d}.txt"), "w") as f:
                f.write(" ".join(str(float(x)) for x in stored.reshape(-1)))


def write_custom_scene(
    root: str,
    n_images: int = 10,
    size: int = 16,
    n_samples: int = 64,
    seed: int = 0,
    scene: str = "sphere",
    device: Optional[torch.device] = None,
) -> None:
    """Write a renderable custom ("SW capture")-format dataset: one
    transforms.json with ``fl_x`` / ``fl_y`` / ``cx`` / ``cy`` and relative
    ``file_path`` entries with their extension, and RGB (3-channel) PNGs, so
    that the loader pads the alpha; the loader makes the split."""
    device = resolve_device(device)
    H = W = size
    focal = 0.9 * W
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    frames = []
    for i in range(n_images):
        theta = float(rng.uniform(-180.0, 180.0))
        phi = float(rng.uniform(-60.0, -10.0))
        c2w = pose_spherical(theta, phi, 4.0)
        rgb = _render_pose_chunked(H, W, focal, c2w, 2.0, 6.0, n_samples, scene, True, device)
        rel = f"images/frame_{i:03d}.png"
        write_png_bytes(os.path.join(root, rel), _png8(rgb))
        frames.append({"file_path": rel, "transform_matrix": c2w.tolist()})
    meta = {"fl_x": focal, "fl_y": focal, "cx": 0.5 * W, "cy": 0.5 * H, "frames": frames}
    with open(os.path.join(root, "transforms.json"), "w") as f:
        json.dump(meta, f)
