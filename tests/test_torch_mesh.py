"""The SW mesh chain of the port (``ops/marching.py``, ``utils/mesh.py``,
``pipelines/load_model.py``, ``pipelines/extract_mesh.py``,
``pipelines/transform_mesh.py``) against the JAX package's, on the CPU.

The numpy copies are held bit for bit (marching tetrahedra's arrays, the
OBJ text); the field-driven pieces on the repo's trained ``010000.tar``
(D=8, W=256) in fp32: ``nerf_to_mesh`` at resolution 24 and 4 views (the
same vertex and face counts, vertices within 1e-4) and ``load_model``'s
``query_fn`` (atol 1e-5, rtol 1e-4); the metric-scale solve on marker views
built as ``tests/test_mesh_pipeline.py::TestMetricScale`` builds them (the
same scale and transform to 1e-9). The chain on the card is
``chip_smoke.py``'s phases 29-30."""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from swnerf_torch.ops import marching as port_marching
from swnerf_torch.pipelines import extract_mesh as port_extract
from swnerf_torch.pipelines import transform_mesh as port_transform
from swnerf_torch.pipelines.load_model import load_model
from swnerf_torch.utils import mesh as port_mesh
from swnerf_tpu.ops import marching as jax_marching
from swnerf_tpu.pipelines import extract_mesh as jax_extract
from swnerf_tpu.pipelines import load_model as jax_load_model
from swnerf_tpu.pipelines import transform_mesh as jax_transform
from swnerf_tpu.utils import mesh as jax_mesh
from test_mesh_pipeline import _looking_cameras, _project

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "benchmarks" / "full_scale" / "full_nerf_200k.txt"
CKPT = REPO / "benchmarks" / "full_scale" / "logs" / "full_nerf_200k" / "010000.tar"
BOUNDS = ((-2.0, 2.0), (-2.0, 2.0), (-2.0, 2.0))  # the drill recipe's (benchmarks/tpu_sw_chain.py:160)


def _blob(res=20, seed=0):
    """A smooth random scalar field with a closed level set near 0."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-1, 1, res)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    f = 0.6 - np.sqrt(X**2 + 1.3 * Y**2 + 0.8 * Z**2)
    for _ in range(4):
        c, a = rng.uniform(-0.6, 0.6, 3), rng.uniform(0.05, 0.2)
        f = f + a * np.exp(-((X - c[0]) ** 2 + (Y - c[1]) ** 2 + (Z - c[2]) ** 2) / 0.05)
    return f.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_marching_tetrahedra_bit_equal_to_jax_copy(seed):
    """The same vertices and faces, bit for bit, on a random blob with a
    non-unit spacing and origin."""
    f = _blob(seed=seed)
    args = (f, 0.05, (0.1, 0.2, 0.15), (-1.0, 0.5, 2.0))
    v, fa = port_marching.marching_tetrahedra(*args)
    jv, jf = jax_marching.marching_tetrahedra(*args)
    assert len(v) > 100 and np.array_equal(v, jv) and np.array_equal(fa, jf)
    assert v.dtype == jv.dtype and fa.dtype == jf.dtype


@pytest.mark.parametrize("colors", [True, False], ids=["colored", "plain"])
def test_obj_text_byte_equal_to_jax_writer(tmp_path, colors):
    """save_obj writes the JAX writer's bytes for the same arrays (colours
    clipped to [0, 1]); load_obj reads back what the JAX reader reads."""
    rng = np.random.default_rng(3)
    verts = rng.normal(size=(50, 3)).astype(np.float32)
    faces = rng.integers(0, 50, (80, 3)).astype(np.int32)
    vcol = rng.uniform(-0.2, 1.2, (50, 3)) if colors else None
    port_mesh.save_obj(str(tmp_path / "a" / "mesh.obj"), verts, faces, vcol)
    jax_mesh.save_obj(str(tmp_path / "b" / "mesh.obj"), verts, faces, vcol)
    a, b = (tmp_path / "a" / "mesh.obj").read_bytes(), (tmp_path / "b" / "mesh.obj").read_bytes()
    assert a == b and len(a) > 0
    for x, y in zip(port_mesh.load_obj(str(tmp_path / "a" / "mesh.obj")),
                    jax_mesh.load_obj(str(tmp_path / "b" / "mesh.obj"))):
        assert (x is None and y is None) or np.array_equal(x, y)


def _argv(tmp_path, *extra):
    return ["--config", str(CONFIG), "--ft_path", str(CKPT), "--basedir", str(tmp_path), *extra]


def test_fibonacci_sphere_matches_jax():
    np.testing.assert_array_equal(port_extract.fibonacci_sphere(100), jax_extract.fibonacci_sphere(100))


def test_nerf_to_mesh_matches_jax_on_the_checkpoint(tmp_path):
    """nerf_to_mesh on 010000.tar's fine network at resolution 24 and 4 views
    over the drill recipe's bounds, threshold 25, fp32 on the CPU, against
    the JAX nerf_to_mesh on make_vanilla_field(fused=False): the same vertex
    and face counts, the same faces, vertices within 1e-4 and colours within
    1e-4. Measured max |dv| 1.3e-6, colours 3.6e-7."""
    model, state, _, _ = load_model(_argv(tmp_path, "--device", "cpu"))
    assert model is state.fine and not model.fused  # the CPU's fields: the plain trunk
    verts, faces, vcol = port_extract.nerf_to_mesh(model, BOUNDS, resolution=24, density_threshold=25, num_views=4)
    field, params, *_ = jax_load_model.load_model(_argv(tmp_path))
    jv, jf, jc = jax_extract.nerf_to_mesh(field, params, BOUNDS, resolution=24, density_threshold=25, num_views=4)
    assert len(verts) > 100 and len(verts) == len(jv) and len(faces) == len(jf)
    np.testing.assert_array_equal(faces, jf)
    np.testing.assert_allclose(verts, jv, atol=1e-4, rtol=0)
    np.testing.assert_allclose(vcol, jc, atol=1e-4, rtol=0)


def test_load_model_query_fn_matches_jax(tmp_path):
    """query_fn(positions [N, 3], viewdirs [N, 3]) -> raw [N, 4] through the
    fine network, against the JAX load_model's on 256 seeded points: atol
    1e-5, rtol 1e-4. Measured max |d| 1.1e-5 at max |raw| 42.8."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(-1.5, 1.5, (256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3))
    vd = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    _, _, _, query = load_model(_argv(tmp_path), device="cpu")
    got = query(pos, vd)
    assert got.shape == (256, 4) and got.device.type == "cpu" and not got.requires_grad
    *_, jquery = jax_load_model.load_model(_argv(tmp_path))
    np.testing.assert_allclose(got.numpy(), np.asarray(jquery(pos, vd)), atol=1e-5, rtol=1e-4)


def _marker_capture(root):
    """The synthetic capture of TestMetricScale.test_full_scale_solve_from_
    rendered_views: a 0.2-unit DICT_4X4_1000 marker warped into 8 pinhole
    views' images_ori/ twins, and transforms.json."""
    import cv2

    d = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_4X4_1000)
    msize = 240
    marker = cv2.aruco.generateImageMarker(d, 7, msize)
    world = np.array([[0.0, 0.2, 0.0], [0.2, 0.2, 0.0], [0.2, 0.0, 0.0], [0.0, 0.0, 0.0]])
    src_px = np.array([[0, 0], [msize - 1, 0], [msize - 1, msize - 1], [0, msize - 1]], np.float32)
    fl_x, fl_y, cx, cy = 500.0, 500.0, 320.0, 240.0
    os.makedirs(root / "images_ori", exist_ok=True)
    frames = []
    for k, c2w in enumerate(_looking_cameras(8)):
        dst = np.stack([_project(p, c2w, (fl_x, fl_y, cx, cy)) for p in world]).astype(np.float32)
        Hm, _ = cv2.findHomography(src_px, dst)
        canvas = cv2.warpPerspective(marker, Hm, (640, 480), flags=cv2.INTER_LINEAR,
                                     borderMode=cv2.BORDER_CONSTANT, borderValue=255)
        cv2.imwrite(str(root / "images_ori" / f"f{k}.png"), canvas)
        frames.append({"file_path": f"images/f{k}.png", "transform_matrix": c2w.tolist()})
    meta = {"fl_x": fl_x, "fl_y": fl_y, "cx": cx, "cy": cy, "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0,
            "frames": frames}
    (root / "transforms.json").write_text(json.dumps(meta))


@pytest.mark.parametrize("convention", ["c2w", "reference"])
def test_cal_scale_matches_jax(tmp_path, convention):
    """cal_scale (detection with cv2, triangulation, edge lengths,
    alignment) on the marker capture: the same scale and transform as the
    JAX package to 1e-9, under both pose conventions; under c2w the scale is
    0.05 / 0.2 within 2% (the ArUco corner localisation)."""
    _marker_capture(tmp_path)
    scale, T = port_transform.cal_scale(str(tmp_path), 0.05, convention)
    jscale, jT = jax_transform.cal_scale(str(tmp_path), 0.05, convention)
    assert abs(scale - jscale) <= 1e-9 * abs(jscale)
    np.testing.assert_allclose(T, jT, atol=1e-9, rtol=0)
    if convention == "c2w":
        assert scale == pytest.approx(0.25, rel=0.02)


def test_metric_solve_without_cv2_recovers_the_scale():
    """calculate_3d_corners -> marker_edge_lengths -> alignment_matrix on
    corners projected exactly (no detection, so no cv2) into the cameras
    of TestMetricScale, the marker tilted off the z=0 plane: the scale is
    real_length / 0.2 within 1e-6 relative, the normal maps to +z within
    1e-6, as the JAX functions give."""
    rot = np.array([[1, 0, 0], [0, np.cos(0.3), -np.sin(0.3)], [0, np.sin(0.3), np.cos(0.3)]])
    marker = np.array([[0.0, 0.0, 0.0], [0.2, 0.0, 0.0], [0.2, 0.2, 0.0], [0.0, 0.2, 0.0]]) @ rot.T
    intr = (400.0, 400.0, 320.0, 240.0)
    info = [{"frame": {"transform_matrix": c2w.tolist()}, "id": 0,
             "corners": np.stack([_project(p, c2w, intr) for p in marker])} for c2w in _looking_cameras()]
    corners = port_transform.calculate_3d_corners(info, intr + (0.0, 0.0, 0.0, 0.0))
    mean_len, _ = port_transform.marker_edge_lengths(corners)
    assert 0.05 / mean_len == pytest.approx(0.25, rel=1e-6)
    T = port_transform.alignment_matrix(corners)
    n = np.cross(T[:3, :3] @ (corners[1] - corners[0]), T[:3, :3] @ (corners[2] - corners[0]))
    np.testing.assert_allclose(n / np.linalg.norm(n), [0, 0, 1], atol=1e-6)
    np.testing.assert_array_equal(corners, jax_transform.calculate_3d_corners(info, intr + (0.0, 0.0, 0.0, 0.0)))
    np.testing.assert_array_equal(T, jax_transform.alignment_matrix(corners))


def test_detection_without_cv2_raises(monkeypatch, tmp_path):
    """Without cv2 the detection raises a clear error; it never skips."""
    import builtins

    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2" or name.startswith("cv2."):
            raise ImportError("No module named 'cv2'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(RuntimeError, match="needs OpenCV"):
        port_transform.detect_marker_corners(str(tmp_path), [{"file_path": "images/f0.png"}])


def test_transform_mesh_matches_jax(tmp_path):
    """transform_mesh with a given scale and 4x4 matrix writes the JAX
    package's OBJ bytes (v' = T (s v)), colours kept."""
    rng = np.random.default_rng(5)
    verts = rng.normal(size=(30, 3)).astype(np.float32)
    faces = rng.integers(0, 30, (40, 3)).astype(np.int32)
    src = str(tmp_path / "mesh.obj")
    port_mesh.save_obj(src, verts, faces, rng.uniform(0, 1, (30, 3)))
    T = np.eye(4)
    T[:3, :3] = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]])
    T[:3, 3] = [0.5, -1.0, 2.0]
    port_transform.transform_mesh(src, str(tmp_path / "a.obj"), 0.25, T)
    jax_transform.transform_mesh(src, str(tmp_path / "b.obj"), 0.25, T)
    assert (tmp_path / "a.obj").read_bytes() == (tmp_path / "b.obj").read_bytes()
    v, f, c = port_mesh.load_obj(str(tmp_path / "a.obj"))
    np.testing.assert_allclose(v, (0.25 * verts) @ T[:3, :3].T + T[:3, 3], atol=1e-6)
    assert c is not None and np.array_equal(f, faces)
