"""The port's loaders, writers and image helpers against swnerf_tpu on the
CPU: the LLFF pose machinery, the area resize against cv2, the LLFF,
custom, LINEMOD and DeepVoxels loaders on captures written by the JAX
writers, the port's writers against the JAX ones, ``load_scene`` for every
dataset type, the JPEG refusal, and every ``configs/nerf/*.txt`` reaching
its loader.

Bars: poses, bounds, intrinsics and render paths within 1e-6; images equal
(float32 ones resized in float within 1e-6); written pixels within one
8-bit level. The JAX loaders read with imageio and resize with cv2, so the
tests that run them skip without either."""

import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from swnerf_torch.data import cameras
from swnerf_torch.utils.images import area_resize

imageio = pytest.importorskip("imageio.v2")
cv2 = pytest.importorskip("cv2")

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "configs" / "nerf").glob("*.txt"))


def _close(a, b, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), atol=atol, rtol=0)


# ---------------------------------------------------------------- the LLFF pose machinery


def _seeded_poses(n=7, seed=0):
    """[n, 3, 5] forward-facing poses (rotation near identity, hwf column)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a = rng.standard_normal(3) * 0.2
        q, _ = np.linalg.qr(np.eye(3) + np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]]))
        q = q * np.sign(np.diag(q))  # a rotation near the identity
        t = rng.standard_normal(3) * 0.5 + np.array([0.0, 0.0, 3.0])
        out.append(np.concatenate([q, t[:, None], np.array([[40.0], [60.0], [55.0]])], 1))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("fn", ["normalize", "viewmatrix", "poses_avg", "recenter_poses", "render_path_spiral",
                                "spherify_poses"])
def test_cameras_match_jax(fn):
    from swnerf_tpu.data import cameras as jcam

    poses = _seeded_poses()
    rng = np.random.default_rng(1)
    bds = rng.uniform(1.0, 5.0, (7, 2)).astype(np.float32)
    if fn == "normalize":
        x = rng.standard_normal(3)
        pairs = [(cameras.normalize(x), jcam.normalize(x))]
    elif fn == "viewmatrix":
        z, up, pos = rng.standard_normal((3, 3))
        pairs = [(cameras.viewmatrix(z, up, pos), jcam.viewmatrix(z, up, pos))]
    elif fn == "poses_avg":
        pairs = [(cameras.poses_avg(poses), jcam.poses_avg(poses))]
    elif fn == "recenter_poses":
        pairs = [(cameras.recenter_poses(poses), jcam.recenter_poses(poses))]
    elif fn == "render_path_spiral":
        c2w = jcam.poses_avg(poses)
        args = (c2w, poses[:, :3, 1].sum(0), [0.3, 0.2, 0.1], 2.5, 0.5, 2, 17)
        pairs = [(cameras.render_path_spiral(*args), jcam.render_path_spiral(*args))]
    else:
        pairs = list(zip(cameras.spherify_poses(poses, bds), jcam.spherify_poses(poses, bds)))
    for got, ref in pairs:
        assert np.asarray(got).shape == np.asarray(ref).shape
        _close(got, ref)


# ---------------------------------------------------------------- the area resize


@pytest.mark.parametrize("factor", [2, 4, 8])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_area_resize_uint8_matches_cv2_bytes(factor, channels):
    """Integer factors on uint8 (the _minify and mogrify caches): the bytes
    cv2 gives, ties included (random bytes hit every rounding case)."""
    rng = np.random.default_rng(factor * 10 + channels)
    shape = (96, 128) if channels == 1 else (96, 128, channels)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    size = (128 // factor, 96 // factor)
    got = area_resize(img, size)
    ref = cv2.resize(img, size, interpolation=cv2.INTER_AREA)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("hw", [(16, 16), (17, 17), (15, 21), (33, 10)])
def test_area_resize_float_half_size_matches_cv2(hw):
    """Half size in float32 at even and odd sizes (odd: fractional box
    weights)."""
    H, W = hw
    img = np.random.default_rng(H * W).random((H, W, 4)).astype(np.float32)
    got = area_resize(img, (W // 2, H // 2))
    ref = cv2.resize(img, (W // 2, H // 2), interpolation=cv2.INTER_AREA)
    assert got.dtype == np.float32 and got.shape == ref.shape
    _close(got, ref)


def test_area_resize_refuses_upscaling():
    with pytest.raises(ValueError):
        area_resize(np.zeros((4, 4, 3), np.uint8), (8, 8))


# ---------------------------------------------------------------- LLFF


def _jax_llff(root, n=6, size=8):
    from swnerf_tpu.data.synthetic import write_llff_scene

    write_llff_scene(str(root), n_images=n, size=size, n_samples=16)
    return root


@pytest.mark.parametrize("case", ["factor1", "factor2", "spherify", "path_zflat"])
def test_load_llff_data_matches_jax(tmp_path, case):
    """On a capture written by the JAX writer; at factor 2 each loader
    builds its own images_2/ cache (_minify), whose images must be equal."""
    from swnerf_tpu.data.llff import load_llff_data as jax_load

    from swnerf_torch.data.llff import load_llff_data

    a = _jax_llff(tmp_path / "a", size=16)
    b = tmp_path / "b"
    shutil.copytree(a, b)
    factor = 2 if case == "factor2" else 1
    kw = dict(factor=factor, recenter=True, bd_factor=0.75, spherify=case == "spherify",
              path_zflat=case == "path_zflat")
    ref = jax_load(str(a), **kw)
    got = load_llff_data(str(b), **kw)
    assert np.array_equal(got[0], ref[0])  # images
    for g, r in zip(got[1:4], ref[1:4]):  # poses, bds, render_poses
        assert g.shape == r.shape
        _close(g, r)
    assert got[4] == ref[4]  # i_test
    if factor == 2:
        names = sorted(os.listdir(a / "images_2"))
        assert names == sorted(os.listdir(b / "images_2")) and len(names) == 6
        for name in names:
            assert np.array_equal(imageio.imread(a / "images_2" / name), imageio.imread(b / "images_2" / name))


def test_write_llff_scene_matches_jax(tmp_path):
    from swnerf_tpu.data.synthetic import write_llff_scene as jax_write

    from swnerf_torch.data.synthetic import write_llff_scene

    jax_write(str(tmp_path / "a"), n_images=5, size=12, n_samples=24, seed=3)
    write_llff_scene(str(tmp_path / "b"), n_images=5, size=12, n_samples=24, seed=3, device="cpu")
    _close(np.load(tmp_path / "b" / "poses_bounds.npy"), np.load(tmp_path / "a" / "poses_bounds.npy"))
    for sub in ("images", "images_1"):
        names = sorted(os.listdir(tmp_path / "a" / sub))
        assert names == sorted(os.listdir(tmp_path / "b" / sub)) and len(names) == 5
        for name in names:
            ref = imageio.imread(tmp_path / "a" / sub / name).astype(int)
            got = imageio.imread(tmp_path / "b" / sub / name).astype(int)
            assert got.shape == ref.shape == (12, 12, 3)
            assert np.abs(got - ref).max() <= 1


def test_jpeg_folder_raises(tmp_path, monkeypatch):
    """A capture whose images/ holds JPEG files, on a machine without cv2:
    building the factor-2 cache must decode them, and the port refuses,
    naming the file (with cv2 it decodes them: tests/test_torch_images.py)."""
    from swnerf_torch.data.llff import load_llff_data

    root = _jax_llff(tmp_path / "cap")
    shutil.rmtree(root / "images_1")
    for name in os.listdir(root / "images"):
        img = imageio.imread(root / "images" / name)
        os.remove(root / "images" / name)
        imageio.imwrite(root / "images" / name.replace(".png", ".jpg"), img)
    monkeypatch.setitem(sys.modules, "cv2", None)  # `import cv2` raises ImportError
    with pytest.raises(NotImplementedError, match=r"image000\.jpg: JPEG decoding needs cv2"):
        load_llff_data(str(root), factor=2)
    with pytest.raises(NotImplementedError, match="JPEG decoding needs cv2"):
        load_llff_data(str(root), factor=1)


# ---------------------------------------------------------------- custom, LINEMOD, DeepVoxels


def _custom(root, intrinsics=None):
    from swnerf_tpu.data.synthetic import write_custom_scene

    write_custom_scene(str(root), n_images=10, size=16, n_samples=16)
    if intrinsics:  # fl_x != fl_y, an off-centre principal point
        meta = json.loads((root / "transforms.json").read_text())
        meta.update(intrinsics)
        (root / "transforms.json").write_text(json.dumps(meta))
    return root


@pytest.mark.parametrize("half_res", [False, True])
@pytest.mark.parametrize("intrinsics", [None, dict(fl_x=15.5, fl_y=12.25, cx=6.75, cy=9.5)],
                         ids=["writer", "hand_written"])
def test_load_custom_data_matches_jax(tmp_path, half_res, intrinsics):
    from swnerf_tpu.data.custom import load_custom_data as jax_load

    from swnerf_torch.data.custom import load_custom_data

    root = _custom(tmp_path, intrinsics)
    ref = jax_load(str(root), half_res=half_res, testskip=1)
    got = load_custom_data(str(root), half_res=half_res, testskip=1)
    imgs, poses, render_poses, K, hwf, i_split = got
    assert imgs.shape == ref[0].shape == ((10, 8, 8, 4) if half_res else (10, 16, 16, 4))
    _close(imgs, ref[0])
    if not half_res:
        assert np.array_equal(imgs, ref[0])
    for g, r in ((poses, ref[1]), (render_poses, ref[2]), (K, ref[3]), (hwf, ref[4])):
        _close(g, r)
    for g, r in zip(i_split, ref[5]):  # the seeded split
        assert np.array_equal(g, r)
    if intrinsics:
        assert K[0, 0] != K[1, 1] and K[0, 2] == intrinsics["cx"] / (2 if half_res else 1)


def _linemod(root, rgba=False):
    from swnerf_tpu.data.synthetic import write_linemod_scene

    K = write_linemod_scene(str(root), n_train=3, n_val=1, n_test=2, size=16, n_samples=16)
    if rgba:  # 4-channel frames
        for split in ("train", "val", "test"):
            for frame in json.loads((root / f"transforms_{split}.json").read_text())["frames"]:
                img = imageio.imread(frame["file_path"])
                imageio.imwrite(frame["file_path"], np.concatenate([img, np.full_like(img[..., :1], 200)], -1))
    return K


@pytest.mark.parametrize("testskip", [1, 2])
def test_load_linemod_data_matches_jax(tmp_path, testskip):
    from swnerf_tpu.data.linemod import load_linemod_data as jax_load

    from swnerf_torch.data.linemod import load_linemod_data

    _linemod(tmp_path)
    ref = jax_load(str(tmp_path), half_res=False, testskip=testskip)
    got = load_linemod_data(str(tmp_path), half_res=False, testskip=testskip)
    assert np.array_equal(got[0], ref[0])
    for g, r in zip(got[1:5], ref[1:5]):  # poses, render_poses, hwf, K
        _close(g, r)
    for g, r in zip(got[5], ref[5]):
        assert np.array_equal(g, r)
    assert got[6:] == ref[6:] == (2.0, 6.0)


def test_linemod_half_res_keeps_k_with_the_images(tmp_path):
    """Reference defect 1 (ROADMAP.md Queue C): under half_res the JAX
    loader halves the focal but returns the full-resolution K, which
    load_scene then uses. The port halves K with the images; the rest is
    equal."""
    from swnerf_tpu.data.linemod import load_linemod_data as jax_load

    from swnerf_torch.data.linemod import load_linemod_data

    K_in = _linemod(tmp_path)
    ref = jax_load(str(tmp_path), half_res=True, testskip=1)
    got = load_linemod_data(str(tmp_path), half_res=True, testskip=1)
    _close(np.asarray(ref[4]), K_in)  # the JAX loader: full resolution
    halved = K_in.copy()
    halved[:2] /= 2.0
    _close(got[4], halved)  # the port: the images' resolution
    assert got[3][2] == ref[3][2] == K_in[0, 0] / 2.0
    assert got[0].shape == ref[0].shape == (6, 8, 8, 3)
    _close(got[0], ref[0])


def test_linemod_half_res_keeps_four_channels(tmp_path):
    """Reference defect 2 (ROADMAP.md Queue C): the JAX loader resizes into
    a 3-channel buffer, so 4-channel frames fail under half_res; the port
    keeps the channels, each image cv2's area resize of the full one."""
    from swnerf_tpu.data.linemod import load_linemod_data as jax_load

    from swnerf_torch.data.linemod import load_linemod_data

    _linemod(tmp_path, rgba=True)
    with pytest.raises(ValueError):
        jax_load(str(tmp_path), half_res=True, testskip=1)
    full = jax_load(str(tmp_path), half_res=False, testskip=1)[0]
    got = load_linemod_data(str(tmp_path), half_res=True, testskip=1)[0]
    assert got.shape == (6, 8, 8, 4)
    _close(got, np.stack([cv2.resize(img, (8, 8), interpolation=cv2.INTER_AREA) for img in full]))


def _dv(root, n=3):
    """A small DeepVoxels tree (the loader reads any image size)."""
    rng = np.random.default_rng(1)
    for split, count in (("train", n), ("test", n + 1), ("validation", n + 2)):
        base = root / split / "cube"
        (base / "pose").mkdir(parents=True)
        (base / "rgb").mkdir()
        (base / "intrinsics.txt").write_text("50.0 7.5 8.5\n0. 0. 0.\n0.5\n1.0\n16.0 16.0\n0\n")
        for i in range(count):
            c2w = np.eye(4)
            c2w[:3, :3] = np.linalg.qr(rng.standard_normal((3, 3)))[0]
            c2w[:3, 3] = rng.standard_normal(3) * 4
            (base / "pose" / f"{i:03d}.txt").write_text(" ".join(str(x) for x in c2w.reshape(-1)))
            imageio.imwrite(base / "rgb" / f"{i:03d}.png", rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))


@pytest.mark.parametrize("testskip", [1, 2])
def test_load_dv_data_matches_jax(tmp_path, testskip):
    from swnerf_tpu.data.deepvoxels import load_dv_data as jax_load

    from swnerf_torch.data.deepvoxels import load_dv_data

    _dv(tmp_path)
    ref = jax_load(scene="cube", basedir=str(tmp_path), testskip=testskip)
    got = load_dv_data(scene="cube", basedir=str(tmp_path), testskip=testskip)
    assert np.array_equal(got[0], ref[0])
    for g, r in zip(got[1:4], ref[1:4]):
        _close(g, r)
    for g, r in zip(got[4], ref[4]):
        assert np.array_equal(g, r)


@pytest.mark.parametrize("kind", ["custom", "linemod", "deepvoxels"])
def test_writers_match_jax(tmp_path, kind):
    """The port's custom, LINEMOD and DeepVoxels writers against the JAX
    ones: the same files and metadata, pixels within one 8-bit level."""
    from swnerf_tpu.data import synthetic as jsyn

    from swnerf_torch.data import synthetic as tsyn

    a, b = tmp_path / "a", tmp_path / "b"
    if kind == "custom":
        jsyn.write_custom_scene(str(a), n_images=4, size=12, n_samples=16, seed=2)
        tsyn.write_custom_scene(str(b), n_images=4, size=12, n_samples=16, seed=2, device="cpu")
    elif kind == "linemod":
        k_a = jsyn.write_linemod_scene(str(a), n_train=2, n_val=1, n_test=1, size=12, n_samples=16, seed=2)
        k_b = tsyn.write_linemod_scene(str(b), n_train=2, n_val=1, n_test=1, size=12, n_samples=16, seed=2,
                                       device="cpu")
        _close(k_b, k_a)
    else:
        jsyn.write_deepvoxels_scene(str(a), n_train=1, n_val=1, n_test=1, n_samples=4, seed=2)
        tsyn.write_deepvoxels_scene(str(b), n_train=1, n_val=1, n_test=1, n_samples=4, seed=2, device="cpu")
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file()) and files
    for rel in files:
        if rel.suffix == ".png":
            ref, got = imageio.imread(a / rel).astype(int), imageio.imread(b / rel).astype(int)
            assert got.shape == ref.shape and np.abs(got - ref).max() <= 1, rel
        elif rel.suffix == ".json":
            ja, jb = json.loads((a / rel).read_text()), json.loads((b / rel).read_text())
            for fa, fb in zip(ja.pop("frames"), jb.pop("frames")):
                assert fa.pop("file_path").replace(str(a), "") == fb.pop("file_path").replace(str(b), "")
                assert set(fa) == set(fb)
                for key in fa:
                    _close(fb[key], fa[key])
            assert ja == jb
        else:
            na = np.array((a / rel).read_text().split(), np.float64)
            nb = np.array((b / rel).read_text().split(), np.float64)
            _close(nb, na)


# ---------------------------------------------------------------- load_scene and the configs


SCENE_CASES = {
    "llff": ["--dataset_type", "llff", "--factor", "1", "--llffhold", "3"],
    "llff_no_ndc": ["--dataset_type", "llff", "--factor", "2", "--llffhold", "0", "--no_ndc"],
    "llff_render_test": ["--dataset_type", "llff", "--factor", "1", "--llffhold", "2", "--render_test"],
    "blender": ["--dataset_type", "blender", "--white_bkgd", "--testskip", "1"],
    "custom": ["--dataset_type", "custom", "--white_bkgd", "--half_res"],
    "LINEMOD": ["--dataset_type", "LINEMOD", "--testskip", "1", "--render_test"],
    "deepvoxels": ["--dataset_type", "deepvoxels", "--shape", "cube", "--testskip", "2"],
}


@pytest.mark.parametrize("case", list(SCENE_CASES))
def test_load_scene_matches_jax(tmp_path, case):
    """Every field of the port's Scene against the JAX load_scene's."""
    from swnerf_tpu.pipelines.common import load_scene as jax_load_scene
    from swnerf_tpu.utils.config import config_parser as jax_parser

    from swnerf_torch.pipelines.common import load_scene
    from swnerf_torch.utils.config import config_parser

    data = tmp_path / "data"
    if case.startswith("llff"):
        _jax_llff(data, size=16)
    elif case == "blender":
        from swnerf_tpu.data.synthetic import write_blender_scene

        write_blender_scene(str(data), n_train=3, n_val=1, n_test=2, size=8, n_samples=16)
    elif case == "custom":
        _custom(data, dict(fl_x=15.5, fl_y=12.25, cx=6.75, cy=9.5))
    elif case == "LINEMOD":
        _linemod(data)
    else:
        _dv(data)
    argv = SCENE_CASES[case] + ["--datadir", str(data)]
    ref, got = jax_load_scene(jax_parser().parse_args(argv)), load_scene(config_parser().parse_args(argv))
    for field in ("images", "poses", "render_poses", "K", "i_train", "i_val", "i_test"):
        g, r = getattr(got, field), np.asarray(getattr(ref, field))
        assert g.shape == r.shape and g.dtype == r.dtype, field
        _close(g, r)
    for field in ("focal", "near", "far"):
        assert getattr(got, field) == pytest.approx(getattr(ref, field), abs=1e-6), field
    assert (got.H, got.W, got.ndc) == (ref.H, ref.W, ref.ndc)
    assert got.times is ref.times is None and got.render_times is ref.render_times is None
    assert got.ndc == (case in ("llff", "llff_render_test"))


def test_load_scene_rejects_unknown_types():
    import argparse

    from swnerf_torch.pipelines.common import load_scene

    with pytest.raises(ValueError, match="Unknown dataset type 'nerf_synthetic'"):
        load_scene(argparse.Namespace(dataset_type="nerf_synthetic"))


LOADERS = {"llff": ("llff", "load_llff_data"), "blender": ("blender", "load_blender_data"),
           "custom": ("custom", "load_custom_data")}


class _Reached(Exception):
    pass


@pytest.mark.parametrize("config", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_every_nerf_config_reaches_its_loader(config, monkeypatch, tmp_path):
    """Each configs/nerf/*.txt parses with the port's parser and load_scene
    hands its datadir and options to the loader of its dataset_type."""
    import importlib

    from swnerf_torch.pipelines.common import load_scene
    from swnerf_torch.utils.config import config_parser

    args = config_parser().parse_args(["--config", str(config), "--datadir", str(tmp_path)])
    module, name = LOADERS[args.dataset_type]
    calls = []

    def loader(*a, **kw):
        calls.append((a, kw))
        raise _Reached

    monkeypatch.setattr(importlib.import_module(f"swnerf_torch.data.{module}"), name, loader)
    with pytest.raises(_Reached):
        load_scene(args)
    assert calls and calls[0][0][0] == str(tmp_path)


def test_loaders_and_writers_run_without_imageio_cv2_pil(tmp_path):
    """With imageio, cv2 and PIL blocked, the port's writers write each
    format and its loaders read it (the LLFF factor-2 cache built by
    _minify, the float half_res resizes on their numpy path)."""
    import subprocess
    import sys

    code = f"""
import sys
for m in ('imageio', 'cv2', 'PIL', 'jax', 'swnerf_tpu'):
    sys.modules[m] = None
from swnerf_torch.data import synthetic as s
from swnerf_torch.data.custom import load_custom_data
from swnerf_torch.data.deepvoxels import load_dv_data
from swnerf_torch.data.linemod import load_linemod_data
from swnerf_torch.data.llff import load_llff_data
root = {str(tmp_path)!r}
s.write_llff_scene(root + '/llff', n_images=4, size=8, n_samples=8, device='cpu')
s.write_custom_scene(root + '/custom', n_images=10, size=8, n_samples=8, device='cpu')
s.write_linemod_scene(root + '/linemod', n_train=2, n_val=1, n_test=1, size=8, n_samples=8, device='cpu')
s.write_deepvoxels_scene(root + '/dv', n_train=1, n_val=1, n_test=1, n_samples=2, device='cpu')
shapes = [load_llff_data(root + '/llff', factor=2)[0].shape, load_custom_data(root + '/custom', half_res=True)[0].shape,
          load_linemod_data(root + '/linemod', half_res=True)[0].shape, load_dv_data('cube', root + '/dv', 1)[0].shape]
print(shapes)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[(4, 4, 4, 3), (10, 4, 4, 4), (4, 4, 4, 3), (3, 512, 512, 3)]"


def test_port_data_modules_import_no_image_libraries():
    """The port's loaders, writers and image helpers import no imageio or
    PIL, and cv2 only inside ``utils/images.py::_cv2`` (JPEG decoding and
    the float area resize, each with its path without cv2; transform_mesh's
    ArUco detection asks for cv2 too)."""
    import ast

    paths = sorted((REPO / "swnerf_torch" / "data").glob("*.py")) + [
        REPO / "swnerf_torch" / p for p in ("utils/images.py", "utils/png.py", "pipelines/common.py")]
    for path in paths:
        tree = ast.parse(path.read_text(), str(path))
        lazy = {id(n) for f in ast.walk(tree) if isinstance(f, ast.FunctionDef) and f.name == "_cv2"
                for n in ast.walk(f)} if path.name == "images.py" else set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""]
                banned = ("imageio", "PIL") if id(node) in lazy else ("imageio", "cv2", "PIL")
                assert not any(n.split(".")[0] in banned for n in names), f"{path}: {names}"
    assert "_cv2" in (REPO / "swnerf_torch" / "utils" / "images.py").read_text()
