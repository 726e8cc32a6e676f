"""The port's image reading and half resolution against swnerf_tpu on the
CPU (``swnerf_torch/utils/images.py``, the loaders' ``half_res``).

Bars: images equal (``np.array_equal``), poses within 1e-6.

- ``half_res``: the Blender loaders (static and dynamic, even and odd
  frame sizes), the custom and LINEMOD loaders against their JAX
  counterparts, which resize with ``cv2.resize(INTER_AREA)``; the port
  resizes with cv2 where it imports, and its numpy path without cv2 gives
  the same bytes (every exact box here, float32 and float64, 1 to 5
  channels).
- JPEG: ``read_images`` against ``imageio.imread`` (the JAX loaders'
  reader) on RGB files at quality 75 and 95, a grayscale file and files
  whose EXIF orientation tag asks for a rotation (neither applies it); a
  custom capture and an LLFF capture at factor 2 in JPEG through the
  port's and the JAX loaders; without cv2 the read refuses and names the
  file.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest

from swnerf_torch.utils import images

imageio = pytest.importorskip("imageio.v2")
cv2 = pytest.importorskip("cv2")
PIL = pytest.importorskip("PIL.Image")


def _close(a, b, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), atol=atol, rtol=0)


@pytest.fixture
def no_cv2(monkeypatch):
    """``import cv2`` raises ImportError inside the test."""
    monkeypatch.setitem(sys.modules, "cv2", None)


# ---------------------------------------------------------------- the area resize


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape,box", [
    ((64, 64, 4), (2, 2)), ((70, 70, 1), (2, 2)), ((62, 30, 1), (2, 2)), ((64, 64, 3), (2, 2)),
    ((64, 64), (2, 2)), ((30, 30, 5), (2, 2)), ((90, 60, 4), (3, 3)), ((90, 60, 3), (3, 3)),
    ((96, 96, 4), (4, 4)), ((90, 64, 4), (3, 2)), ((100, 100, 1), (5, 5)),
])
def test_area_resize_without_cv2_equals_cv2(shape, box, dtype, monkeypatch):
    """The numpy path's float summation order gives cv2's INTER_AREA bytes
    on images quantised to k/255 (every 2x2 tie and rounding case)."""
    img = (np.random.default_rng(sum(shape)).integers(0, 256, shape) / 255.0).astype(dtype)
    size = (shape[1] // box[1], shape[0] // box[0])
    ref = cv2.resize(img, size, interpolation=cv2.INTER_AREA).reshape(size[::-1] + shape[2:])  # cv2 drops a 1-channel axis
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = images.area_resize(img, size)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got, ref)


def test_area_resize_with_cv2_is_cv2():
    img = np.random.default_rng(1).random((33, 10, 4)).astype(np.float32)  # fractional boxes
    assert np.array_equal(images.area_resize(img, (5, 16)), cv2.resize(img, (5, 16), interpolation=cv2.INTER_AREA))


# ---------------------------------------------------------------- half_res against the JAX loaders


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
@pytest.mark.parametrize("size,cv2_present", [(16, True), (15, True), (16, False)], ids=["cv2", "cv2_odd", "numpy"])
def test_blender_half_res_equals_jax(tmp_path, monkeypatch, dynamic, size, cv2_present):
    """cv2 where it imports (odd sizes too), the numpy path without it (odd
    sizes there take fractional boxes summed in float64: not cv2's bytes)."""
    from swnerf_tpu.data import blender as jax_blender
    from swnerf_tpu.data.synthetic import write_blender_scene

    from swnerf_torch.data import blender

    write_blender_scene(str(tmp_path), n_train=3, n_val=1, n_test=1, size=size, dynamic=dynamic, n_samples=16)
    if dynamic:
        ref = jax_blender.load_blender_dynamic_data(str(tmp_path), half_res=True, testskip=1)
    else:
        ref = jax_blender.load_blender_data(str(tmp_path), half_res=True, testskip=1)
    if not cv2_present:
        monkeypatch.setitem(sys.modules, "cv2", None)
    got = (blender.load_blender_dynamic_data if dynamic else blender.load_blender_data)(
        str(tmp_path), half_res=True, testskip=1)
    assert got[0].dtype == np.float32 and got[0].shape == ref[0].shape == (5, size // 2, size // 2, 4)
    assert np.array_equal(got[0], ref[0])
    hwf = got[5] if dynamic else got[3]
    _close(hwf, ref[5] if dynamic else ref[3])


def _custom(root, jpeg=False):
    from swnerf_tpu.data.synthetic import write_custom_scene

    write_custom_scene(str(root), n_images=10, size=16, n_samples=16)
    if jpeg:  # a phone capture's files: JPEG
        meta = json.loads((root / "transforms.json").read_text())
        for frame in meta["frames"]:
            src = root / frame["file_path"]
            frame["file_path"] = os.path.splitext(frame["file_path"])[0] + ".jpg"
            imageio.imwrite(root / frame["file_path"], imageio.imread(src), quality=90)
            os.remove(src)
        (root / "transforms.json").write_text(json.dumps(meta))
    return root


@pytest.mark.parametrize("jpeg", [False, True], ids=["png", "jpeg"])
@pytest.mark.parametrize("half_res", [False, True])
def test_custom_equals_jax(tmp_path, half_res, jpeg):
    from swnerf_tpu.data.custom import load_custom_data as jax_load

    from swnerf_torch.data.custom import load_custom_data

    root = _custom(tmp_path, jpeg)
    ref = jax_load(str(root), half_res=half_res, testskip=1)
    got = load_custom_data(str(root), half_res=half_res, testskip=1)
    assert got[0].shape == ref[0].shape and np.array_equal(got[0], ref[0])
    for g, r in zip(got[1:5], ref[1:5]):
        _close(g, r)


def test_linemod_half_res_equals_jax(tmp_path):
    """3-channel frames (the JAX loader resizes into a 3-channel buffer).
    K differs on purpose (the port halves it: ROADMAP.md Queue C #5)."""
    from swnerf_tpu.data.linemod import load_linemod_data as jax_load
    from swnerf_tpu.data.synthetic import write_linemod_scene

    from swnerf_torch.data.linemod import load_linemod_data

    write_linemod_scene(str(tmp_path), n_train=3, n_val=1, n_test=2, size=16, n_samples=16)
    ref = jax_load(str(tmp_path), half_res=True, testskip=1)
    got = load_linemod_data(str(tmp_path), half_res=True, testskip=1)
    assert got[0].shape == ref[0].shape == (6, 8, 8, 3) and np.array_equal(got[0], ref[0])
    _close(got[3], ref[3])


# ---------------------------------------------------------------- JPEG decoding


def _photo(rng, H=120, W=160):
    """A smooth photo-like RGB picture with some texture."""
    ys, xs = np.mgrid[0:H, 0:W]
    base = np.stack([xs / W, ys / H, 0.5 + 0.5 * np.sin(xs / 7.0) * np.cos(ys / 5.0)], -1)
    return np.clip(255 * base + rng.normal(0, 6, base.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("quality", [75, 95])
def test_read_jpeg_rgb_equals_imageio(tmp_path, quality):
    path = str(tmp_path / "a.jpg")
    imageio.imwrite(path, _photo(np.random.default_rng(quality)), quality=quality)
    got = images.read_images([path])[0]
    ref = imageio.imread(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape == (120, 160, 3)
    assert np.array_equal(got, ref)


def test_read_jpeg_gray_stays_2d(tmp_path):
    path = str(tmp_path / "g.jpeg")
    imageio.imwrite(path, _photo(np.random.default_rng(0))[..., 1], quality=90)
    got, ref = images.read_images([path])[0], imageio.imread(path)
    assert got.shape == ref.shape == (120, 160) and np.array_equal(got, ref)


@pytest.mark.parametrize("orientation", [3, 6, 8])
def test_read_jpeg_leaves_exif_orientation_unapplied(tmp_path, orientation):
    """A phone capture's tag (6: rotate 90 degrees) is left as imageio
    leaves it: the stored 120 x 160 pixels, where cv2.IMREAD_COLOR would
    rotate."""
    path = str(tmp_path / "o.JPG")
    exif = PIL.Exif()
    exif[0x0112] = orientation
    PIL.fromarray(_photo(np.random.default_rng(orientation))).save(path, quality=92, exif=exif.tobytes())
    got, ref = images.read_images([path])[0], imageio.imread(path)
    assert got.shape == ref.shape == (120, 160, 3) and np.array_equal(got, ref)
    if orientation in (6, 8):
        assert cv2.imread(path, cv2.IMREAD_COLOR).shape == (160, 120, 3)  # what the loaders avoid


def test_read_images_keeps_order_across_formats(tmp_path):
    from swnerf_torch.utils.png import write_png_bytes

    rng = np.random.default_rng(3)
    paths, want = [], []
    for i, ext in enumerate(["png", "jpg", "png", "jpeg", "PNG"]):
        img = _photo(rng, 24, 32)
        p = str(tmp_path / f"{i}.{ext}")
        if ext.lower() == "png":
            write_png_bytes(p, img)
        else:
            imageio.imwrite(p, img, quality=90)
        paths.append(p)
        want.append(imageio.imread(p))
    for g, r in zip(images.read_images(paths), want):
        assert np.array_equal(g, r)


def test_llff_jpeg_capture_factor2_equals_jax(tmp_path):
    """An LLFF capture whose images/ holds JPEG: each loader builds its own
    images_2/ PNG cache from the decoded JPEGs (imageio and cv2.resize in
    the JAX loader; cv2.imdecode and area_resize in the port)."""
    from swnerf_tpu.data.llff import load_llff_data as jax_load
    from swnerf_tpu.data.synthetic import write_llff_scene

    from swnerf_torch.data.llff import load_llff_data

    a = tmp_path / "a"
    write_llff_scene(str(a), n_images=6, size=16, n_samples=16)
    shutil.rmtree(a / "images_1")
    for name in os.listdir(a / "images"):
        img = imageio.imread(a / "images" / name)
        os.remove(a / "images" / name)
        imageio.imwrite(a / "images" / name.replace(".png", ".jpg"), img, quality=90)
    b = tmp_path / "b"
    shutil.copytree(a, b)
    ref = jax_load(str(a), factor=2)
    got = load_llff_data(str(b), factor=2)
    assert got[0].shape == ref[0].shape == (6, 8, 8, 3) and np.array_equal(got[0], ref[0])
    for g, r in zip(got[1:4], ref[1:4]):
        _close(g, r, atol=1e-5)
    for name in sorted(os.listdir(a / "images_2")):
        assert np.array_equal(imageio.imread(b / "images_2" / name), imageio.imread(a / "images_2" / name))


def test_jpeg_without_cv2_raises_naming_the_file(tmp_path, no_cv2):
    from swnerf_torch.data.custom import load_custom_data

    path = tmp_path / "frame_07.jpg"
    path.write_bytes(b"\xff\xd8\xff")  # never decoded
    with pytest.raises(NotImplementedError, match=r"frame_07\.jpg: JPEG decoding needs cv2"):
        images.read_images([str(path)])
    root = tmp_path / "cap"
    _custom(root, jpeg=True)
    with pytest.raises(NotImplementedError, match=r"\.jpg: JPEG decoding needs cv2"):
        load_custom_data(str(root))
