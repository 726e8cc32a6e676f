"""What the trainers log, check and write, and the evaluation tools, in
swnerf_torch on the CPU: ``pipelines/eval_dirs.py`` and ``utils/color.py``
against the JAX package's, ``utils/media.py::write_video`` (mp4 through cv2,
the port's GIF without it), ``SWNERF_DEBUG_NANS`` and ``SWNERF_PROFILE_DIR``
in ``run_nerf``, TensorBoard from ``utils/logging.py`` and ``run_dnerf``'s
``--i_img``, and D-NeRF's ``--do_half_precision`` on the plain route.

Bars: eval_dirs' mse, psnr and ssim within 1e-10 of the JAX package's (the
same float64 numpy), lpips within 1e-5 (fp32 convolutions); hsv_to_rgb bit
for bit; the GIF within half its palette's step per channel (25.5 of 255 on
the colour cube's six levels, exact on greys); runs with the debug switch
or the profiler bit-equal to runs without; the half-precision forward
within 1e-5 (relative L2) of a float64 forward whose matmul inputs are
rounded to bf16, and bit-equal to the fp32 forward without the flag."""

import json
import sys

import numpy as np
import pytest
import torch

from swnerf_torch.models import DirectTemporalNeRF, DNeRFConfig
from swnerf_torch.ops.embedding import positional_encoding
from swnerf_torch.pipelines import eval_dirs, run_dnerf, run_nerf
from swnerf_torch.train import checkpoint as ck
from swnerf_torch.utils import color, media, msgpack
from swnerf_torch.utils.metrics import LPIPS_UNAVAILABLE_NOTE
from swnerf_torch.utils.png import write_png_bytes
from swnerf_tpu.data.synthetic import write_blender_scene
from swnerf_tpu.pipelines import eval_dirs as jax_eval_dirs
from swnerf_tpu.utils import color as jax_color
from swnerf_tpu.utils import lpips_jax
from test_torch_lpips import write_lpips_weights

torch.set_num_threads(2)


# ---------------------------------------------------------------- eval_dirs, hsv_to_rgb


@pytest.fixture()
def frame_dirs(tmp_path):
    """Three 32 x 32 predicted and ground-truth PNG frames, seeded."""
    rng = np.random.default_rng(0)
    pred, gt = tmp_path / "pred", tmp_path / "gt"
    for d in (pred, gt):
        d.mkdir()
    for i in range(3):
        g = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
        p = np.clip(g.astype(int) + rng.integers(-20, 21, g.shape), 0, 255).astype(np.uint8)
        write_png_bytes(str(gt / f"{i:03d}.png"), g)
        write_png_bytes(str(pred / f"{i:03d}.png"), p)
    return pred, gt


@pytest.mark.parametrize("with_lpips", [False, True])
def test_eval_dirs_matches_jax(with_lpips, frame_dirs, tmp_path, monkeypatch):
    """Per frame and in the mean: mse, psnr and ssim within 1e-10, lpips
    (vgg) within 1e-5 or null on both sides; metrics.txt's keys; the note in
    metrics.json and metrics.txt only when LPIPS is null."""
    pred, gt = frame_dirs
    if with_lpips:
        weights = tmp_path / "w"
        weights.mkdir()
        write_lpips_weights(weights, "vgg")
        monkeypatch.setenv("SWNERF_LPIPS_DIR", str(weights))
    else:
        monkeypatch.delenv("SWNERF_LPIPS_DIR", raising=False)
    lpips_jax.from_env.cache_clear()  # the JAX package caches by net only
    eval_dirs.main(["--pred", str(pred), "--gt", str(gt), "--out", str(tmp_path / "port"), "--device", "cpu"])
    jax_eval_dirs.main(["--pred", str(pred), "--gt", str(gt), "--out", str(tmp_path / "jax")])
    lpips_jax.from_env.cache_clear()
    got, want = (json.loads((tmp_path / d / "metrics.json").read_text()) for d in ("port", "jax"))
    for a, b in zip(got["frames"] + [got["mean"]], want["frames"] + [want["mean"]]):
        for k in ("mse", "psnr", "ssim"):
            assert abs(a[k] - b[k]) <= 1e-10, k
        assert (a["lpips"] is None) == (b["lpips"] is None) == (not with_lpips)
        if with_lpips:
            assert abs(a["lpips"] - b["lpips"]) <= 1e-5
    assert [f["pred"] for f in got["frames"]] == ["000.png", "001.png", "002.png"]
    text = (tmp_path / "port" / "metrics.txt").read_text()
    assert [ln.split(":")[0] for ln in text.splitlines()][:4] == ["mse", "psnr", "ssim", "lpips"]
    assert ("lpips_note" in got) == ("note:" in text) == (not with_lpips)
    if not with_lpips:
        assert got["lpips_note"] == LPIPS_UNAVAILABLE_NOTE


def test_eval_dirs_refuses_a_count_mismatch_and_jpeg(frame_dirs, monkeypatch):
    pred, gt = frame_dirs
    (pred / "003.png").write_bytes((pred / "000.png").read_bytes())
    with pytest.raises(ValueError, match="frame count mismatch"):
        eval_dirs.evaluate_dirs(str(pred), str(gt))
    (pred / "003.png").unlink()
    (pred / "002.png").rename(pred / "002.jpg")
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)  # JPEG needs cv2: without it the read refuses
        with pytest.raises(NotImplementedError, match=r"002\.jpg: JPEG decoding needs cv2"):
            eval_dirs.evaluate_dirs(str(pred), str(gt))


def test_hsv_to_rgb_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    h, s, v = (rng.uniform(0, 1, (17, 19)) for _ in range(3))
    h[0, :7] = np.arange(7) / 6  # sector edges, and h = 1
    got = color.hsv_to_rgb(h, s, v)
    assert got.dtype == np.float64 and got.shape == (17, 19, 3)
    assert np.array_equal(got, jax_color.hsv_to_rgb(h, s, v))


def test_show_writes_a_png(tmp_path):
    color.show(np.random.default_rng(0).uniform(0, 1, (8, 8)), str(tmp_path), "disp", 3)
    assert (tmp_path / "disp" / "3.png").stat().st_size > 0


# ---------------------------------------------------------------- write_video


def _frames(T=5, H=24, W=32, grey=False):
    rng = np.random.default_rng(0)
    return rng.uniform(0, 1, (T, H, W) if grey else (T, H, W, 3)).astype(np.float32)


def test_write_video_mp4_through_cv2(tmp_path):
    cv2 = pytest.importorskip("cv2")
    frames = _frames()
    path = media.write_video(str(tmp_path / "v" / "video.mp4"), frames)
    assert path == str(tmp_path / "v" / "video.mp4")
    cap = cv2.VideoCapture(path)
    shapes = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        shapes.append(f.shape)
    assert shapes == [(24, 32, 3)] * 5


@pytest.mark.parametrize("grey", [False, True])
def test_write_video_gif_without_cv2(grey, tmp_path, monkeypatch):
    """With cv2 hidden the port's GIF: PIL reads T frames of H x W, each
    channel within half the palette's step (exact for grey frames, which get
    the 256-grey palette)."""
    from PIL import Image

    monkeypatch.setitem(sys.modules, "cv2", None)  # `import cv2` raises ImportError
    frames = _frames(T=4, H=21, W=330, grey=grey)  # rows of 330 px: codes span the 255-byte sub-blocks
    path = media.write_video(str(tmp_path / "disp.mp4"), frames)
    assert path == str(tmp_path / "disp.gif")
    im = Image.open(path)
    assert im.n_frames == 4
    want = media.to8b(frames if not grey else np.repeat(frames[..., None], 3, -1)).astype(int)
    half_step = np.array([0, 0, 0]) if grey else 255 / (2 * (np.array(media.CUBE) - 1))
    for t in range(4):
        im.seek(t)
        got = np.asarray(im.convert("RGB")).astype(int)
        assert got.shape == (21, 330, 3)
        assert np.all(np.abs(got - want[t]).max(axis=(0, 1)) <= half_step + 1e-9)


def test_write_video_raises_when_cv2_cannot_open(tmp_path, monkeypatch):
    cv2 = pytest.importorskip("cv2")

    class Closed:
        def __init__(self, *a):
            pass

        def isOpened(self):
            return False

    monkeypatch.setattr(cv2, "VideoWriter", Closed)
    with pytest.raises(RuntimeError, match="could not open"):
        media.write_video(str(tmp_path / "v.mp4"), _frames())
    assert not (tmp_path / "v.gif").exists()


# ---------------------------------------------------------------- run_nerf's debug switch and profiler


@pytest.fixture(scope="module")
def static_scene(tmp_path_factory):
    data = tmp_path_factory.mktemp("static") / "data"
    write_blender_scene(str(data), n_train=3, n_val=1, n_test=1, size=16)
    return data


def _nerf_argv(data, logs):
    return ["--expname", "e", "--basedir", str(logs), "--datadir", str(data), "--dataset_type", "blender",
            "--white_bkgd", "--use_viewdirs", "--netdepth", "2", "--netwidth", "32", "--netdepth_fine", "2",
            "--netwidth_fine", "32", "--multires", "2", "--multires_views", "1", "--N_rand", "16",
            "--N_samples", "8", "--N_importance", "8", "--chunk", "128", "--i_weights", "4", "--i_print", "2",
            "--i_video", "100000", "--i_testset", "100000", "--precrop_iters", "0", "--testskip", "1",
            "--device", "cpu"]


def _run_nerf(monkeypatch, data, logs, env):
    for k in ("SWNERF_DEBUG_NANS", "SWNERF_PROFILE_DIR", "SWNERF_PROFILE_STEPS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SWNERF_MAX_ITERS", "9")
    monkeypatch.setenv("SWNERF_STEPS_PER_DISPATCH", "2")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    return run_nerf.main(_nerf_argv(data, logs))


def _records(exp):
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    return [{k: v for k, v in r.items() if k not in ("t", "steps_per_sec", "ray_samples_per_sec_per_chip")}
            for r in recs]


def _assert_same_run(a, b):
    ta, tb = ck.load_tar(str(a / "000008.tar")), ck.load_tar(str(b / "000008.tar"))
    for key in ("network_fn_state_dict", "network_fine_state_dict"):
        assert all(torch.equal(v, tb[key][n]) for n, v in ta[key].items())
    for x, y in zip(ta["optimizer_state_dict"]["state"].values(), tb["optimizer_state_dict"]["state"].values()):
        assert torch.equal(x["exp_avg"], y["exp_avg"]) and torch.equal(x["exp_avg_sq"], y["exp_avg_sq"])
    assert _records(a) == _records(b) and _records(a)


def test_debug_nans_and_profiler_leave_the_run_bit_equal(static_scene, tmp_path, monkeypatch):
    """8 steps, 2 a dispatch: SWNERF_DEBUG_NANS=1 with SWNERF_PROFILE_DIR
    (3 steps) against neither: the same 000008.tar and metrics.jsonl; the
    profiled run writes one Chrome trace of the steps, the plain run no
    trace directory."""
    prof = tmp_path / "prof"
    res = _run_nerf(monkeypatch, static_scene, tmp_path / "on",
                    {"SWNERF_DEBUG_NANS": "1", "SWNERF_PROFILE_DIR": str(prof), "SWNERF_PROFILE_STEPS": "3"})
    plain = _run_nerf(monkeypatch, static_scene, tmp_path / "off", {})
    _assert_same_run(tmp_path / "on" / "e", tmp_path / "off" / "e")
    assert res["metrics"] == plain["metrics"]
    traces = sorted(prof.iterdir())
    assert [p.name for p in traces] == ["trace_1-2.json"]  # from chunk 1-2; the chunk at 3 = start + 3 stops it
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("addmm" in e.get("name", "") or "linear" in e.get("name", "") for e in events)
    assert [p for p in tmp_path.rglob("trace*.json") if prof not in p.parents] == []


@pytest.mark.parametrize("k", ["1", "2"])
def test_debug_nans_raises_on_a_planted_nan(k, static_scene, tmp_path, monkeypatch):
    """A NaN planted in one weight of the step-8 native snapshot: resumed
    with SWNERF_DEBUG_NANS=1 (1 or 2 steps a dispatch) the run raises
    FloatingPointError naming iteration 9, the first after the snapshot;
    without the switch it runs on to its next save."""
    _run_nerf(monkeypatch, static_scene, tmp_path / "a", {"SWNERF_CKPT_FORMAT": "native"})
    raw = msgpack.unpackb((tmp_path / "a" / "e" / "000008.msgpack").read_bytes())
    raw["state"]["params"]["coarse"]["pts_linears"]["1"]["w"][3, 5] = np.nan
    monkeypatch.setenv("SWNERF_STEPS_PER_DISPATCH", k)
    monkeypatch.setenv("SWNERF_MAX_ITERS", "13")
    for case in ("on", "off"):
        exp = tmp_path / case / "e"
        exp.mkdir(parents=True)
        (exp / "000008.msgpack").write_bytes(msgpack.packb(raw))
        if case == "on":
            monkeypatch.setenv("SWNERF_DEBUG_NANS", "1")
            with pytest.raises(FloatingPointError, match="non-finite loss at iteration 9 "):
                run_nerf.main(_nerf_argv(static_scene, tmp_path / case))
        else:
            monkeypatch.delenv("SWNERF_DEBUG_NANS")
            run_nerf.main(_nerf_argv(static_scene, tmp_path / case))
            assert (exp / "000012.msgpack").exists()


def test_debug_nans_names_a_parameter_after_a_finite_loss():
    """A dispatch whose losses stay finite passes; one that leaves a
    parameter non-finite with finite losses names the dispatch."""
    from swnerf_torch.utils.logging import enable_debug_nans

    p = torch.nn.Parameter(torch.ones(4))
    check = enable_debug_nans([p], 3)
    wrapped = check.wrap(lambda: {"loss": torch.tensor(0.5)})
    check.begin(10, 3)
    for _ in range(3):
        wrapped()
    check.check()
    check.begin(13, 2)
    for _ in range(2):
        wrapped()
    with torch.no_grad():
        p[2] = float("nan")
    with pytest.raises(FloatingPointError, match="parameter after the dispatch of iterations 13-14"):
        check.check()
    with pytest.raises(ValueError, match="exceeds"):
        check.begin(15, 4)


def test_profiler_trace_context(tmp_path, monkeypatch):
    from swnerf_torch.utils.profiling import StepProfiler, trace

    with trace(str(tmp_path / "t")):
        torch.ones(3).sum()
    assert (tmp_path / "t" / "trace.json").exists()
    with trace(None):
        pass
    monkeypatch.delenv("SWNERF_PROFILE_DIR", raising=False)
    prof = StepProfiler()
    for i in range(1, 30):
        prof.step(i, 0)
    prof.close(29)
    assert prof.logdir is None and prof.path is None


# ---------------------------------------------------------------- TensorBoard


@pytest.fixture(scope="module")
def dynamic_scene(tmp_path_factory):
    data = tmp_path_factory.mktemp("dynamic") / "data"
    write_blender_scene(str(data), n_train=4, n_val=2, n_test=1, size=16, dynamic=True)
    return data


def _dnerf_argv(data, logs, *extra):
    return ["--expname", "d", "--basedir", str(logs), "--datadir", str(data), "--dataset_type", "blender",
            "--nerf_type", "direct_temporal", "--white_bkgd", "--use_viewdirs", "--netdepth", "2",
            "--netwidth", "32", "--multires", "2", "--multires_views", "1", "--N_rand", "8", "--N_samples", "8",
            "--chunk", "128", "--testskip", "1", "--i_weights", "100000", "--i_print", "2", "--i_img", "3",
            "--i_video", "100000", "--i_testset", "100000", "--raw_noise_std", "1", "--device", "cpu", *extra]


def _tb_events(d):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(d), size_guidance={"images": 0, "scalars": 0})
    acc.Reload()
    return acc


def test_tensorboard_scalars_and_i_img(dynamic_scene, tmp_path, monkeypatch):
    """run_dnerf for 6 steps (print 2, image 3): the scalars read back from
    the event file equal metrics.jsonl's (as fp32), and --i_img wrote gt,
    rgb and disp at steps 3 and 6."""
    pytest.importorskip("tensorboardX")
    monkeypatch.setenv("SWNERF_MAX_ITERS", "7")
    run_dnerf.main(_dnerf_argv(dynamic_scene, tmp_path))
    acc = _tb_events(tmp_path / "summaries" / "d")
    recs = [json.loads(line) for line in (tmp_path / "d" / "metrics.jsonl").read_text().splitlines()]
    for key in ("loss", "psnr", "total_loss"):
        want = [(r["step"], np.float32(r[key])) for r in recs if key in r]
        got = [(e.step, np.float32(e.value)) for e in acc.Scalars(key)]
        assert got == want and len(want) == 3, key
    assert sorted(acc.Tags()["images"]) == ["disp", "gt", "rgb"]
    for tag in ("gt", "rgb", "disp"):
        assert [e.step for e in acc.Images(tag)] == [3, 6]
        assert (acc.Images(tag)[0].width, acc.Images(tag)[0].height) == (16, 16)


def test_training_runs_without_tensorboardx(dynamic_scene, tmp_path, monkeypatch):
    """With the tensorboardX import made to fail the run trains, writes
    metrics.jsonl, skips the --i_img render and makes no summaries/."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    monkeypatch.setenv("SWNERF_MAX_ITERS", "7")
    run_dnerf.main(_dnerf_argv(dynamic_scene, tmp_path))
    assert not (tmp_path / "summaries").exists()
    recs = [json.loads(line) for line in (tmp_path / "d" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if "psnr" in r] == [2, 4, 6]


# ---------------------------------------------------------------- --do_half_precision


def _bf16(x64):
    return torch.from_numpy(np.asarray(x64, np.float32)).to(torch.bfloat16).to(torch.float64)


def _reference_dx_and_raw(model, pts, viewdirs, t):
    """A float64 DirectTemporalNeRF forward whose every dense layer rounds
    its input and weight to bf16 (the rounding a bf16 pass makes), the sums
    in float64. The encodings are the field's own (fp32, of ``pts + dx``
    formed in fp32 as the field forms it): at high frequencies a float64
    encoding moves by more than bf16's rounding boundaries allow."""
    cfg = model.cfg

    def dense(lyr, x):
        return _bf16(x) @ _bf16(lyr.weight.detach()).T + lyr.bias.detach().double()

    pts_emb = positional_encoding(pts, cfg.nf_pts).double()
    h = torch.cat([pts_emb, positional_encoding(t, cfg.nf_time).double()], -1)
    for i, lyr in enumerate(model._time):
        h = torch.relu(dense(lyr, h))
        if i in cfg.skips:
            h = torch.cat([pts_emb, h], -1)
    dx = dense(model._time_out, h)
    emb = positional_encoding(pts + dx.float(), cfg.nf_pts).double()
    occ = model._occ
    h = emb
    for i, lyr in enumerate(occ.pts_linears):
        h = torch.relu(dense(lyr, h))
        if i in cfg.skips:
            h = torch.cat([emb, h], -1)
    alpha = dense(occ.alpha_linear, h)
    ve = positional_encoding(viewdirs, cfg.nf_views).double()[:, None, :].expand(*pts.shape[:-1], -1)
    h = torch.cat([dense(occ.feature_linear, h), ve], -1)
    for lyr in occ.views_linears:
        h = torch.relu(dense(lyr, h))
    return dx, torch.cat([dense(occ.rgb_linear, h), alpha], -1)


def test_half_precision_plain_forward(monkeypatch):
    """The plain route with ``half_precision``. Every dense layer's output
    within 1e-5 (relative L2) of float64 on the same input and weight
    rounded to bf16; the deformation net's dx within 1e-5 of the float64
    chain. The raw output within 1e-3 of that chain: where an fp32 and a
    float64 activation round to different bf16 values (4 of 4,096 raw
    values here, measured 1.2e-4) the chain parts; the fp32 forward is
    further (measured 6.7e-3). Without the flag every dense layer is
    bit-equal to ``F.linear(x, W, b)`` on its input, the fp32 product the
    forward made before the flag existed; the gradients flow."""
    from swnerf_torch.models import common, dnerf, vanilla

    cfg = dict(netdepth=8, netwidth=64, skips=(4,), multires=6, multires_views=2, use_viewdirs=True, output_ch=4,
               zero_canonical=False)
    g = torch.Generator().manual_seed(0)
    half = DirectTemporalNeRF(DNeRFConfig(**cfg, half_precision=True), device="cpu", generator=g, fused=False)
    rng = np.random.default_rng(1)
    pts = torch.from_numpy(rng.uniform(-1.5, 1.5, (64, 16, 3)).astype(np.float32))
    vd = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32)), dim=-1)
    t = torch.from_numpy(rng.uniform(0, 1, (64, 1)).astype(np.float32))

    layer_errs = []

    def checked_dense(layer, x, half_flag=False):
        out = common.dense(layer, x, half_flag)
        ref = _bf16(x.detach()) @ _bf16(layer.weight.detach()).T + layer.bias.detach().double()
        layer_errs.append((half_flag, float(torch.linalg.norm(out.detach().double() - ref) / torch.linalg.norm(ref))))
        return out

    monkeypatch.setattr(vanilla, "dense", checked_dense)
    monkeypatch.setattr(dnerf, "dense", checked_dense)
    raw, extras = half(pts, vd, t)
    monkeypatch.undo()
    assert len(layer_errs) == 8 + 1 + 8 + 4 and all(h for h, _ in layer_errs)
    assert max(e for _, e in layer_errs) <= 1e-5, layer_errs

    def rel(a, b):
        return float(torch.linalg.norm(a.detach().double() - b) / torch.linalg.norm(b))

    ref_dx, ref_raw = _reference_dx_and_raw(half, pts, vd, t[..., None, :].expand(64, 16, 1))
    assert rel(extras["dx"], ref_dx) <= 1e-5
    full = DirectTemporalNeRF(DNeRFConfig(**cfg), device="cpu", fused=False)
    full.load_state_dict(half.state_dict())
    plain = []

    def fp32_dense(layer, x, half_flag=False):
        out = common.dense(layer, x, half_flag)
        plain.append(not half_flag and torch.equal(out, torch.nn.functional.linear(x, layer.weight, layer.bias)))
        return out

    monkeypatch.setattr(vanilla, "dense", fp32_dense)
    monkeypatch.setattr(dnerf, "dense", fp32_dense)
    raw32, _ = full(pts, vd, t)
    monkeypatch.undo()
    assert len(plain) == 8 + 1 + 8 + 4 and all(plain)
    assert rel(raw, ref_raw) <= 1e-3 < rel(raw32, ref_raw)
    raw.sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in half.parameters())


def test_do_half_precision_reaches_the_models(monkeypatch):
    args = run_dnerf.config_parser_dnerf().parse_args(["--do_half_precision", "--netdepth", "2"])
    assert run_dnerf._model_config(args, 2, 32).half_precision
    args = run_dnerf.config_parser_dnerf().parse_args(["--netdepth", "2"])
    assert not run_dnerf._model_config(args, 2, 32).half_precision
