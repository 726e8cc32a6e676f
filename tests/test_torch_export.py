"""The port's renderer export (``swnerf_torch/utils/export.py``,
``pipelines/export_model.py``) against swnerf_tpu on the CPU, mirroring
``tests/test_export.py``.

Bars: the port's artifact against the JAX artifact on the same weights
(``params_from_jax``) within atol 1e-5, rtol 5e-4 (``tests/test_torch_render.py``'s
bar for the two render cores); against the port's own eager ``render_rays``
bit for bit (NaN where the eager render has NaN: a ray with no density has
0 / 0 disparity in both packages). The fused artifacts' graphs call the
``swnerf::`` ops and run their plain twins here, bit-equal to the eager
fused fields. The four CLI modes export what the trainers saved.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swnerf_torch.models import DirectTemporalNeRF, DNeRFConfig, TNeRF, TNeRFConfig, VanillaNeRF, VanillaNeRFConfig
from swnerf_torch.pipelines import export_model
from swnerf_torch.render.core import Rays, RenderConfig, render_rays
from swnerf_torch.train.checkpoint import params_from_jax
from swnerf_torch.utils.export import export_renderer, kernel_ops, load_renderer
from swnerf_tpu.models import VanillaNeRFConfig as JaxVanillaConfig
from swnerf_tpu.models import make_vanilla_field
from swnerf_tpu.models.dnerf import DNeRFConfig as JaxDNeRFConfig
from swnerf_tpu.models.dnerf import make_dnerf_field
from swnerf_tpu.render import RenderConfig as JaxRenderConfig
from swnerf_tpu.utils.export import export_renderer as jax_export_renderer
from swnerf_tpu.utils.export import load_renderer as jax_load_renderer

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
OUTS = ("rgb", "disp", "acc", "depth")


def _rays(n, with_t=False, seed=0):
    """The rays of tests/test_export.py: from (0, 0, 4), unit directions."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = 4.0
    t = rng.uniform(0, 1, (n, 1)).astype(np.float32) if with_t else None
    return o, d, t


def _port_rays(o, d, t=None):
    n = o.shape[0]
    return Rays(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(d), torch.full((n,), 2.0),
                torch.full((n,), 6.0), None if t is None else torch.from_numpy(t))


def _call(art, params, rays):
    return art(params, rays.origins, rays.directions, rays.viewdirs, rays.near, rays.far,
               *(() if rays.times is None else (rays.times,)))


def _eager(field, rays, rcfg, fine=None):
    with torch.no_grad():
        out = render_rays(field, rays, rcfg.eval_mode(), fine_model=fine)
    return tuple(out[k] for k in OUTS)


def _same_bits(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert bool(torch.all((g == w) | (torch.isnan(g) & torch.isnan(w))))


def _params(coarse, fine=None):
    return {"coarse": {n: p.detach() for n, p in coarse.named_parameters()},
            "fine": None if fine is None else {n: p.detach() for n, p in fine.named_parameters()}}


VANILLA = dict(netdepth=2, netwidth=16, skips=(), multires=4, multires_views=2)


class TestExportRenderer:
    def test_vanilla_roundtrip_matches_jax_and_eager(self, tmp_path):
        jcfg = JaxVanillaConfig(**VANILLA)
        jfield = make_vanilla_field(jcfg, fused=False)
        jparams = {"coarse": jfield.init(jax.random.PRNGKey(0)), "fine": jfield.init(jax.random.PRNGKey(1))}
        rc = dict(n_samples=8, n_importance=8, perturb=1.0, white_bkgd=True, raw_noise_std=1.0)
        n = 32
        o, d, _ = _rays(n)
        jcall = jax_load_renderer(jax_export_renderer(jfield, jparams, JaxRenderConfig(**rc), n))
        ref = jcall(jparams, jnp.asarray(o), jnp.asarray(d), jnp.asarray(d), jnp.full((n,), 2.0), jnp.full((n,), 6.0))

        coarse, fine = (VanillaNeRF(VanillaNeRFConfig(**VANILLA), device="cpu", fused=False) for _ in range(2))
        coarse.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams["coarse"])))
        fine.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams["fine"])))
        params = _params(coarse, fine)
        blob = export_renderer(coarse, params, RenderConfig(**rc), n)
        path = tmp_path / "renderer.pt2"  # the artifact is plain bytes
        path.write_bytes(blob)
        art = load_renderer(path.read_bytes())
        assert art.meta == {"platforms": ["cpu"], "n_rays": n, "with_times": False, "fused": False,
                            "ops": ["swnerf.sample_pdf.default"]}  # B2 in the fine pass, as the JAX artifact
        rays = _port_rays(o, d)
        got = _call(art, params, rays)
        for k, g, r in zip(OUTS, got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=5e-4, err_msg=k)
        # without a distinct fine field the fine params run the coarse architecture: the same render
        _same_bits(got, _eager(coarse, rays, RenderConfig(**rc), fine))
        # the params are an input: other weights, the same artifact
        params2 = {k: {n: p + 0.01 for n, p in v.items()} for k, v in params.items()}
        coarse.load_state_dict(params2["coarse"])
        fine.load_state_dict(params2["fine"])
        _same_bits(_call(art, params2, rays), _eager(coarse, rays, RenderConfig(**rc), fine))

    def test_dnerf_with_times(self):
        kw = dict(netdepth=3, netwidth=16, skips=(1,), multires=2, multires_views=1)
        jfield = make_dnerf_field(JaxDNeRFConfig(**kw), fused=False)
        jparams = {"coarse": jfield.init(jax.random.PRNGKey(0)), "fine": None}
        rc = dict(n_samples=8, n_importance=0, perturb=0.0, white_bkgd=True)
        n = 16
        o, d, t = _rays(n, with_t=True)
        jcall = jax_load_renderer(jax_export_renderer(jfield, jparams, JaxRenderConfig(**rc), n, with_times=True))
        ref = jcall(jparams, jnp.asarray(o), jnp.asarray(d), jnp.asarray(d), jnp.full((n,), 2.0),
                    jnp.full((n,), 6.0), jnp.asarray(t))
        field = DirectTemporalNeRF(DNeRFConfig(**kw), device="cpu", fused=False)
        field.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams["coarse"])))
        art = load_renderer(export_renderer(field, _params(field), RenderConfig(**rc), n))
        assert art.meta["with_times"]  # detected from the field
        rays = _port_rays(o, d, t)
        got = _call(art, _params(field), rays)
        for k, g, r in zip(OUTS, got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=5e-4, err_msg=k)
        _same_bits(got, _eager(field, rays, RenderConfig(**rc)))

    def test_wrong_batch_size_and_platform_rejected(self):
        field = VanillaNeRF(VanillaNeRFConfig(**VANILLA), device="cpu", fused=False)
        params = _params(field)
        rcfg = RenderConfig(n_samples=8, n_importance=0, perturb=0.0)
        art = load_renderer(export_renderer(field, params, rcfg, 16))
        rays = _port_rays(*_rays(8)[:2])
        with pytest.raises(ValueError, match="batches of 16 rays, not 8"):
            _call(art, params, rays)
        with pytest.raises(ValueError, match="no times operand"):
            art(params, *_port_rays(*_rays(16)[:2])[:5], torch.zeros(16, 1))
        cuda_only = load_renderer(export_renderer(field, params, rcfg, 8, platforms=["cuda"]))
        with pytest.raises(ValueError, match=r"exported for \['cuda'\], not 'cpu'"):
            _call(cuda_only, params, rays)
        with pytest.raises(ValueError, match="export platforms"):
            export_renderer(field, params, rcfg, 8, platforms=["tpu"])


class TestCrossPlatform:
    def test_cpu_cuda_artifact_runs_on_cpu(self):
        """platforms cpu,cuda: one program traced on the CPU, which runs here
        (on a card it is moved to the inputs' device)."""
        field = VanillaNeRF(VanillaNeRFConfig(**VANILLA), device="cpu", fused=False,
                            generator=torch.Generator().manual_seed(0))
        rcfg = RenderConfig(n_samples=8, n_importance=0, perturb=0.0, white_bkgd=True)
        art = load_renderer(export_renderer(field, _params(field), rcfg, 8, platforms=["cpu", "cuda"]))
        assert art.meta["platforms"] == ["cpu", "cuda"]
        rays = _port_rays(*_rays(8)[:2])
        _same_bits(_call(art, _params(field), rays), _eager(field, rays, rcfg))
        devices = {n.kwargs["device"].type for n in art.program("cpu").graph.nodes if "device" in n.kwargs}
        assert devices == {"cpu"}  # the traced program's factory calls: moved, not re-traced, on a card


def _vanilla_fused(dtype=None, seed=0):
    cfg = VanillaNeRFConfig(netdepth=3, netwidth=128, skips=(1,), multires=4, multires_views=2)
    g = torch.Generator().manual_seed(seed)
    return (VanillaNeRF(cfg, device="cpu", generator=g, fused=True, compute_dtype=dtype),
            VanillaNeRF(cfg, device="cpu", generator=g, fused=True, compute_dtype=dtype))


class TestFusedExport:
    """Fields on the kernel route: the ops in the graph, their plain twins
    here, bit-equal to the eager fused fields (which run the same twins)."""

    @pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["fp32", "bf16"])
    @pytest.mark.parametrize("raw", [False, True], ids=["B7", "B8"])
    def test_vanilla(self, monkeypatch, raw, dtype):
        monkeypatch.setenv("SWNERF_FUSED_RAW", "1" if raw else "0")
        coarse, fine = _vanilla_fused(dtype=dtype)
        assert coarse.fused and coarse.uses_field_raw() == raw
        rcfg = RenderConfig(n_samples=8, n_importance=8, white_bkgd=True)
        art = load_renderer(export_renderer(coarse, _params(coarse, fine), rcfg, 24, fine_field=fine))
        assert art.meta["fused"] and kernel_ops(art.program("cpu")) == {"swnerf.trunk.default": 2,
                                                                         "swnerf.sample_pdf.default": 1}
        rays = _port_rays(*_rays(24, seed=3)[:2])
        got = _call(art, _params(coarse, fine), rays)
        _same_bits(got, _eager(coarse, rays, rcfg, fine))
        plain = VanillaNeRF(coarse.cfg, device="cpu", fused=False)
        plain.load_state_dict(coarse.state_dict())
        plain_f = VanillaNeRF(fine.cfg, device="cpu", fused=False)
        plain_f.load_state_dict(fine.state_dict())
        ref = _eager(plain, rays, rcfg, plain_f)
        tol = 1e-4 if dtype is None else 5e-2  # the twins' bf16 operands
        np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), atol=tol, rtol=0)

    def test_dnerf_and_tnerf(self):
        rcfg = RenderConfig(n_samples=8, n_importance=0, white_bkgd=True)
        rays = _port_rays(*_rays(16, with_t=True, seed=4))
        g = torch.Generator().manual_seed(1)
        dn = DirectTemporalNeRF(DNeRFConfig(netdepth=3, netwidth=128, skips=(1,), multires=4, multires_views=2),
                                device="cpu", generator=g, fused=True)
        tn = TNeRF(TNeRFConfig(netdepth=6, net_dim=128, skip_layer=4, multires=4, multires_views=2), device="cpu",
                   generator=g, fused=True)
        for field, ops in ((dn, {"swnerf.time_net.default": 1, "swnerf.trunk.default": 1}),
                           (tn, {"swnerf.trunk.default": 1})):
            assert export_model.export_fields(field, None, True, "cpu")[0] is not None  # a covered field
            art = load_renderer(export_renderer(field, _params(field), rcfg, 16))
            assert art.meta["with_times"] and kernel_ops(art.program("cpu")) == ops
            _same_bits(_call(art, _params(field), rays), _eager(field, rays, rcfg))

    def test_uncovered_field_refused(self):
        narrow = VanillaNeRF(VanillaNeRFConfig(**VANILLA), device="cpu", fused=False)  # W=16: no kernel
        with pytest.raises(ValueError, match=r"--export_fused: no kernel op covers the coarse field \(VanillaNeRF"):
            export_model.export_fields(narrow, None, True, "cpu")


# ---------------------------------------------------------------- the CLI


def _scene(tmp_path, dynamic):
    from swnerf_torch.data.synthetic import write_blender_scene

    data = tmp_path / "data"
    write_blender_scene(str(data), n_train=4, n_val=1, n_test=1, size=16, dynamic=dynamic, n_samples=16,
                        device="cpu")
    return data


def _common(data, logs, *extra):
    return ["--basedir", str(logs), "--datadir", str(data), "--dataset_type", "blender", "--white_bkgd",
            "--use_viewdirs", "--N_rand", "16", "--N_samples", "6", "--chunk", "64", "--testskip", "1",
            "--i_print", "4", "--i_video", "100000", "--i_testset", "100000", "--device", "cpu", *extra]


def _export(tmp_path, name, mode, base, *flags):
    out = tmp_path / name
    got = export_model.main(["--export_out", str(out), "--export_rays", "8", "--export_mode", mode, *flags] + base)
    return out, got


def _serve_check(path, state_fields, rcfg, with_t):
    art = load_renderer(Path(path).read_bytes())
    coarse, fine = state_fields
    rays = _port_rays(*_rays(8, with_t=with_t, seed=5)[: 3 if with_t else 2])
    got = _call(art, _params(coarse, fine), rays)
    assert got[0].shape == (8, 3) and torch.isfinite(got[0]).all()
    plain = [None if f is None else export_model.export_fields(f, None, False, "cpu")[0] for f in (coarse, fine)]
    _same_bits(got, _eager(plain[0], rays, rcfg, plain[1]))
    return art


class TestExportModelCLI:
    def test_nerf_mode(self, tmp_path, monkeypatch, capsys):
        from swnerf_torch.pipelines.run_nerf import create_vanilla, train
        from swnerf_torch.utils.config import config_parser

        data, logs = _scene(tmp_path, False), tmp_path / "logs"
        base = ["--expname", "tiny", "--dataset_type", "blender", "--netdepth", "2", "--netwidth", "32",
                "--netdepth_fine", "2", "--netwidth_fine", "32", "--multires", "4", "--multires_views", "2",
                "--N_importance", "4", "--i_weights", "10", "--precrop_iters", "0"] + _common(data, logs)
        monkeypatch.setenv("SWNERF_MAX_ITERS", "11")
        train(base)
        out, got = _export(tmp_path, "nerf.pt2", "nerf", base, "--export_platforms", "cpu,cuda")
        assert got == str(out) and "Exported nerf @ iter 10" in capsys.readouterr().out
        state, rcfg, _, _ = create_vanilla(config_parser().parse_args(base), torch.device("cpu"))
        assert state.step == 10
        art = _serve_check(out, (state.coarse, state.fine), rcfg, False)
        assert art.meta == {"platforms": ["cpu", "cuda"], "n_rays": 8, "with_times": False, "fused": False,
                            "ops": ["swnerf.sample_pdf.default"]}
        with pytest.raises(ValueError, match="no kernel op covers the coarse field"):  # W=32: no kernel
            _export(tmp_path, "nerf_fused.pt2", "nerf", base, "--export_fused")
        assert not (tmp_path / "nerf_fused.pt2").exists()

    @pytest.mark.parametrize("mode", ["dnerf", "tnerf"])
    def test_dynamic_modes(self, tmp_path, monkeypatch, mode):
        from swnerf_torch.pipelines import run_dnerf, run_tnerf
        from swnerf_torch.utils.config import config_parser_dnerf

        data, logs = _scene(tmp_path, True), tmp_path / "logs"
        base = ["--expname", "dyn", "--netdepth", "2", "--netwidth", "16", "--multires", "2", "--multires_views",
                "1", "--i_weights", "8", "--i_img", "100000", "--precrop_iters_time", "0", "--no_batching"]
        base += ["--nerf_type", "direct_temporal"] if mode == "dnerf" else []
        base += _common(data, logs)
        monkeypatch.setenv("SWNERF_MAX_ITERS", "9")
        (run_dnerf if mode == "dnerf" else run_tnerf).train(base)
        out, _ = _export(tmp_path, f"{mode}.pt2", mode, base)
        args = config_parser_dnerf().parse_args(base)
        if mode == "dnerf":
            state, rcfg = run_dnerf.create_dnerf(args, torch.device("cpu"))[:2]
        else:
            state, rcfg = run_tnerf.create_tnerf(args, torch.device("cpu"))[:2]
        assert state.step == 8
        art = _serve_check(out, (state.coarse, state.fine), rcfg, True)
        assert art.meta["with_times"]

    def test_multires_mode(self, tmp_path, monkeypatch, capsys):
        from swnerf_torch.pipelines import run_multires
        from swnerf_torch.pipelines.common import load_scene
        from swnerf_torch.utils.config import config_parser_dnerf

        data, logs = _scene(tmp_path, True), tmp_path / "logs"
        base = ["--expname", "mr", "--nerf_type", "direct_temporal", "--netdepth", "2", "--netwidth", "16",
                "--N_samples", "4", "--layer_num", "2", "--global_optimization_epoch", "1", "--i_weights", "4",
                "--i_img", "100000", "--no_batching"] + _common(data, logs)
        monkeypatch.setenv("SWNERF_PHASE1_ITERS", "1")
        monkeypatch.setenv("SWNERF_MAX_ITERS", "5")
        run_multires.train(base)
        out, paths = _export(tmp_path, "mr.pt2", "multires", base)
        assert paths == [f"{out}.L0", f"{out}.L1"]
        printed = capsys.readouterr().out
        assert "level frame 16x16" in printed and "level frame 8x8" in printed
        args = config_parser_dnerf().parse_args(base)
        kind, states, _hwf, rcfg, start = run_multires.create_multires(args, load_scene(args), torch.device("cpu"))
        assert start == 4
        for path, st in zip(paths, states):
            _serve_check(path, (st.coarse, st.fine), rcfg, True)


def test_artifact_loads_its_ops_in_a_fresh_process(tmp_path):
    """An artifact with a fine pass calls B2 as ``swnerf::sample_pdf``;
    ``load_renderer`` alone registers the ops its header names, so a fresh
    process that imports nothing else of the port serves it (B2's twin on
    the CPU), bit-equal to the eager render here."""
    field = VanillaNeRF(VanillaNeRFConfig(**VANILLA), device="cpu", fused=False,
                        generator=torch.Generator().manual_seed(2))
    rcfg = RenderConfig(n_samples=8, n_importance=8, white_bkgd=True)
    params = _params(field, field)
    (tmp_path / "r.pt2").write_bytes(export_renderer(field, params, rcfg, 8))
    rays = _port_rays(*_rays(8, seed=6)[:2])
    torch.save({"params": params, "rays": tuple(rays)[:5]}, tmp_path / "in.pt")
    code = f"""
import sys, torch
from swnerf_torch.utils.export import load_renderer
art = load_renderer(open({str(tmp_path / "r.pt2")!r}, "rb").read())
print(sorted(m for m in sys.modules if m.startswith("swnerf_torch.ops.kernels.")), art.meta["ops"])
x = torch.load({str(tmp_path / "in.pt")!r})
torch.save(art(x["params"], *x["rays"]), {str(tmp_path / "out.pt")!r})
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "'swnerf_torch.ops.kernels.sample_pdf'" in res.stdout and "['swnerf.sample_pdf.default']" in res.stdout
    _same_bits(torch.load(tmp_path / "out.pt"), _eager(field, rays, rcfg, field))


def test_new_modules_import_no_jax():
    """The slice's modules import neither jax nor swnerf_tpu."""
    code = """
import sys
import swnerf_torch.utils.export, swnerf_torch.pipelines.export_model, swnerf_torch.native
import swnerf_torch.native.searchsorted, swnerf_torch.experiments.pos2d, swnerf_torch.experiments.autorun
import swnerf_torch.utils.images, swnerf_torch.ops.kernels.trunk, swnerf_torch.ops.kernels.time_net
bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'swnerf_tpu'))
print(bad)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
