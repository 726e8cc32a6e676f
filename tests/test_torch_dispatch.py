"""K train steps per dispatch in swnerf_torch, against swnerf_tpu on the CPU:
``chunk_until_event`` and ``steps_per_dispatch`` against the JAX package's,
the K-step routes (``make_pool_scan_step``, ``make_image_scan_step``,
``make_dnerf_scan_step``) at K = 3 against the JAX package's scans on the
same weights and deterministic draws, the three trainer CLIs at
``SWNERF_STEPS_PER_DISPATCH=4`` against 1, and ``run_nerf``'s warm start
(``SWNERF_FUSED_DTYPE_SCHEDULE``).

On the CPU a route is a loop over its step; the CUDA-graph replays it runs
on a card are held bit-equal to uncaptured steps in tests/test_torch_cuda.py.

Bars: the K-step routes against the JAX scans, from a JAX state two Adam
steps in (bridged through a .tar) and three steps at the configs' learning
rate 5e-4: each parameter tensor within 1e-2 of JAX's relative to how far
JAX's moved in the three steps (L2; a step left out or repeated moves it by
about a third), and the last step's metrics rel 5e-5. Measured: parameters
within 3.3e-4 (the D-NeRF with TV, whose fp32 gradients flip ReLU ties, see
tests/test_torch_dnerf.py) and 2.9e-5 elsewhere; metrics within 6.2e-6.
Adam normalises each gradient entry by its running magnitude, so entries
near zero carry fp32 noise into the parameters at the learning rate's
scale: an absolute bar would measure that noise. The CLIs at K = 4 and
K = 1 bit-equal."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swnerf_torch.models import DirectTemporalNeRF, DNeRFConfig, TNeRF, TNeRFConfig, VanillaNeRF, VanillaNeRFConfig
from swnerf_torch.pipelines import run_dnerf, run_nerf, run_tnerf
from swnerf_torch.pipelines.common import (
    Scene,
    chunk_until_event,
    make_image_scan_step,
    make_image_step,
    make_pool_scan_step,
    make_time_image_step,
    steps_per_dispatch,
)
from swnerf_torch.pipelines.run_dnerf import make_dnerf_scan_step
from swnerf_torch.render.core import RenderConfig
from swnerf_torch.train.checkpoint import load_tar, params_from_jax, tnerf_state_dict, vanilla_state_dict
from swnerf_torch.train.loop import init_train_state, make_dnerf_train_step, make_train_step
from swnerf_tpu.data.synthetic import write_blender_scene
from swnerf_tpu.models import VanillaNeRFConfig as JaxVanillaConfig
from swnerf_tpu.models import make_vanilla_field
from swnerf_tpu.models.dnerf import DNeRFConfig as JaxDNeRFConfig
from swnerf_tpu.models.dnerf import make_dnerf_field
from swnerf_tpu.models.tnerf import TNeRFConfig as JaxTNeRFConfig
from swnerf_tpu.models.tnerf import init_tnerf_params, make_tnerf_field
from swnerf_tpu.models.vanilla import init_vanilla_params
from swnerf_tpu.pipelines import common as jax_common
from swnerf_tpu.pipelines.common import RayPoolSampler as JaxRayPoolSampler
from swnerf_tpu.pipelines.common import Scene as JaxScene
from swnerf_tpu.pipelines.run_dnerf import make_dnerf_scan_step as jax_make_dnerf_scan_step
from swnerf_tpu.render import RenderConfig as JaxRenderConfig
from swnerf_tpu.train import checkpoint as jck
from swnerf_tpu.train.loop import init_train_state as jax_init_train_state
from swnerf_tpu.train.loop import make_optimizer as jax_make_optimizer
from swnerf_tpu.train.loop import make_train_step as jax_make_train_step

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
VANILLA = dict(netdepth=3, netwidth=128, skips=(1,), multires=4, multires_views=2)
TNERF = dict(netdepth=4, net_dim=128, skip_layer=2, multires=4, multires_views=2)
DNERF = dict(netdepth=3, netwidth=128, skips=(1,), multires=4, multires_views=2)
K = 3
LRATE = 5e-4


# ---------------------------------------------------------------- chunking and K


@pytest.mark.parametrize("cadences", [(), (0,), (10, 0, 7), (5, 100000, 3, 0), (1,), (4, 6, None)],
                         ids=["none", "zero", "mixed", "nerf", "one", "none_entry"])
def test_chunk_until_event_matches_jax(cadences):
    """Every i in 1..40, n_iters in i+1..45 (every second) and k_max 1-25."""
    for i in range(1, 41):
        for n_iters in range(i + 1, 46, 2):
            for k_max in range(1, 26):
                assert chunk_until_event(i, n_iters, k_max, cadences) == jax_common.chunk_until_event(
                    i, n_iters, k_max, cadences), (i, n_iters, k_max)


def test_chunks_end_on_every_cadence_boundary():
    """Walking 1..n_iters-1 in chunks visits each multiple of every cadence
    as a chunk's last iteration, and no chunk passes k_max."""
    cadences, n_iters = (10, 7, 0, 25), 101
    i, ends = 1, []
    while i < n_iters:
        k = chunk_until_event(i, n_iters, 20, cadences)
        assert 1 <= k <= 20
        i += k
        ends.append(i - 1)
    assert ends[-1] == n_iters - 1
    for c in (10, 7, 25):
        assert set(range(c, n_iters, c)) <= set(ends)


@pytest.mark.parametrize("env,cpu,cuda", [(None, 1, 20), ("", 1, 20), ("4", 4, 4), ("1", 1, 1), ("0", 1, 1),
                                          ("-3", 1, 1), ("25", 25, 25)])
def test_steps_per_dispatch(monkeypatch, env, cpu, cuda):
    """20 on a card, 1 on the CPU; SWNERF_STEPS_PER_DISPATCH overrides both
    with the JAX package's parse, which on its CPU gives the same."""
    if env is None:
        monkeypatch.delenv("SWNERF_STEPS_PER_DISPATCH", raising=False)
    else:
        monkeypatch.setenv("SWNERF_STEPS_PER_DISPATCH", env)
    assert steps_per_dispatch("cpu") == cpu == jax_common.steps_per_dispatch()
    assert steps_per_dispatch(torch.device("cuda")) == cuda


def test_steps_per_dispatch_rejects_a_non_integer(monkeypatch):
    monkeypatch.setenv("SWNERF_STEPS_PER_DISPATCH", "x")
    with pytest.raises(ValueError):
        steps_per_dispatch("cpu")
    with pytest.raises(ValueError):
        jax_common.steps_per_dispatch()


# ---------------------------------------------------------------- the K-step routes against the JAX scans


def _scene(n=4, size=12, times=False):
    """The port's and the JAX package's Scene for the same random images and
    poses (cameras 4 units out, looking down -z through the origin)."""
    rng = np.random.default_rng(0)
    poses = np.stack([np.eye(4, dtype=np.float32) for _ in range(n)])
    poses[:, :3, 3] = rng.standard_normal((n, 3)) * 0.2 + np.array([0.0, 0.0, 4.0])
    images = rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)
    K_ = np.array([[10.0, 0, 0.5 * size], [0, 10.0, 0.5 * size], [0, 0, 1]])
    kw = dict(images=images, poses=poses, render_poses=poses, H=size, W=size, focal=10.0, K=K_, near=2.0, far=6.0,
              i_train=np.arange(n), i_val=np.arange(0), i_test=np.arange(0))
    t = np.linspace(0, 1, n).astype(np.float32) if times else None
    return Scene(**kw, times=t), JaxScene(**kw)


def _draws(n_img, size, seed, n_rand=24):
    rng = np.random.default_rng(seed)
    img_i_k = rng.integers(0, n_img, (K,)).astype(np.int64)
    pixels_k = rng.integers(0, size, (K, n_rand, 2)).astype(np.int64)
    neighbor_k = rng.uniform(0, 1, (K,)).astype(np.float32)
    return img_i_k, pixels_k, neighbor_k


def _bridge(js, kind, nets, models, tmp_path):
    """The JAX state's weights and Adam state through a .tar into the port's
    models and a TrainState at its count (run_*'s resume)."""
    path = str(tmp_path / "bridge.tar")
    payload = {"optimizer_state_dict": jck.adam_to_torch_dict(js.opt_state, js.params, [(kind, n) for n in nets],
                                                               LRATE)}
    for net, key in zip(nets, ("network_fn_state_dict", "network_fine_state_dict")):
        payload[key] = jck.params_to_state_dict(kind, js.params[net])
    jck.save_tar(path, payload)
    ckpt = load_tar(path)
    for model, key in zip(models, ("network_fn_state_dict", "network_fine_state_dict")):
        model.load_state_dict((vanilla_state_dict if kind == "vanilla" else tnerf_state_dict)(ckpt[key]))
    state = init_train_state(models[0], models[1] if len(models) > 1 else None, LRATE, 250, step=int(js.step))
    state.optimizer.load_state_dict(ckpt["optimizer_state_dict"])
    return state


def _snapshot(state):
    return [{k: v.clone() for k, v in m.state_dict().items()} for m in state.modules()]


def _assert_close(state, start, js, nets, m, jm):
    """Each parameter tensor within 1e-2 of JAX's, relative to how far JAX's
    moved in the chunk (L2), and the last step's metrics rel 5e-5 (the TV
    term against the total loss it enters)."""
    assert state.step == int(js.step)
    for model, before, net in zip(state.modules(), start, nets):
        ref = params_from_jax(jax.tree.map(np.asarray, js.params[net]))
        for k, v in model.state_dict().items():
            moved = float(torch.linalg.norm(ref[k] - before[k]))
            assert float(torch.linalg.norm(v - ref[k])) <= 1e-2 * moved, (net, k)
    assert set(m) == set(jm)
    for k in jm:
        assert abs(float(m[k]) - float(jm[k])) <= 5e-5 * abs(float(jm["total_loss" if k == "tv" else k])), k


def _rc(cls, n_importance=8):
    return cls(n_samples=8, n_importance=n_importance, perturb=0.0, white_bkgd=True, raw_noise_std=0.0)


def _vanilla_jax(n_importance):
    """The JAX step and a state two steps into training (the moments and
    the count populated), and the nets it trains."""
    cfg = JaxVanillaConfig(**VANILLA)
    nets = ("coarse", "fine") if n_importance else ("coarse",)
    params = {n: init_vanilla_params(jax.random.PRNGKey(s), cfg) for s, n in enumerate(nets)}
    params.setdefault("fine", None)
    opt = jax_make_optimizer(LRATE, 250)
    field = make_vanilla_field(cfg, fused=False)
    jstep = jax_make_train_step(field, _rc(JaxRenderConfig, n_importance), opt,
                                fine_field=field if n_importance else None)
    return jax_init_train_state(params, opt), jstep, nets


def _vanilla_models(nets):
    return [VanillaNeRF(VanillaNeRFConfig(**VANILLA), device="cpu") for _ in nets]


@pytest.mark.parametrize("n_importance", [8, 0], ids=["fine", "coarse_only"])
def test_pool_scan_step_matches_jax(n_importance, tmp_path):
    """Three pool steps in one call against make_pool_scan_step, from a JAX
    state two steps in, bridged through a .tar: the eager step,
    deterministic draws, the JAX pool and indices."""
    scene, jscene = _scene()
    js, jstep, nets = _vanilla_jax(n_importance)
    pool = JaxRayPoolSampler(jscene, 24).pool
    rng = np.random.default_rng(5)
    warm_k, idx_k = (rng.integers(0, pool.shape[0], (n, 24)).astype(np.int64) for n in (2, K))
    jscan = jax_common.make_pool_scan_step(jstep, _rc(JaxRenderConfig, n_importance), jscene)
    js, _ = jscan(js, pool, jnp.asarray(warm_k), jax.random.PRNGKey(0))
    state = _bridge(js, "vanilla", nets, _vanilla_models(nets), tmp_path)
    start = _snapshot(state)
    js, jm = jscan(js, pool, jnp.asarray(idx_k), jax.random.PRNGKey(0))
    m = make_pool_scan_step(make_train_step(_rc(RenderConfig, n_importance)), _rc(RenderConfig, n_importance), scene)(
        state, torch.from_numpy(np.array(pool)), idx_k)
    _assert_close(state, start, js, nets, m, jm)


def test_image_scan_step_matches_jax(tmp_path):
    """Three per-image steps in one call against make_image_scan_step, from a
    bridged JAX state two steps in; ``record`` sees each step."""
    scene, jscene = _scene()
    js, jstep, nets = _vanilla_jax(8)
    jscan = jax_common.make_image_scan_step(jstep, _rc(JaxRenderConfig), jscene)
    images, poses = jnp.asarray(scene.images), jnp.asarray(scene.poses[:, :3, :4])
    warm_i, warm_px, _ = _draws(4, 12, seed=2)
    js, _ = jscan(js, images, poses, jnp.asarray(warm_i[:2].astype(np.int32)), jnp.asarray(warm_px[:2]),
                  jax.random.PRNGKey(0))
    state = _bridge(js, "vanilla", nets, _vanilla_models(nets), tmp_path)
    start = _snapshot(state)
    img_i_k, pixels_k, _ = _draws(4, 12, seed=3)
    js, jm = jscan(js, images, poses, jnp.asarray(img_i_k.astype(np.int32)), jnp.asarray(pixels_k),
                   jax.random.PRNGKey(0))
    record = []
    m = make_image_scan_step(make_train_step(_rc(RenderConfig)), _rc(RenderConfig), scene)(
        state, torch.from_numpy(scene.images), torch.from_numpy(scene.poses[:, :3, :4]), img_i_k, pixels_k,
        None, record.append)
    assert record == list(range(K))
    _assert_close(state, start, js, nets, m, jm)


@pytest.mark.parametrize("kind", ["tnerf", "dnerf_tv"])
def test_dnerf_scan_step_matches_jax(kind, tmp_path):
    """Three time-conditioned steps in one call against make_dnerf_scan_step
    from a bridged JAX state two steps in: the T-NeRF (no neighbour time, as
    run_tnerf) and the D-NeRF with its TV term at the chunk's neighbour
    times."""
    scene, jscene = _scene(times=True)
    opt = jax_make_optimizer(LRATE, 250)
    if kind == "tnerf":
        jcfg = JaxTNeRFConfig(**TNERF)
        field, params = make_tnerf_field(jcfg, fused=False), init_tnerf_params(jax.random.PRNGKey(0), jcfg)
        model, jkind = TNeRF(TNeRFConfig(**TNERF), device="cpu"), "tnerf"
        rc = dict(n_samples=8, n_importance=0, perturb=0.0, white_bkgd=True, raw_noise_std=0.0)
        tv, port_step = False, make_train_step(RenderConfig(**rc))
    else:
        jcfg = JaxDNeRFConfig(**DNERF)
        field = make_dnerf_field(jcfg, fused=False)
        params = field.init(jax.random.PRNGKey(0))
        model, jkind = DirectTemporalNeRF(DNeRFConfig(**DNERF), device="cpu"), "direct_temporal"
        rc = dict(n_samples=8, n_importance=8, perturb=0.0, white_bkgd=True, raw_noise_std=0.0)
        tv, port_step = True, make_dnerf_train_step(RenderConfig(**rc), True, 1e-2)
    jscan = jax_make_dnerf_scan_step(field, JaxRenderConfig(**rc), opt, jscene, tv, 1e-2 if tv else 0.0)
    images, poses, times = jnp.asarray(scene.images), jnp.asarray(scene.poses), jnp.asarray(scene.times)

    def jrun(js, img_i_k, pixels_k, neighbor_k, n):
        return jscan(js, images, poses, times, jnp.asarray(img_i_k[:n].astype(np.int32)), jnp.asarray(pixels_k[:n]),
                     jnp.asarray(neighbor_k[:n] if tv else np.zeros(n, np.float32)), jax.random.PRNGKey(0))

    js, _ = jrun(jax_init_train_state({"coarse": params, "fine": None}, opt), *_draws(4, 12, seed=2), 2)
    state = _bridge(js, jkind, ("coarse",), [model], tmp_path)
    start = _snapshot(state)
    img_i_k, pixels_k, neighbor_k = _draws(4, 12, seed=3)
    js, jm = jrun(js, img_i_k, pixels_k, neighbor_k, K)
    m = make_dnerf_scan_step(port_step, RenderConfig(**rc), scene, pass_neighbor=tv)(
        state, torch.from_numpy(scene.images), torch.from_numpy(scene.poses[:, :3, :4]),
        torch.from_numpy(scene.times), img_i_k, pixels_k, neighbor_k)
    _assert_close(state, start, js, ("coarse",), m, jm)


# ---------------------------------------------------------------- the CLIs at K = 4 against K = 1


@pytest.fixture(scope="module")
def static_scene(tmp_path_factory):
    data = tmp_path_factory.mktemp("static") / "data"
    write_blender_scene(str(data), n_train=3, n_val=1, n_test=1, size=16)
    return data


@pytest.fixture(scope="module")
def dynamic_scene(tmp_path_factory):
    data = tmp_path_factory.mktemp("dynamic") / "data"
    write_blender_scene(str(data), n_train=4, n_val=1, n_test=1, size=16, dynamic=True)
    return data


def _vanilla_argv(data, logs, *extra):
    return ["--expname", "k", "--basedir", str(logs), "--datadir", str(data), "--dataset_type", "blender",
            "--white_bkgd", "--use_viewdirs", "--netdepth", "6", "--netwidth", "128", "--netdepth_fine", "6",
            "--netwidth_fine", "128", "--multires", "4", "--multires_views", "2", "--N_rand", "32",
            "--N_samples", "8", "--N_importance", "8", "--chunk", "128", "--i_weights", "10", "--i_print", "5",
            "--i_video", "100000", "--i_testset", "100000", "--precrop_iters", "0", "--lrate", "5e-3",
            "--testskip", "1", "--device", "cpu", *extra]


def _dynamic_argv(data, logs, *extra):
    return ["--expname", "k", "--basedir", str(logs), "--datadir", str(data), "--dataset_type", "blender",
            "--nerf_type", "direct_temporal", "--white_bkgd", "--use_viewdirs", "--netdepth", "6",
            "--netwidth", "128", "--multires", "4", "--multires_views", "2", "--N_rand", "16", "--N_samples", "8",
            "--chunk", "128", "--testskip", "1", "--i_weights", "10", "--i_print", "5", "--i_video", "100000",
            "--i_testset", "100000", "--raw_noise_std", "1", "--device", "cpu", *extra]


def _run(monkeypatch, main, argv, k):
    monkeypatch.setenv("SWNERF_STEPS_PER_DISPATCH", str(k))
    monkeypatch.setenv("SWNERF_MAX_ITERS", "13")
    return main(argv)


def _records(exp):
    """metrics.jsonl without its clock fields."""
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    return [{k: v for k, v in r.items() if k != "t" and not k.startswith("ray_") and k != "steps_per_sec"}
            for r in recs]


@pytest.mark.parametrize("trainer", ["nerf_pool", "nerf_image", "tnerf", "dnerf_tv"])
def test_cli_k4_equals_k1(trainer, static_scene, dynamic_scene, tmp_path, monkeypatch, capsys):
    """Each trainer for 12 steps (print 5, save 10) at four steps a dispatch
    and at one: the same 000010.tar bit for bit, metrics.jsonl's losses and
    PSNRs at 5 and 10, and the same last metrics."""
    if trainer.startswith("nerf"):
        main, extra = run_nerf.main, (["--no_batching"] if trainer == "nerf_image" else [])
        argv = lambda logs: _vanilla_argv(static_scene, logs, *extra)  # noqa: E731
    else:
        main = run_tnerf.main if trainer == "tnerf" else run_dnerf.main
        extra = ["--add_tv_loss", "--tv_loss_weight", "1e-2", "--N_importance", "8"] if trainer == "dnerf_tv" else []
        argv = lambda logs: _dynamic_argv(dynamic_scene, logs, *extra)  # noqa: E731
    res = {k: _run(monkeypatch, main, argv(tmp_path / f"k{k}"), k) for k in (4, 1)}
    capsys.readouterr()
    exps = {k: tmp_path / f"k{k}" / "k" for k in res}
    assert sorted(p.name for p in exps[4].glob("*.tar")) == sorted(p.name for p in exps[1].glob("*.tar")) == [
        "000010.tar"]
    a, b = load_tar(str(exps[4] / "000010.tar")), load_tar(str(exps[1] / "000010.tar"))
    assert a["global_step"] == b["global_step"] == 10
    for key in a:
        if key.startswith("network"):
            for name, v in a[key].items():
                assert torch.equal(v, b[key][name]), (key, name)
    for (pa, sa), (pb, sb) in zip(a["optimizer_state_dict"]["state"].items(), b["optimizer_state_dict"]["state"].items()):
        assert pa == pb and all(torch.equal(torch.as_tensor(sa[k]), torch.as_tensor(sb[k])) for k in sa)
    ra, rb = _records(exps[4]), _records(exps[1])
    assert ra == rb and [r["step"] for r in ra if "psnr" in r] == [5, 10]
    assert res[4]["metrics"] == res[1]["metrics"]


# ---------------------------------------------------------------- the warm start


@pytest.mark.parametrize("value", ["bf16@5", "f32@", "f32@x", "f32", "f32@-1"])
def test_warm_start_rejects_bad_values_as_jax(value, monkeypatch):
    """The JAX package's ValueError text (run_nerf.py:276-283 there), only
    where the kernel step is taken."""
    monkeypatch.setenv("SWNERF_FUSED_DTYPE_SCHEDULE", value)
    rcfg = RenderConfig(n_samples=8, n_importance=8)
    with pytest.raises(ValueError, match=f"^SWNERF_FUSED_DTYPE_SCHEDULE={value!r}: expected 'f32@<iters>'$"):
        run_nerf.warm_start(True, rcfg)
    assert run_nerf.warm_start(False, rcfg) == (0, None)


def test_warm_start_switches_at_its_iteration(static_scene, tmp_path, monkeypatch, capsys):
    """f32@6 at four steps a dispatch: iterations 1-6 run the eager step with
    fp32 field operands, 7-12 the kernel step, and no chunk mixes them."""
    calls = []

    def spy(make, kind):
        def factory(*args, **kw):
            step = make(*args, **kw)

            def run(state, *a, **k):
                calls.append((kind, state.step + 1, {m.compute_dtype for m in state.modules()}))
                return step(state, *a, **k)
            return run
        return factory

    monkeypatch.setattr(run_nerf, "make_train_step", spy(run_nerf.make_train_step, "eager"))
    monkeypatch.setattr(run_nerf, "make_fused_train_step", spy(run_nerf.make_fused_train_step, "kernel"))
    monkeypatch.setenv("SWNERF_FUSED_DTYPE_SCHEDULE", "f32@6")
    res = _run(monkeypatch, run_nerf.main, _vanilla_argv(static_scene, tmp_path, "--no_batching"), 4)
    out = capsys.readouterr().out
    assert "Precision warm-start: f32 autodiff step through iter 6, fused bf16 step after" in out
    assert [(kind, i) for kind, i, _ in calls] == [("eager", i) for i in range(1, 7)] + [
        ("kernel", i) for i in range(7, 13)]
    assert all(dtypes == {None} for _, _, dtypes in calls)  # the operand type is set inside the step only
    assert np.isfinite(list(res["metrics"].values())).all()


def test_warm_start_step_runs_fp32_field_operands():
    """The warm step sets the fields' operand type to fp32 while it renders
    and gives it back after."""
    seen = []

    class Spy(VanillaNeRF):
        def forward(self, *a, **k):
            seen.append(self.compute_dtype)
            return super().forward(*a, **k)

    cfg = VanillaNeRFConfig(**VANILLA)
    state = init_train_state(Spy(cfg, device="cpu"), None, 5e-3, 250)
    scene, _ = _scene()
    img_i_k, pixels_k, _ = _draws(4, 12, seed=3)
    rcfg = _rc(RenderConfig, 0)
    make_image_scan_step(make_train_step(rcfg, compute_dtype=torch.float32), rcfg, scene)(
        state, torch.from_numpy(scene.images), torch.from_numpy(scene.poses[:, :3, :4]), img_i_k, pixels_k)
    assert seen == [torch.float32] * K and state.coarse.compute_dtype is None


# ---------------------------------------------------------------- what a captured step needs of its parts


def test_step_wrappers_take_device_indices():
    """The step wrappers given the dispatch loop's inputs (img_i a 0-d
    tensor, pixels and the neighbour time tensors) hand the train step the
    rays, target and times they give for a Python int, host pixels and a
    float."""
    scene, _ = _scene(times=True)
    images, poses = torch.from_numpy(scene.images), torch.from_numpy(scene.poses[:, :3, :4])
    times = torch.from_numpy(scene.times)
    pixels = np.random.default_rng(1).integers(0, 12, (16, 2))
    got = []

    def grab(state, rays, target, *rest):
        got.append((rays, target, rest[:-1]))
        return {}

    rcfg = RenderConfig()
    for img_i, px, nt in ((2, pixels, 0.37), (torch.tensor(2), torch.from_numpy(pixels), torch.tensor(0.37))):
        make_image_step(grab, rcfg, scene)(None, images, poses, img_i, px)
        make_time_image_step(grab, rcfg, scene, pass_neighbor=True)(None, images, poses, times, img_i, px, nt)
    for a, b in ((got[0], got[2]), (got[1], got[3])):
        assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]) if x is not None) and torch.equal(a[1], b[1])
    assert float(got[1][2][0]) == pytest.approx(0.37) and float(got[3][2][0]) == pytest.approx(0.37)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_transmittance_gradient_is_torch_cumprods(dtype):
    """The composite's exclusive cumprod (no host test for zeros in its
    backward) gives torch.cumprod's values and gradients bit for bit on the
    transmittance factors, which are never zero."""
    from swnerf_torch.ops.volume import _CumprodNonzero

    g = torch.Generator().manual_seed(0)
    alpha = torch.rand((64, 33), generator=g, dtype=dtype)
    alpha[:, -5:] = 1.0  # saturated samples: factors of exactly 1e-10
    x = torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], -1)
    ct = torch.randn(x.shape, generator=g, dtype=dtype)
    a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    out_a, out_b = _CumprodNonzero.apply(a), torch.cumprod(b, -1)
    (out_a * ct).sum().backward()
    (out_b * ct).sum().backward()
    assert torch.equal(out_a, out_b) and torch.equal(a.grad, b.grad)


def test_card_checkpoint_loads_into_cpu_adam(tmp_path):
    """An optimizer state written by a card's trainer (fused, capturable, a
    tensor learning rate) loads into the CPU's Adam as torch's default: not
    fused, not capturable, and the next update follows the schedule."""
    cfg = VanillaNeRFConfig(**VANILLA)
    state = init_train_state(VanillaNeRF(cfg, device="cpu"), None, 5e-4, 250, graphs=True)
    for p in state.coarse.parameters():
        p.grad = torch.ones_like(p)
    state.apply_update()
    sd = state.optimizer.state_dict()
    for group in sd["param_groups"]:
        group["capturable"], group["fused"], group["lr"] = True, True, torch.tensor(1e-3)
    fresh = init_train_state(VanillaNeRF(cfg, device="cpu"), None, 5e-4, 250, step=1, graphs=True)
    fresh.optimizer.load_state_dict(sd)
    assert all(not group["capturable"] and not group["fused"] for group in fresh.optimizer.param_groups)
    for p in fresh.coarse.parameters():
        p.grad = torch.ones_like(p)
    fresh.apply_update()
    assert fresh.step == 2 and fresh.optimizer.param_groups[0]["lr"] == fresh.schedule(1)
    assert fresh.count is None and fresh.lr is None
