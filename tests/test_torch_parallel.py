"""Data parallelism over ranks (``swnerf_torch/parallel``) on the CPU.

Worlds of 2 gloo ranks are launched through a file store in ``tmp_path``
(``parallel/dryrun.py::launch``: no TCP port, a timeout on the group's
start-up and on the processes, survivors killed on a failure). One world
runs every 2-rank case of this file (:func:`two_rank_results`) and one
1-rank world the bit-equality cases; the ranks read their inputs from a file
the test writes and write their results back.

* ``host_shard_bounds``, ``is_primary``, ``initialize_from_env``, ``Rows``
  and ``batch_rows`` against the JAX package's and without a world; the
  package imports with ``jax`` blocked.
* Against the JAX package's steps sharded over 2 devices of the conftest
  mesh (perturb 0, noise 0, so neither side's random numbers enter; the
  JAX kernels in interpret mode at fp32): the vanilla kernel step under
  ``shard_map_train_step``, the D-NeRF kernel step with the TV term (a
  global sum), and MultiRes phase 2 through ``shard_cli_step`` (the
  reconstruction across the shards) on the field route and the fused one.
  Gradients before the optimizer and the metrics at the bars of the
  existing one-device parity tests (``tests/test_torch_dnerf.py``,
  ``tests/test_torch_multires.py``).
* The port against itself: a 2-rank step with jitter and noise on against
  one process on the global batch (fp32 loss rel 1e-6, parameters after 3
  Adam steps rtol 1e-5, atol 1e-6: ``tests/test_multihost.py``'s bar, as
  Adam's first steps normalise near-zero gradient entries), uneven splits (7 rays over 2 ranks), the ranks'
  parameters bit-identical, a 1-rank group bit-equal to no group.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from swnerf_torch.models import DirectTemporalNeRF, DNeRFConfig, VanillaNeRF, VanillaNeRFConfig
from swnerf_torch.parallel import (
    Rows,
    batch_rows,
    host_fold,
    host_shard_bounds,
    initialize_from_env,
    is_primary,
    make_mesh,
    process_count,
)
from swnerf_torch.parallel.dryrun import launch
from swnerf_torch.render.core import Rays, RenderConfig
from swnerf_torch.train.fused_step import make_fused_dnerf_step, make_fused_train_step
from swnerf_torch.train.loop import init_train_state, make_dnerf_train_step, make_train_step

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(netdepth=3, netwidth=128, skips=(1,), multires=4, multires_views=2)  # the B1 parity tests' widths
TIMEOUT = 300


# ---------------------------------------------------------------- launching worlds


def run_world(tmp_path, world, payload):
    """Run :func:`_child` on ``payload`` in ``world`` gloo ranks; returns
    each rank's results."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    torch.save(payload, tmp_path / "in.pt")
    code = f"from tests.test_torch_parallel import _child; _child({str(tmp_path)!r})"
    launch([sys.executable, "-c", code], world, str(tmp_path), timeout=TIMEOUT, threads=2, cwd=str(REPO))
    return [torch.load(tmp_path / f"out{r}.pt", weights_only=False) for r in range(world)]


def _child(path):
    """A rank: join the world, run every case of the payload with the
    world's group (and, where a case asks, with none), write the results."""
    torch.set_num_threads(2)
    assert initialize_from_env("cpu")
    group = make_mesh()
    payload = torch.load(os.path.join(path, "in.pt"), weights_only=False)
    out = {"policy": _policy(), "resumed_apart": _resumed_apart(group)}
    for name, case in payload.items():
        runner = _run_phase2 if case["kind"] == "phase2" else _run_step
        out[name] = runner(case, group)
        if case.get("also_alone"):
            out[name + "/alone"] = runner(case, None)
    torch.save(out, os.path.join(path, f"out{group.rank}.pt"))


def _policy():
    """``data_parallel_mesh`` in a world: what it refuses (a cap below the
    world, fewer rays than ranks) and its opt-out, as messages or results."""
    from swnerf_torch.parallel import data_parallel_mesh

    out = {}
    for name, env, batch in (("capped", {"SWNERF_MESH_DEVICES": "1"}, 64), ("few_rays", {}, 1),
                             ("opt_out", {"SWNERF_DATA_PARALLEL": "0"}, 64), ("group", {}, 64)):
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            g = data_parallel_mesh(batch, quiet=True)
            out[name] = None if g is None else (g.rank, g.world, g.backend)
        except ValueError as e:
            out[name] = str(e)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
    return out


def _resumed_apart(group):
    """``replicate`` where rank 1 resumed at another update count than rank
    0: the message it raises there (None on rank 0, which goes on to the
    broadcast of the values; rank 1 then joins that broadcast)."""
    from swnerf_torch.parallel import replicate

    torch.manual_seed(0)
    st = init_train_state(VanillaNeRF(VanillaNeRFConfig(**SMALL), device="cpu"), None, 5e-4, 250)
    st.step = 3 if group.rank == 0 else 0
    try:
        replicate(group, st)
        return None
    except RuntimeError as e:
        group.broadcast_(torch.cat([p.detach().reshape(-1) for p in st.coarse.parameters()]))
        return str(e)


# ---------------------------------------------------------------- the cases (run in the ranks and here)


def _model(case, key, dtype):
    if case.get(key) is None:
        return None
    if case["arch"] == "vanilla":
        model = VanillaNeRF(VanillaNeRFConfig(**case["kw"]), device="cpu")
    else:
        model = DirectTemporalNeRF(DNeRFConfig(**case["kw"]), device="cpu", fused=False)
    model.load_state_dict(case[key])
    return model.to(dtype)


def _grads(modules):
    return {f"{n}.{k}": p.grad.detach().clone().numpy() for n, m in modules for k, p in m.named_parameters()
            if p.grad is not None}


def _params(modules):
    return {f"{n}.{k}": p.detach().clone().numpy() for n, m in modules for k, p in m.named_parameters()}


def _run_step(case, group):
    """``case["steps"]`` train steps of a vanilla or D-NeRF step (kernel
    step on the twins, or eager) given the global batch, of which a step
    with a group trains on this rank's rows; the
    gradients of the first step, every step's metrics, the last parameters."""
    dtype = getattr(torch, case["dtype"])
    state = init_train_state(_model(case, "coarse", dtype), _model(case, "fine", dtype), 5e-4, 250)
    rcfg = RenderConfig(**case["rc"])
    fcfg = state.fine.cfg if state.fine is not None else None
    if case["arch"] == "vanilla":
        cfg = VanillaNeRFConfig(**case["kw"])
        step = (make_fused_train_step(cfg, rcfg, fcfg=fcfg, compute_dtype=dtype, group=group) if case["fused"]
                else make_train_step(rcfg, group=group))
        extra = ()
    else:
        cfg = DNeRFConfig(**case["kw"])
        step = (make_fused_dnerf_step(cfg, rcfg, fcfg=fcfg, add_tv_loss=case["tv"], tv_loss_weight=1e-2,
                                      compute_dtype=dtype, group=group) if case["fused"]
                else make_dnerf_train_step(rcfg, case["tv"], 1e-2, group=group))
        extra = (case["neighbor_time"],)
    n = case["o"].shape[0]

    def t(x):
        return None if x is None else torch.from_numpy(x).to(dtype)

    rays = Rays(t(case["o"]), t(case["d"]), t(case["d"].copy()), t(np.full(n, 2.0, np.float32)),
                t(np.full(n, 6.0, np.float32)), t(case.get("times")))
    gen = torch.Generator().manual_seed(case.get("seed", 0))
    modules = [(n_, m) for n_, m in (("coarse", state.coarse), ("fine", state.fine)) if m is not None]
    out = {"metrics": []}
    for s in range(case.get("steps", 1)):
        m = step(state, rays, t(case["target"]), *extra, gen)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if s == 0:
            out["grads"] = _grads(modules)
    out["params"] = _params(modules)
    return out


def _run_phase2(case, group):
    """One MultiRes phase-2 step on the levels of ``case``."""
    from swnerf_torch.pipelines import run_multires as mr

    dtype = getattr(torch, case["dtype"])
    states = []
    for kw, sd in zip(case["kws"], case["levels"]):
        model = DirectTemporalNeRF(DNeRFConfig(**kw), device="cpu", fused=False)
        model.load_state_dict(sd)
        states.append(init_train_state(model.to(dtype), None, 5e-4, 250))
    step = mr.make_phase2_step(RenderConfig(**case["rc"]), case["pyr_hwf"], case["patch_sizes"], case["near"],
                               case["far"], fused=case["fused"], compute_dtype=dtype, group=group)
    cast = lambda x: torch.from_numpy(np.array(x)).to(dtype)  # noqa: E731
    m = step(states, [torch.from_numpy(p) for p in case["pixels"]], [cast(x) for x in case["targets"]],
             cast(case["target_full"]), cast(case["pose"]), case["t"], 1.0, torch.Generator().manual_seed(0))
    return {"metrics": [{k: float(v) for k, v in m.items()}],
            "grads": [_grads([("coarse", st.coarse)]) for st in states],
            "params": [_params([("coarse", st.coarse)]) for st in states]}


# ---------------------------------------------------------------- inputs


def _np_rays(n, seed=0, times=False):
    """Rays through the origin region (tests/test_fused_step.py's), random
    targets; with ``times`` a quarter of them at t = 0."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = 4.0
    out = {"o": o, "d": d, "target": rng.uniform(0, 1, (n, 3)).astype(np.float32)}
    if times:
        t = rng.uniform(0.0, 1.0, (n, 1)).astype(np.float32)
        t[: n // 4] = 0.0
        out["times"] = t
    return out


def _torch_sd(params, arch):
    """A port state dict of freshly initialised fields from a seed."""
    torch.manual_seed(params)
    if arch == "vanilla":
        return VanillaNeRF(VanillaNeRFConfig(**SMALL, output_ch=5), device="cpu").state_dict()
    return DirectTemporalNeRF(DNeRFConfig(**SMALL, output_ch=5), device="cpu", fused=False).state_dict()


SELF_CASES = ["vanilla_fused", "vanilla_fused_uneven", "vanilla_eager_uneven", "dnerf_fused_tv", "dnerf_eager_tv_uneven"]


def _self_cases():
    """The port-against-itself cases: jitter and noise on."""
    rc = dict(n_samples=8, n_importance=8, perturb=1.0, white_bkgd=True, raw_noise_std=0.7)
    vkw = dict(SMALL, output_ch=5)
    dkw = dict(SMALL, output_ch=5)
    v = dict(arch="vanilla", kw=vkw, coarse=_torch_sd(0, "vanilla"), fine=_torch_sd(1, "vanilla"), rc=rc,
             dtype="float32", steps=3, seed=7)
    dn = dict(arch="dnerf", kw=dkw, coarse=_torch_sd(2, "dnerf"), fine=None, rc=dict(rc, coarse_contributes=False),
              dtype="float32", steps=3, seed=7, tv=True, neighbor_time=0.37)
    return {
        "vanilla_fused": dict(v, kind="step", fused=True, **_np_rays(32)),
        "vanilla_fused_uneven": dict(v, kind="step", fused=True, **_np_rays(7, seed=1)),
        "vanilla_eager_uneven": dict(v, kind="step", fused=False, **_np_rays(7, seed=2)),
        "dnerf_fused_tv": dict(dn, kind="step", fused=True, **_np_rays(16, seed=3, times=True)),
        "dnerf_eager_tv_uneven": dict(dn, kind="step", fused=False, **_np_rays(7, seed=4, times=True)),
    }


# ---------------------------------------------------------------- JAX's sharded steps (parent side)


def _mesh2():
    import jax

    from swnerf_tpu.parallel.mesh import make_mesh as jax_make_mesh

    return jax_make_mesh(jax.devices()[:2])


def _jax_vanilla_case():
    """Two nets, hierarchical, deterministic: the case and JAX's sharded
    step's (stashed) gradients and metrics."""
    import jax
    import jax.numpy as jnp

    from swnerf_torch.train.checkpoint import params_from_jax
    from swnerf_tpu.models import VanillaNeRFConfig as JaxConfig
    from swnerf_tpu.parallel.mesh import RAYS_AXIS, shard_map_train_step
    from swnerf_tpu.render import RenderConfig as JaxRenderConfig
    from swnerf_tpu.train.fused_step import make_fused_train_step as jax_step
    from swnerf_tpu.train.loop import init_train_state as jax_init
    from tests.test_torch_train import _grad_stash, _jax_params, _rays

    rc = dict(n_samples=4, n_importance=4, perturb=0.0, white_bkgd=True, raw_noise_std=0.0)
    jcfg = JaxConfig(**SMALL)
    jrays, rays, target = _rays(32)
    pc, pf = _jax_params(0), _jax_params(1)
    stash = _grad_stash()
    step = shard_map_train_step(jax_step(jcfg, JaxRenderConfig(**rc), stash, fcfg=jcfg, interpret=True,
                                         compute_dtype=jnp.float32, axis_name=RAYS_AXIS), _mesh2())
    s, m_ref = jax.jit(step)(jax_init({"coarse": pc, "fine": pf}, stash), jrays, jnp.asarray(target),
                             jax.random.PRNGKey(0))
    ref = {f"{net}.{k}": v.numpy() for net in ("coarse", "fine")
           for k, v in params_from_jax(jax.tree.map(np.asarray, s.opt_state[net])).items()}
    case = dict(kind="step", arch="vanilla", kw=dict(SMALL, output_ch=5), fused=True, rc=rc, dtype="float32",
                coarse=params_from_jax(pc), fine=params_from_jax(pf), o=rays.origins.numpy(),
                d=rays.directions.numpy(), target=target)
    return case, ref, {k: float(v) for k, v in m_ref.items()}


def _jax_dnerf_case():
    """The shared D-NeRF model with the TV term, deterministic, under
    ``shard_map`` (the neighbour time replicated)."""
    import jax
    import jax.numpy as jnp

    from swnerf_torch.train.checkpoint import params_from_jax
    from swnerf_tpu.models.dnerf import DNeRFConfig as JaxConfig
    from swnerf_tpu.parallel.mesh import RAYS_AXIS, shard_map_train_step
    from swnerf_tpu.train.fused_step import make_fused_dnerf_step as jax_step
    from swnerf_tpu.render import RenderConfig as JaxRenderConfig
    from swnerf_tpu.train.loop import init_train_state as jax_init
    from tests.test_torch_dnerf import _grad_stash, _jax_grads, _jax_params, _rays

    rc = dict(n_samples=4, n_importance=4, perturb=0.0, white_bkgd=True, raw_noise_std=0.0, coarse_contributes=False)
    jrc, kw = JaxRenderConfig(**rc), dict(SMALL, zero_canonical=True)
    jcfg = JaxConfig(**kw)
    _, pc = _jax_params(kw, 0)
    stash = _grad_stash()
    jrays, rays, target = _rays(32)
    step = shard_map_train_step(jax_step(jcfg, jrc, stash, add_tv_loss=True, tv_loss_weight=1e-2, interpret=True,
                                         compute_dtype=jnp.float32, axis_name=RAYS_AXIS), _mesh2(), n_extra_rep=1)
    s, m_ref = jax.jit(step)(jax_init(jax.tree.map(jnp.asarray, {"coarse": pc, "fine": None}), stash), jrays,
                             jnp.asarray(target), jnp.float32(0.37), jax.random.PRNGKey(0))
    case = dict(kind="step", arch="dnerf", kw=kw, fused=True, rc=rc, tv=True, neighbor_time=0.37,
                coarse=params_from_jax(pc), fine=None, o=rays.origins.numpy(), d=rays.directions.numpy(),
                times=rays.times.numpy(), target=target)
    return case, _jax_grads(s.opt_state), {k: float(v) for k, v in m_ref.items()}


def _jax_phase2_case():
    """Three levels (level 1 and 2's widths, the identity; 8/4/2-pixel
    patches), deterministic, through JAX's ``make_phase2_step(mesh=...)``:
    ``shard_cli_step`` shards every level's pixels over 2 devices."""
    import jax
    import jax.numpy as jnp

    from swnerf_torch.train.checkpoint import params_from_jax
    from swnerf_tpu.models.dnerf import DNeRFConfig as JaxConfig
    from swnerf_tpu.models.dnerf import make_dnerf_field
    from swnerf_tpu.ops import pyramid as jp
    from swnerf_tpu.pipelines import run_multires as jmr
    from swnerf_tpu.render import RenderConfig as JaxRenderConfig
    from tests.test_torch_multires import LEVELS, _grad_stash, _small_deformation, _tiny_scene

    kws = [LEVELS[1], LEVELS[2], LEVELS[3]]
    rc = dict(n_samples=8, n_importance=0, perturb=0.0, white_bkgd=True)
    _, _, images, poses, times = _tiny_scene()
    pyr_hwf = [[16 // 2**l, 16 // 2**l, 20.0 / 2**l] for l in range(3)]
    patch_sizes = [8, 4, 2]
    coords = [(4, 4), (2, 2), (1, 1)]
    fields = [make_dnerf_field(JaxConfig(**kw), fused=False) for kw in kws]
    params = [_small_deformation(jax.tree.map(np.asarray, f.init(jax.random.PRNGKey(11 + l))))
              for l, f in enumerate(fields)]
    lap = [np.asarray(b) for b in jp.generate_laplacian_pyramid(jnp.asarray(images), levels=3)]
    pixels = [np.stack(np.meshgrid(np.arange(y, y + ps), np.arange(x, x + ps), indexing="ij"), -1).reshape(-1, 2)
              for (y, x), ps in zip(coords, patch_sizes)]
    targets = [lap[l][2, y : y + ps, x : x + ps] for l, ((y, x), ps) in enumerate(zip(coords, patch_sizes))]
    stash = _grad_stash()
    jstep = jmr.make_phase2_step(None, fields, [stash] * 3, JaxRenderConfig(**rc), pyr_hwf, patch_sizes, 2.0, 6.0,
                                 mesh=_mesh2(), fused=False)
    jparams = [{"coarse": jax.tree.map(jnp.asarray, p), "fine": None} for p in params]
    _, jstates, m_ref = jstep(jparams, [stash.init(p) for p in jparams], [jnp.asarray(p) for p in pixels],
                              [jnp.asarray(t) for t in targets], jnp.asarray(images[2, 4:12, 4:12]),
                              jnp.asarray(poses[2, :3, :4]), jnp.float32(times[2]), jnp.float32(1.0),
                              jax.random.PRNGKey(5))
    refs = [{f"coarse.{k}": v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, s["coarse"])).items()}
            for s in jstates]
    case = dict(kind="phase2", kws=kws, levels=[params_from_jax(p) for p in params], rc=rc, pyr_hwf=pyr_hwf,
                patch_sizes=patch_sizes, near=2.0, far=6.0, pixels=pixels, targets=targets,
                target_full=images[2, 4:12, 4:12], pose=poses[2, :3, :4], t=float(times[2]))
    return case, refs, {k: float(v) for k, v in m_ref.items()}


# ---------------------------------------------------------------- the 2-rank world


@pytest.fixture(scope="module")
def two_rank_results(tmp_path_factory):
    """One 2-rank world over every case: the JAX references (computed
    here) with their cases in fp32 and float64, and the self cases. Returns
    (per-rank results, references, cases)."""
    cases, refs = _self_cases(), {}
    for name, make in (("vanilla", _jax_vanilla_case), ("dnerf", _jax_dnerf_case), ("phase2", _jax_phase2_case)):
        case, grads, metrics = make()
        refs[name] = (grads, metrics)
        for dtype in ("float32", "float64"):
            if name == "phase2":
                for fused in (False, True):
                    cases[f"jax/{name}/{dtype}/{'fused' if fused else 'fields'}"] = dict(case, dtype=dtype,
                                                                                       fused=fused)
            else:
                cases[f"jax/{name}/{dtype}"] = dict(case, dtype=dtype)
    results = run_world(tmp_path_factory.mktemp("world2"), 2, cases)
    return results, refs, cases


def _check_grads(g32, g64, ref):
    """tests/test_torch_multires.py::_check_grads: each tensor within 1e-4 *
    max|g| + 1e-7 of JAX's from the fp32 or the float64 port, or the fp32
    port no further from the float64 one than twice JAX is."""
    assert set(g32) == set(g64) == set(ref)
    for k, r in ref.items():
        bar = 1e-4 * np.abs(r).max() + 1e-7
        d32, d64 = np.abs(g32[k] - r).max(), np.abs(g64[k] - r).max()
        assert min(d32, d64) <= bar or np.abs(g32[k] - g64[k]).max() <= 2 * np.abs(r - g64[k]).max(), (k, d32, bar)


def _check_metrics(ms, m_ref, keys):
    """Rel 1e-5 from the fp32 or the float64 port (the TV term against the
    total loss it enters)."""
    for k in keys:
        scale = float(m_ref["total_loss" if k == "tv" else k])
        assert any(abs(m[k] - m_ref[k]) <= 1e-5 * scale for m in ms), (k, [m[k] for m in ms], m_ref[k])


@pytest.mark.parametrize("name", ["vanilla", "dnerf"])
def test_two_ranks_match_the_jax_sharded_step(two_rank_results, name):
    """The vanilla kernel step (B1, B2) and the D-NeRF kernel step with TV
    (B6, B3's pts mode, B5, B2) over 2 ranks against the JAX kernel steps
    under ``shard_map_train_step`` over 2 devices (``pmean``; the D-NeRF
    TV term pre-scaled by the axis size there, summed here): the summed
    gradients before Adam and the metrics."""
    results, refs, _ = two_rank_results
    grads, m_ref = refs[name]
    for rank in (0, 1):
        r32, r64 = results[rank][f"jax/{name}/float32"], results[rank][f"jax/{name}/float64"]
        _check_grads(r32["grads"], r64["grads"], grads)
        _check_metrics([r32["metrics"][0], r64["metrics"][0]], m_ref, list(m_ref))


@pytest.mark.parametrize("route", ["fields", "fused"])
def test_two_rank_phase2_matches_jax_shard_cli_step(two_rank_results, route):
    """MultiRes phase 2 over 2 ranks, each level's patch split by rows and
    the patches assembled for the reconstruction, on the field route and
    the fused one (B6, B3's pts mode, B9 twins), against JAX's phase 2
    with every level's pixels sharded over 2 devices (``shard_cli_step``;
    GSPMD spans the reconstruction): every level's gradients and the
    metrics."""
    results, refs, _ = two_rank_results
    grads, m_ref = refs["phase2"]
    for rank in (0, 1):
        r32, r64 = (results[rank][f"jax/phase2/{d}/{route}"] for d in ("float32", "float64"))
        for l in range(3):
            _check_grads(r32["grads"][l], r64["grads"][l], grads[l])
        _check_metrics([r32["metrics"][0], r64["metrics"][0]], m_ref,
                       ("loss_layer_0", "loss_layer_1", "loss_layer_2", "global_loss", "total_loss"))


@pytest.mark.parametrize("name", SELF_CASES)
def test_two_ranks_match_one_process(two_rank_results, name):
    """Jitter and noise on: every rank draws the global batch's numbers
    from one seeded generator and keeps its rows, so a 2-rank run is the
    1-process run on the global batch up to summation order: every step's
    loss rel 1e-6 (fp32), the parameters after 3 steps (Adam) rtol 1e-5,
    atol 1e-6 (one entry in 16,384 measured 5.3e-7 apart: a near-zero
    gradient entry that Adam normalises);
    the ranks' parameters bit-identical. The uneven cases split 7 rays 4 +
    3 (the global scale makes them exact too)."""
    results, _, cases = two_rank_results
    alone = _run_step(cases[name], None)
    r0, r1 = results[0][name], results[1][name]
    for k in r0["params"]:
        assert np.array_equal(r0["params"][k], r1["params"][k]), k
    assert r0["metrics"] == r1["metrics"]
    for m, m1 in zip(r0["metrics"], alone["metrics"]):
        assert m.keys() == m1.keys()
        for k in ("loss", "total_loss"):
            assert m[k] == pytest.approx(m1[k], rel=1e-6), k
    for k, p in alone["params"].items():
        np.testing.assert_allclose(r0["params"][k], p, rtol=1e-5, atol=1e-6, err_msg=k)


def test_two_rank_mesh_policy(two_rank_results):
    """In a world of 2: a group over both ranks on gloo; a
    SWNERF_MESH_DEVICES cap below the world and an N_rand below it refuse,
    naming both numbers; SWNERF_DATA_PARALLEL=0 gives no group."""
    results = two_rank_results[0]
    for rank in (0, 1):
        pol = results[rank]["policy"]
        assert pol["group"] == (rank, 2, "gloo")
        assert pol["opt_out"] is None
        assert "SWNERF_MESH_DEVICES=1" in pol["capped"] and "2 processes" in pol["capped"]
        assert "N_rand=1" in pol["few_rays"] and "2 ranks" in pol["few_rays"]


def test_replicate_refuses_ranks_that_resumed_apart(two_rank_results):
    """A rank whose state is not laid out as rank 0's (here: another update
    count, as when it found no checkpoint to resume) raises, naming both,
    before the broadcast; rank 0's layout is its own."""
    results = two_rank_results[0]
    assert results[0]["resumed_apart"] is None
    msg = results[1]["resumed_apart"]
    assert "rank 1 resumed" in msg and "rank 0 resumed" in msg and "rank 0's checkpoint" in msg


def test_gloo_on_a_card_refuses_k_steps():
    """A gloo group on a card cannot capture its collective: K > 1 refuses
    and names the setting; K = 1, NCCL and the CPU pass."""
    from swnerf_torch.parallel import RaysGroup, check_dispatch

    with pytest.raises(ValueError, match="SWNERF_STEPS_PER_DISPATCH=20"):
        check_dispatch(RaysGroup(0, 2, "gloo"), "cuda", 20)
    for group, device, k in ((RaysGroup(0, 2, "gloo"), "cuda", 1), (RaysGroup(0, 2, "nccl"), "cuda", 20),
                             (RaysGroup(0, 2, "gloo"), "cpu", 20), (None, "cuda", 20)):
        check_dispatch(group, device, k)


# ---------------------------------------------------------------- one rank


def test_one_rank_group_is_bit_equal_to_no_group(tmp_path):
    """A world of one rank: the kernel steps and the eager steps with the
    group (the reducer's one all-reduce, the global scale, the draws' rows)
    give the same bits as without one: metrics, gradients and parameters
    after 3 steps."""
    cases = {k: dict(v, also_alone=True) for k, v in _self_cases().items() if "uneven" not in k}
    cases["vanilla_eager"] = dict(cases["vanilla_fused"], fused=False)
    (res,) = run_world(tmp_path, 1, cases)
    for name in cases:
        a, b = res[name], res[name + "/alone"]
        assert a["metrics"] == b["metrics"], name
        for part in ("grads", "params"):
            assert a[part].keys() == b[part].keys()
            for k in a[part]:
                assert np.array_equal(a[part][k], b[part][k]), (name, part, k)


# ---------------------------------------------------------------- helpers without a world


@pytest.mark.parametrize("count", [1, 2, 3, 8])
@pytest.mark.parametrize("n", [1, 7, 8, 100, 1003])
def test_host_shard_bounds_match_jax(n, count):
    """Every rank's rows, and together they tile [0, n)."""
    from swnerf_tpu.parallel.multihost import host_shard_bounds as jax_bounds

    bounds = [host_shard_bounds(n, i, count) for i in range(count)]
    assert bounds == [jax_bounds(n, i, count) for i in range(count)]
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))


def test_no_world_means_no_op(monkeypatch):
    """With nothing set, nothing starts: no group, rank 0 of 1, primary,
    the whole range, the unfolded seed, a step's whole batch."""
    for k in ("SWNERF_COORDINATOR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    from swnerf_torch.parallel import data_parallel_mesh

    assert initialize_from_env("cpu") is False
    assert not torch.distributed.is_initialized()
    assert is_primary() and process_count() == 1
    assert host_shard_bounds(13) == (0, 13)
    assert host_fold(5) == 5 and host_fold(5, 1) != 5 and host_fold(5, 1) != host_fold(5, 2)
    assert data_parallel_mesh(1024) is None
    assert batch_rows(None, 13) == Rows(0, 13, 13)


def test_rows_of_a_batch():
    """A rank's rows (``batch_rows``): ``Rows.take`` cuts an array,
    ``Rows.take_fields`` every field of a ``Rays`` (None passes), which is
    how a step with a group takes its rows of the global batch."""
    from swnerf_torch.parallel import RaysGroup

    rows = batch_rows(RaysGroup(1, 2, "gloo"), 7)
    assert rows == Rows(4, 7, 7) and rows.n == 3
    x = np.arange(14).reshape(7, 2)
    assert np.array_equal(rows.take(x), x[4:])
    rays = Rays(*(torch.arange(7.0)[:, None] * (k + 1) for k in range(5)), None)
    got = rows.take_fields(rays)
    assert isinstance(got, Rays) and got.times is None
    assert all(torch.equal(a, b[4:]) for a, b in zip(got[:5], rays[:5]))


def test_parallel_imports_without_jax():
    """``swnerf_torch.parallel`` (and the trainers it serves) import with
    ``jax`` and the JAX package blocked."""
    code = ("import sys; sys.modules['jax'] = None; sys.modules['swnerf_tpu'] = None\n"
            "import swnerf_torch.parallel, swnerf_torch.parallel.dryrun, swnerf_torch.pipelines.run_multires\n"
            "assert not any(m.split('.')[0] in ('jax', 'swnerf_tpu') for m in sys.modules if sys.modules[m])\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(REPO), timeout=120)
