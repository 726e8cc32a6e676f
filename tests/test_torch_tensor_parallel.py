"""Tensor parallelism (``swnerf_torch/parallel/tensor.py``) on the CPU.

* The assignment: every layer's column / row / replicated against the JAX
  package's ``mlp_param_specs`` (layer by layer, by checkpoint name) for a
  vanilla field, a T-NeRF, a D-NeRF and the MultiRes levels 0 and 3 (the
  identity encoding), at k = 2 and 4 and widths 32 (the views stack
  degrades), 33 (everything degrades) and 512 (every trunk layer cut at
  k = 2).
* Refusals without a world, and the package importing with ``jax`` and
  the JAX package blocked.
* One 2-rank world (model 2) and one 4-rank world (rays 2 x model 2) of gloo
  ranks (``parallel/dryrun.py::launch``, 1 thread a rank) run every world
  case: the refusals of the policy (a world below
  k, one that k does not divide, a ``SWNERF_MESH_DEVICES`` cap, a batch
  below the rays axis); one vanilla and one D-NeRF eager step (TV on,
  perturb 0, noise 0, D=8, W=64, skip 4) in fp32 and float64 against the
  JAX package's autodiff step on a state sharded by its
  ``tensor_parallel_setup`` over the conftest's 8 CPU devices, at the bars
  of ``tests/test_torch_parallel.py``'s parity cases (each gradient tensor,
  gathered, within 1e-4 max|g| + 1e-7 of JAX's from the fp32 or the float64
  port, or the fp32 port no further from the float64 one than twice JAX
  is; the metrics rel 1e-5); 3 Adam steps with jitter and noise on against
  one port process (rtol 1e-5, atol 1e-6, the bar of
  ``tests/test_multihost.py``); the replicated parameters bit-identical
  across the model ranks; the shards' shapes, their moments' and the bytes
  a rank holds; MultiRes's joint phase-2 step (four levels at the
  config's encodings, D=8, W=32, the global term on): in float64 every
  level's gathered gradient within rel L2 1e-9 of one process's; in fp32,
  where level 0's 2^19-frequency encoding carries any change of summation
  order into its gradients at ~1e-1, every level's gradients within rel L2
  1e-5 of one process that sums each cut layer's products as the grid
  does (``chip_smoke.grid_sums``, phase 45's control), so a wrong
  gradient of any level fails in either dtype; and the test frame
  every level renders from the gathered fields over the world equal
  (``torch.equal``) to one process's from the same weights.
"""

import concurrent.futures
import contextlib
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import grid_sums
from swnerf_torch.models import DirectTemporalNeRF, DNeRFConfig, TNeRF, TNeRFConfig, VanillaNeRF, VanillaNeRFConfig
from swnerf_torch.parallel import check_dispatch
from swnerf_torch.parallel import tensor as T
from swnerf_torch.parallel.dryrun import launch
from swnerf_torch.pipelines import run_multires as mr
from swnerf_torch.pipelines.run_multires import CHANNEL_LIST
from swnerf_torch.render.core import Rays, RenderConfig
from swnerf_torch.train.loop import init_train_state, make_dnerf_train_step, make_train_step

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
KW = dict(netdepth=8, netwidth=64, skips=(4,), multires=4, multires_views=2)
TIMEOUT = 300


# ---------------------------------------------------------------- the assignment


def _family_cfgs(family, width):
    """(the JAX param tree's shapes, the port's field) of one family at
    ``width``."""
    import jax

    from swnerf_tpu.models import VanillaNeRFConfig as JaxVanillaConfig
    from swnerf_tpu.models.dnerf import DNeRFConfig as JaxDNeRFConfig
    from swnerf_tpu.models.dnerf import make_dnerf_field
    from swnerf_tpu.models.tnerf import TNeRFConfig as JaxTNeRFConfig
    from swnerf_tpu.models.tnerf import init_tnerf_params
    from swnerf_tpu.models.vanilla import init_vanilla_params

    key = jax.random.PRNGKey(0)
    if family == "vanilla":
        kw = dict(netdepth=8, netwidth=width, multires=4, multires_views=2)
        return (jax.eval_shape(functools.partial(init_vanilla_params, cfg=JaxVanillaConfig(**kw)), key),
                VanillaNeRF(VanillaNeRFConfig(**kw), device="cpu"))
    if family == "tnerf":
        kw = dict(netdepth=8, net_dim=width, multires=4, multires_views=2)
        return (jax.eval_shape(functools.partial(init_tnerf_params, cfg=JaxTNeRFConfig(**kw)), key),
                TNeRF(TNeRFConfig(**kw), device="cpu"))
    if family == "dnerf":
        kw = dict(netdepth=8, netwidth=width, multires=4, multires_views=2)
    else:  # a MultiRes level: its channels, as run_multires builds it
        pos, tim, view = CHANNEL_LIST[int(family[-1])]
        kw = dict(netdepth=8, netwidth=width, multires=pos, multires_views=view, multires_time=tim,
                  i_embed=0 if pos != -1 else -1)
    return (jax.eval_shape(make_dnerf_field(JaxDNeRFConfig(**kw), fused=False).init, key),
            DirectTemporalNeRF(DNeRFConfig(**kw), device="cpu", fused=False))


@functools.lru_cache(maxsize=None)
def _jax_and_port(family, width):
    return _family_cfgs(family, width)


def _jax_kinds(params, n_model):
    """The JAX package's assignment by the port's module names: its spec
    tree walked by the checkpoint bridge's layer order."""
    from jax.sharding import PartitionSpec as P

    from swnerf_torch.train.checkpoint import _dnerf_layers, _tnerf_layers, _vanilla_layers
    from swnerf_tpu.parallel import mlp_param_specs

    specs = mlp_param_specs(params, n_model)
    walk = _dnerf_layers if "canonical" in specs else _tnerf_layers if "layers" in specs else _vanilla_layers
    kinds = {}
    for name, spec in walk(specs):
        kind = {P(None, "model"): T.COLUMN, P("model", None): T.ROW, P(): T.REPLICATED}[spec["w"]]
        assert spec["b"] == (P("model") if kind == T.COLUMN else P()), (name, spec)
        kinds[name] = kind
    return kinds


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("width", [32, 33, 512])
@pytest.mark.parametrize("family", ["vanilla", "tnerf", "dnerf", "multires0", "multires3"])
def test_assignment_matches_jax(family, width, n_model):
    """Column, row or replicated, layer by layer by checkpoint name, as the
    JAX package's ``mlp_param_specs`` gives them on its param tree."""
    params, field = _jax_and_port(family, width)
    got = T.mlp_param_specs(field, n_model)
    assert got == _jax_kinds(params, n_model)
    assert set(got) == {n.rpartition(".")[0] for n, _ in field.named_parameters()}
    stacks, _ = field.mlp_layout()
    if width == 33:  # no width-33 dimension divides: every stack but the views stack stays whole
        assert all(got[n] == T.REPLICATED for names in stacks if "views" not in names[0] for n in names)
    if width == 512 and n_model == 2:
        assert all(got[n] != T.REPLICATED for n in stacks[0])  # every trunk layer is cut


def test_views_stack_degrades_at_width_32():
    """The JAX test's case: the one-layer views stack is forced to a row
    layer whose fan_in (15 + 32 = 47) k = 2 does not divide: replicated."""
    _, field = _jax_and_port("vanilla", 32)
    specs = T.mlp_param_specs(field, 2)
    assert specs["views_linears.0"] == T.REPLICATED
    assert [specs[f"pts_linears.{i}"] for i in range(8)] == [T.COLUMN, T.ROW, T.COLUMN, T.ROW, T.ROW, T.COLUMN,
                                                             T.ROW, T.ROW]


def test_shard_numel():
    """The values a model rank holds per layer kind."""
    assert T.shard_numel(T.COLUMN, 10, 8, 2) == 4 * 11
    assert T.shard_numel(T.ROW, 10, 8, 2) == 8 * 5 + 8
    assert T.shard_numel(T.REPLICATED, 10, 8, 2) == 8 * 11


def test_no_world_refuses(monkeypatch):
    """One process: SWNERF_TENSOR_PARALLEL=2 refuses with the JAX message;
    at most 1 means no tensor parallelism."""
    for k in ("SWNERF_COORDINATOR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    state = init_train_state(VanillaNeRF(VanillaNeRFConfig(**KW), device="cpu", fused=False), None)
    with pytest.raises(ValueError, match=r"SWNERF_TENSOR_PARALLEL=2 needs >= 2 devices, have 1"):
        T.tensor_parallel_setup(state, 32, 2)
    for value, want in (("", 0), ("0", 0), ("1", 0), ("2", 2), ("4", 4)):
        monkeypatch.setenv("SWNERF_TENSOR_PARALLEL", value)
        assert T.tensor_parallel_degree() == want


def test_kernel_route_fields_refuse_to_shard():
    """A field built for its kernel route reads whole weights: cutting it
    refuses."""
    field = VanillaNeRF(VanillaNeRFConfig(**dict(KW, netwidth=128)), device="cpu", fused=True)
    assert field.fused
    with pytest.raises(ValueError, match="fused=False"):
        T.shard_field_(field, T.mlp_param_specs(field, 2), None)


def test_tensor_parallel_imports_without_jax():
    """``swnerf_torch.parallel.tensor`` and the trainers import with ``jax``
    and the JAX package blocked."""
    code = ("import sys; sys.modules['jax'] = None; sys.modules['swnerf_tpu'] = None\n"
            "import swnerf_torch.parallel.tensor, swnerf_torch.pipelines.run_nerf, swnerf_torch.pipelines.run_tnerf\n"
            "import swnerf_torch.pipelines.run_dnerf, swnerf_torch.pipelines.run_multires\n"
            "assert not any(m.split('.')[0] in ('jax', 'swnerf_tpu') for m in sys.modules if sys.modules[m])\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(REPO), timeout=120)


# ---------------------------------------------------------------- the ranks


def run_world(tmp_path, world, payload, threads):
    tmp_path.mkdir(parents=True, exist_ok=True)
    torch.save(payload, tmp_path / "in.pt")
    code = f"from tests.test_torch_tensor_parallel import _child; _child({str(tmp_path)!r}, {threads})"
    launch([sys.executable, "-c", code], world, str(tmp_path), timeout=TIMEOUT, threads=threads, cwd=str(REPO))
    return [torch.load(tmp_path / f"out{r}.pt", weights_only=False) for r in range(world)]


def _child(path, threads):
    """A rank: join the world, the policy's refusals, then every case of
    the payload under tensor parallelism (and alone where a case asks)."""
    from swnerf_torch.parallel import initialize_from_env

    torch.set_num_threads(threads)
    assert initialize_from_env("cpu")
    payload = torch.load(os.path.join(path, "in.pt"), weights_only=False)
    out = {"refusals": _refusals()}
    for name, case in payload.items():
        run = functools.partial(_run_multires, tmp=path) if case["arch"] == "multires" else _run
        out[name] = run(case, tp=True)
        if case.get("alone"):
            out[name + "/alone"] = run(case, tp=False)
        if case["arch"] == "multires" and case["dtype"] == "float32":
            out[name + "/control"] = run(case, tp=False, control=True)
    torch.save(out, os.path.join(path, f"out{torch.distributed.get_rank()}.pt"))


def _refusals():
    """What ``tensor_parallel_setup`` refuses in this world, as messages."""
    world = torch.distributed.get_world_size()
    out = {}
    for name, k, env, batch in (("below", 2 * world, {}, 64), ("indivisible", 3, {}, 64),
                                ("capped", 2, {"SWNERF_MESH_DEVICES": "1"}, 64), ("few_rays", 2, {}, 1)):
        saved = {e: os.environ.get(e) for e in env}
        os.environ.update(env)
        state = init_train_state(VanillaNeRF(VanillaNeRFConfig(**KW), device="cpu", fused=False), None)
        try:
            T.tensor_parallel_setup(state, batch, k, quiet=True)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
        finally:
            for e, v in saved.items():
                if v is None:
                    os.environ.pop(e)
                else:
                    os.environ[e] = v
    return out


def _field(case, key, dtype):
    if case.get(key) is None:
        return None
    if case["arch"] == "vanilla":
        model = VanillaNeRF(VanillaNeRFConfig(**case["kw"]), device="cpu", fused=False)
    else:
        model = DirectTemporalNeRF(DNeRFConfig(**case["kw"]), device="cpu", fused=False)
    model.load_state_dict(case[key])
    return model.to(dtype)


def _named(state):
    return [(net, m) for net, m in (("coarse", state.coarse), ("fine", state.fine)) if m is not None]


def _whole(mesh, state, what):
    """Every parameter's whole value or gradient, keyed ``net.name``."""
    if mesh is not None:
        vals = T.gathered(mesh.model, dict(_named(state)), grads=what == "grad")
    else:
        vals = {f"{net}.{n}": p.grad if what == "grad" else p for net, m in _named(state)
                for n, p in m.named_parameters()}
    return {k: v.detach().clone().numpy() for k, v in vals.items()}


def _run(case, tp):
    """``case["steps"]`` eager steps on the case's fields, cut over the world
    (``tp``) or alone: every step's metrics, the first step's whole
    gradients, the last whole parameters; under tensor parallelism also the
    replicated parameters as this rank holds them, the local shapes of the
    parameters and moments, and the bytes held against the assignment's."""
    dtype = getattr(torch, case["dtype"])
    state = init_train_state(_field(case, "coarse", dtype), _field(case, "fine", dtype), 5e-4, 250)
    n = case["rays"].origins.shape[0]
    mesh = group = specs = None
    if tp:
        mesh, specs, state = T.tensor_parallel_setup(state, n, 2, quiet=True)
        group = mesh.rays
    rcfg = RenderConfig(**case["rc"])
    if case["arch"] == "vanilla":
        step, extra = make_train_step(rcfg, group=group), ()
    else:
        step, extra = make_dnerf_train_step(rcfg, True, 1e-2, group=group), (case["neighbor_time"],)
    rays = Rays(*(None if x is None else x.to(dtype) for x in case["rays"]))
    gen = torch.Generator().manual_seed(7)
    out = {"metrics": []}
    for s in range(case["steps"]):
        m = step(state, rays, case["target"].to(dtype), *extra, gen)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if s == 0:
            out["grads"] = _whole(mesh, state, "grad")
    out["params"] = _whole(mesh, state, "data")
    if tp:
        rep = {f"{net}.{name}": p.detach().numpy().copy() for net, m in _named(state)
               for name, p in m.named_parameters()
               if isinstance(m.get_submodule(name.rpartition(".")[0]), torch.nn.Linear)}
        shapes = {f"{net}.{name}": (tuple(p.shape), tuple(state.optimizer.state[p]["exp_avg"].shape),
                                    tuple(state.optimizer.state[p]["exp_avg_sq"].shape))
                  for net, m in _named(state) for name, p in m.named_parameters()}
        try:
            check_dispatch(group, "cuda", 20)
        except ValueError as e:
            out["dispatch"] = str(e)
        out.update(replicated=rep, shapes=shapes, specs=specs, bytes=T.local_bytes(state),
                   expected_bytes=T.expected_local_bytes(specs, state, 2),
                   rays_rank=mesh.rays.rank, model_rank=mesh.model.rank)
    return out


MR_PATCHES = [16, 8, 4, 2]  # the joint step's patch at each level (halved per level, as run_multires's)


def _multires_case():
    """Four MultiRes levels at the config's encodings (``CHANNEL_LIST``;
    D=8, W=32, direct_temporal), seeded, and one joint step's inputs: a
    32 x 32 scene's camera, each level's aligned patch, its Laplacian-band
    target and the full-resolution target (the global term on), jitter and
    noise on, the draws fixed."""
    rng = np.random.default_rng(5)
    L, H = len(MR_PATCHES), 32
    levels = []
    for l in range(L):
        torch.manual_seed(20 + l)
        cfg = _mr_cfg(l)
        levels.append(DirectTemporalNeRF(cfg, device="cpu", fused=False).state_dict())
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 4.0
    pixels, targets = [], []
    for l, ps in enumerate(MR_PATCHES):
        y = x = (H >> l) // 4
        ys, xs = np.meshgrid(np.arange(y, y + ps), np.arange(x, x + ps), indexing="ij")
        pixels.append(torch.from_numpy(np.stack([ys, xs], -1).reshape(-1, 2)))
        targets.append(torch.from_numpy(rng.uniform(-0.2, 0.2, (ps, ps, 3)).astype(np.float32)))
    draws = [(torch.from_numpy(rng.uniform(0, 1, (ps * ps, 8)).astype(np.float32)),
              torch.from_numpy(rng.standard_normal((ps * ps, 8)).astype(np.float32))) for ps in MR_PATCHES]
    return dict(arch="multires", levels=levels, pose=torch.from_numpy(c2w), pixels=pixels, targets=targets,
                full=torch.from_numpy(rng.uniform(0, 1, (MR_PATCHES[0],) * 2 + (3,)).astype(np.float32)),
                draws=draws, hwf=[[H >> l, H >> l, 40.0 / 2**l] for l in range(L)], alone=True)


def _mr_cfg(level):
    pos, tim, view = CHANNEL_LIST[level]
    return DNeRFConfig(netdepth=8, netwidth=32, skips=(4,), multires=pos, multires_views=view, multires_time=tim,
                       i_embed=0 if pos != -1 else -1, use_viewdirs=True, output_ch=4, zero_canonical=True)


def _run_multires(case, tp, tmp, control=False):
    """MultiRes: the test frame every level renders (from the gathered
    fields over the world under tensor parallelism), then one joint
    phase-2 step on the field route (over the rays group; with
    ``control``, alone under :func:`grid_sums`): the metrics and every
    level's whole gradients."""
    from types import SimpleNamespace

    from swnerf_torch.pipelines.common import Scene
    from swnerf_torch.render.core import Draws

    dtype = getattr(torch, case["dtype"])
    states = []
    for l, sd in enumerate(case["levels"]):
        model = DirectTemporalNeRF(_mr_cfg(l), device="cpu", fused=False)
        model.load_state_dict(sd)
        states.append(init_train_state(model.to(dtype), None, 5e-4, 50))
    mesh = group = None
    if tp:
        mesh, _, states = T.tensor_parallel_setup_multires(states, min(MR_PATCHES) ** 2, 2, quiet=True)
        group = mesh.rays
    rcfg = RenderConfig(n_samples=8, perturb=1.0, white_bkgd=True, raw_noise_std=0.5)
    out = {}
    if case["dtype"] == "float32" and not control:
        H = case["hwf"][0][0]
        pose = case["pose"].numpy()[None]
        scene = Scene(np.zeros((1, H, H, 3), np.float32), pose, pose, H, H, case["hwf"][0][2], np.eye(3), 2.0, 6.0,
                      np.array([], int), np.array([], int), np.array([0]), times=np.array([0.5], np.float32))
        rank = torch.distributed.get_rank()
        args = SimpleNamespace(basedir=os.path.join(tmp, f"mr{rank}"), expname="tp" if tp else "alone", chunk=64)
        _, _, frames = mr.render_testset(args, scene, mr.render_states(mesh, states), case["hwf"], rcfg, 0, None,
                                         None if mesh is None else mesh.world)
        out["frames"] = [f.clone() for f in frames]
    cast = lambda x: x.to(dtype)  # noqa: E731
    step = mr.make_phase2_step(rcfg, case["hwf"], MR_PATCHES, 2.0, 6.0, fused=False, group=group)
    with grid_sums() if control else contextlib.nullcontext(lambda states: None) as register:
        register(states)
        m = step(states, case["pixels"], [cast(x) for x in case["targets"]], cast(case["full"]),
                 cast(case["pose"][:3]), 0.5, 1.0, draws=[Draws(cast(t), cast(n), None, None) for t, n in case["draws"]])
    out["metrics"] = {k: float(v) for k, v in m.items()}
    out["grads"] = [_whole(mesh, st, "grad") for st in states]
    return out


# ---------------------------------------------------------------- the cases


def _jax_vanilla_case():
    """Two nets, hierarchical, deterministic: the case, and a function that
    runs the JAX autodiff step on a state sharded by the JAX package's
    tensor_parallel_setup (k = 2 over the 8 CPU devices: 4-way rays) and
    returns its gradients and metrics."""
    import jax
    import jax.numpy as jnp

    from swnerf_torch.train.checkpoint import params_from_jax
    from swnerf_tpu.models import VanillaNeRFConfig as JaxConfig
    from swnerf_tpu.models import make_vanilla_field
    from swnerf_tpu.parallel import tensor_parallel_setup as jax_setup
    from swnerf_tpu.render import RenderConfig as JaxRenderConfig
    from swnerf_tpu.train.loop import init_train_state as jax_init
    from swnerf_tpu.train.loop import make_train_step as jax_step
    from tests.test_torch_train import _grad_stash, _jax_params, _rays

    rc = dict(n_samples=8, n_importance=8, perturb=0.0, white_bkgd=True, raw_noise_std=0.0)
    jcfg = JaxConfig(**KW)
    jrays, rays, target = _rays(32)
    pc, pf = _jax_params(0, jcfg), _jax_params(1, jcfg)

    def reference():
        stash = _grad_stash()
        _, _, js = jax_setup(jax_init({"coarse": pc, "fine": pf}, stash), 32, 2, quiet=True)
        s, m_ref = jax.jit(jax_step(make_vanilla_field(jcfg, fused=False), JaxRenderConfig(**rc), stash))(
            js, jrays, jnp.asarray(target), jax.random.PRNGKey(0))
        ref = {f"{net}.{k}": v.numpy() for net in ("coarse", "fine")
               for k, v in params_from_jax(jax.tree.map(np.asarray, s.opt_state[net])).items()}
        return ref, {k: float(v) for k, v in m_ref.items()}

    case = dict(arch="vanilla", kw=dict(KW, output_ch=5), rc=rc, coarse=params_from_jax(pc), fine=params_from_jax(pf),
                rays=rays, target=torch.from_numpy(target), steps=1)
    return case, reference


def _jax_dnerf_case():
    """One D-NeRF field with the TV term, deterministic, 32 pixels of frame
    1 of a small scene: the case, and the JAX ``make_dnerf_step`` on a state
    sharded by its tensor_parallel_setup (as :func:`_jax_vanilla_case`); the
    port takes the rays its ``make_time_image_step`` builds from the same
    pixels."""
    import jax
    import jax.numpy as jnp

    from swnerf_torch.pipelines.common import make_time_image_step
    from swnerf_tpu.models.dnerf import DNeRFConfig as JaxConfig
    from swnerf_tpu.models.dnerf import make_dnerf_field
    from swnerf_tpu.parallel import tensor_parallel_setup as jax_setup
    from swnerf_tpu.pipelines.run_dnerf import make_dnerf_step as jax_make_dnerf_step
    from swnerf_tpu.render import RenderConfig as JaxRenderConfig
    from swnerf_tpu.train.loop import init_train_state as jax_init
    from tests.test_torch_dnerf import _grad_stash, _jax_grads, _jax_params, _tiny_scene
    from swnerf_torch.train.checkpoint import params_from_jax

    rc = dict(n_samples=8, n_importance=8, perturb=0.0, white_bkgd=True, raw_noise_std=0.0, coarse_contributes=False)
    kw = dict(KW, zero_canonical=True)
    _, pc = _jax_params(kw, 0)
    scene, jscene, images, poses, times = _tiny_scene()
    pixels = np.random.default_rng(3).integers(0, 16, (32, 2))

    def reference():
        stash = _grad_stash()
        jstep = jax_make_dnerf_step(make_dnerf_field(JaxConfig(**kw), fused=False), JaxRenderConfig(**rc), stash,
                                    jscene, True, 1e-2)
        _, _, js = jax_setup(jax_init(jax.tree.map(jnp.asarray, {"coarse": pc, "fine": None}), stash), 32, 2,
                             quiet=True)
        s_ref, m_ref = jax.jit(jstep.__wrapped__)(js, jnp.asarray(images), jnp.asarray(poses), jnp.asarray(times), 1,
                                                  jnp.asarray(pixels), jnp.float32(0.37), jax.random.PRNGKey(42))
        return _jax_grads(s_ref.opt_state), {k: float(v) for k, v in m_ref.items()}

    got = {}

    def capture(state, rays, target, neighbor_time, generator=None):
        got.update(rays=rays, target=target)

    make_time_image_step(capture, RenderConfig(**rc), scene, pass_neighbor=True)(
        None, torch.from_numpy(images), torch.from_numpy(poses[:, :3, :4]), torch.from_numpy(times), 1, pixels, 0.37)
    case = dict(arch="dnerf", kw=kw, rc=rc, coarse=params_from_jax(pc), fine=None, neighbor_time=0.37, steps=1,
                **got)
    return case, reference


def _np_rays(n, seed, times=False):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = 4.0
    t = None
    if times:
        t = rng.uniform(0.0, 1.0, (n, 1)).astype(np.float32)
        t[: n // 4] = 0.0
        t = torch.from_numpy(t)
    rays = Rays(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(d.copy()), torch.full((n,), 2.0),
                torch.full((n,), 6.0), t)
    return rays, torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32))


def _sd(arch, seed):
    torch.manual_seed(seed)
    if arch == "vanilla":
        return VanillaNeRF(VanillaNeRFConfig(**KW, output_ch=5), device="cpu", fused=False).state_dict()
    return DirectTemporalNeRF(DNeRFConfig(**KW), device="cpu", fused=False).state_dict()


def _self_cases():
    """Jitter and noise on, 3 Adam steps, against one process."""
    rc = dict(n_samples=8, n_importance=8, perturb=1.0, white_bkgd=True, raw_noise_std=0.7)
    rays, target = _np_rays(32, 1)
    trays, ttarget = _np_rays(32, 2, times=True)
    return {
        "self/vanilla": dict(arch="vanilla", kw=dict(KW, output_ch=5), rc=rc, coarse=_sd("vanilla", 0),
                             fine=_sd("vanilla", 1), rays=rays, target=target, steps=3, dtype="float32", alone=True),
        "self/dnerf": dict(arch="dnerf", kw=KW, rc=dict(rc, coarse_contributes=False), coarse=_sd("dnerf", 2),
                           fine=None, rays=trays, target=ttarget, neighbor_time=0.37, steps=3, dtype="float32",
                           alone=True),
    }


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The 2-rank and 4-rank worlds' results per rank, the JAX references
    and the cases. The worlds run (one after the other, in a thread) while
    this process computes the JAX references."""
    cases, references = _self_cases(), {}
    for dtype in ("float32", "float64"):
        cases[f"multires/{dtype}"] = dict(_multires_case(), dtype=dtype)
    for name, make in (("vanilla", _jax_vanilla_case), ("dnerf", _jax_dnerf_case)):
        case, references[name] = make()
        for dtype in ("float32", "float64"):
            cases[f"jax/{name}/{dtype}"] = dict(case, dtype=dtype)
    dirs = {w: tmp_path_factory.mktemp(f"tp{w}") for w in (2, 4)}
    # 1 thread a rank: a multithreaded product may split its sums by the
    # machine's load, which Adam's normalisation of near-zero entries shows
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        worlds = pool.submit(lambda: {w: run_world(dirs[w], w, cases, threads=1) for w in (2, 4)})
        refs = {name: ref() for name, ref in references.items()}
        results = worlds.result()
    return results, refs, cases


WORLDS = [2, 4]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["vanilla", "dnerf"])
def test_sharded_step_matches_the_jax_sharded_step(worlds, name, world):
    """The eager vanilla step and the eager D-NeRF step with TV on the
    shards of a (rays, model) grid against the JAX autodiff step on a
    state its tensor_parallel_setup sharded: the gathered gradients before
    Adam and the metrics (module docstring's bars)."""
    from tests.test_torch_parallel import _check_grads, _check_metrics

    results, refs, _ = worlds
    grads, m_ref = refs[name]
    for rank in range(world):
        r32, r64 = results[world][rank][f"jax/{name}/float32"], results[world][rank][f"jax/{name}/float64"]
        _check_grads(r32["grads"], r64["grads"], grads)
        _check_metrics([r32["metrics"][0], r64["metrics"][0]], m_ref, list(m_ref))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["self/vanilla", "self/dnerf"])
def test_sharded_adam_steps_match_one_process(worlds, name, world):
    """Jitter and noise on (every rank draws the global batch's numbers from
    one seeded generator): 3 Adam steps on the shards, gathered, against
    one process (rtol 1e-5, atol 1e-6); every step's loss rel 1e-5; every
    rank's metrics equal."""
    results = worlds[0][world]
    r0, alone = results[0][name], results[0][name + "/alone"]
    assert all(r[name]["metrics"] == r0["metrics"] for r in results)
    for m, m1 in zip(r0["metrics"], alone["metrics"]):
        for k in ("loss", "total_loss"):
            assert m[k] == pytest.approx(m1[k], rel=1e-5), k
    for r in results:
        for k, p in alone["params"].items():
            np.testing.assert_allclose(r[name]["params"][k], p, rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_replicated_parameters_are_bit_identical_across_model_ranks(worlds, world):
    """A replicated layer's gradient is the same bits on every model rank,
    so its parameters stay bit-identical after Adam; the shards of one
    model rank are bit-identical across the rays ranks."""
    results = worlds[0][world]
    for name in ("self/vanilla", "self/dnerf", "jax/vanilla/float32", "jax/dnerf/float32"):
        reps = [r[name]["replicated"] for r in results]
        assert reps[0]
        for rep in reps[1:]:
            assert rep.keys() == reps[0].keys()
            for k in rep:
                assert np.array_equal(rep[k], reps[0][k]), (name, k)
        for r in results:  # the same gathered whole on every rank
            for k, v in r[name]["params"].items():
                assert np.array_equal(v, results[0][name]["params"][k]), (name, k)


@pytest.mark.parametrize("world", WORLDS)
def test_each_rank_holds_its_shards_and_moments(worlds, world):
    """The grid (rank = rays index x 2 + model index), each parameter's and
    each Adam moment's local shape by its layer's kind, and the bytes a
    rank holds equal to the assignment's sum, about half a whole state's
    for the trunk."""
    results = worlds[0][world]
    for rank, r in enumerate(results):
        res = r["self/vanilla"]
        assert (res["rays_rank"], res["model_rank"]) == divmod(rank, 2)
        assert res["bytes"] == res["expected_bytes"]
        for net in ("coarse", "fine"):
            for layer, kind in res["specs"][net].items():
                w, b = res["shapes"][f"{net}.{layer}.weight"], res["shapes"][f"{net}.{layer}.bias"]
                whole = res["params"][f"{net}.{layer}.weight"].shape
                want_w = {T.COLUMN: (whole[0] // 2, whole[1]), T.ROW: (whole[0], whole[1] // 2)}.get(kind, whole)
                want_b = (whole[0] // 2,) if kind == T.COLUMN else (whole[0],)
                assert w == (want_w,) * 3 and b == (want_b,) * 3, (net, layer, kind, w, b)
        whole_bytes = sum(v.size for v in res["params"].values()) * 4 * 3
        assert res["bytes"] < 0.6 * whole_bytes


@pytest.mark.parametrize("world", WORLDS)
def test_policy_refusals(worlds, world):
    """A world below k, one that k does not divide, a SWNERF_MESH_DEVICES
    cap below the world and a batch below the rays axis refuse, naming the
    numbers, before any group is made."""
    for r in worlds[0][world]:
        ref = r["refusals"]
        assert f"SWNERF_TENSOR_PARALLEL={2 * world} needs >= {2 * world} devices, have {world}" in ref["below"]
        if world == 4:
            assert "SWNERF_TENSOR_PARALLEL=3 does not divide the world of 4 processes" in ref["indivisible"]
        else:  # 3 > 2: the world is below k
            assert "SWNERF_TENSOR_PARALLEL=3 needs >= 3 devices, have 2" in ref["indivisible"]
        assert "SWNERF_MESH_DEVICES=1" in ref["capped"] and f"{world} processes" in ref["capped"]
        if world == 4:
            assert "N_rand=1" in ref["few_rays"] and "2 ranks of the rays axis" in ref["few_rays"]
        else:
            assert ref["few_rays"] is None


@pytest.mark.parametrize("world", WORLDS)
def test_gloo_grid_on_a_card_refuses_k_steps(worlds, world):
    """The rays group a trainer's step reduces over is a gloo group: on a
    card, K > 1 steps a dispatch (a CUDA graph, which cannot hold a gloo
    collective) refuses, as under data parallelism."""
    for r in worlds[0][world]:
        assert "SWNERF_STEPS_PER_DISPATCH=20" in r["self/vanilla"]["dispatch"]


def _rel_l2(got, want):
    return {k: np.linalg.norm(got[k] - w) / max(np.linalg.norm(w), 1e-300) for k, w in want.items()}


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_multires_step_matches_one_process(worlds, world):
    """MultiRes's joint step with every level cut over the grid against one
    process (module docstring): in float64 each level's every gathered
    gradient tensor within rel L2 1e-9 and every metric rel 1e-10; in fp32
    the total loss rel 1e-5, and each level's every gradient tensor within
    rel L2 1e-5 of one process summing as the grid does (``grid_sums``;
    one process summing as it likes parts level 0 by ~1e-1 here)."""
    for r in worlds[0][world]:
        tp, one = r["multires/float64"], r["multires/float64/alone"]
        for k, v in one["metrics"].items():
            assert tp["metrics"][k] == pytest.approx(v, rel=1e-10), k
        for level, (g, want) in enumerate(zip(tp["grads"], one["grads"])):
            assert g.keys() == want.keys()
            errs = _rel_l2(g, want)
            assert max(errs.values()) <= 1e-9, (level, max(errs, key=errs.get), max(errs.values()))
        tp, one, ctl = (r[f"multires/float32{s}"] for s in ("", "/alone", "/control"))
        assert tp["metrics"]["total_loss"] == pytest.approx(one["metrics"]["total_loss"], rel=1e-5)
        for level, (g, want) in enumerate(zip(tp["grads"], ctl["grads"])):
            errs = _rel_l2(g, want)
            assert max(errs.values()) <= 1e-5, (level, max(errs, key=errs.get), max(errs.values()))


@pytest.mark.parametrize("world", WORLDS)
def test_multires_frames_from_gathered_fields_are_bit_equal(worlds, world):
    """``render_testset`` on ``render_states``: every level's test frame
    from the fields gathered over the model group, its chunks shared over
    the world, equal to one process's frame from the same weights."""
    for r in worlds[0][world]:
        got, want = r["multires/float32"]["frames"], r["multires/float32/alone"]["frames"]
        assert len(got) == len(want) == len(MR_PATCHES)
        for level, (a, b) in enumerate(zip(got, want)):
            assert a.shape == b.shape and torch.isfinite(a).all(), level
            assert torch.equal(a, b), level
