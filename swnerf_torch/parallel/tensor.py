"""Tensor (model) parallelism over ranks (port of
``swnerf_tpu/parallel/tensor.py``): ``SWNERF_TENSOR_PARALLEL=k``.

The JAX package shards the fields' weights over the ``model`` axis of a 2-D
``(rays, model)`` device mesh and lets GSPMD place the matmuls and insert
the all-reduces. The port runs one process per card and does by hand what
GSPMD does there:

* the grid (:func:`make_mesh_2d`): rank = rays index x n_model + model
  index, so a model group is a run of adjacent ranks; every rank creates
  every rays group and every model group (``dist.new_group``, in one
  order). A :class:`~swnerf_torch.parallel.mesh.RaysGroup` stands for
  each: the step's batch rows, its gradient all-reduce and ``replicate``
  run over the rays group, the layers' collectives over the model group;
* the assignment (:func:`mlp_param_specs`), the JAX package's
  Megatron-style rule walked over each family's stacks in the JAX tree's
  order: a segment starts wherever a layer's fan_in differs from the
  previous layer's fan_out (a skip concat widened the input); inside a
  segment the layers alternate column, row, column, and a segment's last
  layer is a row layer, so its output is whole for the concat or the
  heads; a layer whose sharded dimension ``k`` does not divide, and every
  lone head, is replicated;
* the sharded layers: torch keeps ``W [out, in]``. A :class:`ColumnLinear`
  keeps rows ``[m out/k, (m+1) out/k)`` of ``W`` and ``b``; its output is
  feature-sharded, and ReLU, ELU and the bf16 rounding act elementwise on
  the shard. A :class:`RowLinear` keeps the columns of ``W`` for its input
  shard (it cuts a whole input to its columns itself), sums the partial
  products over the model group and adds the whole bias once, after the
  sum. Two ``torch.autograd.Function``\\ s carry the collectives:
  :func:`copy_to_model` (identity forward, ``all_reduce`` backward) on
  every sharded layer's whole input, and :func:`reduce_from_model`
  (``all_reduce`` forward, identity backward). Replicated layers stay
  ``nn.Linear``; every model rank computes them on the same values, and
  their gradients are the same bits on every model rank. Nothing on the
  step's path gathers a weight;
* Adam's moments are cut like their parameters (:func:`shard_train_state`),
  so optimizer memory shrinks with ``k``; the step's reducer sums a shard's
  gradient over the rays group only;
* checkpoints and renders gather: :meth:`TensorMesh.whole_state` gives a
  ``TrainState`` of whole fields and whole moments (rank 0 writes the
  checkpoint a one-process run writes), :meth:`TensorMesh.whole_modules`
  whole fields on the kernel route for the test renders, which every rank
  of the world then shares (``render_image(group=)``). A resume reads the
  whole file on every rank before the state is cut;
* the trainers' choice (:func:`parallel_setup`): tensor parallelism,
  data parallelism or no group, in one place; a ``--render_only`` run
  trains nothing, so it cuts nothing and renders its loaded fields over
  the world.

Every collective is an ``all_reduce`` (SUM) or a ``broadcast``: a gather is
an all-reduce of zero-filled buffers that each rank fills at its slice, so
it is exact and runs under NCCL, gloo on the CPU and gloo on CUDA tensors.
Under tensor parallelism the fields take their plain route and the
trainers their eager steps: the field kernels (B6, B7, B7', B8) and the
kernel steps read whole weights. Kernel B2 still runs inside
``render_rays`` on a card.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from swnerf_torch.models.common import linear
from swnerf_torch.parallel.mesh import RAYS_AXIS, RaysGroup, data_parallel_mesh, make_mesh, replicate

MODEL_AXIS = "model"
COLUMN, ROW, REPLICATED = "column", "row", "replicated"


def tensor_parallel_degree() -> int:
    """``SWNERF_TENSOR_PARALLEL`` as the model axis's size; 0 when it is
    unset or at most 1 (no tensor parallelism, as the JAX package's
    ``tp > 1``)."""
    k = int(os.environ.get("SWNERF_TENSOR_PARALLEL", "0") or 0)
    return k if k > 1 else 0


# ---------------------------------------------------------------- the grid


@dataclasses.dataclass(eq=False)
class TensorMesh:
    """The ``(rays, model)`` grid of this rank: its rays group (the step's
    rows, gradient sum and ``replicate``), its model group (the layers'
    collectives) and the whole world (the renders)."""

    rays: RaysGroup
    model: RaysGroup
    world: RaysGroup

    @property
    def shape(self) -> Dict[str, int]:
        return {RAYS_AXIS: self.rays.world, MODEL_AXIS: self.model.world}

    @property
    def size(self) -> int:
        return self.rays.world * self.model.world

    def whole_modules(self, modules: Sequence[Optional[nn.Module]], fused: Optional[bool] = None
                      ) -> List[Optional[nn.Module]]:
        """Whole fields with the shards' values, one collective a field,
        built with ``fused`` (None: the kernel route where the device and
        the switches take it). Every rank of the model group calls it."""
        return [None if m is None else _whole_field(m, self.model, fused) for m in modules]

    def whole_state(self, state):
        """A ``TrainState`` of whole fields and whole Adam moments at the
        state's update count, as one process would hold it: what a
        checkpoint writes (``native_state``, the trainers' ``.tar``
        payloads). Every rank of the model group calls it."""
        from swnerf_torch.train.loop import TrainState, make_optimizer

        coarse, fine = self.whole_modules([state.coarse, state.fine], fused=False)
        old = [p for m in state.modules() for p in m.parameters()]
        new = [p for m in (coarse, fine) if m is not None for p in m.parameters()]
        opt = make_optimizer([coarse, fine], state.lr if state.count is not None else
                             state.optimizer.param_groups[0]["lr"])
        moments, where = [], []
        for p, q, dim in zip(old, new, _param_dims(state.modules())):
            st = state.optimizer.state.get(p)
            if not st:
                continue
            opt.state[q] = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in st.items()}
            for k in ("exp_avg", "exp_avg_sq"):
                moments.append((st[k], dim, tuple(q.shape)))
                where.append((q, k))
        for (q, k), whole in zip(where, _gather(moments, self.model)):
            opt.state[q][k] = whole
        return TrainState(state.step, coarse, fine, opt, state.schedule)


def make_mesh_2d(n_rays: int, n_model: int) -> TensorMesh:
    """The ``(rays, model)`` grid over the default process group, whose size
    must be ``n_rays * n_model``: the model axis on adjacent ranks (the
    JAX package puts it on adjacent devices). Every rank creates every
    subgroup, in the same order."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n_rays * n_model:
        raise ValueError(f"a {n_rays} x {n_model} (rays, model) grid needs {n_rays * n_model} ranks, the world has "
                         f"{world}")
    backend = dist.get_backend()
    r, m = divmod(rank, n_model)
    rays_pg = model_pg = None
    for mm in range(n_model):
        pg = dist.new_group([rr * n_model + mm for rr in range(n_rays)])
        if mm == m:
            rays_pg = pg
    for rr in range(n_rays):
        pg = dist.new_group([rr * n_model + mm for mm in range(n_model)])
        if rr == r:
            model_pg = pg
    return TensorMesh(RaysGroup(r, n_rays, backend, rays_pg), RaysGroup(m, n_model, backend, model_pg), make_mesh())


def _policy_world(batch_size: int, n_model: int) -> int:
    """The ``SWNERF_TENSOR_PARALLEL=k`` policy: the model axis gets ``k``
    ranks, the rays axis the rest, whose size it returns. The launch fixes
    the world (one process per card), so where the JAX package shrinks its
    rays axis to a divisor of the batch, a world below ``k``, one ``k`` does
    not divide, one above ``SWNERF_MESH_DEVICES`` or a batch below the rays
    axis refuses."""
    n_dev = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    limit = int(os.environ.get("SWNERF_MESH_DEVICES", "0") or 0)
    if limit and n_dev > limit:
        raise ValueError(f"SWNERF_MESH_DEVICES={limit} is below the world of {n_dev} processes; the launch fixes "
                         "the world (one process per card): launch fewer processes or raise the cap")
    if n_dev < n_model:
        raise ValueError(f"SWNERF_TENSOR_PARALLEL={n_model} needs >= {n_model} devices, have {n_dev}")
    if n_dev % n_model:
        raise ValueError(f"SWNERF_TENSOR_PARALLEL={n_model} does not divide the world of {n_dev} processes: the "
                         "rays axis would leave ranks idle")
    n_rays = n_dev // n_model
    if batch_size and batch_size < n_rays:
        raise ValueError(f"N_rand={batch_size} rays cannot be sharded over {n_rays} ranks of the rays axis: every "
                         "rank needs at least one row")
    return n_rays


def _announce(mesh: TensorMesh, n_model: int, extra: str = "") -> None:
    print(f"Tensor parallelism: {n_model}-way model sharding x {mesh.shape[RAYS_AXIS]}-way ray sharding "
          f"({mesh.size} devices){extra}", flush=True)


def tensor_parallel_setup(state, batch_size: int, n_model: int, quiet: bool = False):
    """The trainers' policy for ``SWNERF_TENSOR_PARALLEL=k``: build the grid
    (:func:`_policy_world`), cut ``state``'s fields and Adam moments into
    this rank's shards (:func:`shard_train_state`) and broadcast them over
    the rays group (``replicate``). The state must hold whole fields on
    their plain route (``fused=False``), resumed alike on every rank.
    Returns ``(mesh, specs, state)``: ``specs`` maps ``"coarse"`` /
    ``"fine"`` to :func:`mlp_param_specs`."""
    mesh = make_mesh_2d(_policy_world(batch_size, n_model), n_model)
    specs = shard_train_state(mesh, state)
    replicate(mesh.rays, state)
    if not quiet:
        _announce(mesh, n_model)
    return mesh, specs, state


def tensor_parallel_setup_multires(states, batch_size: int, n_model: int, quiet: bool = False):
    """``SWNERF_TENSOR_PARALLEL=k`` for run_multires's per-level states: one
    grid, every level's fields and moments cut by its own assignment (the
    levels differ in their embeddings and share ``netwidth``). Returns
    ``(mesh, specs per level, states)``."""
    mesh = make_mesh_2d(_policy_world(batch_size, n_model), n_model)
    specs = [shard_train_state(mesh, st) for st in states]
    replicate(mesh.rays, states)
    if not quiet:
        _announce(mesh, n_model, f", {len(states)} pyramid levels")
    return mesh, specs, states


class Parallel(NamedTuple):
    """How a trainer's run spreads over the ranks (:func:`parallel_setup`):
    ``mesh`` the grid its fields are cut over (None: whole fields),
    ``group`` the step's rows and gradient sum, ``render_group`` the ranks
    that share each frame's chunks."""

    mesh: Optional[TensorMesh]
    group: Optional[RaysGroup]
    render_group: Optional[RaysGroup]


def field_route(render_only: bool = False) -> Optional[bool]:
    """The route a trainer builds its fields on: the plain one (False) where
    tensor parallelism will cut them for training (the field kernels read
    whole weights), else None (the kernel route where the card and the
    switches take it)."""
    return False if tensor_parallel_degree() and not render_only else None


def parallel_setup(states, batch_size: int = 0, render_only: bool = False, tp_batch_size: Optional[int] = None
                   ) -> Parallel:
    """The trainers' one choice between tensor parallelism, data parallelism
    and no group, made once their state (MultiRes: a list of level states)
    is built on :func:`field_route` and resumed alike on every rank:

    * ``SWNERF_TENSOR_PARALLEL=k`` for training: the grid and the cut
      (:func:`tensor_parallel_setup`, or ``_multires`` for a list) at
      ``tp_batch_size`` (default ``batch_size``) rays a step; the step runs
      over the rays group, the renders over the world on whole fields
      (:func:`render_fields`);
    * ``SWNERF_TENSOR_PARALLEL=k`` with ``render_only``: nothing trains, so
      nothing is cut: the policy's refusals, then the whole loaded fields
      render over the world;
    * otherwise ``data_parallel_mesh(batch_size)`` for both (None in a
      process that joined no world).

    Every rank starts from rank 0's values within the group that must hold
    them (``replicate``)."""
    k = tensor_parallel_degree()
    if k and not render_only:
        setup = tensor_parallel_setup_multires if isinstance(states, list) else tensor_parallel_setup
        mesh, _, _ = setup(states, batch_size if tp_batch_size is None else tp_batch_size, k)
        return Parallel(mesh, mesh.rays, mesh.world)
    if k:
        _policy_world(0, k)
        group = make_mesh()
        print(f"Tensor parallelism: {k}-way model sharding, render only: whole fields over {group.world} devices",
              flush=True)
    else:
        group = data_parallel_mesh(batch_size)
    replicate(group, states)
    return Parallel(None, group, group)


# ---------------------------------------------------------------- the assignment


def _stack_specs(dims: Sequence[Tuple[int, int]], n_model: int) -> List[str]:
    """Column / row / replicated for one stack of ``(fan_in, fan_out)``
    layers: ``_stack_specs`` of the JAX package."""
    starts = [0] + [i for i in range(1, len(dims)) if dims[i][0] != dims[i - 1][1]]
    ends = starts[1:] + [len(dims)]
    out = []
    for lo, hi in zip(starts, ends):
        for pos, i in enumerate(range(lo, hi)):
            fan_in, fan_out = dims[i]
            col = pos % 2 == 0 and i != hi - 1
            if col and fan_out % n_model == 0:
                out.append(COLUMN)
            elif not col and fan_in % n_model == 0:
                out.append(ROW)
            else:
                out.append(REPLICATED)
    return out


def _dims(layer: nn.Module) -> Tuple[int, int]:
    """A layer's whole ``(fan_in, fan_out)``, sharded or not."""
    return layer.in_features, layer.out_features


def mlp_param_specs(field: nn.Module, n_model: int) -> Dict[str, str]:
    """Column, row or replicated for every layer of ``field`` (by module
    name, in the JAX tree's order: the field's ``mlp_layout``): the JAX
    package's ``mlp_param_specs``, whose ``P(None, "model")`` is
    :data:`COLUMN`, ``P("model", None)`` :data:`ROW` and ``P()``
    :data:`REPLICATED`."""
    stacks, heads = field.mlp_layout()
    out: Dict[str, str] = {}
    for names in stacks:
        out.update(zip(names, _stack_specs([_dims(field.get_submodule(n)) for n in names], n_model)))
    out.update((n, REPLICATED) for n in heads)
    return out


def shard_numel(kind: str, fan_in: int, fan_out: int, n_model: int) -> int:
    """The values of one layer (weight and bias) that a model rank holds."""
    if kind == COLUMN:
        return (fan_out // n_model) * (fan_in + 1)
    if kind == ROW:
        return fan_out * (fan_in // n_model) + fan_out
    return fan_out * (fan_in + 1)


# ---------------------------------------------------------------- the collectives


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce_(g.clone(memory_format=torch.contiguous_format)), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce_(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group: RaysGroup) -> torch.Tensor:
    """``x`` as it is; its gradient summed over the model group (each shard
    of a layer adds its part of the input's gradient)."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group: RaysGroup) -> torch.Tensor:
    """``x`` summed over the model group; the gradient passes as it is."""
    return _ReduceFromModel.apply(x, group)


# ---------------------------------------------------------------- the sharded layers


class ColumnLinear(nn.Module):
    """Rows ``[m out/k, (m+1) out/k)`` of an ``nn.Linear``'s weight and bias
    on model rank ``m``: a whole input in, this rank's features out."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor, fan_in: int, fan_out: int, group: RaysGroup):
        super().__init__()
        self.weight, self.bias = nn.Parameter(weight), nn.Parameter(bias)
        self.in_features, self.out_features, self.group = fan_in, fan_out, group

    def forward(self, x: torch.Tensor, half: bool = False) -> torch.Tensor:
        return linear(copy_to_model(x, self.group), self.weight, self.bias, half)


class RowLinear(nn.Module):
    """Columns ``[m in/k, (m+1) in/k)`` of an ``nn.Linear``'s weight and the
    whole bias on model rank ``m``: this rank's input features in (a whole
    input is cut to them), the whole output out."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor, fan_in: int, fan_out: int, group: RaysGroup):
        super().__init__()
        self.weight, self.bias = nn.Parameter(weight), nn.Parameter(bias)
        self.in_features, self.out_features, self.group = fan_in, fan_out, group

    def forward(self, x: torch.Tensor, half: bool = False) -> torch.Tensor:
        n = self.weight.shape[1]
        if x.shape[-1] != n:  # a whole input: this rank's columns of it
            x = copy_to_model(x, self.group)[..., self.group.rank * n : (self.group.rank + 1) * n]
        return reduce_from_model(linear(x, self.weight, None, half), self.group) + self.bias


# Which dimension of (weight, bias) a layer kind cuts; None: whole.
_CUTS = {COLUMN: (0, 0), ROW: (1, None), REPLICATED: (None, None)}


def _kind(layer: nn.Module) -> str:
    return COLUMN if isinstance(layer, ColumnLinear) else ROW if isinstance(layer, RowLinear) else REPLICATED


def _param_dims(modules: Sequence[nn.Module]) -> List[Optional[int]]:
    """The dimension each parameter of ``modules`` is cut along (None:
    whole), in ``parameters()`` order."""
    out = []
    for module in modules:
        for name, _ in module.named_parameters():
            owner, _, leaf = name.rpartition(".")
            out.append(_CUTS[_kind(module.get_submodule(owner))][0 if leaf == "weight" else 1])
    return out


def _take(t: torch.Tensor, dim: Optional[int], rank: int, k: int) -> torch.Tensor:
    """Model rank ``rank``'s piece of a whole tensor cut along ``dim``."""
    if dim is None:
        return t.detach().clone()
    n = t.shape[dim] // k
    return t.detach().narrow(dim, rank * n, n).contiguous()


def _gather(pieces: Sequence[Tuple[torch.Tensor, Optional[int], Tuple[int, ...]]], group: RaysGroup
            ) -> List[torch.Tensor]:
    """Whole tensors from this rank's pieces ``(piece, dim, whole shape)``:
    one all-reduce of zero-filled buffers, each rank's piece at its slice
    (exact); a piece with no dimension cut is whole already."""
    cut = [(t, d, s) for t, d, s in pieces if d is not None]
    outs: Dict[int, torch.Tensor] = {}
    if cut:
        sizes = [math.prod(s) for _, _, s in cut]
        flat = torch.zeros(sum(sizes), dtype=cut[0][0].dtype, device=cut[0][0].device)
        for (t, d, s), buf in zip(cut, flat.split(sizes)):
            n = t.shape[d]
            buf.view(s).narrow(d, group.rank * n, n).copy_(t.detach())
        group.all_reduce_(flat)
        it = iter(buf.view(s) for (_, _, s), buf in zip(cut, flat.split(sizes)))
        outs = {j: next(it) for j, (_, d, _) in enumerate(pieces) if d is not None}
    return [outs[j] if d is not None else t.detach().clone() for j, (t, d, _) in enumerate(pieces)]


@torch.no_grad()
def shard_field_(field: nn.Module, specs: Dict[str, str], group: RaysGroup) -> None:
    """Replace each column and row layer of a whole ``field`` (plain route)
    by this rank's :class:`ColumnLinear` / :class:`RowLinear`, in place:
    the parameters keep their names and their order."""
    if any(getattr(field, a, False) for a in ("fused", "fused_time", "fused_trunk")):
        raise ValueError("tensor parallelism cuts the fields on their plain route: build them with fused=False "
                         "(the field kernels read whole weights)")
    k, m = group.world, group.rank
    for name, kind in specs.items():
        if kind == REPLICATED:
            continue
        lyr = field.get_submodule(name)
        wd, bd = _CUTS[kind]
        cls = ColumnLinear if kind == COLUMN else RowLinear
        new = cls(_take(lyr.weight, wd, m, k), _take(lyr.bias, bd, m, k), lyr.in_features, lyr.out_features, group)
        parent, _, child = name.rpartition(".")
        setattr(field.get_submodule(parent) if parent else field, child, new)


@torch.no_grad()
def shard_train_state(mesh: TensorMesh, state) -> Dict[str, Optional[Dict[str, str]]]:
    """Cut ``state``'s whole fields into this rank's shards
    (:func:`shard_field_`) and its Adam moments with them: a new optimizer
    of the same kind (the card's fused, capturable Adam reads the state's
    device learning rate) over the shards, each moment cut like its
    parameter, the update counts kept. Returns the assignment of each
    field (``{"coarse": ..., "fine": ... or None}``)."""
    from swnerf_torch.train.loop import make_optimizer

    group = mesh.model
    old = [p for m in state.modules() for p in m.parameters()]
    specs = {}
    for key, field in (("coarse", state.coarse), ("fine", state.fine)):
        specs[key] = None if field is None else mlp_param_specs(field, group.world)
        if field is not None:
            shard_field_(field, specs[key], group)
    new = [p for m in state.modules() for p in m.parameters()]
    opt = make_optimizer(state.modules(), state.lr if state.count is not None else
                         state.optimizer.param_groups[0]["lr"])
    for p, q, dim in zip(old, new, _param_dims(state.modules())):
        st = state.optimizer.state.get(p)
        if st:
            opt.state[q] = {k: _take(v, dim, group.rank, group.world) if k in ("exp_avg", "exp_avg_sq") else
                            v.clone() if isinstance(v, torch.Tensor) else v for k, v in st.items()}
    opt.register_load_state_dict_post_hook(state._loaded)
    state.optimizer = opt
    return specs


def gathered(group: RaysGroup, modules: Dict[str, nn.Module], grads: bool = False) -> Dict[str, torch.Tensor]:
    """The whole value (with ``grads``, the whole gradient) of every
    parameter of ``modules``, keyed ``"<key>.<name>"`` (``"<name>"`` for
    the key ``""``): one all-reduce over the model ``group``."""
    pieces, keys = [], []
    for key, module in modules.items():
        for (name, p), dim in zip(module.named_parameters(), _param_dims([module])):
            lyr = module.get_submodule(name.rpartition(".")[0])
            shape = (lyr.out_features, lyr.in_features) if name.endswith("weight") else (lyr.out_features,)
            pieces.append((p.grad if grads else p, dim, shape))
            keys.append(f"{key}.{name}" if key else name)
    return dict(zip(keys, _gather(pieces, group)))


def _whole_field(field: nn.Module, group: RaysGroup, fused: Optional[bool]) -> nn.Module:
    """A whole field of ``field``'s class and config (built on its device,
    from a fixed generator, then overwritten) holding the shards' values."""
    device = next(field.parameters()).device
    whole = type(field)(field.cfg, device=device, generator=torch.Generator().manual_seed(0), fused=fused)
    whole.load_state_dict(gathered(group, {"": field}))
    return whole


def local_bytes(state) -> int:
    """The bytes of parameters and Adam moments that this rank holds."""
    n = 0
    for p in (p for m in state.modules() for p in m.parameters()):
        st = state.optimizer.state.get(p, {})
        n += sum(t.numel() * t.element_size() for t in [p] + [st[k] for k in ("exp_avg", "exp_avg_sq") if k in st])
    return n


def expected_local_bytes(specs: Dict[str, Optional[Dict[str, str]]], state, n_model: int, moments: bool = True
                         ) -> int:
    """What :func:`local_bytes` should read by the assignment alone: each
    layer's :func:`shard_numel` in fp32, times 3 with Adam's two moments."""
    n = 0
    for key, field in (("coarse", state.coarse), ("fine", state.fine)):
        if field is None:
            continue
        for name, kind in specs[key].items():
            n += shard_numel(kind, *_dims(field.get_submodule(name)), n_model)
    return n * 4 * (3 if moments else 1)


def render_fields(mesh: Optional[TensorMesh], state) -> Tuple[nn.Module, Optional[nn.Module]]:
    """The fields a render reads: the state's own without a grid, else whole
    fields gathered once for the call, on the kernel route (the test
    renders' eval passes and B7 take whole weights)."""
    if mesh is None:
        return state.coarse, state.fine
    coarse, fine = mesh.whole_modules([state.coarse, state.fine])
    return coarse, fine


def checkpoint_state(mesh: Optional[TensorMesh], state):
    """The state a checkpoint writes: the state itself without a grid, else
    its whole fields and moments (:meth:`TensorMesh.whole_state`), which
    every rank gathers and rank 0 writes."""
    return state if mesh is None else mesh.whole_state(state)
