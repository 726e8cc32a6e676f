"""Ray-sharded data parallelism over ranks (port of
``swnerf_tpu/parallel/mesh.py``).

The JAX package shards each step's ray batch over a 1-D ``rays`` device
mesh and lets XLA insert the gradient ``psum`` (``shard_map`` + ``pmean``
around its kernel steps). The port runs one process per card, and a
:class:`RaysGroup` stands for the mesh: its world size, this process's rank
and the rows of a batch each rank holds (:meth:`RaysGroup.rows`). The
parameters and Adam state are replicated (:func:`replicate` broadcasts rank
0's once at start-up and after every resume); each rank renders its rows of
the global batch, scaled as pieces of the global mean; and a
:class:`StepReducer` sums, after the backward and before Adam, every
gradient and the step's loss terms in ONE flat buffer with ONE
``all_reduce`` a step, which a CUDA graph of the step captures under NCCL.
Because the pieces carry the global scale, the sum is the global-batch
gradient also when the rows do not split evenly.

Every collective is an ``all_reduce`` (SUM) or a ``broadcast``: the two
operations that NCCL, gloo on the CPU and gloo on CUDA tensors all take.
Nothing is caught: a collective that fails raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from swnerf_torch.parallel.multihost import host_shard_bounds

RAYS_AXIS = "rays"


class Rows(NamedTuple):
    """Rows ``[lo, hi)`` of a global batch of ``total`` rows: what one rank
    holds."""

    lo: int
    hi: int
    total: int

    @property
    def n(self) -> int:
        return self.hi - self.lo

    def take(self, x):
        """``x``'s rows (numpy, torch, or a list; None passes)."""
        return None if x is None else x[self.lo : self.hi]

    def take_fields(self, t):
        """A NamedTuple of row-major tensors (``render.core.Rays``,
        ``Draws``; None fields pass) cut to these rows."""
        return type(t)(*(self.take(x) for x in t))


@dataclasses.dataclass(eq=False)
class RaysGroup:
    """The ``rays`` mesh of the port: ``world`` ranks of ``pg`` (None: the
    default process group), this one ``rank``, on ``backend``."""

    rank: int
    world: int
    backend: str
    pg: Optional[object] = None

    def rows(self, n: int) -> Rows:
        """This rank's rows of an n-row batch (``host_shard_bounds``)."""
        lo, hi = host_shard_bounds(n, self.rank, self.world)
        return Rows(lo, hi, n)

    def all_reduce_(self, buf: torch.Tensor) -> torch.Tensor:
        """Sum ``buf`` over the ranks in place; returns it."""
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.pg)
        return buf

    def broadcast_(self, buf: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``buf`` from rank ``src`` of this group on every rank, in place;
        returns it."""
        dist.broadcast(buf, src=src if self.pg is None else dist.get_global_rank(self.pg, src), group=self.pg)
        return buf


def batch_rows(group: Optional[RaysGroup], n: int) -> Rows:
    """The rows of an n-row global batch that a step built with ``group``
    trains on: this rank's, or all of them without a group."""
    return Rows(0, n, n) if group is None else group.rows(n)


def make_mesh(pg=None) -> RaysGroup:
    """The group over every process of ``pg`` (None: the default group),
    which must be initialised."""
    return RaysGroup(dist.get_rank(pg), dist.get_world_size(pg), dist.get_backend(pg), pg)


def data_parallel_mesh(batch_size: int = 0, quiet: bool = False) -> Optional[RaysGroup]:
    """The trainers' policy: a group over the run's processes when it was
    launched as a world (``multihost.initialize_from_env``, or a group the
    caller brought), else None: a process that joined no world has no group
    and runs no collective. ``SWNERF_DATA_PARALLEL=0`` opts out (each
    process then trains alone). A world of one process keeps its group: its
    reduction is exact, so it is bit-equal to no group.

    The launch fixes the world (one process per card), so where the JAX
    package caps its mesh at ``SWNERF_MESH_DEVICES`` a larger world refuses,
    as does a ``batch_size`` (the step's rays) smaller than the world: no
    rank is left idle. Batches that do not divide evenly are exact (the
    pieces carry the global scale)."""
    if os.environ.get("SWNERF_DATA_PARALLEL", "1") == "0":
        return None
    if not (dist.is_available() and dist.is_initialized()):
        return None
    group = make_mesh()
    limit = int(os.environ.get("SWNERF_MESH_DEVICES", "0") or 0)
    if limit and group.world > limit:
        raise ValueError(f"SWNERF_MESH_DEVICES={limit} is below the world of {group.world} processes; the launch "
                         "fixes the world (one process per card): launch fewer processes or raise the cap")
    if batch_size and batch_size < group.world:
        raise ValueError(f"N_rand={batch_size} rays cannot be sharded over {group.world} ranks: every rank needs "
                         "at least one row")
    if not quiet:
        print(f"Data parallelism: sharding rays over {group.world} ranks ({group.backend})", flush=True)
    return group


def check_dispatch(group: Optional[RaysGroup], device, k: int) -> None:
    """Refuse what cannot run: gloo collectives cannot be captured in a CUDA
    graph, so a gloo group on a card needs one step a dispatch."""
    if group is not None and group.backend == "gloo" and torch.device(device).type == "cuda" and k > 1:
        raise ValueError(f"SWNERF_STEPS_PER_DISPATCH={k} captures the step in a CUDA graph, which cannot hold a "
                         "gloo collective: use the nccl backend, or SWNERF_STEPS_PER_DISPATCH=1 under gloo")


def _adam_moments(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    out = []
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            out += [st[k] for k in ("exp_avg", "exp_avg_sq") if k in st]
    return out


@torch.no_grad()
def replicate(group: Optional[RaysGroup], states) -> None:
    """Broadcast rank 0's parameters and Adam moments to every rank of
    ``group`` (one flat buffer, one ``broadcast``), so that the ranks cannot
    start apart: at start-up and after any resume or auto-reseed. Under
    tensor parallelism ``group`` is the rays group of a model rank
    (``parallel/tensor.py``), whose rank 0 holds the same shards. ``states``
    is a ``TrainState`` or a list of them (MultiRes's levels). No-op without
    a group.

    The ranks must have resumed alike (every rank reads rank 0's files, on
    a file system they share): a rank whose update counts, or whose number
    or size of tensors, differ from rank 0's raises before the broadcast."""
    if group is None:
        return
    if not isinstance(states, (list, tuple)):
        states = [states]
    tensors = []
    for st in states:
        tensors += [p for m in st.modules() for p in m.parameters()] + _adam_moments(st.optimizer)
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    layout = torch.tensor([len(tensors), flat.numel()] + [st.step for st in states], device=flat.device)
    ref = group.broadcast_(layout.clone())
    if not torch.equal(ref, layout):
        raise RuntimeError(f"rank {group.rank} resumed {layout.tolist()} (tensors, values, update counts) where rank "
                           f"0 resumed {ref.tolist()}: every rank must read rank 0's checkpoint")
    group.broadcast_(flat)
    for t, piece in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(piece.view_as(t))


class StepReducer:
    """The step's reduction (the JAX steps' ``axis_name`` / ``pmean``):
    :meth:`__call__` gathers every parameter gradient and the step's loss
    terms into one flat buffer, sums it over the ranks with ONE
    ``all_reduce``, and leaves each gradient as a view of the sum (Adam
    reads it there: no copy back). The buffer is allocated once per layout,
    so its address is static for a CUDA-graph capture of the step."""

    def __init__(self, group: RaysGroup):
        self.group = group
        self._bufs: Dict[Tuple, torch.Tensor] = {}

    def __call__(self, params: Sequence[torch.Tensor], terms: Sequence[torch.Tensor] = ()) -> List[torch.Tensor]:
        """Sum the ``.grad`` of ``params`` (those that have one; the ranks
        run the same code, so the same ones) and ``terms`` (0-d) over the
        ranks. Returns the summed terms."""
        params = [p for p in params if p.grad is not None]
        grads = [p.grad.reshape(-1) for p in params]
        lead = grads[0] if grads else terms[0]
        sizes = [g.numel() for g in grads]
        key = (tuple(sizes), len(terms), lead.dtype, lead.device)
        buf = self._bufs.get(key)
        if buf is None:
            buf = self._bufs[key] = torch.empty(sum(sizes) + len(terms), dtype=lead.dtype, device=lead.device)
        torch.cat(grads + [t.detach().reshape(1).to(lead.dtype) for t in terms], out=buf)
        self.group.all_reduce_(buf)
        for p, g in zip(params, buf.split(sizes + [len(terms)])):
            p.grad = g.view_as(p)
        summed = buf[sum(sizes):].clone()
        return [summed[j].to(t.dtype) for j, t in enumerate(terms)]


def reducer_for(group: Optional[RaysGroup]) -> Optional[StepReducer]:
    """A :class:`StepReducer` for ``group``; None without one."""
    return None if group is None else StepReducer(group)


def all_reduce_rows(group: RaysGroup, pieces: Sequence[torch.Tensor], rows: Sequence[Rows]) -> List[torch.Tensor]:
    """Assemble row-sharded results: each rank's ``pieces[k]`` holds rows
    ``rows[k]`` of a result; they are written into zero-filled buffers of
    the whole results (one flat buffer) and summed with one ``all_reduce``.
    The pieces are disjoint, so the sum is exact: each row is bit-equal to
    the rank's that computed it. Returns the whole results."""
    shapes = [(r.total,) + tuple(p.shape[1:]) for p, r in zip(pieces, rows)]
    sizes = [int(np.prod(s)) for s in shapes]
    flat = torch.zeros(sum(sizes), dtype=pieces[0].dtype, device=pieces[0].device)
    outs = [x.view(s) for x, s in zip(flat.split(sizes), shapes)]
    for out, p, r in zip(outs, pieces, rows):
        out[r.lo : r.hi] = p.detach().to(out.dtype)
    group.all_reduce_(flat)
    return outs
