"""Multi-process support: the launch, the process roles and the rows each
rank takes (port of ``swnerf_tpu/parallel/multihost.py``).

The port runs one process per card (the JAX package runs one per host).
Every rank loads the (small) image set and runs the SAME seeded numpy
ray/pixel sampler, so all ranks agree on each step's global batch without
any traffic, and hand that batch to the step; a step built with a group
trains on this rank's rows of it (:func:`host_shard_bounds`, through
``parallel/mesh.py::batch_rows``: the JAX package's ``wrap_feeder``, which
assembles each process's shards into a global array, has no counterpart
to do). The gradients are summed by one all-reduce a step
(``parallel/mesh.py``). NeRF datasets are a few
hundred images, so replicated image loading beats a sharded input pipeline
in both simplicity and bytes moved (zero per step).

Checkpoints, videos, test sets and log files are written by rank 0 only
(:func:`is_primary`); every rank computes. With no process group every
helper is a no-op or returns the whole range, so a single-process run is
bit-identical to one without this module.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

__all__ = [
    "host_fold",
    "host_shard_bounds",
    "initialize_from_env",
    "is_primary",
    "process_count",
    "process_index",
]

# How long a rank waits for the others at start-up and in a collective.
TIMEOUT = datetime.timedelta(seconds=600)


def initialize_from_env(device: Union[str, torch.device, None] = None) -> bool:
    """Join the run's process group, if the launch describes one.

    Reads the JAX package's ``SWNERF_COORDINATOR`` (``host:port``, or a
    ``file://`` path on a file system every rank sees), ``SWNERF_NUM_PROCESSES``
    and ``SWNERF_PROCESS_ID``; else ``torchrun``'s ``RANK`` / ``WORLD_SIZE``
    (with ``MASTER_ADDR`` / ``MASTER_PORT``: ``env://``). The backend is
    ``nccl`` for a CUDA ``device`` (None means ``cuda``, as
    ``device.resolve_device``) and ``gloo`` on the CPU; a CUDA rank binds
    card ``LOCAL_RANK`` (else ``rank % device_count``) before any tensor
    lives there. Call it before the first device query.

    A no-op when nothing is set, and when a group already exists: a caller
    may bring its own (gloo ranks sharing one card, for instance). A failed
    initialisation raises. Returns True when it created the group."""
    if dist.is_initialized():
        return False
    coord = os.environ.get("SWNERF_COORDINATOR", "")
    if coord:
        init = coord if "://" in coord else f"tcp://{coord}"
        world = int(os.environ.get("SWNERF_NUM_PROCESSES", "1"))
        rank = int(os.environ.get("SWNERF_PROCESS_ID", "0"))
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        init, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        return False
    cuda = torch.device("cuda" if device is None else device).type == "cuda"
    if cuda:
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None else rank % torch.cuda.device_count())
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init, world_size=world, rank=rank,
                            timeout=TIMEOUT)
    return True


def process_index() -> int:
    """This process's rank; 0 with no process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes in the run; 1 with no process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that owns the files (checkpoints, videos, test
    sets, metrics and log files): rank 0. Always True single-process."""
    return process_index() == 0


def host_fold(seed: int, index: Optional[int] = None) -> int:
    """A per-rank generator seed: ``seed`` on rank 0, a distinct seed for
    each other rank (the JAX package's ``fold_in(rng, process_index)``).

    For randomness that must DIFFER across ranks; the training batch and its
    draws deliberately do not use it (every rank draws the global batch)."""
    if index is None:
        index = process_index()
    if index == 0:
        return int(seed)
    return (int(seed) + index * 0x9E3779B97F4A7C15) % (1 << 63)


def host_shard_bounds(n: int, index: Optional[int] = None, count: Optional[int] = None) -> tuple:
    """Contiguous ``[lo, hi)`` rows of an n-row resource assigned to a rank
    (the remainder spread over the first ``n % count`` ranks): the JAX
    package's bounds for every ``(n, index, count)``."""
    if index is None:
        index = process_index()
    if count is None:
        count = process_count()
    base, rem = divmod(n, count)
    lo = index * base + min(index, rem)
    return lo, lo + base + (1 if index < rem else 0)
