"""Data parallelism over ranks (port of ``swnerf_tpu/parallel``'s ``mesh``
and ``multihost``): one process per card, each step's ray batch split by
rows, the gradients summed by one all-reduce a step. The JAX package's
names are kept where the meaning carries over; its ``shard_cli_step``,
``shard_map_train_step`` and ``wrap_feeder`` become the steps' ``group``
argument (each step takes its rows of the global batch and reduces
itself), and its tensor parallelism (``parallel/tensor.py``) is not
ported yet."""

from swnerf_torch.parallel.mesh import (
    RAYS_AXIS,
    RaysGroup,
    Rows,
    StepReducer,
    all_reduce_rows,
    batch_rows,
    check_dispatch,
    data_parallel_mesh,
    make_mesh,
    reducer_for,
    replicate,
)
from swnerf_torch.parallel.multihost import (
    host_fold,
    host_shard_bounds,
    initialize_from_env,
    is_primary,
    process_count,
    process_index,
)

__all__ = [
    "RAYS_AXIS",
    "RaysGroup",
    "Rows",
    "StepReducer",
    "all_reduce_rows",
    "batch_rows",
    "check_dispatch",
    "data_parallel_mesh",
    "host_fold",
    "host_shard_bounds",
    "initialize_from_env",
    "is_primary",
    "make_mesh",
    "process_count",
    "process_index",
    "reducer_for",
    "replicate",
]
