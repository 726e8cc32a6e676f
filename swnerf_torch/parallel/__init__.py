"""Data parallelism over ranks (port of ``swnerf_tpu/parallel``'s ``mesh``
and ``multihost``): one process per card, each step's ray batch split by
rows, the gradients summed by one all-reduce a step. The JAX package's
names are kept where the meaning carries over; its ``shard_cli_step``,
``shard_map_train_step`` and ``wrap_feeder`` become the steps' ``group``
argument (each step takes its rows of the global batch and reduces
itself). Tensor parallelism (``SWNERF_TENSOR_PARALLEL=k``,
``parallel/tensor.py``) adds a ``model`` axis: a ``(rays, model)`` grid of
ranks, each field's layers cut into column and row shards whose
collectives run over the model group, the batch rows and the gradient sum
over the rays group, checkpoints and renders gathered. The trainers make
the choice through one call, ``parallel_setup``."""

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
from swnerf_torch.parallel.tensor import (
    MODEL_AXIS,
    Parallel,
    TensorMesh,
    checkpoint_state,
    field_route,
    make_mesh_2d,
    mlp_param_specs,
    parallel_setup,
    render_fields,
    tensor_parallel_degree,
    tensor_parallel_setup,
    tensor_parallel_setup_multires,
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
    "MODEL_AXIS",
    "Parallel",
    "RAYS_AXIS",
    "RaysGroup",
    "Rows",
    "StepReducer",
    "TensorMesh",
    "all_reduce_rows",
    "batch_rows",
    "check_dispatch",
    "checkpoint_state",
    "data_parallel_mesh",
    "field_route",
    "host_fold",
    "host_shard_bounds",
    "initialize_from_env",
    "is_primary",
    "make_mesh",
    "make_mesh_2d",
    "mlp_param_specs",
    "parallel_setup",
    "process_count",
    "process_index",
    "reducer_for",
    "render_fields",
    "replicate",
    "tensor_parallel_degree",
    "tensor_parallel_setup",
    "tensor_parallel_setup_multires",
]
