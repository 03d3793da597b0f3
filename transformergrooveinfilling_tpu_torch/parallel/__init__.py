"""Multi-GPU and multi-process training on ``torch.distributed``, as the JAX
package's ``parallel`` package: data parallelism over a ``("data",
"model")`` mesh with tensor parallelism on "model" (``mesh.py``,
``tensor.py``), the GPipe pipeline over ``("data", "pipe"[, "model"])``
(``pipeline.py``), the process group from the environment
(``multihost.py``), and the backend rule and transport every collective
goes through (``comm.py``)."""

from .pipeline import (
    PipelinePlan,
    make_pipeline_mesh,
    make_pipeline_train_step,
    merge_encoder_params,
    pipeline_forward,
    split_encoder_params,
)
from .multihost import (
    initialize_from_env,
    is_main_process,
    global_mesh,
    local_batch_slice,
)
from .mesh import (
    make_mesh,
    data_sharding,
    replicated,
    param_partition_specs,
    shard_params,
    MeshPlan,
)

__all__ = [
    "make_mesh",
    "data_sharding",
    "replicated",
    "param_partition_specs",
    "shard_params",
    "MeshPlan",
    "initialize_from_env",
    "is_main_process",
    "global_mesh",
    "local_batch_slice",
    "PipelinePlan",
    "make_pipeline_mesh",
    "make_pipeline_train_step",
    "merge_encoder_params",
    "pipeline_forward",
    "split_encoder_params",
]
