"""Data parallelism over ``torch.distributed``: the mesh, sharding and
multi-process launch utilities."""

from nerf_fewshot_tpu_torch.parallel.mesh import (
    data_parallel_train_step,
    initialize_multihost,
    make_global_batch,
    make_mesh,
    process_local_slice,
    replicate,
    shard_batch,
)

__all__ = [
    "make_mesh",
    "shard_batch",
    "replicate",
    "data_parallel_train_step",
    "initialize_multihost",
    "make_global_batch",
    "process_local_slice",
]
