from confignet_tpu_torch.parallel.mesh import (
    Mesh,
    create_mesh,
    shard_batch,
    process_slice,
    replicate,
    maybe_initialize_distributed,
    all_reduce_mean,
    all_reduce_sum,
    all_gather_rows,
)

__all__ = [
    "Mesh",
    "create_mesh",
    "shard_batch",
    "process_slice",
    "replicate",
    "maybe_initialize_distributed",
    "all_reduce_mean",
    "all_reduce_sum",
    "all_gather_rows",
]
