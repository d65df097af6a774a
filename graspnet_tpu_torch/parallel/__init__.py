"""Device meshes, parallel inference and the multi-process runtime."""

from graspnet_tpu_torch.parallel.candidate import candidate_sharded_infer, data_parallel_infer
from graspnet_tpu_torch.parallel.distributed import global_mesh, process_local_batch_slice
from graspnet_tpu_torch.parallel.distributed import initialize as distributed_initialize
from graspnet_tpu_torch.parallel.mesh import Mesh, make_mesh, replicate, shard_batch

__all__ = [
    "Mesh",
    "make_mesh",
    "shard_batch",
    "replicate",
    "candidate_sharded_infer",
    "data_parallel_infer",
    "distributed_initialize",
    "global_mesh",
    "process_local_batch_slice",
]
