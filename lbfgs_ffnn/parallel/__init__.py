from lbfgs_ffnn.parallel.mesh import make_mesh, distributed_init
from lbfgs_ffnn.parallel.shard import (
    shard_batch,
    replicate,
    data_parallel_batch_problem,
    data_parallel_problem,
)

__all__ = [
    "make_mesh",
    "distributed_init",
    "shard_batch",
    "replicate",
    "data_parallel_batch_problem",
    "data_parallel_problem",
]
