from kmertools_jax.parallel.mesh import make_mesh, shard_batch
from kmertools_jax.parallel.ops import (
    distributed_dense_count,
    distributed_oligo_step,
    sharded_accum_count,
)

__all__ = [
    "make_mesh",
    "shard_batch",
    "distributed_dense_count",
    "distributed_oligo_step",
    "sharded_accum_count",
]
