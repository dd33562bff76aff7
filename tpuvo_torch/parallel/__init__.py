"""The sharded layer over ``torch.distributed`` (twin of ``tpuvo/parallel``)."""

from tpuvo_torch.parallel.mesh import local_mesh, maybe_distributed_init
from tpuvo_torch.parallel.match_sharded import sharded_match_descriptors
from tpuvo_torch.parallel.ba_sharded import shard_ba_problem, sharded_ba_solve, sharded_ba_step
from tpuvo_torch.parallel.posegraph_sharded import shard_edges, sharded_pgo_solve

__all__ = [
    "local_mesh",
    "maybe_distributed_init",
    "sharded_match_descriptors",
    "shard_ba_problem",
    "sharded_ba_solve",
    "sharded_ba_step",
    "shard_edges",
    "sharded_pgo_solve",
]
