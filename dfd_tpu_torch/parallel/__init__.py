from dfd_tpu_torch.parallel.collectives import (all_sum, gather_members, gather_results,
                                                shard_map_combine)
from dfd_tpu_torch.parallel.mesh import (PopMesh, initialize_multihost, make_pop_mesh,
                                         pop_sharding, replicated)

__all__ = [
    "PopMesh",
    "make_pop_mesh",
    "pop_sharding",
    "replicated",
    "initialize_multihost",
    "shard_map_combine",
    "gather_members",
    "gather_results",
    "all_sum",
]
