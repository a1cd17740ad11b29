"""The parallel layer: the process mesh and its collectives
(``mesh``), the partition rules and placement (``sharding``) and sharded
serving (``serve_tp``), over ``torch.distributed``."""
from tsue_tpu_torch.parallel.mesh import (Mesh, barrier, initialize_distributed,
                                          is_primary, make_mesh, shard_batch)

__all__ = ["Mesh", "barrier", "initialize_distributed", "is_primary",
           "make_mesh", "shard_batch"]
