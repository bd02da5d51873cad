"""Multi-rank execution on ``torch.distributed``: device meshes and
``DTensor`` placements (``mesh``), process-group wiring (``multihost``)
and the row-sharded rescan engine with K1 on every rank
(``sharded_rescan``), with the JAX package's public names."""

from rescan_line_sted_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    replicate,
    replicated_sharding,
    shard_batch,
)
from rescan_line_sted_torch.parallel.multihost import (
    initialize_multihost,
    is_initialized,
    local_device_slice,
)
from rescan_line_sted_torch.parallel.sharded_rescan import (
    rescanned_line_sted_sharded,
)

__all__ = ["batch_sharding", "initialize_multihost", "is_initialized",
           "local_device_slice", "make_mesh", "replicate",
           "replicated_sharding", "rescanned_line_sted_sharded",
           "shard_batch"]
