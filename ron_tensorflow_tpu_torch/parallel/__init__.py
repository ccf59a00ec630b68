"""Distribution over torch.distributed: the (data, model) mesh and its
sharding rules (`mesh`), process-group init and batch placement
(`multihost`), and the autograd-aware collectives the sharded step calls
(`collectives`)."""

from .mesh import (
    Mesh,
    make_mesh,
    partition_batch,
    partition_batch_stats,
    partition_opt_state,
    partition_params,
    partition_rules,
    sharded_names,
)
from .multihost import (
    GlobalBatch,
    batch_rows,
    host_local_to_global,
    host_tree_to_global,
    initialize_distributed,
    local_device,
    process_info,
    take_rows,
)
