"""Process group, mesh, sharding rules and collectives for training and
serving on several devices."""

from clipa_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_rows,
    batch_shard,
    create_mesh,
    fsdp_shardings,
    init_distributed,
    local_batch_to_global,
)
