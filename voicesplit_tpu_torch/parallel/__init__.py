"""Data parallelism over `torch.distributed` (counterpart of
`voicesplit_tpu/parallel/`): the rank mesh, process-group start-up, batch
placement and replicated training state."""

from voicesplit_tpu_torch.parallel.mesh import (
    Mesh,
    initialize_distributed,
    local_batch_size,
    make_mesh,
)
from voicesplit_tpu_torch.parallel.sharding import (
    batch_sharding,
    param_partition_spec,
    put_batch,
    shard_train_state,
)
