"""Data and sequence parallelism over `torch.distributed` (counterpart of
`voicesplit_tpu/parallel/`): the rank mesh, process-group start-up, batch
placement and replicated training state; long-form separation with the time
axis sharded over the ranks (`sequence.py`)."""

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
from voicesplit_tpu_torch.parallel.sequence import (
    make_seq_mesh,
    make_sp_mask_fn,
    pad_frames,
    separate_long,
)
