"""Data parallelism — the port of color_transfer_tpu/parallel (``mesh``,
``multihost``) on ``torch.distributed`` and device lists.

  * ``multihost``: one process per card under torchrun — the process
    group, this process's card and its rows of each global batch.
  * ``mesh``: one process over a list of devices (serving): the split of a
    chunk, the copies of the variables.
  * ``data_parallel``: the collectives of a data-parallel train step
    (gradient and log averages, global-batch BatchNorm statistics).
"""

from color_transfer_tpu_torch.parallel.mesh import (
    create_mesh,
    pad_to_devices,
    replicate,
    shard_batch,
)
from color_transfer_tpu_torch.parallel.multihost import (
    host_batch_slice,
    initialize_distributed,
    rank_world,
)

__all__ = ["create_mesh", "pad_to_devices", "replicate", "shard_batch",
           "host_batch_slice", "initialize_distributed", "rank_world"]
