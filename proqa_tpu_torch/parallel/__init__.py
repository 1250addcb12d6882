"""Multi-device execution: device lists, row sharding and the sharded corpus
search (one process over several devices), and data-parallel training over
torch.distributed (one process per device).

Counterpart of proqa_tpu/parallel, whose single `data` mesh axis carries both
the row-sharded corpus and the data-parallel batch.
"""

from proqa_tpu_torch.parallel.mesh import (
    DATA_AXIS, host_device_count, make_mesh, replicate, shard_rows,
)
from proqa_tpu_torch.parallel.search import sharded_matvec_stats, sharded_mips_topk

__all__ = [
    "DATA_AXIS",
    "host_device_count",
    "make_mesh",
    "replicate",
    "shard_rows",
    "sharded_matvec_stats",
    "sharded_mips_topk",
]
