"""Data and spatial parallelism on torch.distributed (counterpart of
bsvd_tpu/parallel/)."""

from bsvd_tpu_torch.parallel.mesh import (batch_sharding, make_mesh,
                                          replicated_sharding, shard_batch)
