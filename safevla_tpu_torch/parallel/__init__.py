from safevla_tpu_torch.parallel.mesh import (
    make_mesh,
    batch_sharding,
    replicated_sharding,
    shard_batch,
)

__all__ = ["make_mesh", "batch_sharding", "replicated_sharding", "shard_batch"]
