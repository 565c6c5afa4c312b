from .mesh import (Mesh, make_mesh, shard_batch_arrays, shard_region_batch,
                   sharded_train_prescribe_step)

__all__ = ["Mesh", "make_mesh", "shard_batch_arrays", "shard_region_batch",
           "sharded_train_prescribe_step"]
