"""Multi-device proving (port of the JAX reference's dist/): meshes of torch
devices, and the NTT, MSMs and grand-product scan sharded over them."""

from .mesh import (ROW_AXIS, Mesh, all_gather, all_to_all, gather_rows,
                   make_mesh, replicate, shard_columns, shard_rows)
from .msm import ShardedCachedMSM, sharded_msm
from .ntt import ShardedNTT
from .scan import sharded_prefix_product

__all__ = ["make_mesh", "shard_columns", "shard_rows", "replicate",
           "ROW_AXIS", "sharded_msm", "ShardedCachedMSM", "ShardedNTT",
           "sharded_prefix_product", "Mesh", "all_gather", "all_to_all",
           "gather_rows"]
