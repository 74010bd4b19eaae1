"""The mesh path on ``torch.distributed`` (counterpart of
localmd_tpu/parallel/): ``make_mesh`` builds the 1-D mesh over every rank,
``sharded`` splits the block stage and the V regression over it, and
``multihost`` holds the collectives and the per-rank stripes."""

from localmd_tpu_torch.parallel.mesh import block_sharding, frame_sharding, make_mesh
from localmd_tpu_torch.parallel.sharded import (
    sharded_block_decomposition,
    sharded_gram_quadratic,
    sharded_v_projection_chunk,
)

__all__ = [
    "make_mesh",
    "block_sharding",
    "frame_sharding",
    "sharded_block_decomposition",
    "sharded_v_projection_chunk",
    "sharded_gram_quadratic",
]
