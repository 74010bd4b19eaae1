"""The reference's ``localmd.decomposition`` names (counterpart of
localmd_tpu/decomposition.py): the per-block functions of
:mod:`localmd_tpu_torch.compat` and the port's own implementations under
their reference names."""

from localmd_tpu_torch.compat import (
    decomposition_no_normalize_approx,
    get_temporal_projector,
    rank_simulation,
    single_block_md,
    single_residual_block_md,
    truncated_random_svd_ref as truncated_random_svd,
    windowed_pmd,
)
from localmd_tpu_torch.engine import identity, threshold_heuristic
from localmd_tpu_torch.factorization import (
    aggregate_local_and_global_decomposition,
    compute_lowrank_factorized_svd,
)
from localmd_tpu_torch.ops.linalg import (
    projected_svd,
    svd_gram_left as fewer_rows_svd_routine,
    svd_gram_right as fewer_columns_svd_routine,
)
from localmd_tpu_torch.ops.pooling import downsample_average_pooling
from localmd_tpu_torch.ops.roughness import construct_final_fitness_decision, filter_by_failures
from localmd_tpu_torch.ops.tiling import check_fov_size, update_block_sizes
from localmd_tpu_torch.pipeline import identify_window_chunks, localmd_decomposition
from localmd_tpu_torch.utils import display
from localmd_tpu_torch.utils.keys import make_jax_random_key

__all__ = [
    "localmd_decomposition",
    "single_block_md",
    "single_residual_block_md",
    "windowed_pmd",
    "rank_simulation",
    "decomposition_no_normalize_approx",
    "get_temporal_projector",
    "downsample_average_pooling",
    "threshold_heuristic",
    "truncated_random_svd",
    "compute_lowrank_factorized_svd",
    "projected_svd",
    "construct_final_fitness_decision",
    "filter_by_failures",
    "identify_window_chunks",
    "update_block_sizes",
    "check_fov_size",
    "make_jax_random_key",
    "identity",
    "display",
    "aggregate_local_and_global_decomposition",
    "fewer_rows_svd_routine",
    "fewer_columns_svd_routine",
]
