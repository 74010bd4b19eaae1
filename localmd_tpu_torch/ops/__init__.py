"""The port's array primitives under the names ``localmd_tpu.ops`` exports
(localmd_tpu/ops/__init__.py). ``jacobi_eigh`` is K4's route: the CUDA
kernel on a card tensor, its plain twin on a CPU tensor."""

from localmd_tpu_torch.ops.kernels import jacobi_eigh
from localmd_tpu_torch.ops.linalg import (
    batched_truncated_random_svd,
    eigh_descending,
    projected_svd,
    svd_gram_left,
    svd_gram_right,
    truncated_random_svd,
)
from localmd_tpu_torch.ops.noise import (
    center,
    center_and_get_noise_estimate,
    center_and_noise_normalize,
    get_mean_and_noise,
    standardize_block,
    welch_noise_estimate,
)
from localmd_tpu_torch.ops.pooling import downsample_average_pooling
from localmd_tpu_torch.ops.roughness import (
    evaluate_fitness,
    filter_by_failures,
    filter_by_failures_np,
    l1_norm,
    spatial_roughness_stat,
    temporal_roughness_stat,
    total_variation_stat,
    trend_filter_stat,
)

__all__ = [
    "truncated_random_svd",
    "batched_truncated_random_svd",
    "svd_gram_left",
    "svd_gram_right",
    "projected_svd",
    "eigh_descending",
    "jacobi_eigh",
    "welch_noise_estimate",
    "get_mean_and_noise",
    "spatial_roughness_stat",
    "temporal_roughness_stat",
    "evaluate_fitness",
    "filter_by_failures",
    "filter_by_failures_np",
    "downsample_average_pooling",
    "center",
    "center_and_noise_normalize",
    "standardize_block",
    "center_and_get_noise_estimate",
    "l1_norm",
    "trend_filter_stat",
    "total_variation_stat",
]
