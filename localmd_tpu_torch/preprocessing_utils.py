"""The reference's ``preprocessing_utils`` names over :mod:`localmd_tpu_torch.ops.noise`
(counterpart of localmd_tpu/preprocessing_utils.py). The functions work on
the trailing time axis and batch over leading dims, so the ``*_vmap``
names are the same functions. The noise estimate is the documented
256-sample-segment Welch; ``welch_noise_estimate_ref_compat`` is the
reference's effective single-periodogram one."""

from localmd_tpu_torch.ops.noise import (
    center,
    center_and_get_noise_estimate,
    center_and_noise_normalize,
    get_mean,
    get_mean_and_noise,
    get_mean_chunk,
    get_noise_estimate,
    standardize_block,
    welch_noise_estimate,
    welch_noise_estimate_ref_compat,
)

# the reference's vmap names (preprocessing_utils.py:40, :70, :81)
get_noise_estimate_vmap = welch_noise_estimate
center_vmap = center
center_and_noise_normalize_vmap = center_and_noise_normalize

__all__ = [
    "get_mean_and_noise",
    "get_mean_chunk",
    "get_noise_estimate",
    "get_noise_estimate_vmap",
    "center_and_get_noise_estimate",
    "get_mean",
    "center",
    "center_vmap",
    "center_and_noise_normalize",
    "center_and_noise_normalize_vmap",
    "standardize_block",
    "welch_noise_estimate",
    "welch_noise_estimate_ref_compat",
]
