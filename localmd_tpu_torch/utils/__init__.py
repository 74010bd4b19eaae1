from localmd_tpu_torch.utils.device import (
    block_batch_budget,
    device_free_bytes,
    is_device_oom,
    transient_budget_bytes,
)
from localmd_tpu_torch.utils.keys import make_jax_random_key, make_key, make_key_with_seed, split_keys
from localmd_tpu_torch.utils.logging import display, get_logger
from localmd_tpu_torch.utils.random import make_generator, normal, sketch_override, stage_seeds

__all__ = [
    "display",
    "get_logger",
    "device_free_bytes",
    "block_batch_budget",
    "is_device_oom",
    "transient_budget_bytes",
    "make_key",
    "make_key_with_seed",
    "split_keys",
    "make_jax_random_key",
    "make_generator",
    "normal",
    "sketch_override",
    "stage_seeds",
]
