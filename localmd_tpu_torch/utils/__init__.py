from localmd_tpu_torch.utils.device import free_bytes, is_device_oom, transient_budget_bytes
from localmd_tpu_torch.utils.logging import display, get_logger
from localmd_tpu_torch.utils.random import make_generator, normal, sketch_override, stage_seeds

__all__ = [
    "display",
    "get_logger",
    "free_bytes",
    "is_device_oom",
    "transient_budget_bytes",
    "make_generator",
    "normal",
    "sketch_override",
    "stage_seeds",
]
