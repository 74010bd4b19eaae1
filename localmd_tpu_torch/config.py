"""Numerics and device policy of the PyTorch port.

The JAX package pins ``Precision.HIGHEST`` on every parity-critical product
(ops/pallas_kernels.py:101-106, 205-208, 292-295; ops/noise.py:89;
ops/linalg.py:253). The port's counterpart is plain IEEE fp32 everywhere:
TF32 stays off for matmuls and convolutions, and the fp32 matmul precision
is "highest". Importing the package applies this (``apply()``), and so
does every ``localmd_decomposition`` call.

The device is always explicit: ``resolve_device("cuda")`` raises when CUDA
is absent instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch


def apply() -> None:
    """Turn TF32 off and pin fp32 matmuls to full precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and there is
    no usable card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} was requested but CUDA is not available; "
            "pass device='cpu' explicitly to run on the CPU"
        )
    return dev
