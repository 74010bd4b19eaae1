"""Numerics and device policy of the PyTorch port.

The JAX package pins ``Precision.HIGHEST`` on every parity-critical product
(ops/pallas_kernels.py:101-106, 205-208, 292-295; ops/noise.py:89;
ops/linalg.py:253). The port's counterpart is plain IEEE fp32 everywhere:
TF32 stays off for matmuls and convolutions, and the fp32 matmul precision
is "highest". Importing the package applies this (``apply()``), and so
does every ``localmd_decomposition`` call, inside
``matmul_precision_scope``, which restores the caller's setting on exit.

The device is always explicit: ``resolve_device("cuda")`` raises when CUDA
is absent instead of quietly running on the CPU.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

# the JAX package's ``matmul_precision`` names (jax.default_matmul_precision)
# and torch's own, mapped onto torch's fp32 matmul precision
MATMUL_PRECISIONS = {
    "highest": "highest",
    "tensorfloat32": "high",
    "high": "high",
    "bfloat16": "medium",
    "medium": "medium",
}


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


def torch_matmul_precision(name: Optional[str]) -> Optional[str]:
    """torch's fp32 matmul precision for a ``matmul_precision`` name (None
    stays None); raises ``ValueError`` for a name it does not know."""
    if name is None:
        return None
    if name not in MATMUL_PRECISIONS:
        raise ValueError(
            f"matmul_precision must be one of {sorted(MATMUL_PRECISIONS)} or None, got {name!r}"
        )
    return MATMUL_PRECISIONS[name]


@contextlib.contextmanager
def matmul_precision_scope(precision: Optional[str] = None):
    """Apply the port's policy (``apply()``) and then ``precision`` (torch's
    name, None keeps "highest") for the body, as ``jax.default_matmul_precision``
    scopes a call (pipeline.py:233-234). On every exit, an exception
    included, the caller's fp32 matmul precision and both TF32 flags come
    back: the flags first and the precision last, the order ``apply()``
    uses, since torch refuses to read a precision that a later flag
    contradicts."""
    saved = (
        torch.get_float32_matmul_precision(),
        torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32,
    )
    try:
        apply()
        if precision is not None:
            torch.set_float32_matmul_precision(precision)
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
        torch.backends.cudnn.allow_tf32 = saved[2]
        torch.set_float32_matmul_precision(saved[0])


def route_enabled(flag, device) -> bool:
    """Whether one of the accelerator routes (``engine.COSET_STAGE``,
    ``blocksparse.BANDED_GRAM``, ``blocksparse.COSET_VPROJ``) is on for
    tensors on ``device``: ``True`` or ``False`` force it, ``"auto"`` turns
    it on for CUDA tensors and off on the CPU, as the JAX package turns
    these routes on whenever its backend is not the CPU. The CPU keeps the
    gather and canvas forms, whose numerics the CPU tests hold to the JAX
    package's."""
    if flag is True or flag is False:
        return flag
    if flag != "auto":
        raise ValueError(f"a route flag is True, False or 'auto', got {flag!r}")
    return torch.device(device).type == "cuda"
