"""localmd_tpu_torch -- the PyTorch + CUDA port of localmd_tpu.

Localized Penalized Matrix Decomposition of functional-imaging movies on one
NVIDIA GPU. The JAX package ``localmd_tpu`` stays the reference; this
package never imports it (or jax). The three TPU kernels of the main path
are hand-written CUDA C++ for sm_90a (``csrc/``), built with nvcc at first
use; on CPU tensors each wrapper takes its plain PyTorch version.
"""

from localmd_tpu_torch import config

config.apply()

from localmd_tpu_torch.blocksparse import BlockSparseMatrix  # noqa: E402
from localmd_tpu_torch.factorization import compute_lowrank_factorized_svd  # noqa: E402
from localmd_tpu_torch.loader import PMDLoader  # noqa: E402
from localmd_tpu_torch.ops.linalg import projected_svd  # noqa: E402
from localmd_tpu_torch.pipeline import localmd_decomposition  # noqa: E402
from localmd_tpu_torch.pmd_array import PMDArray  # noqa: E402
from localmd_tpu_torch.serialization import load_decomposition, save_decomposition  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "localmd_decomposition",
    "compute_lowrank_factorized_svd",
    "projected_svd",
    "PMDArray",
    "BlockSparseMatrix",
    "PMDLoader",
    "save_decomposition",
    "load_decomposition",
]
