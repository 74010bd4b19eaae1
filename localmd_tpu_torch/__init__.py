"""localmd_tpu_torch -- the PyTorch + CUDA port of localmd_tpu.

Localized Penalized Matrix Decomposition of functional-imaging movies on one
NVIDIA GPU. The JAX package ``localmd_tpu`` stays the reference; this
package never imports it (or jax). The four TPU kernels of the repository
are hand-written CUDA C++ for sm_90a (``csrc/``), built with nvcc at first
use; on CPU tensors each wrapper takes its plain PyTorch version. Movies
come from memory, tensors or files (``dataset``), streamed through pinned
host buffers; ``python -m localmd_tpu_torch.cli`` compresses, describes
and exports from the command line. ``metrics``, ``sim`` and
``diagnostics`` give quality numbers, synthetic movies and QC images; the
reference's module names (``decomposition``, ``diagnostic_plots``,
``evaluation``, ``pmd_loader``, ``pmdarray``, ``preprocessing_utils``) are
bound as attributes of the package.
"""

from localmd_tpu_torch import config

config.apply()

from localmd_tpu_torch.blocksparse import BlockSparseMatrix  # noqa: E402
from localmd_tpu_torch.dataset import (  # noqa: E402
    DeviceMovie,
    NpyArray,
    NumpyArray,
    PlaneView,
    PMDDataset,
    RawBinaryArray,
    TensorMovie,
    TiffArray,
    ZStackArray,
    as_dataset,
    lazy_data_loader,
)
from localmd_tpu_torch.factorization import compute_lowrank_factorized_svd  # noqa: E402
from localmd_tpu_torch.loader import PMDLoader  # noqa: E402
from localmd_tpu_torch.ops.linalg import projected_svd  # noqa: E402
from localmd_tpu_torch.pipeline import localmd_decomposition  # noqa: E402
from localmd_tpu_torch.pmd_array import PMDArray  # noqa: E402
from localmd_tpu_torch.serialization import load_decomposition, save_decomposition  # noqa: E402
from localmd_tpu_torch.volumetric import VolumetricPMD, volumetric_decomposition  # noqa: E402

# the reference's submodule names as attributes of the package, as
# localmd_tpu/__init__.py:35-42 binds them
from localmd_tpu_torch import (  # noqa: E402,F401
    decomposition,
    diagnostic_plots,
    evaluation,
    pmd_loader,
    pmdarray,
    preprocessing_utils,
)

__version__ = "0.1.0"

__all__ = [
    "localmd_decomposition",
    "volumetric_decomposition",
    "VolumetricPMD",
    "compute_lowrank_factorized_svd",
    "projected_svd",
    "PMDArray",
    "BlockSparseMatrix",
    "PMDLoader",
    "PMDDataset",
    "lazy_data_loader",
    "NumpyArray",
    "TiffArray",
    "RawBinaryArray",
    "NpyArray",
    "ZStackArray",
    "PlaneView",
    "TensorMovie",
    "DeviceMovie",
    "as_dataset",
    "save_decomposition",
    "load_decomposition",
]
