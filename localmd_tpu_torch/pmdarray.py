"""The reference's ``localmd.pmdarray`` name (counterpart of localmd_tpu/pmdarray.py)."""

from localmd_tpu_torch.pmd_array import PMDArray

__all__ = ["PMDArray"]
