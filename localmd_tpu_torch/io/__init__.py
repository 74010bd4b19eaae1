from localmd_tpu_torch.io.tiff import TiffReader, write_tiff

__all__ = ["TiffReader", "write_tiff"]
