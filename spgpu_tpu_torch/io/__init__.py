"""Matrix Market I/O (:mod:`spgpu_tpu_torch.io.mm`), the counterpart of
:mod:`spgpu_tpu.io`."""

from spgpu_tpu_torch.io.mm import MmProperties, read_mm, read_mm_properties, write_mm

__all__ = ["MmProperties", "read_mm", "read_mm_properties", "write_mm"]
