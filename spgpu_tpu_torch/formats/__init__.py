"""Matrix formats: host COO and the WHELL (packed, classic and per-cell
routing), SDIA and WHDIA compute layouts."""

from spgpu_tpu_torch.formats.coo import CooMatrix  # noqa: F401
from spgpu_tpu_torch.formats.dia import SdiaMatrix  # noqa: F401
from spgpu_tpu_torch.formats.whdia import WhdiaMatrix  # noqa: F401
from spgpu_tpu_torch.formats.whell import (  # noqa: F401
    PcellWhell,
    WhellMatrix,
    from_numpy_fields,
    from_numpy_pcell,
)
