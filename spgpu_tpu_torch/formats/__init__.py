"""Matrix formats: host COO, the classic layouts (ELL/OELL, HELL, DIA,
HDIA, BCOO, BHDIA), the WHELL (packed, classic and per-cell routing), SDIA
and WHDIA compute layouts, and the hybrid split."""

from spgpu_tpu_torch.formats.bcoo import BcooMatrix, BhdiaMatrix  # noqa: F401
from spgpu_tpu_torch.formats.coo import CooMatrix  # noqa: F401
from spgpu_tpu_torch.formats.dia import DiaMatrix, SdiaMatrix  # noqa: F401
from spgpu_tpu_torch.formats.ell import EllMatrix  # noqa: F401
from spgpu_tpu_torch.formats.hdia import HdiaMatrix  # noqa: F401
from spgpu_tpu_torch.formats.hell import HellMatrix  # noqa: F401
from spgpu_tpu_torch.formats.hybrid import HybridMatrix  # noqa: F401
from spgpu_tpu_torch.formats.whdia import WhdiaMatrix  # noqa: F401
from spgpu_tpu_torch.formats.whell import (  # noqa: F401
    PcellWhell,
    WhellMatrix,
    from_numpy_fields,
    from_numpy_pcell,
)
