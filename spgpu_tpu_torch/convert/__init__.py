"""Host-side conversions (NumPy + the C++ layout helpers)."""

from spgpu_tpu_torch.convert.pcell import coo_to_whell_percell  # noqa: F401
from spgpu_tpu_torch.convert.sdia import coo_to_sdia  # noqa: F401
from spgpu_tpu_torch.convert.select import (  # noqa: F401
    FormatEstimate,
    estimate_formats,
    suggest_format,
)
from spgpu_tpu_torch.convert.whdia import coo_to_whdia  # noqa: F401
from spgpu_tpu_torch.convert.whell import (  # noqa: F401
    coo_to_whell,
    degree_sort_perm,
    local_degree_perm,
    symmetric_relabel,
    whell_update_values,
)
