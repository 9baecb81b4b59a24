"""Host-side conversions (NumPy + the C++ layout helpers)."""

from spgpu_tpu_torch.convert.host import (  # noqa: F401
    bcoo_to_bhdia,
    compute_bcoo_size,
    compute_dia_alloc_pitch,
    compute_dia_diagonals_count,
    compute_ell_alloc_pitch,
    compute_ell_row_lengths,
    compute_hdia_hack_offsets,
    compute_hdia_hack_offsets_from_coo,
    compute_hell_alloc_size,
    coo_to_bcoo,
    coo_to_dia,
    coo_to_ell,
    coo_to_hdia,
    coo_to_hdia_size,
    coo_to_hell,
    dia_to_hdia,
    ell_to_hell,
    ell_to_oell,
    get_hdia_hacks_count,
)
from spgpu_tpu_torch.convert.hybrid import coo_to_hybrid, hybrid_split_stats  # noqa: F401
from spgpu_tpu_torch.convert.pcell import coo_to_whell_percell  # noqa: F401
from spgpu_tpu_torch.convert.sdia import coo_to_sdia, dia_to_sdia  # noqa: F401
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
