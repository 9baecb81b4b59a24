"""spgpu_tpu_torch — the PyTorch + CUDA port of spgpu_tpu for NVIDIA Hopper.

A second package beside :mod:`spgpu_tpu` (the JAX reference, which it
never imports).  It carries its own NumPy host side (COO, fixtures,
converters, format selection), binds the same C++ layout helpers, and
runs its routes on the GPU, each through a hand CUDA kernel:

    host COO → convert.coo_to_whell (packed) → ops.whell_spmv in lane
    space (kernels/whell.py) → solvers.cg / bicgstab
    host COO → convert.coo_to_sdia | coo_to_whdia → ops.sdia_spmv |
    whdia_spmv (kernels/sdia.py, kernels/whdia.py) → solvers.cg / bicgstab
    host COO → convert.coo_to_whell(packed=False) (classic: OELL order,
    way-split rows) | coo_to_whell_percell → ops.whell_spmv in the
    original numbering (kernels/whell_classic.py, kernels/pcell.py);
    solve(fmt="pcell")
    host COO → convert.coo_to_hybrid (WHDIA band + packed WHELL rest)
    → ops.hybrid_spmv (kernels #3/#6 and #1/#4); solve(fmt="hybrid")
    host COO → convert.coo_to_ell | coo_to_hell | coo_to_dia |
    coo_to_hdia | coo_to_bcoo (the classic layouts, convert/host.py) →
    ops.ell_spmv | hell_spmv | dia_spmv | hdia_spmv | bcoo_spmv (plain
    torch on the layout's device, as the JAX package runs them in XLA);
    ops.spmv on any layout; solve(fmt="hell")
    the per-op cycle accounts of the fp32 WHDIA SpMV and the float64
    WHELL SpMV (kernels/ablation.py) and the float64 WHELL geometry sweep:
    python -m spgpu_tpu_torch.sweeps.<whdia_ablation|dd_ablation|dd_geom_sweep>

A Matrix Market file comes in through ``io.read_mm`` (and goes out through
``io.write_mm``), as in the JAX package, to ``solvers.solve``, whose CG
and BiCGSTAB iterate on a CUDA device as replays of a CUDA graph of
masked steps: the host reads one flag per replay, not one per iteration.

The multi-RHS products ``ops.whell_spmm``, ``sdia_spmm`` and
``whdia_spmm`` take ``(n_rhs, n)`` stacks on the same layouts, fused in
one kernel per route (fp32, and bf16 on WHELL) or as a loop of the SpMV.
``solvers.solve`` picks the route by format selection.  Values are
float32 (bf16 too on WHELL), float64, complex64 or complex128; a float64
or complex matrix runs layouts, kernels and solver loops of its own type
natively, where the JAX package emulates D precision with fp32 pairs and
keeps complex matrices as two real planes.

Every converter takes an explicit ``device``; CPU tensors run the plain
PyTorch version of each kernel.
"""

from spgpu_tpu_torch import convert, core, formats, io, kernels, ops, solvers, utils  # noqa: F401
from spgpu_tpu_torch.convert import (  # noqa: F401
    coo_to_sdia,
    coo_to_whdia,
    coo_to_whell,
    coo_to_whell_percell,
    degree_sort_perm,
    suggest_format,
    whell_update_values,
)
from spgpu_tpu_torch.formats import (  # noqa: F401
    CooMatrix,
    PcellWhell,
    SdiaMatrix,
    WhdiaMatrix,
    WhellMatrix,
)
from spgpu_tpu_torch.io import MmProperties, read_mm, read_mm_properties, write_mm  # noqa: F401
from spgpu_tpu_torch.ops import (  # noqa: F401
    sdia_spmm,
    sdia_spmv,
    whdia_spmm,
    whdia_spmv,
    whell_spmm,
    whell_spmv,
)
from spgpu_tpu_torch.solvers import solve  # noqa: F401
from spgpu_tpu_torch.utils.hostmem import tune_malloc as _tune_malloc

_tune_malloc()  # as the JAX package does: conversions' NumPy temporaries stay resident

__version__ = "0.1.0"
