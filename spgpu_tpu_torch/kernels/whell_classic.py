"""Kernels #15 and #16: the classic (non-packed) WHELL SpMV and SpMM,
hand-written in CUDA C++.

Replaces ``spgpu_tpu/ops/pallas_kernels.py::_whell_kernel`` (#15) and
``_whell_spmm_kernel`` (#16, the multi-RHS product): fp32 or bf16 values
with fp32 x and sums, or float64 values, x and sums.  The source of both is
``spgpu_tpu_torch/csrc/whell_classic_spmv.cu`` (its header note gives the
design and its bound), built on first launch by
:mod:`spgpu_tpu_torch.kernels._build`; nothing is built when this module
is imported.

:func:`whell_classic_spmv` and :func:`whell_classic_spmm` launch their
kernels for CUDA tensors (or raise) and run
:func:`whell_classic_spmv_plain` / :func:`whell_classic_spmm_plain`, the
plain PyTorch versions of the same functions, for CPU tensors.  Both give
the product in STORED rows, ``(num_groups*8, 128)`` per RHS: the OELL
scatter, the way reduction and the epilogue are the op's
(:func:`spgpu_tpu_torch.ops.whell_spmv`).  ``LAUNCHES`` counts the
launches of kernel #15 and ``LAUNCHES_SPMM`` those of #16 on fp32 and
bf16 values, ``LAUNCHES_F64`` and ``LAUNCHES_SPMM_F64`` their float64
launches (entries ``whell_classic_spmv_f64``, ``whell_classic_spmm_f64``).
The product comes in x's type.  Both kernels
read only the live units of the layout's work list (in float64 values
only in the live sectors of its ``work_sectors``); both plain versions
read every cell.  #16 is a persistent kernel that copies each unit's slab
bytes into shared memory 16 B at a time, so it needs a 16 B aligned
slab.  Every function takes the layout's ``tile_page``
(``WhellMatrix.tile_page``, each tile's full-width base page) and reads
the page from it, and only the hack-in-group from ``tile_base``;
``tile_page`` is a required argument of each.
"""

from __future__ import annotations

import ctypes

import torch

from spgpu_tpu_torch.core import CHUNK_TILES
from spgpu_tpu_torch.kernels._build import CudaLibrary

__all__ = ["LAUNCHES", "LAUNCHES_F64", "LAUNCHES_SPMM", "LAUNCHES_SPMM_F64",
           "SOURCE", "build",
           "whell_classic_spmm",
           "whell_classic_spmm_plain", "whell_classic_spmv",
           "whell_classic_spmv_plain"]

#: launches of kernel #15 (SpMV) and #16 (SpMM) so far, fp32/bf16 values
#: and float64 values; the CPU path does not count
LAUNCHES = 0
LAUNCHES_SPMM = 0
LAUNCHES_F64 = 0
LAUNCHES_SPMM_F64 = 0

#: x's type for each value type: fp32 for fp32 and bf16 values, float64
#: for float64
X_DTYPE = {torch.float32: torch.float32, torch.bfloat16: torch.float32,
           torch.float64: torch.float64}

#: hacks per output group of the classic layout
_GROUP_HACKS = 8


def _bind(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.whell_classic_spmv.restype = ctypes.c_int
    lib.whell_classic_spmv.argtypes = [p, i32] + [p] * 7 + [i64, p, p, p]
    lib.whell_classic_spmm.restype = ctypes.c_int
    lib.whell_classic_spmm.argtypes = [p, i32] + [p] * 7 + [i64, p, p, i64, i32, p]
    lib.whell_classic_spmv_f64.restype = ctypes.c_int
    lib.whell_classic_spmv_f64.argtypes = [p] * 8 + [i64, p, p, p]
    lib.whell_classic_spmm_f64.restype = ctypes.c_int
    lib.whell_classic_spmm_f64.argtypes = [p] * 8 + [i64, p, p, i64, i32, p]


_LIB = CudaLibrary("whell_classic_spmv", _bind)
SOURCE = _LIB.source
build = _LIB.build


def _check_args(op, values, residue, page_tab, tile_base, chunk_group, x,
                num_groups, tile_page):
    """Shapes, dtypes, devices and contiguity of ``op``'s operands: ``x``
    is ``(x_pages, 128)`` for the SpMV, ``(n_rhs, x_pages, 128)`` for the
    SpMM, fp32 for fp32 or bf16 values and float64 for float64 ones."""
    spmm = op == "whell_classic_spmm"
    S = values.shape[0]
    T = tile_base.shape[0]
    xshape = "(n_rhs, x_pages, 128)" if spmm else "(x_pages, 128)"
    xdt = X_DTYPE.get(values.dtype)
    xname = str(xdt).removeprefix("torch.")
    want = [
        (xdt is not None, "values dtype"),
        (values.shape == (S, 128) and S == 8 * T, "values shape"),
        (residue.shape == (S, 128) and residue.dtype == torch.int8, "residue"),
        (page_tab.shape == (S, 128) and page_tab.dtype == torch.int8, "page_tab"),
        (tile_base.dtype == torch.int32 and T % CHUNK_TILES == 0, "tile_base"),
        (tile_page.dtype == torch.int32 and tile_page.shape == (T,), "tile_page"),
        (chunk_group.dtype == torch.int32
         and chunk_group.shape == (T // CHUNK_TILES,), "chunk_group (no sentinel)"),
        (x.dim() == (3 if spmm else 2) and x.shape[-1] == 128
         and x.dtype == xdt, f"x: {xshape} {xname} for {values.dtype} values"),
        (num_groups >= 1, "num_groups"),
    ]
    for ok, what in want:
        if not ok:
            raise ValueError(f"{op}: bad {what}")
    ts = [values, residue, page_tab, tile_base, tile_page, chunk_group, x]
    if any(t.device != x.device for t in ts):
        raise ValueError(f"{op}: all operands must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{op}: operands must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: no kernel for device {x.device}")


def _check_work(op, work, device) -> None:
    """``work`` is the layout's work list (``WhellMatrix.work_list``: a
    contiguous int64 list on ``device``); the kernels need it, so on a
    CUDA device it may not be None (the plain versions read every cell
    and need none)."""
    if work is None:
        if device.type == "cuda":
            raise ValueError(f"{op}: the kernel needs the layout's work list "
                             "(WhellMatrix.work_list)")
        return
    if (work.dtype != torch.int64 or work.dim() != 1 or work.device != device
            or not work.is_contiguous()):
        raise ValueError(f"{op}: bad work (a contiguous int64 list on x's device)")


def _check_sectors(values, work, sectors, device, op="whell_classic_spmv") -> None:
    """``sectors`` is the layout's sector list (``WhellMatrix.work_sectors``:
    a contiguous int64 list on ``device``, aligned with ``work``) for
    float64 values, whose kernels #15 and #16 read by sector, so on a CUDA
    device it may not be None there; fp32 and bf16 values take none."""
    if values.dtype != torch.float64:
        if sectors is not None:
            raise ValueError(f"{op}: only float64 values take work_sectors (fp32 and "
                             "bf16 kernels read whole warp-slots)")
        return
    if sectors is None:
        if device.type == "cuda":
            raise ValueError(f"{op}: the float64 kernel needs the layout's sector "
                             "list (WhellMatrix.work_sectors)")
        return
    if (sectors.dtype != torch.int64 or sectors.dim() != 1 or sectors.device != device
            or not sectors.is_contiguous()):
        raise ValueError(f"{op}: bad work_sectors (a contiguous int64 list on x's device)")
    if work is not None and sectors.shape != work.shape:
        raise ValueError(f"{op}: work_sectors must align with work")


def _launch_args(op, values, residue, page_tab, tile_base, tile_page, chunk_group,
                 work, sectors=None, lib=None):
    """The float64 entry of ``op`` or the fp32/bf16 one (of ``lib``, default
    the built library) and the pointers the kernels #15 and #16 take
    before x (the sector list null where ``sectors`` is None), with the
    list's length (the fp32/bf16 entries also take the bf16 flag); the row
    prefetch loads page_tab 4 B a lane."""
    if page_tab.data_ptr() % 4:
        raise ValueError(f"{op}: the kernel loads page_tab 4 B a lane; it must be "
                         "4 B aligned")
    lib = lib or _LIB.load()
    f64 = values.dtype == torch.float64
    flag = () if f64 else (int(values.dtype == torch.bfloat16),)
    return getattr(lib, f"{op}_f64" if f64 else op), (
        values.data_ptr(), *flag, residue.data_ptr(), page_tab.data_ptr(),
        tile_base.data_ptr(), tile_page.data_ptr(), chunk_group.data_ptr(),
        work.data_ptr(), None if sectors is None else sectors.data_ptr(),
        work.numel())


def whell_classic_spmv(values, residue, page_tab, tile_base, chunk_group, x2d,
                       *, num_groups: int, work=None, work_sectors=None,
                       tile_page: torch.Tensor) -> torch.Tensor:
    """Classic WHELL product ``(num_groups*8, 128)`` in stored rows, in
    x's type, of fp32 or bf16 values and x2d ``(x_pages, 128)`` fp32, or
    of float64 values and a float64 x2d.

    CUDA tensors launch kernel #15 (counted in ``LAUNCHES``, float64 in
    ``LAUNCHES_F64``) over
    ``work``, the slab's :func:`~spgpu_tpu_torch.formats.whell.classic_work_list`
    (``WhellMatrix.work_list``; required there) and, for float64 values,
    ``work_sectors``, the live 32 B value sectors of each entry
    (:func:`~spgpu_tpu_torch.formats.whell.classic_work_sectors`,
    ``WhellMatrix.work_sectors``; required there too, None for fp32 and
    bf16): it reads only the units and slots that hold a nonzero, in
    float64 values only in the sectors that hold one, and a zero-valued
    cell contributes nothing even where x is not finite.  CPU tensors run
    :func:`whell_classic_spmv_plain`, the full-layout product, and need
    no list.  Any other device raises.  The layout arrays and ``work`` are
    trusted as built by the converter or checked by ``WhellMatrix.check``;
    shapes, dtypes and devices are checked here."""
    _check_args("whell_classic_spmv", values, residue, page_tab, tile_base,
                chunk_group, x2d, num_groups, tile_page)
    dev = x2d.device
    _check_work("whell_classic_spmv", work, dev)
    _check_sectors(values, work, work_sectors, dev)
    if dev.type == "cpu":
        return whell_classic_spmv_plain(values, residue, page_tab, tile_base,
                                        chunk_group, x2d, num_groups=num_groups,
                                        tile_page=tile_page)
    z = launch_spmv(_LIB.load(), values, residue, page_tab, tile_base, tile_page,
                    chunk_group, work, work_sectors, x2d, num_groups=num_groups)
    f64 = values.dtype == torch.float64
    global LAUNCHES, LAUNCHES_F64
    if f64:
        LAUNCHES_F64 += 1
    else:
        LAUNCHES += 1
    return z


def launch_spmv(lib, values, residue, page_tab, tile_base, tile_page, chunk_group,
                work, work_sectors, x2d, *, num_groups: int) -> torch.Tensor:
    """One launch of ``lib``'s #15 entry for the values' type into a new
    zeroed z ``(num_groups*8, 128)`` of x's type; ``work_sectors`` None
    passes a null sector list (what an fp32 or bf16 build reads none
    of).  Counts nothing."""
    fn, args = _launch_args("whell_classic_spmv", values, residue, page_tab,
                               tile_base, tile_page, chunk_group, work, work_sectors,
                               lib=lib)
    z = torch.zeros((num_groups * _GROUP_HACKS, 128), dtype=x2d.dtype, device=x2d.device)
    err = fn(*args, x2d.data_ptr(), z.data_ptr(),
             torch.cuda.current_stream(x2d.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"whell_classic_spmv launch failed: CUDA error {err}")
    return z


def whell_classic_spmm(values, residue, page_tab, tile_base, chunk_group, x3d,
                       *, num_groups: int, work=None, work_sectors=None,
                       tile_page: torch.Tensor) -> torch.Tensor:
    """Fused multi-RHS product ``(n_rhs, num_groups*8, 128)`` in stored
    rows, in x's type, of fp32 or bf16 values and x3d ``(n_rhs, x_pages,
    128)`` fp32, or of float64 values and a float64 x3d: each cell is
    decoded once for every RHS.

    CUDA tensors launch kernel #16 (counted in ``LAUNCHES_SPMM``, float64
    in ``LAUNCHES_SPMM_F64``; the
    wrapper first copies X into the kernel's RHS-interleaved buffer) over
    ``work`` and, for float64 values, ``work_sectors``, the layout's lists
    (both required there, as for :func:`whell_classic_spmv`, in any order;
    ``WhellMatrix.spmm_work``/``spmm_work_sectors``, in
    :func:`~spgpu_tpu_torch.formats.whell.classic_spmm_order`, let a warp
    add the sums of consecutive entries into z once): it reads only the
    units and slots that hold a nonzero, and a zero-valued cell
    contributes nothing even where X is not finite.  CPU tensors run
    :func:`whell_classic_spmm_plain`, the full-layout product, and need no
    list.  Any other device raises."""
    _check_args("whell_classic_spmm", values, residue, page_tab, tile_base,
                chunk_group, x3d, num_groups, tile_page)
    dev = x3d.device
    _check_work("whell_classic_spmm", work, dev)
    _check_sectors(values, work, work_sectors, dev, "whell_classic_spmm")
    if dev.type == "cpu":
        return whell_classic_spmm_plain(values, residue, page_tab, tile_base,
                                        chunk_group, x3d, num_groups=num_groups,
                                        tile_page=tile_page)
    if x3d.shape[0] > 65535:
        raise ValueError("whell_classic_spmm: at most 65,535 RHS per launch")
    z = launch_spmm(_LIB.load(), values, residue, page_tab, tile_base, tile_page,
                    chunk_group, work, work_sectors, x3d, num_groups=num_groups)
    global LAUNCHES_SPMM, LAUNCHES_SPMM_F64
    if values.dtype == torch.float64:
        LAUNCHES_SPMM_F64 += 1
    else:
        LAUNCHES_SPMM += 1
    return z


def launch_spmm(lib, values, residue, page_tab, tile_base, tile_page, chunk_group,
                work, work_sectors, x3d, *, num_groups: int) -> torch.Tensor:
    """X copied into the RHS-interleaved ``(x_pages*128, n_rhs)`` buffer,
    then one launch of ``lib``'s #16 entry for the values' type into a new
    zeroed Z ``(n_rhs, num_groups*8, 128)`` of x's type; ``work_sectors``
    None passes a null sector list.  Counts nothing."""
    if any(t.data_ptr() % 16 for t in (values, residue, page_tab)):
        raise ValueError("whell_classic_spmm: the kernel copies the slab 16 B at a "
                         "time; values, residue and page_tab must be 16 B aligned")
    fn, args = _launch_args("whell_classic_spmm", values, residue, page_tab,
                               tile_base, tile_page, chunk_group, work, work_sectors,
                               lib=lib)
    n_rhs = x3d.shape[0]
    xi = x3d.reshape(n_rhs, -1).t().contiguous()  # (x_pages*128, n_rhs)
    z = torch.zeros((n_rhs, num_groups * _GROUP_HACKS, 128), dtype=x3d.dtype,
                    device=x3d.device)
    err = fn(*args, xi.data_ptr(), z.data_ptr(), num_groups * _GROUP_HACKS * 128, n_rhs,
             torch.cuda.current_stream(x3d.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"whell_classic_spmm launch failed: CUDA error {err}")
    return z


def whell_classic_spmv_plain(values, residue, page_tab, tile_base, chunk_group,
                             x2d, *, num_groups: int,
                             tile_page: torch.Tensor) -> torch.Tensor:
    """The same product in plain PyTorch over the full layout (every cell,
    padding included): :func:`whell_classic_spmm_plain` with one RHS."""
    return whell_classic_spmm_plain(values, residue, page_tab, tile_base,
                                    chunk_group, x2d.unsqueeze(0),
                                    num_groups=num_groups, tile_page=tile_page)[0]


def whell_classic_spmm_plain(values, residue, page_tab, tile_base, chunk_group,
                             x3d, *, num_groups: int,
                             tile_page: torch.Tensor) -> torch.Tensor:
    """The multi-RHS product in plain PyTorch, vectorised over the RHS
    axis of ``x3d`` ``(n_rhs, x_pages, 128)``, on the operands' device, in
    x's type (fp32 for fp32 and bf16 values, float64 for float64): decode
    once, gather ``(n_rhs, S, 128)``, sum each tile's 8 slots and
    ``index_add_`` the tiles into their stored-row hacks."""
    dev = x3d.device
    n_rhs = x3d.shape[0]
    T = tile_base.shape[0]
    res = residue.long()
    d = torch.gather(page_tab.long(), 1, res)  # page delta by residue
    meta = tile_base.long()
    tile = torch.arange(T * 8, device=dev) // 8
    col = (tile_page.long()[tile, None]
           + d) * 128 + res
    prod = values.to(x3d.dtype) * x3d.reshape(n_rhs, -1)[:, col]
    hack = (chunk_group.long()[torch.arange(T, device=dev) // CHUNK_TILES]
            * _GROUP_HACKS + (meta >> 16))
    z = torch.zeros((n_rhs, num_groups * _GROUP_HACKS, 128), dtype=x3d.dtype,
                    device=dev)
    z.index_add_(1, hack, prod.view(n_rhs, T, 8, 128).sum(dim=2))
    return z
