"""Kernel #17: the per-cell row-routing WHELL (pcell) SpMV, hand-written
in CUDA C++.

Replaces ``spgpu_tpu/ops/pallas_kernels.py::_pcell_kernel``: fp32
values, x and sums.  The source is ``spgpu_tpu_torch/csrc/pcell_spmv.cu``
(its header note gives the design and its bound), built on first launch
by :mod:`spgpu_tpu_torch.kernels._build`; nothing is built when this
module is imported.

:func:`pcell_spmv` launches the kernel for CUDA tensors (or raises) and
runs :func:`pcell_spmv_plain`, the plain PyTorch version of the same
function, for CPU tensors.  ``LAUNCHES`` counts the kernel's launches.
Both take the layout's ``tile_page`` (``PcellWhell.tile_page``, each
tile's full-width layout group) and read the group from it, and only the
hack-in-group from ``tile_base``; ``tile_page`` is a required
argument of both.
"""

from __future__ import annotations

import ctypes

import torch

from spgpu_tpu_torch.kernels._build import CudaLibrary

__all__ = ["LAUNCHES", "SOURCE", "build", "pcell_spmv",
           "pcell_spmv_plain"]

#: launches of kernel #17 so far; the CPU path does not count
LAUNCHES = 0


def _bind(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.pcell_spmv.restype = ctypes.c_int
    lib.pcell_spmv.argtypes = [p] * 11 + [i64, i32, i32, i32, p]


_LIB = CudaLibrary("pcell_spmv", _bind)
SOURCE = _LIB.source
build = _LIB.build


def _check_args(values, residue, page_tab, run_hi, run_lo, tile_base,
                chunk_group, group_bases, x, chunk_tiles, group_hacks,
                window_pages, num_groups, tile_page):
    S = values.shape[0]
    T = tile_base.shape[0]
    want = [
        (values.dtype == torch.float32 and values.shape == (S, 128) and S == 8 * T,
         "values"),
        *[((t.shape == (S, 128) and t.dtype == torch.int8), name)
          for name, t in (("residue", residue), ("page_tab", page_tab),
                          ("run_hi", run_hi), ("run_lo", run_lo))],
        (tile_base.dtype == torch.int32 and T % chunk_tiles == 0, "tile_base"),
        (tile_page.dtype == torch.int32 and tile_page.shape == (T,), "tile_page"),
        (chunk_group.dtype == torch.int32
         and chunk_group.shape == (T // chunk_tiles + 1,), "chunk_group"),
        (window_pages in (8, 16, 32, 64) and group_bases.dtype == torch.int32
         and group_bases.dim() == 1
         and group_bases.numel() % (window_pages // 8) == 0, "group_bases"),
        (x.dim() == 2 and x.shape[-1] == 128 and x.dtype == torch.float32,
         "x2d: (x_pages, 128) float32"),
        (group_hacks >= 1 and num_groups >= 1, "group_hacks/num_groups"),
    ]
    for ok, what in want:
        if not ok:
            raise ValueError(f"pcell_spmv: bad {what}")
    ts = [values, residue, page_tab, run_hi, run_lo, tile_base, tile_page,
          chunk_group, group_bases, x]
    if any(t.device != x.device for t in ts):
        raise ValueError("pcell_spmv: all operands must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("pcell_spmv: operands must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pcell_spmv: no kernel for device {x.device}")


def pcell_spmv(values, residue, page_tab, run_hi, run_lo, tile_base,
               chunk_group, group_bases, x2d, *, chunk_tiles: int,
               group_hacks: int, window_pages: int, num_groups: int,
               tile_page: torch.Tensor) -> torch.Tensor:
    """pcell product ``(num_groups*group_hacks, 128)`` fp32 in the original
    row numbering, of fp32 values and x2d ``(x_pages, 128)`` fp32.

    CUDA tensors launch kernel #17 (counted in ``LAUNCHES``); CPU tensors
    run :func:`pcell_spmv_plain`.  Any other device raises.  The layout
    arrays are trusted as built by the converter or checked by
    ``PcellWhell.check``; shapes, dtypes and devices are checked here."""
    _check_args(values, residue, page_tab, run_hi, run_lo, tile_base,
                chunk_group, group_bases, x2d, chunk_tiles, group_hacks,
                window_pages, num_groups, tile_page)
    dev = x2d.device
    static = dict(chunk_tiles=chunk_tiles, group_hacks=group_hacks,
                  window_pages=window_pages, num_groups=num_groups,
                  tile_page=tile_page)
    if dev.type == "cpu":
        return pcell_spmv_plain(values, residue, page_tab, run_hi, run_lo,
                                tile_base, chunk_group, group_bases, x2d, **static)
    if (any(t.data_ptr() % 16 for t in (values, page_tab))
            or any(t.data_ptr() % 4 for t in (residue, run_hi, run_lo))):
        raise ValueError("pcell_spmv: the kernel's vector loads need 16 B aligned "
                         "values and page_tab and 4 B aligned residue, run_hi, run_lo")
    lib = _LIB.load()
    z = torch.zeros((num_groups * group_hacks, 128), dtype=torch.float32, device=dev)
    err = lib.pcell_spmv(
        values.data_ptr(), residue.data_ptr(), page_tab.data_ptr(),
        run_hi.data_ptr(), run_lo.data_ptr(), tile_base.data_ptr(),
        tile_page.data_ptr(), chunk_group.data_ptr(), group_bases.data_ptr(),
        x2d.data_ptr(), z.data_ptr(), tile_base.shape[0], chunk_tiles, group_hacks,
        window_pages // 8, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pcell_spmv launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return z


def pcell_spmv_plain(values, residue, page_tab, run_hi, run_lo, tile_base,
                     chunk_group, group_bases, x2d, *, chunk_tiles: int,
                     group_hacks: int, window_pages: int, num_groups: int,
                     tile_page: torch.Tensor) -> torch.Tensor:
    """The same product in plain PyTorch, with the kernel's arithmetic:
    each slot's products, their inclusive ``cumsum`` along the lanes,
    then the difference of the scan at each output lane's run bounds
    (not a direct segment sum), and ``index_add_`` of each tile's routed
    slots into its hack."""
    dev = x2d.device
    S = values.shape[0]
    T = tile_base.shape[0]
    res = residue.long()
    d = torch.gather(page_tab.long(), 1, res)  # page delta by residue
    meta = tile_base.long()
    K = window_pages // 8
    tile = torch.arange(S, device=dev) // 8
    group = tile_page.long()
    page = group_bases.long()[group[tile, None] * K + (d >> 3)] + (d & 7)
    scan = (values * x2d.reshape(-1)[page * 128 + res]).cumsum(dim=1)
    hi, lo = run_hi.long(), run_lo.long()
    routed = (torch.where(hi >= 0, torch.gather(scan, 1, hi.clamp(min=0)), 0.0)
              - torch.where(lo >= 0, torch.gather(scan, 1, lo.clamp(min=0)), 0.0))
    hack = (chunk_group.long()[torch.arange(T, device=dev) // chunk_tiles]
            * group_hacks + (meta >> 20))
    z = torch.zeros((num_groups * group_hacks, 128), dtype=torch.float32, device=dev)
    z.index_add_(0, hack, routed.view(T, 8, 128).sum(dim=1))
    return z
