"""Kernels #3, #6, #9, #10 and #13: the windowed hacked DIA (WHDIA) SpMV
and SpMM, hand-written in CUDA C++.

Replaces ``spgpu_tpu/ops/pallas_kernels.py::_whdia_kernel`` (#3, fp32,
both r0 modes), ``_whdia_dd_kernel`` (#6, float64, which the TPU kernel
emulates with double-float pairs; here in both r0 modes too),
``_whdia_cplx_kernel`` (#9, complex64, both r0 modes),
``_whdia_z_kernel`` (#10, complex128, four double-float slabs and slab
mode only on the TPU; here in both r0 modes) and ``_whdia_spmm_kernel``
(#13, the multi-RHS product, fp32, both r0 modes).  The source of all
five is ``spgpu_tpu_torch/csrc/whdia_spmv.cu`` (its header note gives
the design and its bound), built on first launch by
:mod:`spgpu_tpu_torch.kernels._build`.

All five read only the layout's live slots (``WhdiaMatrix.hack_slot_ptr``/
``hack_slots``, which their wrappers require for CUDA tensors): #3, #6
and #10 the warp pass (a hack is 1, 2 or 4 warps, each thread owning a
run of lanes; #3 and #6 need a 16 B aligned slab), #9 and #13 the hack
pass (one block per hack); each stores each row once, so z needs no
zero fill and the result has the same bits from run to run.  A dead
slot is not read, so an Inf or NaN in x that only all-zero slots reach
gives no NaN there; the plain versions multiply every cell (the JAX
semantics).

:func:`whdia_spmv` and :func:`whdia_spmm` launch their kernels for CUDA
tensors (or raise) and run :func:`whdia_spmv_plain` /
:func:`whdia_spmm_plain`, the plain PyTorch versions of the same
functions, for CPU tensors; :func:`whdia_spmm_listed_plain` is the
live-slot kernels' product in plain PyTorch, summed in their order.  ``LAUNCHES``
counts the launches of kernel #3, ``LAUNCHES_F64`` those of #6,
``LAUNCHES_C64`` those of #9, ``LAUNCHES_C128`` those of #10 and
``LAUNCHES_SPMM`` those of #13.

Every function takes the layout's ``tile_page`` (``WhdiaMatrix.tile_page``,
each tile's full-width base page) and reads the page from it, and only
the hack-in-group from ``tile_base``; ``tile_page`` is a required
argument of each.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from spgpu_tpu_torch.kernels._build import CudaLibrary

__all__ = ["ALIGNED", "HACK_PASS", "LAUNCHES", "LAUNCHES_C128", "LAUNCHES_C64",
           "LAUNCHES_F64", "LAUNCHES_SPMM", "SOURCE", "build",
           "whdia_listed_columns",
           "whdia_listed_sum", "whdia_spmm", "whdia_spmm_listed_plain",
           "whdia_spmm_plain", "whdia_spmv", "whdia_spmv_plain"]

#: launches of kernel #3 (fp32), #6 (float64), #9 (complex64), #10
#: (complex128) and #13 (SpMM) so far; the CPU path does not count
LAUNCHES = 0
LAUNCHES_F64 = 0
LAUNCHES_C64 = 0
LAUNCHES_C128 = 0
LAUNCHES_SPMM = 0

#: value dtype -> (C entry, launch counter)
_ENTRIES = {torch.float32: ("whdia_spmv", "LAUNCHES"),
            torch.float64: ("whdia_spmv_f64", "LAUNCHES_F64"),
            torch.complex64: ("whdia_spmv_c64", "LAUNCHES_C64"),
            torch.complex128: ("whdia_spmv_c128", "LAUNCHES_C128")}

#: value dtypes whose SpMV reads only the live-slot list: all four (fp32
#: #3, float64 #6 and complex128 #10 on the warp pass; complex64 #9 on the
#: hack pass, which the fp32 SpMM, #13, runs too)
HACK_PASS = tuple(_ENTRIES)

#: value dtypes whose kernel loads a lane run's values as 16-byte words, so
#: their slab must be 16 B aligned (fp32 #3, float64 #6; complex128
#: elements are 16 B themselves)
ALIGNED = (torch.float32, torch.float64)


def _bind(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name, _ in _ENTRIES.values():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [p] * 8 + [i64, i64, p]
    lib.whdia_spmm.restype = ctypes.c_int
    lib.whdia_spmm.argtypes = [p] * 8 + [i64, i64, i64, i32, p]
    # kernel #18 (spgpu_tpu_torch.kernels.ablation)
    lib.whdia_ablation.restype = ctypes.c_int
    lib.whdia_ablation.argtypes = [i32] + [p] * 8 + [i64, i64, i32, i32, p]
    lib.whdia_hack_ablation.restype = ctypes.c_int
    lib.whdia_hack_ablation.argtypes = [i32, i32] + [p] * 8 + [i64, i64, i64,
                                                              i32, p]


_LIB = CudaLibrary("whdia_spmv", _bind)
SOURCE = _LIB.source
build = _LIB.build


def _check_args(op, values, slot_r0, tile_r0, tile_base, chunk_group, x,
                chunk_tiles, tile_page):
    """Shapes, dtypes, devices and contiguity of ``op``'s operands: ``x``
    is ``(n_cols,)`` for the SpMV, ``(n_rhs, n_cols)`` for the SpMM
    (fp32 only)."""
    spmm = op == "whdia_spmm"
    S = values.shape[0]
    T = tile_base.shape[0]
    xshape = "an (n_rhs, n_cols)" if spmm else "an (n_cols,)"
    want = [
        ((values.dtype == torch.float32 if spmm else values.dtype in _ENTRIES)
         and values.shape == (S, 128) and S == 8 * T, "values"),
        ((slot_r0 is None) != (tile_r0 is None),
         "r0: give exactly one of slot_r0 and tile_r0"),
        (slot_r0 is None or (slot_r0.dtype == torch.int16
                             and slot_r0.shape == (S,)), "slot_r0"),
        (tile_r0 is None or (tile_r0.dtype == torch.int32
                             and tile_r0.shape == (T,)), "tile_r0"),
        (tile_base.dtype == torch.int32 and chunk_tiles > 0
         and T % chunk_tiles == 0, "tile_base"),
        (tile_page.dtype == torch.int32 and tile_page.shape == (T,), "tile_page"),
        (chunk_group.dtype == torch.int32
         and chunk_group.shape == (T // chunk_tiles,), "chunk_group"),
        (x.dim() == (2 if spmm else 1) and x.dtype == values.dtype,
         f"x: {values.dtype} values take {xshape} {values.dtype} x"),
    ]
    for ok, what in want:
        if not ok:
            raise ValueError(f"{op}: bad {what}")
    ts = [t for t in (values, slot_r0, tile_r0, tile_base, tile_page, chunk_group, x)
          if t is not None]
    if any(t.device != x.device for t in ts):
        raise ValueError(f"{op}: all operands must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{op}: operands must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: no kernel for device {x.device}")


def _list_ptrs(op, hack_slot_ptr, hack_slots, hacks, device):
    """The live-slot list's pointers for the hack pass, checked: int32,
    contiguous, on ``device``, ``hack_slot_ptr`` ``(hacks + 1,)``."""
    if hack_slot_ptr is None or hack_slots is None:
        raise ValueError(f"{op}: the hack pass needs hack_slot_ptr and hack_slots "
                         "(WhdiaMatrix.hack_slot_list) for CUDA tensors")
    for t in (hack_slot_ptr, hack_slots):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous() \
                or t.device != device:
            raise ValueError(f"{op}: hack_slot_ptr and hack_slots must be "
                             f"contiguous 1-D int32 tensors on {device}")
    if hack_slot_ptr.shape[0] != hacks + 1:
        raise ValueError(f"{op}: hack_slot_ptr has {hack_slot_ptr.shape[0]} "
                         f"entries, not num_groups*group_hacks + 1 = {hacks + 1}")
    return hack_slot_ptr.data_ptr(), hack_slots.data_ptr()


def _check_aligned(op, values):
    """#3 and #6 read each thread's run of lanes as 16-byte loads."""
    if values.data_ptr() % 16:
        raise ValueError(f"{op}: the {values.dtype} warp pass needs 16 B aligned "
                         "values")


def _r0_ptrs(slot_r0, tile_r0):
    return (None if slot_r0 is None else slot_r0.data_ptr(),
            None if tile_r0 is None else tile_r0.data_ptr())


def whdia_spmv(values, slot_r0: Optional[torch.Tensor],
               tile_r0: Optional[torch.Tensor], tile_base, chunk_group,
               x, *, chunk_tiles: int, group_hacks: int, num_groups: int,
               hack_slot_ptr: Optional[torch.Tensor] = None,
               hack_slots: Optional[torch.Tensor] = None,
               tile_page: torch.Tensor) -> torch.Tensor:
    """WHDIA product ``(num_groups*group_hacks*128,)`` (row ``r`` at
    index ``r``) of the slab and ``x`` ``(n_cols,)``, both float32,
    float64, complex64 or complex128.

    Give ``slot_r0`` (slab mode) or ``tile_r0`` (pattern mode).  CUDA
    tensors launch the hand kernel of their type (#3, #6, #9 or #10, each
    counted in its ``LAUNCHES*``), which reads only the live slots: it
    needs the layout's ``hack_slot_ptr`` and ``hack_slots`` and raises
    without them; fp32 (#3) and float64 (#6) also need a 16 B aligned
    slab.  CPU tensors run :func:`whdia_spmv_plain` and ignore the lists.
    Any other device raises.  The layout arrays are trusted as built by
    the converter or checked by ``WhdiaMatrix.check``; shapes, dtypes and
    devices are checked here."""
    _check_args("whdia_spmv", values, slot_r0, tile_r0, tile_base,
                chunk_group, x, chunk_tiles, tile_page)
    dev = x.device
    if dev.type == "cpu":
        return whdia_spmv_plain(values, slot_r0, tile_r0, tile_base,
                                chunk_group, x, chunk_tiles=chunk_tiles,
                                group_hacks=group_hacks, num_groups=num_groups,
                                tile_page=tile_page)
    hacks = num_groups * group_hacks
    lists = _list_ptrs("whdia_spmv", hack_slot_ptr, hack_slots, hacks, dev)
    if x.dtype in ALIGNED:
        _check_aligned("whdia_spmv", values)
    lib = _LIB.load()
    entry, counter = _ENTRIES[x.dtype]
    z = torch.empty(hacks * 128, dtype=x.dtype, device=dev)  # every row written
    err = getattr(lib, entry)(
        values.data_ptr(), *_r0_ptrs(slot_r0, tile_r0), tile_page.data_ptr(), *lists,
        x.data_ptr(), z.data_ptr(), hacks, x.shape[0],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"whdia_spmv launch failed: CUDA error {err}")
    globals()[counter] += 1
    return z


def whdia_spmm(values, slot_r0: Optional[torch.Tensor],
               tile_r0: Optional[torch.Tensor], tile_base, chunk_group,
               x, *, chunk_tiles: int, group_hacks: int, num_groups: int,
               hack_slot_ptr: Optional[torch.Tensor] = None,
               hack_slots: Optional[torch.Tensor] = None,
               tile_page: torch.Tensor) -> torch.Tensor:
    """Fused multi-RHS WHDIA product ``(n_rhs, num_groups*group_hacks*128)``
    of the fp32 slab and ``x`` ``(n_rhs, n_cols)`` fp32, in either r0
    mode: each live slot's r0 is decoded once for every RHS.

    CUDA tensors launch kernel #13 (the hack pass, counted in
    ``LAUNCHES_SPMM``), which needs the layout's ``hack_slot_ptr`` and
    ``hack_slots`` and raises without them; CPU tensors run
    :func:`whdia_spmm_plain`.  Any other device raises."""
    _check_args("whdia_spmm", values, slot_r0, tile_r0, tile_base,
                chunk_group, x, chunk_tiles, tile_page)
    dev = x.device
    if dev.type == "cpu":
        return whdia_spmm_plain(values, slot_r0, tile_r0, tile_base,
                                chunk_group, x, chunk_tiles=chunk_tiles,
                                group_hacks=group_hacks, num_groups=num_groups,
                                tile_page=tile_page)
    hacks = num_groups * group_hacks
    lists = _list_ptrs("whdia_spmm", hack_slot_ptr, hack_slots, hacks, dev)
    lib = _LIB.load()
    n_rhs, n_cols = x.shape
    z = torch.empty((n_rhs, hacks * 128), dtype=x.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.whdia_spmm(
        values.data_ptr(), *_r0_ptrs(slot_r0, tile_r0), tile_page.data_ptr(),
        *lists, x.data_ptr(), z.data_ptr(), hacks, n_cols, hacks * 128, n_rhs,
        stream)
    if err != 0:
        raise RuntimeError(f"whdia_spmm launch failed: CUDA error {err}")
    global LAUNCHES_SPMM
    LAUNCHES_SPMM += 1
    return z


def whdia_spmv_plain(values, slot_r0, tile_r0, tile_base, chunk_group, x, *,
                     chunk_tiles: int, group_hacks: int, num_groups: int,
                     tile_page: torch.Tensor) -> torch.Tensor:
    """The same product in plain PyTorch: :func:`whdia_spmm_plain` with
    one RHS."""
    return whdia_spmm_plain(values, slot_r0, tile_r0, tile_base, chunk_group,
                            x.unsqueeze(0), chunk_tiles=chunk_tiles,
                            group_hacks=group_hacks, num_groups=num_groups,
                            tile_page=tile_page)[0]


def whdia_spmm_plain(values, slot_r0, tile_r0, tile_base, chunk_group, x, *,
                     chunk_tiles: int, group_hacks: int, num_groups: int,
                     tile_page: torch.Tensor) -> torch.Tensor:
    """The multi-RHS product in plain PyTorch, vectorised over the RHS
    axis of ``x`` ``(n_rhs, n_cols)``, on the operands' device, in x's
    type: decode r0 once, gather ``(n_rhs, T, 8, 128)`` with the
    ``[0, n_cols)`` guard, sum over each tile's 8 slots, then
    ``index_add_`` into the rows."""
    n_rhs = x.shape[0]
    tile_sum = whdia_tile_sums(values, slot_r0, tile_r0, tile_base, x,
                               tile_page=tile_page)
    z = torch.zeros((n_rhs, num_groups * group_hacks, 128), dtype=x.dtype,
                    device=x.device)
    z.index_add_(1, whdia_tile_hacks(tile_base, chunk_group, chunk_tiles,
                                     group_hacks), tile_sum)
    return z.view(n_rhs, -1)


def whdia_spmm_listed_plain(values, slot_r0, tile_r0, tile_base, hack_slot_ptr,
                            hack_slots, x, *, group_hacks: int, num_groups: int,
                            tile_page: torch.Tensor) -> torch.Tensor:
    """The hack pass's product in plain PyTorch, ``(n_rhs,
    num_groups*group_hacks*128)`` for ``x`` ``(n_rhs, n_cols)``: each row
    sums only its hack's listed slots (``hack_slots[hack_slot_ptr[h] :
    hack_slot_ptr[h + 1]]``), in list order, as the kernel does (it fuses
    each multiply-add; here they round apart); x is read as 0 outside
    ``[0, n_cols)``.  Rows of a hack with no listed slot are 0."""
    n_rhs, n_cols = x.shape
    col = whdia_listed_columns(slot_r0, tile_r0, tile_base, hack_slots,
                               tile_page=tile_page)
    col = torch.where((col >= 0) & (col < n_cols), col, n_cols)
    xz = torch.cat([x, x.new_zeros(n_rhs, 1)], dim=1)  # index n_cols reads 0
    prod = values[hack_slots.long()] * xz[:, col]  # (n_rhs, L, 128)
    return whdia_listed_sum(prod, hack_slot_ptr, num_groups * group_hacks)


def whdia_listed_columns(slot_r0, tile_r0, tile_base, hack_slots,
                         tile_page: torch.Tensor) -> torch.Tensor:
    """The x column of each cell of each listed slot, ``(L, 128)`` int64,
    unguarded, in list order."""
    return whdia_columns(slot_r0, tile_r0, tile_base,
                         tile_page=tile_page).view(-1, 128)[hack_slots.long()]


def whdia_listed_sum(terms, hack_slot_ptr, hacks: int) -> torch.Tensor:
    """Each hack's rows, ``(n_rhs, hacks*128)``: the sum of the terms
    ``(n_rhs, L, 128)`` of its listed slots (``hack_slot_ptr[h] :
    hack_slot_ptr[h + 1]``), added in list order; 0 for a hack with
    none."""
    n_rhs, L = terms.shape[:2]
    z = torch.zeros((n_rhs, hacks, 128), dtype=terms.dtype, device=terms.device)
    if L:
        ptr = hack_slot_ptr.long()
        counts = ptr[1:] - ptr[:-1]
        hack = torch.repeat_interleave(torch.arange(hacks, device=z.device), counts)
        rank = torch.arange(L, device=z.device) - ptr[hack]
        for k in range(int(counts.max())):
            sel = rank == k  # at most one slot of each hack
            z[:, hack[sel]] += terms[:, sel]
    return z.view(n_rhs, -1)


def whdia_columns(slot_r0, tile_r0, tile_base,
                  tile_page: torch.Tensor) -> torch.Tensor:
    """Each cell's x column ``base*128 + r0 + lane``, ``(T, 8, 128)``
    int64, unguarded: the base page from ``tile_page``, r0 from
    ``slot_r0`` (slab mode) or decoded from the tile's ``tile_r0`` word
    (pattern mode)."""
    dev = tile_base.device
    T = tile_base.shape[0]
    base = tile_page.long()
    if slot_r0 is not None:
        r0 = slot_r0.long().view(T, 8)
    else:
        w = tile_r0.long() & 0xFFFFFFFF
        r00 = (w & 0xFFFF) - 1024
        f1 = (w >> 16) & 0x7
        step = ((w >> 19) & 0x1FFF) - 4096
        s = torch.arange(8, device=dev)
        r0 = r00[:, None] + step[:, None] * torch.minimum(s[None, :], f1[:, None])
    return ((base * 128)[:, None] + r0)[:, :, None] + torch.arange(128, device=dev)


def whdia_tile_sums(values, slot_r0, tile_r0, tile_base, x,
                    tile_page: torch.Tensor) -> torch.Tensor:
    """Each tile's lane sums over its 8 slots, ``(n_rhs, T, 128)``, of the
    product with every row of ``x`` ``(n_rhs, n_cols)``: x is read as 0
    outside ``[0, n_cols)``."""
    n_rhs, n_cols = x.shape
    T = tile_base.shape[0]
    col = whdia_columns(slot_r0, tile_r0, tile_base, tile_page=tile_page)
    col = torch.where((col >= 0) & (col < n_cols), col, n_cols)
    xz = torch.cat([x, x.new_zeros(n_rhs, 1)], dim=1)  # index n_cols reads 0
    return (values.view(T, 8, 128) * xz[:, col]).sum(dim=2)


def whdia_tile_hacks(tile_base, chunk_group, chunk_tiles: int,
                     group_hacks: int) -> torch.Tensor:
    """Each tile's output row block (hack), ``(T,)`` int64."""
    T = tile_base.shape[0]
    return chunk_group.long()[torch.arange(T, device=tile_base.device) // chunk_tiles] \
        * group_hacks + (tile_base.long() >> 16)
