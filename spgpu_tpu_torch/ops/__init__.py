"""Compute ops of the port: the WHELL, SDIA and WHDIA SpMVs and
multi-RHS SpMMs, the classic-layout SpMVs (ELL/OELL, HELL, DIA, HDIA,
BCOO), the hybrid split's SpMV, the format-generic ``spmv``, csput and
BLAS-1.

Counterpart of :mod:`spgpu_tpu.ops` for the ported paths.  Each SpMV and
fused SpMM runs its hand kernel (:mod:`spgpu_tpu_torch.kernels`) on CUDA
tensors and the kernel's plain PyTorch version on CPU tensors.
``whell_spmv``/``whell_spmm`` dispatch on the layout kind: a packed
``WhellMatrix`` works in lane space, a classic one and a ``PcellWhell``
in the original numbering, as do the SDIA and WHDIA ops.  The SpMMs
dispatch as the JAX ones do: packed WHELL is fused by default for
fp32/bf16 values, classic WHELL (fp32, bf16 and float64), SDIA and WHDIA
loop over their SpMV by default and fuse on ``fused=True``, pcell always
loops, and float64 and complex packed, SDIA and WHDIA matrices always
loop (``fused=True`` raises for them).

A float64 matrix takes and returns float64 vectors and its alpha/beta
epilogue runs in float64: the counterpart of the JAX package's
double-float branches (``_dd_epilogue`` on ``(2, n)`` hi/lo stacks).  A
complex64 or complex128 matrix takes and returns complex vectors of its
type, and alpha and beta may be Python complex numbers: the counterpart of
the JAX package's complex branches (the fused one-pass kernels and
``_complex_epilogue`` on ``[re, im]`` plane stacks).

The classic-layout SpMVs are plain torch on the layout's device
(:mod:`.spmv_plain`), as the JAX package computes them with XLA outside
any Pallas kernel; their ``impl="pallas"`` raises, as the JAX ops' does.
``hybrid_spmv`` runs the band part through the WHDIA kernel (#3 or #6)
and the rest through the packed WHELL kernel (#1 or #4) with one index
copy into its lane space and one gather back.  ``spmv`` dispatches on
the layout's type.
"""

from __future__ import annotations

from typing import Optional

import torch

from spgpu_tpu_torch.formats.bcoo import BcooMatrix
from spgpu_tpu_torch.formats.dia import DiaMatrix, SdiaMatrix
from spgpu_tpu_torch.formats.ell import EllMatrix
from spgpu_tpu_torch.formats.hdia import HdiaMatrix
from spgpu_tpu_torch.formats.hell import HellMatrix
from spgpu_tpu_torch.formats.hybrid import HybridMatrix
from spgpu_tpu_torch.formats.whdia import WhdiaMatrix
from spgpu_tpu_torch.formats.whell import CLASSIC_DTYPES, PcellWhell, WhellMatrix
from spgpu_tpu_torch.kernels import pcell as _pcell
from spgpu_tpu_torch.kernels import sdia as _sdia
from spgpu_tpu_torch.kernels import whdia as _whdia
from spgpu_tpu_torch.kernels import whell_classic as _classic
from spgpu_tpu_torch.kernels.whell import whell_packed_spmm, whell_packed_spmv
from spgpu_tpu_torch.ops import blas1
from spgpu_tpu_torch.ops.blas1 import *  # noqa: F401,F403  (re-export BLAS-1)
from spgpu_tpu_torch.ops.csput import ell_csput, hell_csput
from spgpu_tpu_torch.ops.spmv_plain import (dia_spmv_plain, ell_spmv_plain,
                                            hdia_spmv_plain, hell_spmv_plain)
from spgpu_tpu_torch.ops.spmv_plain import epilogue as _epilogue

__all__ = ["spmv", "ell_spmv", "hell_spmv", "dia_spmv", "hdia_spmv", "bcoo_spmv",
           "hybrid_spmv", "ell_csput", "hell_csput", "sdia_spmm", "sdia_spmv",
           "whdia_spmm", "whdia_spmv", "whell_spmm", "whell_spmv"] + blas1.__all__

#: the value dtypes whose SpMM has a fused kernel (#12-#14; bf16 on WHELL
#: only, the DIA converters take float32)
_FUSED = (torch.float32, torch.bfloat16)


def _prep_x(x: torch.Tensor, n_cols: int, x_pages: int,
            stack: bool = False) -> torch.Tensor:
    """Pad lane-space x — or each row of an ``(n_rhs, n_cols)`` stack
    (``stack``) — to ``x_pages * 128`` so every decoded column, padding
    cells included, is in range; view it as ``(x_pages, 128)`` (a stack
    as ``(n_rhs, x_pages, 128)``)."""
    _check_x(x, n_cols, stack)
    pad = x_pages * 128 - n_cols
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.contiguous().view(*x.shape[:-1], x_pages, 128)


def _check_x(x: torch.Tensor, n_cols: int, stack: bool = False,
             planes: Optional[torch.dtype] = None) -> None:
    """``x`` is ``(n_cols,)``, or ``(n_rhs, n_cols)`` with ``stack``, and
    of the ``planes``' dtype where given."""
    if x.dim() != 1 + stack or x.shape[-1] != n_cols:
        want = f"(n_rhs, {n_cols})" if stack else f"({n_cols},)"
        raise ValueError(f"x must have shape {want}, got {tuple(x.shape)}")
    if planes is not None and x.dtype != planes:
        raise ValueError(f"x: {planes} planes take a {planes} x, not {x.dtype}")


def _fused(a, fused, default: bool, op: str, kernels=_FUSED) -> bool:
    """The JAX SpMMs' dispatch: ``fused=True`` on a matrix whose value
    type has no fused kernel (``kernels``: float64 or complex, but for a
    classic WHELL layout's float64) raises, ``None`` takes ``default``
    where a fused kernel exists and the loop elsewhere."""
    has_kernel = a.values.dtype in kernels
    if fused and not has_kernel:
        raise NotImplementedError(
            f"fused SpMM covers fp32/bf16 {op} only; float64/complex "
            "matrices run the loop-of-SpMV path (omit fused or pass "
            "fused=False)")
    return default and has_kernel if fused is None else bool(fused)


def _require(a, cls, op: str) -> None:
    if not isinstance(a, cls):
        names = " or ".join(c.__name__ for c in (cls if isinstance(cls, tuple) else (cls,)))
        raise TypeError(f"{op} takes a {names}, not {type(a).__name__}")


def _classic_rows(a: WhellMatrix, acc: torch.Tensor) -> torch.Tensor:
    """The classic product in stored rows, ``(..., rows_padded)``, to the
    original rows, as the JAX wrapper does outside its kernel: scatter
    through ``row_perm`` (its padded tail is the identity), cut to
    ``n_rows``, then sum each row's ``ways`` virtual rows."""
    if a.row_perm is not None:
        out = torch.zeros_like(acc)
        out[..., a.row_perm.long()] = acc
        acc = out
    acc = acc[..., : a.n_rows]
    if a.ways > 1:
        acc = acc.reshape(*acc.shape[:-1], a.n_rows // a.ways, a.ways).sum(dim=-1)
    return acc


def whell_spmv(a, x: torch.Tensor, alpha=1.0, beta=0.0, y=None) -> torch.Tensor:
    """``z = beta*y + alpha*(A @ x)`` on a WHELL layout, on ``a``'s device.

    A packed :class:`WhellMatrix` takes ``x``, ``y`` and ``z`` in lane
    space, of the values' type for a float64, complex64 or complex128
    matrix, float32 for a float32 or bf16 one (kernels #1, #4, #7 and the
    complex128 kernel).  A classic one (kernel #15) and a
    :class:`PcellWhell` (kernel #17) take an ``(n_cols,)`` ``x`` in the
    original numbering, float64 on a float64 layout and float32 on a
    float32 or bf16 one, and give ``(n_rows,)`` of x's type (true rows,
    for a way-split layout)."""
    _require(a, (WhellMatrix, PcellWhell), "whell_spmv")
    if isinstance(a, PcellWhell):
        z = _pcell.pcell_spmv(
            a.values, a.residue, a.page_tab, a.run_hi, a.run_lo, a.tile_base,
            a.chunk_group, a.group_bases, _prep_x(x, a.n_cols, a.x_pages),
            chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
            window_pages=a.window_pages, num_groups=a.num_groups,
            tile_page=a.tile_page, hack_tiles=a.hack_tiles, hack_units=a.hack_units)
        return _epilogue(z.view(-1)[: a.n_rows], alpha, beta, y)
    if not a.packed:
        z = _classic.whell_classic_spmv(
            a.values, a.residue, a.page_tab, a.tile_base, a.chunk_group,
            _prep_x(x, a.n_cols, a.x_pages), num_groups=a.num_groups,
            work=a.work_list, work_sectors=a.work_sectors, tile_page=a.tile_page)
        return _epilogue(_classic_rows(a, z.view(-1)), alpha, beta, y)
    z = whell_packed_spmv(
        a.values, a.residue, a.page_tab, a.tile_base, a.chunk_group,
        a.group_bases, a.seg_lo, a.seg_hi, _prep_x(x, a.n_cols, a.x_pages),
        chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
        window_pages=a.window_pages, unit_segments=a.unit_segments,
        hack_units=a.hack_units, tile_page=a.tile_page)
    return _epilogue(z.view(-1)[: a.n_rows], alpha, beta, y)


def sdia_spmv(a: SdiaMatrix, x: torch.Tensor, alpha=1.0, beta=0.0,
              y=None) -> torch.Tensor:
    """``z = beta*y + alpha*(A @ x)`` on the SDIA layout (``x``: the
    ``(n_cols,)`` vector on ``a``'s device, of the planes' type; ``z``:
    ``(n_rows,)``).  A matrix with no diagonals gives zeros, as
    ``sdia_spmv_pallas`` and the double-float branch do."""
    _require(a, SdiaMatrix, "sdia_spmv")
    _check_x(x, a.n_cols, planes=a.values.dtype)
    if a.n_diags == 0:
        zero = torch.zeros(a.n_rows, dtype=x.dtype, device=x.device)
        return _epilogue(zero, 1, beta, y)
    z = _sdia.sdia_spmv(a.values, a.offset_table, x.contiguous(), n_rows=a.n_rows)
    return _epilogue(z, alpha, beta, y)


def whdia_spmv(a: WhdiaMatrix, x: torch.Tensor, alpha=1.0, beta=0.0,
               y=None) -> torch.Tensor:
    """``z = beta*y + alpha*(A @ x)`` on the WHDIA layout (``x``: the
    ``(n_cols,)`` vector on ``a``'s device, of the slab's type; ``z``:
    ``(n_rows,)``), in either r0 mode."""
    _require(a, WhdiaMatrix, "whdia_spmv")
    _check_x(x, a.n_cols)
    z = _whdia.whdia_spmv(
        a.values, a.slot_r0, a.tile_r0, a.tile_base, a.chunk_group,
        x.contiguous(), chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
        num_groups=a.num_groups, hack_slot_ptr=a.hack_slot_ptr,
        hack_slots=a.hack_slots, tile_page=a.tile_page)
    return _epilogue(z[: a.n_rows], alpha, beta, y)


def whell_spmm(a, x: torch.Tensor, alpha=1.0, beta=0.0, y=None,
               fused=None) -> torch.Tensor:
    """Multi-RHS ``Z = beta*Y + alpha*(A @ X)`` on a WHELL layout, ``x``
    ``(n_rhs, n_cols)`` and the result ``(n_rhs, n_rows)`` in the numbering
    of :func:`whell_spmv` (lane space for a packed layout), on ``a``'s
    device.

    As the JAX dispatch (``fused = packed and not special``): on a packed
    layout ``fused=None`` fuses for fp32 and bf16 values (kernel #12, the
    hack pass over ``hack_units``: each tile decoded once for every RHS;
    bf16 values take fp32 x) and loops
    :func:`whell_spmv` per RHS for float64 and complex ones (their
    kernels, each RHS with its own epilogue); on a classic layout
    ``fused=None`` loops kernel #15 and ``fused=True`` runs kernel #16
    (over the layout's ``work_list``, as #15; fp32 and bf16 values take an
    fp32 X, float64 ones a float64 X) with the same ``row_perm``/``ways``
    epilogue.  ``fused=False`` loops in every type; ``fused=True`` on a
    packed float64 or complex layout, or on a :class:`PcellWhell` (which
    has no fused kernel), raises ``NotImplementedError``."""
    _require(a, (WhellMatrix, PcellWhell), "whell_spmm")
    if isinstance(a, PcellWhell):
        if fused:
            raise NotImplementedError(
                "fused SpMM covers fp32/bf16 packed and classic WHELL; pcell "
                "runs the loop-of-SpMV path (omit fused or pass fused=False)")
        fuse = False
    else:
        fuse = (_fused(a, fused, True, "packed WHELL layouts") if a.packed
                else _fused(a, fused, False, "classic WHELL layouts", CLASSIC_DTYPES))
    if not fuse:
        _check_x(x, a.n_cols, stack=True)
        return torch.stack([
            whell_spmv(a, x[r], alpha=alpha, beta=beta,
                       y=None if y is None else y[r])
            for r in range(x.shape[0])])
    if not a.packed:
        zs = _classic.whell_classic_spmm(
            a.values, a.residue, a.page_tab, a.tile_base, a.chunk_group,
            _prep_x(x, a.n_cols, a.x_pages, stack=True), num_groups=a.num_groups,
            work=a.spmm_work, work_sectors=a.spmm_work_sectors, tile_page=a.tile_page)
        return _epilogue(_classic_rows(a, zs.flatten(1)), alpha, beta, y)
    zs = whell_packed_spmm(
        a.values, a.residue, a.page_tab, a.tile_base, a.chunk_group,
        a.group_bases, a.seg_lo, a.seg_hi,
        _prep_x(x, a.n_cols, a.x_pages, stack=True),
        chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
        window_pages=a.window_pages, unit_segments=a.unit_segments,
        hack_units=a.hack_units, tile_page=a.tile_page)
    return _epilogue(zs.flatten(1)[:, : a.n_rows], alpha, beta, y)


def sdia_spmm(a: SdiaMatrix, x: torch.Tensor, alpha=1.0, beta=0.0, y=None,
              fused=None) -> torch.Tensor:
    """Multi-RHS ``Z = beta*Y + alpha*(A @ X)`` on the SDIA layout, ``x``
    ``(n_rhs, n_cols)`` of the planes' type, the result ``(n_rhs,
    n_rows)``.

    ``fused=None`` (the JAX default) loops :func:`sdia_spmv` per RHS, in
    every type; ``fused=True`` runs kernel #14 in fp32 (each value read
    once for a block of RHS; bit-identical to the loop) and raises
    ``NotImplementedError`` for float64 and complex planes.  A matrix
    with no diagonals gives zeros."""
    _require(a, SdiaMatrix, "sdia_spmm")
    fuse = _fused(a, fused, False, "SDIA")
    _check_x(x, a.n_cols, stack=True, planes=a.values.dtype)
    if a.n_diags == 0:
        zero = torch.zeros((x.shape[0], a.n_rows), dtype=x.dtype, device=x.device)
        return _epilogue(zero, 1, beta, y)
    if fuse:
        zs = _sdia.sdia_spmm(a.values, a.offset_table, x.contiguous(),
                             n_rows=a.n_rows)
    else:
        zs = torch.stack([sdia_spmv(a, x[r]) for r in range(x.shape[0])])
    return _epilogue(zs, alpha, beta, y)


def whdia_spmm(a: WhdiaMatrix, x: torch.Tensor, alpha=1.0, beta=0.0, y=None,
               fused=None) -> torch.Tensor:
    """Multi-RHS ``Z = beta*Y + alpha*(A @ X)`` on the WHDIA layout, in
    either r0 mode, ``x`` ``(n_rhs, n_cols)`` of the slab's type, the
    result ``(n_rhs, n_rows)``.

    ``fused=None`` (the JAX default) loops :func:`whdia_spmv` per RHS, in
    every type; ``fused=True`` runs kernel #13 in fp32 (each live slot's r0
    decoded once for every RHS) and raises ``NotImplementedError`` for
    float64 and complex slabs."""
    _require(a, WhdiaMatrix, "whdia_spmm")
    fuse = _fused(a, fused, False, "WHDIA")
    _check_x(x, a.n_cols, stack=True)
    if fuse:
        zs = _whdia.whdia_spmm(
            a.values, a.slot_r0, a.tile_r0, a.tile_base, a.chunk_group,
            x.contiguous(), chunk_tiles=a.chunk_tiles,
            group_hacks=a.group_hacks, num_groups=a.num_groups,
            hack_slot_ptr=a.hack_slot_ptr, hack_slots=a.hack_slots,
            tile_page=a.tile_page)[:, : a.n_rows]
    else:
        zs = torch.stack([whdia_spmv(a, x[r]) for r in range(x.shape[0])])
    return _epilogue(zs, alpha, beta, y)


def _plain_impl(impl: str, fast: str) -> None:
    """The classic ops' ``impl``, as the JAX ops take it: "pallas" raises
    ``ValueError`` naming the layout with a hand kernel (``fast``); any
    other value runs the plain torch product."""
    if impl == "pallas":
        raise ValueError(f"the kernel fast path runs on the {fast}")


def ell_spmv(a: EllMatrix, x: torch.Tensor, alpha=1.0, beta=0.0, y=None,
             impl: str = "auto") -> torch.Tensor:
    """``z = beta*y + alpha*(A @ x)`` on ELL/OELL (spGPU's
    ``spgpu?ellspmv``), ``x`` ``(..., n_cols)`` on ``a``'s device; plain
    torch.  The kernel path is packed WHELL (:func:`whell_spmv`)."""
    _require(a, EllMatrix, "ell_spmv")
    _plain_impl(impl, "WHELL layout: convert.coo_to_whell + ops.whell_spmv")
    return ell_spmv_plain(a, x, alpha, beta, y)


def hell_spmv(a: HellMatrix, x: torch.Tensor, alpha=1.0, beta=0.0, y=None,
              impl: str = "auto") -> torch.Tensor:
    """``z = beta*y + alpha*(A @ x)`` on HELL (``spgpu?hellspmv``); plain
    torch, each hack summed in slot order (the same bits every call)."""
    _require(a, HellMatrix, "hell_spmv")
    _plain_impl(impl, "WHELL layout: convert.coo_to_whell + ops.whell_spmv")
    return hell_spmv_plain(a, x, alpha, beta, y)


def dia_spmv(a: DiaMatrix, x: torch.Tensor, alpha=1.0, beta=0.0, y=None,
             impl: str = "auto") -> torch.Tensor:
    """``z = beta*y + alpha*(A @ x)`` on DIA (``spgpu?diaspmv``); plain
    torch.  The kernel paths are SDIA (``convert.dia_to_sdia`` +
    :func:`sdia_spmv`) and WHDIA."""
    _require(a, DiaMatrix, "dia_spmv")
    _plain_impl(impl, "SDIA layout (convert.dia_to_sdia + ops.sdia_spmv) or "
                "WHDIA (convert.coo_to_whdia + ops.whdia_spmv)")
    return dia_spmv_plain(a, x, alpha, beta, y)


def hdia_spmv(a: HdiaMatrix, x: torch.Tensor, alpha=1.0, beta=0.0, y=None,
              impl: str = "auto") -> torch.Tensor:
    """``z = beta*y + alpha*(A @ x)`` on HDIA (``spgpu?hdiaspmv``); plain
    torch, each hack summed in slot order."""
    _require(a, HdiaMatrix, "hdia_spmv")
    _plain_impl(impl, "WHDIA layout: convert.coo_to_whdia + ops.whdia_spmv")
    return hdia_spmv_plain(a, x, alpha, beta, y)


def bcoo_spmv(a: BcooMatrix, x: torch.Tensor, alpha=1.0, beta=0.0,
              y=None) -> torch.Tensor:
    """``z = beta*y + alpha*(A @ x)`` on BCOO (spGPU ships the format but
    no product; the JAX package adds this one): one batched product of the
    dense blocks with their x blocks (``torch.einsum``), added into the
    block rows by ``index_add_``."""
    _require(a, BcooMatrix, "bcoo_spmv")
    br, bc = a.block_rows, a.block_cols
    nbc, nbr = a.n_block_cols, a.n_block_rows
    xp = torch.nn.functional.pad(x, (0, nbc * bc - a.n_cols))
    xg = xp.reshape(*x.shape[:-1], nbc, bc)[..., a.block_col_idx, :]  # (..., B, bc)
    prod = torch.einsum("brc,...bc->...br", a.blocks, xg)  # (..., B, br)
    zb = prod.new_zeros(prod.shape[:-2] + (nbr, br))
    zb.index_add_(-2, a.block_row_idx, prod)
    return _epilogue(zb.reshape(*zb.shape[:-2], nbr * br)[..., : a.n_rows],
                     alpha, beta, y)


def hybrid_spmv(a: HybridMatrix, x: torch.Tensor, alpha=1.0, beta=0.0,
                y=None) -> torch.Tensor:
    """``z = beta*y + alpha*(A @ x)`` on the hybrid split, ``x`` and ``z``
    ``(n,)`` in the original numbering, of the matrix's type: the band
    through :func:`whdia_spmv` (kernel #3, #6 in float64), the rest
    through :func:`whell_spmv` in its lane space (kernel #1, #4), crossing
    by one index copy in and one gather out.  No fallback: on CUDA tensors
    a kernel that fails to build or launch raises."""
    _require(a, HybridMatrix, "hybrid_spmv")
    z = None if a.band is None else whdia_spmv(a.band, x)
    if a.rest is not None:
        zr = a.extract_rest(whell_spmv(a.rest, a.embed_rest(x)))
        z = zr if z is None else z + zr
    return _epilogue(z, alpha, beta, y)


def spmv(a, x: torch.Tensor, alpha=1.0, beta=0.0, y=None, **kw) -> torch.Tensor:
    """Format-generic ``z = beta*y + alpha*(A @ x)``: the op of ``a``'s
    layout type (a packed :class:`WhellMatrix` in lane space, the others
    in the original numbering).  Any other type raises ``TypeError``."""
    table = {EllMatrix: ell_spmv, HellMatrix: hell_spmv, DiaMatrix: dia_spmv,
             SdiaMatrix: sdia_spmv, HdiaMatrix: hdia_spmv, BcooMatrix: bcoo_spmv,
             WhellMatrix: whell_spmv, PcellWhell: whell_spmv,
             WhdiaMatrix: whdia_spmv, HybridMatrix: hybrid_spmv}
    try:
        fn = table[type(a)]
    except KeyError:
        raise TypeError(f"no SpMV for {type(a).__name__}") from None
    return fn(a, x, alpha, beta, y, **kw)
