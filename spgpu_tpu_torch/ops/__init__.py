"""Compute ops of the port: the WHELL, SDIA and WHDIA SpMVs and
multi-RHS SpMMs, and BLAS-1.

Counterpart of :mod:`spgpu_tpu.ops` for the ported paths.  Each SpMV and
fused SpMM runs its hand kernel (:mod:`spgpu_tpu_torch.kernels`) on CUDA
tensors and the kernel's plain PyTorch version on CPU tensors.
``whell_spmv``/``whell_spmm`` dispatch on the layout kind: a packed
``WhellMatrix`` works in lane space, a classic one and a ``PcellWhell``
in the original numbering, as do the SDIA and WHDIA ops.  The SpMMs
dispatch as the JAX ones do: packed WHELL is fused by default for
fp32/bf16 values, classic WHELL, SDIA and WHDIA loop over their SpMV by
default and fuse on ``fused=True``, pcell always loops, and float64 and
complex matrices always loop (``fused=True`` raises for them).

A float64 matrix takes and returns float64 vectors and its alpha/beta
epilogue runs in float64: the counterpart of the JAX package's
double-float branches (``_dd_epilogue`` on ``(2, n)`` hi/lo stacks).  A
complex64 or complex128 matrix takes and returns complex vectors of its
type, and alpha and beta may be Python complex numbers: the counterpart of
the JAX package's complex branches (the fused one-pass kernels and
``_complex_epilogue`` on ``[re, im]`` plane stacks).
"""

from __future__ import annotations

from typing import Optional

import torch

from spgpu_tpu_torch.formats.dia import SdiaMatrix
from spgpu_tpu_torch.formats.whdia import WhdiaMatrix
from spgpu_tpu_torch.formats.whell import PcellWhell, WhellMatrix
from spgpu_tpu_torch.kernels import pcell as _pcell
from spgpu_tpu_torch.kernels import sdia as _sdia
from spgpu_tpu_torch.kernels import whdia as _whdia
from spgpu_tpu_torch.kernels import whell_classic as _classic
from spgpu_tpu_torch.kernels.whell import whell_packed_spmm, whell_packed_spmv
from spgpu_tpu_torch.ops import blas1
from spgpu_tpu_torch.ops.blas1 import *  # noqa: F401,F403  (re-export BLAS-1)

__all__ = ["sdia_spmm", "sdia_spmv", "whdia_spmm", "whdia_spmv", "whell_spmm",
           "whell_spmv"] + blas1.__all__

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


def _fused(a, fused, default: bool, op: str) -> bool:
    """The JAX SpMMs' dispatch: ``fused=True`` on a float64 or complex
    matrix raises, ``None`` takes ``default`` where a fused kernel exists
    and the loop elsewhere."""
    has_kernel = a.values.dtype in _FUSED
    if fused and not has_kernel:
        raise NotImplementedError(
            f"fused SpMM covers fp32/bf16 {op} only; float64/complex "
            "matrices run the loop-of-SpMV path (omit fused or pass "
            "fused=False)")
    return default and has_kernel if fused is None else bool(fused)


def _epilogue(acc: torch.Tensor, alpha, beta, y) -> torch.Tensor:
    """``beta*y + alpha*acc`` in ``acc``'s type (alpha and beta may be
    complex for a complex ``acc``); a static ``beta == 0`` (or ``y is
    None``) never reads ``y``, as in spGPU's ``*spmv`` entry points."""
    static = (int, float, complex)
    if (isinstance(beta, static) and beta == 0) or y is None:
        return acc if isinstance(alpha, static) and alpha == 1 else alpha * acc
    return alpha * acc + beta * y


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
    :class:`PcellWhell` (kernel #17) take an ``(n_cols,)`` float32 ``x``
    in the original numbering and give ``(n_rows,)`` (true rows, for a
    way-split layout)."""
    _require(a, (WhellMatrix, PcellWhell), "whell_spmv")
    if isinstance(a, PcellWhell):
        z = _pcell.pcell_spmv(
            a.values, a.residue, a.page_tab, a.run_hi, a.run_lo, a.tile_base,
            a.chunk_group, a.group_bases, _prep_x(x, a.n_cols, a.x_pages),
            chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
            window_pages=a.window_pages, num_groups=a.num_groups,
            tile_page=a.tile_page)
        return _epilogue(z.view(-1)[: a.n_rows], alpha, beta, y)
    if not a.packed:
        z = _classic.whell_classic_spmv(
            a.values, a.residue, a.page_tab, a.tile_base, a.chunk_group,
            _prep_x(x, a.n_cols, a.x_pages), num_groups=a.num_groups,
            work=a.work_list, tile_page=a.tile_page)
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
    (over the layout's ``work_list``, as #15) with the same
    ``row_perm``/``ways`` epilogue.  ``fused=False`` loops
    in every type; ``fused=True`` on float64 or complex values, or on a
    :class:`PcellWhell` (which has no fused kernel), raises
    ``NotImplementedError``."""
    _require(a, (WhellMatrix, PcellWhell), "whell_spmm")
    if isinstance(a, PcellWhell):
        if fused:
            raise NotImplementedError(
                "fused SpMM covers fp32/bf16 packed and classic WHELL; pcell "
                "runs the loop-of-SpMV path (omit fused or pass fused=False)")
        fuse = False
    else:
        fuse = _fused(a, fused, a.packed, "packed and classic WHELL layouts")
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
            work=a.work_list, tile_page=a.tile_page)
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
