"""Compute ops of the port: the WHELL, SDIA and WHDIA SpMVs and BLAS-1.

Counterpart of :mod:`spgpu_tpu.ops` for the ported paths.  Each SpMV runs
its hand kernel (:mod:`spgpu_tpu_torch.kernels`) on CUDA tensors and the
kernel's plain PyTorch version on CPU tensors.  ``whell_spmv`` works in
lane space; ``sdia_spmv`` and ``whdia_spmv`` in the original numbering.

A float64 matrix takes and returns float64 vectors and its alpha/beta
epilogue runs in float64: the counterpart of the JAX package's
double-float branches (``_dd_epilogue`` on ``(2, n)`` hi/lo stacks).  A
complex64 or complex128 matrix takes and returns complex vectors of its
type, and alpha and beta may be Python complex numbers: the counterpart of
the JAX package's complex branches (the fused one-pass kernels and
``_complex_epilogue`` on ``[re, im]`` plane stacks).
"""

from __future__ import annotations

import torch

from spgpu_tpu_torch.formats.dia import SdiaMatrix
from spgpu_tpu_torch.formats.whdia import WhdiaMatrix
from spgpu_tpu_torch.formats.whell import WhellMatrix
from spgpu_tpu_torch.kernels import sdia as _sdia
from spgpu_tpu_torch.kernels import whdia as _whdia
from spgpu_tpu_torch.kernels.whell import whell_packed_spmv
from spgpu_tpu_torch.ops import blas1
from spgpu_tpu_torch.ops.blas1 import *  # noqa: F401,F403  (re-export BLAS-1)

__all__ = ["sdia_spmv", "whdia_spmv", "whell_spmv"] + blas1.__all__


def _prep_x(x: torch.Tensor, n_cols: int, x_pages: int) -> torch.Tensor:
    """Pad lane-space x to ``x_pages * 128`` so every decoded column —
    padding cells included — is in range; view it as ``(x_pages, 128)``."""
    if x.shape != (n_cols,):
        raise ValueError(f"x must have shape ({n_cols},), got {tuple(x.shape)}")
    pad = x_pages * 128 - n_cols
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.contiguous().view(x_pages, 128)


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
        raise TypeError(f"{op} takes a {cls.__name__}, not {type(a).__name__}")


def whell_spmv(a: WhellMatrix, x: torch.Tensor, alpha=1.0, beta=0.0,
               y=None) -> torch.Tensor:
    """``z = beta*y + alpha*(A @ x)`` on the packed WHELL layout, with
    ``x``, ``y`` and ``z`` in lane space, on ``a``'s device: of the
    values' type for a float64, complex64 or complex128 matrix, float32
    for a float32 or bf16 one."""
    _require(a, WhellMatrix, "whell_spmv")
    z = whell_packed_spmv(
        a.values, a.residue, a.page_tab, a.tile_base, a.chunk_group,
        a.group_bases, a.seg_lo, a.seg_hi, _prep_x(x, a.n_cols, a.x_pages),
        chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
        window_pages=a.window_pages, unit_segments=a.unit_segments)
    return _epilogue(z.view(-1)[: a.n_rows], alpha, beta, y)


def sdia_spmv(a: SdiaMatrix, x: torch.Tensor, alpha=1.0, beta=0.0,
              y=None) -> torch.Tensor:
    """``z = beta*y + alpha*(A @ x)`` on the SDIA layout (``x``: the
    ``(n_cols,)`` vector on ``a``'s device, of the planes' type; ``z``:
    ``(n_rows,)``).  A matrix with no diagonals gives zeros, as
    ``sdia_spmv_pallas`` and the double-float branch do."""
    _require(a, SdiaMatrix, "sdia_spmv")
    if x.shape != (a.n_cols,):
        raise ValueError(f"x must have shape ({a.n_cols},), got {tuple(x.shape)}")
    if x.dtype != a.values.dtype:
        raise ValueError(f"x: {a.values.dtype} planes take a {a.values.dtype} x, "
                         f"not {x.dtype}")
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
    if x.shape != (a.n_cols,):
        raise ValueError(f"x must have shape ({a.n_cols},), got {tuple(x.shape)}")
    z = _whdia.whdia_spmv(
        a.values, a.slot_r0, a.tile_r0, a.tile_base, a.chunk_group,
        x.contiguous(), chunk_tiles=a.chunk_tiles, group_hacks=a.group_hacks,
        num_groups=a.num_groups)
    return _epilogue(z[: a.n_rows], alpha, beta, y)
