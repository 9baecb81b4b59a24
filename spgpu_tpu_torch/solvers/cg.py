"""Krylov solvers: CG and BiCGSTAB, on any device.

Counterpart of :mod:`spgpu_tpu.solvers.cg` (``cg``, ``bicgstab``,
``jacobi_preconditioner``).  The JAX versions run the iteration as one
``lax.while_loop``; here it is a Python loop over PyTorch ops, in the
type of ``b``.  float64 vectors iterate in native float64, so the same
loops are also the counterparts of ``cg_dd`` and ``bicgstab_dd``, whose
double-float arithmetic the GPU does not need.  complex64 and complex128
vectors iterate in their complex type: ``cg`` for Hermitian
positive-definite systems (every CG scalar is the real part of a
conjugated product, as in ``cg_herm_planes``) and ``bicgstab`` with
sesquilinear products (``conj(u)·v``, as in ``bicgstab_planes``), so the
same loops are also the counterparts of those two and of their ``_dd``
variants, on one complex vector instead of ``[re, im]`` plane stacks.
Vectors and scalars stay on the device; the loop test reads one scalar per
iteration back to the host (a CUDA graph of the iteration is later work).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from spgpu_tpu_torch.core import real_part_dtype
from spgpu_tpu_torch.ops import blas1

__all__ = ["CgResult", "cg", "bicgstab", "jacobi_preconditioner"]


class CgResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: torch.Tensor  # 0-d, on the device
    converged: torch.Tensor  # 0-d bool, on the device


def jacobi_preconditioner(coo, device) -> torch.Tensor:
    """1/diag(A) from a host COO (duplicates summed, zero diagonal → 1),
    on ``device``."""
    d = np.zeros(coo.n_rows, dtype=coo.values.dtype)
    on_diag = coo.rows == coo.cols
    np.add.at(d, coo.rows[on_diag], coo.values[on_diag])
    d = np.where(d == 0, 1.0, d)
    return torch.from_numpy(np.asarray(1.0 / d)).to(device)


def _bnorm(dotp, b):
    bnorm = torch.sqrt(torch.real(dotp(b, b)))
    return torch.where(bnorm == 0, torch.ones_like(bnorm), bnorm)


def cg(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
       x0: Optional[torch.Tensor] = None, tol: float = 1e-10,
       maxiter: int = 1000, m_inv: Optional[torch.Tensor] = None) -> CgResult:
    """Preconditioned conjugate gradient for SPD ``A``, or Hermitian
    positive-definite ``A`` on complex vectors (``m_inv``: an optional
    diagonal preconditioner vector).  Every scalar is real: ``rz =
    Re<r,z>``, ``alpha = rz / Re<p,Ap>``, ``beta = rz_new / rz`` (a
    complex ``<p,Ap>`` would give alpha an imaginary part of rounding
    size).  Stops when ‖r‖ ≤ tol·‖b‖ or after ``maxiter`` iterations."""

    def dotp(u, v):
        return blas1.dot(u, v, conjugate=u.is_complex())

    def re_dot(u, v):
        return torch.real(dotp(u, v))

    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = r * m_inv if m_inv is not None else r
    rz = re_dot(r, z)
    thresh = tol * _bnorm(dotp, b)
    p = z
    k = 0
    while k < maxiter and bool(torch.sqrt(re_dot(r, r)) > thresh):
        ap = matvec(p)
        alpha = rz / re_dot(p, ap)
        x = blas1.axpby(alpha, p, 1.0, x)
        r = blas1.axpby(-alpha, ap, 1.0, r)
        z = r * m_inv if m_inv is not None else r
        rz_new = re_dot(r, z)
        p = blas1.axpby(1.0, z, rz_new / rz, p)
        rz = rz_new
        k += 1
    rnorm = torch.sqrt(re_dot(r, r))
    return CgResult(x, k, rnorm, rnorm <= thresh)


def bicgstab(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
             x0: Optional[torch.Tensor] = None, tol: float = 1e-10,
             maxiter: int = 1000,
             m_inv: Optional[torch.Tensor] = None) -> CgResult:
    """BiCGSTAB for general systems.  Complex vectors take sesquilinear
    products (``conj(r̂)·r``, ``conj(r̂)·v``, ``conj(t)·s``; ``<t,t>`` is
    real).  On breakdown (ρ, r̂·v or ω ≈ 0 — for complex, a squared
    modulus below ``tiny`` — or a non-finite residual) the iterate
    freezes and the loop stops."""
    cplx = b.is_complex()

    def dotp(u, v):
        return blas1.dot(u, v, conjugate=cplx)

    def small(s):
        if cplx:
            return s.real * s.real + s.imag * s.imag < tiny
        return torch.abs(s) < tiny

    def prec(v):
        return v * m_inv if m_inv is not None else v

    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    rhat = r
    thresh = tol * _bnorm(dotp, b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    p = v = torch.zeros_like(b)
    rho = alpha = omega = one
    tiny = torch.finfo(real_part_dtype(b.dtype)).tiny
    down = torch.zeros((), dtype=torch.bool, device=b.device)
    k = 0
    while k < maxiter and bool((torch.sqrt(torch.real(dotp(r, r))) > thresh)
                               & ~down):
        rho_new = dotp(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = prec(p)
        v = matvec(phat)
        rv = dotp(rhat, v)
        alpha = rho_new / rv
        s_vec = r - alpha * v
        shat = prec(s_vec)
        t = matvec(shat)
        tt = torch.real(dotp(t, t))
        ts = dotp(t, s_vec)
        omega_new = torch.where(tt == 0, torch.zeros_like(ts),
                                ts / torch.where(tt == 0, torch.ones_like(tt), tt))
        x_new = x + alpha * phat + omega_new * shat
        r_new = s_vec - omega_new * t
        down = (small(rho_new) | small(rv) | small(omega_new)
                | ~torch.isfinite(torch.real(dotp(r_new, r_new))))
        x = torch.where(down, x, x_new)
        r = torch.where(down, r, r_new)
        rho = rho_new
        omega = torch.where(down, omega, omega_new)
        k += 1
    rnorm = torch.sqrt(torch.real(dotp(r, r)))
    return CgResult(x, k, rnorm, rnorm <= thresh)
