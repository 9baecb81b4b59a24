"""BLAS-1 / vector operation suite in plain PyTorch.

Counterpart of :mod:`spgpu_tpu.ops.blas1`, with the same semantics:

* reductions (dot/nrm2/asum/amax) return 0-d tensors on the operands'
  device, so a solver loop reads them only where it must;
* complex ``dot`` is NON-conjugated like spGPU's ``zdot`` (pass
  ``conjugate=True`` for the sesquilinear product); ``abs``/``asum``/
  ``amax`` use the modulus and return real;
* ``gath``/``scat`` skip negative positions after base subtraction, and
  ``scat`` applies ``beta`` only to touched entries;
* the m-variants take stacked ``(count, n)`` operands.

Every function returns a new tensor and leaves its inputs unchanged, as
the JAX functions do.  These are elementwise passes and reductions that
PyTorch runs as its own kernels; none of them was a Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "scal", "axpby", "axy", "axypbz", "abs_", "setscal",
    "dot", "nrm2", "asum", "amax",
    "gath", "scat",
    "mdot", "mnrm2", "masum", "mamax", "maxpby", "maxy", "maxypbz", "mscal",
]


def _is_static_zero(v) -> bool:
    return isinstance(v, (int, float, complex)) and v == 0


def scal(alpha, x: torch.Tensor) -> torch.Tensor:
    """``y = alpha * x``."""
    return alpha * x


def axpby(alpha, x: torch.Tensor, beta, y: torch.Tensor) -> torch.Tensor:
    """``z = beta*y + alpha*x``; a static ``beta == 0`` never reads y.  On
    real floating vectors a static 1 skips its multiply (``1.0 * v`` is
    ``v`` bit for bit there; a complex product by 1 can flip a zero's
    sign, so complex vectors keep it)."""
    if _is_static_zero(beta):
        return alpha * x
    ax = x if _is_static_one(alpha, x) else alpha * x
    return ax + (y if _is_static_one(beta, y) else beta * y)


def _is_static_one(v, t: torch.Tensor) -> bool:
    return (isinstance(v, (int, float)) and v == 1 and t.is_floating_point())


def axy(alpha, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``z = alpha * x * y`` (Hadamard)."""
    return alpha * x * y


def axypbz(alpha, x: torch.Tensor, y: torch.Tensor, beta,
           z: torch.Tensor) -> torch.Tensor:
    """``w = beta*z + alpha*x*y`` (alpha == 0 → scal, beta == 0 → axy)."""
    if _is_static_zero(alpha):
        return scal(beta, z)
    if _is_static_zero(beta):
        return axy(alpha, x, y)
    return alpha * x * y + beta * z


def abs_(x: torch.Tensor, alpha=1.0) -> torch.Tensor:
    """``y = alpha * |x|``; complex input gives the real modulus."""
    m = torch.abs(x)
    if isinstance(alpha, (int, float)) and alpha == 1:
        return m
    return alpha * m


def setscal(y: torch.Tensor, val, first: int = 0,
            last: Optional[int] = None) -> torch.Tensor:
    """A copy of ``y`` with ``y[..., first:last] = val``."""
    out = y.clone()
    out[..., first:last] = val
    return out


def dot(a: torch.Tensor, b: torch.Tensor, conjugate: bool = False) -> torch.Tensor:
    """``a · b`` over the last axis; non-conjugated for complex unless
    ``conjugate=True`` (then ``conj(a) · b``)."""
    if conjugate:
        a = torch.conj(a)
    return torch.sum(a * b, dim=-1)


def nrm2(x: torch.Tensor) -> torch.Tensor:
    """‖x‖₂ over the last axis; complex returns real."""
    return torch.sqrt(torch.sum(torch.real(x * torch.conj(x)), dim=-1))


def asum(x: torch.Tensor) -> torch.Tensor:
    """Σ|xᵢ| (modulus for complex)."""
    return torch.sum(torch.abs(x), dim=-1)


def amax(x: torch.Tensor) -> torch.Tensor:
    """max|xᵢ|."""
    return torch.amax(torch.abs(x), dim=-1)


def gath(y: torch.Tensor, indices: torch.Tensor,
         out: Optional[torch.Tensor] = None, base_index: int = 0) -> torch.Tensor:
    """``values[i] = y[indices[i] − base]``; where that position is
    negative the result keeps ``out``'s value (0 when ``out`` is None)."""
    pos = indices.long() - base_index
    ok = pos >= 0
    gathered = y[..., pos.clamp(0, y.shape[-1] - 1)]
    if out is None:
        out = torch.zeros_like(gathered)
    return torch.where(ok, gathered, out.to(gathered.dtype))


def scat(y: torch.Tensor, indices: torch.Tensor, values: torch.Tensor,
         beta=0.0, base_index: int = 0, mode: str = "store") -> torch.Tensor:
    """``y[pos] = beta*y[pos] + values[i]`` at touched positions only;
    negative positions are skipped and untouched entries keep ``y``.

    ``mode="store"``: duplicate indices leave one unspecified winner
    (spGPU's documented race).  ``mode="add"``: duplicates accumulate
    after the single ``beta`` scaling."""
    pos = indices.long() - base_index
    ok = pos >= 0
    n = y.shape[-1]
    safe = torch.where(ok, pos, n)  # skipped entries land past the end
    values = torch.as_tensor(values, device=y.device)
    if mode == "add":
        touched = torch.zeros(n + 1, dtype=torch.bool, device=y.device)
        touched[safe[ok]] = True
        sums = torch.zeros(y.shape[:-1] + (n + 1,), dtype=y.dtype, device=y.device)
        sums.index_add_(-1, safe, torch.where(ok, values, 0).to(y.dtype))
        scaled = torch.zeros_like(y) if _is_static_zero(beta) else y * beta
        return torch.where(touched[:n], scaled + sums[..., :n], y)
    y_ext = torch.cat([y, torch.zeros(y.shape[:-1] + (1,), dtype=y.dtype,
                                      device=y.device)], dim=-1)
    upd = values if _is_static_zero(beta) else beta * y_ext[..., safe] + values
    y_ext[..., safe] = upd.to(y.dtype)
    return y_ext[..., :n]


def mdot(a: torch.Tensor, b: torch.Tensor, conjugate: bool = False) -> torch.Tensor:
    """Per-row dot of two ``(count, n)`` multivectors → ``(count,)``."""
    return dot(a, b, conjugate)


def mnrm2(x: torch.Tensor) -> torch.Tensor:
    return nrm2(x)


def masum(x: torch.Tensor) -> torch.Tensor:
    return asum(x)


def mamax(x: torch.Tensor) -> torch.Tensor:
    return amax(x)


def mscal(alpha, x: torch.Tensor) -> torch.Tensor:
    return scal(alpha, x)


def maxpby(alpha, x: torch.Tensor, beta, y: torch.Tensor) -> torch.Tensor:
    return axpby(alpha, x, beta, y)


def maxy(alpha, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return axy(alpha, x, y)


def maxypbz(alpha, x: torch.Tensor, y: torch.Tensor, beta,
            z: torch.Tensor) -> torch.Tensor:
    return axypbz(alpha, x, y, beta, z)
