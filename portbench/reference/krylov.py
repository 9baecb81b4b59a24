"""Textbook CG and BiCGSTAB (no preconditioner, x0 = 0), one host read of
the residual norm an iteration: the reference loops, in whatever type
the right-hand side has."""

from __future__ import annotations

from typing import Callable, Tuple

import torch

__all__ = ["bicgstab", "cg"]


def cg(matvec: Callable, b: torch.Tensor, tol: float,
       maxiter: int) -> Tuple[torch.Tensor, int, float]:
    """CG until ``‖r‖ <= tol·‖b‖`` or ``maxiter`` iterations; ``(x, k,
    ‖r‖)``, ``r`` the recursively updated residual."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rr = torch.dot(r, r)
    thresh = tol * float(torch.sqrt(torch.dot(b, b)))
    k = 0
    while k < maxiter and float(torch.sqrt(rr)) > thresh:
        ap = matvec(p)
        alpha = rr / torch.dot(p, ap)
        x += alpha * p
        r -= alpha * ap
        rr_new = torch.dot(r, r)
        p = r + (rr_new / rr) * p
        rr = rr_new
        k += 1
    return x, k, float(torch.sqrt(rr))


def bicgstab(matvec: Callable, b: torch.Tensor, tol: float,
             maxiter: int) -> Tuple[torch.Tensor, int, float]:
    """BiCGSTAB (van der Vorst) until ``‖r‖ <= tol·‖b‖``, ``maxiter``
    iterations or a breakdown (a zero ``rho``, ``r̂·v`` or ``t·t``);
    ``(x, k, ‖r‖)``, ``r`` the recursively updated residual."""
    x = torch.zeros_like(b)
    r = b.clone()
    rhat = r.clone()
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho, alpha, omega = one, one, one
    thresh = tol * float(torch.sqrt(torch.dot(b, b)))
    k = 0
    while k < maxiter and float(torch.sqrt(torch.dot(r, r))) > thresh:
        rho_new = torch.dot(rhat, r)
        p = r + (rho_new / rho) * (alpha / omega) * (p - omega * v)
        v = matvec(p)
        rv = torch.dot(rhat, v)
        if float(rho_new) == 0.0 or float(rv) == 0.0:
            break
        alpha = rho_new / rv
        s = r - alpha * v
        t = matvec(s)
        tt = torch.dot(t, t)
        if float(tt) == 0.0:
            break
        omega = torch.dot(t, s) / tt
        x += alpha * p + omega * s
        r = s - omega * t
        rho = rho_new
        k += 1
    return x, k, float(torch.sqrt(torch.dot(r, r)))
