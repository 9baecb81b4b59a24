"""The control: the plain reference put in the program's place, computed
in the precision below the configuration's (float32 for float64).  A
limit holds only if the control fails it; :mod:`portbench.calibrate` runs
it on the card, the tests at a small size.  The benchmark's runs never
run it."""

from __future__ import annotations

import torch

from portbench.reference import krylov

__all__ = ["Control"]

#: the precision below each stated one
BELOW = {torch.float64: torch.float32}


class Control:
    """The reference's product and loops over the matrix in the type below
    its own, with the program's interface: vectors go in and come out in
    the matrix's type."""

    fmt = "control"

    def __init__(self, matrix, device):
        self.dtype = getattr(torch, matrix.dtype)
        self.low = BELOW[self.dtype]
        self.ref = matrix.reference(device, self.low)

    def into(self, v) -> torch.Tensor:
        return torch.as_tensor(v).to(self.ref.a.device, self.low)

    def out(self, v: torch.Tensor) -> torch.Tensor:
        return v.to(self.dtype)

    def product(self, v: torch.Tensor) -> torch.Tensor:
        return self.ref(v)

    def solve(self, b, solver: str, tol: float, maxiter: int):
        b = self.into(b)
        x, k, rnorm = getattr(krylov, solver)(self.ref, b, tol, maxiter)
        converged = rnorm <= tol * float(torch.linalg.vector_norm(b))
        return self.out(x), k, converged, rnorm
