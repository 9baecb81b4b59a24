"""The reference product: a CSR matrix built from the generator's COO
arrays, multiplied by PyTorch's own sparse product."""

from __future__ import annotations

import warnings

import numpy as np
import torch

__all__ = ["CsrMatrix"]


class CsrMatrix:
    """``A`` in CSR on ``device`` in ``dtype``, from COO arrays whose rows
    ascend (the generators' order; duplicates would be kept and added)."""

    def __init__(self, rows: np.ndarray, cols: np.ndarray, values: np.ndarray, n: int,
                 device, dtype: torch.dtype):
        if rows.size and np.any(rows[1:] < rows[:-1]):
            raise ValueError("the reference takes COO arrays in row order")
        crow = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows, minlength=n), out=crow[1:])
        self.n = n
        with warnings.catch_warnings():  # "sparse CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            self.a = torch.sparse_csr_tensor(
                torch.from_numpy(crow).to(device), torch.from_numpy(cols).to(device),
                torch.from_numpy(values).to(device, dtype), size=(n, n),
                check_invariants=False)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """``A·x`` for a vector ``x``, or for each column of an ``(n, k)``
        block."""
        if x.dim() == 1:
            return (self.a @ x.unsqueeze(1)).squeeze(1)
        return self.a @ x
