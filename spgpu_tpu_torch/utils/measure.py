"""What a measurement on the card reports beside its times: the card
(:func:`nvidia_smi`), the least time the card could take
(:func:`bound`), and the check that makes a time worth reporting
(:func:`check_close`)."""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from spgpu_tpu_torch.core import HBM_BW_BY_KIND

__all__ = ["HBM_BYTES_PER_S", "PEAK_FLOPS", "bound", "check_close", "nbytes",
           "nvidia_smi"]

#: H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): HBM bytes/s
#: (the bandwidth table's H100 entry, ``core.HBM_BW_BY_KIND``), and FLOP/s
#: outside the tensor cores for each vector type (a complex type's
#: operations are those of its real parts)
HBM_BYTES_PER_S = HBM_BW_BY_KIND["H100 80GB HBM3"]
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "complex64": 67e12,
              "complex128": 34e12}


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def nbytes(*tensors) -> int:
    """Bytes held by the tensors (None counts 0)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(moved: int, flops: int, dtype: str) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the peak for their type."""
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=moved, bound_flops=flops)


def check_close(got, want, rtol: float, atol_frac: float, what: str) -> float:
    """``allclose`` on the host in float64 (complex128 for complex values)
    with ``atol = atol_frac * max|want|``, of tensors or arrays; raises
    ``AssertionError``; returns ``max|got - want|``."""
    got, want = (np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
                 for v in (got, want))
    dt = np.complex128 if np.iscomplexobj(got) or np.iscomplexobj(want) else np.float64
    got, want = got.astype(dt), want.astype(dt)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        raise AssertionError(f"{what}: shape {got.shape} vs {want.shape} or "
                             "non-finite values")
    atol = atol_frac * float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)
    return float(np.abs(got - want).max(initial=0.0))
