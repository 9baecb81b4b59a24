"""Helpers shared by the classic layouts' dataclasses (ELL, HELL, DIA,
HDIA, BCOO, BHDIA): byte counts, the NumPy bridge and device moves."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from spgpu_tpu_torch.utils.measure import nbytes  # noqa: F401  (re-exported)

__all__ = ["bridge", "host", "nbytes", "tensor_or_none", "to_device"]


def tensor_or_none(a) -> Optional[torch.Tensor]:
    """A NumPy array (or None) as a CPU tensor (a copy, so the tensor
    owns its memory)."""
    return None if a is None else torch.from_numpy(np.array(a))


def to_device(obj, device, names):
    """A copy of dataclass ``obj`` with its tensor fields ``names`` on
    ``device``."""
    return dataclasses.replace(obj, **{
        n: None if getattr(obj, n) is None else getattr(obj, n).to(device)
        for n in names})


def host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def bridge(cls, fields: dict):
    """A ``cls`` layout on the CPU from a JAX layout's fields by name: its
    array fields (``cls._TENSORS``) as NumPy arrays or None, each copied
    into a tensor of the same type, and its static fields as they are.
    Raises ``ValueError`` on a missing or unknown field."""
    names = {f.name for f in dataclasses.fields(cls)}
    if set(fields) != names:
        raise ValueError(f"{cls.__name__} fields: missing {sorted(names - set(fields))}, "
                         f"unknown {sorted(set(fields) - names)}")
    return cls(**{k: tensor_or_none(v) if k in cls._TENSORS else v
                  for k, v in fields.items()})
