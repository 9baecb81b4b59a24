"""Hand-written GPU kernels, each beside its plain PyTorch version and a
launch counter.  Sources live in ``spgpu_tpu_torch/csrc/`` and are built
on first launch (:mod:`spgpu_tpu_torch.kernels._build`)."""

from spgpu_tpu_torch.kernels import (  # noqa: F401
    ablation,
    pcell,
    sdia,
    whdia,
    whell,
    whell_classic,
)
