"""Hand-written GPU kernels, each beside its plain PyTorch version and a
launch counter.  Sources live in ``spgpu_tpu_torch/csrc/`` and are built
on first launch (:mod:`spgpu_tpu_torch.kernels._build`).

Each wrapper adds one to its module's ``LAUNCHES*`` counter where it
launches its kernel.  A launch captured in a CUDA graph runs once per
replay: :func:`launch_counts_since` gives what a capture added and
:func:`add_launches` adds it per replay (the Krylov loop,
:mod:`spgpu_tpu_torch.solvers.cg`, does)."""

from spgpu_tpu_torch.kernels import (  # noqa: F401
    ablation,
    pcell,
    sdia,
    whdia,
    whell,
    whell_classic,
)

_MODULES = (ablation, pcell, sdia, whdia, whell, whell_classic)


def launch_counts() -> dict:
    """Every launch counter of the kernel modules, ``{(module, name):
    count}``."""
    return {(m, name): getattr(m, name) for m in _MODULES for name in dir(m)
            if name.startswith("LAUNCHES")}


def reset_launch_counts() -> None:
    """Set every launch counter of the kernel modules to 0."""
    for m, name in launch_counts():
        setattr(m, name, 0)


def counter_name(key) -> str:
    """A key of :func:`launch_counts` as ``module.NAME``
    (``"whell.LAUNCHES"``)."""
    m, name = key
    return f"{m.__name__.rsplit('.', 1)[-1]}.{name}"


def launch_counts_since(before: dict) -> dict:
    """The counters that moved since ``before`` (:func:`launch_counts`),
    by how much."""
    return {key: n - before[key] for key, n in launch_counts().items()
            if n != before[key]}


def add_launches(counts: dict, times: int = 1) -> None:
    """Add ``times`` times ``counts`` (``{(module, name): n}``) to the
    counters."""
    for (m, name), n in counts.items():
        setattr(m, name, getattr(m, name) + times * n)
