"""Benchmark harness: spGPU's hellPerf/diaPerf protocol on the port.

Counterpart of :mod:`spgpu_tpu.bench`: warm-up product → ‖z‖² checksum
→ timed product → GFLOPS = (2·nnz − 1)/t, with each row's bytes, device
time and its source, as one JSON line per format and configuration
(:mod:`.harness`).  It writes no file.
"""

__all__ = ["BenchResult", "run_config", "run_suite", "run_weak_scaling",
           "run_blas1_suite", "run_baseline_rows"]


def __getattr__(name):
    # loaded on first use, so that ``python -m spgpu_tpu_torch.bench.harness``
    # runs the module once, as ``__main__``
    if name in __all__:
        from spgpu_tpu_torch.bench import harness

        return getattr(harness, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
