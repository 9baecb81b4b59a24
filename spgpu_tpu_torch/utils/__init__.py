"""Fixtures (host NumPy), spGPU's benchmark protocol and profiling."""

from spgpu_tpu_torch.utils.fixtures import (  # noqa: F401
    ctest_fixture,
    laplacian_2d,
    laplacian_3d,
    random_banded,
    random_fem_like,
    random_irregular,
    random_mixed,
)
from spgpu_tpu_torch.utils.profiling import roofline_report, time_op, trace  # noqa: F401
from spgpu_tpu_torch.utils.timing import BenchResult, Clock, benchmark_op  # noqa: F401
