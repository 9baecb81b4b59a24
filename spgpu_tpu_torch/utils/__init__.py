"""Fixtures (host NumPy) and CUDA-event timing."""

from spgpu_tpu_torch.utils.fixtures import (  # noqa: F401
    ctest_fixture,
    laplacian_2d,
    laplacian_3d,
    random_banded,
    random_fem_like,
    random_irregular,
    random_mixed,
)
