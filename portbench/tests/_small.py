"""Small runs of the benchmark's cells on the CPU for the tests."""

import time

import torch

from portbench import spec
from portbench.run import run_one

#: sizes the CPU runs each configuration at (the generator's keys)
SMALL = {"hpcg": {"nx": 16, "ny": 16, "nz": 16}, "pde3d": {"idim": 12}}

CELLS = ("hpcg-cg50", "hpcg-spmv", "pde3d-bicgstab")


def run_small(workload, root=spec.ROOT, seed=2**31 + 11, seconds=0.3, trace=False,
              make_program=None, device="cpu"):
    """The result line of ``workload`` at the small size on ``device``."""
    cell = spec.load_cell(workload, root)
    return run_one(cell, torch.device(device), seed, seconds, trace, time.perf_counter(),
                   params=SMALL[cell.config["generator"]], make_program=make_program)
