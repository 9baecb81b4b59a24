"""Rank-side helpers of the distributed tests (not a test module): a rank
process of :func:`spgpu_tpu_torch.parallel.group.run_ranks` imports this
file alone, so it loads no JAX and nothing of ``tests/conftest.py``."""

import sys
import time

import torch
import torch.distributed as dist


def loaded_modules(rg):
    """The JAX and JAX-package modules this rank process has loaded."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "spgpu_tpu"))


def one_rank_never_joins(rg):
    """Rank 0 waits in a collective that no other rank joins."""
    if rg.rank == 0:
        dist.all_reduce(torch.ones(1), group=rg.group)
    else:
        time.sleep(600)


def every_rank_sleeps(rg):
    time.sleep(600)
