"""The ranks of a distributed run: one process per shard, joined by
``torch.distributed``.

Counterpart of ``make_row_mesh`` (:mod:`spgpu_tpu.parallel.partition`):
where the JAX package runs every shard inside one ``shard_map`` over a
device mesh, the port runs one process per shard.  A :class:`RankGroup`
holds a process's rank, the world size, its device and the process group:
NCCL on a CUDA device, gloo on the CPU.  The group meets through a
``file://`` store at a path the caller gives, so no TCP port is taken and
no network is used.  The device is the card (``cuda:rank`` modulo the
cards present) unless the caller asks for the CPU.

:func:`run_ranks` is the launcher: it starts ``n`` processes of the rank
entry (``python -m spgpu_tpu_torch.parallel._rank``), each of which joins
the group and calls a function named by ``"module:function"`` with its
:class:`RankGroup` and the caller's arguments, and returns every rank's
result.  The ranks import only that module and what it imports, so a
caller (a test module, say) need not be importable there.  Each process
is joined under a timeout, and the group's own timeout makes a rank whose
peer never answers fail instead of waiting for ever.
"""

from __future__ import annotations

import dataclasses
import datetime
import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any

import torch
import torch.distributed as dist

__all__ = ["RankGroup", "destroy_rank_group", "init_rank_group", "run_ranks"]

#: seconds a collective or point-to-point wait may take before it fails
GROUP_TIMEOUT_S = 60.0


@dataclasses.dataclass
class RankGroup:
    """This process's place in a distributed run."""

    rank: int
    size: int
    device: torch.device
    #: the process group (torch.distributed's default group)
    group: Any


def init_rank_group(store: str, rank: int, size: int, device=None,
                    timeout_s: float = GROUP_TIMEOUT_S) -> RankGroup:
    """Join the ``size``-rank group meeting at the file ``store`` (a path
    every rank names alike; it must not hold an older group's store) as
    ``rank``.  ``device``: ``"cpu"`` for gloo on the CPU, else a CUDA
    device (default ``cuda:rank`` modulo the cards present; raises without
    one) for NCCL.  A collective or wait that outlasts ``timeout_s`` fails.
    One collective runs before the group is returned, so every rank has
    joined when this returns."""
    if device is None or str(device) == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA device is required (torch.cuda.is_available() "
                               "is False); pass device='cpu' for gloo on the CPU")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method="file://" + os.path.abspath(store), rank=rank, world_size=size,
        timeout=datetime.timedelta(seconds=timeout_s))
    rg = RankGroup(rank=rank, size=size, device=device, group=dist.group.WORLD)
    dist.all_reduce(torch.zeros(1, device=device), group=rg.group)
    return rg


def destroy_rank_group() -> None:
    """Leave and destroy this process's group."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_ranks(n: int, target: str, *args, device: str = "cuda",
              timeout_s: float = 2 * GROUP_TIMEOUT_S,
              group_timeout_s: float = GROUP_TIMEOUT_S, **kwargs) -> list:
    """Run ``target`` (``"module:function"``) on ``n`` ranks, each a new
    process that calls ``function(rank_group, *args, **kwargs)`` and
    returns what it returns (picklable), and give back the ranks' results
    in rank order.  ``device``: ``"cuda"`` (NCCL, one card a rank; raises
    without a card) unless the caller asks for ``"cpu"`` (gloo);
    ``group_timeout_s``: the group's timeout (:func:`init_rank_group`).
    As soon as a rank fails, the others are killed and ``RuntimeError``
    raised with its traceback and output; if the ranks have not all ended
    within ``timeout_s``, every rank is killed and ``TimeoutError``
    raised."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device is required (torch.cuda.is_available() "
                           "is False); pass device='cpu' for gloo on the CPU")
    with tempfile.TemporaryDirectory(prefix="spgpu_ranks_") as d:
        with open(os.path.join(d, "job.pkl"), "wb") as f:
            pickle.dump((target, args, kwargs, group_timeout_s), f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [_package_root()] + [p for p in os.environ.get("PYTHONPATH", "").split(
                os.pathsep) if p]))
        procs = []
        for r in range(n):
            with open(os.path.join(d, f"rank{r}.log"), "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "spgpu_tpu_torch.parallel._rank", d, str(r),
                     str(n), device], stdout=log, stderr=subprocess.STDOUT, env=env))

        def failure(r):
            with open(os.path.join(d, f"rank{r}.log")) as f:
                log = f.read()
            what = f"exited {procs[r].returncode} with no result"
            path = os.path.join(d, f"result{r}.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    what = pickle.load(f)[1]
            return f"{target}: rank {r} of {n} failed:\n{what}\n{log}"

        deadline = time.monotonic() + timeout_s
        try:
            while True:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    raise RuntimeError(failure(bad[0]))
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{target}: {n} ranks still running after "
                                       f"{timeout_s} s; killed")
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        out = []
        for r in range(n):
            with open(os.path.join(d, f"result{r}.pkl"), "rb") as f:
                out.append(pickle.load(f)[1])
        return out


def rank_main(d: str, rank: int, size: int, device: str) -> int:
    """One rank of :func:`run_ranks`: join the group, call the target,
    write ``(ok, result or traceback)``, leave the group."""
    if device == "cpu":
        torch.set_num_threads(1)
    with open(os.path.join(d, "job.pkl"), "rb") as f:
        target, args, kwargs, group_timeout_s = pickle.load(f)
    try:
        mod, name = target.split(":")
        fn = getattr(importlib.import_module(mod), name)
        rg = init_rank_group(os.path.join(d, "store"), rank, size, device,
                             timeout_s=group_timeout_s)
        try:
            result = (True, fn(rg, *args, **kwargs))
        finally:
            destroy_rank_group()
    except BaseException:  # report it to the launcher, whatever it was
        result = (False, traceback.format_exc())
    with open(os.path.join(d, f"result{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    return 0 if result[0] else 1

