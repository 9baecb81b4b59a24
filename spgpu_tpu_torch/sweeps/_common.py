"""What the sweeps share: the device, the timing of a set of levels, the
library yardstick, the prices and the printed lines."""

from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from spgpu_tpu_torch.core import require_cuda
from spgpu_tpu_torch.utils.measure import nvidia_smi
from spgpu_tpu_torch.utils.timing import device_ms, kernel_device_ms, time_interleaved

#: what the time fields say on a CPU run
CPU_TIMING = "not measured: a CPU run of the plain versions"
#: where the times of a card run come from
CARD_TIMING = ("device_ms: torch.profiler, the level's own kernels, calls back "
               "to back (warm L2); cold_device_ms: the same with the L2 "
               "flushed before every call (4x the L2 written, then another "
               "4x read); per_call_ms: CUDA events around "
               "20 Python calls, best of 5 interleaved reps; *_source: "
               "'profiler', or 'cuda_events' when no session was usable")


def sweep_device(device) -> torch.device:
    """``device`` as a torch device: a CUDA one must exist (raises
    otherwise: nothing falls back to the CPU); the CPU runs the plain
    versions."""
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
    elif dev.type != "cpu":
        raise ValueError(f"the sweeps run on cuda or cpu, not {dev}")
    return dev


def card(dev: torch.device) -> dict:
    """The device a run's numbers belong to."""
    if dev.type == "cpu":
        return dict(device="cpu", gpu=None, timing=CPU_TIMING)
    return dict(device=str(dev), gpu=nvidia_smi(),
                kind=torch.cuda.get_device_name(dev), timing=CARD_TIMING)


def csr_call(coo, x: torch.Tensor) -> Callable[[], torch.Tensor]:
    """The yardstick ``csr @ x`` (``torch.sparse_csr_tensor``: cuSPARSE on
    the card) on the COO with duplicates summed, in x's type."""
    c = coo.sum_duplicates()
    crow = np.zeros(c.n_rows + 1, np.int64)
    np.cumsum(np.bincount(c.rows, minlength=c.n_rows), out=crow[1:])
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(crow), torch.from_numpy(c.cols),
        torch.from_numpy(c.values).to(x.dtype), size=c.shape,
        check_invariants=True).to(x.device)
    return lambda: csr @ x


def time_calls(dev: torch.device, kernels: Dict[object, Callable[[], object]],
               names: Dict[object, Sequence[str]],
               plains: Dict[object, Callable[[], object]],
               make_library: Callable[[], Callable[[], object]]) -> dict:
    """The times of each entry of ``kernels`` (a level, or a geometry) on
    the card ``dev``: warm and cold device ms of its own kernels
    ``names[key]``, with their sources, and per-call ms of it and of
    ``plains[key]`` from CUDA events, interleaved with each other and the
    library call ``make_library()`` builds; and the library call's per-call
    and device ms under ``"library"``.  On the CPU every time is None (and
    nothing is built)."""
    if dev.type != "cuda":
        return {**{k: dict(device_ms=None, device_source=None,
                           cold_device_ms=None, cold_source=None,
                           per_call_ms=None, per_call_spread_ms=None,
                           plain_per_call_ms=None) for k in kernels},
                "library": dict(per_call_ms=None, device_ms=None,
                                device_source=None)}
    library = make_library()
    fns = {**{("kernel", k): f for k, f in kernels.items()},
           **{("plain", k): f for k, f in plains.items()},
           ("library", None): library}
    per_call = time_interleaved(fns, reps=5, iters=20)
    out = {}
    for k, fn in kernels.items():
        warm, warm_src = kernel_device_ms(fn, names[k])
        cold, cold_src = kernel_device_ms(fn, names[k], cold=True)
        out[k] = dict(device_ms=warm, device_source=warm_src,
                      cold_device_ms=cold, cold_source=cold_src,
                      per_call_ms=per_call[("kernel", k)]["best_ms"],
                      per_call_spread_ms=per_call[("kernel", k)]["spread_ms"],
                      plain_per_call_ms=per_call[("plain", k)]["best_ms"])
    lib_dev, lib_src = device_ms(library)
    out["library"] = dict(per_call_ms=per_call[("library", None)]["best_ms"],
                          device_ms=lib_dev, device_source=lib_src)
    return out


def add_prices(rows: List[dict]) -> None:
    """Each row's ``price_ms`` / ``price_cold_ms``: its warm / cold device
    time less the row before's; None for the first row, on the CPU, and
    where the two times have different sources (a profiler time less a
    CUDA-events one prices nothing)."""
    prev = None
    for r in rows:
        for key, t, src in (("price_ms", "device_ms", "device_source"),
                            ("price_cold_ms", "cold_device_ms", "cold_source")):
            r[key] = (None if prev is None or r[t] is None or prev[t] is None
                      or r[src] != prev[src] else r[t] - prev[t])
        prev = r


def rates(ms: Optional[float], nnz: int, tiles: int) -> dict:
    """ns per tile and GFLOPS-equivalent (2·nnz) of a device time."""
    if ms is None:
        return dict(ns_per_tile=None, gflops_equiv=None)
    return dict(ns_per_tile=ms * 1e6 / tiles, gflops_equiv=2.0 * nnz / (ms * 1e6))


def _f(v, spec: str) -> str:
    return "n/a" if v is None else format(v, spec)


def print_result(res: dict, head: str, label: str, rows_key: str = "levels") -> None:
    """The sweep's lines: its head, one line per row as the JAX scripts
    print them (``label(row)``: ms, ns/tile, GFLOPS-equiv) with the cold
    and per-call times, the prices and the bytes beside, then the absent
    TPU levels, the bound, the library call and the card."""
    print(head, flush=True)
    for r in res[rows_key]:
        print(f"{label(r)}: {_f(r['device_ms'], '.4f')} ms  "
              f"{_f(r['ns_per_tile'], '.2f')} ns/tile  "
              f"{_f(r['gflops_equiv'], '.1f')} GFLOPS-equiv  | cold "
              f"{_f(r['cold_device_ms'], '.4f')} ms  per call "
              f"{_f(r['per_call_ms'], '.4f')} ms  price "
              f"{_f(r.get('price_ms'), '+.4f')} / cold "
              f"{_f(r.get('price_cold_ms'), '+.4f')} ms  "
              f"moves {r['level_bytes']} B (writes {r['output_bytes']} B)  "
              f"max err {r['max_abs_err']:.3g}  [{r['device_source']}/"
              f"{r['cold_source']}]", flush=True)
    for a in res.get("absent", []):
        print(f"absent  {a['tpu_level']}: {a['reason']}", flush=True)
    b, lib = res["bound"], res["library"]
    print(f"bound: {_f(b['bound_ms'], '.4f')} ms ({b['bound_by']}: "
          f"{b['bound_bytes']} B, {b['bound_flops']} flop) of "
          f"{res['bound_of']}", flush=True)
    print(f"library: {res['library_call']}: per call "
          f"{_f(lib['per_call_ms'], '.4f')} ms, device "
          f"{_f(lib['device_ms'], '.4f')} ms [{lib['device_source']}]", flush=True)
    print(f"timing: {res['timing']}", flush=True)
    print(f"gpu: {res['gpu'] or 'none (cpu run)'}", flush=True)


def cli(run: Callable[..., dict], doc: str,
        printer: Callable[[dict], None]) -> dict:
    """``main()`` of a sweep: ``run`` at its JAX script's size on
    ``--device`` (default cuda); prints the result's lines and returns
    it."""
    p = argparse.ArgumentParser(description=doc)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu (the "
                        "plain versions, no times)")
    args = p.parse_args()
    res = run(args.device)
    printer(res)
    return res
