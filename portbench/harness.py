"""One run of one cell: set-up, the driver's window, the comparison with
the reference, and the result line.

Set-up is torch's and the card's start, the port's libraries (built on
the first run into the checkout's ``spgpu_tpu_torch/_build/``), the
matrix from the configuration's generator, the program's selection and
conversion (the ``convert`` span), the inputs from the seed, and the
driver's warm-up.  The driver then measures for the given seconds,
compares what the timed path produced with the plain reference once the
window has closed, and hands back its numbers; the harness checks them
against the cell's limits and reads the per-layer metrics from the
record, each with its own reader."""

from __future__ import annotations

import dataclasses
import math
import random
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from portbench import spec as _spec
from portbench.reference.spmv import CsrMatrix

__all__ = ["Context", "FORBIDDEN", "Matrix", "forbidden_modules", "make_matrix",
           "result_line", "run_cell", "set_up"]

#: top-level module names no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "spgpu_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is one of
    :data:`FORBIDDEN`."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Matrix:
    """The generated matrix: COO arrays (rows ascending, no duplicates),
    its size and its value type."""

    rows: np.ndarray
    cols: np.ndarray
    values: np.ndarray
    n: int

    @property
    def nnz(self) -> int:
        return int(self.rows.size)

    @property
    def dtype(self) -> str:
        return self.values.dtype.name

    def coo(self):
        """The program's COO of these arrays."""
        from spgpu_tpu_torch.formats.coo import CooMatrix

        return CooMatrix(self.rows, self.cols, self.values, self.n, self.n)

    def reference(self, device, dtype: Optional[torch.dtype] = None) -> CsrMatrix:
        """The reference product, in the matrix's type unless ``dtype``."""
        return CsrMatrix(self.rows, self.cols, self.values, self.n, device,
                         dtype or getattr(torch, self.dtype))


def make_matrix(cell: _spec.Cell, params: Optional[dict] = None) -> Matrix:
    """The configuration's matrix from its generator, which reads its
    sizes from the configuration (``params`` replace some: the tests'
    small sizes, a multi-rank run's global grid)."""
    cfg = dict(cell.config, **(params or {}))
    gen = cell.module("generators", cfg["generator"])
    rows, cols, values, n = gen.generate(cfg, np.dtype(cfg["dtype"]))
    return Matrix(rows, cols, values, n)


def set_up(cell: _spec.Cell, device, params: Optional[dict] = None, rg=None,
           make_program: Optional[Callable] = None):
    """The matrix and the program of ``cell`` on ``device``: ``(matrix,
    program, generate_s, convert_s)``.  The program is the route's
    (:class:`portbench.program.Program`), the driver's own for a
    multi-rank traffic (``build_program``, in rank group ``rg``, over the
    global sizes its ``params`` give), or ``make_program(matrix, device)``
    in its place (the tests' small runs, the control)."""
    from portbench.program import Program

    driver = cell.module("drivers", cell.traffic["driver"])
    if rg is not None and hasattr(driver, "params"):
        params = driver.params(cell, dict(cell.config, **(params or {})), rg)
    matrix, gen_s = timed(make_matrix, cell, params)
    if make_program is not None:
        program, convert_s = timed(make_program, matrix, device)
    elif hasattr(driver, "build_program"):
        program, convert_s = timed(driver.build_program, cell, matrix, device, rg)
    else:
        program, convert_s = timed(Program, matrix.coo(), cell.config["route"], device)
    return matrix, program, gen_s, convert_s


@dataclasses.dataclass
class Context:
    """What a driver is given for one run."""

    cell: _spec.Cell
    matrix: Matrix
    program: object  # portbench.program.Program, or the control in its place
    device: torch.device
    seed: int
    seconds: float
    trace: bool
    #: the rank group of a multi-rank traffic, else None
    rg: object = None
    #: drop the program's layout once the window has closed (a run); the
    #: calibration keeps it for its next seed
    free_program: bool = True
    window_t0: Optional[float] = None
    _before: dict = dataclasses.field(default_factory=dict)
    window_diag: dict = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0
    #: host clock when the inputs were on the device (set-up's account)
    inputs_t: Optional[float] = None

    def generator(self, seed: Optional[int] = None) -> torch.Generator:
        """A generator on the device seeded from ``seed``, by default the
        run's."""
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed if seed is None else seed) % (1 << 63))
        return g

    def sampler(self) -> random.Random:
        """The host generator that draws which answers are compared."""
        return random.Random(self.seed)

    def inputs_made(self) -> None:
        """Inputs are on the device: the reference's set-up is freed, and
        the memory peak starts from what the program holds."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        self.inputs_t = time.perf_counter()

    def window_opens(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._before = self._counters()
        self.window_t0 = time.perf_counter()
        return self.window_t0

    def _counters(self) -> dict:
        """The program's loop counters and the caching allocator's, for the
        diagnostics of a window (not metrics)."""
        loop = sys.modules.get("spgpu_tpu_torch.solvers.cg")
        out = {"capture_ms": getattr(loop, "CAPTURE_MS", 0.0),
               "replays": getattr(loop, "REPLAYS", 0)}
        if self.device.type == "cuda":
            st = torch.cuda.memory_stats(self.device)
            out.update(device_allocs=st.get("num_device_alloc", 0),
                       device_frees=st.get("num_device_free", 0),
                       alloc_retries=st.get("num_alloc_retries", 0))
        return out

    def diagnostics(self) -> dict:
        """What the counters moved by over the window, and the allocator's
        reserved peak."""
        now = self._counters()
        out = {k: now[k] - self._before.get(k, 0) for k in now}
        if self.device.type == "cuda":
            out["reserved_peak_bytes"] = int(torch.cuda.max_memory_reserved(self.device))
        return out

    def window_closed(self) -> None:
        """Read the memory peak and the window's diagnostics; then the
        program's state may go."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated(self.device))
        self.window_diag = self.diagnostics()

    def release_program(self) -> None:
        if self.free_program:
            self.program = None
            if self.device.type == "cuda":
                torch.cuda.empty_cache()


def relative_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """``max|got - want| / max|want|`` in float64 (inf where ``got`` is
    not finite)."""
    got, want = got.double(), want.double()
    if not bool(torch.isfinite(got).all()):
        return math.inf
    return float((got - want).abs().max() / want.abs().max())



def worst(values) -> float:
    """The largest of ``values``, or inf where one is not a number (so a
    NaN never passes a limit)."""
    values = list(values)
    return math.inf if any(math.isnan(v) for v in values) else max(values)


def run_cell(ctx: Context) -> dict:
    """The driver's run of ``ctx``: a dict with ``attempted``, ``failed``,
    ``e2e`` (end-to-end values by name), ``numbers`` (compared values by
    name) and ``record`` (what the per-layer readers read)."""
    driver = ctx.cell.module("drivers", ctx.cell.traffic["driver"])
    return driver.run(ctx)


def _checks(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise KeyError(f"the driver gave no {', '.join(missing)} to compare")
    return {k: {"value": numbers[k], "limit": limits[k]} for k in sorted(limits)}


def _layer_metrics(cell: _spec.Cell, record: dict) -> Dict[str, dict]:
    out = {}
    for m in cell.per_layer:
        value = cell.module("layer_metrics", m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(cell: _spec.Cell, out: dict, *, trace: bool, setup_s: float,
                device: dict) -> dict:
    """The last line of a run: ``correct``, ``attempted``, ``failed``,
    ``metrics`` (the cell's end-to-end metrics, or with ``trace`` its
    per-layer ones), ``device``, with ``trace`` a ``breakdown``, and last
    the numbers compared, each beside its limit."""
    checks = _checks(out["numbers"], cell.limits)
    correct = out["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    if trace:
        metrics = _layer_metrics(cell, out["record"])
    else:
        values = dict(out["e2e"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if values.get(m["name"]) is not None}
    line = {"correct": bool(correct), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if trace and out["record"].get("breakdown"):
        line["breakdown"] = out["record"]["breakdown"]
    line["checks"] = checks
    return line


def timed(fn: Callable, *args, **kw):
    """``(fn(*args, **kw), seconds)`` on the host clock."""
    t0 = time.perf_counter()
    res = fn(*args, **kw)
    return res, time.perf_counter() - t0
