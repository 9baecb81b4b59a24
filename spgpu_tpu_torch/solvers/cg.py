"""Krylov solvers: CG and BiCGSTAB, on any device.

Counterpart of :mod:`spgpu_tpu.solvers.cg` (``cg``, ``bicgstab``,
``jacobi_preconditioner``).  The JAX versions run the whole iteration as
one ``lax.while_loop`` under jit: nothing crosses to the host until the
caller reads the result.  Here each solver is a state and a step.  The
state (iterate, residual, search vectors, Krylov scalars, the iteration
count ``k`` and, for BiCGSTAB, the breakdown flag) lives in tensors
allocated once, on ``b``'s device, in ``b``'s type.  The step first
computes on the device whether the iteration still runs (``active``: the
JAX loop's condition), then runs the iteration's body and writes every
state tensor in place, masked by ``active``, and adds ``active`` to
``k``.  An inactive step changes nothing; an active one computes exactly
what a plain loop computes.

On a CUDA device the first step runs eagerly (it loads every kernel and
library the step reaches), then :data:`GRAPH_STEPS` steps are captured in
one ``torch.cuda.CUDAGraph`` and replayed until a replay ends inactive.
The host reads one flag per replay: it is copied into pinned memory behind
the replay, and the next replay is queued before the host waits for it
(a replay after the last active step is masked through and changes
nothing).  The graph and its memory pool are released before the solver
returns.  A matvec that cannot be captured (one that reads a value back to
the host, say) makes the solver raise; nothing then runs eagerly instead,
as the JAX ``while_loop`` likewise needs a traceable matvec.  The kernel
modules' launch counters count a captured launch once per replay
(:func:`spgpu_tpu_torch.kernels.add_launches`).  On the CPU the same step
runs eagerly, one at a time, with a host test after each: bit for bit the
plain loop, which stays as the private witnesses ``_cg_eager`` and
``_bicgstab_eager``.

With a ``group`` (a ``torch.distributed`` process group: the distributed
solves of :mod:`spgpu_tpu_torch.parallel`, each rank on its row block),
each inner product is ``all_reduce``d on the device, inside the captured
graph, as the JAX ``axis_name`` sums them with ``psum``; every rank then
reads the same flag and runs the same replays.

float64 vectors iterate in native float64, so the same loops are also
the counterparts of ``cg_dd`` and ``bicgstab_dd``, whose double-float
arithmetic the GPU does not need.  complex64 and complex128 vectors
iterate in their complex type: ``cg`` for Hermitian positive-definite
systems (every CG scalar is the real part of a conjugated product, as in
``cg_herm_planes``) and ``bicgstab`` with sesquilinear products
(``conj(u)·v``, as in ``bicgstab_planes``), so the same loops are also the
counterparts of those two and of their ``_dd`` variants, on one complex
vector instead of ``[re, im]`` plane stacks.

``SOLVES`` counts the solver calls, ``STEPS`` the steps run (masked ones
included), ``MASKED_STEPS`` the steps run past a solve's last iteration
(its steps less its ``iterations``), ``HOST_READS`` the flag reads,
``REPLAYS`` the chunks of steps after the first read (graph replays on a
CUDA device, chunks of eager steps on the CPU), ``CAPTURE_MS`` the host
milliseconds spent capturing graphs and ``POOL_MALLOCS`` the caching
allocator's ``cudaMalloc`` calls during captures (the graph pools'
growth), counted only while a profiler records: ``torch.cuda.memory_stats``
costs about 0.1 ms on an H100.  :func:`counters` gives them all by name;
like the kernels' launch counters they are process-wide and not
thread-safe.

While a profiler records, each solver call is a span
(:func:`spgpu_tpu_torch.utils.profiling.span`) named ``spgpu.krylov.cg``
or ``spgpu.krylov.bicgstab``, the parent of its phases:
``spgpu.krylov.setup`` (the state, ``b − A·x0``, the first inner
products, the threshold); on CUDA ``spgpu.krylov.eager_step`` (the eager
step and its read), ``spgpu.krylov.capture`` and ``spgpu.krylov.replays``
(through the last wait); on the CPU ``spgpu.krylov.steps`` (the chunks);
and ``spgpu.krylov.release`` (the graph's release, the final residual
norm and the read of ``k``).  No span opens inside a step.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from spgpu_tpu_torch import kernels
from spgpu_tpu_torch.core import real_part_dtype
from spgpu_tpu_torch.ops import blas1
from spgpu_tpu_torch.utils import profiling

__all__ = ["CAPTURE_MS", "COUNTERS", "CgResult", "GRAPH_STEPS", "HOST_READS",
           "MASKED_STEPS", "POOL_MALLOCS", "REPLAYS", "SOLVES", "STEPS", "bicgstab", "cg",
           "counters", "jacobi_preconditioner"]

#: steps captured in one CUDA graph, chosen on the H100 from 4, 8, 16 and
#: 32 by ms per iteration against steps run past convergence (PERF.md §6):
#: with the next replay queued before each read, 4 steps keep the card
#: busy, and more only add capture time and masked steps
GRAPH_STEPS = 4

#: solver calls, steps run (masked ones included), steps run past a
#: solve's last iteration, flag reads, chunks of steps after the first read
#: (graph replays on CUDA), host ms spent capturing graphs and the
#: allocator's cudaMalloc calls during captures while a profiler records
SOLVES = 0
STEPS = 0
MASKED_STEPS = 0
HOST_READS = 0
REPLAYS = 0
CAPTURE_MS = 0.0
POOL_MALLOCS = 0

#: the counters' names, in :func:`counters`' order
COUNTERS = ("SOLVES", "STEPS", "MASKED_STEPS", "HOST_READS", "REPLAYS", "CAPTURE_MS",
            "POOL_MALLOCS")


def counters() -> dict:
    """The loop's counters by name (:data:`COUNTERS`), as
    :func:`spgpu_tpu_torch.kernels.launch_counts` gives the launches."""
    return {name: globals()[name] for name in COUNTERS}


class CgResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: torch.Tensor  # 0-d, on the device
    converged: torch.Tensor  # 0-d bool, on the device


def jacobi_preconditioner(coo, device) -> torch.Tensor:
    """1/diag(A) from a host COO (duplicates summed, zero diagonal → 1),
    on ``device``."""
    d = np.zeros(coo.n_rows, dtype=coo.values.dtype)
    on_diag = coo.rows == coo.cols
    np.add.at(d, coo.rows[on_diag], coo.values[on_diag])
    d = np.where(d == 0, 1.0, d)
    return torch.from_numpy(np.asarray(1.0 / d)).to(device)


def _bnorm(dotp, b):
    bnorm = torch.sqrt(torch.real(dotp(b, b)))
    return torch.where(bnorm == 0, torch.ones_like(bnorm), bnorm)


def _dot(cplx: bool, group=None):
    """The solvers' inner product: sesquilinear for complex vectors, and
    summed over ``group``'s ranks on the device where one is given (every
    rank then holds the same value, so every rank's flag agrees)."""
    if group is None:
        return lambda u, v: blas1.dot(u, v, conjugate=cplx)

    def dot(u, v):
        d = blas1.dot(u, v, conjugate=cplx)
        dist.all_reduce(torch.view_as_real(d) if d.is_complex() else d, group=group)
        return d

    return dot


def _solver(name: str):
    """A solver's wrapper: counts the call in ``SOLVES`` and opens the
    call's span ``spgpu.krylov.<name>``, the parent of its phases."""
    def wrap(fn):
        @functools.wraps(fn)
        def solve(*args, **kw):
            global SOLVES
            SOLVES += 1
            with profiling.span("spgpu.krylov." + name):
                return fn(*args, **kw)
        return solve
    return wrap


def _write(mask, pairs) -> None:
    """Each ``old`` state tensor takes its ``new`` value where ``mask``
    holds and keeps its own elsewhere, in place."""
    for old, new in pairs:
        torch.where(mask, new, old, out=old)


def cg(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
       x0: Optional[torch.Tensor] = None, tol: float = 1e-10,
       maxiter: int = 1000, m_inv: Optional[torch.Tensor] = None,
       group=None) -> CgResult:
    """Preconditioned conjugate gradient for SPD ``A``, or Hermitian
    positive-definite ``A`` on complex vectors (``m_inv``: an optional
    diagonal preconditioner vector).  Every scalar is real: ``rz =
    Re<r,z>``, ``alpha = rz / Re<p,Ap>``, ``beta = rz_new / rz`` (a
    complex ``<p,Ap>`` would give alpha an imaginary part of rounding
    size).  Stops when ‖r‖ ≤ tol·‖b‖ or after ``maxiter`` iterations.  On
    a CUDA device the iteration runs as CUDA-graph replays (module
    docstring); ``matvec`` must be capturable there.  ``group``: a
    ``torch.distributed`` process group over which ``b`` and every vector
    are row blocks (a distributed solve, ``matvec`` this rank's block of
    the product): each inner product is ``all_reduce``d on the device,
    inside the captured graph."""
    return _cg(matvec, b, x0, tol, maxiter, m_inv, group=group)


def bicgstab(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
             x0: Optional[torch.Tensor] = None, tol: float = 1e-10,
             maxiter: int = 1000,
             m_inv: Optional[torch.Tensor] = None, group=None) -> CgResult:
    """BiCGSTAB for general systems.  Complex vectors take sesquilinear
    products (``conj(r̂)·r``, ``conj(r̂)·v``, ``conj(t)·s``; ``<t,t>`` is
    real).  On breakdown (ρ, r̂·v or ω ≈ 0 — for complex, a squared
    modulus below ``tiny`` — or a non-finite residual) the iterate
    freezes and the loop stops.  On a CUDA device the iteration runs as
    CUDA-graph replays (module docstring); ``matvec`` must be capturable
    there.  ``group`` as for :func:`cg`."""
    return _bicgstab(matvec, b, x0, tol, maxiter, m_inv, group=group)


@_solver("cg")
def _cg(matvec, b, x0=None, tol=1e-10, maxiter=1000, m_inv=None,
        steps: Optional[int] = None, group=None) -> CgResult:
    """:func:`cg` with ``steps`` per chunk (default: :data:`GRAPH_STEPS`
    on CUDA, 1 on the CPU); the tests run chunks of several eager steps
    on the CPU with it."""
    dotp = _dot(b.is_complex(), group)

    def re_dot(u, v):
        return torch.real(dotp(u, v))

    def prec(v):
        return v * m_inv if m_inv is not None else v

    dev = b.device
    with profiling.span("spgpu.krylov.setup"):
        x = torch.zeros_like(b) if x0 is None else x0.clone()
        r = b - matvec(x)
        z = prec(r)
        rz = re_dot(r, z)
        thresh = tol * _bnorm(dotp, b)
        p = z.clone()
        k = torch.zeros((), dtype=torch.int64, device=dev)
        active = torch.zeros((), dtype=torch.bool, device=dev)

    def step():
        torch.logical_and(torch.sqrt(re_dot(r, r)) > thresh, k < maxiter,
                          out=active)
        ap = matvec(p)
        alpha = rz / re_dot(p, ap)
        x_new = blas1.axpby(alpha, p, 1.0, x)
        r_new = blas1.axpby(-alpha, ap, 1.0, r)
        z = prec(r_new)
        rz_new = re_dot(r_new, z)
        p_new = blas1.axpby(1.0, z, rz_new / rz, p)
        _write(active, ((x, x_new), (r, r_new), (p, p_new), (rz, rz_new)))
        k.add_(active)

    rnorm, iters = _release(*_run(step, active, steps, dev), k,
                            lambda: torch.sqrt(re_dot(r, r)))
    return CgResult(x, iters, rnorm, rnorm <= thresh)


@_solver("bicgstab")
def _bicgstab(matvec, b, x0=None, tol=1e-10, maxiter=1000, m_inv=None,
              steps: Optional[int] = None, group=None) -> CgResult:
    """:func:`bicgstab` with ``steps`` per chunk, as :func:`_cg`."""
    cplx = b.is_complex()
    dotp = _dot(cplx, group)
    tiny = torch.finfo(real_part_dtype(b.dtype)).tiny

    def small(s):
        if cplx:
            return s.real * s.real + s.imag * s.imag < tiny
        return torch.abs(s) < tiny

    def prec(v):
        return v * m_inv if m_inv is not None else v

    dev = b.device
    with profiling.span("spgpu.krylov.setup"):
        x = torch.zeros_like(b) if x0 is None else x0.clone()
        r = b - matvec(x)
        rhat = r.clone()
        thresh = tol * _bnorm(dotp, b)
        one = torch.ones((), dtype=b.dtype, device=dev)
        p, v = torch.zeros_like(b), torch.zeros_like(b)
        rho, alpha, omega = one.clone(), one.clone(), one.clone()
        down = torch.zeros((), dtype=torch.bool, device=dev)
        k = torch.zeros((), dtype=torch.int64, device=dev)
        active = torch.zeros((), dtype=torch.bool, device=dev)

    def step():
        torch.logical_and(
            (torch.sqrt(torch.real(dotp(r, r))) > thresh) & (k < maxiter),
            ~down, out=active)
        rho_new = dotp(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p_new = r + beta * (p - omega * v)
        phat = prec(p_new)
        v_new = matvec(phat)
        rv = dotp(rhat, v_new)
        alpha_new = rho_new / rv
        s_vec = r - alpha_new * v_new
        shat = prec(s_vec)
        t = matvec(shat)
        tt = torch.real(dotp(t, t))
        ts = dotp(t, s_vec)
        omega_new = torch.where(tt == 0, torch.zeros_like(ts),
                                ts / torch.where(tt == 0, torch.ones_like(tt), tt))
        x_new = x + alpha_new * phat + omega_new * shat
        r_new = s_vec - omega_new * t
        down_new = (small(rho_new) | small(rv) | small(omega_new)
                    | ~torch.isfinite(torch.real(dotp(r_new, r_new))))
        # a breakdown freezes the iterate, the residual and omega
        _write(active & ~down_new, ((x, x_new), (r, r_new), (omega, omega_new)))
        _write(active, ((p, p_new), (v, v_new), (rho, rho_new),
                        (alpha, alpha_new), (down, down_new)))
        k.add_(active)

    rnorm, iters = _release(*_run(step, active, steps, dev), k,
                            lambda: torch.sqrt(torch.real(dotp(r, r))))
    return CgResult(x, iters, rnorm, rnorm <= thresh)


def _run(step: Callable[[], None], active: torch.Tensor, steps: Optional[int],
         device: torch.device):
    """Run ``step`` until a chunk of steps ends with ``active`` false (an
    inactive step changes nothing, and every later one is inactive too):
    the steps run, and the graph replayed (None where none was captured),
    which the caller releases (:func:`_release`).

    On the CPU: chunks of ``steps`` eager steps (default 1), the flag read
    after each.  On CUDA: one eager step and a read, then replays of a
    graph of ``steps`` steps (default :data:`GRAPH_STEPS`), one read per
    replay, the next replay queued before the wait."""
    global STEPS, HOST_READS, REPLAYS
    if device.type != "cuda":
        steps = steps or 1
        with profiling.span("spgpu.krylov.steps"):
            chunks = 0
            while True:
                for _ in range(steps):
                    step()
                chunks += 1
                STEPS += steps
                REPLAYS += 1
                HOST_READS += 1
                if not bool(active):
                    return chunks * steps, None
    steps = steps or GRAPH_STEPS
    with profiling.span("spgpu.krylov.eager_step"):
        step()  # eagerly: loads every kernel and library before the capture
        STEPS += 1
        HOST_READS += 1
        if not bool(active):
            return 1, None
    with profiling.span("spgpu.krylov.capture"):
        graph, launched = _capture(step, steps, device)
    try:
        with profiling.span("spgpu.krylov.replays"):
            replays = _replay(graph, launched, active, steps)
    except BaseException:
        graph.reset()
        raise
    return 1 + replays * steps, graph


def _release(ran: int, graph, k: torch.Tensor, rnorm: Callable[[], torch.Tensor]):
    """Release ``graph`` and its pool (where one was captured), compute the
    final residual norm ``rnorm()`` and read ``k``: ``(norm,
    iterations)``; of the ``ran`` steps, those past the last iteration go
    to ``MASKED_STEPS``."""
    global MASKED_STEPS
    with profiling.span("spgpu.krylov.release"):
        if graph is not None:
            graph.reset()
        norm = rnorm()
        iters = int(k)
    MASKED_STEPS += ran - iters
    return norm, iters


def _capture(step, steps: int, device: torch.device):
    """``steps`` steps captured in a new CUDA graph with its own memory
    pool, on a side stream (thread-local capture mode, so solves in other
    threads may run meanwhile), and the launch counts the capture added,
    taken back off the counters: a captured kernel has not run.  A step
    that cannot be captured raises ``RuntimeError``.  While a profiler
    records, the allocator's ``cudaMalloc`` calls across the capture go to
    ``POOL_MALLOCS``."""
    global CAPTURE_MS, POOL_MALLOCS
    profiled = torch.autograd._profiler_enabled()
    mallocs = _device_mallocs(device) if profiled else 0
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    try:
        with torch.cuda.stream(stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                for _ in range(steps):
                    step()
            finally:
                graph.capture_end()  # raises when a step broke the capture
    except RuntimeError as err:
        graph.reset()
        raise RuntimeError(
            "the Krylov step cannot be captured in a CUDA graph (a matvec "
            "that reads the host or synchronises, or a collective this "
            "torch build cannot capture?); the solvers do not run eagerly "
            "on CUDA instead") from err
    finally:
        launched = kernels.launch_counts_since(before)
        kernels.add_launches(launched, -1)
    torch.cuda.current_stream(device).wait_stream(stream)
    CAPTURE_MS += 1e3 * (time.perf_counter() - t0)
    if profiled:
        POOL_MALLOCS += _device_mallocs(device) - mallocs
    return graph, launched


def _device_mallocs(device: torch.device) -> int:
    """The caching allocator's ``cudaMalloc`` count on ``device``."""
    return torch.cuda.memory_stats(device).get("num_device_alloc", 0)


def _replay(graph, launched, active: torch.Tensor, steps: int) -> int:
    """Replay ``graph`` on the current stream until a replay ends with
    ``active`` false; returns the replays run.  Each replay's flag is
    copied into pinned memory behind it and an event recorded; the next
    replay is queued before the host waits on that event, so the device
    does not idle during the read.  Waits for the last replay before
    returning."""
    global HOST_READS
    flags = torch.empty(2, dtype=torch.bool, pin_memory=True)
    done = [torch.cuda.Event(), torch.cuda.Event()]

    def launch(i):
        global STEPS, REPLAYS
        graph.replay()
        flags[i % 2].copy_(active, non_blocking=True)
        done[i % 2].record()
        kernels.add_launches(launched)
        STEPS += steps
        REPLAYS += 1

    launch(0)
    i = 0
    while True:
        launch(i + 1)
        done[i % 2].synchronize()
        HOST_READS += 1
        if not bool(flags[i % 2]):
            break
        i += 1
    done[(i + 1) % 2].synchronize()
    return i + 2


def _cg_eager(matvec, b, x0=None, tol=1e-10, maxiter=1000, m_inv=None,
              group=None) -> CgResult:
    """The plain CG loop, one host read per iteration: the witness the
    tests and ``chip_smoke.py`` hold :func:`cg` to (never on a solve
    route)."""
    dotp = _dot(b.is_complex(), group)

    def re_dot(u, v):
        return torch.real(dotp(u, v))

    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = r * m_inv if m_inv is not None else r
    rz = re_dot(r, z)
    thresh = tol * _bnorm(dotp, b)
    p = z
    k = 0
    while k < maxiter and bool(torch.sqrt(re_dot(r, r)) > thresh):
        ap = matvec(p)
        alpha = rz / re_dot(p, ap)
        x = blas1.axpby(alpha, p, 1.0, x)
        r = blas1.axpby(-alpha, ap, 1.0, r)
        z = r * m_inv if m_inv is not None else r
        rz_new = re_dot(r, z)
        p = blas1.axpby(1.0, z, rz_new / rz, p)
        rz = rz_new
        k += 1
    rnorm = torch.sqrt(re_dot(r, r))
    return CgResult(x, k, rnorm, rnorm <= thresh)


def _bicgstab_eager(matvec, b, x0=None, tol=1e-10, maxiter=1000,
                    m_inv=None, group=None) -> CgResult:
    """The plain BiCGSTAB loop, one host read per iteration: the witness
    of :func:`bicgstab`, as :func:`_cg_eager` is of :func:`cg`."""
    cplx = b.is_complex()
    dotp = _dot(cplx, group)

    def small(s):
        if cplx:
            return s.real * s.real + s.imag * s.imag < tiny
        return torch.abs(s) < tiny

    def prec(v):
        return v * m_inv if m_inv is not None else v

    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    rhat = r
    thresh = tol * _bnorm(dotp, b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    p = v = torch.zeros_like(b)
    rho = alpha = omega = one
    tiny = torch.finfo(real_part_dtype(b.dtype)).tiny
    down = torch.zeros((), dtype=torch.bool, device=b.device)
    k = 0
    while k < maxiter and bool((torch.sqrt(torch.real(dotp(r, r))) > thresh)
                               & ~down):
        rho_new = dotp(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = prec(p)
        v = matvec(phat)
        rv = dotp(rhat, v)
        alpha = rho_new / rv
        s_vec = r - alpha * v
        shat = prec(s_vec)
        t = matvec(shat)
        tt = torch.real(dotp(t, t))
        ts = dotp(t, s_vec)
        omega_new = torch.where(tt == 0, torch.zeros_like(ts),
                                ts / torch.where(tt == 0, torch.ones_like(tt), tt))
        x_new = x + alpha * phat + omega_new * shat
        r_new = s_vec - omega_new * t
        down = (small(rho_new) | small(rv) | small(omega_new)
                | ~torch.isfinite(torch.real(dotp(r_new, r_new))))
        x = torch.where(down, x, x_new)
        r = torch.where(down, r, r_new)
        rho = rho_new
        omega = torch.where(down, omega, omega_new)
        k += 1
    rnorm = torch.sqrt(torch.real(dotp(r, r)))
    return CgResult(x, k, rnorm, rnorm <= thresh)
