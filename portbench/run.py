"""Run one cell of ``BENCHMARK.json`` once, on the card(s) of this machine:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints diagnostics and, last on standard error, each number compared
beside its limit; then, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``.
Exits non-zero with no result without the cards the cell asks for, or if
JAX or the JAX package was loaded."""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up counts from here: torch's import on

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

__all__ = ["launch_ranks", "main", "run_one"]


def _card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


def run_one(cell, device, seed: int, seconds: float, trace: bool, t_start: float,
            params=None, make_program=None, rg=None) -> dict:
    """One run of ``cell`` on ``device`` (in rank group ``rg`` for a
    multi-rank traffic): the result line.  ``params`` replace some of the
    configuration's sizes, and ``make_program(matrix, device)`` builds
    what runs in the program's place (the tests' small runs, the
    control)."""
    import torch

    from portbench import harness, work

    t_torch = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)  # the card's context
    t_card = time.perf_counter()
    matrix, program, gen_s, convert_s = harness.set_up(cell, device, params, rg, make_program)
    fmt, select_s = getattr(program, "fmt", None), getattr(program, "select_s", None)
    ctx = harness.Context(cell=cell, matrix=matrix, program=program, device=device,
                          seed=seed, seconds=seconds, trace=trace, rg=rg)
    del program
    out = harness.run_cell(ctx)
    if out is None:  # a rank other than the first: it prints nothing
        return None
    setup_s = ctx.window_t0 - t_start
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    out["record"].update(convert_s=convert_s, nnz=matrix.nnz, n=matrix.n,
                         dtype=matrix.dtype, peaks=work.peaks_for(kind))
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
           "count": cell.chips if rg is None else rg.size,
           "memory_peak_bytes": out.get("memory_peak_bytes", ctx.memory_peak_bytes)}
    if trace and "busy_s" in out["record"]:
        dev.update(busy_s=out["record"]["busy_s"], window_s=out["record"]["window_s"])
    line = harness.result_line(cell, out, trace=trace, setup_s=setup_s, device=dev)
    info = dict(out.get("info", {}), fmt=fmt, setup_s=setup_s, import_s=t_torch - t_start,
                card_s=t_card - t_torch, generate_s=gen_s, select_s=select_s,
                convert_s=convert_s, inputs_s=ctx.inputs_t - t_card - gen_s - convert_s,
                warm_s=ctx.window_t0 - ctx.inputs_t)
    print(json.dumps({"info": info}), file=sys.stderr)
    return line


def _report(line: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    standard error; then the result line on standard output."""
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def launch_ranks(argv: list, n: int, device: str, root: str = None,
                 timeout_s: float = 3000.0) -> int:
    """Run this cell on ``n`` ranks, one process each (``portbench.rank``),
    joined through a file store in a fresh directory under ``TMPDIR``;
    rank 0's standard output is this process's (``root``: the tree that
    holds ``BENCHMARK.json``, by default this one).  Returns the first
    failing rank's exit code, else 0; kills the rest when one fails."""
    d = tempfile.mkdtemp(prefix="portbench_ranks_")
    procs = []
    try:
        for r in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "portbench.rank", "--rank", str(r), "--world", str(n),
                 "--store", os.path.join(d, "store"), "--device", device,
                 *(["--root", root] if root else []), *argv],
                stdout=None if r == 0 else subprocess.DEVNULL))
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                return bad[0]
            if all(c == 0 for c in codes):
                return 0
            if time.monotonic() > deadline:
                print(f"ranks still running after {timeout_s} s", file=sys.stderr)
                return 124
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in os.listdir(d):
            os.remove(os.path.join(d, f))
        os.rmdir(d)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    from portbench import harness, spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}: no result", file=sys.stderr)
        return 2
    if cell.traffic.get("ranks"):
        return launch_ranks(argv, cell.chips, "cuda")
    line = run_one(cell, torch.device("cuda", 0), args.seed, args.seconds,
                   bool(args.trace), T_START)
    print(f"card: {_card()}", file=sys.stderr)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this run, which no run may load: {', '.join(bad)}: no result",
              file=sys.stderr)
        return 3
    _report(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
