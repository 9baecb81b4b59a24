"""The readings a cell's limits are set from, in one process on the card
(one a card for a multi-rank cell):
the program's compared numbers over a dozen seeds or more (the lower
readings) and the control's over three or more (the upper readings),
each seed through the cell's own traffic with a short window.  Set-up
(generation and conversion) is made once and shared by every seed.

    python3 -m portbench.calibrate --workload <name> --seconds 3 \\
        --seeds 11,12,... --control-seeds 21,22,23

Prints one JSON line a seed and a last line with the largest program
reading and the smallest control reading of each number.  Not run by the
benchmark's runs."""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

__all__ = ["main", "readings"]


def readings(cell, device, seeds, control_seeds, seconds: float, params=None,
             out=sys.stdout, rg=None) -> dict:
    """Each seed's numbers for the program and the control; returns the
    summary line (printed by the first rank of a multi-rank cell, whose
    ranks all call this with their group ``rg``)."""
    import torch

    from portbench import harness
    from portbench.control import Control

    if rg is not None and rg.rank != 0:
        out = None
    matrix, program, _, _ = harness.set_up(cell, device, params, rg)
    rows = {"program": [], "control": []}
    for side, seeds_ in (("program", seeds), ("control", control_seeds)):
        for seed in seeds_:
            prog = program if side == "program" else Control(matrix, device)
            ctx = harness.Context(cell=cell, matrix=matrix, program=prog, device=device,
                                  seed=seed, seconds=seconds, trace=False, rg=rg,
                                  free_program=False)
            t0 = time.perf_counter()
            res = harness.run_cell(ctx)
            if out is None:  # a rank other than the first
                continue
            row = {"side": side, "seed": seed, "numbers": res["numbers"],
                   "attempted": res["attempted"], "failed": res["failed"],
                   "e2e": res["e2e"], "s": time.perf_counter() - t0}
            rows[side].append(row)
            print(json.dumps(row), file=out, flush=True)
            if device.type == "cuda":
                torch.cuda.empty_cache()
    if out is None:
        return None
    names = sorted(rows["program"][0]["numbers"]) if rows["program"] else []
    summary = {"workload": cell.name, "lower": {}, "upper": {}}
    for k in names:
        summary["lower"][k] = harness.worst(r["numbers"][k] for r in rows["program"])
        vals = [r["numbers"][k] for r in rows["control"]]
        summary["upper"][k] = min((v if not math.isnan(v) else math.inf) for v in vals) \
            if vals else None
    print(json.dumps(summary), file=out, flush=True)
    return summary


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", required=True, type=_ints)
    ap.add_argument("--control-seeds", required=True, type=_ints)
    return ap.parse_args(argv)


def _ints(text: str) -> list:
    return [int(v) for v in text.split(",") if v]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    import torch

    from portbench import spec
    from portbench.run import launch_ranks

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"the readings are taken on {cell.chips} CUDA card(s): not here",
              file=sys.stderr)
        return 2
    if cell.traffic.get("ranks"):
        return launch_ranks(["--readings", *argv], cell.chips, "cuda")
    readings(cell, torch.device("cuda", 0), args.seeds, args.control_seeds, args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
