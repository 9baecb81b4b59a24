"""One rank of a multi-rank cell, started by :func:`portbench.run.launch_ranks`
(never the benchmark's command): joins the group through the port's
``parallel.group.init_rank_group`` and runs the cell; rank 0 prints the
result line."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), required=True)
    ap.add_argument("--root", default=None)
    ap.add_argument("--readings", action="store_true",
                    help="take the calibration's readings (portbench.calibrate)")
    args, rest = ap.parse_known_args(argv)
    from portbench import calibrate, harness, spec
    from portbench.run import _report, parse, run_one

    run_args = (calibrate.parse if args.readings else parse)(rest)
    cell = spec.load_cell(run_args.workload, args.root or spec.ROOT)
    import torch

    from spgpu_tpu_torch.parallel.group import destroy_rank_group, init_rank_group

    if args.device == "cpu":
        torch.set_num_threads(1)
    rg = init_rank_group(args.store, args.rank, args.world,
                         None if args.device == "cuda" else "cpu")
    try:
        if args.readings:
            calibrate.readings(cell, rg.device, run_args.seeds, run_args.control_seeds,
                               run_args.seconds, rg=rg)
            return 0
        line = run_one(cell, rg.device, run_args.seed, run_args.seconds,
                       bool(run_args.trace), T_START, rg=rg)
    finally:
        destroy_rank_group()
    if args.rank != 0:
        return 0
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this run, which no run may load: {', '.join(bad)}: no result",
              file=sys.stderr)
        return 3
    _report(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
