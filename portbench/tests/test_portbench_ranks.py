"""The multi-rank path at 2 ranks with gloo on the CPU: the harness starts
one process a rank, joins them through the port's rank group, and rank 0
prints a correct result line.  The cell is files and entries in a copy."""

import json
import os
import shutil
import subprocess
import sys

from portbench.spec import PKG, ROOT

_LAUNCH = "import sys; from portbench.run import launch_ranks; " \
          "sys.exit(launch_ranks(sys.argv[2:], 2, 'cpu', root=sys.argv[1]))"


def _ranks_root(tmp_path):
    """A copy of the benchmark with a 2-rank cell of an 8-cubed block a rank."""
    root = str(tmp_path / "root")
    shutil.copytree(PKG, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    base = os.path.join(root, "portbench")
    cfg = json.load(open(os.path.join(base, "configs", "hpcg-128.json")))
    json.dump(dict(cfg, nx=8, ny=8, nz=8), open(os.path.join(base, "configs", "hpcg-8.json"),
                                                 "w"))
    json.dump({"driver": "dist_solve_loop", "ranks": True, "stack": "nz", "tol": 0.0,
               "maxiter": 20, "pool": 4, "pool_first_ones": True, "samples": 2,
               "slice_s": 0.2},
              open(os.path.join(base, "traffic", "cg20-ranks.json"), "w"))
    json.dump({"x_gap": 1e-9}, open(os.path.join(base, "checks", "hpcg-ranks.json"), "w"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["workloads"].append({"name": "hpcg-ranks", "config": "hpcg-8",
                               "traffic": "cg20-ranks", "chips": 2, "why": "a test cell"})
    next(m for m in bench["end_to_end"] if m["name"] == "solve_ms")["workloads"].append(
        "hpcg-ranks")
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    return root


def _launch(root, *args, env=None):
    return subprocess.run([sys.executable, "-c", _LAUNCH, root, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_two_ranks_on_gloo(tmp_path):
    root = _ranks_root(tmp_path)
    for tr in ("0", "1"):
        proc = _launch(root, "--workload", "hpcg-ranks", "--seed", str(2**31 + 3),
                       "--seconds", "0.5", "--trace", tr)
        assert proc.returncode == 0, proc.stderr[-3000:]
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        assert line["correct"] and line["attempted"] >= 1, line
        assert line["device"]["count"] == 2
        assert ("window_s" in line["device"]) if tr == "1" else ("solve_ms" in line["metrics"])
    # the readings of the program and of the control, in one set-up a rank
    proc = _launch(root, "--readings", "--workload", "hpcg-ranks", "--seconds", "0.3",
                   "--seeds", "5,6", "--control-seeds", "7")
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["lower"]["x_gap"] < 1e-9 < summary["upper"]["x_gap"]


def test_exchange_left_out_is_not_correct(tmp_path):
    """Every rank's halo exchange posts nothing (the halo stays zero): the
    run comes out not correct."""
    root = _ranks_root(tmp_path)
    fault = tmp_path / "fault"
    fault.mkdir()
    (fault / "sitecustomize.py").write_text(
        "import importlib\n"
        "mod = importlib.import_module('spgpu_tpu_torch.parallel.dist_spmv')\n"
        "mod.ShardedHandle._post = lambda self: []\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(fault), ROOT]))
    proc = _launch(root, "--workload", "hpcg-ranks", "--seed", "9", "--seconds", "0.3",
                   "--trace", "0", env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not line["correct"], line["checks"]
