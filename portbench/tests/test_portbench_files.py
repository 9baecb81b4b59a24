"""A new cell, traffic mix and per-layer metric are files and entries
only: in a copy of the benchmark, a cell of an existing configuration
under a new traffic file, with a new reader, runs without a file of the
copy being edited."""

import hashlib
import json
import os
import shutil

from portbench.spec import PKG, ROOT, load_cell

from _small import run_small


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "portbench")):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_new_cell_is_files_and_entries(tmp_path):
    root = str(tmp_path)
    shutil.copytree(PKG, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _digests(root)
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    base = os.path.join(root, "portbench")
    traffic = json.load(open(os.path.join(base, "traffic", "cg50.json")))
    json.dump(dict(traffic, maxiter=8), open(os.path.join(base, "traffic", "cg8.json"), "w"))
    json.dump({"x_gap": 1e-9}, open(os.path.join(base, "checks", "hpcg-cg8.json"), "w"))
    with open(os.path.join(base, "layer_metrics", "solves_done.py"), "w") as f:
        f.write("def read(rec):\n    return len(rec['iterations'])\n")
    bench["workloads"].append({"name": "hpcg-cg8", "config": "hpcg-128", "traffic": "cg8",
                               "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "solve_ms":
            m["workloads"].append("hpcg-cg8")
    bench["per_layer"].append({"name": "solves_done", "unit": "count", "better": "higher",
                               "source": "host_clock", "layer": "solvers",
                               "moves": "solve_ms", "workloads": ["hpcg-cg8"]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))

    cell = load_cell("hpcg-cg8", root)
    assert cell.traffic["maxiter"] == 8
    line = run_small("hpcg-cg8", root=root)
    assert line["correct"] and set(line["metrics"]) == {"solve_ms", "setup_s"}
    traced = run_small("hpcg-cg8", root=root, trace=True)
    assert traced["metrics"]["solves_done"]["value"] == traced["attempted"]
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())  # nothing edited, only added
