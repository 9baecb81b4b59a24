"""What a cell is made of, found by name: the entry of ``BENCHMARK.json``,
its configuration, traffic mix and limits (data files), and the code
they name (a generator, a driver, per-layer readers), each in a file of
its own under the benchmark's folder.  Adding a cell, a traffic mix or a
metric adds files and entries; no file here names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from types import ModuleType
from typing import Dict, List

__all__ = ["Cell", "load_cell", "load_module"]

#: the benchmark's folder, and the root of the checkout that holds it
PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    root: str

    def module(self, kind: str, name: str) -> ModuleType:
        """The code file ``portbench/<kind>/<name>.py`` of this cell's
        tree."""
        return load_module(os.path.join(self.root, "portbench", kind, name + ".py"))


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str) -> ModuleType:
    """Import the file ``path`` (whose name may hold dots, as a metric's
    does) as a module of its own."""
    key = "portbench._by_path." + os.path.relpath(path, ROOT).replace(os.sep, "/")
    if key in sys.modules:
        return sys.modules[key]
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{path}: no such benchmark file")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def _applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def load_cell(workload: str, root: str = ROOT) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json``: its entry, the
    configuration ``portbench/configs/<config>.json``, the traffic mix
    ``portbench/traffic/<traffic>.json``, the limits of its comparison
    ``portbench/checks/<workload>.json`` and the metrics it reports."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    if not entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"({', '.join(w['name'] for w in bench['workloads'])})")
    w = entries[0]
    base = os.path.join(root, "portbench")
    config = _json(os.path.join(base, "configs", w["config"] + ".json"))
    return Cell(
        name=workload, chips=int(w["chips"]), config=config,
        traffic=_json(os.path.join(base, "traffic", w["traffic"] + ".json")),
        limits=_json(os.path.join(base, "checks", workload + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        root=root)
