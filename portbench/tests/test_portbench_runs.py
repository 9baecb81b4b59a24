"""Whole runs of each cell at a small size on the CPU, the card's look
skipped: a sound run comes out correct; the control (the reference in
float32 in the program's place) and each fault planted underneath the
timed path come out not correct."""

import importlib
import os
import subprocess
import sys

import pytest
import torch

from portbench.calibrate import readings
from portbench.control import Control
from portbench.spec import ROOT, load_cell

from _small import CELLS, SMALL, run_small

LOOP = importlib.import_module("spgpu_tpu_torch.solvers.cg")
SOLVES = ("hpcg-cg50", "pde3d-bicgstab")


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(workload, trace):
    line = run_small(workload, trace=trace, seconds=1.0 if trace else 0.3)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    if trace:
        assert "convert_s" in line["metrics"]
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    line = run_small(workload, make_program=Control)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_limits_pass_the_program_and_the_control_fails_one(workload):
    cell = load_cell(workload)
    with open(os.devnull, "w") as out:
        summary = readings(cell, torch.device("cpu"), [3, 2**31 + 4], [5], 0.3,
                           params=SMALL[cell.config["generator"]], out=out)
    assert all(summary["lower"][k] <= lim for k, lim in cell.limits.items())
    assert any(summary["upper"][k] > lim for k, lim in cell.limits.items())


def _op_fault(monkeypatch, kind):
    """Break the routes' ops underneath the benchmark: ``unchanged`` returns
    its input, ``half`` leaves out the second half of the rows, ``altered``
    changes one answer."""
    from spgpu_tpu_torch import ops

    for name in ("whdia_spmv", "whell_spmv"):
        orig = getattr(ops, name)

        def broken(a, x, *args, _orig=orig, **kw):
            if kind == "unchanged":
                return x.clone()
            z = _orig(a, x, *args, **kw)
            if kind == "half":
                z[z.numel() // 2:] = 0
            else:
                z[0] += 1.0
            return z

        monkeypatch.setattr(ops, name, broken)


def _loop_fault(monkeypatch, kind):
    """Break the Krylov loop: ``unchanged`` makes each step keep its state,
    ``altered`` changes one entry of each answer."""
    if kind == "unchanged":
        monkeypatch.setattr(LOOP, "_write", lambda mask, pairs: None)
        return
    for name in ("cg", "bicgstab"):
        orig = getattr(LOOP, name)

        def broken(*args, _orig=orig, **kw):
            res = _orig(*args, **kw)
            res.x[0] += 1.0
            return res

        monkeypatch.setattr(LOOP, name, broken)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_fault_is_not_correct(workload, kind, monkeypatch):
    if workload in SOLVES and kind != "half":
        _loop_fault(monkeypatch, kind)
    else:
        _op_fault(monkeypatch, kind)
    line = run_small(workload)
    assert not line["correct"], line["checks"]


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "hpcg-spmv",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_small_run_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    line = run_small(workload, trace=True, device="cuda:0", seconds=2.0)
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0
    assert "breakdown" in line


