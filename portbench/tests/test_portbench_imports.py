"""No run loads JAX or the JAX package, and the reference imports nothing
of the program.  Top-level module names are compared whole: the
program's name, ``spgpu_tpu_torch``, begins with the JAX package's."""

import ast
import glob
import json
import os
import subprocess
import sys

from portbench.harness import FORBIDDEN
from portbench.spec import PKG, ROOT

_RUN = r"""
import json, sys
sys.path.insert(0, "tests_dir")
from _small import CELLS, run_small
from portbench.control import Control
from portbench.harness import forbidden_modules
for w in CELLS:
    run_small(w, seconds=0.1)
    run_small(w, seconds=0.5, trace=True, make_program=Control)
print(json.dumps(forbidden_modules()))
"""


def _top_level_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_a_run_loads_no_jax():
    code = _RUN.replace("tests_dir", os.path.join(PKG, "tests"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_whole_names_are_compared(monkeypatch):
    from portbench import harness

    fake = {"spgpu_tpu_torch.ops": None, "jaxtyping": None, "spgpu_tpu.ops": None,
            "jaxlib.xla": None, "flax": None}
    monkeypatch.setattr(sys, "modules", fake)
    assert harness.forbidden_modules() == ["flax", "jaxlib.xla", "spgpu_tpu.ops"]


def test_sources_import_no_jax_and_the_reference_none_of_the_program():
    for path in glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True):
        names = set(_top_level_imports(path))
        assert not names & set(FORBIDDEN), path
        if os.sep + "reference" + os.sep in path:
            assert "spgpu_tpu_torch" not in names, path
