"""PyTorch port: package boundary checks in fresh processes.

* ``import spgpu_tpu_torch`` loads no JAX module (the GPU host has none),
  nor does any module of its distributed layer, the ranks' entry among
  them;
* no file of the port (nor ``chip_smoke.py``) imports JAX or the JAX
  package, or builds a path into ``spgpu_tpu/``: the port keeps its own
  copy of the C++ layout helpers, identical to the JAX package's but for
  one comment that cites spGPU's sources by a relative path;
* ``chip_smoke.py`` refuses to run without a CUDA device, and without the
  rest of the repository, printing no result line.
"""

import ast
import glob
import os
import re
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_import_loads_no_jax():
    p = _run(["-c", "import spgpu_tpu_torch, sys; "
             "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
             " or m == 'spgpu_tpu' or m.startswith('spgpu_tpu.')]; "
             "assert not bad, bad; print('ok')"], ROOT)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "ok"


def test_parallel_modules_and_rank_entry_load_no_jax():
    """Every module of ``spgpu_tpu_torch.parallel``, the rank entry among
    them, imports in a fresh process without loading JAX or the JAX
    package (the ranks of a distributed run import nothing else)."""
    mods = sorted(os.path.splitext(os.path.basename(p))[0] for p in glob.glob(
        os.path.join(ROOT, "spgpu_tpu_torch", "parallel", "*.py")))
    assert {"_rank", "dist_solve", "dist_spmv", "dryrun", "group", "partition",
            "partition_packed", "partition_whell"} <= set(mods)
    names = ", ".join(f"spgpu_tpu_torch.parallel.{m}".removesuffix(".__init__")
                      for m in mods)
    p = _run(["-c", f"import importlib, sys; [importlib.import_module(m) for m in "
              f"'{names}'.split(', ')]; "
              "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'spgpu_tpu')]; assert not bad, bad; print('ok')"], ROOT)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "ok"


def _port_sources():
    return sorted(glob.glob(os.path.join(ROOT, "spgpu_tpu_torch", "**", "*.py"),
                            recursive=True)) + [os.path.join(ROOT, "chip_smoke.py")]


def _jax_imports(tree):
    """Modules of JAX or of the JAX package that ``tree`` imports."""
    bad = []
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 and node.level == 0 else [])
        bad += [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "spgpu_tpu")]
    return bad


def _paths_into_jax_package(tree):
    """String constants naming ``spgpu_tpu`` that ``tree`` hands to a call
    (``os.path.join(..., "spgpu_tpu", ...)``, ``open("spgpu_tpu/...")``)
    or joins with ``/`` (``Path(...) / "spgpu_tpu"``); docstrings,
    comments and plain labels are not path building."""
    def names_pkg(n):
        return (isinstance(n, ast.Constant) and isinstance(n.value, str)
                and (n.value.strip("/") == "spgpu_tpu" or "spgpu_tpu/" in n.value)
                and "spgpu_tpu_torch" not in n.value)

    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            args = list(node.args) + [k.value for k in node.keywords]
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            args = [node.left, node.right]
        else:
            continue
        bad += [a.value for a in args if names_pkg(a)]
    return bad


def _as_copied(ref: bytes) -> bytes:
    """The reference source as the port copies it: byte for byte, except
    that the header comment cites spGPU's ``src/core/hell.c`` relative to
    spGPU's tree, where the reference names an absolute path."""
    return re.sub(rb"\(/\S*/src/core/hell\.c", b"(src/core/hell.c", ref, count=1)


def test_native_source_is_the_reference_copy():
    with open(os.path.join(ROOT, "spgpu_tpu_torch", "csrc", "conversion.cpp"), "rb") as f:
        port = f.read()
    with open(os.path.join(ROOT, "spgpu_tpu", "native", "conversion.cpp"), "rb") as f:
        ref = f.read()
    assert port == _as_copied(ref), (
        "spgpu_tpu_torch/csrc/conversion.cpp differs from the JAX package's "
        "spgpu_tpu/native/conversion.cpp: copy it again")
    from spgpu_tpu_torch import native

    assert native.SOURCE == os.path.join(ROOT, "spgpu_tpu_torch", "csrc", "conversion.cpp")


@pytest.mark.parametrize("check", ["imports", "paths"])
def test_port_reads_nothing_of_the_jax_package(check):
    find = _jax_imports if check == "imports" else _paths_into_jax_package
    found = {}
    for path in _port_sources():
        with open(path) as f:
            hits = find(ast.parse(f.read(), path))
        if hits:
            found[os.path.relpath(path, ROOT)] = hits
    assert not found


def test_the_checks_catch_what_they_look_for():
    flagged = ast.parse('import jax.numpy\nfrom spgpu_tpu.ops import dd\n'
                        'p = os.path.join(ROOT, "spgpu_tpu", "native")\n'
                        'q = open("spgpu_tpu/native/conversion.cpp")\n'
                        'r = Path(ROOT) / "spgpu_tpu"\n')
    assert _jax_imports(flagged) == ["jax.numpy", "spgpu_tpu.ops"]
    assert len(_paths_into_jax_package(flagged)) == 3
    clean = ast.parse('"""Replaces spgpu_tpu/ops/pallas_kernels.py."""\n'
                      'K = {"a": ("cuda", "spgpu_tpu/ops/pallas_kernels.py:120")}\n'
                      'import spgpu_tpu_torch\n'
                      'p = os.path.join(ROOT, "spgpu_tpu_torch", "csrc")  # spgpu_tpu/\n')
    assert _jax_imports(clean) == [] and _paths_into_jax_package(clean) == []


def test_chip_smoke_fails_without_cuda():
    p = _run([os.path.join(ROOT, "chip_smoke.py")], ROOT,
             env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    p = _run([str(tmp_path / "chip_smoke.py")], str(tmp_path),
             env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
