"""The JAX package's native layout library, made safe for the port's tests.

The port's parity tests compare its converters with the JAX package's, and
both must run the same C++ first-fit assigner and tiler.  The JAX package
builds ``spgpu_tpu/native/_libspgpu_native.so`` on first use through a
fixed temporary file; test workers that start that build together can
replace each other's half-written file, and a worker that then fails to
load it falls back, for the rest of its life, to the NumPy assigner, which
builds other layouts (5.44x padding against 1.74x on the flagship).  Its
parity tests would then fail as layout mismatches.

:func:`ensure_jax_native` takes a lock beside the library, rebuilds it
(per-process temporary file, atomic replace) when it is missing, older
than its source or not loadable, lets a worker that gave up try again,
and fails loudly when the library is still not in use.  Every
``tests/test_torch_*.py`` module that calls a JAX converter imports the
module-scoped autouse fixture :func:`jax_native`.
"""

import ctypes
import fcntl
import os
import subprocess

import pytest

from spgpu_tpu import native as jnative


def _loadable(path: str) -> bool:
    try:
        ctypes.CDLL(path)
    except OSError:
        return False
    return True


def _build(src: str, so: str) -> None:
    """The JAX package's g++ build of ``src`` into ``so`` (OpenMP when the
    compiler has it), through a per-process temporary file."""
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-fopenmp", src,
                        "-o", tmp], check=True, capture_output=True, timeout=300)
    except subprocess.CalledProcessError:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", src, "-o", tmp],
                       check=True, capture_output=True, timeout=300)
    os.replace(tmp, so)


def ensure_jax_native() -> None:
    """Make the JAX package's ``spgpu_tpu.native`` load its library in
    this process, or fail naming it."""
    so, src = jnative._SO, jnative._SRC
    what = (f"the JAX package's native layout library ({so}) is not in use "
            "in this process, so its converters would fall back to the NumPy "
            "assigner and build other layouts than the port")
    if os.environ.get("SPGPU_TPU_NO_NATIVE"):
        pytest.fail(f"{what}: SPGPU_TPU_NO_NATIVE is set")
    with open(so + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for _ in range(3):
            if (not os.path.exists(so)
                    or os.path.getmtime(so) < os.path.getmtime(src)
                    or not _loadable(so)):
                _build(src, so)
            with jnative._lock:
                if jnative._tried and jnative._lib is None:  # a load gave up
                    jnative._tried = False
            if jnative.available():
                return
    pytest.fail(f"{what}: it failed to load after 3 builds")


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """Run :func:`ensure_jax_native` before a module's first test."""
    ensure_jax_native()


def _relocate(monkeypatch, tmp_path, gave_up: bool) -> str:
    """Point ``spgpu_tpu.native`` at a library under ``tmp_path``, in the
    state of a fresh process or of one whose load gave up (both undone
    after the test)."""
    so = str(tmp_path / "_libspgpu_native.so")
    monkeypatch.setattr(jnative, "_SO", so)
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", gave_up)
    return so


@pytest.mark.parametrize("state", ["missing", "torn", "stale"])
def test_ensure_rebuilds_a_broken_library(state, monkeypatch, tmp_path):
    so = _relocate(monkeypatch, tmp_path, gave_up=True)
    if state != "missing":
        with open(so, "wb") as f:
            f.write(b"\x7fELF" + b"\0" * 60)  # a half-written library
    if state == "stale":
        os.utime(so, (0, 0))
    assert not jnative.available()  # the state a lost build race leaves
    ensure_jax_native()
    assert jnative._lib is not None and jnative._lib._name == so
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


def test_ensure_keeps_a_good_library(monkeypatch, tmp_path):
    so = _relocate(monkeypatch, tmp_path, gave_up=True)
    _build(jnative._SRC, so)
    mtime = os.stat(so).st_mtime_ns
    ensure_jax_native()
    assert jnative._lib is not None and os.stat(so).st_mtime_ns == mtime


def test_ensure_fails_loudly_without_native(monkeypatch, tmp_path):
    _relocate(monkeypatch, tmp_path, gave_up=False)
    monkeypatch.setenv("SPGPU_TPU_NO_NATIVE", "1")
    with pytest.raises(pytest.fail.Exception, match="native layout library"):
        ensure_jax_native()


def test_jax_native_in_use():
    assert jnative.available() and jnative._lib is not None
