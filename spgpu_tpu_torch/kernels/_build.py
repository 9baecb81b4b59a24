"""Build and load the hand-written CUDA kernels (``nvcc`` + ``ctypes``).

Each source ``spgpu_tpu_torch/csrc/<name>.cu`` has a plain C interface
and is compiled for ``sm_90a`` into ``spgpu_tpu_torch/_build/lib<name>.so``
on its first launch (never at import), with the same flags for every
library.  A library is rebuilt when its source is newer.  A missing
``nvcc`` or a failed compile raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Callable

from spgpu_tpu_torch.native import BUILD_DIR

__all__ = ["CudaLibrary", "compile_library", "kernel_key", "ptxas_by_kernel"]

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")


def _nvcc() -> str:
    """Path of ``nvcc`` (``PATH``, then ``$CUDA_HOME/bin``); raises if absent."""
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels are built from source on first launch")


def compile_library(source: str, path: str) -> tuple:
    """``nvcc`` of ``source`` into the shared library ``path`` with every
    library's flags (``sm_90a``, ``-O3``, ptxas's register and spill lines);
    returns ``(seconds, ptxas_log)`` and raises if the compile fails."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", tmp, source]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent load never sees a torn file
    return time.perf_counter() - t0, proc.stderr


def ptxas_by_kernel(log: str) -> dict:
    """``ptxas -v``'s spill and register lines of each kernel instance,
    keyed ``name<mangled template arguments>`` (``whell_tile_pass<ddLb0E>``:
    double, double, false), in the order ptxas reports them."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(_Z\w+)", ln)
        if m:
            name = kernel_key(m.group(1))
        elif name and ("registers" in ln or "spill" in ln):
            text = ln.strip().removeprefix("ptxas info    : ")
            out[name] = f"{out[name]}; {text}" if name in out else text
    return out


def kernel_key(mangled: str) -> str:
    """A mangled kernel name's last name component, with its template
    arguments as mangled (``_ZN<len><ns>...<len><name>I<args>EEv...``)."""
    i, name = 3, mangled
    while mangled.startswith("_ZN") and i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    rest = mangled[i:]
    if rest.startswith("I") and "EEv" in rest:
        name += f"<{rest[1:rest.index('EEv')]}>"
    return name


class CudaLibrary:
    """One kernel source, its shared library and its ctypes handle.

    ``bind(lib)`` declares the C entry points' ``argtypes``/``restype``."""

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None]):
        self.source = os.path.join(_CSRC, f"{name}.cu")
        self.path = os.path.join(BUILD_DIR, f"lib{name}.so")
        self._bind = bind
        self._lock = threading.Lock()
        self._lib = None

    def build(self) -> tuple:
        """Compile the library if it is missing or older than its source.
        Returns ``(seconds, ptxas_log)``; ``(0.0, "")`` when up to date."""
        if (os.path.exists(self.path)
                and os.path.getmtime(self.path) >= os.path.getmtime(self.source)):
            return 0.0, ""
        return compile_library(self.source, self.path)

    def load(self) -> ctypes.CDLL:
        """The bound library, built first if needed (thread-safe)."""
        with self._lock:
            if self._lib is None:
                self.build()
                lib = ctypes.CDLL(self.path)
                self._bind(lib)
                self._lib = lib
            return self._lib
