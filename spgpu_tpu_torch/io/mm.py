"""Matrix Market I/O.

A copy of :mod:`spgpu_tpu.io.mm` (NumPy, the same behaviour: the port's
:class:`~spgpu_tpu_torch.formats.coo.CooMatrix`, the same C++ tokenizer
through :func:`spgpu_tpu_torch.native.mm_parse`), carried so the PyTorch
port never imports the JAX package.

Re-implementation (no scipy in the image, and the reference carries its own
NIST ``mmio`` copy anyway) of the reference's reader stack:

* banner + properties: ``loadMmProperties``
  (``/root/reference/src/utils/mmread.cpp:15-59`` → ``mmio.c``)
* COO load with real/integer/pattern/complex overloads:
  ``loadMmMatrixToCoo`` (``mmread.cpp:63-``)
* symmetric unfolding that drops explicit zeros:
  ``getUnfoldedMmSymmetricSize`` / ``unfoldMmSymmetricReal``
  (``mmutils.hpp:10-62``)

Supports ``coordinate`` and ``array`` formats; ``real``, ``integer``,
``complex``, ``pattern`` fields; ``general``, ``symmetric``,
``skew-symmetric``, ``hermitian`` symmetries.  Also provides a writer for
round-trip tests (the reference has none — writer is a convenience
extension).
"""

from __future__ import annotations

import dataclasses
import gzip
from typing import Optional

import numpy as np

from spgpu_tpu_torch.formats.coo import CooMatrix
from spgpu_tpu_torch.utils import hostmem as _hostmem  # noqa: F401  malloc tuning
#   (keeps the ~270 MB of rows/cols/vals buffers heap-resident across
#   loads — the §2e microVM page-fault tax otherwise doubles read time)

__all__ = ["MmProperties", "read_mm_properties", "read_mm", "write_mm"]


@dataclasses.dataclass
class MmProperties:
    """Parsed ``%%MatrixMarket`` banner; mirrors ``loadMmProperties``."""

    object: str  # "matrix"
    format: str  # "coordinate" | "array"
    field: str  # "real" | "integer" | "complex" | "pattern"
    symmetry: str  # "general" | "symmetric" | "skew-symmetric" | "hermitian"
    n_rows: int = 0
    n_cols: int = 0
    nnz: int = 0

    @property
    def is_symmetric(self) -> bool:
        return self.symmetry != "general"


def _open(path_or_file):
    if hasattr(path_or_file, "read"):
        return path_or_file, False
    p = str(path_or_file)
    if p.endswith(".gz"):
        return gzip.open(p, "rt"), True
    return open(p, "r"), True


def _open_binary(path_or_file):
    """Binary-mode open for the bulk body read: a 367 MB text-mode read
    costs ~2.8 s of decode (+ a re-encode for the C tokenizer) that the
    bytes path skips entirely.  Caller-supplied file objects keep their
    own mode."""
    if hasattr(path_or_file, "read"):
        return path_or_file, False
    p = str(path_or_file)
    if p.endswith(".gz"):
        return gzip.open(p, "rb"), True
    return open(p, "rb"), True


def _rl(f) -> str:
    """readline returning str for text OR binary handles."""
    line = f.readline()
    return line.decode("latin-1") if isinstance(line, bytes) else line


def _parse_banner(line: str) -> MmProperties:
    parts = line.strip().split()
    if len(parts) < 5 or parts[0] not in ("%%MatrixMarket", "%MatrixMarket"):
        raise ValueError(f"not a MatrixMarket banner: {line!r}")
    obj, fmt, field, sym = (p.lower() for p in parts[1:5])
    if obj != "matrix":
        raise ValueError(f"unsupported MatrixMarket object {obj!r}")
    if fmt not in ("coordinate", "array"):
        raise ValueError(f"unsupported format {fmt!r}")
    if field not in ("real", "integer", "complex", "pattern"):
        raise ValueError(f"unsupported field {field!r}")
    if sym not in ("general", "symmetric", "skew-symmetric", "hermitian"):
        raise ValueError(f"unsupported symmetry {sym!r}")
    return MmProperties(obj, fmt, field, sym)


def read_mm_properties(path_or_file) -> MmProperties:
    """Read banner + size line only; mirrors ``loadMmProperties``."""
    f, should_close = _open(path_or_file)
    try:
        props = _parse_banner(f.readline())
        for line in f:
            s = line.strip()
            if not s or s.startswith("%"):
                continue
            dims = s.split()
            props.n_rows, props.n_cols = int(dims[0]), int(dims[1])
            props.nnz = int(dims[2]) if props.format == "coordinate" else (
                props.n_rows * props.n_cols
            )
            return props
        raise ValueError("missing MatrixMarket size line")
    finally:
        if should_close:
            f.close()


def read_mm(
    path_or_file,
    dtype=None,
    unfold_symmetric: bool = True,
    drop_explicit_zeros: Optional[bool] = None,
) -> CooMatrix:
    """Load a Matrix Market file to :class:`CooMatrix`.

    ``unfold_symmetric=True`` generalises symmetric/hermitian/skew input by
    mirroring off-diagonal entries, as ``unfoldMmSymmetricReal``
    (``mmutils.hpp:10-62``) does for the perf harnesses
    (``hellPerf.cpp:94-114``).  Like the reference's unfold, explicit zeros
    are dropped during unfolding (and only then, unless
    ``drop_explicit_zeros`` overrides).
    """
    f, should_close = _open_binary(path_or_file)
    try:
        props = _parse_banner(_rl(f))
        # skip comments to the size line
        while True:
            s = _rl(f).strip()
            if s and not s.startswith("%"):
                break
        dims = s.split()
        n_rows, n_cols = int(dims[0]), int(dims[1])

        if props.format == "array":
            data = np.loadtxt(f, dtype=np.float64, ndmin=2)
            if props.field == "complex":
                flat = data.reshape(-1, 2)
                vals = (flat[:, 0] + 1j * flat[:, 1]).reshape(-1)
            else:
                vals = data.reshape(-1)
            # array format is column-major dense
            dense = vals.reshape((n_cols, n_rows)).T
            if props.symmetry in ("symmetric", "hermitian", "skew-symmetric"):
                # array symmetric stores lower triangle column by column
                tri = vals
                dense = np.zeros((n_rows, n_cols), dtype=tri.dtype)
                idx = 0
                for j in range(n_cols):
                    span = n_rows - j
                    dense[j:, j] = tri[idx : idx + span]
                    idx += span
                lower = np.tril(dense, -1)
                mirror = lower.conj().T if props.symmetry == "hermitian" else (
                    -lower.T if props.symmetry == "skew-symmetric" else lower.T
                )
                dense = dense + mirror
            r, c = np.nonzero(dense)
            coo = CooMatrix(r.astype(np.int64), c.astype(np.int64), dense[r, c], n_rows, n_cols)
            if dtype is not None:
                coo = CooMatrix(coo.rows, coo.cols, coo.values.astype(dtype), n_rows, n_cols)
            return coo

        nnz = int(dims[2])
        ncols_txt = {"pattern": 2, "real": 3, "integer": 3, "complex": 4}[props.field]
        rows = cols = rvals = None
        if nnz > 0:
            # fast path (r5): one bulk read + the parallel C++ tokenizer
            # (``native.mm_parse``) — newline-aligned chunks parsed with
            # OpenMP threads and STRICT per-line validation (every
            # non-blank line must hold exactly ncols_txt tokens), so a
            # structurally misaligned body can never silently reshape
            # (ADVICE r4: the old np.fromstring path was lenient and
            # deprecated).  The reference's mmio.c is a per-line fscanf
            # loop (``src/utils/mmread.cpp:63-``); the JAX package's
            # measurement, on its own host: 12M nnz ≈ 1.3 s vs 10 s (r4
            # tokenizer) vs 20 s (loadtxt).  A malformed or misaligned
            # body falls back to np.loadtxt; a missing compiler raises.
            buf = f.read()
            from spgpu_tpu_torch import native as _native

            parsed = _native.mm_parse(buf, ncols_txt, nnz)
            if parsed is not None:
                r1, c1, v = parsed
                rows = r1 - 1
                cols = c1 - 1
                if props.field == "pattern":
                    rvals = np.ones(nnz, dtype=np.float64)
                elif props.field == "complex":
                    rvals = v[:, 0] + 1j * v[:, 1]
                elif props.field == "integer":
                    rvals = v.astype(np.int64).astype(np.float64)
                else:
                    rvals = v.copy()
            else:
                import io as _io

                data = np.loadtxt(
                    _io.BytesIO(buf) if isinstance(buf, bytes)
                    else _io.StringIO(buf), dtype=np.float64, ndmin=2)
                del buf
                if data.shape[0] != nnz:
                    raise ValueError(
                        f"expected {nnz} entries, got {data.shape[0]}")
                if data.shape[1] < ncols_txt:
                    raise ValueError("malformed coordinate line")
        else:
            data = np.zeros((0, ncols_txt))

        if rows is None:
            rows = data[:, 0].astype(np.int64) - 1
            cols = data[:, 1].astype(np.int64) - 1
            if props.field == "pattern":
                vals = np.ones(nnz, dtype=np.float64)
            elif props.field == "complex":
                vals = data[:, 2] + 1j * data[:, 3]
            elif props.field == "integer":
                vals = data[:, 2].astype(np.int64).astype(np.float64)
            else:
                vals = data[:, 2]
        else:
            vals = rvals

        if props.is_symmetric and unfold_symmetric:
            drop = True if drop_explicit_zeros is None else drop_explicit_zeros
            if drop:
                keep = vals != 0
                rows, cols, vals = rows[keep], cols[keep], vals[keep]
            off = rows != cols
            mv = vals[off]
            if props.symmetry == "hermitian":
                mv = np.conj(mv)
            elif props.symmetry == "skew-symmetric":
                mv = -mv
            r_off, c_off = rows[off], cols[off]
            rows = np.concatenate([rows, c_off])
            cols = np.concatenate([cols, r_off])
            vals = np.concatenate([vals, mv])
        elif drop_explicit_zeros:
            keep = vals != 0
            rows, cols, vals = rows[keep], cols[keep], vals[keep]

        if dtype is not None:
            vals = vals.astype(dtype)
        elif props.field != "complex":
            vals = vals.astype(np.float64)
        return CooMatrix(rows, cols, vals, n_rows, n_cols)
    finally:
        if should_close:
            f.close()


def write_mm(path_or_file, coo: CooMatrix, field: Optional[str] = None) -> None:
    """Write a COO matrix as a general coordinate Matrix Market file."""
    if field is None:
        field = "complex" if np.iscomplexobj(coo.values) else "real"
    own = not hasattr(path_or_file, "write")
    f = open(str(path_or_file), "w") if own else path_or_file
    try:
        f.write(f"%%MatrixMarket matrix coordinate {field} general\n")
        f.write(f"{coo.n_rows} {coo.n_cols} {coo.nnz}\n")
        # one vectorised np.savetxt call (the reader is vectorised too);
        # a per-entry Python loop costs minutes at the 26.8M-nnz class
        if field == "complex":
            body = np.column_stack([
                coo.rows + 1, coo.cols + 1,
                coo.values.real, coo.values.imag,
            ])
            np.savetxt(f, body, fmt=("%d", "%d", "%.17g", "%.17g"))
        else:
            body = np.column_stack([coo.rows + 1, coo.cols + 1, coo.values])
            np.savetxt(f, body, fmt=("%d", "%d", "%.17g"))
    finally:
        if own:
            f.close()
