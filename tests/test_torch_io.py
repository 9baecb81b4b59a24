"""PyTorch port: Matrix Market I/O against the JAX package.

``spgpu_tpu_torch.io`` is a NumPy copy of ``spgpu_tpu.io.mm`` with its own
binding of the same C++ tokenizer.  Every file of ``tests/test_io.py``,
and ``.gz``, integer and skew-symmetric files (banners written by hand,
bodies from the JAX ``write_mm``), is read by both readers: ``rows``,
``cols``, ``values``, shape and dtype must be equal bit for bit, and so
must the properties.  The two writers write the same bytes, and the JAX
reader reads the port's file back.  A body the tokenizer rejects goes to
``np.loadtxt`` in both packages.  A file read by the port goes through
``solve(device="cpu")`` to the JAX ``solve()``'s answer, in the manner of
``tests/test_io.py::test_bench_mtx_pipeline``.
"""

import gzip
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from spgpu_tpu.formats.coo import CooMatrix as JCoo  # noqa: E402
from spgpu_tpu.io import read_mm as j_read  # noqa: E402
from spgpu_tpu.io import read_mm_properties as j_props  # noqa: E402
from spgpu_tpu.io import write_mm as j_write  # noqa: E402
from spgpu_tpu.solvers import solve as j_solve  # noqa: E402
from spgpu_tpu_torch import io as tio  # noqa: E402
from spgpu_tpu_torch.formats.coo import CooMatrix  # noqa: E402
from spgpu_tpu_torch.solvers import solve  # noqa: E402
from spgpu_tpu_torch.utils.fixtures import laplacian_2d, random_banded  # noqa: E402
from test_io import ARRAY, COMPLEX_H, GENERAL, PATTERN, SYMMETRIC  # noqa: E402
from test_torch_native_guard import jax_native  # noqa: E402,F401  (autouse)

TEXTS = {"general": GENERAL, "symmetric": SYMMETRIC, "pattern": PATTERN,
         "complex_hermitian": COMPLEX_H, "array": ARRAY}


def _same(t, j):
    """The port's COO equals the JAX one bit for bit."""
    assert type(t).__module__.startswith("spgpu_tpu_torch")
    assert (t.n_rows, t.n_cols) == (j.n_rows, j.n_cols)
    for got, want in ((t.rows, j.rows), (t.cols, j.cols), (t.values, j.values)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


def _read_both(src, **kw):
    """Read ``src`` (text or a path) with both readers."""
    def fresh():
        return io.StringIO(src) if isinstance(src, str) and "\n" in src else src
    return tio.read_mm(fresh(), **kw), j_read(fresh(), **kw)


@pytest.mark.parametrize("unfold", [True, False], ids=["unfold", "as_stored"])
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_test_io_fixtures_match(name, unfold):
    _same(*_read_both(TEXTS[name], unfold_symmetric=unfold))
    t, j = tio.read_mm_properties(io.StringIO(TEXTS[name])), j_props(io.StringIO(TEXTS[name]))
    assert t.__dict__ == j.__dict__ and t.is_symmetric == j.is_symmetric


@pytest.mark.parametrize("drop", [None, True, False])
@pytest.mark.parametrize("dtype", [None, np.float32, np.complex64])
def test_symmetric_with_zeros_options(dtype, drop):
    """The explicit zero of the symmetric fixture, dropped or kept, and
    the value dtype override."""
    _same(*_read_both(SYMMETRIC, dtype=dtype, drop_explicit_zeros=drop))


def _hand_banner(tmp_path, name, banner, coo, field=None, gz=False):
    """A file with a banner written by hand and the body of the JAX
    ``write_mm``."""
    buf = io.StringIO()
    j_write(buf, coo, field=field)
    body = buf.getvalue().split("\n", 1)[1]
    path = tmp_path / (name + (".mtx.gz" if gz else ".mtx"))
    text = banner + "\n% written by hand\n" + body
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text(text)
    return str(path)


def _lower(coo, strict=False):
    keep = coo.rows > coo.cols if strict else coo.rows >= coo.cols
    return JCoo(coo.rows[keep], coo.cols[keep], coo.values[keep], coo.n_rows, coo.n_cols)


def _cases(tmp_path):
    lap = laplacian_2d(7, 5)
    jlap = JCoo(lap.rows, lap.cols, lap.values, lap.n_rows, lap.n_cols)
    rng = np.random.default_rng(3)
    ints = JCoo(lap.rows, lap.cols, rng.integers(-9, 10, lap.nnz).astype(np.float64),
                lap.n_rows, lap.n_cols)
    cplx = JCoo(lap.rows, lap.cols, lap.values + 1j * rng.standard_normal(lap.nnz),
                lap.n_rows, lap.n_cols)
    return {
        "gz_general": _hand_banner(tmp_path, "g", "%%MatrixMarket matrix coordinate "
                                   "real general", jlap, gz=True),
        "gz_symmetric": _hand_banner(tmp_path, "gs", "%%MatrixMarket matrix coordinate "
                                     "real symmetric", _lower(jlap), gz=True),
        "integer": _hand_banner(tmp_path, "i", "%%MatrixMarket matrix coordinate "
                                "integer general", ints, field="real"),
        "integer_symmetric": _hand_banner(tmp_path, "is", "%%MatrixMarket matrix "
                                          "coordinate integer symmetric",
                                          _lower(ints), field="real"),
        "skew": _hand_banner(tmp_path, "s", "%%MatrixMarket matrix coordinate real "
                             "skew-symmetric", _lower(jlap, strict=True)),
        "skew_complex": _hand_banner(tmp_path, "sc", "%%MatrixMarket matrix "
                                     "coordinate complex skew-symmetric",
                                     _lower(cplx, strict=True)),
        "hermitian": _hand_banner(tmp_path, "h", "%%MatrixMarket matrix coordinate "
                                  "complex hermitian", _lower(cplx)),
    }


CASE_NAMES = ["gz_general", "gz_symmetric", "integer", "integer_symmetric", "skew",
              "skew_complex", "hermitian"]


@pytest.mark.parametrize("unfold", [True, False], ids=["unfold", "as_stored"])
@pytest.mark.parametrize("name", CASE_NAMES)
def test_hand_banner_files_match(name, unfold, tmp_path):
    path = _cases(tmp_path)[name]
    _same(*_read_both(path, unfold_symmetric=unfold))
    t, j = tio.read_mm_properties(path), j_props(path)
    assert t.__dict__ == j.__dict__


@pytest.mark.parametrize("field", [None, "real", "complex"])
def test_writers_agree_and_jax_reads_the_port(field, tmp_path):
    rng = np.random.default_rng(4)
    lap = laplacian_2d(9, 6)
    vals = lap.values * rng.standard_normal(lap.nnz)
    if field == "complex":
        vals = vals + 1j * rng.standard_normal(lap.nnz)
    coo = CooMatrix(lap.rows, lap.cols, vals, lap.n_rows, lap.n_cols)
    tio.write_mm(tmp_path / "port.mtx", coo, field=field)
    j_write(tmp_path / "jax.mtx", JCoo(coo.rows, coo.cols, coo.values, 54, 54),
            field=field)
    assert (tmp_path / "port.mtx").read_bytes() == (tmp_path / "jax.mtx").read_bytes()
    back = j_read(str(tmp_path / "port.mtx"))
    _same(tio.read_mm(str(tmp_path / "port.mtx")), back)
    assert np.array_equal(back.values, coo.values)
    # a file object, as the JAX writer takes one
    buf = io.StringIO()
    tio.write_mm(buf, coo, field=field)
    assert buf.getvalue().encode() == (tmp_path / "port.mtx").read_bytes()


def _spy_loadtxt(monkeypatch):
    calls = []
    loadtxt = np.loadtxt
    monkeypatch.setattr(np, "loadtxt", lambda *a, **k: calls.append(1) or loadtxt(*a, **k))
    return calls


def test_misaligned_body_takes_loadtxt_and_raises_in_both(tmp_path, monkeypatch):
    """tests/test_io.py's merged entries: the tokenizer rejects the body,
    ``np.loadtxt`` raises, in both packages."""
    p = tmp_path / "bad.mtx"
    p.write_text("%%MatrixMarket matrix coordinate real general\n3 3 3\n"
                 "1 1 2.0\n2 2 3.0 3 3 4.0\n")
    calls = _spy_loadtxt(monkeypatch)
    for read in (tio.read_mm, j_read):
        with pytest.raises(ValueError):
            read(str(p))
    assert len(calls) == 2


@pytest.mark.parametrize("body", ["1.0 1 2.5\n2 2 -1\n3 1 4\n",
                                  "1 1 2.5 # note\n2 2 -1\n3 1 4\n"],
                         ids=["float_index", "trailing_comment"])
def test_loadtxt_fallback_gives_the_same_coo(body, monkeypatch):
    """Bodies the strict tokenizer rejects and ``np.loadtxt`` reads: both
    packages take the fallback and agree."""
    calls = _spy_loadtxt(monkeypatch)
    text = "%%MatrixMarket matrix coordinate real general\n3 3 3\n" + body
    t, j = _read_both(text)
    _same(t, j)
    assert len(calls) == 2 and t.nnz == 3


def test_port_file_solves_like_jax(tmp_path):
    """A PSBLAS-style user's path: an SPD band's lower triangle in a
    ``symmetric`` file, read by the port and solved on the CPU, against the
    JAX package reading and solving the same file (float32 values, SDIA
    by auto-selection in both): iterations within max(3, 10 %), x within
    1e-3, the true residual under 1e-4."""
    n = 600
    base = random_banded(n, bands=5, seed=1, dtype=np.float32).sum_duplicates()
    d = np.zeros(n)
    np.add.at(d, base.rows, np.abs(base.values))
    spd = CooMatrix(np.r_[base.rows, base.cols, np.arange(n)],
                    np.r_[base.cols, base.rows, np.arange(n)],
                    np.r_[base.values * .05, base.values * .05, d + 1.0].astype(np.float32),
                    n, n).sum_duplicates()
    keep = spd.rows >= spd.cols
    path = tmp_path / "t.mtx"
    tio.write_mm(str(path), CooMatrix(spd.rows[keep], spd.cols[keep], spd.values[keep],
                                      n, n))
    lines = path.read_text().split("\n")
    lines[0] = lines[0].replace("general", "symmetric")
    path.write_text("\n".join(lines))
    t, j = _read_both(str(path), dtype=np.float32)
    _same(t, j)
    assert t.nnz == spd.nnz
    b = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    rt = solve(t.sum_duplicates(), b, device="cpu", tol=1e-5, maxiter=2000)
    rj = j_solve(j.sum_duplicates(), b, tol=1e-5, maxiter=2000)
    assert bool(rt.converged) and bool(rj.converged)
    assert abs(int(rj.iterations) - rt.iterations) <= max(3, rt.iterations // 10)
    xt = rt.x.numpy().astype(np.float64)
    xj = np.asarray(rj.x, np.float64)
    np.testing.assert_allclose(xt, xj, rtol=1e-3, atol=1e-3 * np.abs(xj).max())
    assert np.linalg.norm(b - spd.spmv(xt)) <= 1e-4 * np.linalg.norm(b)


def test_new_modules_are_under_the_import_checks():
    """tests/test_torch_import.py walks every module of the port: the I/O
    and host-memory copies are among them and import nothing of JAX."""
    import ast
    import os

    from test_torch_import import _jax_imports, _paths_into_jax_package, _port_sources

    sources = {os.path.relpath(p, os.path.dirname(os.path.dirname(__file__))): p
               for p in _port_sources()}
    for rel in ("spgpu_tpu_torch/io/__init__.py", "spgpu_tpu_torch/io/mm.py",
                "spgpu_tpu_torch/utils/hostmem.py"):
        with open(sources[rel]) as f:
            tree = ast.parse(f.read())
        assert _jax_imports(tree) == [] and _paths_into_jax_package(tree) == []


def test_hostmem_copy_keeps_the_opt_out(monkeypatch):
    """The port's ``tune_malloc`` honours the JAX package's opt-out
    variable, and is idempotent once active."""
    from spgpu_tpu.utils import hostmem as j_hostmem
    from spgpu_tpu_torch.utils import hostmem

    monkeypatch.setattr(hostmem, "_done", False)
    monkeypatch.setenv("SPGPU_TPU_NO_MALLOC_TUNING", "1")
    assert hostmem.tune_malloc() is False
    monkeypatch.delenv("SPGPU_TPU_NO_MALLOC_TUNING")
    assert hostmem.tune_malloc() == j_hostmem.tune_malloc()
    assert hostmem.tune_malloc() is hostmem._done
