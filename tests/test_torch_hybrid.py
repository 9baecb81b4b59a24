"""PyTorch port: the hybrid banded + irregular split against the JAX
package (its ``solve()`` routes: tests/test_torch_hybrid_solve.py).

On tests/test_hybrid.py's fixture (``random_mixed(1 << 12, bands=9,
wander=3, extra_avg=4.0, span=500, far_frac=0.02, seed=1)``):

* the split: ``tau_lanes``, ``band_nnz`` and ``runs`` equal the JAX
  converter's, and the band (WHDIA) and rest (packed WHELL) layouts equal
  the JAX parts carried across by their bridges, array for array (float64:
  the rest with ``scattered=False``, the JAX double-float geometry; values
  within the double-float split);
* ``hybrid_spmv`` (the plain versions of kernels #3/#1 and #6/#4 here)
  against the JAX op and the golden, at 2e-5 in float32 and 1e-12 in
  float64 (times max|z|), with alpha and beta, through ``ops.spmv`` too;
* the refusals: an unbanded matrix (``ValueError``, "not part-banded") and
  complex values (``NotImplementedError``), as in the JAX converter.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from spgpu_tpu.convert import coo_to_hybrid as j_coo_to_hybrid  # noqa: E402
from spgpu_tpu.formats.coo import CooMatrix as JCoo  # noqa: E402
from spgpu_tpu.ops import dd as jdd  # noqa: E402
from spgpu_tpu.ops import hybrid_spmv as j_hybrid_spmv  # noqa: E402
from spgpu_tpu_torch import ops as tops  # noqa: E402
from spgpu_tpu_torch.convert import coo_to_hybrid, hybrid_split_stats  # noqa: E402
from spgpu_tpu_torch.formats import whdia as twhdia  # noqa: E402
from spgpu_tpu_torch.formats import whell as twhell  # noqa: E402
from spgpu_tpu_torch.formats.coo import CooMatrix  # noqa: E402
from spgpu_tpu_torch.formats.hybrid import lane_runs, run_embed, run_extract  # noqa: E402
from spgpu_tpu_torch.utils import fixtures as tfix  # noqa: E402
from test_torch_native_guard import jax_native  # noqa: E402,F401  (autouse)

N = 1 << 12
TYPES = (np.float32, np.float64)
TOL = {np.float32: 2e-5, np.float64: 1e-12}


def mixed(dt=np.float32):
    return tfix.random_mixed(N, bands=9, wander=3, extra_avg=4.0, span=500,
                             far_frac=0.02, seed=1, dtype=dt)


def jcoo(c):
    return JCoo(c.rows, c.cols, c.values, c.n_rows, c.n_cols)


def rest_kw(dt):
    """The rest part's geometry as the JAX one's (float64: aligned)."""
    return dict(scattered=False) if np.dtype(dt) == np.float64 else {}


@pytest.fixture(scope="module")
def split():
    """Each type's port and JAX hybrids of the fixture."""
    out = {}
    for dt in TYPES:
        c = mixed(dt)
        out[dt] = (c, coo_to_hybrid(c, device="cpu", **rest_kw(dt)),
                   j_coo_to_hybrid(jcoo(c)))
    return out


def jax_arrays(ja):
    """A JAX layout's array fields as NumPy and its static fields."""
    arrays, static = {}, {}
    for f in dataclasses.fields(ja):
        v = getattr(ja, f.name)
        if f.metadata.get("static"):
            static[f.name] = v
        else:
            arrays[f.name] = None if v is None else np.asarray(v)
    return arrays, static


def assert_part_equal(port, bridged, dt, skip=()):
    """Every tensor of the port's part but ``skip`` equals the bridged JAX
    part's: structure bit for bit, values bit for bit in float32 and within
    the double-float split's 1e-13 in float64."""
    for f in dataclasses.fields(port):
        if f.name in skip:
            continue
        a, b = getattr(port, f.name), getattr(bridged, f.name)
        if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
            assert (a is None) == (b is None), f.name
            if f.name == "values" and np.dtype(dt) == np.float64:
                torch.testing.assert_close(a, b, rtol=1e-13, atol=0)
            else:
                assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("dt", TYPES, ids=lambda d: np.dtype(d).name)
def test_split_equals_jax(split, dt):
    c, h, jh = split[dt]
    assert (h.tau_lanes, h.band_nnz, h.nnz, h.runs) == \
        (jh.tau_lanes, jh.band_nnz, jh.nnz, jh.runs)
    assert 0 < h.band_nnz < c.nnz and h.band_nnz / c.nnz > 0.5
    _, occ = hybrid_split_stats(c)
    assert (occ >= h.tau_lanes).sum() == h.band_nnz
    band, static = jax_arrays(jh.band)
    jband = twhdia.from_numpy_fields(band, **static)
    if dt == np.float64:
        # the port packs an arithmetic-progression r0 per tile (pattern
        # mode) in float64 too, where the JAX double-float layout keeps
        # slot_r0 (tests/test_torch_f64.py): the same r0 on live slots
        live = (jband.values != 0).any(dim=1).numpy()
        assert np.array_equal(h.band.slot_r0_host()[live], jband.slot_r0_host()[live])
        assert_part_equal(h.band, jband, dt, skip=("slot_r0", "tile_r0"))
    else:
        assert_part_equal(h.band, jband, dt)
    rest, static = jax_arrays(jh.rest)
    assert_part_equal(h.rest, twhell.from_numpy_fields(rest, **static), dt)
    np.testing.assert_allclose(h.to_dense(), c.to_dense(), rtol=1e-6)


@pytest.mark.parametrize("dt", TYPES, ids=lambda d: np.dtype(d).name)
def test_hybrid_spmv_matches_jax_and_golden(split, dt):
    c, h, jh = split[dt]
    rng = np.random.default_rng(4)
    x = rng.standard_normal(N).astype(dt)
    y = rng.standard_normal(N).astype(dt)
    z = tops.hybrid_spmv(h, torch.from_numpy(x), 2.0, -0.5, torch.from_numpy(y))
    assert z.dtype == getattr(torch, np.dtype(dt).name)
    g = 2.0 * c.spmv(x.astype(np.float64)) - 0.5 * y.astype(np.float64)
    scale = TOL[dt] * np.abs(g).max()
    np.testing.assert_allclose(z.numpy(), g, rtol=0, atol=scale)
    if dt == np.float64:
        xj = jnp.asarray(np.stack(jdd.split(x)))
        zj = np.asarray(j_hybrid_spmv(jh, xj))
        zj = 2.0 * (zj[0].astype(np.float64) + zj[1]) - 0.5 * y
    else:
        zj = np.asarray(j_hybrid_spmv(jh, jnp.asarray(x), 2.0, -0.5, jnp.asarray(y)))
    np.testing.assert_allclose(z.numpy(), zj, rtol=0, atol=scale)
    torch.testing.assert_close(tops.spmv(h, torch.from_numpy(x), 2.0, -0.5,
                                         torch.from_numpy(y)), z, rtol=0, atol=0)


def test_lane_runs_roundtrip(split):
    c, h, _ = split[np.float32]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(N).astype(np.float32))
    xe = h.embed_rest(x)
    assert xe.shape == (h.rest.n_rows,)
    assert torch.equal(h.extract_rest(xe), x)
    assert torch.equal(run_embed(h.runs, h.rest.n_rows, x), xe)
    assert torch.equal(run_extract(h.runs, xe), x)
    lor = h.rest.lane_of_row.numpy()
    assert lane_runs(lor, h.rest.n_rows) == h.runs
    assert np.array_equal(np.concatenate([np.arange(d, d + n) for d, n in h.runs]), lor)


def test_refuses_unbanded_and_complex():
    fem = tfix.random_fem_like(N, 27.0, span=700, far_frac=0.01, seed=0,
                               dtype=np.float32)
    with pytest.raises(ValueError, match="not part-banded"):
        coo_to_hybrid(fem, device="cpu")
    c = mixed(np.float64)
    for dt in (np.complex64, np.complex128):
        cz = CooMatrix(c.rows, c.cols, c.values.astype(dt), N, N)
        with pytest.raises(NotImplementedError, match="complex"):
            coo_to_hybrid(cz, device="cpu")
    with pytest.raises(NotImplementedError, match="float16"):
        coo_to_hybrid(c, device="cpu", dtype=np.float16)
