"""PyTorch port: the bench harness against :mod:`spgpu_tpu.bench.harness`,
on the CPU (the kernels' plain versions, the host clock).

* ``run_suite("small", device="cpu")`` gives the JAX suite's rows, config
  for config and in order (the JAX suite run with its product rows
  stubbed out, so no JAX product is timed, and its BLAS-1 rows at a tiny
  n); each SpMV/SpMM row's checksum agrees with its host golden;
* on ``fem_irregular`` (fp32 packed WHELL, the JAX layout bit for bit)
  and ``banded`` (WHDIA) the rows' ``n_rows``, ``nnz`` and ``pad_factor``
  equal the JAX ones, and the checksum is within 1e-4 of ‖z‖² of one JAX
  product (interpret mode) on the same x;
* each row's bytes are the nbytes of the layout tensors its route reads
  plus x and z;
* ``run_blas1_suite`` gives the JAX ops with the JAX byte counts;
* ``run_weak_scaling`` on gloo ranks (S = 2): the product at the
  golden, and the halo lanes the ranks sent equal to those the JAX
  partition plans;
* the entry points raise without a card unless given the CPU.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from spgpu_tpu.bench import harness as jharness

torch = pytest.importorskip("torch")

from spgpu_tpu_torch.bench import harness  # noqa: E402
from spgpu_tpu_torch.utils.measure import nbytes  # noqa: E402

from test_torch_native_guard import jax_native  # noqa: E402,F401  (autouse)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def suite():
    lines = []
    rows = harness.run_suite("small", out=lines.append, device="cpu")
    return rows, [json.loads(line) for line in lines]


def _jax_suite_configs(monkeypatch):
    """The JAX small suite's row configs in order, its product rows stubbed
    (no conversion, no timing) and its BLAS-1 rows at n = 4096."""
    class Row:
        def __init__(self, config):
            self.config = config

        def json(self):
            return json.dumps({"config": self.config})

    blas1 = jharness.run_blas1_suite
    monkeypatch.setattr(jharness, "run_config", lambda config, *a, **k: Row(config))
    monkeypatch.setattr(jharness, "_run_spmm8", lambda coo, out=None: Row("fem_irregular"))
    monkeypatch.setattr(jharness, "run_blas1_suite", lambda n, iters: blas1(4096, 2))
    lines = []
    jharness.run_suite("small", out=lines.append)
    return [json.loads(line)["config"] for line in lines]


def test_suite_rows_follow_the_jax_suite(suite, monkeypatch):
    rows, lines = suite
    assert [d["config"] for d in lines] == _jax_suite_configs(monkeypatch)
    assert [d.get("op") for d in lines if d["config"] in ("blas1", "conversion", "vendor")] \
        == ["dot", "nrm2", "asum", "amax", "axpby", "coo_to_whell_packed",
            "scipy_csr_cpu", "torch_sparse_csr"]
    for r in rows:
        if isinstance(r, harness.BenchResult):
            assert (r.t_source, r.device) == ("host", "cpu") and r.t_avg_s > 0
            assert r.launches == {}  # the plain versions on the CPU
            assert r.roofline_frac is None  # the CPU has no HBM rate
            tol = 1e-12 if "f64" in r.fmt else 1e-5
            assert r.checksum == pytest.approx(r.golden_checksum, rel=tol), r.fmt


@pytest.mark.parametrize("config, fmt", [("fem_irregular", "whell_packed_k1"),
                                         ("banded", "whdia_k3")])
def test_product_row_matches_the_jax_layout(suite, config, fmt):
    from spgpu_tpu.convert import coo_to_whdia, coo_to_whell
    from spgpu_tpu.ops import whdia_spmv, whell_spmv

    row = next(r for r in suite[0] if getattr(r, "fmt", None) == fmt)
    coo = next(spec[2] for spec in harness.suite_rows("small", CPU) if spec[1] == fmt)
    a = coo_to_whell(coo, packed=True) if config == "fem_irregular" else coo_to_whdia(coo)
    spmv = whell_spmv if config == "fem_irregular" else whdia_spmv
    x = jnp.asarray(np.random.default_rng(1).standard_normal(a.n_cols), jnp.float32)
    z = np.asarray(spmv(a, x), np.float64)
    assert (row.config, row.n_rows, row.nnz) == (config, coo.n_rows, coo.nnz)
    assert row.pad_factor == np.asarray(a.values).size / coo.nnz
    assert row.checksum == pytest.approx(float(np.sum(z * z)), rel=1e-4)


#: the layout tensors each route reads, by the port's ``fmt``
FIELDS = {
    "ell_torch": ("values", "col_indices", "row_perm"),
    "hell_spmm8_torch": ("values", "col_indices", "hack_offsets", "row_perm"),
    "sdia_k2": ("values", "offset_table"),
    "sdia_f64_k5": ("values", "offset_table"),
    "whdia_k3": ("values", "slot_r0", "tile_r0", "tile_page", "hack_slot_ptr",
                 "hack_slots"),
    "whdia_c64_k9": ("values", "slot_r0", "tile_r0", "tile_page", "hack_slot_ptr",
                     "hack_slots"),
}
for _fmt in ("whell_packed_k1", "whell_f64_k4", "whell_c64_k7", "whell_spmm8_k12"):
    FIELDS[_fmt] = ("values", "residue", "page_tab", "tile_page", "group_bases",
                    "hack_units", "seg_lo", "seg_hi")


def test_row_bytes_are_the_layout_tensors_and_vectors(suite):
    rows = [r for r in suite[0] if isinstance(r, harness.BenchResult)]
    specs = list(harness.suite_rows("small", CPU))
    assert [(r.config, r.fmt) for r in rows] == [s[:2] for s in specs]
    for r, (_, fmt, coo, convert, *_rest) in zip(rows, specs):
        a = convert(coo, CPU)
        rhs = 8 if "spmm8" in fmt else 1
        item = np.dtype(coo.values.dtype if fmt != "ell_torch" else np.float64).itemsize
        item = 4 if "spmm8" in fmt else item
        vectors = rhs * (a.n_cols + a.n_rows) * item
        assert r.bytes_moved == nbytes(*(getattr(a, f) for f in FIELDS[fmt])) + vectors, fmt
        assert r.eff_bandwidth_gbs == pytest.approx(r.bytes_moved / r.t_avg_s / 1e9)


def test_blas1_rows_take_the_jax_byte_counts():
    n = 1 << 12
    rows = harness.run_blas1_suite(n, iters=3, device="cpu")
    want = {"dot": 2 * n * 4, "nrm2": n * 4, "asum": n * 4, "amax": n * 4,
            "axpby": 3 * n * 4}
    assert [r["op"] for r in rows] == list(want)
    for r in rows:
        assert r["bytes_moved"] == want[r["op"]] and r["t_source"] == "host"
        assert r["eff_bandwidth_gbs"] == pytest.approx(want[r["op"]] / r["t_avg_s"] / 1e9)
        assert r["roofline_frac"] is None


def test_weak_scaling_on_gloo_ranks_matches_the_jax_halo():
    from spgpu_tpu.parallel.partition_packed import partition_coo_rows_packed
    from spgpu_tpu.utils.fixtures import random_banded

    (r,) = harness.run_weak_scaling(2048, shards=(2,), iters=2, out=None, device="cpu")
    jpm = partition_coo_rows_packed(
        random_banded(4096, bands=11, wander=3, seed=2, dtype=np.float32).sum_duplicates(), 2)
    assert r["shards"] == 2 and r["n_rows"] == 4096
    assert r["halo_lanes_used"] == sum(sum(c) for c in jpm.halo_counts) > 0
    assert r["halo_slots_sent"] == r["halo_lanes_used"] and r["k_padding_waste"] == 0.0
    assert r["halo_bytes_per_iter"] == 4 * r["halo_lanes_used"]
    assert r["max_rel_err"] <= 2e-5 and r["t_source"] == "host" and r["launches"] == {}
    assert r["efficiency"] == 1.0  # the only S run is its own base


@pytest.mark.parametrize("call", [
    lambda: harness.run_suite(out=None),
    lambda: harness.run_blas1_suite(1024),
    lambda: harness.run_baseline_rows(None, False),
    lambda: harness.run_config("c", "f", None, None, None, None),
    lambda: harness.run_weak_scaling(out=None),
], ids=["run_suite", "run_blas1_suite", "run_baseline_rows", "run_config",
        "run_weak_scaling"])
def test_entry_points_raise_without_a_card(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        call()
