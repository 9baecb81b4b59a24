"""The yardstick's arithmetic on synthetic data: work and bounds, rates
over a window, the tail and its sample rule, interval unions and gaps,
the profiler tally, and the readers built on them."""

import math
import statistics

import pytest

from portbench import stats, trace, work
from portbench.spec import load_module
import os

LAYER = os.path.join(os.path.dirname(os.path.dirname(__file__)), "layer_metrics")


def test_spmv_work_and_bound():
    nnz, n = 55_742_968, 2_097_152
    assert work.spmv_bytes(nnz, n, n, 8) == (nnz + 2 * n) * 8
    assert work.spmv_flops(nnz) == 2 * nnz
    peaks = work.peaks_for("NVIDIA H100 80GB HBM3")
    t = work.spmv_bound_s(nnz, n, n, "float64", peaks)
    assert t == pytest.approx((nnz + 2 * n) * 8 / 3.35e12)  # bytes bind
    assert 1e-9 * 2 * nnz / t == pytest.approx(778.9, rel=1e-3)  # GFLOP/s at the bound
    assert work.peaks_for("NVIDIA A100-SXM4-40GB") is None


def test_roofline_reader_share():
    peaks = work.peaks_for("H100 80GB HBM3")
    rec = {"nnz": 1000, "n": 100, "dtype": "float64", "peaks": peaks,
           "probe": {"per_call_s": 2 * work.spmv_bound_s(1000, 100, 100, "float64", peaks)}}
    assert work.spmv_roofline_pct(rec) == pytest.approx(50.0)
    for name in ("spmv_roofline.solve", "spmv_roofline.stream"):
        reader = load_module(os.path.join(LAYER, name + ".py"))
        assert reader.read(rec) == pytest.approx(50.0)
        assert reader.read(dict(rec, probe=None)) is None  # never 0
        assert reader.read(dict(rec, peaks=None)) is None


def test_rate_is_over_the_whole_window():
    assert stats.rate(300, 2.0) == 150.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_p95_over_all_samples_and_its_sample_rule():
    assert stats.p95(list(range(199))) is None
    samples = [1.0] * 190 + [10.0] * 10
    # 200 samples: the 95th percentile lies between the 190th and 191st
    assert stats.p95(samples) == pytest.approx(
        statistics.quantiles(samples, n=100, method="inclusive")[94])
    assert stats.p95(list(range(1, 1001))) == pytest.approx(950.05)


def test_spread_is_quartiles_over_median():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx((4.5 - 1.5) / 3.0)


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.7)]
    assert stats.busy_union(iv) == pytest.approx(3.0)
    assert stats.idle_gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]
    assert stats.idle_pct({"busy_s": 3.0, "window_s": 6.0}) == pytest.approx(50.0)
    assert stats.idle_pct({"busy_s": 0.0, "window_s": 6.0}) is None


def test_tally_tolerates_one_lost_event():
    ev = [("k", 1.0)] * 10 + [("fill", 0.5)] * 9
    times, usable = stats.tally(ev, 10)
    assert usable and times["k"] == pytest.approx(1.0) and times["fill"] == pytest.approx(0.5)
    assert not stats.tally([("k", 1.0)] * 8, 10)[1]
    assert not stats.tally([], 10)[1]
    assert stats.per_call(ev, 10) == pytest.approx(1.5)


def test_summary_and_vector_reader():
    rec = {"t0": 0.0, "t1": 10.0,
           "spans": [("solve", 0.0, 4.0), ("solve", 4.0, 10.0)],
           "device_ops": [("spmv", 1.0, 2.0), ("axpby", 2.0, 3.0), ("spmv", 5.0, 6.0),
                          ("dot", 6.0, 6.5), ("late", 9.5, 11.0)]}
    s = trace.summarize(rec)
    assert s["window_s"] == 10.0 and s["busy_s"] == pytest.approx(4.0)
    assert s["breakdown"]["device_ops"][0] == ["spmv", 2.0]
    gaps = s["breakdown"]["idle_gaps"]
    assert gaps == [["solve", pytest.approx(3.0)], ["solve", pytest.approx(2.0)],
                    ["solve", pytest.approx(1.0)]]
    reader = load_module(os.path.join(LAYER, "vector_us_per_iter.py"))
    full = dict(s, slice=rec, slice_iterations=2,
                probe={"per_call_s": 1.25, "primary": "spmv", "primary_s": 1.0})
    # busy 4 s less two products of 1.25 s, over 2 iterations
    assert reader.read(full) == pytest.approx(1e6 * (4.0 - 2.5) / 2)
    assert reader.read(dict(full, probe=None)) is None
    idle = load_module(os.path.join(LAYER, "device_idle.solve.py"))
    assert idle.read(s) == pytest.approx(60.0)
    assert not math.isnan(idle.read(s))
