"""PyTorch port: profiling and the benchmark protocol against the JAX
package's (:mod:`spgpu_tpu.utils.profiling`, :mod:`spgpu_tpu.utils.timing`),
on the CPU.

* ``roofline_report`` gives the JAX report key for key at one bandwidth
  (the card's name stubbed to the H100's, the JAX table stubbed to the
  same rate), and None shares where no rate is known;
* ``trace`` writes a Chrome trace naming the ops it saw, and, unlike the
  JAX ``trace``, lets an error raised inside it through (its trace still
  written);
* ``time_op`` times a chained loop; ``benchmark_op``'s checksum is the
  JAX one (‖z‖², a complex vector's over both parts as the JAX plane
  stack's), its GFLOPS (2·nnz − 1)/t.
"""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from spgpu_tpu import core as jcore
from spgpu_tpu.utils import profiling as jprof
from spgpu_tpu.utils import timing as jtiming

torch = pytest.importorskip("torch")

from spgpu_tpu_torch.utils import profiling, timing  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("name, bw", [(H100, 3.35e12), ("NVIDIA A100-SXM4-80GB", None)])
def test_roofline_report_matches_jax(name, bw, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    monkeypatch.setattr(jcore, "hbm_bandwidth", lambda device=None: bw)
    for args in (("spmv", 2.5e-5, 70_000_000, 13_500_000), ("dot", 1e-3, 8 << 20, 2 << 20)):
        got = profiling.roofline_report(*args, device="cuda:0")
        assert got == jprof.roofline_report(*args)
        assert (got["roofline_frac"] is None) == (bw is None)


def test_roofline_report_on_the_cpu_has_no_rate():
    rep = profiling.roofline_report("x", 1e-3, 10**6, 2 * 10**6, device="cpu")
    assert rep["roofline_gbs"] is None and rep["roofline_frac"] is None
    assert rep["gflops"] == pytest.approx(2.0) and rep["achieved_gbs"] == pytest.approx(1.0)


def _trace_files(d):
    return glob.glob(os.path.join(d, "*.json"))


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.arange(1000.0)
    with profiling.trace(str(tmp_path)) as prof:
        torch.cumsum(x, 0)
    assert prof is not None
    (path,) = _trace_files(str(tmp_path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::cumsum" for e in events)


def test_trace_reraises_and_still_writes(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with profiling.trace(str(tmp_path)):
            torch.ones(3).sum()
            1 / 0
    assert len(_trace_files(str(tmp_path))) == 1


def test_time_op_times_the_chained_loop():
    calls = []

    def op(a, x):
        calls.append(1)
        return a * x

    t = profiling.time_op(op, 2.0, torch.ones(64), iters=5, repeats=2)
    assert 0 < t < 1 and len(calls) == 5 * 3  # the warm-up loop and 2 repeats


@pytest.mark.parametrize("kind", ["float32", "complex64"])
def test_benchmark_op_checksum_matches_jax(kind):
    rng = np.random.default_rng(0)
    re, im = rng.standard_normal((2, 500)).astype(np.float32)
    if kind == "complex64":
        x = torch.complex(torch.from_numpy(re), torch.from_numpy(im))
        jx = jnp.asarray(np.stack([re, im]))  # the JAX package's plane stack
    else:
        x, jx = torch.from_numpy(re), jnp.asarray(re)
    got = timing.benchmark_op(lambda v: 3 * v, x, iters=4, nnz=1000, bytes_per_iter=4000)
    want = jtiming.benchmark_op(lambda v: 3 * v, jx, iters=4, nnz=1000)
    assert got.checksum == pytest.approx(want.checksum, rel=1e-6)
    assert got.iters == 4 and got.seconds_per_iter > 0
    assert got.gflops == pytest.approx(1999 / got.seconds_per_iter * 1e-9)
    assert got.gbytes_per_sec == pytest.approx(4000 / got.seconds_per_iter / 1e9)
    custom = timing.benchmark_op(lambda v: (3 * v, v), x, iters=1,
                                 checksum_fn=lambda out: 7.0)
    assert custom.checksum == 7.0 and custom.gflops is None
    assert timing.Clock().get_time() > 0
