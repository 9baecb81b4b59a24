"""PyTorch port: the context API against :mod:`spgpu_tpu.core`, on the CPU.

* the type registry (``Status``, ``TypeCode``, ``size_of``, ``dtype_of``)
  equals the JAX one code for code;
* ``Context(device="cpu")`` has the JAX geometry (lanes, slots per dtype)
  and keeps the JAX stream shims' no-op behaviour; ``Context()`` and
  ``create()`` raise without a card, as the measurement paths do;
* ``hbm_bandwidth`` reads the card's name (stubbed here) and gives None
  for the CPU and an unknown card; ``utils.measure``'s rate is its H100
  entry;
* the rest of the surface: the top-level and ``utils`` exports of the
  JAX package, ``convert.whell.dataclasses_replace_values`` and
  ``parallel.partition.pad_vector``, each beside its JAX counterpart.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import spgpu_tpu
import spgpu_tpu.utils
from spgpu_tpu import core as jcore
from spgpu_tpu.convert import whell as jwhell
from spgpu_tpu.parallel import partition as jpartition

torch = pytest.importorskip("torch")

import spgpu_tpu_torch  # noqa: E402
import spgpu_tpu_torch.utils  # noqa: E402
from spgpu_tpu_torch import core  # noqa: E402
from spgpu_tpu_torch.convert import whell as twhell  # noqa: E402
from spgpu_tpu_torch.parallel import partition as tpartition  # noqa: E402
from spgpu_tpu_torch.utils import measure  # noqa: E402

from test_torch_native_guard import jax_native  # noqa: E402,F401  (autouse)


@pytest.mark.parametrize("code", list(jcore.TypeCode), ids=lambda c: c.name)
def test_type_registry_matches_jax(code):
    assert core.TypeCode[code.name] == code
    assert core.size_of(code) == jcore.size_of(code)
    assert core.dtype_name(core.dtype_of(code)) == np.dtype(jcore.dtype_of(code)).name


def test_status_codes_match_jax():
    assert [(s.name, int(s)) for s in core.Status] == \
        [(s.name, int(s)) for s in jcore.Status]


def test_cpu_context_geometry_and_stream_shims():
    ctx, jctx = core.Context(device="cpu"), jcore.Context()
    assert (ctx.platform, ctx.lanes, ctx.hbm_bandwidth) == ("cpu", jctx.lanes, None)
    for name in ("float32", "float64", "bfloat16", "float16", "int8", "int32",
                 "complex64", "complex128"):
        want = jctx.sublanes(jnp.bfloat16 if name == "bfloat16" else np.dtype(name))
        assert ctx.sublanes(getattr(torch, name)) == want, name
    assert ctx.stream_create() is None and jctx.stream_create() is None
    assert ctx.set_stream(None) == jctx.set_stream(None) == core.Status.SUCCESS
    assert ctx.get_stream() is None and jctx.get_stream() is None
    assert core.destroy(ctx) == core.Status.SUCCESS


@pytest.mark.parametrize("make", [lambda: core.Context(), lambda: core.create(),
                                  lambda: core.Context(device="cuda")],
                         ids=["Context()", "create()", "Context(cuda)"])
def test_card_contexts_raise_without_a_card(make, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        make()


@pytest.mark.parametrize("name, want", [("NVIDIA H100 80GB HBM3", 3.35e12),
                                        ("NVIDIA A100-SXM4-80GB", None)])
def test_hbm_bandwidth_by_card_name(name, want, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    assert core.hbm_bandwidth() == want
    assert core.hbm_bandwidth("cuda:0") == want
    assert core.Context("cuda:0").hbm_bandwidth == want
    assert core.create(0).platform == "cuda"
    assert core.hbm_bandwidth("cpu") is None
    with pytest.raises(ValueError, match="no CUDA device 1"):
        core.create(1)


def test_hbm_bandwidth_none_on_the_cpu():
    assert core.hbm_bandwidth("cpu") is None
    if not torch.cuda.is_available():
        assert core.hbm_bandwidth() is None


def test_measure_rate_is_the_tables_h100_entry():
    assert measure.HBM_BYTES_PER_S == core.HBM_BW_BY_KIND["H100 80GB HBM3"] == 3.35e12


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


def test_top_level_and_utils_exports_cover_the_jax_packages():
    top = {n for n in _public(spgpu_tpu) if n not in ("native", "core", "bench")}
    assert top - _public(spgpu_tpu_torch) == set()
    assert _public(spgpu_tpu.utils) - {"fixtures", "hostmem", "profiling", "timing"} \
        - _public(spgpu_tpu_torch.utils) == set()
    assert spgpu_tpu_torch.create is core.create
    assert spgpu_tpu_torch.parallel.ShardedHandle is not None


def test_dataclasses_replace_values_matches_jax():
    from spgpu_tpu.convert import coo_to_whell as jax_coo_to_whell
    from spgpu_tpu_torch.convert import coo_to_whell
    from spgpu_tpu_torch.utils.fixtures import random_fem_like

    coo = random_fem_like(700, 9.0, span=96, far_frac=0.02, seed=3, dtype=np.float32)
    a = coo_to_whell(coo, device="cpu")
    ja = jax_coo_to_whell(coo, packed=True)
    b = twhell.dataclasses_replace_values(a, 2 * a.values)
    jb = jwhell.dataclasses_replace_values(ja, 2 * ja.values)
    np.testing.assert_array_equal(b.values.numpy(), np.asarray(jb.values))
    assert torch.equal(b.hack_units, a.hack_units) and b.n_rows == a.n_rows
    np.testing.assert_array_equal(b.to_dense(), 2 * a.to_dense())


@pytest.mark.parametrize("shape, dtype", [((5,), np.float32), ((2, 5), np.float64),
                                          ((5,), np.complex64), ((8,), np.int32)])
def test_pad_vector_matches_jax(shape, dtype):
    x = np.arange(np.prod(shape)).reshape(shape).astype(dtype)
    got = tpartition.pad_vector(torch.from_numpy(x), 8)
    want = np.asarray(jpartition.pad_vector(x, 8))
    assert core.dtype_name(got.dtype) == want.dtype.name
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="does not fit"):
        tpartition.pad_vector(torch.from_numpy(x), shape[-1] - 1)
