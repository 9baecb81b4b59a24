"""PyTorch port: the device-timing helpers' session handling, on the CPU.

``device_ms`` must not report a profiling session that recorded only part
of the device activity: each call issues the same operations, so a
session's count of each operation tells how many of its events were
lost.  A session that lost at most one event of each operation is used,
rescaled; any other is repeated.  The sessions are stubbed here (the CPU
has no device activity to profile).
"""

import pytest

torch = pytest.importorskip("torch")

from spgpu_tpu_torch.utils import timing  # noqa: E402


def _stub(monkeypatch, sessions):
    """``_session`` hands back ``sessions`` in turn; no device needed."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    seen = []

    def session(fn, iters):
        seen.append(iters)
        return sessions[len(seen) - 1]
    monkeypatch.setattr(timing, "_session", session)
    monkeypatch.setattr(timing, "time_interleaved",
                        lambda fns, **k: {"fn": {"best_ms": 9.0, "spread_ms": 0.0}})
    return seen


def test_device_ms_repeats_a_partial_session(monkeypatch):
    seen = _stub(monkeypatch, [({"k": 0.08}, False), ({"k": 0.1, "m": 0.01}, True)])
    ms, src = timing.device_ms(lambda: None, iters=20, warmup=0)
    assert (round(ms, 6), src, len(seen)) == (0.11, "profiler", 2)


def test_device_ms_falls_back_to_events_after_partial_sessions(monkeypatch):
    seen = _stub(monkeypatch, [({"k": 0.08}, False)] * 3)
    assert timing.device_ms(lambda: None, warmup=0) == (9.0, "cuda_events")
    assert len(seen) == 3


def test_device_ms_by_kernel_keeps_the_first_complete_session(monkeypatch):
    seen = _stub(monkeypatch, [({}, False), ({"k": 0.1}, True), ({"k": 0.5}, True)])
    assert timing.device_ms_by_kernel(lambda: None, warmup=0) == {"k": 0.1}
    assert len(seen) == 2


def test_device_ms_by_kernel_reports_nothing_without_a_complete_session(monkeypatch):
    seen = _stub(monkeypatch, [({"k": 0.08}, False)] * 5)
    assert timing.device_ms_by_kernel(lambda: None, warmup=0) == {}
    assert len(seen) == 5


def test_tally_of_a_complete_session():
    ev = [("k", 0.10)] * 20 + [("fill", 0.01)] * 40
    times, usable = timing._tally(ev, 20)
    assert usable
    assert times == pytest.approx({"k": 0.10, "fill": 0.02})


def test_tally_rescales_one_lost_event():
    """On the H100 a session after one that profiled a loop with host
    reads loses one event of each operation: 19 of 20, 199 of 200."""
    ev = [("k", 0.10)] * 19 + [("fill", 0.01)] * 199
    times, usable = timing._tally(ev, 20)
    assert usable
    assert times == pytest.approx({"k": 0.10, "fill": 0.10})


@pytest.mark.parametrize("events", [[], [("k", 0.1)] * 18, [("k", 0.1)] * 21,
                                    [("k", 0.1)] * 20 + [("m", 0.1)] * 13])
def test_tally_refuses_other_sessions(events):
    assert not timing._tally(events, 20)[1]


def _stub_kernel_sessions(monkeypatch, sessions):
    """``kernel_device_ms`` with ``_session`` handing back ``sessions`` in
    turn, a sentinel flush and a stubbed event fallback; returns the flush
    each session was given."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(timing, "_l2_flush", lambda: "flush")
    monkeypatch.setattr(timing, "_call_events_ms", lambda fn, iters, flush: 7.0)
    given = []

    def session(fn, iters, flush=None):
        given.append(flush)
        return sessions[len(given) - 1]
    monkeypatch.setattr(timing, "_session", session)
    return given


def test_kernel_device_ms_keeps_only_the_named_kernels(monkeypatch):
    """The zero fill and the L2 flush are operations of their own: only
    the named kernels count, warm or cold."""
    times = {"tile_pass": 0.010, "flush_pass": 0.002, "vectorized_elementwise_kernel": 0.05}
    given = _stub_kernel_sessions(monkeypatch, [(times, True)] * 2)
    ms, src = timing.kernel_device_ms(lambda: None, ("tile_pass", "flush_pass"), warmup=0)
    assert (round(ms, 6), src) == (0.012, "profiler")
    ms, src = timing.kernel_device_ms(lambda: None, ("tile_pass",), cold=True, warmup=0)
    assert (ms, src) == (0.010, "profiler")
    assert given == [None, "flush"]


def test_kernel_device_ms_repeats_a_session_without_the_kernel(monkeypatch):
    given = _stub_kernel_sessions(monkeypatch, [({"other": 0.1}, True),
                                                ({"k": 0.1}, False),
                                                ({"k": 0.3}, True)])
    assert timing.kernel_device_ms(lambda: None, ("k",), warmup=0) == (0.3, "profiler")
    assert len(given) == 3


def test_kernel_device_ms_falls_back_to_events_around_each_call(monkeypatch):
    given = _stub_kernel_sessions(monkeypatch, [({"k": 0.1}, False)] * 3)
    assert timing.kernel_device_ms(lambda: None, ("k",), cold=True,
                                   warmup=0) == (7.0, "cuda_events")
    assert given == ["flush"] * 3


def test_kernel_device_ms_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device is required"):
        timing.kernel_device_ms(lambda: None, ("k",))
