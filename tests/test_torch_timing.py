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
