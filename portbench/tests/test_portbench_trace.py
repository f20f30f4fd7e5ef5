"""The trace reduction (busy time as the union of device intervals, idle
gaps named by the harness's host range) and the trace's integrity check:
a window whose trace holds fewer launches than its work must contain is
profiled again, and a second short trace fails the run."""

import pytest

from portbench import harness
from portbench.roofline import Op
from portbench.trace import Capture, Event, Trace, reduce
from portbench.window import Window


def Ev(name, dev, lo, hi, ann=False):
    return Event(name, dev, ann, lo, hi)


CPU, GPU = False, True


def test_reduce():
    events = [
        Ev("window", CPU, 0, 1000, True),
        Ev("train_step", CPU, 0, 600, True),
        Ev("Optimizer.step#Adam.step", CPU, 500, 590, True),  # not the harness's
        Ev("sync", CPU, 600, 1000, True),
        Ev("Optimizer.step#Adam.step", GPU, 100, 900, True),  # annotation: left out
        Ev("void dense_rows_kernel<1>", GPU, 100, 300),
        Ev("void dense_rows_kernel<1>", GPU, 250, 400),  # overlaps: counted once
        Ev("ln_fwd", GPU, 550, 700),
        Ev("aten::mm", CPU, 10, 20),
    ]
    tr = reduce(events, {"train_step", "sync"})
    assert tr.busy_s == pytest.approx((300 + 150) / 1e9)
    assert tr.span_s == pytest.approx(1e-6)
    assert tr.kernels["void dense_rows_kernel<1>"] == [2, pytest.approx(350e-9)]
    assert tr.launches(("dense_rows_kernel",)) == 2 and tr.launches(("ln_bwd",)) == 0
    # gaps: 0-100 and 400-550 in train_step, 700-1000 in sync
    assert tr.idle_by_range == {"train_step": pytest.approx(250e-9),
                                "sync": pytest.approx(300e-9)}
    assert tr.top_idle()[0][0] == "sync"


def test_no_window_range_reads_nothing():
    tr = reduce([Ev("ln_fwd", GPU, 0, 10)], set())
    assert tr.span_s == 0 and tr.busy_s == 0


class FakeDriver:
    def __init__(self, launches):
        self.launches, self.calls = launches, 0

    def window(self, seconds, rec):
        self.calls += 1
        return Window(1.0, 1, 0, [{"samples": 1}])

    def ops(self, win):
        return [Op("agg", 1.0, 1.0)] * 8 + [Op("matmul", 1.0, 0.0)]


def fake_capture(driver):
    def capture(device):
        class Ctx:
            def __enter__(self):
                return Capture()

            def __exit__(self, *exc):
                return False
        return Ctx()
    return capture


@pytest.mark.parametrize("launches,calls", [((8, 8), 1), ((3, 8), 2), ((3, 3), None)])
def test_short_trace_is_profiled_again(monkeypatch, launches, calls):
    driver = FakeDriver(launches)
    seen = iter(launches)
    monkeypatch.setattr(harness, "capture", fake_capture(driver))
    monkeypatch.setattr(harness, "reduce", lambda ev, names: Trace(
        kernels={"dense_rows_kernel": [next(seen), 1.0]}, busy_s=0.5, span_s=1.0))
    notes = []
    args = (driver, 1.0, None, harness.expected_launches(driver),
            {"agg": ("dense_rows_kernel",)}, notes)
    if calls is None:
        with pytest.raises(harness.TraceShort):
            harness._traced_window(*args)
        assert driver.calls == 2
    else:
        harness._traced_window(*args)
        assert driver.calls == calls
        assert sum(n.startswith("trace short") for n in notes) == calls - 1
