"""Device time by the program's spans (``portbench/spans.py``) on
fabricated profiler events: attribution on the launching thread, the
entry thread's spans for a launch on autograd's device thread, the
forward's model and operator spans below ``gwen.backward`` by sequence
number, ``unattributed`` time and the 2 % rule, the idle gaps by span and
by harness range, and each request's idle time. Each new metric's file
loads by name and reads nothing on a run without spans."""

import pytest

import torch

from portbench import harness, spans, tap, trace
from portbench.harness import ROOT, Run
from portbench.spec import Spec
from portbench.spans import Linked as Event
from portbench.window import Window

MAIN, AUTOGRAD = 1, 2
NEW_METRICS = ["forward_ms.train", "backward_ms.train", "optimizer_ms.train",
               "glue_pct.train", "glue_pct.ensemble", "request_idle_ms",
               "kernel_load_s"]


def span(name, lo, hi, tid=MAIN, corr=0):
    return Event(name, False, True, lo, hi, tid, corr)


def op(name, lo, hi, corr, tid=MAIN, seq=-1, fwd_tid=0):
    return Event(name, False, False, lo, hi, tid, corr, 0, seq, fwd_tid)


def kernel(lo, hi, linked, name="k", corr=0):
    return Event(name, True, False, lo, hi, 0, corr, linked)


def launch(lo, corr, linked):
    """A runtime call: its own correlation id, linked to its operator."""
    return Event("cudaLaunchKernel", False, False, lo, lo + 2, 99, corr, linked)


def train_step_events():
    """One step: forward on the main thread, backward on autograd's."""
    return [
        span("window", 0, 2000),
        span("train_step", 50, 1500),
        span("gwen.train_step", 100, 1400),
        span("gwen.forward", 110, 400),
        span("gwen.process", 120, 390),
        span("gwen.op.linear", 130, 150),
        op("aten::mm", 135, 145, corr=10, seq=8),
        op("aten::relu", 160, 170, corr=11, seq=7),
        span("gwen.op.aggregate", 180, 220),
        op("_SymmetricAggregation", 185, 215, corr=12, seq=9),
        span("gwen.backward", 400, 1300),
        op("autograd::engine::evaluate_function: ReluBackward0", 420, 480, 13,
           AUTOGRAD, seq=7, fwd_tid=MAIN),
        op("aten::threshold_backward", 430, 440, corr=20, tid=AUTOGRAD),
        op("MmBackward0", 490, 560, 14, AUTOGRAD, seq=8, fwd_tid=MAIN),
        op("aten::mm", 495, 505, corr=21, tid=AUTOGRAD),
        # the node opens before the span its backward opens; a kernel
        # launched from it links to the node, at its runtime call's time
        op("_SymmetricAggregationBackward", 590, 710, 15, AUTOGRAD, seq=9, fwd_tid=MAIN),
        span("gwen.op.aggregate.bwd", 600, 700, tid=AUTOGRAD),
        op("aten::copy_", 610, 620, corr=22, tid=AUTOGRAD),
        launch(650, corr=901, linked=15),
        span("gwen.optimizer", 1300, 1400),
        op("aten::_foreach_add_", 1310, 1320, corr=23),
        op("cudaLaunchKernel", 136, 140, corr=10),  # a runtime call: not an op
        # the profiler's own records, their ids of the runtime's kind equal
        # to an operator's: on no thread of the program's, not an op; on
        # the main thread, not the one whose interval holds the launch
        op("Command Buffer Full", 150, 160, corr=11, tid=31337),
        op("Command Buffer Full", 1700, 1710, corr=11),
        launch(165, corr=902, linked=11),
        kernel(200, 260, 10, "gemm"),
        kernel(270, 300, 11, "relu", corr=902),
        kernel(300, 340, 12, "dense_rows_kernel"),
        kernel(500, 520, 20, "relu_grad"),
        kernel(530, 570, 21, "gemm_bwd"),
        kernel(700, 800, 22, "dense_rows_kernel"),
        kernel(810, 830, 15, "dense_rows_kernel", corr=901),
        kernel(1350, 1360, 23, "adam"),
        Event("gwen.forward", True, True, 200, 400),  # device-side range: left out
    ]


def path(*names):
    return tuple("gwen." + n for n in names)


def test_attribution_by_thread_entry_and_sequence_number():
    sp = spans.attribute(train_step_events(), {"window", "train_step"})
    ns = 1e-9
    assert sp.by_path == pytest.approx({
        # on the launching thread
        path("train_step", "forward", "process", "op.linear"): 60 * ns,
        path("train_step", "forward", "process"): 30 * ns,
        path("train_step", "forward", "process", "op.aggregate"): 40 * ns,
        # autograd's thread: the entry thread's spans, then the forward's
        path("train_step", "backward", "process"): 20 * ns,
        path("train_step", "backward", "process", "op.linear"): 40 * ns,
        path("train_step", "backward", "process", "op.aggregate",
             "op.aggregate.bwd"): 120 * ns,
        path("train_step", "optimizer"): 10 * ns,
    })
    assert sp.unattributed_s == 0 and sp.device_s == pytest.approx(320 * ns)
    assert sp.opened["gwen.train_step"] == 1 and sp.opened["gwen.process"] == 1
    assert sp.glue(("gwen.forward", "gwen.backward")) == pytest.approx(50 * ns)
    assert spans.per_step_ms(sp, "gwen.backward") == pytest.approx(180e-6)
    assert spans.per_step_ms(sp, "gwen.optimizer") == pytest.approx(10e-6)
    assert spans.glue_pct(sp, ("gwen.forward", "gwen.backward")) == pytest.approx(
        100 * 50 / 310)
    top = {name: (count, ms) for name, count, ms in sp.layers()}
    assert top["gwen.op.aggregate.bwd"] == (1, pytest.approx(120e-6))
    assert top["gwen.op.linear"] == (1, pytest.approx(100e-6))


def test_idle_gaps_by_innermost_span_or_harness_range():
    sp = spans.attribute(train_step_events(), {"window", "train_step"})
    ns = 1e-9
    # gaps by midpoint on the main thread: 0-200 (100: gwen.train_step
    # opens), 260-270 (gwen.process), 340-500, 520-530, 570-700 and
    # 800-810, 830-1350 (gwen.backward; autograd's thread is not looked
    # at), 1360-2000 (no span, no harness range)
    assert sp.idle_by_span == pytest.approx({
        "gwen.train_step": 200 * ns, "gwen.process": 10 * ns,
        "gwen.backward": (160 + 10 + 130 + 10 + 520) * ns, "harness": 640 * ns,
    })
    events = train_step_events() + [span("sync", 1500, 2000)]
    sp = spans.attribute(events, {"window", "train_step", "sync"})
    assert sp.idle_by_span["sync"] == pytest.approx(640 * ns)


def test_unattributed_and_the_two_percent_rule():
    base = train_step_events()
    # no launch: 5 ns of 325 is 1.5 %: the glue share still reads
    few = base + [kernel(1700, 1705, 0)]
    sp = spans.attribute(few, {"window"})
    assert sp.unattributed_s == pytest.approx(5e-9)
    assert sp.unattributed_by == {"no launch": pytest.approx(5e-9)}
    assert spans.glue_pct(sp, ("gwen.forward", "gwen.backward")) is not None
    # an op launched outside every program span: 20 ns more, over 2 %
    many = few + [op("aten::randn", 1600, 1610, corr=40), kernel(1800, 1820, 40)]
    sp = spans.attribute(many, {"window"})
    assert sp.unattributed_by["aten::randn"] == pytest.approx(20e-9)
    assert sp.unattributed_share() > spans.MAX_UNATTRIBUTED
    assert spans.glue_pct(sp, ("gwen.forward", "gwen.backward")) is None
    assert spans.UNATTRIBUTED in {row[0] for row in sp.layers()}


def test_request_idle_from_the_span_start_to_its_last_kernel():
    events = [span("window", 0, 1000)]
    for i, lo in enumerate((100, 500)):
        events += [span("gwen.ensemble", lo, lo + 200),
                   span("gwen.lead_step", lo + 10, lo + 190),
                   op("aten::mm", lo + 20, lo + 30, corr=10 + 2 * i),
                   op("aten::add", lo + 40, lo + 50, corr=11 + 2 * i),
                   kernel(lo + 60, lo + 100, 10 + 2 * i),
                   kernel(lo + 150, lo + 300, 11 + 2 * i)]
    sp = spans.attribute(events, {"window"})
    # each request: 60 ns before its first kernel, 50 ns between its two
    assert sp.request_idle_s == pytest.approx([110e-9, 110e-9])
    assert spans.request_idle_ms(sp) == pytest.approx(110e-6)
    assert sp.idle_by_span["gwen.lead_step"] == pytest.approx(2 * 50e-9)
    assert spans.glue_pct(sp, ("gwen.ensemble",)) == pytest.approx(100.0)


def test_no_window_reads_nothing():
    sp = spans.attribute([kernel(0, 10, 0)], set())
    assert sp.device_s == 0 and not sp.by_path


@pytest.fixture
def untapped(monkeypatch):
    """The harness's own ``capture`` and ``reduce`` back after the test."""
    monkeypatch.setattr(harness, "capture", harness.capture)
    monkeypatch.setattr(harness, "reduce", harness.reduce)


@pytest.mark.parametrize("metric", NEW_METRICS)
def test_new_metric_files_read_nothing_without_spans(untapped, metric):
    reader = Spec.load(ROOT).reader(metric)
    assert getattr(harness.reduce, "tapped", False)
    run = Run("cell", {}, {}, Window(1.0, 1, 0), [], 1.0, 0)
    assert reader.read(run) is None
    run.trace = trace.Trace()  # a window the tap did not keep
    assert reader.read(run) is None


def test_the_tap_keeps_the_window_the_harness_reduced(untapped):
    from gwen_tpu_torch import ops, profiling

    own = harness.reduce
    tap.install()
    tap.install()
    assert harness.reduce.__closure__[0].cell_contents is own  # wrapped once
    x = torch.ones(4, 4)
    for _ in range(2):  # the harness keeps the last window: so does the tap
        with harness.capture(torch.device("cpu")) as cap:
            with torch.profiler.record_function(trace.WINDOW_RANGE):
                with profiling.annotate("gwen.train_step"):
                    with profiling.annotate("gwen.op.linear"):
                        x = x @ x
        tr = harness.reduce(cap.events, {"window"})
    assert all(isinstance(e, Event) for e in cap.events)
    assert {e.tid for e in cap.events if e.name == "gwen.train_step"} != {0}
    # what the harness's reduce made of the events it saw before the tap
    plain = [trace.Event(*e[:5]) for e in cap.events]
    assert tr == own(plain, {"window"})
    run = Run("cell", {}, {}, Window(1.0, 1, 0), [], 1.0, 0, trace=tr)
    sp = tap.span_trace(run)
    assert sp.opened == {"gwen.train_step": 1, "gwen.op.linear": 1}
    assert tap.span_trace(run) is sp
    assert tap.kernel_loads(run) == ops.kernel_loads()
    assert tap.kernel_loads(Run("cell", {}, {}, Window(1.0, 1, 0), [], 1.0, 0,
                                trace=trace.Trace())) is None
