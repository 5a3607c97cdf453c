"""``benchmark/program_trace.py`` and the readers of the port's own spans, on
synthetic records and device events: the window cut, idle time under a
prefix across threads, idle time no span covers, and readers that find
nothing."""

from types import SimpleNamespace

import pytest

from benchmark import cell as cell_mod
from benchmark import program_trace as pt

READERS = {  # metric -> the span names it reads
    "refine_ms_per_frame.serve": ["gmflow.refine"],
    "swin_ms_per_frame.serve": ["gmflow.transformer"],
    "entry_idle_ms_per_frame.serve": ["video.call"],
    "backward_ms_per_step.fit": ["train.backward"],
    "backward_idle_ms_per_step.fit": ["train.backward"],
    "allreduce_calls_per_step.fit_dp": ["dp.allreduce.moments", "dp.allreduce.grads"],
    "collective_idle_ms_per_step.fit_dp": ["dp.allreduce.moments", "dp.allreduce.logs"],
}


@pytest.fixture(autouse=True)
def fresh():
    """The recorder off again after each test."""
    yield
    if pt._profiling is not None and hasattr(pt._profiling, "disable"):
        pt._profiling.disable()


_ids = iter(range(1, 10**6))


def rec(name, start_us, end_us, thread=1, device_ms=None, unit=None):
    return SimpleNamespace(name=name, start_ns=int(start_us * 1e3), end_ns=int(end_us * 1e3),
                           thread=thread, id=next(_ids), device_ms=device_ms, unit=unit)


def dev(*intervals):
    return [("kernel", float(s), float(e)) for s, e in intervals]


def test_window_leaves_out_set_up_and_the_labelling_pass():
    events = dev((1000, 1500), (1600, 2000))
    recs = [rec("set-up", 100, 900), rec("first", 900, 1100), rec("inside", 1200, 1300),
            rec("last", 1900, 2100), rec("labelling", 2200, 2500), rec("touching", 2000, 2100)]
    assert [r.name for r in pt.window(recs, events)] == ["first", "inside", "last"]
    assert pt.window(recs, []) == []


def test_idle_under_a_prefix_across_threads():
    """``train.backward`` on the main thread; autograd's thread works inside
    its host interval with no parent of its own; a child on the main
    thread. Gaps: 150-250, 300-500, 1100-1300."""
    events = dev((0, 150), (250, 300), (500, 1100), (1300, 1400))
    recs = [rec("train.backward", 100, 900), rec("op.backward", 200, 400, thread=2),
            rec("train.backward.child", 420, 460)]
    assert pt.idle_under(recs, events, "train.backward") == pytest.approx(0.3)
    assert pt.idle_under(recs, events, "op.") == pytest.approx(0.15)
    assert pt.idle_under(recs, events, "dp.") is None
    by = pt.idle_by_span(recs, events)
    assert by == pytest.approx({"train.backward": 0.11,
                                "op.backward": 0.15, "train.backward.child": 0.04,
                                pt.CALLER: 0.2})


def test_a_gap_no_span_covers_goes_to_the_caller():
    events = dev((0, 100), (400, 500))
    recs = [rec("video.call", 0, 200)]
    assert pt.idle_by_span(recs, events) == pytest.approx({"video.call": 0.1, pt.CALLER: 0.2})
    assert pt.idle_under(recs, events, "video.call") == pytest.approx(0.1)


def _run(events, records, units=2):
    return SimpleNamespace(digest={"device_events": events, "busy_s": 0.0, "window_s": 1.0},
                           units=units, chips=1, window_s=1.0, spans={}, span_shapes={},
                           records=records)


def test_calls_count_whole_units():
    """Two steps in the window: the second's last all-reduce starts after
    the device trace's last event and still counts; set-up's step does not."""
    events = dev((0, 1000), (3000, 4000))
    recs = [rec("train.step", -900, -100, unit=0), rec("dp.allreduce.logs", -300, -200, unit=0),
            rec("train.step", 100, 2000, unit=1), rec("train.step", 2500, 4200, unit=2)]
    recs += [rec("dp.allreduce.moments", 200 + 10 * i, 205 + 10 * i, thread=1 + i % 2, unit=u)
             for u in (1, 2) for i in range(3)]
    recs += [rec("dp.allreduce.logs", 1900, 1950, unit=1),
             rec("dp.allreduce.logs", 4100, 4150, unit=2)]
    assert pt.calls_per_unit(_run(events, recs), "dp.allreduce.", "train.step") == 4.0


@pytest.mark.parametrize("metric", sorted(READERS))
def test_readers_read_the_port_s_spans(metric):
    reader = cell_mod.reader(metric)
    events = dev((0, 1000), (3000, 4000))
    recs = [rec(name, 500 + 100 * i, 3500, device_ms=6.0, unit=i % 2)
            for i, name in enumerate(READERS[metric])]
    recs += [rec("train.step", 400, 3600, unit=u) for u in (0, 1)]
    value = reader.read(_run(events, recs + [rec("set-up", -900, -100, device_ms=1.0)]))
    n = len(READERS[metric])
    want = {"ms": 6.0 * n / 2, "calls": n / 2, "idle": 2.0 / 2}  # 2 units a run
    kind = "calls" if "calls" in metric else "idle" if "idle" in metric else "ms"
    assert value == pytest.approx(want[kind])


@pytest.mark.parametrize("metric", sorted(READERS))
def test_readers_return_none_without_their_spans(metric):
    reader = cell_mod.reader(metric)
    events = dev((0, 1000), (3000, 4000))
    assert reader.read(_run(events, [rec("something.else", 500, 3500, device_ms=5.0)])) is None
    assert reader.read(_run(events, [])) is None  # a program without the recorder
