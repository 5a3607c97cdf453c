"""Port parity: profiling (color_transfer_tpu_torch/utils/profiling.py) and
the Trainer's ``profile_dir`` / ``profile_steps`` and best-PSNR-gated image
panels (run/trainer.py) against color_transfer_tpu's Trainer, on the CPU;
and the port's span and counter recorder on its own (off, on, threads, the
buffer's bound, the clock it shares with torch.profiler, the counters).

A tiny DCMCS3DI (1 + 1 ResB blocks, 8 channels) fits tests/test_cli.py's
set for 3 epochs of 3 steps in both packages. The gate compares PSNRs that
random init and the two packages' random streams make differ, so both
sides' train steps and validations report one scripted PSNR an epoch;
the panels must then land at the same steps under the same names.
"""

import collections
import json
import sys
import threading

import pytest
import torch

from color_transfer_tpu.run import datamodule as jdm
from color_transfer_tpu.run import modules as jmodules
from color_transfer_tpu.run import trainer as jtrainer
from color_transfer_tpu_torch.run import modules, trainer
from color_transfer_tpu_torch.run.datamodule import DataModule
from color_transfer_tpu_torch.utils import profiling
from test_cli import _make_data
from test_torch_port_core import one_torch_thread  # noqa: F401  (an autouse fixture)

SMALL = dict(extraction_layers=1, transfer_layers=1, channels=8, heavy_metrics=False)
DATA = dict(crop_size=(16, 24), image_repeats=2, batch_size=2, num_workers=2)
STEPS, EPOCHS = 3, 3
TRAIN_PSNR, VAL_PSNR = (20.0, 19.0, 21.0), (10.0, 12.0, 11.0)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return _make_data(tmp_path_factory.mktemp("prof"))


@pytest.fixture
def recorder():
    """The recorder off and empty before and after the test."""
    profiling.disable()
    profiling.clear()
    yield profiling
    profiling.disable()
    profiling.clear()


def test_off_spans_are_one_shared_null_context(recorder, monkeypatch):
    def refuse(name):
        raise AssertionError("record_function reached with the recorder off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first = profiling.annotate("video.call", unit=3)
    assert all(profiling.annotate(n) is first for n in ("a", "b", "train.step"))
    with first:
        with profiling.annotate("inner"):
            pass
    assert profiling.records() == []


def test_on_spans_nest_with_parents_and_units(recorder):
    profiling.enable()
    with profiling.annotate("root", unit=7) as root:
        with profiling.annotate("child") as child:
            with profiling.annotate("grandchild") as grand:
                pass
        with profiling.annotate("sibling", unit=9) as sibling:
            pass
    with profiling.annotate("no unit") as loose:
        pass
    recs = profiling.records()
    assert [r.name for r in recs] == ["root", "child", "grandchild", "sibling", "no unit"]
    assert root.parent is None and child.parent == root.id and grand.parent == child.id
    assert sibling.parent == root.id and loose.parent is None
    assert (root.unit, child.unit, grand.unit, sibling.unit, loose.unit) == (7, 7, 7, 9, None)
    assert root.start_ns <= child.start_ns <= grand.start_ns <= grand.end_ns <= child.end_ns
    assert sibling.end_ns <= root.end_ns and len({r.thread for r in recs}) == 1
    assert all(r.device_ms is None for r in recs)  # no card


def test_threads_keep_their_own_stacks(recorder):
    """Two threads' spans nest on their own stacks; a thread with no span
    open takes the unit of the root span open elsewhere (autograd's
    backward thread on a card)."""
    profiling.enable()
    gate = threading.Barrier(2, timeout=30)

    def work(tag):
        with profiling.annotate(f"{tag}.outer", unit=tag):
            gate.wait()
            with profiling.annotate(f"{tag}.inner"):
                gate.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    by_name = {r.name: r for r in profiling.records()}
    for tag in ("a", "b"):
        outer, inner = by_name[f"{tag}.outer"], by_name[f"{tag}.inner"]
        assert inner.parent == outer.id and inner.thread == outer.thread
        assert inner.unit == outer.unit == tag
    assert by_name["a.outer"].thread != by_name["b.outer"].thread

    with profiling.annotate("train.step", unit=5):
        seen = []

        def backward():
            with profiling.annotate("backward op") as rec:
                seen.append(rec)

        worker = threading.Thread(target=backward)
        worker.start()
        worker.join(timeout=30)
    assert not worker.is_alive() and seen[0].parent is None and seen[0].unit == 5


def test_spans_take_an_event_pair_on_a_card(recorder, monkeypatch):
    """With the card in use a span records a CUDA event pair, read once by
    ``records()``; ``device=False`` (a collective's span) records none."""
    made = []

    class FakeEvent:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.t, self.waited = None, False
            made.append(self)

        def record(self):
            self.t = len(made)

        def synchronize(self):
            self.waited = True

        def elapsed_time(self, end):
            assert end.waited
            return float(end.t - self.t)

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    profiling.enable()
    with profiling.annotate("timed"):
        with profiling.annotate("dp.allreduce.logs", device=False):
            pass
    assert len(made) == 2
    by_name = {r.name: r for r in profiling.records()}
    assert by_name["timed"].device_ms == 1.0 and by_name["dp.allreduce.logs"].device_ms is None
    assert by_name["timed"]._events is None  # read once: the record holds no events now


def test_buffer_keeps_the_newest_and_clear_empties_it(recorder, monkeypatch):
    monkeypatch.setattr(profiling, "_buffer", collections.deque(maxlen=8))
    profiling.enable()
    for i in range(20):
        with profiling.annotate(f"s{i}"):
            pass
    assert [r.name for r in profiling.records()] == [f"s{i}" for i in range(12, 20)]
    profiling.clear()
    assert profiling.records() == []
    profiling.disable()
    with profiling.annotate("off"):
        pass
    assert profiling.records() == []


def test_spans_share_the_profiler_clock(recorder, tmp_path):
    """Inside ``trace`` every span is also a profiler range, and the span's
    host stamps (time.time_ns) bracket the profiler's own event of it."""
    with profiling.trace(tmp_path / "prof") as prof:
        for i in range(12):
            with profiling.annotate(f"clock {i % 3}"):
                torch.ones(32, 32) @ torch.ones(32, 32)
    assert not profiling._on  # back off after the trace
    spans = sorted((r.start_ns, r.end_ns, r.name) for r in profiling.records())
    events = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("clock "))
    assert len(spans) == len(events) == 12
    for (s0, s1, name), (e0, e1, ev_name) in zip(spans, events):
        assert name == ev_name and s0 <= e0 <= e1 <= s1


def test_counters_total_and_land_on_the_open_span(recorder):
    before = profiling.counter("test.counted")
    profiling.count("test.counted")
    profiling.count("test.counted", 4)
    assert profiling.counter("test.counted") == before + 5
    assert profiling.counter("test.never counted") == 0
    profiling.enable()
    with profiling.annotate("outer") as outer:
        profiling.count("test.counted")
        with profiling.annotate("inner") as inner:
            profiling.count("test.counted", 2)
            profiling.count("test.other")
    assert outer.counts == {"test.counted": 1}
    assert inner.counts == {"test.counted": 2, "test.other": 1}
    assert profiling.counter("test.counted") == before + 8


def test_counters_lose_no_update_across_threads(recorder):
    """More threads than cores count one name with a short switch interval."""
    threads, per = 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = profiling.counter("test.threads")
        workers = [threading.Thread(target=lambda: [profiling.count("test.threads")
                                                    for _ in range(per)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert profiling.counter("test.threads") == before + threads * per


def test_trace_and_annotate(tmp_path):
    with profiling.trace(tmp_path / "prof"):
        with profiling.annotate("span under test"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    (path,) = (tmp_path / "prof").glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "span under test" in names and "aten::mm" in names


def _scripted(monkeypatch, train_cls, trainer_cls, port):
    """Train steps report TRAIN_PSNR[epoch]; validation VAL_PSNR[epoch]."""
    calls = {"steps": 0, "val": 0}
    orig = train_cls.train_step

    def train_step(self, *args, **kwargs):
        state, logs = orig(self, *args, **kwargs)
        epoch = calls["steps"] // STEPS
        calls["steps"] += 1
        if not port or "Training PSNR" in logs:
            logs = {**logs, "Training PSNR": TRAIN_PSNR[epoch]}
        return state, logs

    def validate(self, module, datamodule, state, step, max_batches=None):
        calls["val"] += 1
        return {"Validation PSNR/dataloader_idx_0": VAL_PSNR[calls["val"] - 1]}

    monkeypatch.setattr(train_cls, "train_step", train_step)
    monkeypatch.setattr(trainer_cls, "validate", validate)


def _images(log_dir):
    assert not (log_dir / "image_log_error.txt").exists()
    return sorted(p.name for p in (log_dir / "images").glob("*.png"))


def test_panels_land_where_jax_writes_them(data_root, tmp_path, monkeypatch):
    _scripted(monkeypatch, jmodules.DCMCS3DIModule, jtrainer.Trainer, port=False)
    _scripted(monkeypatch, modules.DCMCS3DIModule, trainer.Trainer, port=True)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jtrainer.Trainer(max_epochs=EPOCHS, log_dir=jax_dir, log_every=100).fit(
        jmodules.DCMCS3DIModule(**SMALL), jdm.DataModule(data_root, **DATA))
    trainer.Trainer(max_epochs=EPOCHS, log_dir=port_dir, log_every=100, device="cpu").fit(
        modules.DCMCS3DIModule(**SMALL), DataModule(data_root, **DATA))
    want = _images(jax_dir)
    # Training panels after epochs 0 and 2 (steps 3, 9); validation after 0, 1.
    steps = sorted({int(n.rsplit("_", 2)[-2]) for n in want})
    assert steps == [3, 6, 9] and len(want) == 4 * 6
    assert _images(port_dir) == want


def test_panel_error_does_not_stop_the_run(data_root, tmp_path, monkeypatch):
    def broken(self, state, batch):
        raise RuntimeError("no panel")

    monkeypatch.setattr(modules.DCMCS3DIModule, "image_panels", broken)
    state = trainer.Trainer(max_epochs=1, log_dir=tmp_path, log_every=100, device="cpu").fit(
        modules.DCMCS3DIModule(**SMALL), DataModule(data_root, **DATA))
    assert state.step == STEPS
    assert "no panel" in (tmp_path / "image_log_error.txt").read_text()
    records = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert any(r.get("image_log_error") == 1.0 for r in records)


@pytest.mark.parametrize("profile_steps,traced", [((1, 3), [1, 2, 3]), ((7, 20), [7, 8])])
def test_fit_profiles_its_steps(data_root, tmp_path, monkeypatch, profile_steps, traced):
    """``profile_dir``: steps profile_steps[0] to profile_steps[1] traced
    (a fit that ends first closes the trace at its end)."""
    seen = []
    orig = modules.DCMCS3DIModule.train_step

    def train_step(self, state, batch, seed, metrics=True):
        with profiling.annotate(f"step {state.step}"):
            seen.append(state.step)
            return orig(self, state, batch, seed, metrics)

    monkeypatch.setattr(modules.DCMCS3DIModule, "train_step", train_step)
    t = trainer.Trainer(max_epochs=EPOCHS, log_dir=tmp_path / "log", log_every=100,
                        device="cpu", profile_dir=tmp_path / "prof",
                        profile_steps=profile_steps)
    t.fit(modules.DCMCS3DIModule(**SMALL), DataModule(data_root, **DATA))
    assert seen == list(range(STEPS * EPOCHS))
    (path,) = (tmp_path / "prof").glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert sorted(int(n.split()[1]) for n in names if n and n.startswith("step ")) == traced
    assert "aten::convolution" in names


def test_trainer_takes_jax_profile_defaults(tmp_path):
    t = trainer.Trainer(log_dir=tmp_path, device="cpu")
    j = jtrainer.Trainer.__init__.__defaults__
    assert t.profile_dir is None and t.profile_steps == (10, 15) == j[-1]
