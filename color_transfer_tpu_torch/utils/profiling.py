"""The port's one span and counter recorder, and the Chrome trace of a
block — port of color_transfer_tpu/utils/profiling.py.

``annotate(name, unit=None)`` marks a span of the port's work. The recorder
is off unless ``enable()`` (or ``trace``) turns it on; off, a span is one
flag check that returns a shared null context. On, each span appends one
``Record`` to a buffer that keeps the newest ``LIMIT``: its name, its host
start and end from ``time.time_ns()`` (the clock torch.profiler stamps its
host and device events with, so a span lies over a device trace), its
thread, its parent (the innermost span open on the same thread), its unit
(a root span's ``unit``, inherited by its children and by the spans of
threads with no span open, such as autograd's backward thread on a card)
and, while the card is in use, a CUDA event pair on the current stream,
read once by ``records()`` (the collectives' spans take none: their work
runs on NCCL's stream).

    profiling.enable()
    with profiling.annotate("video.call", unit=i):
        ...
    spans = profiling.records()

``count(name, n=1)`` adds to a counter (always on, as cheap as an
attribute increment); with the recorder on the count is also kept on the
innermost open span, so counts can be cut to a window as spans are.
``counter(name)`` reads the total.

``trace(log_dir)`` records the block (a train step, an evaluation, one
kernel) on the host and the card and writes a Chrome-trace JSON under
``log_dir`` that Perfetto (ui.perfetto.dev) and TensorBoard's profiler
plugin read; inside it the recorder is on and each span is also a named
range of the trace (``torch.profiler.record_function``). The Trainer takes
``profile_dir`` and traces steps ``profile_steps`` (10 to 15 by default)
of a ``fit``. The JAX package's ``start_server`` (JAX's remote profiler
endpoint) has no torch counterpart.

The span names are fixed; the benchmark's per-layer metrics and the tests
read them: ``video.call`` (unit: the call's number), ``video.copy_in``,
``video.forward`` (methods/video.py); ``dmsct.matcher``, ``dmsct.correct``
(models/dmsct.py); ``gmflow.backbone``, ``gmflow.transformer``,
``gmflow.match``, ``gmflow.refine`` (models/gmflow.py); ``train.step``
(unit: the state's step), ``train.distort``, ``train.forward``,
``train.backward``, ``train.update``, ``train.logs`` (run/modules.py);
``dcmcs3di.extraction``, ``dcmcs3di.matcher`` (models/dcmcs3di.py);
``dp.allreduce.moments``, ``dp.allreduce.rank_mean``,
``dp.allreduce.grads``, ``dp.allreduce.logs`` (parallel/);
``test.data``, ``test.forward``, ``test.metrics`` (run/trainer.py).
"""

import collections
import contextlib
import itertools
import os
import socket
import threading
import time
from pathlib import Path

import torch

LIMIT = 2**20  # records kept: the newest

_NULL = contextlib.nullcontext()
_on = False
_ranges = False  # inside trace(): each span is also a record_function range
_lock = threading.Lock()
_buffer = collections.deque(maxlen=LIMIT)
_ids = itertools.count(1)
_local = threading.local()
_open_unit = None  # the unit of the root span open with a unit
_counts = {}


class Record:
    """One span: ``device_ms`` is None off the card, and until
    ``records()`` has read it."""

    __slots__ = ("id", "name", "start_ns", "end_ns", "thread", "parent", "unit",
                 "counts", "device_ms", "_events")

    def __repr__(self):
        return (f"Record({self.name!r}, id={self.id}, parent={self.parent}, "
                f"unit={self.unit}, {(self.end_ns - self.start_ns) / 1e3:.1f} us)")


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("record", "_range", "_unit_before", "_device")

    def __init__(self, name, unit, device):
        rec = self.record = Record()
        rec.name, rec.unit = name, unit
        self._device = device

    def __enter__(self):
        global _open_unit
        rec, stack = self.record, _stack()
        parent = stack[-1].record if stack else None
        rec.id, rec.thread = next(_ids), threading.get_ident()
        rec.parent = parent.id if parent is not None else None
        self._unit_before = _open_unit
        if rec.unit is None:
            rec.unit = parent.unit if parent is not None else _open_unit
        elif parent is None:
            _open_unit = rec.unit
        rec.counts, rec.device_ms, rec._events = None, None, None
        self._range = torch.profiler.record_function(rec.name) if _ranges else None
        rec.start_ns = time.time_ns()
        if self._range is not None:
            self._range.__enter__()
        if self._device and torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            rec._events = (start, None)
        stack.append(self)
        return rec

    def __exit__(self, *exc):
        global _open_unit
        rec = self.record
        _stack().pop()
        if rec._events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            rec._events = (rec._events[0], end)
        if self._range is not None:
            self._range.__exit__(*exc)
        rec.end_ns = time.time_ns()
        _open_unit = self._unit_before
        with _lock:
            _buffer.append(rec)
        return False


def annotate(name, unit=None, device=True):
    """A span named ``name`` around the block: the shared null context
    while the recorder is off. ``unit`` (a root span's: a served call's
    number, a train step's) goes to its children. ``device=False`` leaves
    out the CUDA event pair, for a span whose device work runs on another
    stream (an NCCL collective): the pair would time none of it, and it
    costs the host 0.13-0.19 ms under a device-activity profiler."""
    if not _on:
        return _NULL
    return _Span(name, unit, device)


def enable():
    """Turns the recorder on."""
    global _on
    _on = True


def disable():
    """Turns the recorder off; the records stay until ``clear()``."""
    global _on
    _on = False


def clear():
    """Empties the buffer of records."""
    with _lock:
        _buffer.clear()


def records():
    """A snapshot of the finished spans in order of their host start, each
    span's device ms read (waiting for its end event once)."""
    with _lock:
        snap = list(_buffer)
    for rec in snap:
        if rec._events is not None:
            start, end = rec._events
            end.synchronize()
            rec.device_ms = start.elapsed_time(end)
            rec._events = None
    return sorted(snap, key=lambda r: (r.start_ns, r.id))


def count(name, n=1):
    """Adds ``n`` to the counter ``name`` and, with the recorder on, to the
    innermost span open on this thread."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n
    if _on:
        stack = getattr(_local, "stack", None)
        if stack:
            rec = stack[-1].record
            if rec.counts is None:
                rec.counts = {}
            rec.counts[name] = rec.counts.get(name, 0) + n


def counter(name):
    """The counter's total in this process (0 before its first count)."""
    return _counts.get(name, 0)


@contextlib.contextmanager
def trace(log_dir):
    """Profile the block (the CPU, and the card when there is one), with
    the recorder on and every span a named range; the trace is written to
    ``log_dir`` on exit under TensorBoard's plugin layout,
    ``<host>.<pid>.<ms>.pt.trace.json``. Yields the profiler."""
    global _ranges
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    was_on = _on
    with torch.profiler.profile(activities=acts) as prof:
        enable()
        _ranges = True
        try:
            yield prof
        finally:
            _ranges = False
            if not was_on:
                disable()
    name = f"{socket.gethostname()}.{os.getpid()}.{time.time_ns() // 1_000_000}.pt.trace.json"
    prof.export_chrome_trace(str(Path(log_dir) / name))
