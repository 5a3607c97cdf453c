"""The port's own spans (``color_transfer_tpu_torch/utils/profiling.py``)
laid over a traced run's device trace.

Importing this module turns the port's recorder on. The per-layer metrics
that read the port's spans import it, and a run imports its metrics'
readers only with ``--trace 1``, in every rank, before set-up, so the
untraced runs that decide the end-to-end metrics run with the recorder off.

The recorder stamps a span's host start and end with ``time.time_ns()``;
torch.profiler stamps its device events on the same clock (in us in
``run.digest["device_events"]``). A run's view (``run.RunView``) carries the
records, taken once the run has ended; a reader reads the window's: those
whose host interval overlaps [first start, last end] of the window's device
events, which leaves out set-up's spans and those of the labelling pass
after the window. Two readings of them:

  * ``device_ms``: a span's device ms (its CUDA event pair), summed;
  * ``idle_ms``: the device's idle time (the gaps in the union of the
    device intervals, ``benchmark.trace._union``) while the host was inside
    a span whose name starts with a prefix, on any thread, its children
    included;

and ``calls_per_unit`` counts spans by the unit they carry (a train step's
``state.step``, inherited on autograd's thread too), so a step whose last
spans fall after the device trace's last event still counts whole.

``idle_by_span`` puts each stretch of idle time down to the innermost span
open on the host at that moment (the latest started, on any thread: a span
of autograd's backward thread lies inside ``train.backward``), and to
"caller" where none was. A program without the recorder gives no records,
and every reading is None.
"""

from benchmark.trace import _union

try:
    from color_transfer_tpu_torch.utils import profiling as _profiling
except ImportError:  # the port is not importable here
    _profiling = None

CALLER = "caller"  # idle time under no span of the port


def _no_records():
    return []


if _profiling is not None and hasattr(_profiling, "records"):
    _profiling.enable()
    records = _profiling.records
else:  # a program that has no recorder
    records = _no_records


def window(recs, device_events):
    """The records whose host interval overlaps [first start, last end] of
    the device events (us)."""
    if not device_events:
        return []
    lo = min(s for _, s, _ in device_events)
    hi = max(e for _, _, e in device_events)
    return [r for r in recs if r.end_ns / 1e3 > lo and r.start_ns / 1e3 < hi]


def snapshot(run):
    """The run's records inside its window."""
    return window(run.records, run.digest["device_events"])


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_under(recs, device_events, prefix):
    """Device idle ms while the host was inside a record whose name starts
    with ``prefix`` -> None where there is no such record."""
    spans = _merged((r.start_ns / 1e3, r.end_ns / 1e3) for r in recs
                    if r.name.startswith(prefix))
    if not spans or not device_events:
        return None
    gaps = _union(device_events, 0.0)[1]
    total, j = 0.0, 0
    for gs, ge in gaps:
        while j < len(spans) and spans[j][1] <= gs:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < ge:
            total += min(ge, spans[k][1]) - max(gs, spans[k][0])
            k += 1
    return total / 1e3


def idle_by_span(recs, device_events):
    """{span name or CALLER: device idle ms} over the device events' gaps,
    each stretch put down to the innermost record open then."""
    gaps = _union(device_events, 0.0)[1]
    marks = []  # (time us, order, kind, record): ends before starts at one time
    for r in recs:
        marks.append((r.start_ns / 1e3, 1, "start", r))
        marks.append((r.end_ns / 1e3, 0, "end", r))
    for gs, ge in gaps:
        marks.append((gs, 1, "gap", None))
        marks.append((ge, 0, "gap end", None))
    marks.sort(key=lambda m: (m[0], m[1]))
    out, open_, in_gap, last = {}, {}, 0, None
    for t, _, kind, rec in marks:
        if in_gap and last is not None and t > last:
            inner = max(open_.values(), key=lambda r: (r.start_ns, r.id), default=None)
            name = inner.name if inner is not None else CALLER
            out[name] = out.get(name, 0.0) + (t - last) / 1e3
        last = t
        if kind == "start":
            open_[rec.id] = rec
        elif kind == "end":
            open_.pop(rec.id, None)
        else:
            in_gap += 1 if kind == "gap" else -1
    return out


def device_ms(run, name):
    """The summed device ms of the window's spans named ``name``; None
    where there is none (or no card)."""
    ms = [r.device_ms for r in snapshot(run) if r.name == name and r.device_ms is not None]
    return sum(ms) if ms else None


def idle_ms(run, prefix):
    return idle_under(snapshot(run), run.digest["device_events"], prefix)


def calls_per_unit(run, prefix, root):
    """The spans whose name starts with ``prefix`` a unit (a train step):
    every such span of the units whose ``root`` span lies in the window,
    over those units; the window's edges cut no unit's spans. None where
    there is none."""
    units = {r.unit for r in snapshot(run) if r.name == root}
    n = sum(r.name.startswith(prefix) and r.unit in units for r in run.records)
    return n / len(units) if n else None
