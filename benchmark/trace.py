"""Spans and the device trace of a ``--trace 1`` run.

Spans are recorded from the benchmark's own files, around the calls into the
measured program: a CUDA event pair around every call of a submodule
(forward hooks), of a method of the model, or of a function (a wrapper put
in the module's namespace), read after one synchronise at the end. A span
includes the host's enqueue gaps between its kernels. A function span also
keeps the shapes of its tensor arguments.

The device trace is one ``torch.profiler`` window over the whole measured
window that records the device's activity alone: the union of the device
intervals gives the busy time, and the kernels summed by name the
breakdown's device operations. Recording the host's operations too would
slow a host-bound step by half and with it the window's rate. The idle
gaps are labelled in a short pass after the window closes (``LABEL_UNITS``
more frames or steps), traced with the host's operations: each gap goes to
the host operation that overlapped it most."""

import importlib
from collections import defaultdict

import torch

LABEL_UNITS = 3  # frames or steps of the labelling pass after the window


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class Spans:
    """Records the spans the readers ask for: ``{name: (kind, target)}``
    where kind is "module" (a submodule path of the model), "method" (a
    method of the model) or "function" ((import path, attribute))."""

    def __init__(self, model, wanted):
        self.records = defaultdict(list)  # name -> [(start, end)]
        self.shapes = defaultdict(list)  # name -> [shapes of tensor arguments]
        self._undo = []
        for name, (kind, target) in wanted.items():
            if kind == "module":
                self._hook(model.get_submodule(target), name)
            elif kind == "method":
                self._wrap(model, target, name, instance=True)
            elif kind == "function":
                self._wrap(importlib.import_module(target[0]), target[1], name)
            else:
                raise ValueError(f"span {name}: unknown kind {kind!r}")

    def _hook(self, mod, name):
        started = []
        pre = mod.register_forward_pre_hook(lambda m, a: started.append(_event()))
        post = mod.register_forward_hook(
            lambda m, a, o: self.records[name].append((started.pop(), _event())))
        self._undo += [pre.remove, post.remove]

    def _wrap(self, owner, attr, name, instance=False):
        fn = getattr(owner, attr)

        def call(*args, **kwargs):
            self.shapes[name].append([tuple(a.shape) for a in args if torch.is_tensor(a)])
            start = _event()
            out = fn(*args, **kwargs)
            self.records[name].append((start, _event()))
            return out

        setattr(owner, attr, call)
        self._undo.append(lambda: delattr(owner, attr) if instance else setattr(owner, attr, fn))

    def close(self):
        """Removes the hooks and wrappers; returns {name: summed ms}."""
        for undo in reversed(self._undo):
            undo()
        torch.cuda.synchronize()
        return {name: sum(s.elapsed_time(e) for s, e in pairs)
                for name, pairs in self.records.items()}


def profiler(host_ops=False):
    """The device's activity; with ``host_ops`` the host's operations too."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    return profile(activities=activities)


def _events(prof):
    """(device, host) lists of (name, start_us, end_us) from the raw
    profiler results (no tree is built)."""
    device, host = [], []
    raw = prof.profiler.kineto_results.events()
    for e in raw:
        start = e.start_ns() / 1e3 if hasattr(e, "start_ns") else e.start_us()
        dur = e.duration_ns() / 1e3 if hasattr(e, "duration_ns") else e.duration_us()
        item = (e.name(), start, start + dur)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append(item)
        else:
            host.append(item)
    return device, host


def _union(device, min_gap_us):
    """(busy us, [(start, end) of each idle gap of ``min_gap_us`` or more])
    of the device intervals."""
    busy, reached, gaps = 0.0, None, []
    for s, e in sorted((s, e) for _, s, e in device):
        if reached is None or s >= reached:
            if reached is not None and s - reached >= min_gap_us:
                gaps.append((reached, s))
            busy += e - s
            reached = e
        elif e > reached:
            busy += e - reached
            reached = e
    return busy, gaps


def digest(prof, window_s, top=10):
    """The window's numbers: busy seconds (the union of the device
    intervals), the device events and the ``top`` device operations by
    summed time."""
    device, _ = _events(prof)
    if not device:
        raise RuntimeError("the profiler recorded no device activity")
    by_op = defaultdict(float)
    for name, s, e in device:
        by_op[name] += e - s
    return {
        "busy_s": _union(device, 0.0)[0] / 1e6,
        "window_s": window_s,
        "device_events": device,
        "device_ops": sorted(([n, t / 1e6] for n, t in by_op.items()), key=lambda x: -x[1])[:top],
    }


def idle_gaps(prof, top=10, min_gap_us=5.0):
    """The ``top`` host operations by the device's idle time they
    overlapped, from a trace that recorded the host's operations."""
    device, host = _events(prof)
    return _label_gaps(_union(device, min_gap_us)[1], host, top)


def _label_gaps(gaps, host, top):
    """Idle seconds summed by the host operation that overlapped each gap
    the most ("no host op" where none did)."""
    host = sorted(host, key=lambda x: x[1])
    by_label = defaultdict(float)
    active, i = [], 0
    for gs, ge in gaps:
        while i < len(host) and host[i][1] < ge:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[2] > gs]
        best, label = 0.0, "no host op"
        for name, s, e in active:
            overlap = min(e, ge) - max(s, gs)
            if overlap > best:
                best, label = overlap, name
        by_label[label] += (ge - gs) / 1e6
    return sorted(([n, t] for n, t in by_label.items()), key=lambda x: -x[1])[:top]
