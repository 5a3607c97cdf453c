"""Profiling hooks on torch.profiler — port of
color_transfer_tpu/utils/profiling.py.

``trace(log_dir)`` records the block (a train step, an evaluation, one
kernel) on the host and the card and writes a Chrome-trace JSON under
``log_dir`` that Perfetto (ui.perfetto.dev) and TensorBoard's profiler
plugin read; ``annotate(name)`` names a span inside it
(``torch.profiler.record_function``).

    with profiling.trace("runs/prof"):
        module.train_step(state, batch, seed)

    with profiling.annotate("parallax-attention"):
        out = row_attention(...)

The Trainer takes ``profile_dir`` and traces steps ``profile_steps`` (10 to
15 by default) of a ``fit``. The JAX package's ``start_server`` (JAX's
remote profiler endpoint) has no torch counterpart.
"""

import contextlib
import os
import socket
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir):
    """Profile the block (the CPU, and the card when there is one); its
    trace is written to ``log_dir`` on exit under TensorBoard's plugin
    layout, ``<host>.<pid>.<ms>.pt.trace.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    name = f"{socket.gethostname()}.{os.getpid()}.{time.time_ns() // 1_000_000}.pt.trace.json"
    prof.export_chrome_trace(str(Path(log_dir) / name))


def annotate(name):
    return torch.profiler.record_function(name)
