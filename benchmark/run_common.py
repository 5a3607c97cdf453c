"""What a run of a cell hands back, and the device helpers the runs share."""

from dataclasses import dataclass, field

import torch


@dataclass
class Outcome:
    """One run of a cell: the window's counts and host-clock readings
    (``e2e``), the numbers compared with the reference (``numbers``), and,
    in a traced run, the spans (summed ms), their calls' shapes and the
    device trace's digest."""

    attempted: int
    failed: int
    units: int
    window_s: float
    setup_s: float
    peak_bytes: int
    numbers: dict
    e2e: dict
    spans: dict = None
    span_shapes: dict = None
    digest: dict = None
    notes: list = field(default_factory=list)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device):
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def free(device):
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def set_up(marks):
    """'set-up: <phase> <s>, ...' from [(phase, perf_counter at its end)]."""
    return "set-up: " + ", ".join(f"{name} {end - start:.2f} s"
                                  for (_, start), (name, end) in zip(marks, marks[1:]))
