"""Rank 0's device ms a training step in NCCL's kernels
(``parallel/data_parallel.py``: BatchNorm's global moments in the forward
and backward, the bucketed gradient average, the logs' average): the
profiler's ``nccl`` kernel intervals over the window, over its steps. A
kernel that waits for a slower rank counts its wait."""


def read(run):
    nccl = [e - s for name, s, e in run.digest["device_events"] if "nccl" in name.lower()]
    if not nccl:
        return None
    return sum(nccl) / 1e3 / run.units
