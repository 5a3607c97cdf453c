"""All-reduces a training step on rank 0 (``parallel/data_parallel.py`` and
``parallel/mesh.py``: the spans ``dp.allreduce.moments`` (BatchNorm's
global moments, forward and backward), ``.rank_mean``, ``.grads`` (one a
gradient bucket) and ``.logs``), counted by the step (``train.step``'s
unit) over the window's steps. A count, the same in every run: the model's
structure fixes it."""

from benchmark import program_trace


def read(run):
    return program_trace.calls_per_unit(run, "dp.allreduce.", "train.step")
