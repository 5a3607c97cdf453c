"""Device idle ms a training step on rank 0 while the host was inside an
all-reduce (the spans ``dp.allreduce.*`` of ``parallel/data_parallel.py``
and ``parallel/mesh.py``, on any thread): the gaps in the union of the
window's device intervals under them, over the steps."""

from benchmark import program_trace


def read(run):
    ms = program_trace.idle_ms(run, "dp.allreduce.")
    return None if ms is None else ms / run.units
