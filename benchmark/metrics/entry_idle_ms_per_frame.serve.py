"""Device idle ms a frame while the host was inside the port's video entry
(``methods/video.py``: the span ``video.call``, the whole of
``color_transfer_between_videos``): the gaps in the union of the window's
device intervals under its host intervals, over the frames served. The rest
of ``device_idle_pct.serve`` is the caller's (the copy out, the loop)."""

from benchmark import program_trace


def read(run):
    ms = program_trace.idle_ms(run, "video.call")
    return None if ms is None else ms / run.units
