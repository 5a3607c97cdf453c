"""Device ms a frame of host-to-device and device-to-host copies
(``methods/video.py`` hands host frames in and the job copies each corrected
frame out): the profiler's memcpy intervals over the window, over the frames
served."""


def read(run):
    copies = [e - s for name, s, e in run.digest["device_events"]
              if name.startswith("Memcpy HtoD") or name.startswith("Memcpy DtoH")]
    if not copies:
        return None
    return sum(copies) / 1e3 / run.units
