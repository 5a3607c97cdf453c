"""The ``serve`` cells: a closed loop of one client handing one stereo
frame pair at a time to the port's video entry
(``methods/video.py::color_transfer_between_videos``) and copying each
corrected frame back to host memory, as a video job does.

Set-up draws the weights and the clip from the seed and serves
``warmup_frames`` frames. The window serves the clip's frames in turn until
``--seconds`` have passed. A seeded reservoir keeps ``check_frames`` of the
window's frames, with the outputs the configuration captures (its
``capture``: {submodule: [output, ...]}, which may be empty); once the
window has closed, the reference recomputes those frames from the same
inputs and weights and the gaps are held to the cell's limits: the
corrected frame's always, and each captured output that the reference
module's ``SERVE_OUTPUTS`` names ({number: (output, rule)}, a rule of
``RULES``)."""

import contextlib
import time
import numpy as np
import torch

from benchmark import trace
from benchmark.reference import precision
from benchmark.run_common import Outcome, free, peak_bytes, set_up, sync
from benchmark.traffic import serve_clip
from benchmark.weights import derive, draw, shapes_of


def setup_weights(cell, seed, device):
    with torch.device("meta"):
        shapes = shapes_of(cell.reference().build(cell.config))
    return draw(shapes, cell.config["init"], seed, device)


class Capture:
    """Keeps the named outputs of a submodule's dict result while armed."""

    def __init__(self, model, spec):
        self.kept, self.armed, self.handles = None, False, []
        for path, keys in spec.items():
            self.handles.append(model.get_submodule(path).register_forward_hook(
                lambda m, a, out, keys=keys: self._keep(out, keys)))

    def _keep(self, out, keys):
        if self.armed:
            self.kept = {k: out[k] for k in keys}

    def take(self):
        kept, self.kept = self.kept, None
        return kept

    def close(self):
        for h in self.handles:
            h.remove()


def program(config, weights, device):
    """The port's serving entry on ``weights``: frames (1, H, W, 3) host
    arrays -> the corrected frame as a host array."""
    from color_transfer_tpu_torch.methods.video import build_deep, color_transfer_between_videos

    module, variables = build_deep(config["method"], variables=weights,
                                   module_kwargs=config["kwargs"])

    def serve(t, r):
        out = color_transfer_between_videos(t, r, method=config["method"], module=module,
                                            variables=variables, device=device)
        return out.cpu().numpy()

    return module, serve


def reference_frames(cell, weights, clip, idxs, device, tf32=False):
    """The reference's own [(clip index, corrected frame, its outputs)] for
    the clip frames ``idxs``. In TF32 it stands in for the program as the
    control."""
    ref_mod = cell.reference()
    ref = ref_mod.build(cell.config).to(device)
    ref.load_state_dict(weights)
    ref.eval()
    kept = []
    for idx in idxs:
        t = torch.from_numpy(clip[0][idx:idx + 1]).to(device)
        r = torch.from_numpy(clip[1][idx:idx + 1]).to(device)
        with torch.no_grad(), precision(tf32):
            out, outputs = ref_mod.serve(ref, t, r)
        kept.append((idx, out.cpu().numpy(), outputs))
    return kept


# How a captured output is held to the reference's, worst frame first.
RULES = {
    "max_abs": lambda got, want: float((got - want).abs().max()),  # the widest gap
    "differ_share": lambda got, want: float((got != want).float().mean()),  # elements that differ
}


def gaps(kept, clip, cell, weights, device):
    """The reference on the kept frames -> {number: value}: the corrected
    frame's widest and mean gap, and each output the reference module's
    ``SERVE_OUTPUTS`` compares where the configuration captures it, by its
    rule, the worst kept frame's. ``kept``: [(clip index, corrected frame,
    captured outputs)] of the program (or of the control)."""
    want = reference_frames(cell, weights, clip, [k[0] for k in kept], device)
    captured = {k for keys in cell.config["capture"].values() for k in keys}
    compared = {number: (output, RULES[rule]) for number, (output, rule)
                in getattr(cell.reference(), "SERVE_OUTPUTS", {}).items() if output in captured}
    frame, frame_mean, outputs = 0.0, [], dict.fromkeys(compared, 0.0)
    for (_, out, got), (_, ref_out, ref_got) in zip(kept, want):
        d = np.abs(out - ref_out)
        frame = max(frame, float(d.max()))
        frame_mean.append(float(d.mean()))
        for number, (output, rule) in compared.items():
            outputs[number] = max(outputs[number], rule(got[output], ref_got[output]))
    return {"frame_max_abs": frame, "frame_mean_abs": float(np.mean(frame_mean)), **outputs}


def run(cell, seed, seconds, trace_on, device, t_process, readers=None):
    config, mix = cell.config, cell.traffic
    marks = [("start", t_process), ("imports", time.perf_counter())]
    weights = setup_weights(cell, seed, device)
    sync(device)
    marks.append(("weights", time.perf_counter()))
    module, serve = program(config, weights, device)
    marks.append(("module", time.perf_counter()))
    clip = serve_clip(mix, seed, device)
    target, reference = clip
    n_clip = target.shape[0]
    capture = Capture(module.model, config["capture"])
    marks.append(("clip", time.perf_counter()))
    for i in range(mix["warmup_frames"]):
        serve(target[i:i + 1], reference[i:i + 1])
    sync(device)
    marks.append(("warm-up frames", time.perf_counter()))

    wanted = {}
    for r in (readers or {}).values():
        wanted.update(getattr(r, "SPANS", {}))
    spans = trace.Spans(module.model, wanted) if trace_on else None
    prof = trace.profiler() if trace_on else contextlib.nullcontext()
    rng = np.random.default_rng(derive(seed, 6))
    k_check = mix["check_frames"]
    kept, latencies = [None] * k_check, []
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_process
    with prof:
        start = time.perf_counter()
        while True:
            n = len(latencies)
            slot = n if n < k_check else int(rng.integers(0, n + 1))
            slot = slot if slot < k_check else None
            idx = (mix["warmup_frames"] + n) % n_clip
            capture.armed = slot is not None
            t0 = time.perf_counter()
            out = serve(target[idx:idx + 1], reference[idx:idx + 1])
            latencies.append(time.perf_counter() - t0)
            if slot is not None:
                kept[slot] = (idx, out, capture.take())
            if time.perf_counter() - start >= seconds:
                break
        sync(device)
        window_s = time.perf_counter() - start
    peak = peak_bytes(device)
    span_ms = spans.close() if spans else None
    span_shapes = dict(spans.shapes) if spans else None
    digest = None
    if trace_on:
        digest = trace.digest(prof, window_s)
        capture.armed = False
        with trace.profiler(host_ops=True) as labelled:
            for k in range(trace.LABEL_UNITS):
                idx = (mix["warmup_frames"] + len(latencies) + k) % n_clip
                serve(target[idx:idx + 1], reference[idx:idx + 1])
            sync(device)
        digest["idle_gaps"] = trace.idle_gaps(labelled)
    capture.close()
    del module, serve
    free(device)

    kept = [k for k in kept if k is not None]
    numbers = gaps(kept, clip, cell, weights, device)
    lat_ms = np.asarray(latencies) * 1e3
    frames = len(latencies)
    return Outcome(
        attempted=frames, failed=0, units=frames, window_s=window_s, setup_s=setup_s,
        peak_bytes=peak, numbers=numbers, spans=span_ms,
        span_shapes=span_shapes, digest=digest,
        e2e={"frames_per_s": frames / window_s,
             "frame_ms_p90": float(np.percentile(lat_ms, 90)),
             "peak_mem_gib": peak / 2**30, "setup_s": setup_s},
        notes=[set_up(marks), f"frame latency: median {float(np.median(lat_ms)):.3f} ms, "
               f"p90 {float(np.percentile(lat_ms, 90)):.3f} ms over {frames} frames; "
               f"checked clip frames {[k[0] for k in kept]}"],
    )
