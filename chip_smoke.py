"""Smoke test of the PyTorch/CUDA port on one GPU: build, check, serve.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero; there is no CPU
fallback):
  1. probe    — card name and power limit, CUDA/nvcc versions; TF32 off.
  2. build    — nvcc builds csrc/local_corr.cu for sm_90a.
  3. kernels  — each kernel of the serving path against its plain torch
                version on the card, at the main path's shape and at a
                ragged small shape, with timings (CUDA events, warmed up).
  4. serve    — full-width DMSCT (6 transformer layers, 6 refinements,
                efficientnet-b2, decoder (256, 128, 64, 32), seeded random
                weights) serves 2 synthetic 1080x1920 stereo pairs through
                color_transfer_between_videos; launch counts, output checks,
                a warm timed pass, peak memory, device time by stage (CUDA
                events) and the device's busy share (torch.profiler); then
                the same model on a small pair, stage by stage, against the
                CPU (plain torch) run.
The line before the last is a JSON object with per-kernel results; the last
line is {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

# Kernel against plain version: the channel sums run in another order
# (lane-strided partial sums + a shuffle tree against a batched matmul), so
# f32 results differ by rounding; 1e-4 of the output scale bounds that.
KERNEL_RTOL = 1e-4
# Each model stage on the card (f32, TF32 off) against the same stage on the
# CPU fed the same inputs (see check_small).
STAGE_RTOL = 1e-4
FRAMES, HEIGHT, WIDTH = 2, 1080, 1920


def _log(*args):
    print(*args, flush=True)


def probe():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _log(f"nvidia-smi: {smi}")
    _log(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}")
    from color_transfer_tpu_torch.ops import _build

    nvcc = subprocess.run(
        [_build.nvcc_path(), "--version"], capture_output=True, text=True,
        check=True,
    ).stdout.strip().splitlines()[-1]
    _log(f"nvcc: {nvcc}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _log(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
         f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    return smi


def build():
    from color_transfer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib, report = _build.build("local_corr")
    _log(f"build local_corr: {time.perf_counter() - t0:.2f} s -> {lib.name}")
    if report:
        _log(report.strip())


def _time_ms(fn, iters=20):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _mixed_flow(g, b, h, w, device):
    """Flows that mix fractional in-image, exactly zero and far-outside
    displacements, one kind per pixel."""
    frac = torch.randn(b, h, w, 2, generator=g) * 3.0
    far = torch.sign(torch.randn(b, h, w, 2, generator=g)) * (
        60.0 + torch.rand(b, h, w, 2, generator=g) * 500.0
    )
    kind = torch.randint(0, 3, (b, h, w, 1), generator=g)
    flow = torch.where(kind == 0, frac, torch.where(kind == 1, 0.0 * frac, far))
    return flow.to(device).contiguous()


def check_kernels():
    """Kernel against plain version on the card. Returns per-kernel rows
    (without the launch count, which the serving run fills in)."""
    from color_transfer_tpu_torch.ops import local_corr as lc

    g = torch.Generator().manual_seed(0)
    row = None
    # (B, H, W, C, r): the 1080p matcher shape, then a ragged small one.
    for shape in ((2, 128, 224, 128, 4), (1, 13, 37, 16, 1)):
        b, h, w, c, r = shape
        f0 = torch.randn(b, h, w, c, generator=g).cuda()
        f1 = torch.randn(b, h, w, c, generator=g).cuda()
        flow = _mixed_flow(g, b, h, w, "cuda")
        with torch.no_grad():
            got = lc.local_correlation_with_flow(f0, f1, flow, r)
            want = lc.local_correlation_with_flow_plain(f0, f1, flow, r)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        with torch.no_grad():
            ms = _time_ms(lambda: lc.local_correlation_with_flow(f0, f1, flow, r))
            plain_ms = _time_ms(
                lambda: lc.local_correlation_with_flow_plain(f0, f1, flow, r)
            )
        _log(f"local_corr {shape}: max|d|={err:.3e} (line {KERNEL_RTOL * scale:.3e}) "
             f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not np.isfinite(err) or err > KERNEL_RTOL * scale:
            raise AssertionError(f"local_corr kernel disagrees at {shape}: {err}")
        if row is None:  # the main path's shape is the one reported
            row = {
                "name": "local_correlation_with_flow",
                "route": "cuda",
                "source": "color_transfer_tpu_torch/csrc/local_corr.cu",
                "replaces": "color_transfer_tpu/ops/local_corr.py:68",
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
            }
    return [row]


def serve(rows):
    from color_transfer_tpu_torch.methods.video import color_transfer_between_videos
    from color_transfer_tpu_torch.ops import local_corr as lc
    from color_transfer_tpu_torch.run.modules import DMSCTModule

    module = DMSCTModule()  # full width: the reference DMSCT recipe
    variables = module.init_eval_variables(seed=0, device="cuda")
    rng = np.random.default_rng(0)
    # Smooth synthetic scenes: a low-frequency field upsampled to 1080p, the
    # reference a shifted, colour-distorted copy of the target.
    low = rng.uniform(0, 1, (FRAMES, 3, 34, 60)).astype(np.float32)
    scene = torch.nn.functional.interpolate(
        torch.from_numpy(low), size=(HEIGHT, WIDTH + 16), mode="bilinear",
        align_corners=False,
    ).permute(0, 2, 3, 1)
    target = scene[:, :, :WIDTH].contiguous()
    reference = (scene[:, :, 16:] * 0.9 + 0.05).clamp(0, 1).contiguous()

    lc.local_correlation_with_flow.launches = 0  # the path's only kernel
    out = color_transfer_between_videos(
        target, reference, method="dmsct", module=module, variables=variables,
        device="cuda",
    )
    torch.cuda.synchronize()
    launches = lc.local_correlation_with_flow.launches
    _log(f"serve: output {tuple(out.shape)}, local_corr launches {launches}")
    if tuple(out.shape) != (FRAMES, HEIGHT, WIDTH, 3):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("non-finite output")
    lo, hi = float(out.min()), float(out.max())
    _log(f"serve: output range [{lo:.4f}, {hi:.4f}]")
    if lo < 0.0 or hi > 1.0:
        raise AssertionError("output outside [0, 1]")
    refine = module.model.matcher.num_reg_refine
    if launches != refine * FRAMES:
        raise AssertionError(
            f"local_corr launched {launches} times, expected {refine} per frame"
        )
    rows[0]["launches"] = launches

    def clip():
        color_transfer_between_videos(
            target, reference, method="dmsct", module=module,
            variables=variables, device="cuda",
        )

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clip()
    torch.cuda.synchronize()
    ms_frame = (time.perf_counter() - t0) * 1e3 / FRAMES
    peak = torch.cuda.max_memory_allocated() / 2**30
    _log(f"serve: warm pass {ms_frame:.1f} ms/frame, peak memory {peak:.2f} GiB "
         f"(1080x1920, batch 1, f32)")
    stages = _stage_ms(module.model, clip)
    _log("serve: device ms/frame by stage: " + ", ".join(
        f"{k} {v / FRAMES:.2f}" for k, v in stages.items()))
    busy_ms = _device_busy_ms(clip)
    _log(f"serve: device busy {busy_ms / FRAMES:.1f} ms/frame (profiled pass), "
         f"busy share of the warm pass {busy_ms / FRAMES / ms_frame:.3f}")
    return module, variables, target, reference


# Submodules of DMSCT timed by stage (matcher.* lie inside matcher), and
# functions of the path timed where their module calls them.
STAGES = ("matcher", "matcher.backbone", "matcher.transformer",
          "matcher.feature_flow_attn", "matcher.refine", "encoder", "decoder",
          "head")
STAGE_FUNCTIONS = (
    ("matcher local_corr", "color_transfer_tpu_torch.models.gmflow",
     "local_correlation_with_flow"),
    ("corrector warps", "color_transfer_tpu_torch.models.dmsct", "flow_warp"),
)


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _stage_ms(model, run):
    """Device time of each stage summed over ``run()``: a CUDA event pair
    around every call of the stage (forward hooks on the submodules, a
    wrapper on the functions), read after one synchronize at the end, so the
    pass itself is not serialised."""
    import importlib

    spans, started = [], {}
    handles = []
    for name in STAGES:
        mod = model.get_submodule(name)
        handles.append(mod.register_forward_pre_hook(
            lambda m, a, name=name: started.__setitem__(name, _event())))
        handles.append(mod.register_forward_hook(
            lambda m, a, o, name=name: spans.append(
                (name, started.pop(name), _event()))))

    def timed(name, fn):
        def call(*args, **kwargs):
            start = _event()
            out = fn(*args, **kwargs)
            spans.append((name, start, _event()))
            return out
        return call

    patched = []
    for name, module_name, attr in STAGE_FUNCTIONS:
        owner = importlib.import_module(module_name)
        patched.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, timed(name, getattr(owner, attr)))
    try:
        run()
    finally:
        for h in handles:
            h.remove()
        for owner, attr, fn in patched:
            setattr(owner, attr, fn)
    torch.cuda.synchronize()
    ms = dict.fromkeys(STAGES + tuple(s[0] for s in STAGE_FUNCTIONS), 0.0)
    for name, start, end in spans:
        ms[name] += start.elapsed_time(end)
    return ms


def _device_busy_ms(run):
    """Device busy ms of ``run()`` from a torch.profiler trace: the union of
    the intervals of the device events (kernels, copies, memsets) it ran."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    intervals = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy, reached = 0.0, float("-inf")
    for start, end in intervals:
        if end > reached:
            busy += end - max(start, reached)
            reached = end
    if busy == 0.0:
        raise AssertionError("the profiler recorded no device activity")
    return busy / 1e3


def check_small(module, variables, target, reference):
    """The model on the card against the plain-torch CPU reference, on a
    small pair, stage by stage: each stage of the card model runs on the
    inputs the CPU run gave that stage (1e-4 relative line: f32 on both,
    sums in another order). End to end, the two runs are reported, not
    held to a line: with random weights the global correlation softmax is
    nearly one-hot, so rounding differences of 1e-6 can move its expected
    coordinates by a pixel and the flow carries that to the output."""
    import copy

    stages = ("matcher.backbone", "matcher.transformer",
              "matcher.feature_flow_attn", "matcher.refine", "encoder",
              "decoder", "head")
    cpu_model = copy.deepcopy(module.model).cpu()
    cpu_model.load_state_dict({k: v.cpu() for k, v in variables.items()})
    card_model = copy.deepcopy(cpu_model).cuda()
    records = []
    handles = [
        cpu_model.get_submodule(name).register_forward_hook(
            lambda m, a, kw, o, name=name: records.append((name, a, kw, o)),
            with_kwargs=True,
        )
        for name in stages
    ]
    small_t = target[:1, ::8, ::8].contiguous()
    small_r = reference[:1, ::8, ::8].contiguous()
    with torch.no_grad():
        cpu_out = cpu_model(small_t, small_r)
        for h in handles:
            h.remove()
        card_out = card_model(small_t.cuda(), small_r.cuda()).cpu()

        def to_card(x):
            if torch.is_tensor(x):
                return x.cuda()
            if isinstance(x, (list, tuple)):
                return type(x)(to_card(y) for y in x)
            return x

        def leaves(x):
            return [x] if torch.is_tensor(x) else [t for y in x for t in leaves(y)]

        worst = {}
        for name, args, kwargs, out in records:
            got = card_model.get_submodule(name)(*to_card(args), **to_card(kwargs))
            for g, w in zip(leaves(got), leaves(out)):
                err = float((g.cpu() - w).abs().max()) / max(1.0, float(w.abs().max()))
                worst[name] = max(worst.get(name, 0.0), err)
    _log(f"small pair {tuple(small_t.shape)}, card stage vs CPU stage (relative): "
         + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    _log(f"small pair end to end, card vs CPU: image max|d|="
         f"{float((card_out - cpu_out).abs().max()):.3e}")
    if set(worst) != set(stages) or max(worst.values()) > STAGE_RTOL:
        raise AssertionError("a stage on the card disagrees with the CPU reference")


def main():
    probe()
    build()
    rows = check_kernels()
    check_small(*serve(rows))
    _log(json.dumps({"kernels": rows}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
