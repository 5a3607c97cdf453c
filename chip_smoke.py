"""Smoke test of the PyTorch/CUDA port on one GPU: build, check, serve.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero; there is no CPU
fallback):
  1. probe    — card name and power limit, CUDA/nvcc versions; TF32 off.
  2. build    — nvcc builds csrc/local_corr.cu, resb_chain.cu,
                row_attention.cu, idt_apply.cu and regrain_stencil.cu for
                sm_90a, all five at once.
  3. kernels  — each kernel against its plain torch version on the card,
                at the main paths' shapes and at a ragged small shape, with
                timings (CUDA events, warmed up): B1 local correlation; B6
                ResB chain (one block at (2, 1080, 1920, 64) in f32 and
                bf16, the 18-block extraction chain in bf16); B5 row
                attention (a 16-row band of (1, 1080, 1920, 64), bf16 and
                precise, timed at the full shape).
  4. serve    — full-width DMSCT (6 transformer layers, 6 refinements,
                efficientnet-b2, decoder (256, 128, 64, 32), seeded random
                weights) serves 2 synthetic 1080x1920 stereo pairs through
                color_transfer_between_videos; launch counts, output checks,
                a warm timed pass, peak memory, device time by stage (CUDA
                events) and the device's busy share (torch.profiler); then
                the same model on a small pair, stage by stage, against the
                CPU (plain torch) run.
  5. dcmcs3di — full-width DCMCS3DI (18 extraction and 6 transfer ResB
                blocks, 64 channels, seeded random weights) serves the same
                2 pairs through the kernel route (``inference=True,
                use_kernels=True``) in the f32 recipe (TF32 off; B5 only)
                and the bf16 recipe (B5 and B6); launch counts, output
                checks, warm ms/frame, peak memory, device ms by stage,
                busy share, the bf16-against-f32 pair PSNR; then the f32
                model with precise row attention on a small pair, stage by
                stage, against the CPU run.
  6. classical — B3 (IDT transport apply) at a 1080p chunk (8, 3, 2073600)
                and a ragged N, B4 (regrain sweeps) at 1080p level 0 (nbit
                4), the smallest 1080p level 34x60 (nbit 64) and 13x22
                (nbit 7), each against its plain version and timed; then
                all five classical methods (Reinhard, CCS, MK, IDT,
                grading) serve 8 synthetic 1080x1920 frames per frame
                through color_transfer_between_videos, MK also in global
                mode: exact launch counts (B3 4 per chunk for IDT and
                grading, B4 6 per chunk for grading, no other kernel),
                output checks, warm ms/frame, peak memory, busy share, the
                grading chunk's device split between IDT and regrain; then
                each method on a small clip on the card against the CPU,
                with the same (default, seed 42) rotations on both sides.
The line before the last is a JSON object with per-kernel results; the last
line is {"ok": true, "device": {...}}.
"""

import json
import math
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
KERNELS = ("local_corr", "resb_chain", "row_attention", "idt_apply", "regrain_stencil")
# DCMCS3DI at the reference recipe's full width.
EXTRACTION_LAYERS, TRANSFER_LAYERS, CHANNELS = 18, 6, 64
# B6 in bf16 against its plain version: both round to bf16 at the same
# places, but the f32 sums run in another order, so a rounding can flip by
# one ulp; within a block or two that stays under 4 ulps of the output scale.
# Through the 18-block chain the flips feed the next convs and compound:
# 32 ulps there.
BF16_BLOCK_ULPS, BF16_CHAIN_ULPS = 4, 32
# The classical path: the JAX package's default chunk of 8 frames, IDT's 4
# rotations, and the regrain pyramid's 6 levels at 1080p (1080x1920 down to
# 34x60).
CLASSICAL = ("reinhard", "correlated_color_space", "monge_kantorovitch", "idt",
             "automated_color_grading")
CLASSICAL_FRAMES, N_ITER, LEVELS = 8, 4, 6
# B3 and B4 against their plain versions: the kernels round operation by
# operation as the plain versions do (IEEE division, no FMA contraction), so
# they agree to rounding: B3 within 1e-6 * bins (bin units; 4 ulps at the top
# value 255), B4 within 1e-6 of max(1, max|ref|).
B3_LINE, B4_LINE = 1e-6, 1e-6
# Card against CPU on a small clip. The linear methods: 1e-4 (sums over the
# frame in another order, cuSOLVER's eigensolver against LAPACK's). IDT and
# grading are chaotic under rounding (a sample within an ulp of a bin edge
# moves to the next bin, and one table entry by up to a bin): one bin of the
# joint range of [0, 1]^3 projections, sqrt(3)/255, at most, and 1e-4 on
# average, the lines of the CPU tests against JAX.
SMALL_LINEAR_ATOL = 1e-4
SMALL_IDT_MAX, SMALL_IDT_MEAN = 3**0.5 / 255, 1e-4


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
    """One nvcc per kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from color_transfer_tpu_torch.ops import _build

    def timed(name):
        t0 = time.perf_counter()
        lib, report = _build.build(name)
        return name, time.perf_counter() - t0, lib, report

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        for name, secs, lib, report in pool.map(timed, KERNELS):
            _log(f"build {name}: {secs:.2f} s -> {lib.name}")
            for line in (report or "").splitlines():  # registers and spills
                if "Used" in line or "spill" in line:
                    _log("  " + line.strip())


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
    return [row, check_resb_chain(g), check_row_attention(g)]


def _bf16_ulp(scale):
    """One bf16 ulp (8 significant bits) at the magnitude ``scale``."""
    return 2.0 ** (math.floor(math.log2(max(scale, 1e-30))) - 7)


def _chain_weights(g, layers, c):
    """ResB chain weights with the JAX init's law, U(+-1/sqrt(9 C))."""
    bound = (9 * c) ** -0.5
    k = (torch.rand(layers, 2, 3, 3, c, c, generator=g) * 2 - 1) * bound
    b = (torch.rand(layers, 2, c, generator=g) * 2 - 1) * bound
    return k.cuda(), b.cuda()


def check_resb_chain(g):
    """B6 against its plain version: one ResB block at the two-view 1080p
    shape in f32 (line KERNEL_RTOL of the output scale: f32 on both sides,
    sums in another order) and in bf16 (BF16_BLOCK_ULPS), the 18-block
    extraction chain in bf16 (BF16_CHAIN_ULPS), and a ragged small shape in
    both. Times one bf16 block (two launches) against its plain version."""
    from color_transfer_tpu_torch.ops import conv_chain as cc

    row = None
    cases = (
        ((2, HEIGHT, WIDTH, CHANNELS), 1, torch.float32),
        ((2, HEIGHT, WIDTH, CHANNELS), 1, torch.bfloat16),
        ((2, HEIGHT, WIDTH, CHANNELS), EXTRACTION_LAYERS, torch.bfloat16),
        ((1, 13, 37, 16), 2, torch.float32),
        ((1, 13, 37, 16), 2, torch.bfloat16),
    )
    for shape, layers, cd in cases:
        x = torch.randn(*shape, generator=g).cuda()
        k, b = _chain_weights(g, layers, shape[-1])
        with torch.no_grad():
            got = cc.resb_chain(x, k, b, cd)
            want = cc.resb_chain_plain(x, k, b, cd)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        if cd == torch.float32:
            line = KERNEL_RTOL * scale
        else:
            ulps = BF16_CHAIN_ULPS if layers == EXTRACTION_LAYERS else BF16_BLOCK_ULPS
            line = ulps * _bf16_ulp(scale)
        msg = (f"resb_chain {shape} x {layers} blocks {str(cd)[6:]}: max|d|={err:.3e} "
               f"(line {line:.3e}, max|ref| {scale:.3f})")
        if layers == 1:
            with torch.no_grad():
                ms = _time_ms(lambda: cc.resb_chain(x, k, b, cd), iters=5)
                plain_ms = _time_ms(lambda: cc.resb_chain_plain(x, k, b, cd), iters=5)
            msg += f" per block: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
        _log(msg)
        if not np.isfinite(err) or err > line:
            raise AssertionError(f"resb_chain kernel disagrees at {shape}, {cd}: {err}")
        if layers == 1 and cd == torch.bfloat16:  # the serving recipe's block
            row = {
                "name": "resb_chain",
                "route": "cuda",
                "source": "color_transfer_tpu_torch/csrc/resb_chain.cu",
                "replaces": "color_transfer_tpu/ops/conv_chain.py:100",
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
            }
        del x, got, want
    return row


def check_row_attention(g):
    """B5 against its plain version on a 16-row band of the 1080p matcher
    shape and on a ragged small shape, bf16 operands and precise (f32).
    Lines: out within KERNEL_RTOL of max(1, max|ref|) in precise mode (f32
    on both sides); in bf16 within 2^-8 max|v|, the bound if every att
    entry's bf16 rounding flipped by an ulp (sum of att is 1); colsum
    within KERNEL_RTOL of max(1, max|ref|) (f32 att on both sides). Times
    the full (1, 1080, 1920, 64) call, kernel against the plain version
    (which runs in bands of rows)."""
    from color_transfer_tpu_torch.ops import row_attention as ra

    err_bf16 = None
    for shape in ((1, 16, WIDTH, CHANNELS), (2, 5, 97, 32)):
        # q and k of std 3: scores of std ~1.1 at scale 1/C, peaked rows.
        q, k = (3 * torch.randn(*shape, generator=g)).cuda(), (3 * torch.randn(*shape, generator=g)).cuda()
        v = torch.randn(*shape, generator=g).cuda()
        scale = 1.0 / shape[-1]
        for precise in (False, True):
            with torch.no_grad():
                out, cs = ra.row_attention_warp(q, k, v, scale, precise)
                _, cs_only = ra.row_attention_warp(q, k, None, scale, precise)
                want_out, want_cs = ra.row_attention_warp_plain(q, k, v, scale, precise)
            torch.cuda.synchronize()
            err = float((out - want_out).abs().max())
            err_cs = max(float((cs - want_cs).abs().max()),
                         float((cs_only - want_cs).abs().max()))
            line = (KERNEL_RTOL * max(1.0, float(want_out.abs().max())) if precise
                    else 2.0 ** -8 * float(v.abs().max()))
            line_cs = KERNEL_RTOL * max(1.0, float(want_cs.abs().max()))
            _log(f"row_attention {shape} {'precise' if precise else 'bf16'}: out "
                 f"max|d|={err:.3e} (line {line:.3e}), colsum max|d|={err_cs:.3e} "
                 f"(line {line_cs:.3e})")
            if not (err <= line and err_cs <= line_cs):
                raise AssertionError(f"row_attention kernel disagrees at {shape}")
            if err_bf16 is None and not precise:
                err_bf16 = err
    shape = (1, HEIGHT, WIDTH, CHANNELS)
    q, k, v = (torch.randn(*shape, generator=g).cuda() for _ in range(3))
    with torch.no_grad():
        ms = _time_ms(lambda: ra.row_attention_warp(q, k, v, 1 / CHANNELS), iters=3)
        ms_cs = _time_ms(lambda: ra.row_attention_warp(q, k, None, 1 / CHANNELS), iters=3)
        plain_ms = _time_ms(lambda: ra.row_attention_warp_plain(q, k, v, 1 / CHANNELS), iters=3)
    _log(f"row_attention {shape} bf16: kernel {ms:.3f} ms (colsum only {ms_cs:.3f} ms), "
         f"plain {plain_ms:.3f} ms")
    return {
        "name": "row_attention_warp",
        "route": "cuda",
        "source": "color_transfer_tpu_torch/csrc/row_attention.cu",
        "replaces": "color_transfer_tpu/ops/row_attention.py:35",
        "max_abs_err": err_bf16,
        "ms": ms,
        "plain_ms": plain_ms,
    }


def _wrappers():
    """The kernel wrappers, each with its ``launches`` count."""
    from color_transfer_tpu_torch.ops import (
        conv_chain,
        idt_apply,
        local_corr,
        regrain_stencil,
        row_attention,
    )

    return (local_corr.local_correlation_with_flow, conv_chain.resb_chain,
            row_attention.row_attention_warp, idt_apply.transport_apply,
            regrain_stencil.regrain_sweeps)


def _reset_launches():
    for fn in _wrappers():
        fn.launches = 0


def _launches():
    return {fn.__name__: fn.launches for fn in _wrappers()}


def serve(rows):
    from color_transfer_tpu_torch.methods.video import color_transfer_between_videos
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

    _reset_launches()
    out = color_transfer_between_videos(
        target, reference, method="dmsct", module=module, variables=variables,
        device="cuda",
    )
    torch.cuda.synchronize()
    counts = _launches()
    launches = counts["local_correlation_with_flow"]
    _log(f"serve: output {tuple(out.shape)}, launches {counts}")
    if any(n for name, n in counts.items() if name != "local_correlation_with_flow"):
        raise AssertionError("DMSCT launched another path's kernel")
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


def _stage_ms(model, run, stages=STAGES, functions=STAGE_FUNCTIONS):
    """Device time of each stage summed over ``run()``: a CUDA event pair
    around every call of the stage (forward hooks on the submodules, a
    wrapper on the functions), read after one synchronize at the end, so the
    pass itself is not serialised. ``functions`` holds (name, owner, attr):
    the owner is a module's import name or an object."""
    import importlib

    spans, started = [], {}
    handles = []
    for name in stages:
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
    for name, owner, attr in functions:
        if isinstance(owner, str):
            owner = importlib.import_module(owner)
        patched.append((owner, attr, vars(owner).get(attr)))
        setattr(owner, attr, timed(name, getattr(owner, attr)))
    try:
        run()
    finally:
        for h in handles:
            h.remove()
        for owner, attr, fn in patched:
            if fn is None:  # a method patched on an instance
                delattr(owner, attr)
            else:
                setattr(owner, attr, fn)
    torch.cuda.synchronize()
    ms = dict.fromkeys(stages + tuple(s[0] for s in functions), 0.0)
    for name, start, end in spans:
        ms[name] += start.elapsed_time(end)
    return ms


def _device_busy_ms(run, top=0):
    """Device busy ms of ``run()`` from a torch.profiler trace: the union of
    the intervals of the device events (kernels, copies, memsets) it ran.
    With ``top``, also logs the ``top`` device kernels by summed time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    device_events = [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    intervals = sorted((e.time_range.start, e.time_range.end) for e in device_events)
    if top:
        by_name = {}
        for e in device_events:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
            _log(f"  device {us / 1e3:9.2f} ms  {name[:110]}")
    busy, reached = 0.0, float("-inf")
    for start, end in intervals:
        if end > reached:
            busy += end - max(start, reached)
            reached = end
    if busy == 0.0:
        raise AssertionError("the profiler recorded no device activity")
    return busy / 1e3


def _check_stages(label, model, variables, small_t, small_r, stages,
                  forward=lambda m, t, r: m(t, r), functions=()):
    """``model`` on the card against the plain-torch CPU run on a small
    pair, stage by stage: each stage of the card model (a submodule, or a
    function (name, import name, attr) its modules call) runs on the inputs
    the CPU run gave that stage; every stage must agree within STAGE_RTOL of
    max(1, max|ref|). Returns the end-to-end image max|d|, card vs CPU."""
    import copy
    import importlib

    cpu_model = copy.deepcopy(model).cpu()
    cpu_model.load_state_dict({k: v.cpu() for k, v in variables.items()})
    card_model = copy.deepcopy(cpu_model).cuda()
    records = []
    handles = [
        cpu_model.get_submodule(name).register_forward_hook(
            lambda m, a, kw, o, name=name: records.append((name, None, a, kw, o)),
            with_kwargs=True,
        )
        for name in stages
    ]
    patched = []
    for name, owner, attr in functions:
        owner = importlib.import_module(owner)
        fn = getattr(owner, attr)

        def recorded(*a, name=name, fn=fn, **kw):
            out = fn(*a, **kw)
            records.append((name, fn, a, kw, out))
            return out

        patched.append((owner, attr, fn))
        setattr(owner, attr, recorded)

    def to_card(x):
        if torch.is_tensor(x):
            return x.cuda()
        if isinstance(x, (list, tuple)):
            return type(x)(to_card(y) for y in x)
        if isinstance(x, dict):
            return {k: to_card(v) for k, v in x.items()}
        return x

    def leaves(x):
        if torch.is_tensor(x):
            return [x.float()]
        if isinstance(x, (list, tuple)):
            return [t for y in x for t in leaves(y)]
        return []

    try:
        with torch.no_grad():
            cpu_out = forward(cpu_model, small_t, small_r)
    finally:
        for h in handles:
            h.remove()
        for owner, attr, fn in patched:
            setattr(owner, attr, fn)
    with torch.no_grad():
        card_out = forward(card_model, small_t.cuda(), small_r.cuda()).cpu()
        worst = {}
        for name, fn, args, kwargs, out in records:
            call = fn or card_model.get_submodule(name)
            got = call(*to_card(args), **to_card(kwargs))
            for g, w in zip(leaves(got), leaves(out), strict=True):
                err = float((g.cpu() - w).abs().max()) / max(1.0, float(w.abs().max()))
                worst[name] = max(worst.get(name, 0.0), err)
    names = set(stages) | {f[0] for f in functions}
    _log(f"{label}: small pair {tuple(small_t.shape)}, card stage vs CPU stage "
         "(relative): " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    e2e = float((card_out - cpu_out).abs().max())
    _log(f"{label}: small pair end to end, card vs CPU: image max|d|={e2e:.3e}")
    if set(worst) != names or max(worst.values()) > STAGE_RTOL:
        raise AssertionError(f"{label}: a stage on the card disagrees with the CPU")
    return e2e


def check_small(module, variables, target, reference):
    """DMSCT on the card against the CPU, stage by stage (1e-4 relative
    line: f32 on both, sums in another order). End to end, the two runs are
    reported, not held to a line: with random weights the global
    correlation softmax is nearly one-hot, so rounding differences of 1e-6
    can move its expected coordinates by a pixel and the flow carries that
    to the output."""
    _check_stages(
        "dmsct", module.model, variables, target[:1, ::8, ::8].contiguous(),
        reference[:1, ::8, ::8].contiguous(),
        ("matcher.backbone", "matcher.transformer", "matcher.feature_flow_attn",
         "matcher.refine", "encoder", "decoder", "head"),
    )


def _dcmcs3di_clip(module, variables, target, reference):
    """DCMCS3DI at 1080p as the JAX package serves it (bench.py,
    examples/deep_gate.py): the model called frame by frame with
    ``inference=True`` on the kernel route, TF32 off."""
    from color_transfer_tpu_torch.run.modules import full_f32_inference

    outs = []
    with full_f32_inference():
        for i in range(target.shape[0]):
            out, _ = torch.func.functional_call(
                module.model, variables,
                (target[i : i + 1].cuda(), reference[i : i + 1].cuda()),
                {"inference": True, "use_kernels": True}, strict=True,
            )
            outs.append(out)
    return torch.cat(outs)


def serve_dcmcs3di(rows, target, reference):
    """Full-width DCMCS3DI on the two 1080p pairs in the f32 and the bf16
    recipe: launch counts, output checks, warm ms/frame, peak memory,
    device ms by stage, busy share; then the bf16-against-f32 pair PSNR.
    Returns the f32 module and variables."""
    from color_transfer_tpu_torch.models import dcmcs3di as dc_models
    from color_transfer_tpu_torch.run.modules import DCMCS3DIModule

    outputs, kept = {}, None
    for recipe in (None, "bfloat16"):
        label = f"dcmcs3di {recipe or 'float32'}"
        module = DCMCS3DIModule(EXTRACTION_LAYERS, TRANSFER_LAYERS, CHANNELS,
                                compute_dtype=recipe)
        variables = module.init_eval_variables(seed=0, device="cuda")

        def clip():
            return _dcmcs3di_clip(module, variables, target, reference)

        _reset_launches()
        out = clip()
        torch.cuda.synchronize()
        counts = _launches()
        _log(f"{label}: output {tuple(out.shape)}, launches {counts}")
        b6 = 0 if recipe is None else 2 * (EXTRACTION_LAYERS + TRANSFER_LAYERS) * FRAMES
        want = {"local_correlation_with_flow": 0, "resb_chain": b6,
                "row_attention_warp": 2 * FRAMES, "transport_apply": 0,
                "regrain_sweeps": 0}
        if counts != want:
            raise AssertionError(f"{label}: launches {counts}, expected {want}")
        if tuple(out.shape) != (FRAMES, HEIGHT, WIDTH, 3):
            raise AssertionError(f"{label}: output shape {tuple(out.shape)}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{label}: non-finite output")
        lo, hi = float(out.min()), float(out.max())
        _log(f"{label}: output range [{lo:.4f}, {hi:.4f}]")
        if lo < 0.0 or hi > 1.0:
            raise AssertionError(f"{label}: output outside [0, 1]")
        if recipe is not None:  # the serving recipe runs both kernels
            rows[1]["launches"] = counts["resb_chain"]
            rows[2]["launches"] = counts["row_attention_warp"]
        outputs[recipe] = out

        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clip()
        torch.cuda.synchronize()
        ms_frame = (time.perf_counter() - t0) * 1e3 / FRAMES
        peak = torch.cuda.max_memory_allocated() / 2**30
        _log(f"{label}: warm pass {ms_frame:.1f} ms/frame, peak memory "
             f"{peak:.2f} GiB (1080x1920, batch 1)")
        model = module.model
        stages = _stage_ms(
            model, clip,
            stages=("extraction", "matcher.head", "matcher.query", "matcher.key",
                    "matcher.value", "transfer"),
            functions=(("extraction B6", model.extraction, "fused"),
                       ("transfer B6", model.transfer, "fused"),
                       ("matcher row attention B5", dc_models, "fused_parallax_inference")),
        )
        _log(f"{label}: device ms/frame by stage: " + ", ".join(
            f"{k} {v / FRAMES:.2f}" for k, v in stages.items()))
        grouped = {
            "extraction": stages["extraction"] + stages["extraction B6"],
            "matcher": sum(v for k, v in stages.items() if k.startswith("matcher")),
            "transfer": stages["transfer"] + stages["transfer B6"],
        }
        _log(f"{label}: extraction {grouped['extraction'] / FRAMES:.2f}, matcher "
             f"{grouped['matcher'] / FRAMES:.2f}, transfer "
             f"{grouped['transfer'] / FRAMES:.2f} device ms/frame")
        busy_ms = _device_busy_ms(clip, top=8)
        _log(f"{label}: device busy {busy_ms / FRAMES:.1f} ms/frame (profiled pass), "
             f"busy share of the warm pass {busy_ms / FRAMES / ms_frame:.3f}")
        if recipe is None:
            kept = (module, variables)
        else:
            del module, variables
        torch.cuda.empty_cache()

    d = outputs["bfloat16"] - outputs[None]
    psnr = 10 * math.log10(1.0 / max(float((d * d).mean()), 1e-30))
    _log(f"dcmcs3di bf16 against f32 on identical weights: pair PSNR {psnr:.2f} dB, "
         f"max|d|={float(d.abs().max()):.3e} (reported; the JAX TPU gate's "
         "record is 61.0 dB)")
    return kept


def check_small_dcmcs3di(module, variables, target, reference):
    """DCMCS3DI's f32 recipe with precise row attention on the card against
    the CPU, stage by stage (1e-4 relative line: f32 everywhere, sums in
    another order); end to end reported."""
    _check_stages(
        "dcmcs3di", module.model, variables, target[:1, ::8, ::8].contiguous(),
        reference[:1, ::8, ::8].contiguous(),
        ("extraction", "matcher.head", "matcher.query", "matcher.key",
         "matcher.value", "transfer"),
        forward=lambda m, t, r: m(t, r, inference=True, use_kernels=True,
                                  precise=True)[0],
        functions=(("row attention", "color_transfer_tpu_torch.ops.row_attention",
                    "row_attention_warp"),),
    )


def check_classical_kernels(g):
    """B3 and B4 against their plain versions at the 1080p chunk's shapes and
    at ragged ones, timed (CUDA events). Lines: B3_LINE * bins for B3 (bin
    units), B4_LINE * max(1, max|ref|) for B4. Returns their two rows."""
    from color_transfer_tpu_torch.ops import idt_apply as ia
    from color_transfer_tpu_torch.ops import regrain_stencil as rs

    rows = []
    bins = 255
    for frames, n in ((CLASSICAL_FRAMES, HEIGHT * WIDTH), (2, 4099)):
        # Monotone tables in bin units; samples also below grid_lo and above
        # right_edge.
        fp = torch.sort(torch.rand(frames, 3, bins, generator=g) * bins, dim=-1).values.cuda()
        lo = (torch.rand(frames, 3, generator=g) * 0.4 - 0.5).cuda()
        step = (0.004 + torch.rand(frames, 3, generator=g) * 0.004).cuda()
        right_edge = lo + step * (bins - 1)
        x = (torch.rand(frames, 3, n, generator=g) * 1.8 - 0.7).cuda()
        args = (x, lo, step, fp, right_edge)
        got, want = ia.transport_apply(*args), ia.transport_apply_plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ms = _time_ms(lambda: ia.transport_apply(*args))
        plain_ms = _time_ms(lambda: ia.transport_apply_plain(*args))
        _log(f"idt_apply (B3) {tuple(x.shape)} bins {bins}: max|d|={err:.3e} (line "
             f"{B3_LINE * bins:.3e}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not err <= B3_LINE * bins:
            raise AssertionError(f"idt_apply kernel disagrees at {tuple(x.shape)}: {err}")
        if not rows:
            rows.append({"name": "transport_apply", "route": "cuda",
                         "source": "color_transfer_tpu_torch/csrc/idt_apply.cu",
                         "replaces": "color_transfer_tpu/methods/iterative.py:137",
                         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
        del x, got, want, args
    for frames, h, w, nbit in ((CLASSICAL_FRAMES, HEIGHT, WIDTH, 4),
                               (CLASSICAL_FRAMES, 34, 60, 64), (1, 13, 22, 7)):
        out0 = torch.rand(frames, h, w, 3, generator=g).cuda()
        const = torch.rand(frames, h, w, 3, generator=g).cuda()
        phis = (torch.rand(frames, 4, h, w, generator=g) * 15).cuda()
        inv_den = (0.8 / (phis.sum(dim=1) + 1.0)).contiguous()
        args = (out0, const, phis, inv_den, nbit)
        got, want = rs.regrain_sweeps(*args), rs.regrain_sweeps_plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        line = B4_LINE * max(1.0, float(want.abs().max()))
        ms = _time_ms(lambda: rs.regrain_sweeps(*args))
        plain_ms = _time_ms(lambda: rs.regrain_sweeps_plain(*args), iters=5)
        _log(f"regrain_sweeps (B4) ({frames}, {h}, {w}, 3) nbit {nbit}: max|d|={err:.3e} "
             f"(line {line:.3e}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not err <= line:
            raise AssertionError(f"regrain_sweeps kernel disagrees at {(frames, h, w)}: {err}")
        if len(rows) == 1:  # 1080p level 0 is the reported shape
            rows.append({"name": "regrain_sweeps", "route": "cuda",
                         "source": "color_transfer_tpu_torch/csrc/regrain_stencil.cu",
                         "replaces": "color_transfer_tpu/ops/regrain_stencil.py:27",
                         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
        del out0, const, phis, inv_den, got, want, args
    torch.cuda.empty_cache()
    return rows


def _classical_clip(frames, h, w, seed=1):
    """Smooth synthetic scenes (a low-frequency field, upsampled) and a
    shifted, gamma- and colour-cast reference."""
    rng = np.random.default_rng(seed)
    low = rng.uniform(0, 1, (frames, 3, 34, 60)).astype(np.float32)
    scene = torch.nn.functional.interpolate(
        torch.from_numpy(low), size=(h, w + 16), mode="bilinear", align_corners=False,
    ).permute(0, 2, 3, 1)
    cast = torch.tensor([0.9, 1.0, 0.75])
    target = scene[:, :, :w].contiguous()
    reference = (scene[:, :, 16:] ** 1.4 * cast + 0.05).clamp(0, 1).contiguous()
    return target, reference


def serve_classical(rows):
    """The five classical methods on 8 1080p frames (MK also in global
    mode) through color_transfer_between_videos: launch counts reset before
    each run and checked exactly, output checks, warm ms/frame, peak memory,
    busy share; for grading the device split between IDT and regrain."""
    from color_transfer_tpu_torch.methods import iterative
    from color_transfer_tpu_torch.methods.video import color_transfer_between_videos

    target, reference = (x.cuda() for x in _classical_clip(CLASSICAL_FRAMES, HEIGHT, WIDTH))
    runs = [(m, True) for m in CLASSICAL] + [("monge_kantorovitch", False)]
    for method, per_frame in runs:
        label = f"{method}{'' if per_frame else ' (global)'}"

        def clip():
            return color_transfer_between_videos(target, reference, method=method,
                                                 per_frame=per_frame)

        _reset_launches()
        out = clip()
        torch.cuda.synchronize()
        counts = _launches()
        want = dict.fromkeys(counts, 0)
        if method in ("idt", "automated_color_grading"):
            want["transport_apply"] = N_ITER
        if method == "automated_color_grading":
            want["regrain_sweeps"] = LEVELS
            rows[3]["launches"] = counts["transport_apply"]
            rows[4]["launches"] = counts["regrain_sweeps"]
        if counts != want:
            raise AssertionError(f"{label}: launches {counts}, expected {want}")
        if tuple(out.shape) != (CLASSICAL_FRAMES, HEIGHT, WIDTH, 3):
            raise AssertionError(f"{label}: output shape {tuple(out.shape)}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{label}: non-finite output")
        lo, hi = float(out.min()), float(out.max())
        if lo < 0.0 or hi > 1.0:
            raise AssertionError(f"{label}: output outside [0, 1]")
        del out
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clip()
        torch.cuda.synchronize()
        ms_frame = (time.perf_counter() - t0) * 1e3 / CLASSICAL_FRAMES
        peak = torch.cuda.max_memory_allocated() / 2**30
        busy_ms = _device_busy_ms(clip, top=5)
        _log(f"{label}: launches {counts}, output range [{lo:.4f}, {hi:.4f}], warm pass "
             f"{ms_frame:.2f} ms/frame, peak memory {peak:.2f} GiB ({CLASSICAL_FRAMES} x "
             f"{HEIGHT}x{WIDTH} f32 chunk), device busy {busy_ms / CLASSICAL_FRAMES:.2f} ms/frame, busy share "
             f"{busy_ms / CLASSICAL_FRAMES / ms_frame:.3f}")
        if method == "automated_color_grading":
            owner = "color_transfer_tpu_torch.methods.iterative"
            stages = _stage_ms(None, clip, stages=(), functions=(
                ("grading", iterative.automated_color_grading, "batched"),
                ("idt", owner, "iterative_distribution_transfer_batched"),
                ("idt transport B3", owner, "transport_apply"),
                ("regrain sweeps B4", owner, "regrain_sweeps"),
            ))
            per = {k: v / CLASSICAL_FRAMES for k, v in stages.items()}
            _log(f"{label}: device ms/frame: IDT {per['idt']:.3f} (B3 "
                 f"{per['idt transport B3']:.3f}), regrain {per['grading'] - per['idt']:.3f} "
                 f"(B4 {per['regrain sweeps B4']:.3f}), grading {per['grading']:.3f}")


def check_small_classical():
    """Each classical method on a small clip, on the card against the CPU,
    the default (seed 42) rotations on both sides. Lines: SMALL_LINEAR_ATOL
    for the linear methods; IDT and grading as the CPU tests hold them
    against JAX (max SMALL_IDT_MAX, mean SMALL_IDT_MEAN)."""
    from color_transfer_tpu_torch.methods.video import color_transfer_between_videos

    target, reference = _classical_clip(2, 135, 240, seed=2)
    report = []
    for method in CLASSICAL:
        cpu = color_transfer_between_videos(target, reference, method=method, device="cpu")
        card = color_transfer_between_videos(target, reference, method=method,
                                             device="cuda").cpu()
        d = (card - cpu).abs()
        err, mean = float(d.max()), float(d.mean())
        report.append(f"{method} max {err:.2e} mean {mean:.2e}")
        if method in ("idt", "automated_color_grading"):
            ok = err <= SMALL_IDT_MAX and mean <= SMALL_IDT_MEAN
        else:
            ok = err <= SMALL_LINEAR_ATOL
        if not ok:
            raise AssertionError(f"{method}: card disagrees with the CPU: max {err}, mean {mean}")
    _log(f"classical: small clip {tuple(target.shape)}, card against CPU: " + ", ".join(report))


def main():
    probe()
    build()
    rows = check_kernels()
    module, variables, target, reference = serve(rows)
    check_small(module, variables, target, reference)
    del module, variables
    torch.cuda.empty_cache()
    check_small_dcmcs3di(*serve_dcmcs3di(rows, target, reference), target, reference)
    del target, reference
    torch.cuda.empty_cache()
    rows += check_classical_kernels(torch.Generator().manual_seed(1))
    serve_classical(rows)
    check_small_classical()
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
