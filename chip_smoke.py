"""Smoke test of the PyTorch/CUDA port on one GPU: build, check, serve.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero; there is no CPU
fallback):
  1. probe    — card name and power limit, CUDA/nvcc versions; TF32 off.
  2. build    — nvcc builds csrc/local_corr.cu, resb_chain.cu,
                row_attention.cu, idt_apply.cu, regrain_stencil.cu,
                warp_adjoint.cu, win_attention.cu, win_sublayer.cu and
                win_ffn.cu for sm_90a, all nine at once.
  3. kernels  — each kernel against its plain torch version on the card,
                at the main paths' shapes and at a ragged small shape, with
                timings (CUDA events, warmed up): B1 local correlation at
                the 1080p matcher shape on a mixed flow (the per-pixel
                route), a smooth flow (the staged route) and a step between
                them (both routes in one call), at the training shape (24,
                64, 120, 128) and a ragged shape: the kernel's route of
                every tile held to ``tile_boxes``, two runs bit-equal, the
                staged share printed, each timed beside its bound; B6
                ResB chain (one block at (2, 1080, 1920, 64) in f32 and
                bf16, the 18-block extraction chain in bf16, ragged shapes
                at 16, 32 and 64 channels; timed per block and per conv
                launch at the two path shapes, beside cuDNN's bf16 convs);
                B5 row attention (a 16-row band of (1, 1080, 1920, 64) and
                ragged widths, bf16 and precise, all three instantiations:
                out and column sums, column sums only, out only; two runs
                bit-equal; each instantiation timed at the full shape
                beside its bound).
  4. serve    — full-width DMSCT (6 transformer layers, 6 refinements,
                efficientnet-b2, decoder (256, 128, 64, 32), seeded random
                weights) serves 2 synthetic 1080x1920 stereo pairs through
                color_transfer_between_videos; launch counts, output checks,
                a warm timed pass, peak memory, device time by stage (CUDA
                events) and the device's busy share (torch.profiler); then
                the same model on a small pair, stage by stage, against the
                CPU (plain torch) run. B1 is checked and timed on the
                arguments of the served frame's first B1 call (the flow the
                GRU loop gives it): B1's reported time.
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
                and a ragged N, B4 (regrain sweeps) at the six levels of an
                8-frame 1080p chunk (1080x1920 with 4 sweeps down to 34x60
                with 64) and 13x22 (nbit 7), bit-equal to its plain version,
                each level timed beside its bound, and the chunk's sum; then
                all five classical methods (Reinhard, CCS, MK, IDT,
                grading) serve 8 synthetic 1080x1920 frames per frame
                through color_transfer_between_videos, MK also in global
                mode: exact launch counts (B3 4 per chunk for IDT and
                grading, B4 6 per chunk for grading, no other kernel),
                output checks, warm ms/frame, peak memory, busy share, the
                grading chunk's device split between IDT and regrain; then
                each method on a small clip on the card against the CPU,
                with the same (default, seed 42) rotations on both sides.
  7. training — B7 (the warp adjoint) against its plain version at DMSCT's
                four training levels (batch 12, 256x480 crops) and at ragged
                shapes, timed beside its bound, the plain version and one
                ``index_add_``; the backward of flow_warp_batched against
                autograd of the plain gather; then ``fit`` through the CLI at
                the full width of configs/dmsct.yaml on a synthetic dataset
                (24 train, 12 validation pairs at 288x512; batch 12, crops
                256x480, 2 epochs): warm ms/step, peak memory, B7 launches
                (4 per step), the device split by span and the top kernels
                of one step, busy share, the matcher bit-unchanged, the
                corrector and BN statistics moved, the checkpoints; predict
                from the best checkpoint; then the corrector's train step on
                the card against the CPU with the matcher's output fed in.
  8. fused    — the matcher transformer's fused route: B2a (windowed
                attention; no mask, the swin mask from geometry, a mask
                operand), B2b (the attention sublayer: self-attention with the
                shift and the residual, cross-attention without) and B2c (the
                FFN) against their plain versions at the paths' shapes (1080p
                scale 1, the train shape's two scales), at half those windows
                and at a ragged shape, timed at 1080p scale 1 beside their
                bounds, plain versions and SDPA (B2a); full-width DMSCT with
                ``matcher_fused_attention=True`` serves the two 1080p pairs:
                exact launch counts (B2b 12, B2c 6, B1 6 per frame, B2a 0),
                output checks, warm ms/frame and the transformer span beside
                phase 4's unfused ones, peak memory, busy share, the pair PSNR
                of fused against unfused; the fused transformer on the card
                against the CPU on a small pair; the matcher alone at the train
                shape (batch 12, 256x480) fused and unfused (B2b 24, B2c 12 per
                call); the drift gate (tools/deep_gate.py, 544x960, 31
                distortions) for DMSCT ``fused`` and DCMCS3DI ``bf16`` (a
                failing one, and DCMCS3DI ``bf16`` always, again with the
                weights of seeds 1 and 2); the
                fused route's drift stage by stage (transformer, flow, image).
                A gate verdict is reported, not asserted; every gate row must
                be finite.
 10. train dcmcs3di — runs before phase 9, which reads its checkpoint:
                ``fit --config configs/dcmcs3di.yaml`` through the CLI at the
                recipe's full width (18 extraction and 6 transfer ResB
                blocks, 64 channels; batch 8, 160x320 crops, f32 with TF32
                off) on a synthetic set of 16 train and 4 validation pairs at
                288x512 (2 steps an epoch, 3 epochs), once with the chunked
                training matcher and once with the materialised one: warm
                ms/step (steps 2-6; step 1 apart), peak memory, no kernel
                launched, finite losses, every parameter moved, the
                checkpoints; device ms by span (targets, forward+loss,
                backward, optimizer), busy share and top kernels of one
                step; each f32 conv's cuDNN time at the recipe's shape; the
                two matchers on one batch (the loss 1e-5 relative, each
                gradient rtol 2e-4 atol 1e-5, JAX's lines); the step at (2,
                32, 64) against float64 (phase 7's rule); ``predict`` from
                the best checkpoint.
  9. test     — the paper's evaluation through ``test``: the five classical
                methods (configs/others.yaml) and DMSCT (configs/dmsct.yaml,
                random init) on a synthetic 1080p set (one Test/ pair, 31
                items; Real-World Test/ two triplets), DCMCS3DI from phase
                10's checkpoint on a 544x960 set (and a 520x900 scene)
                natively and with ``--eval_buckets 64``: every metric of
                both loaders finite, exact launches (DMSCT 6 B1, IDT 4 B3,
                grading 4 B3 and 6 B4 an item, none otherwise), ms an item
                by the host clock, the data / forward / metrics spans, peak
                memory, busy share and host syncs an item; MK's means
                against a per-item recomputation; Reinhard, CCS and MK on a
                64x96 set on the card against the CPU; the bucketed
                DCMCS3DI metrics against the native ones.
 11. assets   — runs after phase 9, on its sets: the image decoder that
                runs (native or PIL, with the build's error), the native
                decoder bit-equal to PIL on the 1080p PNGs, whole and
                cropped, a 1080p decode and a 160x320 crop timed both ways,
                MK's `test` item with each decoder; reference-layout
                checkpoints fabricated from seeded weights (full-width DMSCT
                and DCMCS3DI Lightning .ckpt files, unimatch's .pth layout
                with its upsampler) read strictly and bit-equal to their
                source, the restored DMSCT's 1080p output bit-equal to the
                source weights'; the parity sweep (tools/parity_sweep.py)
                of the four classical methods and DMSCT on the 1080p set and
                DCMCS3DI bucketed on the 544x960 set, its table, exact B1,
                B3 and B4 launches; DMSCT and DCMCS3DI image panels through
                the Trainer's panel logger; a torch.profiler trace
                (utils/profiling.py) of two DMSCT 1080p serve steps that
                names B1's kernel.
Phases 7 and 10 also hold every distinct f32 conv of their recipe's train
step, at the recipe's shape, to float64 (tools/conv_grads.py) and time the
step with the backward through cuDNN and through ATen.
The line before the last is a JSON object with per-kernel results (each
kernel's time, its plain version's, a library call's where one computes
the same function, and its bound on the card: the larger of its bytes over
3.35 TB/s and its operations over the data-sheet rate of their type); the
last line is {"ok": true, "device": {...}}.
"""

import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
KERNELS = ("local_corr", "resb_chain", "row_attention", "idt_apply", "regrain_stencil",
           "warp_adjoint", "win_attention", "win_sublayer", "win_ffn")
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
# B4's six calls of an 8-frame 1080p chunk: (frames, H, W, sweeps), the
# pyramid of methods/iterative.py (NBITS = 4, 16, 32, 64, 64, 64).
REGRAIN_LEVELS = tuple((CLASSICAL_FRAMES, h, w, n) for h, w, n in (
    (1080, 1920, 4), (540, 960, 16), (270, 480, 32), (135, 240, 64), (68, 120, 64),
    (34, 60, 64)))
# B3 and B4 against their plain versions: the kernels round operation by
# operation as the plain versions do (IEEE division, no FMA contraction), so
# they agree to rounding: B3 within 1e-6 * bins (bin units; 4 ulps at the top
# value 255), B4 within 1e-6 of max(1, max|ref|) and bit-equal.
B3_LINE, B4_LINE = 1e-6, 1e-6
# Card against CPU on a small clip. The linear methods: 1e-4 (sums over the
# frame in another order, cuSOLVER's eigensolver against LAPACK's). IDT and
# grading are chaotic under rounding (a sample within an ulp of a bin edge
# moves to the next bin, and one table entry by up to a bin): one bin of the
# joint range of [0, 1]^3 projections, sqrt(3)/255, at most, and 1e-4 on
# average, the lines of the CPU tests against JAX.
SMALL_LINEAR_ATOL = 1e-4
SMALL_IDT_MAX, SMALL_IDT_MEAN = 3**0.5 / 255, 1e-4
# NVIDIA H100 SXM data-sheet peaks at its 700 W limit (dense): device memory
# 3.35 TB/s; 67 TFLOP/s in float32 outside the tensor cores, 495 TFLOP/s in
# TF32 and 989 TFLOP/s in bf16 on them. A kernel's bound is the larger of its bytes (each input read
# once, each output written once) over the memory rate and its operations
# over the rate of their type.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12}
# DMSCT training at the configs/dmsct.yaml recipe: batch 12, 256x480 crops;
# the corrector's warp levels 1-4 (B, H, W, C) on efficientnet-b2.
TRAIN_BATCH, TRAIN_CROP = 12, (256, 480)
B7_SHAPES = ((12, 128, 240, 32), (12, 64, 120, 24), (12, 32, 60, 48), (12, 16, 30, 120))
# B7 against its plain version: float atomics add in an order that changes
# from run to run, so sums of up to hundreds of f32 terms (clamped samples
# pile onto the border corners) round differently: 1e-5 of max(1, max|ref|).
B7_LINE = 1e-5
# The corrector's train step on the card against the CPU (the matcher's
# output fed to both): loss within 1e-5 relative; each gradient's distance
# from a float64 run of the step, relative to its tensor's max|ref| (floored
# at 1e-2 of the model's largest gradient: a BatchNorm bias that feeds only
# train-mode BatchNorms has a gradient that vanishes analytically), at most
# TRAIN_F64_RATIO times the CPU float32 run's distance plus 1e-5. The
# backward of flow_warp_batched against autograd: 1e-4 of scale.
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_F64_RATIO = 1e-5, 1e-4, 4.0
# The fused window ops (B2) at (windows, L, C) with their swin geometry (k,
# hs, ws). The matcher's 1/4 scale holds 4 images (the bidirectional pair,
# each view as source): 1080p gives 4 x 64 windows of 16x28 tokens; the
# train shape (batch 12 at 256x480) 2B = 24 images at 1/8 and 4B = 48 at
# 1/4. Then the 1/4 scales at half the windows, and a ragged shape (L not a
# multiple of the kernels' 32-row tiles).
B2_SHAPES = (((256, 448, 128), (8, 16, 28)), ((96, 480, 128), (2, 16, 30)),
             ((3072, 120, 128), (8, 8, 15)), ((128, 448, 128), (8, 16, 28)),
             ((1536, 120, 128), (8, 8, 15)), ((8, 35, 128), (2, 5, 7)))
B2_TIMED = ((256, 448, 128), (128, 448, 128))  # the row's shape first
B2_FFN = 1024  # 2 d_model x 4
# Launches of the fused route per 1080p frame: 6 blocks at 1/4 scale, each a
# self- and a cross-attention sublayer and one FFN (the 1/8 scale's L = 1792
# fails JAX's guard and stays unfused); B1 as in phase 4.
B2B_PER_FRAME, B2C_PER_FRAME = 12, 6
GATE_HEIGHT, GATE_WIDTH = 544, 960


def bound(bytes_moved, ops):
    """(bound_ms, bound_by) for ``bytes_moved`` bytes and ``ops`` {type:
    operations}."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = max((n / PEAK_OPS_PER_S[k] * 1e3 for k, n in ops.items()), default=0.0)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _with_bound(row, bytes_moved, ops, library_ms):
    row["bound_ms"], row["bound_by"] = bound(bytes_moved, ops)
    row["library_ms"] = library_ms
    _log(f"{row['name']}: bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
         f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
         f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}")
    return row


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
                entry = re.search(r"Compiling entry function '\w*?\d(row_attention_bf16|"
                                  r"row_attention_f32|conv3x3_bf16|conv3x3_f32|"
                                  r"window_attention_kernel|sublayer_kernel|"
                                  r"kv_projection_kernel|ffn_kernel|pack_weights_kernel|"
                                  r"warp_adjoint_kernel)((?:I(?:L[ib]\d+E)+)?)", line)
                if entry:  # e.g. row_attention_bf16 ILi64ELb1ELb0E: <C = 64, out, no colsum>
                    _log(f"  {entry.group(1)} {entry.group(2)}")
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


def _smooth_flow(b, h, w, device):
    """A slowly varying field that moves every window well inside the image
    (the staged route's case)."""
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    flow = torch.stack([3.5 + 0.3 * torch.sin(yy / 5.0) - 0.02 * xx,
                        -2.25 + 0.2 * torch.cos(xx / 7.0)], -1)
    return flow[None].repeat(b, 1, 1, 1).to(device).contiguous()


def _step_flow(g, b, h, w, device):
    """Smooth on the left half of the image, mixed on the right: both of
    B1's routes in one call."""
    left = torch.arange(w, device=device)[None, None, :, None] < w // 2
    return torch.where(left, _smooth_flow(b, h, w, device), _mixed_flow(g, b, h, w, device))


def _b1_bound(f0, flow, r):
    """B1's bound on these inputs: f0, f1 and the flow read once, the
    (2r+1)^2 outputs written once; the (2r+2)^2 window's C-channel dots of
    the pixels whose window touches the image (the others compute
    nothing). No single library call computes it."""
    from color_transfer_tpu_torch.ops import local_corr as lc

    b, h, w, c = f0.shape
    px = b * h * w
    live = int(lc.window_starts(flow, r)[4].sum())
    return 4 * (2 * px * c + 2 * px + px * (2 * r + 1) ** 2), {"f32": live * (2 * r + 2) ** 2 * 2 * c}


def _window_reuse(flow, r):
    """Over the 8 x 8 tiles of B1's plan with a live pixel: the median
    count of in-image taps its windows read, of the distinct positions they
    read (what a tile's staging would need to hold), and of its box's
    positions (what the kernel stages when it fits the budget); and the
    taps over the distinct positions summed over all those tiles."""
    from color_transfer_tpu_torch.ops import local_corr as lc

    b, h, w, _ = flow.shape
    k = 2 * r + 2
    plan = lc.launch_plan(128, r)
    sx, sy, _, _, live = lc.window_starts(flow, r)
    ty, tx = -(-h // plan.tile_h), -(-w // plan.tile_w)
    ys = torch.arange(h, device=flow.device)[None, :, None] // plan.tile_h
    xs = torch.arange(w, device=flow.device)[None, None, :] // plan.tile_w
    tile = (torch.arange(b, device=flow.device)[:, None, None] * ty + ys) * tx + xs
    off = torch.arange(k, device=flow.device)
    yy = sy[..., None, None] + off[:, None]
    xx = sx[..., None, None] + off[None, :]
    read = live[..., None, None] & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
    tiles = tile[..., None, None].expand_as(read)[read]
    keys = torch.unique(tiles * (h * w) + (yy * w + xx)[read])
    n = b * ty * tx
    taps = torch.bincount(tiles, minlength=n)
    distinct = torch.bincount(keys // (h * w), minlength=n)
    boxes = lc.tile_boxes(flow, r, plan)
    used = taps > 0
    box = (boxes["w"] * boxes["h"]).flatten()[used]
    return (float(taps[used].float().median()), float(distinct[used].float().median()),
            float(box.float().median()), float(taps.sum() / distinct.sum()), plan.budget)


def check_b1(f0, f1, flow, r, label):
    """B1 against its plain version on these inputs: the kernel's route of
    each tile (held to ``tile_boxes``, the Python statement of its choice),
    two runs bit-equal, the error on the KERNEL_RTOL line; both timed.
    Returns (err, ms, plain_ms, staged share)."""
    from color_transfer_tpu_torch.ops import local_corr as lc

    with torch.no_grad():
        got, routes = lc._launch(f0, f1, flow, r, routes=True)
        again = lc._launch(f0, f1, flow, r)
        want = lc.local_correlation_with_flow_plain(f0, f1, flow, r)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        staged = lc.tile_boxes(flow, r, lc.launch_plan(f0.shape[-1], r))["staged"]
        if not torch.equal(routes.bool(), staged):
            raise AssertionError(f"local_corr {label}: the kernel's routes are not tile_boxes'")
        if not torch.equal(got, again):
            raise AssertionError(f"local_corr {label}: two runs differ")
        ms = _time_ms(lambda: lc.local_correlation_with_flow(f0, f1, flow, r))
        plain_ms = _time_ms(lambda: lc.local_correlation_with_flow_plain(f0, f1, flow, r),
                            iters=5)
    share = float(routes.float().mean())
    bound_ms, bound_by = bound(*_b1_bound(f0, flow, r))
    _log(f"local_corr {label} {tuple(f0.shape)} r={r}: max|d|={err:.3e} (line "
         f"{KERNEL_RTOL * scale:.3e}), staged tiles {share:.4f}, two runs bit-equal, kernel "
         f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms")
    if not np.isfinite(err) or err > KERNEL_RTOL * scale:
        raise AssertionError(f"local_corr kernel disagrees at {label}: {err}")
    return err, ms, plain_ms, share


def check_kernels():
    """Kernel against plain version on the card. Returns per-kernel rows
    (without the launch count, which the serving run fills in; B1's time is
    the served flow's, which phase 4 fills in too)."""
    g = torch.Generator().manual_seed(0)
    row = None
    # B1 at the 1080p matcher shape on three flows (the mixed flow sends
    # almost every tile to the per-pixel route, the smooth flow every tile
    # to the staged route, the step both), at the training shape, and at a
    # ragged small shape.
    for shape, kinds in (((2, 128, 224, 128, 4), ("mixed", "smooth", "step")),
                         ((24, 64, 120, 128, 4), ("mixed", "smooth")),
                         ((1, 13, 37, 16, 1), ("mixed", "smooth"))):
        b, h, w, c, r = shape
        f0 = torch.randn(b, h, w, c, generator=g).cuda()
        f1 = torch.randn(b, h, w, c, generator=g).cuda()
        for kind in kinds:
            flow = {"mixed": lambda: _mixed_flow(g, b, h, w, "cuda"),
                    "smooth": lambda: _smooth_flow(b, h, w, "cuda"),
                    "step": lambda: _step_flow(g, b, h, w, "cuda")}[kind]()
            err, ms, plain_ms, share = check_b1(f0, f1, flow, r, f"{kind} flow")
            if shape[0] == 2 and kind == "mixed" and share > 0.05:
                raise AssertionError(f"the mixed flow staged {share:.3f} of the tiles")
            if kind == "smooth" and share != 1.0:
                raise AssertionError(f"the smooth flow staged {share:.3f} of the tiles")
            if kind == "step" and not 0.3 < share < 0.7:
                raise AssertionError(f"the step flow staged {share:.3f} of the tiles")
            if row is None:
                row = {"name": "local_correlation_with_flow", "route": "cuda",
                       "source": "color_transfer_tpu_torch/csrc/local_corr.cu",
                       "replaces": "color_transfer_tpu/ops/local_corr.py:68",
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
                _with_bound(row, *_b1_bound(f0, flow, r), None)
        del f0, f1
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
    extraction chain in bf16 (BF16_CHAIN_ULPS), and ragged small shapes at
    16, 32 and 64 channels. Times one bf16 block (two launches and the
    wrapper's casts) against its plain version, and the conv launches alone
    at the two path shapes, from the 18- and 6-block chains."""
    from color_transfer_tpu_torch.ops import conv_chain as cc

    row = None
    cases = (
        ((2, HEIGHT, WIDTH, CHANNELS), 1, torch.float32),
        ((2, HEIGHT, WIDTH, CHANNELS), 1, torch.bfloat16),
        ((2, HEIGHT, WIDTH, CHANNELS), EXTRACTION_LAYERS, torch.bfloat16),
        ((1, 13, 37, 16), 2, torch.float32),
        ((1, 13, 37, 16), 2, torch.bfloat16),
        ((2, 25, 70, 32), 2, torch.bfloat16),
        ((1, 40, 100, 64), 1, torch.bfloat16),
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
        if layers == 1 and shape[1] == HEIGHT:
            with torch.no_grad():
                ms = _time_ms(lambda: cc.resb_chain(x, k, b, cd), iters=5)
                plain_ms = _time_ms(lambda: cc.resb_chain_plain(x, k, b, cd), iters=5)
            msg += f" per block: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
        _log(msg)
        if not np.isfinite(err) or err > line:
            raise AssertionError(f"resb_chain kernel disagrees at {shape}, {cd}: {err}")
        if layers == 1 and shape[1] == HEIGHT and cd == torch.bfloat16:  # the serving recipe's block
            row = {
                "name": "resb_chain",
                "route": "cuda",
                "source": "color_transfer_tpu_torch/csrc/resb_chain.cu",
                "replaces": "color_transfer_tpu/ops/conv_chain.py:100",
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
            }
            # x read and the block's output written (f32), two 3x3 convs of
            # bf16 products. Library: the block's two convolutions in cuDNN,
            # bf16, channels-last (without its elementwise epilogue).
            n, hh, ww, c = shape
            _with_bound(row, 4 * (2 * x.numel() + k.numel() + b.numel()),
                        {"bf16": 2 * n * hh * ww * c * c * 9 * 2},
                        _cudnn_block_ms(x, k, b))
        del x, got, want
    # The conv launches alone, at the path's two shapes: the difference of a
    # long and a one-block chain (the wrapper's casts cancel) over the
    # launches between them.
    for shape, layers in (((2, HEIGHT, WIDTH, CHANNELS), EXTRACTION_LAYERS),
                          ((1, HEIGHT, WIDTH, CHANNELS), TRANSFER_LAYERS)):
        x = torch.randn(*shape, generator=g).cuda()
        k, b = _chain_weights(g, layers, CHANNELS)
        with torch.no_grad():
            long_ms = _time_ms(lambda: cc.resb_chain(x, k, b, torch.bfloat16), iters=3)
            one_ms = _time_ms(lambda: cc.resb_chain(x, k[:1], b[:1], torch.bfloat16), iters=5)
            cast_ms = _time_ms(lambda: x.to(torch.bfloat16), iters=5)
            mma_long = _time_ms(lambda: cc._launch(x, k, b, torch.bfloat16, mma_sync=True), iters=3)
            mma_one = _time_ms(
                lambda: cc._launch(x, k[:1], b[:1], torch.bfloat16, mma_sync=True), iters=5)
        per_launch = (long_ms - one_ms) / (2 * (layers - 1))
        mma_launch = (mma_long - mma_one) / (2 * (layers - 1))
        flop = 2 * x.numel() * CHANNELS * 9
        _log(f"resb_chain {shape} bf16: {layers}-block chain {long_ms:.3f} ms, one block "
             f"{one_ms:.3f} ms (of it the f32 input's cast ~{cast_ms:.3f} ms), per conv launch "
             f"{per_launch:.4f} ms = {flop / per_launch / 1e9:.0f} TFLOP/s (wgmma); through "
             f"the mma.sync kernel {mma_launch:.4f} ms")
        row[f"ms_per_launch_batch{shape[0]}"] = per_launch
        del x
    _log(f"resb_chain: cuDNN's bf16 conv {row['library_ms'] / 2:.4f} ms per conv at "
         f"(2, {HEIGHT}, {WIDTH}, {CHANNELS})")
    return row


def _cudnn_block_ms(x, k, b):
    """Two cuDNN bf16 channels-last 3x3 convs at the block's shape."""
    import torch.nn.functional as F

    xc = x.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    ws = [k[0, j].permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last) for j in range(2)]
    bs = [b[0, j].to(torch.bfloat16) for j in range(2)]

    def block():
        y = F.conv2d(xc, ws[0], bs[0], padding=1)
        return F.conv2d(y, ws[1], bs[1], padding=1)

    with torch.no_grad():
        return _time_ms(block, iters=5)


def check_row_attention(g):
    """B5 against its plain version on a 16-row band of the 1080p matcher
    shape and on ragged small shapes (W not a multiple of the 64-key tile or
    of the 128-query group), bf16 operands and precise (f32), in all three
    instantiations: out and column sums, column sums only, out only.
    Lines: out within KERNEL_RTOL of max(1, max|ref|) in precise mode (f32
    on both sides); in bf16 within 2^-8 max|v|, the bound if every att
    entry's bf16 rounding flipped by an ulp (sum of att is 1); colsum
    within KERNEL_RTOL of max(1, max|ref|) (f32 att on both sides). A second
    run must be bit-equal (the column sums use no atomics). Times each
    instantiation at the full (1, 1080, 1920, 64) shape beside its bound,
    the plain version (which runs in bands of rows) and the library call."""
    from color_transfer_tpu_torch.ops import row_attention as ra

    err_bf16 = None
    for shape in ((1, 16, WIDTH, CHANNELS), (2, 5, 97, 32), (1, 3, 200, 16), (2, 2, 50, 64)):
        # q and k of std 3: scores of std ~1.1 at scale 1/C, peaked rows.
        q, k = (3 * torch.randn(*shape, generator=g)).cuda(), (3 * torch.randn(*shape, generator=g)).cuda()
        v = torch.randn(*shape, generator=g).cuda()
        scale = 1.0 / shape[-1]
        for precise in (False, True):
            with torch.no_grad():
                out, cs = ra.row_attention_warp(q, k, v, scale, precise)
                none, cs_only = ra.row_attention_warp(q, k, None, scale, precise)
                out_only, no_cs = ra._attend(q, k, v, scale, precise, colsum=False)
                again = ra.row_attention_warp(q, k, v, scale, precise)
                want_out, want_cs = ra.row_attention_warp_plain(q, k, v, scale, precise)
            torch.cuda.synchronize()
            if none is not None or no_cs is not None:
                raise AssertionError("row_attention: an instantiation returned what it skips")
            if not (torch.equal(out, again[0]) and torch.equal(cs, again[1])):
                raise AssertionError(f"row_attention: two runs differ at {shape}")
            err = max(float((out - want_out).abs().max()),
                      float((out_only - want_out).abs().max()))
            err_cs = max(float((cs - want_cs).abs().max()),
                         float((cs_only - want_cs).abs().max()))
            line = (KERNEL_RTOL * max(1.0, float(want_out.abs().max())) if precise
                    else 2.0 ** -8 * float(v.abs().max()))
            line_cs = KERNEL_RTOL * max(1.0, float(want_cs.abs().max()))
            _log(f"row_attention {shape} {'precise' if precise else 'bf16'}: out "
                 f"max|d|={err:.3e} (line {line:.3e}), colsum max|d|={err_cs:.3e} "
                 f"(line {line_cs:.3e}); both, colsum only and out only; two runs bit-equal")
            if not (err <= line and err_cs <= line_cs):
                raise AssertionError(f"row_attention kernel disagrees at {shape}")
            if err_bf16 is None and not precise:
                err_bf16 = err
    shape = (1, HEIGHT, WIDTH, CHANNELS)
    q, k, v = (torch.randn(*shape, generator=g).cuda() for _ in range(3))
    scale = 1 / CHANNELS
    with torch.no_grad():
        ms = _time_ms(lambda: ra.row_attention_warp(q, k, v, scale), iters=3)
        ms_cs = _time_ms(lambda: ra.row_attention_warp(q, k, None, scale), iters=3)
        ms_out = _time_ms(lambda: ra._attend(q, k, v, scale, False, colsum=False), iters=3)
        plain_ms = _time_ms(lambda: ra.row_attention_warp_plain(q, k, v, scale), iters=3)
        precise_ms = {
            name: _time_ms(lambda: ra._attend(q, k, vv, scale, True, colsum=cs), iters=2)
            for name, vv, cs in (("both", v, True), ("colsum only", None, True),
                                 ("out only", v, False))}
        # The tail: blocks per image row (1080 one-row blocks at 2 an SM are
        # 4.09 waves), bf16 operands given, so without the wrapper's casts.
        qh, kh, vh = (t.to(torch.bfloat16) for t in (q, k, v))
        tail = {splits: [_time_ms(lambda: ra._launch(qh, kh, vv, scale, False, cs, splits),
                                  iters=3)
                         for vv, cs in ((vh, True), (None, True), (vh, False))]
                for splits in (1, 5, 15)}
    _log("row_attention blocks per row (both / colsum only / out only, ms, bf16 given): "
         + "; ".join(f"{n}: " + " / ".join(f"{t:.3f}" for t in ts) for n, ts in tail.items()))
    del qh, kh, vh
    # Library: scaled_dot_product_attention over the rows (the att.v half;
    # no column sums, and at full width no column mask), bf16, scale 1/C.
    qb, kb, vb = (t.reshape(HEIGHT, 1, WIDTH, CHANNELS).to(torch.bfloat16) for t in (q, k, v))
    with torch.no_grad():
        library_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qb, kb, vb, scale=scale), iters=3)
    row = {
        "name": "row_attention_warp",
        "route": "cuda",
        "source": "color_transfer_tpu_torch/csrc/row_attention.cu",
        "replaces": "color_transfer_tpu/ops/row_attention.py:35",
        "max_abs_err": err_bf16,
        "ms": ms,
        "plain_ms": plain_ms,
        "ms_colsum_only": ms_cs,
        "ms_out_only": ms_out,
    }
    # q, k (and v) read (f32), out and/or the column sums written; the
    # function needs q.k once and att.v once, as bf16 products on the tensor
    # cores, 2 W^2 C operations each per row (the kernel's two sweeps run q.k
    # twice: its own count is one product more). The row's bound is the
    # public call's (both).
    rows_px, product = HEIGHT * WIDTH, 2 * HEIGHT * WIDTH * WIDTH * CHANNELS
    _log(f"row_attention {shape} bf16: both {ms:.3f} ms, colsum only {ms_cs:.3f} ms, "
         f"out only {ms_out:.3f} ms; precise: " + ", ".join(
             f"{n} {t:.3f} ms" for n, t in precise_ms.items()))
    for name, t, reads, writes, products in (
            ("out only", ms_out, 3, CHANNELS, 2), ("colsum only", ms_cs, 2, 1, 1)):
        b_ms, by = bound(4 * rows_px * (reads * CHANNELS + writes), {"bf16": products * product})
        swept, _ = bound(0, {"bf16": (products + 1) * product})
        _log(f"row_attention {name}: bound {b_ms:.4f} ms ({by}; {swept:.4f} ms for the two "
             f"sweeps' products), kernel {t:.4f} ms")
        row[f"bound_ms_{name.replace(' ', '_')}"] = b_ms
    return _with_bound(row, 4 * (4 * rows_px * CHANNELS + rows_px),
                       {"bf16": 2 * product}, library_ms)


def _wrappers():
    """The kernel wrappers, each with its ``launches`` count."""
    from color_transfer_tpu_torch.ops import (
        conv_chain,
        idt_apply,
        local_corr,
        regrain_stencil,
        row_attention,
        warp_adjoint,
        win_attention,
    )

    return (local_corr.local_correlation_with_flow, conv_chain.resb_chain,
            row_attention.row_attention_warp, idt_apply.transport_apply,
            regrain_stencil.regrain_sweeps, warp_adjoint.warp_adjoint,
            win_attention.window_attention_fused, win_attention.window_sublayer_fused,
            win_attention.ffn_fused)


def _reset_launches():
    for fn in _wrappers():
        fn.launches = 0
        if hasattr(fn, "vector_launches"):  # B7's launches on its vector path
            fn.vector_launches = 0


def _launches():
    return {fn.__name__: fn.launches for fn in _wrappers()}


def _dmsct_pairs():
    """Smooth synthetic scenes: a low-frequency field upsampled to 1080p, the
    reference a shifted, colour-distorted copy of the target."""
    rng = np.random.default_rng(0)
    low = rng.uniform(0, 1, (FRAMES, 3, 34, 60)).astype(np.float32)
    scene = torch.nn.functional.interpolate(
        torch.from_numpy(low), size=(HEIGHT, WIDTH + 16), mode="bilinear",
        align_corners=False,
    ).permute(0, 2, 3, 1)
    target = scene[:, :, :WIDTH].contiguous()
    reference = (scene[:, :, 16:] * 0.9 + 0.05).clamp(0, 1).contiguous()
    return target, reference


def serve(rows):
    """Full-width DMSCT (unfused, the default) on the two 1080p pairs.
    Returns (module, variables, target, reference, numbers): the output on
    the CPU, warm ms/frame, the transformer's device ms/frame, peak GiB."""
    from color_transfer_tpu_torch.methods.video import color_transfer_between_videos
    from color_transfer_tpu_torch.run.modules import DMSCTModule

    module = DMSCTModule()  # full width: the reference DMSCT recipe
    variables = module.init_eval_variables(seed=0, device="cuda")
    target, reference = _dmsct_pairs()

    from color_transfer_tpu_torch.models import gmflow
    from color_transfer_tpu_torch.ops import local_corr

    served = []  # the first B1 call's arguments: the flow the GRU loop gives it
    call = gmflow.local_correlation_with_flow

    def keep(f0, f1, flow, local_radius):
        if not served:
            served.extend([t.clone() for t in (f0, f1, flow)] + [local_radius])
        return call(f0, f1, flow, local_radius)

    _reset_launches()
    gmflow.local_correlation_with_flow = keep
    try:
        out = color_transfer_between_videos(
            target, reference, method="dmsct", module=module, variables=variables,
            device="cuda",
        )
    finally:
        gmflow.local_correlation_with_flow = call
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
    # B1 on the flow the served frame's GRU loop gave its first call: the
    # row's time and bound.
    f0, f1, flow, r = served
    err, ms, plain_ms, share = check_b1(f0, f1, flow, r, "served flow")
    live = float(local_corr.window_starts(flow, r)[4].float().mean())
    taps, distinct, box, reuse, budget = _window_reuse(flow, r)
    _log(f"serve: B1 on the served flow: staged tiles {share:.4f}, pixels whose window "
         f"touches the image {live:.4f}; a tile with a live pixel reads a median {taps:.0f} "
         f"taps at {distinct:.0f} distinct positions (all tiles: {reuse:.2f} taps a position), "
         f"its box a median {box:.0f} positions (the budget {budget})")
    rows[0].update(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    _with_bound(rows[0], *_b1_bound(f0, flow, r), None)
    del served, f0, f1, flow
    numbers = {"out": out.cpu(), "ms_frame": ms_frame, "peak": peak,
               "transformer": stages["matcher.transformer"] / FRAMES}
    return module, variables, target, reference, numbers


# Submodules of DMSCT timed by stage (matcher.* lie inside matcher), and
# functions of the path timed where their module calls them.
STAGES = ("matcher", "matcher.backbone", "matcher.transformer",
          "matcher.feature_flow_attn", "matcher.refine", "encoder", "decoder",
          "head")
STAGE_FUNCTIONS = (
    ("matcher local_corr", "color_transfer_tpu_torch.models.gmflow",
     "local_correlation_with_flow"),
    ("corrector warps", "color_transfer_tpu_torch.models.dmsct", "flow_warp_batched"),
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


def _device_busy_ms(run, top=0, required=True):
    """Device busy ms of ``run()`` from a torch.profiler trace: the union of
    the intervals of the device events (kernels, copies, memsets) it ran.
    With ``top``, also logs the ``top`` device kernels by summed time. A
    trace without device activity raises, unless ``required`` is False
    (a figure that is only reported: then 0)."""
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
    if busy == 0.0 and required:
        raise AssertionError("the profiler recorded no device activity")
    return busy / 1e3


def _device_kernels(run, calls=3):
    """The names of the device kernels ``run()`` launches, from a
    torch.profiler trace of ``calls`` calls (reported, not checked)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


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
        want = dict.fromkeys(counts, 0)
        want.update(resb_chain=b6, row_attention_warp=2 * FRAMES)
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
                    "_attend"),),
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
            # x read, out written, the tables once; ~10 f32 operations per
            # sample. No single library call computes it.
            rows.append(_with_bound(
                {"name": "transport_apply", "route": "cuda",
                 "source": "color_transfer_tpu_torch/csrc/idt_apply.cu",
                 "replaces": "color_transfer_tpu/methods/iterative.py:137",
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms},
                4 * (2 * x.numel() + fp.numel() + 3 * lo.numel()),
                {"f32": 10 * x.numel()}, None))
        del x, got, want, args
    # B4 at the six levels of an 8-frame 1080p chunk (1080x1920 with 4
    # sweeps down to 34x60 with 64), then a ragged shape: bit-equal to the
    # plain version (torch.equal), and on the B4_LINE too.
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    err_max, bytes_total, ops_total = 0.0, 0, 0
    for frames, h, w, nbit in REGRAIN_LEVELS + ((1, 13, 22, 7),):
        out0 = torch.rand(frames, h, w, 3, generator=g).cuda()
        const = torch.rand(frames, h, w, 3, generator=g).cuda()
        phis = (torch.rand(frames, 4, h, w, generator=g) * 15).cuda()
        inv_den = (0.8 / (phis.sum(dim=1) + 1.0)).contiguous()
        args = (out0, const, phis, inv_den, nbit)
        got, want = rs.regrain_sweeps(*args), rs.regrain_sweeps_plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        line = B4_LINE * max(1.0, float(want.abs().max()))
        if not (torch.equal(got, want) and err <= line):
            raise AssertionError(f"regrain_sweeps kernel disagrees at {(frames, h, w, nbit)}: "
                                 f"{err} (bit-equal required)")
        ms = _time_ms(lambda: rs.regrain_sweeps(*args))
        plain_ms = _time_ms(lambda: rs.regrain_sweeps_plain(*args), iters=5)
        # out0, const, the four phis and inv_den read once, out written once;
        # ~12 f32 operations per pixel, channel and sweep. No single library
        # call computes it.
        nbytes = 4 * (3 * out0.numel() + phis.numel() + inv_den.numel())
        ops = 12 * out0.numel() * nbit
        bound_ms, bound_by = bound(nbytes, {"f32": ops})
        plan = rs.launch_plan(h, w, nbit)
        _log(f"regrain_sweeps (B4) ({frames}, {h}, {w}, 3) nbit {nbit}: bit-equal, max|d|="
             f"{err:.3e} (line {line:.3e}); kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
             f"({bound_by}), plain {plain_ms:.4f} ms; "
             f"{plan.route}, {plan.passes} launch(es), {plan.sweeps} sweeps a pass, "
             f"{plan.tile_h}x{plan.tile_w} {'tiles' if plan.route == 'trapezoid' else 'rows a block'}"
             + (f", clusters of {plan.cluster}" if plan.route == "cluster" else ""))
        if frames == CLASSICAL_FRAMES:
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms)):
                totals[key] += v
            err_max, bytes_total, ops_total = max(err_max, err), bytes_total + nbytes, ops_total + ops
        del out0, const, phis, inv_den, got, want, args
    _log(f"regrain_sweeps (B4) an 8-frame 1080p chunk's six calls: kernel {totals['ms']:.4f} ms, "
         f"bound {totals['bound_ms']:.4f} ms, plain {totals['plain_ms']:.4f} ms")
    # The row: the chunk's six calls (the main path's work), beside the sum of
    # their bytes and operations' bound.
    rows.append(_with_bound(
        {"name": "regrain_sweeps", "route": "cuda",
         "source": "color_transfer_tpu_torch/csrc/regrain_stencil.cu",
         "replaces": "color_transfer_tpu/ops/regrain_stencil.py:27",
         "max_abs_err": err_max, "ms": totals["ms"], "plain_ms": totals["plain_ms"]},
        bytes_total, {"f32": ops_total}, None))
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


def _b7_flow(g, kind, b, h, w):
    """The mixed flow (the row's), its sub-pixel kind alone (in the image),
    or its far kind alone (every sample clamped to the border)."""
    if kind == "mixed":
        return _mixed_flow(g, b, h, w, "cuda")
    if kind == "in-image":
        return (torch.randn(b, h, w, 2, generator=g) * 3.0).cuda()
    return (torch.sign(torch.randn(b, h, w, 2, generator=g)) * (
        60.0 + torch.rand(b, h, w, 2, generator=g) * 500.0)).cuda()


def check_warp_adjoint(g):
    """B7 against its plain version at the four training levels and at
    ragged shapes (C = 5 and 7: the scalar path) on mixed sub-pixel, zero and
    clamped flows, line B7_LINE. At the four levels each is timed (CUDA
    events; the kernel's time holds the zeroing of the padded buffer) with
    the plain version and one ``index_add_`` of the pre-weighted corner
    updates into the flattened padded buffer (the library's part alone, as
    the row has always counted it; ``zero_`` + ``index_add_`` printed
    beside it), on the mixed flow (the row), an in-image flow and an
    all-clamped one. Then the backward of flow_warp_batched against torch's
    autograd of the plain gather. Returns B7's row: times summed over one
    train step's four launches, mixed flow."""
    from color_transfer_tpu_torch.core.sampling import flow_warp, flow_warp_batched
    from color_transfer_tpu_torch.ops import warp_adjoint as wa

    kinds = ("mixed", "in-image", "clamped")
    totals = {k: dict.fromkeys(("ms", "plain_ms", "library_ms", "zero_library_ms"), 0.0)
              for k in kinds}
    worst, moved, ops = 0.0, 0, 0
    for shape in B7_SHAPES + ((2, 13, 37, 5), (1, 9, 11, 7)):
        b, h, w, c = shape
        gr = torch.randn(*shape, generator=g).cuda()
        for kind in kinds if shape in B7_SHAPES else ("mixed",):
            flow = _b7_flow(g, kind, b, h, w)
            vec_before = wa.warp_adjoint.vector_launches
            got = wa.warp_adjoint(gr, flow)
            want = wa.warp_adjoint_plain(gr, flow)
            torch.cuda.synchronize()
            if wa.warp_adjoint.vector_launches - vec_before != int(c % 4 == 0):
                raise AssertionError(f"warp_adjoint {shape}: the wrong path ran")
            err = float((got - want).abs().max())
            scale = max(1.0, float(want.abs().max()))
            line = B7_LINE * scale
            msg = (f"warp_adjoint (B7) {shape} {kind}: max|d|={err:.3e} (line {line:.3e}, "
                   f"relative {err / scale:.2e})")
            if not np.isfinite(err) or err > line:
                raise AssertionError(f"warp_adjoint kernel disagrees at {shape} {kind}: {err}")
            if shape in B7_SHAPES:
                rows, weights = wa.warp_corners(flow, h, w)
                index = rows[..., None] + torch.tensor([0, 1, w + 4, w + 5], device="cuda")
                index = index.reshape(-1)
                updates = (weights[..., None] * gr[..., None, :]).reshape(-1, c)
                padded = torch.zeros(b * (h + 4) * (w + 4), c, device="cuda")
                t = totals[kind]
                ms = _time_ms(lambda: wa.warp_adjoint(gr, flow))
                plain_ms = _time_ms(lambda: wa.warp_adjoint_plain(gr, flow), iters=5)
                library_ms = _time_ms(lambda: padded.index_add_(0, index, updates))
                zero_ms = _time_ms(lambda: padded.zero_().index_add_(0, index, updates))
                busy_ms = _device_busy_ms(lambda: wa.warp_adjoint(gr, flow), required=False)
                msg += (f" kernel {ms:.4f} ms (device busy in one call {busy_ms:.4f}), plain "
                        f"{plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms, zero_ + "
                        f"index_add_ {zero_ms:.4f} ms")
                for key, val in zip(t, (ms, plain_ms, library_ms, zero_ms)):
                    t[key] += val
                if kind == "mixed":
                    worst = max(worst, err)
                    # g and flow read once, the padded gradient written once;
                    # per (pixel, channel) four weight products and four adds.
                    moved += 4 * (gr.numel() + flow.numel() + b * (h + 4) * (w + 4) * c)
                    ops += 8 * gr.numel()
                del rows, weights, index, updates, padded
            _log(msg)
            del flow, got, want
        del gr
    for kind, t in totals.items():
        _log(f"warp_adjoint (B7) one step's four levels, {kind} flow: kernel {t['ms']:.4f} ms, "
             f"plain {t['plain_ms']:.4f}, index_add_ {t['library_ms']:.4f}, zero_ + index_add_ "
             f"{t['zero_library_ms']:.4f}")
    totals = totals["mixed"]

    feat = torch.randn(2, 64, 120, 24, generator=g).cuda()
    flow = (torch.randn(2, 64, 120, 2, generator=g) * 2).cuda()
    gout = torch.randn(2, 64, 120, 24, generator=g).cuda()
    f1, fl1 = feat.clone().requires_grad_(True), flow.clone().requires_grad_(True)
    (flow_warp_batched(f1, fl1) * gout).sum().backward()
    f2, fl2 = feat.clone().requires_grad_(True), flow.clone().requires_grad_(True)
    (flow_warp(f2, fl2) * gout).sum().backward()
    e_feat = float((f1.grad - f2.grad).abs().max()) / max(1.0, float(f2.grad.abs().max()))
    e_flow = float((fl1.grad - fl2.grad).abs().max()) / max(1.0, float(fl2.grad.abs().max()))
    _log(f"flow_warp_batched backward (2, 64, 120, 24) against autograd of the plain "
         f"gather: feature {e_feat:.2e}, flow {e_flow:.2e} (relative; lines {B7_LINE}, "
         f"{TRAIN_GRAD_RTOL})")
    if not (e_feat <= B7_LINE and e_flow <= TRAIN_GRAD_RTOL):
        raise AssertionError("flow_warp_batched's backward disagrees with autograd")
    row = {"name": "warp_adjoint", "route": "cuda",
           "source": "color_transfer_tpu_torch/csrc/warp_adjoint.cu",
           "replaces": "color_transfer_tpu/core/sampling.py:155",
           "max_abs_err": worst, "ms": totals["ms"], "plain_ms": totals["plain_ms"]}
    return _with_bound(row, moved, {"f32": ops}, totals["library_ms"])


def _stereo_pair(rng, height, width, shift=24):
    """A seeded textured stereo pair: a smooth low-frequency field plus fine
    texture; the right view a shifted, colour-cast copy. float64 in [0, 1]."""
    low = torch.from_numpy(rng.uniform(0, 1, (1, 3, 9, 16)).astype(np.float32))
    field = torch.nn.functional.interpolate(
        low, size=(height, width + shift), mode="bilinear", align_corners=False)[0]
    field = field.permute(1, 2, 0).numpy()
    texture = rng.normal(0, 0.06, (height, width + shift, 1))
    scene = np.clip(field + texture, 0, 1)
    left = scene[:, :width]
    right = np.clip(scene[:, shift:] ** 1.1 * [0.92, 1.0, 0.85] + 0.03, 0, 1)
    return left, right


def _save(path, img):
    from PIL import Image

    Image.fromarray((img * 255 + 0.5).astype(np.uint8)).save(path, compress_level=1)


def _write_dataset(root, seed=0, height=288, width=512,
                   splits=(("Train", 24), ("Validation", 12))):
    """Seeded stereo pairs (``_stereo_pair``) NNNN_{L,R}.png under each
    split's directory."""
    rng = np.random.default_rng(seed)
    for split, n in splits:
        d = root / split
        d.mkdir(parents=True)
        for i in range(n):
            left, right = _stereo_pair(rng, height, width)
            _save(d / f"{i:04d}_L.png", left)
            _save(d / f"{i:04d}_R.png", right)


def train(rows):
    """Full-width DMSCT fit through the CLI (configs/dmsct.yaml: batch 12,
    crops 256x480; 2 epochs of a 24-pair set, 2 steps each), checked and
    measured; then predict from the best checkpoint."""
    from color_transfer_tpu_torch.run import cli, modules

    steps = []  # (ms, logs) per train step of the fit
    held = {}
    orig_step = modules.DMSCTModule.train_step

    def timed_step(self, state, batch, seed, metrics=True):
        if not held:  # the variables as fit built them, before any update
            held.update(module=self, state=state, start={
                k: v.detach().clone() for k, v in state.variables.items()})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_step(self, state, batch, seed, metrics)
        torch.cuda.synchronize()
        steps.append(((time.perf_counter() - t0) * 1e3, out[1]))
        held["batch"], held["seed"] = batch, seed
        return out

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        _write_dataset(root / "data")
        log_dir = root / "run"
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        modules.DMSCTModule.train_step = timed_step
        t0 = time.perf_counter()
        try:
            rc = cli.main(["fit", "--config", "configs/dmsct.yaml", "--data.data_dir",
                           str(root / "data"), "--data.image_repeats", "1",
                           "--trainer.max_epochs", "2", "--log_dir", str(log_dir)])
        finally:
            modules.DMSCTModule.train_step = orig_step
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        counts = _launches()
        if rc != 0:
            raise AssertionError(f"fit returned {rc}")
        module, state = held["module"], held["state"]
        if module.model.encoder.drop_connect_rate != 0.2:
            raise AssertionError("fit did not run the recipe's drop-connect")
        b7 = counts["warp_adjoint"]
        _log(f"train: fit {fit_s:.1f} s, {len(steps)} steps of {TRAIN_BATCH} x "
             f"{TRAIN_CROP[0]}x{TRAIN_CROP[1]}, launches {counts}")
        if len(steps) != 4 or b7 != 4 * len(steps):
            raise AssertionError(f"B7 launched {b7} times in {len(steps)} steps, expected 4 per step")
        from color_transfer_tpu_torch.ops.warp_adjoint import warp_adjoint

        b7_vector = warp_adjoint.vector_launches
        _log(f"train: B7 launches on the vector path (16-byte reductions) {b7_vector} of {b7}")
        if b7_vector != b7:
            raise AssertionError("a training level took B7's scalar path")
        if counts["local_correlation_with_flow"] < 6 * len(steps):
            raise AssertionError("the training matcher did not launch B1 six times a step")
        if any(n for name, n in counts.items() if name not in ("warp_adjoint",
                                                                "local_correlation_with_flow")):
            raise AssertionError("training launched another path's kernel")
        rows[-1]["launches"] = b7
        losses = [float(logs["Training Total Loss"]) for _, logs in steps]
        ms = [t for t, _ in steps]
        warm = ms[1:]
        _log(f"train: step ms {', '.join(f'{t:.1f}' for t in ms)}; warm "
             f"{sum(warm) / len(warm):.1f} ms/step (steps 2-4; step 1 logs the quality "
             f"metrics), peak memory {peak:.2f} GiB; losses "
             f"{', '.join(f'{v:.5f}' for v in losses)}")
        if not all(np.isfinite(losses)):
            raise AssertionError("non-finite training loss")
        start = held["start"]
        params = {name for name, _ in module.model.named_parameters()}
        changed = {"corrector": 0, "bn": 0}
        for name, value in state.variables.items():
            same = torch.equal(value.detach(), start[name])
            if name.startswith("matcher."):
                if not same:
                    raise AssertionError(f"the frozen matcher moved: {name}")
            elif name.endswith(("running_mean", "running_var")):
                changed["bn"] += not same
            elif name in params:
                changed["corrector"] += not same
        n_bn = sum(k.endswith(("running_mean", "running_var")) for k in start)
        n_corr = sum(k in params and not k.startswith("matcher.") for k in start)
        _log(f"train: matcher bit-unchanged; corrector parameters moved "
             f"{changed['corrector']}/{n_corr}, BN statistics {changed['bn']}/{n_bn}")
        if changed["corrector"] < 0.9 * n_corr or changed["bn"] != n_bn:
            raise AssertionError("the corrector or its BN statistics did not move")
        for which in ("last", "best"):
            meta = json.loads((log_dir / "checkpoints" / which / "meta.json").read_text())
            _log(f"train: checkpoints/{which}: step {meta['step']}, epoch {meta['epoch']}")
            if meta["step"] != 2 * (meta["epoch"] + 1) or (which == "last" and meta["epoch"] != 1):
                raise AssertionError(f"checkpoint {which}: {meta}")
        records = [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]
        val = [r for r in records if "Validation PSNR/dataloader_idx_0" in r]
        _log("train: step 0 logged " + ", ".join(
            f"{k} {v:.4f}" for k, v in records[0].items() if k.startswith("Training")))
        _log(f"train: validation PSNR by epoch {[round(r['Validation PSNR/dataloader_idx_0'], 4) for r in val]}")

        train_profile(module, state, held["batch"], held["seed"])

        pair = root / "pair"
        pair.mkdir()
        from PIL import Image

        for view in ("L", "R"):
            with Image.open(root / "data" / "Validation" / f"0000_{view}.png") as img:
                img.crop((0, 0, 240, 135)).save(pair / f"0000_{view}.png")
        out = root / "corrected.png"
        rc = cli.main(["predict", "--method", "dmsct", "--ckpt_path",
                       str(log_dir / "checkpoints" / "best"), "--target",
                       str(pair / "0000_L.png"), "--reference", str(pair / "0000_R.png"),
                       "--output", str(out)])
        with Image.open(out) as img:
            size = img.size
        _log(f"train: predict from checkpoints/best wrote {size[0]}x{size[1]}")
        if rc != 0 or size != (240, 135):
            raise AssertionError("predict from the best checkpoint failed")
    del held
    torch.cuda.empty_cache()


def train_profile(module, state, batch, seed):
    """One more train step of the fitted state (no quality metrics, as the
    fit's unlogged steps): device ms by span, busy share, top kernels."""
    from color_transfer_tpu_torch.ops import warp_adjoint as wa

    def step():
        module.train_step(state, batch, seed, metrics=False)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    before = wa.warp_adjoint.launches
    spans = _stage_ms(module.model, step, stages=("matcher", "encoder", "decoder", "head"),
                      functions=(("step", module, "train_step"),
                                 ("targets", module, "synthesize_targets"),
                                 ("forward+loss", module, "forward_loss"),
                                 ("optimizer", module, "apply_gradients"),
                                 ("B7", "color_transfer_tpu_torch.core.sampling",
                                  "warp_adjoint")))
    if wa.warp_adjoint.launches - before != 4:
        raise AssertionError("the profiled step did not launch B7 four times")
    corrector = spans["forward+loss"] - spans["matcher"]
    backward = spans["step"] - spans["targets"] - spans["forward+loss"] - spans["optimizer"]
    _log("train: device ms by span (one step): " + ", ".join(
        f"{k} {v:.2f}" for k, v in spans.items())
        + f"; corrector forward + loss {corrector:.2f}; backward (step less targets, "
        f"forward+loss and optimizer) {backward:.2f}")
    busy = _device_busy_ms(step, top=15)
    _log(f"train: one step {wall:.1f} ms wall, device busy {busy:.1f} ms, busy share "
         f"{busy / wall:.3f}")
    decoder_routes(module, state, batch)


def decoder_routes(module, state, batch):
    """The decoder and head at the training shape, TF32 off: the forward
    and the backward (input and weight gradients) each timed through cuDNN
    and through ATen's im2col + GEMM (cuDNN off). A train step runs the
    forward through ATen (models/dmsct.py) and the backward through cuDNN
    (run/modules.py); the other three pairings are what it is held to."""
    from color_transfer_tpu_torch.core.precision import full_f32

    model = module.model
    feats = []
    handle = model.decoder.register_forward_hook(
        lambda m, a, o: feats.extend(t.detach() for t in a))
    with torch.no_grad(), full_f32():
        torch.func.functional_call(model, state.variables,
                                   (batch["gt"], batch["reference"]))
    handle.remove()
    params = {name for name, _ in model.named_parameters()}
    sub = {k: v.detach().requires_grad_(k in params) for k, v in state.variables.items()
           if k.startswith(("decoder.", "head."))}
    dec = {k[len("decoder."):]: v for k, v in sub.items() if k.startswith("decoder.")}
    head = {k[len("head."):]: v for k, v in sub.items() if k.startswith("head.")}
    xs = [f.clone().requires_grad_(True) for f in feats]
    wrt = xs + [v for v in sub.values() if v.requires_grad]

    def forward():
        y = torch.func.functional_call(model.decoder, dec, tuple(xs))
        return torch.func.functional_call(model.head, head, (y,))

    times = {}
    for label, enabled in (("cuDNN", True), ("ATen", False)):
        with full_f32(), torch.backends.cudnn.flags(enabled=enabled, benchmark=False,
                                                     deterministic=False, allow_tf32=False):
            fwd = _time_ms(forward, iters=3)
            y = forward()
            gy = torch.ones_like(y)
            bwd = _time_ms(lambda: torch.autograd.grad(y, wrt, gy, retain_graph=True),
                           iters=3)
            del y, gy
        times[label] = (fwd, bwd)
    _log("train: decoder + head at the training shape, forward / backward ms: "
         + ", ".join(f"{k} {f:.2f} / {b:.2f}" for k, (f, b) in times.items())
         + f"; the step's route (ATen forward, cuDNN backward) "
         f"{times['ATen'][0] + times['cuDNN'][1]:.2f}")


def _corrector_step(device, dtype, batch, target, fed=None):
    """One train step of full-width DMSCT on ``device`` in ``dtype``
    (seed-0 variables, drop-connect off, the target given; the matcher's
    output ``fed`` in place of the matcher's own unless None) -> (loss,
    {name: gradient on the CPU in float64})."""
    from color_transfer_tpu_torch.run.modules import DMSCTModule

    module = DMSCTModule()
    module.model.encoder.drop_connect_rate = 0.0
    if fed is not None:
        on = {k: v.to(device, dtype) for k, v in fed.items()}
        module.model.matcher.forward = lambda *a, **k: on
    b = {k: v.to(device, dtype) for k, v in batch.items()}
    state = module.init_state(0, b, num_train_steps=10)
    state.variables = {k: v.detach().to(dtype).requires_grad_(v.requires_grad)
                       if v.is_floating_point() else v for k, v in state.variables.items()}
    state.optimizer = torch.optim.AdamW(
        [v for v in state.variables.values() if v.requires_grad], lr=module.learning_rate)
    module.synthesize_targets = lambda bb, gen, tt=target.to(device, dtype): {**bb, "target": tt}
    grads = {}
    apply_gradients = module.apply_gradients

    def record(st):
        grads.update({k: v.grad.detach().cpu().double() for k, v in st.variables.items()
                      if v.grad is not None})
        apply_gradients(st)

    module.apply_gradients = record
    _, logs = module.train_step(state, b, seed=0, metrics=False)
    return float(logs["Training Total Loss"]), grads


def check_train_small():
    """The full-width corrector's train step on the card against the CPU on
    a small crop (2 x 128x240): the matcher's output (the CPU matcher's, on
    this pair) fed to both, drop-connect off, the same targets. The
    reference is the same step on the CPU in float64: the card's float32
    gradients must be as close to it as the CPU's float32 ones (each tensor
    within TRAIN_F64_RATIO times the CPU's error plus 1e-5 of its scale),
    the loss within TRAIN_LOSS_RTOL of the CPU's. Card against CPU directly
    is reported: sums over the crop's 61k pixels, through train-mode
    BatchNorms whose backward cancels, round differently on the two."""
    from color_transfer_tpu_torch.run.modules import DMSCTModule

    t, r = _classical_clip(2, 128, 240, seed=4)
    batch = {"gt": t, "reference": r}
    target = (t ** 1.2 * 0.9 + 0.04).clamp(0, 1)
    module = DMSCTModule()
    state = module.init_state(0, batch)
    with torch.no_grad():
        fed = torch.func.functional_call(
            module.model.matcher,
            {k[len("matcher."):]: v for k, v in state.variables.items()
             if k.startswith("matcher.")},
            (target * 255.0, r * 255.0))
    fed = {k: fed[k] for k in ("flow", "fwd_occ")}
    del module, state
    loss64, g64 = _corrector_step("cpu", torch.float64, batch, target, fed)
    loss_cpu, g_cpu = _corrector_step("cpu", torch.float32, batch, target, fed)
    loss_card, g_card = _corrector_step("cuda", torch.float32, batch, target, fed)
    floor = 1e-2 * max(float(v.abs().max()) for v in g64.values())
    worst, direct, ratio_name, far_cpu, far_card = 0.0, 0.0, None, 0.0, 0.0
    for k, ref in g64.items():
        scale = max(float(ref.abs().max()), floor)
        e_cpu = float((g_cpu[k] - ref).abs().max()) / scale
        e_card = float((g_card[k] - ref).abs().max()) / scale
        far_cpu, far_card = max(far_cpu, e_cpu), max(far_card, e_card)
        direct = max(direct, float((g_card[k] - g_cpu[k]).abs().max()) / scale)
        excess = e_card / (TRAIN_F64_RATIO * e_cpu + 1e-5)
        if excess > worst:
            worst, ratio_name = excess, f"{k} (card {e_card:.2e}, CPU {e_cpu:.2e})"
    d_loss = abs(loss_card - loss_cpu) / abs(loss_cpu)
    _log(f"train: corrector step (2, 128, 240), matcher fed: loss card {loss_card:.8f}, "
         f"CPU {loss_cpu:.8f}, float64 {loss64:.8f} (card against CPU {d_loss:.2e}, line "
         f"{TRAIN_LOSS_RTOL}); gradients against float64: worst card error / "
         f"({TRAIN_F64_RATIO} x CPU error + 1e-5) = {worst:.3f} at {ratio_name} over "
         f"{len(g64)} tensors; farthest from float64: card {far_card:.2e}, CPU "
         f"{far_cpu:.2e}; card against CPU directly {direct:.2e} of scale (reported)")
    if d_loss > TRAIN_LOSS_RTOL or worst > 1.0:
        raise AssertionError("the corrector's train step on the card disagrees with the CPU")
    # End to end, each side running its own matcher: reported, not held (with
    # random weights the matcher's near one-hot softmax turns rounding into
    # another flow).
    loss_cpu, g_cpu = _corrector_step("cpu", torch.float32, batch, target)
    loss_card, g_card = _corrector_step("cuda", torch.float32, batch, target)
    e2e = max(float((g_card[k] - v).abs().max()) / max(float(v.abs().max()), floor)
              for k, v in g_cpu.items())
    _log(f"train: whole step (2, 128, 240), each side's own matcher: loss card "
         f"{loss_card:.8f}, CPU {loss_cpu:.8f} (relative "
         f"{abs(loss_card - loss_cpu) / abs(loss_cpu):.2e}); worst gradient card "
         f"against CPU {e2e:.2e} of scale (reported)")


def check_conv_grads(recipe):
    """The float64 rule at the recipe's shape (ROADMAP C5): one train step
    of ``recipe`` at its config's batch and crop, full width, and every
    distinct f32 conv of it (tools/conv_grads.py: the step's own input,
    weight and output gradient, its layout) has its input, weight and bias
    gradients recomputed on the card through cuDNN and through ATen and
    held to float64 on the CPU: the module's own route (``backward_cudnn``)
    within TRAIN_F64_RATIO times the CPU float32 error plus 1e-5 of scale,
    the other route reported. Then the step's cost through each route."""
    from color_transfer_tpu_torch.tools import conv_grads as cg

    t0 = time.perf_counter()
    module, state, batch = cg.recipe_step(recipe)
    cases = cg.capture(module, state, batch)
    routes = {"cudnn": True, "aten": False}
    own = "cudnn" if module.backward_cudnn else "aten"
    rows = cg.check(cases, routes)
    for row in rows:
        _log(f"{recipe} conv grads: {row['case'].describe()} {row['grad']}: CPU f32 "
             f"{row['cpu']:.2e}, cuDNN {row['cudnn']:.2e} (excess {row['excess cudnn']:.3f}), "
             f"ATen {row['aten']:.2e} (excess {row['excess aten']:.3f})")
    worst = {r: max(rows, key=lambda row: row["excess " + r]) for r in routes}
    _log(f"{recipe} conv grads: {len(cases)} distinct convs at batch {batch['gt'].shape[0]} x "
         f"{batch['gt'].shape[1]}x{batch['gt'].shape[2]}, {len(rows)} gradients "
         f"({time.perf_counter() - t0:.1f} s); the step's route {own}; worst excess "
         + ", ".join(f"{r} {w['excess ' + r]:.3f} ({w['case'].name} {w['grad']})"
                     for r, w in worst.items()) + f" (line 1, ratio {cg.RATIO})")
    del cases, rows
    torch.cuda.empty_cache()
    times = {True: [], False: []}
    for on in (True, False, False, True):
        module.backward_cudnn = on
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            module.train_step(state, batch, 1, metrics=False)
            torch.cuda.synchronize()
            times[on].append((time.perf_counter() - t1) * 1e3)
    _log(f"{recipe} conv grads: one recipe step (no quality metrics), backward through "
         f"cuDNN {', '.join(f'{t:.1f}' for t in times[True])} ms, through ATen "
         f"{', '.join(f'{t:.1f}' for t in times[False])} ms (order cuDNN, ATen, ATen, cuDNN)")
    if worst[own]["excess " + own] > 1.0:
        raise AssertionError(f"{recipe}: a training conv's gradient on the card is further "
                             "from float64 than the rule allows")


def check_win_kernels(g):
    """B2a (no mask, the shift mask from geometry, a mask operand), B2b
    (self-attention with the shift and the residual, cross-attention
    without) and B2c against their plain versions at B2_SHAPES, line
    KERNEL_RTOL of max(1, max|ref|): 3xTF32 MMAs (every product) against
    cuBLAS's f32 products, in another order. At B2_TIMED (1080p scale 1 and
    half its windows) each is timed beside its plain version and, for B2a,
    one scaled_dot_product_attention with the tiled float mask (f32), whose
    device kernels one profiled call names. Each row's bound is printed twice: for 3xTF32 at TF32's rate
    (the route taken) and at the f32 FMA rate. Returns the rows of B2a
    (shift mode), B2b (cross-attention, the bound's two token inputs) and
    B2c at 1080p scale 1."""
    import torch.nn.functional as F

    from color_transfer_tpu_torch.ops import win_attention as wn

    c = B2_SHAPES[0][0][-1]
    weights = [(torch.randn(*s, generator=g) / s[0] ** 0.5).cuda()
               for s in ((c, c), (c, 2 * c), (c, c))]
    norm = [(1 + 0.1 * torch.randn(c, generator=g)).cuda(), (0.1 * torch.randn(c, generator=g)).cuda()]
    w0 = (torch.randn(2 * c, B2_FFN, generator=g) / (2 * c) ** 0.5).cuda()
    w2 = (torch.randn(B2_FFN, c, generator=g) / B2_FFN**0.5).cuda()
    timed = {}
    for shape, geom in B2_SHAPES:
        x, y, v = (torch.randn(*shape, generator=g).cuda() for _ in range(3))
        mask = wn.geometry_mask(*geom, device="cuda")
        cases = {
            "B2a none": (wn.window_attention_fused, wn.window_attention_plain, (x, y, v), {}),
            "B2a shift": (wn.window_attention_fused, wn.window_attention_plain, (x, y, v),
                          {"shift_windows": geom}),
            "B2a mask": (wn.window_attention_fused, wn.window_attention_plain,
                         (x, y, v, mask), {}),
            "B2b self": (wn.window_sublayer_fused, wn.window_sublayer_plain,
                         (x, x, *weights, *norm), {"shift_windows": geom, "add_residual": True}),
            "B2b cross": (wn.window_sublayer_fused, wn.window_sublayer_plain,
                          (x, y, *weights, *norm), {}),
            "B2c": (wn.ffn_fused, wn.ffn_plain, (x, y, w0, w2, *norm), {"add_residual": True}),
        }
        report, times = [], {}
        for label, (fn, plain, args, kw) in cases.items():
            with torch.no_grad():
                got, want = fn(*args, **kw), plain(*args, **kw)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = max(1.0, float(want.abs().max()))
            report.append(f"{label} {err:.2e} (line {KERNEL_RTOL * scale:.2e})")
            if not np.isfinite(err) or err > KERNEL_RTOL * scale:
                raise AssertionError(f"{label} kernel disagrees at {shape}: {err}")
            if shape in B2_TIMED:
                with torch.no_grad():
                    times[label] = (err, _time_ms(lambda: fn(*args, **kw), iters=10),
                                    _time_ms(lambda: plain(*args, **kw), iters=5))
            del got, want
        _log(f"B2 {shape} geometry {geom}: max|d| " + ", ".join(report))
        if times:
            attn_mask = mask.repeat(shape[0] // mask.shape[0], 1, 1)[:, None]
            with torch.no_grad():
                sdpa_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                    x[:, None], y[:, None], v[:, None], attn_mask=attn_mask), iters=10)
            _log(f"B2 {shape}, ms (kernel / plain): " + ", ".join(
                f"{k} {ms:.4f} / {pm:.4f}" for k, (_, ms, pm) in times.items())
                + f"; SDPA with the tiled float mask {sdpa_ms:.4f}")
            if shape == B2_TIMED[0]:
                timed, kept = times, (shape, x.numel(), sdpa_ms)
                with torch.no_grad():
                    names = _device_kernels(lambda: F.scaled_dot_product_attention(
                        x[:, None], y[:, None], v[:, None], attn_mask=attn_mask))
                _log(f"B2 {shape}: the SDPA call's device kernels (what the library computes "
                     f"in): {'; '.join(names) or 'none recorded by the profiler'}")
            del attn_mask
        del x, y, v, mask
    torch.cuda.empty_cache()

    (bp, length, c), n, sdpa_ms = kept
    tokens = bp * length

    def row(name, source, line, label):
        err, ms, plain_ms = timed[label]
        return {"name": name, "route": "cuda",
                "source": f"color_transfer_tpu_torch/csrc/{source}",
                "replaces": f"color_transfer_tpu/ops/win_attention.py:{line}",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

    # Bounds: each input read once and each output written once (f32), and
    # the products' operations at the rate of the route taken: three TF32
    # products (3xTF32) each (softmax, GELU and LayerNorm are small beside
    # them). Each row also prints its bound were the products f32 FMAs.
    attn = 4 * bp * length * length * c  # QK^T and PV
    proj = 8 * bp * length * c * c  # the q, k/v and merge projections
    ffn = tokens * 2 * 3 * c * B2_FFN  # [src | msg] W0 and h W2
    io = {"B2a": 4 * 4 * n,  # q, k, v read, out written
          "B2b": 4 * (3 * n + 4 * c * c + 2 * c),  # x_src, x_tgt, out, the weights
          "B2c": 4 * (3 * n + 3 * c * B2_FFN + 2 * c)}  # x_src, x_msg, out, W0, W2
    flops = {"B2a": attn, "B2b": proj + attn, "B2c": ffn}
    for label in io:
        ms_fma, _ = bound(io[label], {"f32": flops[label]})
        ms_route, by = bound(io[label], {"tf32": 3 * flops[label]})
        _log(f"{label} bound at {tuple(kept[0])}: {ms_route:.4f} ms ({by}) for the route "
             f"taken, 3xTF32 at 495 TFLOP/s; {ms_fma:.4f} ms were the products f32 FMAs "
             "(67 TFLOP/s)")
    return [
        _with_bound(row("window_attention_fused", "win_attention.cu", 175, "B2a shift"),
                    io["B2a"], {"tf32": 3 * flops["B2a"]}, sdpa_ms),
        _with_bound(row("window_sublayer_fused", "win_sublayer.cu", 321, "B2b cross"),
                    io["B2b"], {"tf32": 3 * flops["B2b"]}, None),
        _with_bound(row("ffn_fused", "win_ffn.cu", 524, "B2c"),
                    io["B2c"], {"tf32": 3 * flops["B2c"]}, None),
    ]


def serve_fused(rows, unfused):
    """Full-width DMSCT with ``matcher_fused_attention=True`` on phase 4's
    two 1080p pairs and weights (seed 0): exact launch counts, output
    checks, warm ms/frame, the transformer span and peak memory beside phase
    4's unfused numbers, busy share, the pair PSNR of fused against unfused;
    then the fused transformer on the card against the CPU on a small pair."""
    from color_transfer_tpu_torch.methods.video import color_transfer_between_videos
    from color_transfer_tpu_torch.run.modules import DMSCTModule

    module = DMSCTModule(matcher_fused_attention=True)
    variables = module.init_eval_variables(seed=0, device="cuda")
    target, reference = _dmsct_pairs()

    def clip():
        return color_transfer_between_videos(
            target, reference, method="dmsct", module=module, variables=variables,
            device="cuda")

    _reset_launches()
    out = clip()
    torch.cuda.synchronize()
    counts = _launches()
    want = dict.fromkeys(counts, 0)
    want.update(local_correlation_with_flow=module.model.matcher.num_reg_refine * FRAMES,
                window_sublayer_fused=B2B_PER_FRAME * FRAMES, ffn_fused=B2C_PER_FRAME * FRAMES)
    _log(f"fused serve: output {tuple(out.shape)}, launches {counts}")
    if counts != want:
        raise AssertionError(f"fused serve: launches {counts}, expected {want}")
    if tuple(out.shape) != (FRAMES, HEIGHT, WIDTH, 3) or not bool(torch.isfinite(out).all()):
        raise AssertionError("fused serve: output shape or values")
    lo, hi = float(out.min()), float(out.max())
    if lo < 0.0 or hi > 1.0:
        raise AssertionError("fused serve: output outside [0, 1]")
    for row in rows:
        if row["name"] in counts and "launches" not in row:
            row["launches"] = counts[row["name"]]

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clip()
    torch.cuda.synchronize()
    ms_frame = (time.perf_counter() - t0) * 1e3 / FRAMES
    peak = torch.cuda.max_memory_allocated() / 2**30
    stages = _stage_ms(module.model, clip, stages=("matcher", "matcher.transformer"),
                       functions=())
    busy_ms = _device_busy_ms(clip, top=8)
    d = out.cpu() - unfused["out"]
    psnr = 10 * math.log10(1.0 / max(float((d * d).mean()), 1e-30))
    _log(f"fused serve: warm pass {ms_frame:.1f} ms/frame (unfused, phase 4: "
         f"{unfused['ms_frame']:.1f}); transformer {stages['matcher.transformer'] / FRAMES:.2f} "
         f"device ms/frame (unfused {unfused['transformer']:.2f}), matcher "
         f"{stages['matcher'] / FRAMES:.2f}; peak memory {peak:.2f} GiB (unfused "
         f"{unfused['peak']:.2f}); device busy {busy_ms / FRAMES:.1f} ms/frame, busy share "
         f"{busy_ms / FRAMES / ms_frame:.3f}")
    _log(f"fused serve: fused against unfused on identical weights: pair PSNR {psnr:.2f} dB, "
         f"max|d|={float(d.abs().max()):.3e} (reported)")
    _check_stages("dmsct fused", module.model, variables, target[:1, ::8, ::8].contiguous(),
                  reference[:1, ::8, ::8].contiguous(), ("matcher.transformer",))
    del module, variables, out
    torch.cuda.empty_cache()


def matcher_train_shape():
    """The frozen matcher alone at the train shape (batch 12, 256x480 crops;
    its transformer sees 24 images at 1/8 and 48 at 1/4), as a train step
    calls it (no_grad, TF32 off), unfused and fused: exact launches (B1 6;
    fused also B2b 24 and B2c 12 per call), warm ms per call, the
    transformer's device span; the two flows compared (reported)."""
    from color_transfer_tpu_torch.core.precision import full_f32
    from color_transfer_tpu_torch.core.resize import derive_matcher_size
    from color_transfer_tpu_torch.run.modules import DMSCTModule

    g = torch.Generator().manual_seed(5)
    t, r = (torch.rand(TRAIN_BATCH, *TRAIN_CROP, 3, generator=g).cuda() * 255 for _ in range(2))
    size = derive_matcher_size(*TRAIN_CROP)
    flows = {}
    for fused in (False, True):
        module = DMSCTModule(matcher_fused_attention=fused)
        matcher = module.model.matcher
        params = {k[len("matcher."):]: v for k, v in
                  module.init_eval_variables(seed=0, device="cuda").items()
                  if k.startswith("matcher.")}

        def call():
            with torch.no_grad(), full_f32():
                return torch.func.functional_call(matcher, params, (t, r),
                                                  {"inference_size": size})

        _reset_launches()
        flows[fused] = call()["flow"]
        torch.cuda.synchronize()
        counts = _launches()
        want = dict.fromkeys(counts, 0)
        want["local_correlation_with_flow"] = matcher.num_reg_refine
        if fused:
            want.update(window_sublayer_fused=2 * B2B_PER_FRAME, ffn_fused=2 * B2C_PER_FRAME)
        if counts != want:
            raise AssertionError(f"train-shape matcher: launches {counts}, expected {want}")
        t0 = time.perf_counter()
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 2
        span = _stage_ms(matcher, call, stages=("transformer",), functions=())["transformer"]
        _log(f"train-shape matcher ({TRAIN_BATCH} x {TRAIN_CROP[0]}x{TRAIN_CROP[1]}) "
             f"{'fused' if fused else 'unfused'}: {ms:.1f} ms per call, transformer "
             f"{span:.2f} device ms, launches {counts}")
        del module, matcher, params
    d = (flows[True] - flows[False]).abs()
    _log(f"train-shape matcher: flow fused against unfused max|d| {float(d.max()):.3e} px, "
         f"mean {float(d.mean()):.3e} px (reported)")
    del flows, d
    torch.cuda.empty_cache()


def gates():
    """The drift gate (tools/deep_gate.py) on the card at 544x960 over all 31
    distortions: DMSCT ``fused`` and DCMCS3DI ``bf16`` against their float32
    defaults on shared seeded weights. The verdicts are reported, not
    asserted; every row must be finite. Then the fused route's drift stage by
    stage."""
    from color_transfer_tpu_torch.tools import deep_gate

    for model, recipe in (("dmsct", "fused"), ("dcmcs3di", "bf16")):
        t0 = time.perf_counter()
        summary, rows = deep_gate.run_gate(model, recipe, height=GATE_HEIGHT,
                                           width=GATE_WIDTH, device="cuda")
        _log(f"gate {model} {recipe}: {len(rows)} distortions in "
             f"{time.perf_counter() - t0:.1f} s; rows (i, pair PSNR, dPSNR, dSSIM, diCID): "
             + json.dumps([[r["i"], round(r["pair_psnr"], 2), round(r["d_psnr"], 5),
                            round(r["d_ssim"], 7), round(r["d_icid"], 7)] for r in rows]))
        _log("gate summary: " + json.dumps(summary))
        _log(f"gate {model} {recipe}: worst pair PSNR "
             f"{min(r['pair_psnr'] for r in rows):.2f} dB, verdict "
             f"{'pass' if summary['pass'] else 'fail'}")
        if len(rows) != 31 or not deep_gate.rows_finite(rows):
            raise AssertionError(f"gate {model} {recipe}: a row is missing or not finite")
        if (model, recipe) == ("dmsct", "fused"):
            # The rows that read far below the others (81.84 dB at
            # distortion 28 since PR 7): do occlusion flags flip there, and
            # does the image differ around them? The best row is the
            # control. Reported only.
            by_psnr = sorted(rows, key=lambda r: r["pair_psnr"])
            for i in sorted({by_psnr[0]["i"], by_psnr[1]["i"], 28, by_psnr[-1]["i"]}):
                _log(f"gate {model} {recipe}: occlusion trace " + json.dumps(
                    deep_gate.occlusion_flips(i, height=GATE_HEIGHT, width=GATE_WIDTH,
                                              device="cuda")))
        # Is a verdict the weights' or the recipe's? DCMCS3DI bf16 always runs
        # the three seeds; another recipe only when it fails.
        if not summary["pass"] or (model, recipe) == ("dcmcs3di", "bf16"):
            for seed in (1, 2):
                other, rows = deep_gate.run_gate(model, recipe, height=GATE_HEIGHT,
                                                 width=GATE_WIDTH, seed=seed, device="cuda")
                _log(f"gate summary, weights of seed {seed}: " + json.dumps(other))
                if not deep_gate.rows_finite(rows):
                    raise AssertionError(f"gate {model} {recipe} seed {seed}: a row is not finite")
    drift_stages()


def drift_stages():
    """Where the fused route's drift comes from, on the gate's undistorted
    pair and weights: the transformer fed the unfused run's inputs (per
    scale, relative to max(1, max|ref|)), the matcher's flow, the image."""
    from color_transfer_tpu_torch.core.precision import full_f32_inference
    from color_transfer_tpu_torch.core.resize import derive_matcher_size
    from color_transfer_tpu_torch.run.modules import DMSCTModule
    from color_transfer_tpu_torch.tools import deep_gate

    base, fused = DMSCTModule(), DMSCTModule(matcher_fused_attention=True)
    variables = base.init_eval_variables(seed=0, device="cuda")
    gt, ref = (torch.from_numpy(a).cuda()[None]
               for a in deep_gate.load_pair(GATE_HEIGHT, GATE_WIDTH))
    records = []
    hook = base.model.matcher.transformer.register_forward_hook(
        lambda m, a, o: records.append((a, o)))
    with torch.no_grad(), full_f32_inference():
        outs = {"unfused": torch.func.functional_call(base.model, variables, (gt, ref))}
        hook.remove()
        outs["fused"] = torch.func.functional_call(fused.model, variables, (gt, ref))
        prefix = "matcher.transformer."
        tf = {k[len(prefix):]: v for k, v in variables.items() if k.startswith(prefix)}
        tf_err = []
        for args, want in records:
            got = torch.func.functional_call(fused.model.matcher.transformer, tf, args)
            tf_err.append(max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                              for a, b in zip(got, want)))
        size = derive_matcher_size(GATE_HEIGHT, GATE_WIDTH)
        mv = {k[len("matcher."):]: v for k, v in variables.items() if k.startswith("matcher.")}
        flows = {name: torch.func.functional_call(
            m.model.matcher, mv, (gt * 255.0, ref * 255.0), {"inference_size": size})["flow"]
            for name, m in (("unfused", base), ("fused", fused))}
    df = (flows["fused"] - flows["unfused"]).abs()
    di = (outs["fused"] - outs["unfused"]).abs()
    psnr = 10 * math.log10(1.0 / max(float((di * di).mean()), 1e-30))
    _log("fused drift by stage (544x960, undistorted pair): transformer fed the unfused "
         "inputs, relative max|d| by scale " + ", ".join(f"{e:.2e}" for e in tf_err)
         + f"; flow max|d| {float(df.max()):.3e} px, mean {float(df.mean()):.3e}, pixels "
         f"off by > 0.1 px {float((df > 0.1).float().mean()):.4f}; image max|d| "
         f"{float(di.max()):.3e}, pair PSNR {psnr:.2f} dB")
    del base, fused, variables, records, outs, flows
    torch.cuda.empty_cache()


# DCMCS3DI training at configs/dcmcs3di.yaml's recipe (batch 8, 160x320
# crops, full width) on a synthetic set of 16 train and 4 validation pairs at
# 288x512: 2 steps an epoch, 3 epochs, once a training matcher.
DC_STEPS, DC_BATCH, DC_CROP = 6, 8, (160, 320)
# The chunked and the materialised training matcher on one batch with the
# same weights and target: JAX's own lines (tests/test_parallax_train.py).
MATCHER_LOSS_RTOL, MATCHER_GRAD_RTOL, MATCHER_GRAD_ATOL = 1e-5, 2e-4, 1e-5
# The step against float64 (check_dc_train_small): batch 2 of 32x64 crops.
DC_SMALL = (2, 32, 64)
# The convs of a DCMCS3DI train step at the recipe's crop, (name, batch,
# C_in, C_out, k, count a step): the extraction and the matcher head run on
# both views (2 x 8 images), the value projection and the transfer net on one.
DC_CONVS = (("extraction stem 3x3", 16, 3, 64, 3, 1),
            ("ResB 3x3, both views", 16, 64, 64, 3, 38),
            ("q/k 1x1", 16, 64, 64, 1, 2),
            ("value 1x1", 8, 64, 64, 1, 1),
            ("transfer 1x1 (2C+1 -> C)", 8, 129, 64, 1, 1),
            ("ResB 3x3, one view", 8, 64, 64, 3, 12),
            ("tail 3x3 64 -> 32", 8, 64, 32, 3, 1),
            ("tail 3x3 32 -> 3", 8, 32, 3, 3, 1))
# `test`: the 1080p set (Test/ one pair, 31 items; Real-World Test/scene1
# two triplets) for the classical methods and DMSCT; the 544x960 set (the
# same layout, plus scene2 at 520x900, a shape bucketing pads in both axes)
# for DCMCS3DI, whose evaluation materialises (1, H, W, W) volumes; the
# 64x96 set for the card against the CPU.
EVAL_1080, EVAL_544, EVAL_SMALL = (1080, 1920), (544, 960), (64, 96)
EVAL_BUCKETS = 64
# Card against CPU of a whole `test` of the linear methods: the metrics'
# means within 1e-4 relative (the methods' own line on the image, carried).
EVAL_CPU_RTOL = 1e-4
# The harness's MK means against a per-item recomputation on the card.
EVAL_SELF_RTOL = 1e-6
# Bucketed against native DCMCS3DI output on a 544x960 item, above the rows
# the padded ones reach: JAX's line (tests/test_bucketing.py).
EVAL_BUCKET_ATOL = 1e-4
# Phase 11 (assets): the parity sweep's items a loader, the crop a training
# decode cuts (configs/dcmcs3di.yaml), the panels' training-shape crops.
SWEEP_BATCHES, DECODE_CROP = 4, (160, 320)
PANEL_CROPS = {"dmsct": (2, 256, 480), "dcmcs3di": (2, 160, 320)}


def _fit_dcmcs3di(root, data, fused):
    """One `fit` of configs/dcmcs3di.yaml through the CLI with the given
    training matcher; returns what it measured and the fitted state."""
    from color_transfer_tpu_torch.run import cli, modules

    label = "chunked" if fused else "materialised"
    steps, held = [], {}
    orig_step = modules.DCMCS3DIModule.train_step

    def timed_step(self, state, batch, seed, metrics=True):
        if not held:
            held.update(module=self, state=state, start={
                k: v.detach().clone() for k, v in state.variables.items()})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_step(self, state, batch, seed, metrics)
        torch.cuda.synchronize()
        steps.append(((time.perf_counter() - t0) * 1e3, out[1]))
        held["batch"], held["seed"] = batch, seed
        return out

    log_dir = root / f"dc_{label}"
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    modules.DCMCS3DIModule.train_step = timed_step
    t0 = time.perf_counter()
    try:
        rc = cli.main(["fit", "--config", "configs/dcmcs3di.yaml", "--data.data_dir", str(data),
                       "--data.image_repeats", "1", "--trainer.max_epochs", "3",
                       "--model.fused_attention", "true" if fused else "false",
                       "--log_dir", str(log_dir)])
    finally:
        modules.DCMCS3DIModule.train_step = orig_step
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = _launches()
    if rc != 0:
        raise AssertionError(f"fit ({label}) returned {rc}")
    module, state = held["module"], held["state"]
    if module.fused_attention != fused or tuple(held["batch"]["gt"].shape[:3]) != (
            DC_BATCH, *DC_CROP):
        raise AssertionError(f"fit ({label}) did not run the recipe")
    ms = [t for t, _ in steps]
    losses = [float(logs["Training Total Loss"]) for _, logs in steps]
    warm = ms[1:]
    _log(f"dcmcs3di train ({label} matcher): fit {fit_s:.1f} s, {len(steps)} steps of "
         f"{DC_BATCH} x {DC_CROP[0]}x{DC_CROP[1]}; step 1 {ms[0]:.1f} ms (logs the quality "
         f"metrics), steps 2-{len(ms)} {', '.join(f'{t:.1f}' for t in warm)}: warm "
         f"{sum(warm) / len(warm):.1f} ms/step; peak memory {peak:.2f} GiB; losses "
         f"{', '.join(f'{v:.5f}' for v in losses)}; launches {counts}")
    if len(steps) != DC_STEPS:
        raise AssertionError(f"fit ({label}) ran {len(steps)} steps, expected {DC_STEPS}")
    if any(counts.values()):
        raise AssertionError("DCMCS3DI training launched a kernel (it runs none)")
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite training loss")
    unmoved = [k for k, v in state.variables.items() if torch.equal(v.detach(), held["start"][k])]
    _log(f"dcmcs3di train ({label}): {len(state.variables) - len(unmoved)} of "
         f"{len(state.variables)} parameters moved")
    if unmoved:
        raise AssertionError(f"parameters that did not move: {unmoved[:5]}")
    for which in ("last", "best"):
        meta = json.loads((log_dir / "checkpoints" / which / "meta.json").read_text())
        _log(f"dcmcs3di train ({label}): checkpoints/{which}: step {meta['step']}, "
             f"epoch {meta['epoch']}")
        if meta["step"] != 2 * (meta["epoch"] + 1) or (which == "last" and meta["epoch"] != 2):
            raise AssertionError(f"checkpoint {which}: {meta}")
    records = [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]
    val = [r["Validation PSNR/dataloader_idx_0"] for r in records
           if "Validation PSNR/dataloader_idx_0" in r]
    _log(f"dcmcs3di train ({label}): validation PSNR by epoch {[round(v, 4) for v in val]}")
    return module, state, held["batch"], held["seed"], log_dir


def _dc_profile(module, state, batch, seed):
    """One more step of the fitted state (no quality metrics): device ms by
    span, busy share, top kernels."""
    from color_transfer_tpu_torch.models import dcmcs3di as dc

    def step():
        module.train_step(state, batch, seed, metrics=False)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    spans = _stage_ms(module.model, step, stages=("extraction", "matcher.head", "transfer"),
                      functions=(("step", module, "train_step"),
                                 ("targets", module, "synthesize_targets"),
                                 ("forward+loss", module, "forward_loss"),
                                 ("optimizer", module, "apply_gradients"),
                                 ("chunked matcher", dc, "chunked_parallax_train"),
                                 ("losses", dc, "compute_losses_fused")))
    backward = spans["step"] - spans["targets"] - spans["forward+loss"] - spans["optimizer"]
    _log("dcmcs3di train: device ms by span (one step, chunked matcher): " + ", ".join(
        f"{k} {v:.2f}" for k, v in spans.items()) + f"; backward (step less targets, "
        f"forward+loss and optimizer) {backward:.2f}")
    busy = _device_busy_ms(step, top=15)
    _log(f"dcmcs3di train: one step {wall:.1f} ms wall, device busy {busy:.1f} ms, busy "
         f"share {busy / wall:.3f}")


def _dc_conv_times():
    """Each f32 conv of a DCMCS3DI train step at the recipe's crop through
    cuDNN with TF32 off, in the path's NHWC layout: forward, and backward
    (input and weight gradients), beside its operations' rate."""
    from color_transfer_tpu_torch.core.precision import full_f32
    from color_transfer_tpu_torch.models.layers import conv

    g = torch.Generator(device="cuda").manual_seed(0)
    h, w = DC_CROP
    total = 0.0
    with full_f32():
        for name, b, c_in, c_out, k, count in DC_CONVS:
            x = torch.randn(b, h, w, c_in, device="cuda", generator=g).requires_grad_(True)
            wt = (torch.randn(c_out, c_in, k, k, device="cuda", generator=g)
                  / (c_in * k * k) ** 0.5).requires_grad_(True)
            bias = torch.zeros(c_out, device="cuda", requires_grad=True)
            with torch.no_grad():
                fwd = _time_ms(lambda: conv(x, wt, bias, k // 2), iters=5)
                cudnn = torch.backends.cudnn
                with cudnn.flags(enabled=False, benchmark=False, deterministic=False,
                                 allow_tf32=False):
                    aten = _time_ms(lambda: conv(x, wt, bias, k // 2), iters=5)
            y = conv(x, wt, bias, k // 2)
            gy = torch.ones_like(y)
            bwd = _time_ms(lambda: torch.autograd.grad(y, (x, wt, bias), gy, retain_graph=True),
                           iters=5)
            flops = 2.0 * k * k * c_in * c_out * b * h * w
            total += count * (aten + bwd)
            _log(f"dcmcs3di conv {name} ({b}, {h}, {w}, {c_in}) -> {c_out}, x{count} a step: "
                 f"cuDNN f32 forward {fwd:.3f} ms ({flops / fwd / 1e9:.1f} TFLOP/s), backward "
                 f"{bwd:.3f} ms ({2 * flops / bwd / 1e9:.1f} TFLOP/s); ATen forward (the "
                 f"training route) {aten:.3f} ms ({flops / aten / 1e9:.1f} TFLOP/s)")
            del x, wt, bias, y, gy
    _log(f"dcmcs3di conv: a step's convs by these times (ATen forward, cuDNN backward) "
         f"{total:.1f} ms")


def _dc_grads(module, state, batch, fused):
    from color_transfer_tpu_torch.core.precision import full_f32

    module.fused_attention = fused
    with full_f32():
        _, total, _ = module.forward_loss(state, batch)
        grads = torch.autograd.grad(total, list(state.variables.values()))
    return float(total.detach()), [gr.detach() for gr in grads]


def _dc_matchers_agree(batch):
    """The chunked and the materialised matcher on one recipe batch, the
    same weights (seed 0) and the same target: the total loss and every
    gradient on JAX's own lines."""
    from color_transfer_tpu_torch.run.modules import DCMCS3DIModule

    module = DCMCS3DIModule()
    state = module.init_state(0, batch)
    b = {**batch, "target": (batch["gt"] ** 1.2 * 0.9 + 0.04).clamp(0, 1)}
    loss_c, g_c = _dc_grads(module, state, b, True)
    loss_m, g_m = _dc_grads(module, state, b, False)
    d_loss = abs(loss_c - loss_m) / abs(loss_m)
    # np.testing.assert_allclose's rule: |c - m| <= atol + rtol |m|, element-wise.
    excess = max(float(((c - m).abs() / (MATCHER_GRAD_ATOL + MATCHER_GRAD_RTOL * m.abs())).max())
                 for c, m in zip(g_c, g_m))
    _log(f"dcmcs3di matchers on one batch ({DC_BATCH} x {DC_CROP[0]}x{DC_CROP[1]}): total "
         f"loss chunked {loss_c:.8f}, materialised {loss_m:.8f} (relative {d_loss:.2e}, line "
         f"{MATCHER_LOSS_RTOL}); gradients: worst |c - m| / ({MATCHER_GRAD_ATOL} + "
         f"{MATCHER_GRAD_RTOL} |m|) = {excess:.3f} over {len(g_c)} tensors")
    if d_loss > MATCHER_LOSS_RTOL or excess > 1.0:
        raise AssertionError("the chunked and the materialised matchers disagree on the card")


def _dc_step(device, dtype, batch, target):
    """One train step of full-width DCMCS3DI (chunked matcher, seed-0
    variables) on ``device`` in ``dtype`` with the target given -> (loss,
    {name: gradient on the CPU in float64})."""
    from color_transfer_tpu_torch.run.modules import DCMCS3DIModule

    module = DCMCS3DIModule()
    b = {k: v.to(device, dtype) for k, v in batch.items()}
    state = module.init_state(0, b, num_train_steps=10)
    state.variables = {k: v.detach().to(dtype).requires_grad_(True)
                       for k, v in state.variables.items()}
    state.optimizer = torch.optim.Adam(list(state.variables.values()), lr=module.learning_rate)
    module.synthesize_targets = lambda bb, gen, tt=target.to(device, dtype): {**bb, "target": tt}
    grads = {}
    apply_gradients = module.apply_gradients

    def record(st):
        grads.update({k: v.grad.detach().cpu().double() for k, v in st.variables.items()})
        apply_gradients(st)

    module.apply_gradients = record
    _, logs = module.train_step(state, b, seed=0, metrics=False)
    return float(logs["Training Total Loss"]), grads


def check_dc_train_small():
    """The full-width DCMCS3DI train step on the card against float64 on
    the CPU at DC_SMALL: each gradient no further from float64 than
    TRAIN_F64_RATIO times the CPU float32 run's distance plus 1e-5 of its
    scale (phase 7's rule), the loss within TRAIN_LOSS_RTOL of the CPU's."""
    n, h, w = DC_SMALL
    t, r = _classical_clip(n, h, w, seed=5)
    batch = {"gt": t, "reference": r}
    target = (t ** 1.2 * 0.9 + 0.04).clamp(0, 1)
    t0 = time.perf_counter()
    loss64, g64 = _dc_step("cpu", torch.float64, batch, target)
    loss_cpu, g_cpu = _dc_step("cpu", torch.float32, batch, target)
    loss_card, g_card = _dc_step("cuda", torch.float32, batch, target)
    floor = 1e-2 * max(float(v.abs().max()) for v in g64.values())
    worst, name, far_cpu, far_card = 0.0, None, 0.0, 0.0
    for k, ref in g64.items():
        scale = max(float(ref.abs().max()), floor)
        e_cpu = float((g_cpu[k] - ref).abs().max()) / scale
        e_card = float((g_card[k] - ref).abs().max()) / scale
        far_cpu, far_card = max(far_cpu, e_cpu), max(far_card, e_card)
        excess = e_card / (TRAIN_F64_RATIO * e_cpu + 1e-5)
        if excess > worst:
            worst, name = excess, f"{k} (card {e_card:.2e}, CPU {e_cpu:.2e})"
    d_loss = abs(loss_card - loss_cpu) / abs(loss_cpu)
    _log(f"dcmcs3di train step {DC_SMALL}, full width, chunked matcher "
         f"({time.perf_counter() - t0:.1f} s): loss card {loss_card:.8f}, CPU {loss_cpu:.8f}, float64 {loss64:.8f} (card against "
         f"CPU {d_loss:.2e}, line {TRAIN_LOSS_RTOL}); gradients against float64: worst card "
         f"error / ({TRAIN_F64_RATIO} x CPU error + 1e-5) = {worst:.3f} at {name} over "
         f"{len(g64)} tensors; farthest from float64: card {far_card:.2e}, CPU {far_cpu:.2e}")
    if d_loss > TRAIN_LOSS_RTOL or worst > 1.0:
        raise AssertionError("the DCMCS3DI train step on the card is further from float64 "
                             "than the rule allows")


def train_dcmcs3di(root):
    """Phase 10: `fit` of configs/dcmcs3di.yaml at its full width through the
    CLI, once with each training matcher; checked and measured. Returns the
    chunked run's best checkpoint (phase 9 evaluates it)."""
    from PIL import Image

    from color_transfer_tpu_torch.run import cli

    t_phase = time.perf_counter()
    data = root / "dc_data"
    _write_dataset(data, splits=(("Train", 16), ("Validation", 4)))
    fitted = {fused: _fit_dcmcs3di(root, data, fused) for fused in (True, False)}
    module, state, batch, seed, log_dir = fitted[True]
    del fitted[False]
    _dc_profile(module, state, batch, seed)
    del module, state
    torch.cuda.empty_cache()
    _dc_conv_times()
    _dc_matchers_agree(batch)
    torch.cuda.empty_cache()
    check_dc_train_small()
    check_conv_grads("dcmcs3di")
    best = log_dir / "checkpoints" / "best"
    pair = root / "dc_pair"
    pair.mkdir()
    for view in ("L", "R"):
        with Image.open(data / "Validation" / f"0000_{view}.png") as img:
            img.crop((0, 0, 240, 135)).save(pair / f"0000_{view}.png")
    out = root / "dc_corrected.png"
    rc = cli.main(["predict", "--method", "dcmcs3di", "--ckpt_path", str(best), "--target",
                   str(pair / "0000_L.png"), "--reference", str(pair / "0000_R.png"),
                   "--output", str(out)])
    with Image.open(out) as img:
        size = img.size
    _log(f"dcmcs3di train: predict from checkpoints/best wrote {size[0]}x{size[1]}; phase "
         f"{time.perf_counter() - t_phase:.1f} s")
    if rc != 0 or size != (240, 135):
        raise AssertionError("predict from the DCMCS3DI checkpoint failed")
    return best


def _write_eval_set(root, hw, extra_scene=None, seed=7):
    """Test/ one pair at ``hw``; Real-World Test/scene1 two triplets at
    ``hw`` (the distorted view LD a gamma- and colour-cast copy of L);
    ``extra_scene`` (h, w): scene2 with one triplet at that shape."""
    rng = np.random.default_rng(seed)
    (root / "Test").mkdir(parents=True)
    left, right = _stereo_pair(rng, *hw)
    _save(root / "Test" / "0000_L.png", left)
    _save(root / "Test" / "0000_R.png", right)
    scenes = [("scene1", 2, hw)] + ([("scene2", 1, extra_scene)] if extra_scene else [])
    for scene, n, (h, w) in scenes:
        d = root / "Real-World Test" / scene
        d.mkdir(parents=True)
        for i in range(n):
            left, right = _stereo_pair(rng, h, w)
            distorted = np.clip(left ** 0.8 * [1.08, 0.95, 0.9] + 0.02, 0, 1)
            for suffix, img in (("L", left), ("LD", distorted), ("R", right)):
                _save(d / f"{i:04d}_{suffix}.png", img)


def _run_test(argv):
    """`test` through the CLI on the card -> (results, the trainer, wall s)."""
    import contextlib
    import io

    from color_transfer_tpu_torch.run import cli, trainer

    held = {}
    orig = trainer.Trainer.test

    def test(self, *args, **kwargs):
        held["trainer"] = self
        return orig(self, *args, **kwargs)

    out = io.StringIO()
    trainer.Trainer.test = test
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(["test", *argv])
        torch.cuda.synchronize()
    finally:
        trainer.Trainer.test = orig
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"test {argv} returned {rc}")
    text = out.getvalue()
    return json.loads(text[text.index("{"):]), held["trainer"], wall


def _counted(argv, profile=False):
    """A `test` run under torch's sync debug mode -> (host syncs, wall s,
    device busy ms of a torch.profiler trace of it when ``profile``)."""
    import warnings

    held = {}

    def run():
        held["wall"] = _run_test(argv)[2]

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            busy = _device_busy_ms(run) if profile else run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught), held["wall"], busy


def _eval_method(label, argv, items, expect):
    """One method's `test` on a set: the run, exact kernel launches, spans,
    host ms an item, peak memory; then a run with no item and one with an
    item a loader: the set-up's wall time, host syncs an item and the busy
    share (the profiled run, set-up included). ``expect``: {wrapper name:
    launches an item}. Returns the results."""
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    results, trainer, wall = _run_test(argv)
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = _launches()
    want = {name: expect.get(name, 0) * items for name in counts}
    spans = {k: sum(v) / len(v) for k, v in trainer.test_spans.items()}
    counted = {k: len(v) for k, v in trainer.test_spans.items()}
    if set(counted.values()) != {items} or len(counted) != 3:
        raise AssertionError(f"{label}: spans an item {counted}")
    fixed, wall0, _ = _counted([*argv, "--max_batches", "0"])
    syncs, wall1, busy = _counted([*argv, "--max_batches", "1"], profile=True)
    _log(f"test {label}: {items} items, {(wall - wall0) * 1e3 / items:.1f} ms an item by the "
         f"host clock (run {wall:.2f} s less its set-up {wall0:.2f} s); device spans an item "
         + ", ".join(f"{k} {v:.2f} ms" for k, v in spans.items())
         + f"; peak memory {peak:.2f} GiB; one item a loader under the profiler: busy "
         f"{busy:.1f} of {wall1 * 1e3:.1f} ms (share {busy / (wall1 * 1e3):.3f}, set-up "
         f"included); host syncs an item {(syncs - fixed) / 2:g} (set-up {fixed}); launches "
         f"{counts}")
    _log(f"test {label}: " + ", ".join(f"{k.removeprefix('Test ')} {v:.6f}"
                                        for k, v in results.items()))
    if counts != want:
        raise AssertionError(f"test {label}: launches {counts}, expected {want}")
    bad = [k for k, v in results.items() if not math.isfinite(v)]
    names = {f"Test {m}/dataloader_idx_{i}" for m in ("PSNR", "SSIM", "iCID", "FSIM")
             for i in (0, 1)}
    if set(results) != names or bad:
        raise AssertionError(f"test {label}: results {sorted(results)}, non-finite {bad}")
    return results


def _bucket_interior(data, ckpt):
    """DCMCS3DI bucketed against native on the real-world items, output
    against output: a 544x960 item pads 32 rows (960 is a multiple of 64),
    so the rows above the receptive field of the padded ones must agree on
    JAX's line (tests/test_bucketing.py, 1e-4); the 520x900 item also pads
    columns, whose attention reaches every row (reported). Returns the
    interior difference of the 544x960 items."""
    from color_transfer_tpu_torch.run.bucketing import BucketedEvaluator
    from color_transfer_tpu_torch.run.checkpoint import restore_eval_variables
    from color_transfer_tpu_torch.run.datamodule import DataModule, to_float
    from color_transfer_tpu_torch.run.modules import DCMCS3DIModule

    module = DCMCS3DIModule()
    variables = restore_eval_variables(module, ckpt)
    evaluator = BucketedEvaluator(module, multiple=EVAL_BUCKETS)
    # Rows a padded row reaches: the stem and 18 ResB blocks, the matcher
    # head's ResB, 6 ResB blocks and the two tail convs (3x3 each; the 1x1
    # convs and the row-wise attention add none).
    band = 1 + 2 * EXTRACTION_LAYERS + 2 + 2 * TRANSFER_LAYERS + 2
    worst = 0.0
    for batch in DataModule(data, num_workers=2).test_loaders()[1]:
        b = {k: torch.from_numpy(v).cuda() for k, v in to_float(batch).items()}
        native = module.eval_forward(variables, b)
        out, _ = evaluator.eval_batch(variables, b)
        h, w = b["gt"].shape[1:3]
        interior = float((out - native)[:, :h - band].abs().max())
        _log(f"test dcmcs3di bucketed against native output at {h}x{w}: rows above the "
             f"{band}-row band {interior:.2e}, whole image "
             f"{float((out - native).abs().max()):.2e}")
        if w % EVAL_BUCKETS == 0:
            worst = max(worst, interior)
    return worst


def _mk_by_hand(data):
    """MK's per-loader metric means recomputed item by item on the card:
    each loader item, its grid distortion, eval_forward, quality_metrics."""
    from color_transfer_tpu_torch.data.distortions import setup_grid_distortions
    from color_transfer_tpu_torch.run.datamodule import DataModule
    from color_transfer_tpu_torch.run.modules import ClassicalModule, quality_metrics
    from color_transfer_tpu_torch.run.trainer import Trainer

    trainer = Trainer(log_dir=data.parent / "mk_by_hand")
    module, grid = ClassicalModule("monge_kantorovitch"), setup_grid_distortions()
    means = {}
    for idx, loader in enumerate(DataModule(data, num_workers=4).test_loaders()):
        sums, n = {}, 0
        for batch in loader:
            d = batch.pop("distortion_idx", None)
            batch = trainer.device_batch(batch)
            if "target" not in batch:
                batch["target"] = grid[int(d[0])](batch["gt"][0])[None]
            with torch.no_grad():
                logs = quality_metrics(module.eval_forward(None, batch), batch["gt"])
            for k, v in logs.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        means.update({f"Test {k}/dataloader_idx_{idx}": v / n for k, v in sums.items()})
    return means


def _worst_rel(a, b):
    return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in b)


def evaluate(root, dc_ckpt):
    """Phase 9: the paper's evaluation, `test` through the CLI: the five
    classical methods and DMSCT (random init) on the 1080p set, DCMCS3DI
    from phase 10's checkpoint on the 544x960 set, natively and bucketed;
    checked and measured."""
    t_phase = time.perf_counter()
    sets = {"1080": root / "eval_1080", "544": root / "eval_544", "small": root / "eval_small"}
    _write_eval_set(sets["1080"], EVAL_1080)
    _write_eval_set(sets["544"], EVAL_544, extra_scene=(520, 900))
    _write_eval_set(sets["small"], EVAL_SMALL)
    _log(f"test: sets written ({time.perf_counter() - t_phase:.1f} s)")
    items = 31 + 2
    results = {}

    def classical(method, data):
        return ["--config", "configs/others.yaml", "--model.func_spec", method,
                "--data.data_dir", str(data), "--log_dir", str(root / "eval_log")]

    expects = {"idt": {"transport_apply": N_ITER},
               "automated_color_grading": {"transport_apply": N_ITER,
                                           "regrain_sweeps": LEVELS}}
    for method in CLASSICAL:
        results[method] = _eval_method(method, classical(method, sets["1080"]), items,
                                       expects.get(method, {}))
    by_hand = _mk_by_hand(sets["1080"])
    d_mk = _worst_rel(results["monge_kantorovitch"], by_hand)
    _log(f"test monge_kantorovitch: the harness's means against a per-item recomputation "
         f"on the card: worst relative {d_mk:.2e} (line {EVAL_SELF_RTOL})")
    small = {}
    for method in CLASSICAL[:3]:
        argv = classical(method, sets["small"])
        small[method] = (_run_test(argv)[0], _run_test([*argv, "--device", "cpu"])[0])
        _log(f"test {method} on {EVAL_SMALL[0]}x{EVAL_SMALL[1]}: card against CPU, worst "
             f"relative {_worst_rel(*small[method]):.2e} (line {EVAL_CPU_RTOL})")
    results["dmsct"] = _eval_method(
        "dmsct (random init)", ["--config", "configs/dmsct.yaml", "--data.data_dir",
                                str(sets["1080"]), "--log_dir", str(root / "eval_log")],
        items, {"local_correlation_with_flow": 6})
    dc = ["--config", "configs/dcmcs3di.yaml", "--ckpt_path", str(dc_ckpt), "--data.data_dir",
          str(sets["544"]), "--log_dir", str(root / "eval_log")]
    native = _eval_method("dcmcs3di (phase 10's best, 544x960)", dc, 31 + 3, {})
    bucketed = _eval_method(f"dcmcs3di bucketed to {EVAL_BUCKETS}", [
        *dc, "--eval_buckets", str(EVAL_BUCKETS)], 31 + 3, {})
    drift = {k: bucketed[k] - native[k] for k in native}
    _log("test dcmcs3di: bucketed less native, " + ", ".join(
        f"{k.removeprefix('Test ')} {v:+.3e}" for k, v in drift.items())
        + f" (loader 0: 544x960, padded to {EVAL_BUCKETS}'s multiple 576x960; loader 1: two "
        "544x960 triplets and one at 520x900, padded to 576x960)")
    interior = _bucket_interior(sets["544"], dc_ckpt)
    _log(f"test: phase {time.perf_counter() - t_phase:.1f} s")
    if interior > EVAL_BUCKET_ATOL:
        raise AssertionError("bucketed DCMCS3DI leaves its rows above the padded band")
    if d_mk > EVAL_SELF_RTOL:
        raise AssertionError("MK's harness means disagree with the per-item recomputation")
    if any(_worst_rel(*pair) > EVAL_CPU_RTOL for pair in small.values()):
        raise AssertionError("a linear method's test on the card disagrees with the CPU")


def _decoder(root):
    """Phase 11, the decoder: which one runs (and the build's error when it
    is PIL), the native decoder bit-equal to PIL on the 1080p set's PNGs
    (whole and cropped), a 1080p decode and a training crop timed with each
    decoder that runs, and MK's `test` item by the host clock with each."""
    from PIL import Image

    from color_transfer_tpu_torch.data import native_loader as nl

    native = nl.available()
    _log("assets: decoder " + ("native" if native else
                               f"pil (native build failed: {nl.build_error()})"))
    path = root / "eval_1080" / "Test" / "0000_L.png"
    ch, cw = DECODE_CROP

    def pil():
        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"))

    def host_ms(fn, n=10):
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e3

    times = {"PIL 1080p": host_ms(pil), f"PIL {ch}x{cw} crop": host_ms(lambda: pil()[:ch, :cw])}
    if native:
        pngs = sorted((root / "eval_1080").rglob("*.png"))
        rng = np.random.default_rng(11)
        for png in pngs:
            with Image.open(png) as img:
                want = np.asarray(img.convert("RGB"))
            top, left = int(rng.integers(0, want.shape[0] - ch + 1)), int(
                rng.integers(0, want.shape[1] - cw + 1))
            if not (np.array_equal(nl.read_image(png), want) and np.array_equal(
                    nl.read_image_crop(png, top, left, ch, cw),
                    want[top:top + ch, left:left + cw])):
                raise AssertionError(f"the native decoder disagrees with PIL on {png.name}")
        _log(f"assets: {len(pngs)} PNGs decoded natively bit-equal to PIL, whole and cropped")
        times.update({
            "native 1080p": host_ms(lambda: nl.read_image(path)),
            f"native {ch}x{cw} crop at the top": host_ms(
                lambda: nl.read_image_crop(path, 0, 0, ch, cw)),
            f"native {ch}x{cw} crop at the bottom": host_ms(
                lambda: nl.read_image_crop(path, 1080 - ch, 1920 - cw, ch, cw))})
    _log("assets: host ms a decode (one thread): "
         + ", ".join(f"{k} {v:.2f}" for k, v in times.items()))
    argv = ["--config", "configs/others.yaml", "--model.func_spec", "monge_kantorovitch",
            "--data.data_dir", str(root / "eval_1080"), "--log_dir", str(root / "assets_log")]
    items = 31 + 2
    per_item = {}
    for label in ("native", "PIL", "native") if native else ("PIL",):
        saved = nl._lib
        if label == "PIL":
            nl._lib = False
        try:
            wall0 = _run_test([*argv, "--max_batches", "0"])[2]
            wall = _run_test(argv)[2]
        finally:
            nl._lib = saved
        per_item.setdefault(label, []).append((wall - wall0) * 1e3 / items)
    _log("assets: MK `test` on the 1080p set, host ms an item (run less its set-up), by "
         "decoder: " + ", ".join(f"{k} {', '.join(f'{v:.1f}' for v in vs)}"
                                 for k, vs in per_item.items()))


def _fabricate_ckpts(root):
    """Reference-layout checkpoints from seeded weights (the port's names
    are the reference's): a full-width DMSCT Lightning .ckpt, a full-width
    DCMCS3DI one, and unimatch's .pth layout with heads the flow model does
    not use. Returns (paths, {kind: source state_dict})."""
    from color_transfer_tpu_torch.run.modules import (
        DCMCS3DIModule,
        DMSCTModule,
        random_state_dict,
    )

    g = torch.Generator().manual_seed(21)
    dm = random_state_dict(DMSCTModule().model, seed=21)
    dc = DCMCS3DIModule().init_eval_variables(21, device="cpu")
    extra = {"encoder._conv_head.weight": (1408, 352, 1, 1), "encoder._bn1.weight": (1408,),
             "matcher.upsampler.0.weight": (256, 130, 3, 3), "matcher.upsampler.0.bias": (256,)}
    unused = {k: torch.randn(shape, generator=g) for k, shape in extra.items()}
    paths = {"dmsct": root / "dmsct.ckpt", "dcmcs3di": root / "dcmcs3di.ckpt",
             "unimatch": root / "gmflow-scale2-regrefine6-mixdata.pth"}
    torch.save({"state_dict": {**dm, **unused}, "hyper_parameters": {"learning_rate": 3e-4}},
               paths["dmsct"])
    torch.save({"state_dict": dc, "hyper_parameters": {"extraction_layers": 18,
                                                        "transfer_layers": 6, "channels": 64}},
               paths["dcmcs3di"])
    matcher = {k.removeprefix("matcher."): v for k, v in {**dm, **unused}.items()
               if k.startswith("matcher.")}
    torch.save({"model": matcher, "step": 0}, paths["unimatch"])
    return paths, {"dmsct": dm, "dcmcs3di": dc}


def _readers(root):
    """Phase 11, the readers: each fabricated file read strictly and
    bit-equal to its source; the restored DMSCT's 1080p output bit-equal to
    the source weights'. Returns the checkpoint paths."""
    from color_transfer_tpu_torch.data.native_loader import read_image
    from color_transfer_tpu_torch.run.datamodule import to_float
    from color_transfer_tpu_torch.tools import convert_checkpoints as cc
    from color_transfer_tpu_torch.tools.convert_gmflow import load_matcher

    t0 = time.perf_counter()
    paths, sources = _fabricate_ckpts(root)
    for kind in ("dmsct", "dcmcs3di"):
        ckpt = cc.load_reference_ckpt(paths[kind])
        same = set(ckpt.state_dict) == set(sources[kind]) and all(
            torch.equal(v, sources[kind][k]) for k, v in ckpt.state_dict.items())
        _log(f"assets: {paths[kind].name} read strictly as {ckpt.kind}: "
             f"{len(ckpt.state_dict)} tensors, hyper-parameters {ckpt.hparams}, dropped "
             f"{len(ckpt.dropped)} keys the port does not build, bit-equal to the source: {same}")
        if ckpt.kind != kind or not same:
            raise AssertionError(f"the reader changed the {kind} checkpoint")
    matcher = load_matcher(paths["unimatch"])
    want = {k.removeprefix("matcher."): v for k, v in sources["dmsct"].items()
            if k.startswith("matcher.")}
    same = set(matcher) == set(want) and all(torch.equal(v, want[k]) for k, v in matcher.items())
    _log(f"assets: {paths['unimatch'].name} (unimatch layout, with its upsampler) read as "
         f"{len(matcher)} matcher tensors, bit-equal to the source: {same}")
    if not same:
        raise AssertionError("the unimatch reader changed the matcher")
    ckpt = cc.load_reference_ckpt(paths["dmsct"])
    module = cc.module_for("dmsct", ckpt.hparams)
    test = root / "eval_1080" / "Test"
    pair = {k: torch.from_numpy(v[None]).cuda() for k, v in to_float(
        {"target": read_image(test / "0000_L.png"),
         "reference": read_image(test / "0000_R.png")}).items()}
    restored = module.eval_forward({k: v.cuda() for k, v in ckpt.state_dict.items()}, pair)
    source = module.eval_forward({k: v.cuda() for k, v in sources["dmsct"].items()}, pair)
    equal = torch.equal(restored, source)
    _log(f"assets: the restored DMSCT's 1080p output bit-equal to the source weights': {equal} "
         f"({time.perf_counter() - t0:.1f} s)")
    if not equal or tuple(restored.shape) != (1, *EVAL_1080, 3):
        raise AssertionError("the restored DMSCT's output differs from its source's")
    return paths


def _sweep(root, paths):
    """Phase 11, the sweep: the four classical methods and DMSCT on the
    1080p set, DCMCS3DI bucketed on the 544x960 set, SWEEP_BATCHES items a
    loader, the table printed, B1 / B3 / B4 launches exact."""
    from color_transfer_tpu_torch.tools import parity_sweep as ps

    t0 = time.perf_counter()
    items = SWEEP_BATCHES + min(SWEEP_BATCHES, 2)  # the 1080p set's two loaders
    _reset_launches()
    results = ps.run_sweep(root / "eval_1080", dmsct_ckpt=paths["dmsct"],
                           max_batches=SWEEP_BATCHES, log_dir=root / "sweep_log")
    counts = _launches()
    want = {name: 0 for name in counts}
    want.update(local_correlation_with_flow=6 * items, transport_apply=N_ITER * items,
                regrain_sweeps=LEVELS * items)
    _reset_launches()
    results.update(ps.run_sweep(root / "eval_544", dcmcs3di_ckpt=paths["dcmcs3di"],
                                classical=False, eval_buckets=EVAL_BUCKETS,
                                max_batches=SWEEP_BATCHES, log_dir=root / "sweep_log"))
    dc_counts = _launches()
    _log(f"assets: parity sweep ({time.perf_counter() - t0:.1f} s; {SWEEP_BATCHES} items a "
         f"loader; DCMCS3DI on the 544x960 set with --eval_buckets {EVAL_BUCKETS}):\n"
         + ps.format_table(results, ps.PUBLISHED_ARTIFICIAL))
    _log(f"assets: sweep launches on the 1080p set {counts} (expected {want}: DMSCT 6 B1 an "
         f"item, grading {N_ITER} B3 and {LEVELS} B4 an item, {items} items); DCMCS3DI "
         f"{dc_counts}")
    bad = [k for r in results.values() for k, v in r.items() if not math.isfinite(v)]
    if counts != want or any(dc_counts.values()) or bad or len(results) != 6:
        raise AssertionError(f"the parity sweep: launches {counts}, DCMCS3DI {dc_counts}, "
                             f"non-finite {bad}")


def _panels_and_profile(root, paths):
    """Phase 11, panels and profile: one DMSCT and one DCMCS3DI panel set
    from the fabricated checkpoints through the Trainer's panel logger (PNGs
    written, no image_log_error.txt); a torch.profiler trace of two DMSCT
    serve steps at 1080p that names B1's kernel."""
    from types import SimpleNamespace

    from color_transfer_tpu_torch.run.trainer import Trainer
    from color_transfer_tpu_torch.tools import convert_checkpoints as cc
    from color_transfer_tpu_torch.utils import profiling

    g = torch.Generator().manual_seed(12)
    for kind, (b, h, w) in PANEL_CROPS.items():
        ckpt = cc.load_reference_ckpt(paths[kind])
        module = cc.module_for(kind, ckpt.hparams)
        state = SimpleNamespace(variables={k: v.cuda() for k, v in ckpt.state_dict.items()})
        t = torch.rand(b, h, w, 3, generator=g).cuda()
        batch = {"gt": t, "reference": t.roll(8, dims=2)}
        log_dir = root / f"panels_{kind}"
        _reset_launches()
        t0 = time.perf_counter()
        Trainer(log_dir=log_dir)._log_panels(module, state, batch, torch.Generator().manual_seed(0),
                                             "Training Images", step=1)
        torch.cuda.synchronize()
        pngs = sorted(p.name for p in (log_dir / "images").glob("*.png"))
        error = (log_dir / "image_log_error.txt").exists()
        _log(f"assets: {kind} panels at {b} x {h}x{w} ({(time.perf_counter() - t0):.1f} s): "
             f"{pngs}; image_log_error.txt {'written' if error else 'absent'}; launches "
             f"{ {k: v for k, v in _launches().items() if v} }")
        if len(pngs) != 6 or error:
            raise AssertionError(f"{kind} panels: {pngs}, error file {error}")
        if kind == "dmsct":
            served = module, state
    module, state = served
    pair = {"target": torch.rand(1, *EVAL_1080, 3, generator=g).cuda()}
    pair["reference"] = pair["target"].roll(16, dims=2)
    module.eval_forward(state.variables, pair)  # warm
    _reset_launches()
    with profiling.trace(root / "prof"):
        for _ in range(2):
            with profiling.annotate("dmsct serve step"):
                module.eval_forward(state.variables, pair)
        torch.cuda.synchronize()
    traces = list((root / "prof").glob("*.pt.trace.json"))
    names = {e.get("name", "") for e in json.loads(traces[0].read_text()).get("traceEvents", [])}
    b1 = sorted(n for n in names if "local_corr_kernel" in n)
    _log(f"assets: profiling.trace of two DMSCT 1080p serve steps: {traces[0].name}, "
         f"{traces[0].stat().st_size / 2**20:.1f} MiB, {len(names)} event names, B1 kernels "
         f"{b1}, the annotation {'dmsct serve step' in names}; launches {_launches()['local_correlation_with_flow']} "
         f"B1")
    if len(traces) != 1 or not b1 or "dmsct serve step" not in names:
        raise AssertionError("the profile does not name B1's kernel or the annotation")


def assets(root):
    """Phase 11: the asset path on phase 9's sets: the decoder, the
    checkpoint readers, the parity sweep, image panels and a profile."""
    t0 = time.perf_counter()
    _decoder(root)
    paths = _readers(root)
    torch.cuda.empty_cache()
    _sweep(root, paths)
    torch.cuda.empty_cache()
    _panels_and_profile(root, paths)
    _log(f"assets: phase {time.perf_counter() - t0:.1f} s")


def main():
    probe()
    build()
    rows = check_kernels()
    module, variables, target, reference, unfused = serve(rows)
    check_small(module, variables, target, reference)
    del module, variables
    torch.cuda.empty_cache()
    check_small_dcmcs3di(*serve_dcmcs3di(rows, target, reference), target, reference)
    del target, reference
    torch.cuda.empty_cache()
    rows += check_classical_kernels(torch.Generator().manual_seed(1))
    serve_classical(rows)
    check_small_classical()
    rows.append(check_warp_adjoint(torch.Generator().manual_seed(2)))
    train(rows)
    check_train_small()
    check_conv_grads("dmsct")
    rows += check_win_kernels(torch.Generator().manual_seed(3))
    serve_fused(rows, unfused)
    del unfused
    matcher_train_shape()
    gates()
    with tempfile.TemporaryDirectory() as tmp:
        # Phase 10 before phase 9: the evaluation reads its checkpoint.
        dc_ckpt = train_dcmcs3di(Path(tmp))
        evaluate(Path(tmp), dc_ckpt)
        assets(Path(tmp))
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
