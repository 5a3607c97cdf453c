"""Time this tree's kernels against another checkout's, in turns, in one
process on one card: the comparison a kernel's redesign is held to.

Two cards, or two calls on one card, differ by more than a redesign may
gain, so both versions run in one process: other, tree, tree, other. The
other checkout is a copy of the package under ANOTHER import name (two
copies of one name would share ``sys.modules``, and the wrappers import
their builder at call time, so both would load one library):

    # where git is: the parent commit's package as runs/ctt_other
    python -m color_transfer_tpu_torch.tools.kernel_ab --prepare HEAD~1 --other runs/ctt_other
    # on the card (runs/ is git-ignored):
    python -m color_transfer_tpu_torch.tools.kernel_ab --other runs/ctt_other

Times B5 (``row_attention_warp``: out and column sums, column sums only;
bf16 operands and precise) and B6 (``resb_chain`` in bf16: chains of 1, 6
and 18 blocks) at the 1080p path's shapes, B7 (``warp_adjoint``) at DMSCT's
four training levels (batch 12, 256x480 crops) on a mixed flow (sub-pixel,
zero and clamped displacements) and an in-image one, and B2a
(``window_attention_fused``, the shift mask), B2b
(``window_sublayer_fused``: cross-attention, and self-attention with the
shift mask and the residual) and B2c (``ffn_fused``, F = 1024, the
residual) at the fused route's 1080p shape (256, 448, 128), B2a, B2b and
B2c in bf16 (the shift mask; cross, and self with the shift and the
residual; F = 1024 with the residual) at the bf16 recipe's three shapes
(``B2_BF16_SHAPES``), B1 (``local_correlation_with_flow``, r = 4, f32 and
``local_corr bf16``) at the 1080p matcher shape (2, 128, 224, 128) on a
smooth and a mixed flow and on the flow the served frame's GRU loop gives
it (``--served``: full-width DMSCT with seeded random weights serves one
synthetic 1080p pair first, in f32 and in the ``bf16`` recipe, and each
one's first B1 call's arguments are kept), and at the training shape (24,
64, 120, 128),
and B4 (``regrain_sweeps``) at the six levels of an 8-frame 1080p chunk,
through their public wrappers, CUDA events after warm-up, and prints one
JSON line per case with both sides' times in the order run. ``--only
REGEX`` keeps the cases whose name matches. ``--device cpu --small`` runs
tiny shapes through the plain versions (a rehearsal: no device numbers).
"""

import argparse
import importlib
import itertools
import json
import re
import shutil
import subprocess
import sys
import tarfile
import tempfile
import time
from pathlib import Path

import torch

PACKAGE = "color_transfer_tpu_torch"
# B2a and B2b in bf16 at the bf16 recipe's shapes: the served 1080p shape and
# the training shape's two scales, with their shift geometry.
B2_BF16_SHAPES = (((256, 448, 128), (8, 16, 28)), ((3072, 120, 128), (8, 8, 15)),
                  ((96, 480, 128), (2, 16, 30)))


def rename_package(src, dest):
    """Copy the package directory ``src`` to ``dest`` and rewrite its
    imports to ``dest``'s name, so that both copies import side by side."""
    src, dest = Path(src), Path(dest)
    if dest.exists():
        shutil.rmtree(dest)
    shutil.copytree(src, dest, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for path in dest.rglob("*.py"):
        text = path.read_text()
        path.write_text(re.sub(rf"\b{PACKAGE}\b", dest.name, text))
    return dest


def prepare(commit, dest):
    """``commit``'s package (``git archive``) as the package ``dest``."""
    with tempfile.TemporaryDirectory() as tmp:
        archive = Path(tmp) / "other.tar"
        subprocess.run(["git", "archive", "-o", str(archive), commit, PACKAGE], check=True)
        with tarfile.open(archive) as tar:
            tar.extractall(tmp, filter="data")
        return rename_package(Path(tmp) / PACKAGE, dest)


def _time_ms(fn, device, iters):
    for _ in range(2):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _smooth_flow(b, h, w):
    """A slowly varying field that moves every window well inside the image."""
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    flow = torch.stack([3.5 + 0.3 * torch.sin(yy / 5.0) - 0.02 * xx,
                        -2.25 + 0.2 * torch.cos(xx / 7.0)], -1)
    return flow[None].repeat(b, 1, 1, 1)


def _mixed_flow(g, b, h, w):
    """Sub-pixel, zero and far (clamped) displacements, one kind per pixel."""
    frac = torch.randn(b, h, w, 2, generator=g) * 3.0
    far = torch.sign(torch.randn(b, h, w, 2, generator=g)) * (
        60.0 + torch.rand(b, h, w, 2, generator=g) * 500.0)
    kind = torch.randint(0, 3, (b, h, w, 1), generator=g)
    return torch.where(kind == 0, frac, torch.where(kind == 1, 0.0 * frac, far))


def served_b1_args(device, small=False, recipe=None):
    """The arguments of the first B1 call when full-width DMSCT (seeded
    random weights; ``recipe``: one of tools/deep_gate.py's, e.g. "bf16",
    whose correlation is bf16) serves one synthetic 1080p pair (``small``: a
    64x96 pair through a one-layer matcher)."""
    import numpy as np

    from color_transfer_tpu_torch.methods.video import color_transfer_between_videos
    from color_transfer_tpu_torch.models import gmflow
    from color_transfer_tpu_torch.tools import deep_gate

    h, w = (64, 96) if small else (1080, 1920)
    kwargs = {"matcher_num_layers": 1, "matcher_num_reg_refine": 1} if small else {}
    module = deep_gate.build("dmsct", recipe or "", kwargs)
    variables = module.init_eval_variables(seed=0, device=device)
    low = np.random.default_rng(0).uniform(0, 1, (1, 3, 34, 60)).astype(np.float32)
    scene = torch.nn.functional.interpolate(torch.from_numpy(low), size=(h, w + 16),
                                            mode="bilinear", align_corners=False)
    scene = scene.permute(0, 2, 3, 1)
    target = scene[:, :, :w].contiguous()
    reference = (scene[:, :, 16:] * 0.9 + 0.05).clamp(0, 1).contiguous()
    kept = []
    call = gmflow.local_correlation_with_flow

    def keep(f0, f1, flow, local_radius, **kw):
        if not kept:  # the features as the kernel takes them (the recipe's correlation type)
            dtype = kw.get("corr_dtype", torch.float32)
            kept.extend(t.clone() for t in (f0.to(dtype), f1.to(dtype), flow))
        return call(f0, f1, flow, local_radius, **kw)

    gmflow.local_correlation_with_flow = keep
    try:
        color_transfer_between_videos(target, reference, method="dmsct", module=module,
                                      variables=variables, device=device)
    finally:
        gmflow.local_correlation_with_flow = call
    return kept


def cases(device, small, served=False):
    """(name, call(one side's ops modules)) per case, on shared inputs."""
    g = torch.Generator().manual_seed(0)
    h, w, c = (6, 40, 16) if small else (1080, 1920, 64)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(device)

    q, k, v = (randn(1, h, w, c) for _ in range(3))
    for precise in (False, True):
        mode = "precise" if precise else "bf16"
        yield (f"row_attention {mode} both {tuple(q.shape)}", lambda ops, p=precise:
               ops.row_attention.row_attention_warp(q, k, v, 1 / c, p))
        yield (f"row_attention {mode} colsum only {tuple(q.shape)}", lambda ops, p=precise:
               ops.row_attention.row_attention_warp(q, k, None, 1 / c, p))
    kernels = randn(18, 2, 3, 3, c, c, scale=(9 * c) ** -0.5)
    biases = randn(18, 2, c, scale=0.05)
    for batch in (2, 1):
        x = randn(batch, h, w, c)
        for layers in (1, 6, 18):
            yield (f"resb_chain bf16 {tuple(x.shape)} x {layers} blocks",
                   lambda ops, x=x, n=layers: ops.conv_chain.resb_chain(
                       x, kernels[:n], biases[:n], torch.bfloat16))
    del q, k, v, x, kernels, biases

    levels = ((2, 8, 15, 32), (2, 4, 8, 24), (2, 2, 4, 48), (2, 2, 3, 120)) if small else (
        (12, 128, 240, 32), (12, 64, 120, 24), (12, 32, 60, 48), (12, 16, 30, 120))
    for shape in levels:
        b, lh, lw, _ = shape
        grad = randn(*shape)
        frac = torch.randn(b, lh, lw, 2, generator=g) * 3.0
        far = torch.sign(torch.randn(b, lh, lw, 2, generator=g)) * (
            60.0 + torch.rand(b, lh, lw, 2, generator=g) * 500.0)
        kind = torch.randint(0, 3, (b, lh, lw, 1), generator=g)
        mixed = torch.where(kind == 0, frac, torch.where(kind == 1, 0.0 * frac, far))
        for name, flow in (("mixed", mixed.to(device)), ("in-image", frac.to(device))):
            yield (f"warp_adjoint {shape} {name} flow", lambda ops, gr=grad, fl=flow:
                   ops.warp_adjoint.warp_adjoint(gr, fl))

    (bp, length, c), geom = ((8, 35, 128), (2, 5, 7)) if small else (
        (256, 448, 128), (8, 16, 28))
    x, y, z = (randn(bp, length, c) for _ in range(3))
    weights = [randn(*s, scale=s[0] ** -0.5) for s in ((c, c), (c, 2 * c), (c, c))]
    norm = [1 + randn(c, scale=0.1), randn(c, scale=0.1)]
    yield (f"window_attention shift {(bp, length, c)}", lambda ops:
           ops.win_attention.window_attention_fused(x, y, z, shift_windows=geom))
    yield (f"window_sublayer cross {(bp, length, c)}", lambda ops:
           ops.win_attention.window_sublayer_fused(x, y, *weights, *norm))
    yield (f"window_sublayer self shift residual {(bp, length, c)}", lambda ops:
           ops.win_attention.window_sublayer_fused(x, x, *weights, *norm, shift_windows=geom,
                                                   add_residual=True))
    f = 64 if small else 1024
    w0, w2 = randn(2 * c, f, scale=(2 * c) ** -0.5), randn(f, c, scale=f**-0.5)
    yield (f"ffn {(bp, length, c)} F={f}", lambda ops:
           ops.win_attention.ffn_fused(x, y, w0, w2, *norm, add_residual=True))
    del x, y, z, w0, w2
    bf = torch.bfloat16
    wb = [w.to(bf) for w in weights]
    for shape, geom in ([((8, 35, 128), (2, 5, 7))] if small else B2_BF16_SHAPES):
        xb, yb, zb = (randn(*shape).to(bf) for _ in range(3))
        yield (f"window_attention bf16 shift {shape}", lambda ops, a=(xb, yb, zb), s=geom:
               ops.win_attention.window_attention_fused(*a, shift_windows=s))
        yield (f"window_sublayer bf16 cross {shape}", lambda ops, a=(xb, yb):
               ops.win_attention.window_sublayer_fused(*a, *wb, *norm))
        yield (f"window_sublayer bf16 self shift residual {shape}", lambda ops, a=(xb, xb), s=geom:
               ops.win_attention.window_sublayer_fused(*a, *wb, *norm, shift_windows=s,
                                                       add_residual=True))
    w0b, w2b = (randn(2 * c, f, scale=(2 * c) ** -0.5).to(bf),
                randn(f, c, scale=f**-0.5).to(bf))
    for shape, _ in ([((8, 35, 128), None)] if small else B2_BF16_SHAPES):
        xb, yb = (randn(*shape).to(bf) for _ in range(2))
        yield (f"ffn bf16 {shape} F={f}", lambda ops, a=(xb, yb):
               ops.win_attention.ffn_fused(*a, w0b, w2b, *norm, add_residual=True))
    del xb, yb, zb, weights, wb, norm, w0b, w2b

    corr_shapes = ((2, 12, 20, 32), (3, 8, 16, 32)) if small else (
        (2, 128, 224, 128), (24, 64, 120, 128))
    for shape in corr_shapes:
        f0, f1 = randn(*shape), randn(*shape)
        flows = [("smooth", _smooth_flow(*shape[:3]).to(device)),
                 ("mixed", _mixed_flow(g, *shape[:3]).to(device))]
        for (kind, flow), dtype in itertools.product(flows, (torch.float32, bf)):
            name = "local_corr" if dtype == torch.float32 else "local_corr bf16"
            yield (f"{name} {shape} r=4 {kind} flow", lambda ops, a=f0, b=f1, fl=flow, dt=dtype:
                   ops.local_corr.local_correlation_with_flow(a, b, fl, 4, corr_dtype=dt))
    if served:  # the f32 recipe's flow, and the bf16 recipe's (its features bf16)
        for recipe, name in ((None, "local_corr"), ("bf16", "local_corr bf16")):
            f0, f1, flow = served_b1_args(device, small, recipe)
            yield (f"{name} {tuple(f0.shape)} r=4 served flow", lambda ops, a=(f0, f1, flow):
                   ops.local_corr.local_correlation_with_flow(*a, 4, corr_dtype=a[0].dtype))
    del f0, f1, flows

    levels = ((32, 48, 4), (16, 24, 16), (8, 12, 32)) if small else (
        (1080, 1920, 4), (540, 960, 16), (270, 480, 32), (135, 240, 64), (68, 120, 64),
        (34, 60, 64))
    for h, w, nbit in levels:
        out0 = torch.rand(8, h, w, 3, generator=g).to(device)
        const = torch.rand(8, h, w, 3, generator=g).to(device)
        phis = (torch.rand(8, 4, h, w, generator=g) * 15).to(device)
        inv_den = (0.8 / (phis.sum(dim=1) + 1.0)).contiguous()
        yield (f"regrain_sweeps (8, {h}, {w}) nbit={nbit}",
               lambda ops, a=(out0, const, phis, inv_den, nbit):
               ops.regrain_stencil.regrain_sweeps(*a))


def run(other, device, small=False, iters=3, only=None, served=False):
    """One row per case (those whose name matches the regex ``only``):
    {"case", "order", "ms"} with the sides in the order run (other, tree,
    tree, other)."""
    other = Path(other).resolve()
    sys.path.insert(0, str(other.parent))
    sides = {}
    try:
        for side, name in (("tree", PACKAGE), ("other", other.name)):
            sides[side] = argparse.Namespace(
                **{mod: importlib.import_module(f"{name}.ops.{mod}") for mod in
                   ("row_attention", "conv_chain", "warp_adjoint", "win_attention",
                    "local_corr", "regrain_stencil")})
    finally:
        sys.path.pop(0)
    order = ("other", "tree", "tree", "other")
    rows = []
    with torch.no_grad():
        for name, call in cases(device, small, served):
            if only is not None and not re.search(only, name):
                continue
            ms = [_time_ms(lambda: call(sides[side]), device, iters) for side in order]
            rows.append({"case": name, "order": list(order), "ms": [round(t, 4) for t in ms]})
            print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None):
    from color_transfer_tpu_torch.methods.video import resolve_device

    ap = argparse.ArgumentParser(prog=f"{PACKAGE}.tools.kernel_ab")
    ap.add_argument("--other", required=True, help="the other checkout's renamed package")
    ap.add_argument("--prepare", metavar="COMMIT", default=None,
                    help="make --other from this commit (needs git) and stop")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu to rehearse)")
    ap.add_argument("--small", action="store_true", help="tiny shapes")
    ap.add_argument("--only", default=None, help="time only the cases matching this regex")
    ap.add_argument("--served", action="store_true",
                    help="also time B1 on the flow the served DMSCT frame gives it")
    args = ap.parse_args(argv)
    if args.prepare:
        print(prepare(args.prepare, args.other))
        return 0
    device = resolve_device(args.device)
    if device.type == "cuda":  # every number beside its card and power limit
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    run(args.other, device, args.small, only=args.only, served=args.served)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
