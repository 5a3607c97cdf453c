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
and 18 blocks) through their public wrappers at the 1080p path's shapes,
CUDA events after warm-up, and prints one JSON line per case with both
sides' times in the order run. ``--device cpu --small`` runs tiny shapes
through the plain versions (a rehearsal: no device numbers).
"""

import argparse
import importlib
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


def cases(device, small):
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


def run(other, device, small=False, iters=3):
    """One row per case: {"case", "order", "ms"} with the sides in the order
    run (other, tree, tree, other)."""
    other = Path(other).resolve()
    sys.path.insert(0, str(other.parent))
    sides = {}
    try:
        for side, name in (("tree", PACKAGE), ("other", other.name)):
            sides[side] = argparse.Namespace(
                row_attention=importlib.import_module(f"{name}.ops.row_attention"),
                conv_chain=importlib.import_module(f"{name}.ops.conv_chain"))
    finally:
        sys.path.pop(0)
    order = ("other", "tree", "tree", "other")
    rows = []
    with torch.no_grad():
        for name, call in cases(device, small):
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
    args = ap.parse_args(argv)
    if args.prepare:
        print(prepare(args.prepare, args.other))
        return 0
    device = resolve_device(args.device)
    if device.type == "cuda":  # every number beside its card and power limit
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    run(args.other, device, args.small)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
