"""One run of one benchmark cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
It builds and warms the cell (set-up), measures for ``--seconds``, checks
the window's outputs against the plain reference, and prints one JSON line
last: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` (with ``busy_s`` and ``window_s`` when traced),
``breakdown`` when traced, and ``checks`` (each number compared beside its
limit), which also close standard error. Without the cards it prints no
result and exits 2; with JAX or the JAX package loaded it exits 3."""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "color_transfer_tpu"}


def process_start():
    """This process's start on the perf_counter clock (Linux: from
    /proc/self/stat and /proc/uptime; else now)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_PROCESS = process_start()


def pin_caches():
    """Build and kernel caches inside the checkout, at fixed paths. The
    port's CUDA kernels build into its own ``_build/`` directory there."""
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))


def loaded_forbidden():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def execute(cell, seed, seconds, trace_on, device, t_process=None):
    """Run ``cell`` on ``device`` -> the result line (a dict) and the notes
    for standard error. Makes no check of the device."""
    import torch

    from benchmark import fit, serve

    device = torch.device(device)
    readers = cell.readers() if trace_on else {}
    kind = {"serve": serve, "fit": fit}[cell.traffic["kind"]]
    out = kind.run(cell, seed, seconds, trace_on, device,
                     T_PROCESS if t_process is None else t_process, readers)
    if out is None:  # a rank other than 0
        return None, []
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace_on:
        # The port's span records: the readers that read them imported
        # program_trace before set-up, which turned the recorder on.
        from benchmark import program_trace

        run = RunView(cell, out, program_trace.records())
        values = {name: r.read(run) for name, r in readers.items()}
    else:
        values = {m["name"]: out.e2e[m["name"]] for m in cell.end_to_end}
    metrics = {k: {"value": float(v), "unit": units[k]} for k, v in values.items() if v is not None}
    checks = {k: {"value": out.numbers[k], "limit": lim["limit"]}
              for k, lim in cell.limits.items()}
    correct = out.failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": out.peak_bytes}
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device_info}
    if trace_on:
        device_info["busy_s"] = out.digest["busy_s"]
        device_info["window_s"] = out.digest["window_s"]
        result["breakdown"] = {"device_ops": out.digest["device_ops"],
                               "idle_gaps": out.digest["idle_gaps"]}
    result["checks"] = checks
    notes = out.notes + [f"numbers: {json.dumps(out.numbers)}"]
    return result, notes


class RunView:
    """What a per-layer reader sees of a traced run: the cell's FLOPs a frame
    or step (None where the cell has no count), the spans recorded from
    outside, the device trace's digest and the port's own span records."""

    def __init__(self, cell, out, records=()):
        self.chips, self.units, self.window_s = cell.chips, out.units, out.window_s
        self.spans, self.span_shapes = out.spans or {}, out.span_shapes or {}
        self.digest = out.digest
        self.records = list(records)
        self.flops_per_unit = cell.flops["flops"] if cell.flops else None


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    pin_caches()
    from benchmark import cell as cell_mod

    cell = cell_mod.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    if cell.chips > 1:
        from benchmark.ranks import launch

        return launch(cell, args.seed, args.seconds, bool(args.trace), T_PROCESS)
    result, notes = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    return report(result, notes)


def report(result, notes):
    """Prints the notes, the checks and last the result line -> the exit
    code: 3 without a result when JAX or the JAX package was loaded."""
    bad = loaded_forbidden()
    if bad:
        print(f"benchmark: JAX or the JAX package was loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for note in notes:
        print(note, file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
