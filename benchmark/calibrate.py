"""The readings a cell's output limits are set from, on the card at the
cell's own size, one seed after another in one process:

  * ``program``: the numbers the port's timed entry gives against the
    reference (sound runs: the lower reading);
  * ``control``: the reference computed in TF32, one step below the
    configurations' float32, put in the program's place (the upper reading);
  * a training cell also reads the planted fault ``half_batch`` (the step
    takes the first half of each batch, the loss the mean over it).

    python3 -m benchmark.calibrate --workload <cell> --seeds <n> [<n> ...] [--out <file>]

prints one JSON line a seed (and appends it to ``--out``). Not run by the
benchmark's own runs."""

import argparse
import json
import sys

import torch

from benchmark import cell as cell_mod
from benchmark import fit, serve
from benchmark.faults import plant
from benchmark.run import pin_caches
from benchmark.run_common import free
from benchmark.traffic import fit_pool, serve_clip


def serve_seed(cell, seed, device):
    config, mix = cell.config, cell.traffic
    weights = serve.setup_weights(cell, seed, device)
    module, serve_fn = serve.program(config, weights, device)
    clip = serve_clip(mix, seed, device)
    capture = serve.Capture(module.model, config["capture"])
    capture.armed = True
    idxs = range(mix["check_frames"])
    kept = [(i, serve_fn(clip[0][i:i + 1], clip[1][i:i + 1]), capture.take()) for i in idxs]
    capture.close()
    del module, serve_fn
    free(device)
    program = serve.gaps(kept, clip, cell, weights, device)
    del kept
    control_kept = serve.reference_frames(cell, weights, clip, idxs, device, tf32=True)
    control = serve.gaps(control_kept, clip, cell, weights, device)
    return {"program": program, "control": control}


def fit_seed(cell, seed, device):
    """A one-chip cell reads the program and the program with half of each
    batch left out; a cell over several chips, whose program runs over its
    ranks in the cell's own runs, reads the fault in the reference put in
    the program's place."""
    config, mix = cell.config, cell.traffic
    weights = serve.setup_weights(cell, seed, device)
    pool = fit_pool(mix, seed, device)
    n = mix["check_steps"]
    ref = fit.reference_steps(cell, weights, pool, seed, n, device)
    out = {}
    if cell.chips == 1:
        for name, fault in (("program", None), ("half_batch", "half_batch")):
            with plant(fault, config):
                module, state = fit.program_state(config, weights, pool[0])
                step = fit.stepper(module, state, pool, seed, mix)
                out[name] = fit.compare(fit.check_steps(step, state, weights, n), ref)
            del module, state, step
            free(device)
    else:
        half = [{k: v[:v.shape[0] // 2] for k, v in b.items()} for b in pool]
        out["half_batch"] = fit.compare(
            fit.reference_steps(cell, weights, half, seed, n, device), ref)
    control = fit.reference_steps(cell, weights, pool, seed, n, device, tf32=True)
    out["control"] = fit.compare(control, ref)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    pin_caches()
    cell = cell_mod.load(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    reader = {"serve": serve_seed, "fit": fit_seed}[cell.traffic["kind"]]
    for seed in args.seeds:
        line = json.dumps({"workload": cell.name, "seed": seed, **reader(cell, seed, device)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
