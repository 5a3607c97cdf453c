"""The ``fit`` cells: the port's training step, called as ``run/trainer.py``
calls it (``module.train_step(state, batch, seed, metrics=step % log_every
== 0)``), on batches of stereo crops made on the device from the seed.

Set-up builds one training state, loads the benchmark's weights into it and
drives it through ``check_steps`` steps on distinct batches, through the
window's own call and feed; the same state then runs the window. The first
step's gradient is read back from the optimizer's first moment (Adam's
m = (1 - beta1) g after one step), and the parameters' change after the
check steps from the state. Once the window has closed, the reference
retakes those steps from the same weights, batches and seeds and the gaps
are held to the cell's limits:

  * ``loss_rel``: the largest relative gap of a step's loss;
  * ``grad_gap`` / ``delta_gap``: over the trainable leaves, the largest gap
    between the program's and the reference's norm of the first gradient /
    of the change, over the larger of the reference leaf's norm and the
    median leaf's. The change leaves out leaves whose reference gradient is
    under a thousandth of the median leaf's: Adam moves them by round-off.
"""

import math
import time
from contextlib import nullcontext

import torch

from benchmark import trace
from benchmark.reference import precision
from benchmark.run_common import Outcome, free, peak_bytes, set_up, sync
from benchmark.serve import setup_weights
from benchmark.traffic import fit_pool
from benchmark.weights import derive


RUNNING = ("running_mean", "running_var")  # BatchNorm's statistics, moved by the step


def step_seed(seed, i):
    return derive(seed, 5, i) % 2**62


def program_state(config, weights, sample):
    """The port's module and a training state holding ``weights``."""
    from color_transfer_tpu_torch.run import modules

    module = getattr(modules, config["module"])(**config["kwargs"])
    state = module.init_state(0, sample)
    with torch.no_grad():
        for name, value in state.variables.items():
            value.copy_(weights[name])
    return module, state


def learning_rate(opt, i):
    """The optimizer's rate at update ``i``: constant, or a cosine decay
    from ``lr`` to ``final_lr`` over ``cosine_steps`` updates."""
    if "cosine_steps" not in opt:
        return opt["lr"]
    t, alpha = min(i, opt["cosine_steps"]), opt["final_lr"] / opt["lr"]
    return opt["lr"] * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / opt["cosine_steps"])) + alpha)


def _norms(tensors):
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


def _gap(prog, ref, names):
    """max over ``names`` of |prog - ref| / max(ref, the median of ref)."""
    vals = sorted(ref[k] for k in names)
    median = vals[len(vals) // 2]
    return max(abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) for k in names)


def reference_steps(cell, weights, pool, seed, steps, device, tf32=False):
    """The reference's first ``steps`` steps -> (losses, first gradients,
    changes, running statistics' changes)."""
    from benchmark.reference.distortions import distort_batch

    ref_mod, config = cell.reference(), cell.config
    model = ref_mod.build(config).to(device)
    model.load_state_dict(weights)
    model.train()
    params = {n: p for n, p in model.named_parameters() if ref_mod.trainable(n)}
    opt = config["optimizer"]
    b1, b2 = opt["betas"]
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, grads1 = [], None
    for i in range(steps):
        batch = pool[i]
        s = step_seed(seed, i)
        with precision(tf32, cudnn=ref_mod.CUDNN):
            target = distort_batch(batch["gt"], s)
            data = {"gt": batch["gt"], "target": target, "reference": batch["reference"]}
            gen = torch.Generator(device=device).manual_seed(s)
            loss = ref_mod.train_loss(model, data, gen)
            grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        if i == 0:
            grads1 = {n: g.detach().clone() for n, g in zip(params, grads)}
        lr = learning_rate(opt, i)
        with torch.no_grad():
            for (n, p), g in zip(params.items(), grads):
                p.mul_(1 - lr * opt["weight_decay"])
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[n] / (1 - b2 ** (i + 1))).sqrt() + opt["eps"]
                p.sub_(lr * (m[n] / (1 - b1 ** (i + 1))) / denom)
    change = {n: (p.detach() - weights[n]) for n, p in params.items()}
    moved = {n: b - weights[n] for n, b in model.named_buffers() if n.endswith(RUNNING)}
    return losses, grads1, change, moved


def compare(prog, ref):
    """The numbers from (losses, first gradients, changes, running
    statistics' changes) of the program and of the reference; ``bn_gap``
    (the running statistics' change, leaf by leaf as ``delta_gap``) where
    the model keeps any."""
    losses, g1, change, stats = prog
    r_losses, r_g1, r_change, r_stats = ref
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses))
    gp, gr = _norms(g1), _norms(r_g1)
    names = sorted(gr)
    grad_gap = _gap(gp, gr, names)
    median_g = sorted(gr.values())[len(gr) // 2]
    moved = [k for k in names if gr[k] >= 1e-3 * median_g]
    delta_gap = _gap(_norms(change), _norms(r_change), moved)
    out = {"loss_rel": loss_rel, "grad_gap": grad_gap, "delta_gap": delta_gap,
           "leaves_compared": float(len(moved)), "leaves": float(len(names))}
    if r_stats:
        out["bn_gap"] = _gap(_norms(stats), _norms(r_stats), sorted(r_stats))
    return out


def stepper(module, state, pool, seed, mix):
    """Step i of the run: the trainer's call on the pool's batches in turn
    -> the step's loss (a device scalar). ``first`` starts a phase (the
    check steps, the window): the phase's steps take the quality metrics
    every ``log_every`` steps from its own first, as the trainer's log steps
    fall from its first step, so every window holds its log steps at the
    same places; ``log`` False takes none."""
    def step(i, first=0, log=True):
        _, logs = module.train_step(state, pool[i % len(pool)], step_seed(seed, i),
                                    metrics=log and (i - first) % mix["log_every"] == 0)
        return logs["Training Total Loss"]

    return step


def check_steps(step, state, weights, steps):
    """The first ``steps`` steps (the first a log step, which warms the
    quality metrics up) -> (losses, the first gradient of each trainable
    leaf read back from Adam's first moment, each leaf's change)."""
    names = {id(p): n for n, p in state.variables.items()}
    beta1 = state.optimizer.param_groups[0]["betas"][0]
    losses = []
    for i in range(steps):
        losses.append(float(step(i)))
        if i == 0:  # a leaf the optimizer never stepped has no moment: read as 0
            g1 = {names[id(p)]: state.optimizer.state[p]["exp_avg"] / (1 - beta1)
                  if "exp_avg" in state.optimizer.state[p] else torch.zeros_like(p)
                  for group in state.optimizer.param_groups for p in group["params"]}
    change = {n: state.variables[n].detach() - weights[n] for n in g1}
    moved = {n: state.variables[n].detach() - weights[n] for n in state.variables
             if n.endswith(RUNNING)}
    return losses, g1, change, moved


def _fingerprint(state):
    """An exact fingerprint of a rank's variables: the sum of their bit
    patterns (int64)."""
    total = 0
    for name in sorted(state.variables):
        v = state.variables[name].detach()
        if v.is_floating_point():
            total = total + v.contiguous().view(torch.int32).to(torch.int64).sum()
    return total


def _ranks_differ(state, rank, world, device):
    """1.0 when any rank's variables differ from rank 0's by a bit, else 0."""
    import torch.distributed as dist

    prints = torch.zeros(world, dtype=torch.int64, device=device)
    prints[rank] = _fingerprint(state)
    dist.all_reduce(prints)
    return float(bool((prints != prints[0]).any()))


def run(cell, seed, seconds, trace_on, device, t_process, readers=None):
    """One run on this process's card; under a process group every rank
    takes its rows of each global batch, rank 0 decides when the window
    closes, and only rank 0 reports (the others return None)."""
    import torch.distributed as dist

    config, mix = cell.config, cell.traffic
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if world > 1 else 0
    marks = [("start", t_process), ("imports", time.perf_counter())]
    weights = setup_weights(cell, seed, device)
    sync(device)
    marks.append(("weights", time.perf_counter()))
    pool = fit_pool(mix, seed, device)
    rows = mix["batch"] // world
    local = [{k: v[rank * rows:(rank + 1) * rows] for k, v in b.items()} for b in pool]
    sync(device)
    marks.append(("batches", time.perf_counter()))
    module, state = program_state(config, weights, local[0])
    if world > 1:
        from color_transfer_tpu_torch.parallel.data_parallel import broadcast_variables

        broadcast_variables(state.variables)  # as the trainer starts a multi-card fit
    sync(device)
    marks.append(("state", time.perf_counter()))
    step = stepper(module, state, local, seed, mix)
    prog = check_steps(step, state, weights, mix["check_steps"])
    differ = _ranks_differ(state, rank, world, device) if world > 1 else 0.0
    sync(device)
    marks.append(("check steps", time.perf_counter()))

    wanted = {}
    for r in (readers or {}).values():
        wanted.update(getattr(r, "SPANS", {}))
    traced = trace_on and rank == 0
    spans = trace.Spans(module.model, wanted) if traced else None
    prof = trace.profiler() if traced else nullcontext()
    ctrl = dist.new_group(backend="gloo") if world > 1 else None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    window_losses = []
    first = i = mix["check_steps"]
    setup_s = time.perf_counter() - t_process
    with prof:
        start = time.perf_counter()
        while True:
            window_losses.append(step(i, first))
            i += 1
            done = torch.tensor([time.perf_counter() - start >= seconds])
            if ctrl is not None:  # rank 0's clock closes every rank's window
                dist.broadcast(done, 0, group=ctrl)
            if done.item():
                break
        sync(device)
        window_s = time.perf_counter() - start
    peak = peak_bytes(device)
    span_ms = spans.close() if spans else None
    span_shapes = dict(spans.shapes) if spans else None
    digest = trace.digest(prof, window_s) if traced else None
    if trace_on:  # every rank steps on: the steps' collectives join them all
        with (trace.profiler(host_ops=True) if traced else nullcontext()) as labelled:
            for k in range(trace.LABEL_UNITS):
                step(i + k, log=False)
            sync(device)
        if traced:
            digest["idle_gaps"] = trace.idle_gaps(labelled)
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    if world > 1:
        top = torch.tensor([peak], dtype=torch.int64, device=device)
        dist.all_reduce(top, op=dist.ReduceOp.MAX)
        peak = int(top)
        dist.barrier()
        dist.destroy_process_group()
    del module, state, step
    free(device)
    if rank != 0:
        return None

    ref = reference_steps(cell, weights, pool, seed, mix["check_steps"], device)
    numbers = compare(prog, ref)
    if world > 1:
        numbers["ranks_differ"] = differ
    steps = len(window_losses)
    # A data-parallel cell reports its rate under a name of its own: its runs
    # spread far wider than one card's, and a shared bound would hide a
    # one-card regression.
    rate = "dp_train_samples_per_s" if world > 1 else "train_samples_per_s"
    return Outcome(
        attempted=steps, failed=failed, units=steps, window_s=window_s, setup_s=setup_s,
        peak_bytes=peak, numbers=numbers, spans=span_ms,
        span_shapes=span_shapes, digest=digest,
        e2e={rate: mix["batch"] * steps / window_s,
             "peak_mem_gib": peak / 2**30, "setup_s": setup_s},
        notes=[set_up(marks),
               f"{steps} steps of {mix['batch']} crops over {world} rank(s) in {window_s:.3f} s, "
               f"{-(-steps // mix['log_every'])} of them log steps; "
               f"check losses {prog[0]} against {ref[0]}"],
    )
