"""The collectives of a data-parallel train step — what XLA inserts into the
JAX package's sharded step, written out for ``torch.distributed``.

Each rank holds its rows of the global batch (``multihost.host_batch_slice``)
and a full copy of the variables. ``step_shard`` marks a train step: inside
it, ``current_shard()`` tells the code that draws per sample (the target
distortions, drop-connect) and the encoder's BatchNorm which rows this rank
holds, so that every rank draws for the global batch and keeps its rows, and
BatchNorm normalises by the global batch's statistics. After the backward,
``average_gradients`` all-reduces the gradients, bucketed: the modules call
``torch.func.functional_call`` on a variables dict, so DDP's wrapper, which
owns an ``nn.Module``'s parameters, does not fit. ``average_logs`` reduces
the logged values.

Every value a step computes is a rank's estimate whose mean over the ranks
is the global batch's value: a batch mean over equal row counts is, and a
masked mean (DCMCS3DI's photometric and cycle losses) is made one by
dividing by the ranks' mean mask count (``rank_mean``). So the averaged
gradient is the global loss's gradient and the averaged logs are the
global batch's.

Only ``all_reduce``, ``broadcast`` and ``barrier`` run: gloo has no other
collective for CUDA tensors. A gather is a sum of zero buffers that each
rank filled at its own place (exact: the other addends are zeros), so every
rank combines the same numbers in the same order and stays bit-equal.
"""

import contextlib
import contextvars
from typing import NamedTuple

import torch
import torch.distributed as dist

from color_transfer_tpu_torch.parallel.mesh import Axis, axis_stack
from color_transfer_tpu_torch.parallel.multihost import rank_world
from color_transfer_tpu_torch.utils import profiling

BUCKET_BYTES = 25 * 2**20  # gradients all-reduced per call (DDP's default bucket)


class Shard(NamedTuple):
    """This rank's rows [start, start + rows) of a global batch of ``total``
    rows split over ``world`` ranks."""

    start: int
    rows: int
    total: int
    world: int


_SHARD = contextvars.ContextVar("color_transfer_tpu_torch_shard", default=None)


def current_shard():
    """The ``Shard`` of the train step running, or None outside one."""
    return _SHARD.get()


@contextlib.contextmanager
def step_shard(rows):
    """A train step on this rank's ``rows`` rows: yields its ``Shard`` under a
    process group (a world of 1 too) and None without one."""
    rank, world = rank_world()
    if not dist.is_initialized():
        yield None
        return
    token = _SHARD.set(Shard(rank * rows, rows, rows * world, world))
    try:
        yield _SHARD.get()
    finally:
        _SHARD.reset(token)


def gather_rows(x):
    """Every rank's ``x`` stacked on a new leading axis (world, ...), autograd
    aware (the backward sums each slot's gradients over the ranks and hands
    this rank its own)."""
    rank, world = rank_world()
    return axis_stack(x, Axis(None, rank, world))


def batch_moments(x, dims):
    """Mean and biased variance of ``x`` over ``dims`` across the global
    batch (every rank's ``x`` has the same shape). Each rank's mean and M2
    (the sum of squared deviations) combine by Chan's formula, M2 = sum M2_r
    + n sum (mean_r - mean)^2, never by E[x^2] - E[x]^2, which cancels on
    activations with a large mean. Autograd aware."""
    var, mean = torch.var_mean(x, dim=dims, correction=0)
    n = x.numel() // mean.numel()
    both = gather_rows(torch.stack([mean, var * n]))  # (world, 2, C)
    means, m2 = both[:, 0], both[:, 1]
    mean = means.mean(dim=0)
    m2 = m2.sum(dim=0) + n * ((means - mean) ** 2).sum(dim=0)
    return mean, m2 / (n * both.shape[0])


def rank_mean(x):
    """The mean of ``x`` over the ranks inside a train step of world > 1 (a
    count that divides a masked sum), ``x`` itself otherwise. No gradient."""
    shard = current_shard()
    if shard is None or shard.world == 1:
        return x
    with profiling.annotate("dp.allreduce.rank_mean", device=False):
        x = x.detach().clone()
        dist.all_reduce(x)
    return x / shard.world


def gradient_buckets(grads):
    """``grads`` in order, cut into buckets of about ``BUCKET_BYTES`` (one
    dtype and device a bucket) -> a list of lists."""
    buckets, size = [], 0
    for g in grads:
        if (not buckets or size + g.numel() * g.element_size() > BUCKET_BYTES
                or g.dtype != buckets[-1][0].dtype or g.device != buckets[-1][0].device):
            buckets.append([])
            size = 0
        buckets[-1].append(g)
        size += g.numel() * g.element_size()
    return buckets


def average_gradients(params):
    """Replace each parameter's ``.grad`` by its mean over the ranks: the
    gradients are flattened into ``gradient_buckets``, each bucket
    all-reduced once."""
    _, world = rank_world()
    for bucket in gradient_buckets([p.grad for p in params if p.grad is not None]):
        with profiling.annotate("dp.allreduce.grads", device=False):
            flat = torch.cat([g.reshape(-1) for g in bucket])
            dist.all_reduce(flat)
        flat /= world
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def average_logs(logs):
    """Each logged 0-d tensor's mean over the ranks, in one all-reduce."""
    _, world = rank_world()
    keys = sorted(logs)
    with profiling.annotate("dp.allreduce.logs", device=False):
        flat = torch.stack([logs[k].detach().float().reshape(()) for k in keys])
        dist.all_reduce(flat)
    flat /= world
    return dict(zip(keys, flat.unbind()))


def broadcast_variables(variables):
    """Copy rank 0's variables (name -> tensor) into every rank's, in place,
    in sorted name order."""
    with torch.no_grad():
        for name in sorted(variables):
            dist.broadcast(variables[name].data, 0)


def barrier():
    """Wait for every rank (no-op without a process group)."""
    if dist.is_initialized():
        dist.barrier()
