"""Device lists for data parallelism in one process — the port of
color_transfer_tpu/parallel/mesh.py (``create_mesh``, ``shard_batch``,
``replicated_sharding``) on a list of ``torch.device``s.

A JAX mesh places one program over many devices and XLA splits the batch.
Here the list is explicit: ``shard_batch`` splits a batch's leading axis
into one piece per listed device, ``replicate`` copies variables to each
device once, and the caller launches every piece before it reads any
result, so the cards overlap. A list may name one device twice (two pieces
on one card, or ``["cpu", "cpu"]``): the split then runs on one device.

``process_mesh`` lays the ranks of a process group out as a JAX mesh (one
process a device): the row-sharded evaluation (``row_attention_sp``) and the
matcher's tensor parallelism (``tensor_parallel``) take their groups from
it.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from color_transfer_tpu_torch.utils import profiling


def create_mesh(devices=None):
    """``devices`` as a list of torch.device; None means every visible card
    (the JAX ``create_mesh()``'s every device). "cuda" without an index is
    the current card. Raises for a card when there is none."""
    from color_transfer_tpu_torch.methods.video import resolve_device

    if devices is None:
        resolve_device("cuda")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("an empty device list")
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devices]


def pad_to_devices(x, n):
    """Pad the leading axis of ``x`` up to a multiple of ``n`` by repeating
    its last item (the JAX package's ragged chunk) -> (padded, true length)."""
    actual = x.shape[0]
    pad = -actual % n
    if pad:
        x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])], dim=0)
    return x, actual


def shard_batch(batch, devices):
    """Split each tensor of ``batch`` (a dict) along its leading axis into
    one equal piece per device and move it there -> a list of dicts, one
    per device. The leading axis must divide by the number of devices."""
    n = len(devices)
    out = [{} for _ in devices]
    for key, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"{key}: {x.shape[0]} rows do not split over {n} devices")
        for piece, part, device in zip(out, x.chunk(n, dim=0), devices):
            piece[key] = part.to(device)
    return out


def replicate(variables, devices):
    """One copy of ``variables`` (name -> tensor) on each device: a list
    aligned with ``devices``. A device named twice shares one copy, and the
    variables' own device uses them as they are."""
    copies = {}
    out = []
    for device in devices:
        if device not in copies:
            copies[device] = {k: v.to(device) for k, v in variables.items()}
        out.append(copies[device])
    return out


class Axis(NamedTuple):
    """One mesh axis as this process sees it: the process group of the
    ranks that differ from it only along the axis (None without a process
    group), this rank's index along it and its size."""

    group: object
    index: int
    size: int


def process_mesh(shape=None, axis_names=("data",)):
    """The process group as a mesh (the JAX ``create_mesh(shape,
    axis_names)`` over processes instead of devices) -> {axis name: Axis};
    rank r sits at the row-major position of r in ``shape``. Every rank
    calls it with the same arguments, as ``torch.distributed.new_group``
    requires. ``shape`` defaults to (world, 1, ...). Without a process
    group the mesh has one rank and no groups."""
    import torch.distributed as dist

    from color_transfer_tpu_torch.parallel.multihost import rank_world

    rank, world = rank_world()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not name its axes {axis_names}")
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} ranks, the "
                         f"process group has {world}")
    position = np.unravel_index(rank, shape)
    mesh = {}
    for axis, name in enumerate(axis_names):
        group = None
        if dist.is_initialized():
            # Every rank creates every group of the axis, in one order.
            for other in np.ndindex(*(s for i, s in enumerate(shape) if i != axis)):
                ranks = [int(np.ravel_multi_index(
                    other[:axis] + (j,) + other[axis:], shape)) for j in range(shape[axis])]
                made = dist.new_group(ranks)
                if rank in ranks:
                    group = made
        mesh[name] = Axis(group, int(position[axis]), shape[axis])
    return mesh


class _AxisAllReduce(torch.autograd.Function):
    """A summing all-reduce over one mesh axis's group (None: every rank)
    whose backward all-reduces the gradient (the rule of
    torch.distributed.nn.functional.all_reduce, kept here: torch marks that
    module deprecated)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        with profiling.annotate("dp.allreduce.moments", device=False):
            x = x.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _AxisAllReduce.apply(grad, ctx.group), None


def axis_sum(x, axis):
    """The sum of every rank's ``x`` along a mesh ``Axis`` (x itself on an
    axis of one rank). Autograd aware."""
    if axis.size == 1:
        return x
    return _AxisAllReduce.apply(x, axis.group)


def axis_stack(x, axis):
    """Every rank's ``x`` along a mesh ``Axis``, stacked on a new leading
    axis (size, ...): each rank writes its own slot of a zero buffer and
    the buffers are summed, so the ranks stay bit-equal (gloo has no
    all_gather for CUDA tensors)."""
    if axis.size == 1:
        return x[None]
    buf = torch.stack([x if i == axis.index else torch.zeros_like(x)
                       for i in range(axis.size)])
    return axis_sum(buf, axis)
