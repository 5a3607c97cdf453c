"""Multi-process start-up and per-process input rows — the port of
color_transfer_tpu/parallel/multihost.py on ``torch.distributed``.

One process drives one card; ``torchrun`` starts them:

    torchrun --nproc_per_node 8 -m color_transfer_tpu_torch.cli fit --config C.yaml

``initialize_distributed`` reads torchrun's environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) unless given the
JAX package's arguments (a config's ``distributed:`` key reads the same in
both packages). It does nothing for a single process started without a
launcher and refuses a multi-process launch without an address, as the JAX
package does: N independent runs would train N times and clobber each
other's checkpoints. Each process loads only its rows of every global batch
(``host_batch_slice``); ``global_batch_from_host_shards`` assembles the
global batch on every process, for logs and tests.
"""

import datetime
import os

import torch
import torch.distributed as dist

# Seconds any collective may wait for the other ranks before the run fails
# (a rank that died must not hang the others).
DEFAULT_TIMEOUT_S = 1800


def rank_world():
    """(rank, world size) of the active process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_device(device=None):
    """The device this process runs on: ``device`` when given (``cuda:0``
    pins every rank to card 0), else ``cuda:{LOCAL_RANK}`` under a launcher,
    else the card (methods/video.py::resolve_device). Raises when the card
    is missing or ``LOCAL_RANK`` names a card that is not visible."""
    from color_transfer_tpu_torch.methods.video import resolve_device

    if device is None and "LOCAL_RANK" in os.environ:
        local = int(os.environ["LOCAL_RANK"])
        resolve_device("cuda")
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK={local} but {torch.cuda.device_count()} card(s) are "
                "visible: start at most one process per card, or pass --device"
            )
        return torch.device("cuda", local)
    return resolve_device(device)


def initialize_distributed(coordinator_address=None, num_processes=None, process_id=None,
                           backend=None, device=None, timeout=DEFAULT_TIMEOUT_S):
    """Join the process group; returns (rank, world size).

    ``coordinator_address`` ("host:port") defaults to torchrun's
    ``MASTER_ADDR:MASTER_PORT``, ``num_processes`` to ``WORLD_SIZE``,
    ``process_id`` to ``RANK``. Without an address a single process returns
    (0, 1) and initialises nothing; a world above 1 raises. With one, even a
    world of 1 joins a group (its collectives then run). ``backend``
    defaults to ``nccl`` for a card and ``gloo`` for the CPU; on a card
    ``torch.cuda.set_device`` runs first (``local_device(device)``).
    ``timeout`` bounds every collective, in seconds. A second call returns
    the group that is already there."""
    if dist.is_initialized():
        return rank_world()
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    world = int(os.environ.get("WORLD_SIZE", "1") if num_processes is None else num_processes)
    rank = int(os.environ.get("RANK", "0") if process_id is None else process_id)
    if coordinator_address is None:
        if world <= 1:
            return 0, 1
        raise ValueError(
            f"num_processes={world} requested but no coordinator address given (start "
            "with torchrun, set MASTER_ADDR/MASTER_PORT or pass coordinator_address)"
        )
    device = local_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=float(timeout)))
    return rank_world()


def host_batch_slice(global_batch_size, process_id=None, num_processes=None):
    """The [start, stop) rows of the global batch this process loads."""
    rank, world = rank_world()
    process_id = rank if process_id is None else process_id
    num_processes = world if num_processes is None else num_processes
    if global_batch_size % num_processes:
        raise AssertionError(f"global batch {global_batch_size} not divisible by "
                             f"{num_processes} processes")
    per_process = global_batch_size // num_processes
    return process_id * per_process, (process_id + 1) * per_process


def global_batch_from_host_shards(local_batch):
    """The global batch on every process from each one's rows
    (``host_batch_slice`` of it; arrays or tensors): a dict of tensors on the
    rows' device. Every rank's rows are written into their place of a zero
    buffer and the buffers summed (``all_reduce``): gloo on CUDA tensors has
    no ``all_gather``, and a sum with zeros is exact. Without a process
    group the rows are the batch."""
    rank, world = rank_world()
    out = {}
    for key, rows in local_batch.items():
        rows = torch.as_tensor(rows)
        if world == 1:
            out[key] = rows
            continue
        buf = rows.new_zeros((rows.shape[0] * world,) + tuple(rows.shape[1:]))
        buf[rank * rows.shape[0]:(rank + 1) * rows.shape[0]] = rows
        dist.all_reduce(buf)
        out[key] = buf
    return out
