"""Device lists for data parallelism in one process — the port of
color_transfer_tpu/parallel/mesh.py (``create_mesh``, ``shard_batch``,
``replicated_sharding``) on a list of ``torch.device``s.

A JAX mesh places one program over many devices and XLA splits the batch.
Here the list is explicit: ``shard_batch`` splits a batch's leading axis
into one piece per listed device, ``replicate`` copies variables to each
device once, and the caller launches every piece before it reads any
result, so the cards overlap. A list may name one device twice (two pieces
on one card, or ``["cpu", "cpu"]``): the split then runs on one device.
"""

import torch


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
