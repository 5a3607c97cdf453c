"""Seeded random weights, drawn by the benchmark on the device in one call
and handed to both the measured program and the reference.

Two laws, named by a configuration's ``init``:
  * ``lecun_normal``: N(0, 1/fan_in) kernels, zero biases and running means,
    unit 1-D scales and running variances, ``num_batches_tracked`` 0;
  * ``uniform_fan_in``: kernels and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    with the kernel's fan-in (torch's Conv2d default).
fan_in is the number of elements of one output channel's kernel."""

import numpy as np
import torch


def derive(seed, *tags):
    """A 63-bit seed for the stream named by ``tags``, from the run's seed."""
    words = np.random.SeedSequence([int(seed) % 2**64, *tags]).generate_state(2, np.uint32)
    return int((int(words[0]) << 31) ^ int(words[1]))


def _fan_in(shapes, name):
    base, leaf = name.rsplit(".", 1) if "." in name else ("", name)
    kernel = shapes[f"{base}.weight" if base else "weight"] if leaf == "bias" else shapes[name]
    return int(np.prod(kernel[1:]))


def draw(shapes, law, seed, device):
    """{name: tensor} for the state_dict ``shapes`` ({name: (shape, dtype)}
    of the reference model) under ``law``, from ``seed``."""
    dims = {k: tuple(s) for k, (s, _) in shapes.items()}
    random, scales, out = [], [], {}
    for name, (shape, dtype) in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
        elif law == "lecun_normal" and (leaf == "running_var" or (leaf == "weight" and len(shape) == 1)):
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        elif law == "lecun_normal" and leaf in ("bias", "running_mean"):
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif law in ("lecun_normal", "uniform_fan_in"):
            random.append(name)
            scales.append(_fan_in(dims, name) ** -0.5)
        else:
            raise ValueError(f"unknown weight law {law!r}")
    counts = [int(np.prod(dims[n])) for n in random]
    g = torch.Generator(device=device).manual_seed(derive(seed, 1))
    total = sum(counts)
    if law == "lecun_normal":
        flat = torch.randn(total, generator=g, device=device)
    else:
        flat = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
    flat *= torch.repeat_interleave(torch.tensor(scales, device=device),
                                    torch.tensor(counts, device=device))
    for name, part in zip(random, flat.split(counts)):
        out[name] = part.view(dims[name])
    return {name: out[name] for name in shapes}


def shapes_of(model):
    """{name: (shape, dtype)} of a model's state_dict (a model built on the
    meta device allocates nothing)."""
    return {k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items()}
