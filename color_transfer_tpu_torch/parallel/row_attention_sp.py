"""Sequence-parallel DCMCS3DI evaluation: image rows sharded over ranks —
the port of color_transfer_tpu/parallel/row_attention_sp.py on
``torch.distributed``.

The (B, H, W, W) cost volumes of the materialised matcher are row-wise:
each image row's cross-view attention, its column sums and the warp stay
within the row, so a rank that holds H / n rows builds only its rows of the
volumes and the matcher needs no exchange. The convolutions do: every
DCMCS3DI conv is stride 1 with 'same' zero padding, so a k x k conv on a
band of rows needs k // 2 rows from each neighbouring band.
``models/layers.py::conv`` takes them inside ``row_shard(axis)``
(``halo_rows``): each rank writes its top and bottom edge rows at its own
place in a zero buffer and the buffers are summed over the ``seq`` axis's
group (gloo has no other collective for CUDA tensors, and the ranks stay
bit-equal); the image's top and bottom take zeros, and the width keeps its
zero padding. So the sharded output equals the unsharded one up to the
convs' summation order. GSPMD inserts the same halos in the JAX package.

``sharded_eval_forward`` shards frames over a ``data`` axis and rows over a
``seq`` axis of a ``parallel.mesh.process_mesh``; both entry points return
the whole result on every rank, gathered the same way, as JAX returns one
global array. The path is the materialised one, which ``eval_forward`` takes
on one card wherever the volumes fit (kernel B5 is its one-card route where
they do not), and bucketed evaluation's ``valid_w`` is not on it, as in JAX.
"""

import contextlib
import contextvars

import torch
import torch.nn.functional as F

from color_transfer_tpu_torch.core.precision import full_f32_inference
from color_transfer_tpu_torch.parallel.mesh import axis_stack, process_mesh

_ROWS = contextvars.ContextVar("color_transfer_tpu_torch_row_shard", default=None)
# Bytes that the halo exchanges of this process have summed (each
# all-reduce counts its buffer once): the traffic ``--scaling`` prints.
halo_bytes = 0


def current_row_shard():
    """The ``seq`` mesh axis that image rows are sharded over, or None."""
    return _ROWS.get()


@contextlib.contextmanager
def row_shard(axis):
    """Convolutions inside take their row halos over ``axis`` (a
    parallel.mesh ``Axis``)."""
    token = _ROWS.set(axis)
    try:
        yield axis
    finally:
        _ROWS.reset(token)


def row_bounds(h, axis):
    """[start, stop) of this rank's rows of an image of ``h`` rows."""
    if h % axis.size:
        raise ValueError(f"{h} image rows do not split over {axis.size} ranks")
    rows = h // axis.size
    return axis.index * rows, (axis.index + 1) * rows


def halo_rows(x, pad, axis):
    """(B, h, W, C) rows of this rank -> (B, h + 2 pad, W, C): the ``pad``
    rows above from the rank before along ``axis``, the ``pad`` rows below
    from the rank after, zeros at the image's top and bottom."""
    global halo_bytes
    if pad > x.shape[1]:
        raise ValueError(f"a halo of {pad} rows exceeds a band of {x.shape[1]}")
    # Summed in f32 (exact: one addend is nonzero), whatever x's dtype.
    edges = axis_stack(torch.stack([x[:, :pad], x[:, -pad:]]).float(), axis).to(x.dtype)
    halo_bytes += edges.numel() * 4  # (n, 2, B, p, W, C) f32 an all-reduce
    zeros = x.new_zeros(x[:, :pad].shape)
    top = edges[axis.index - 1, 1] if axis.index > 0 else zeros
    bottom = edges[axis.index + 1, 0] if axis.index < axis.size - 1 else zeros
    return torch.cat([top, x, bottom], dim=1)


def conv2d_rows(x, weight, padding, axis):
    """F.conv2d of NCHW ``x`` (this rank's rows) with 'same' zero padding
    along a row-sharded height: the halo rows taken from the neighbours, the
    width padded as before. No bias."""
    pad_h, pad_w = padding
    if pad_h == 0 or axis.size == 1:
        return F.conv2d(x, weight, None, padding=padding)
    nhwc = halo_rows(x.permute(0, 2, 3, 1), pad_h, axis)
    return F.conv2d(nhwc.permute(0, 3, 1, 2), weight, None, padding=(0, pad_w))


def _gather(local, mesh, shape):
    """The whole (B, H, ...) result from every rank's (frames, rows) block:
    each rank writes its block into a zero buffer, the buffers are summed
    over every rank."""
    data, seq = mesh["data"], mesh["seq"]
    full = local.new_zeros(shape)
    b, h = local.shape[:2]
    full[data.index * b:(data.index + 1) * b, seq.index * h:(seq.index + 1) * h] = local
    if data.size * seq.size > 1:
        import torch.distributed as dist

        dist.all_reduce(full)
    return full


def _mesh(mesh):
    """A (data, seq) mesh: ``mesh`` itself, else every rank over ``seq``."""
    if mesh is None:
        mesh = process_mesh(None, ("seq", "data"))
    if "seq" not in mesh or "data" not in mesh:
        raise ValueError("a row-sharded mesh needs 'data' and 'seq' axes")
    return mesh


def _frames(b, axis):
    if b % axis.size:
        raise ValueError(f"{b} frames do not split over {axis.size} ranks")
    n = b // axis.size
    return slice(axis.index * n, (axis.index + 1) * n)


def sharded_eval_forward(module, variables, batch, mesh=None):
    """DCMCS3DI evaluation (``DCMCS3DIModule.eval_forward``'s materialised
    matcher at inference, TF32 off) with frames over the
    mesh's ``data`` axis and image rows over its ``seq`` axis: every rank
    holds its rows of the cost volumes, the convs trade row halos, and
    every rank returns the whole (B, H, W, 3) output. ``batch`` holds the
    whole 'target' and 'reference' (B, H, W, 3) on every rank; ``mesh``
    defaults to every rank over ``seq`` (``process_mesh(shape,
    ("data", "seq"))`` gives a 2D layout)."""
    mesh = _mesh(mesh)
    target, reference = batch["target"], batch["reference"]
    frames = _frames(target.shape[0], mesh["data"])
    start, stop = row_bounds(target.shape[1], mesh["seq"])
    with full_f32_inference(), row_shard(mesh["seq"]):
        out, _ = torch.func.functional_call(
            module.model, variables,
            (target[frames, start:stop], reference[frames, start:stop]),
            {"inference": True}, strict=True)
    return _gather(out, mesh, target.shape[:-1] + out.shape[-1:])


def sharded_parallax_inference(q_l, k_r, v_r, q_r, k_l, scale, mesh=None):
    """The row-sharded materialised parallax attention (the counterpart of
    ops/row_attention.py::fused_parallax_inference): warp = softmax(q_l
    k_r^T * scale) v_r and the left valid mask (the column sums of
    softmax(q_r k_l^T * scale) above 0.1), each rank on its rows of the
    whole (B, H, W, C) inputs -> the whole (warped, (B, H, W, 1) bool mask)
    on every rank."""
    from color_transfer_tpu_torch.models import pasm

    mesh = _mesh(mesh)
    start, stop = row_bounds(q_l.shape[1], mesh["seq"])
    frames = _frames(q_l.shape[0], mesh["data"])
    q_l, k_r, v_r, q_r, k_l = (x[frames, start:stop] for x in (q_l, k_r, v_r, q_r, k_l))
    with full_f32_inference():
        att_r2l = torch.softmax(torch.einsum("bhwc,bhvc->bhwv", q_l, k_r) * scale, dim=-1)
        att_l2r = torch.softmax(torch.einsum("bhwc,bhvc->bhwv", q_r, k_l) * scale, dim=-1)
        warped = pasm.warp(v_r, att_r2l)
        mask = (att_l2r.sum(dim=-2) > 0.1)[..., None]
        b, h = q_l.shape[0] * mesh["data"].size, q_l.shape[1] * mesh["seq"].size
        warped = _gather(warped, mesh, (b, h) + warped.shape[2:])
        mask = _gather(mask.float(), mesh, (b, h) + mask.shape[2:]) > 0.5
    return warped, mask
