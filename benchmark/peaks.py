"""The yardstick: NVIDIA H100 SXM data-sheet peaks at its 700 W limit (dense
rates) and a kernel's least time on them.

Device memory 3.35 TB/s; 67 TFLOP/s in float32 outside the tensor cores,
495 TFLOP/s in TF32 and 989 TFLOP/s in bf16 on them. A kernel's bound is the
larger of its bytes (each input read once, each output written once) over
the memory rate and its operations over the rate of their type. A cell's
FLOPs a frame or step, which ``mfu`` reads from ``flops/<cell>.json``, are
counted on its plain reference by ``reference_flops``."""

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12}


def bound_s(bytes_moved, ops):
    """(seconds, "bytes" or "operations") for ``bytes_moved`` bytes and
    ``ops`` {type: operations}."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = max((n / PEAK_OPS_PER_S[k] for k, n in ops.items()), default=0.0)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def local_corr_bound_s(b, h, w, c, r, itemsize=4):
    """B1 (GMFlow's flow-displaced local correlation) at (B, H, W, C) and
    radius r: f0, f1 and the flow read once and the (2r+1)^2 outputs written
    once; the (2r+2)^2 window's C-channel dots of every pixel whose window
    touches the image, at most every pixel. At C = 128, r = 4 in float32 the
    dots of every pixel take less time than the bytes, so the bytes bound
    whatever the flow and the count needs no flow."""
    px = b * h * w
    bytes_moved = 2 * px * c * itemsize + 4 * (2 * px + px * (2 * r + 1) ** 2)
    most_ops = {"f32": px * (2 * r + 2) ** 2 * 2 * c}
    t, by = bound_s(bytes_moved, most_ops)
    if by != "bytes":
        raise ValueError(f"B1 at {(b, h, w, c, r)}: the dots may bound it; count its live pixels")
    return t


def reference_flops(cell, shape):
    """FLOPs of one frame (a ``serve`` cell) or one training step (a
    ``fit`` cell: forward and backward, no recomputation) of the cell's
    plain reference on inputs of ``shape`` (B, H, W, 3), counted by
    ``torch.utils.flop_counter`` on fake tensors (nothing allocated)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    ref = cell.reference()
    with FakeTensorMode():
        model = ref.build(cell.config)
        x = {k: torch.rand(*shape) for k in ("gt", "target", "reference")}
        with FlopCounterMode(display=False) as counter:
            if cell.traffic["kind"] == "serve":
                model.eval()
                with torch.no_grad():
                    ref.serve(model, x["target"], x["reference"])
            else:
                model.train()
                loss = ref.train_loss(model, x, None)
                torch.autograd.grad(loss, [p for n, p in model.named_parameters()
                                           if ref.trainable(n)])
    return counter.get_total_flops()
