"""The f32 convolutions of a training step, their gradients held to float64.

A training step's convolutions compute two gradients each in the backward:
the input's and the weight's (and the bias's). Which algorithm computes
them on the card depends on the backend (cuDNN, or ATen's im2col + cuBLAS
and depthwise kernels when cuDNN is off), the shape and the memory layout,
and their rounding error grows with the reduction: a weight gradient sums
over batch x height x width. The float64 rule holds each one, at the shape
and layout the recipe gives it, to a float64 run on the CPU: the card's
error, relative to the gradient's max |float64|, at most ``RATIO`` times the
CPU float32 run's error plus ``ATOL``.

``capture(module, state, batch, seed)`` runs one ``train_step`` and keeps,
for each distinct convolution of it (input shape, weight shape, stride,
padding, dilation, groups, the input's memory layout), the first call's
input, weight and output gradient, and how many calls share it.
``gradients`` recomputes a case's gradients as autograd does
(``aten.convolution_backward``) under a backend route; ``check`` holds them
to float64.

    python -m color_transfer_tpu_torch.tools.conv_grads --recipe dcmcs3di
    python -m color_transfer_tpu_torch.tools.conv_grads --recipe dmsct --routes cudnn aten

runs one step of ``configs/<recipe>.yaml``'s recipe (full width, seeded
random weights and crops) on the card and prints one line per case and
gradient; the exit code is 1 when the module's own route breaks the rule.
"""

import argparse
import dataclasses
import sys
import time

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from color_transfer_tpu_torch.core.precision import conv_route

RATIO, ATOL = 4.0, 1e-5
GRADS = ("input", "weight", "bias")
# The recipes at the reference configs' shapes (configs/dmsct.yaml,
# configs/dcmcs3di.yaml): batch and crop.
RECIPES = {"dmsct": (12, (256, 480)), "dcmcs3di": (8, (160, 320))}


@dataclasses.dataclass
class ConvCase:
    """One distinct convolution of a step: its first call's tensors (the
    input and weight as the step passed them, the output gradient as the
    backward produced it) and the number of calls of the step with its
    key."""

    name: str
    x: torch.Tensor
    weight: torch.Tensor
    bias: bool
    stride: tuple
    padding: tuple
    dilation: tuple
    groups: int
    calls: int = 1
    gy: torch.Tensor = None

    def describe(self):
        c_out, c_in, kh, kw = self.weight.shape
        layout = "NHWC" if _channels_last(self.x) else "NCHW"
        extra = "".join([f", stride {self.stride[0]}" if max(self.stride) > 1 else "",
                         f", groups {self.groups}" if self.groups > 1 else ""])
        return (f"{self.name}: ({self.x.shape[0]}, {c_in * self.groups}, {self.x.shape[2]}, "
                f"{self.x.shape[3]}) {layout} -> {c_out}, {kh}x{kw}{extra}, x{self.calls}")


def _channels_last(x):
    return x.is_contiguous(memory_format=torch.channels_last) and not x.is_contiguous()


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class _Tap(torch.autograd.Function):
    """Identity (a copy) whose backward hands the output gradient to a case."""

    @staticmethod
    def forward(ctx, y, case):
        ctx.case = case
        return y.clone()

    @staticmethod
    def backward(ctx, gy):
        ctx.case.gy = gy.detach()
        return gy, None


class _Recorder(TorchFunctionMode):
    """Records every ``F.conv2d`` whose output needs a gradient."""

    def __init__(self, names):
        super().__init__()
        self.names = names  # id(weight) -> parameter name
        self.cases = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is not F.conv2d or not (torch.is_grad_enabled() and out.requires_grad):
            return out
        names = ("input", "weight", "bias", "stride", "padding", "dilation", "groups")
        call = dict(zip(names, args), **kwargs)
        x, w = call["input"], call["weight"]
        stride, dilation = _pair(call.get("stride", 1)), _pair(call.get("dilation", 1))
        padding, groups = _pair(call.get("padding", 0)), int(call.get("groups", 1))
        key = (tuple(x.shape), tuple(w.shape), stride, padding, dilation, groups,
               _channels_last(x), call.get("bias") is not None)
        if key in self.cases:
            self.cases[key].calls += 1
            return out
        case = ConvCase(self.names.get(id(w), "conv"), x.detach(), w.detach(),
                        call.get("bias") is not None, stride, padding, dilation, groups)
        self.cases[key] = case
        return _Tap.apply(out, case)


def capture(module, state, batch, seed=0):
    """One ``module.train_step(state, batch, seed)`` (it updates ``state``)
    -> [ConvCase], in the order of their first calls, each named after the
    parameter its weight is."""
    names = {id(v): k.removesuffix(".weight") for k, v in state.variables.items()}
    recorder = _Recorder(names)
    with recorder:
        module.train_step(state, batch, seed, metrics=False)
    missing = [c.name for c in recorder.cases.values() if c.gy is None]
    if missing:
        raise RuntimeError(f"no output gradient reached {missing}")
    return list(recorder.cases.values())


def gradients(case, device, dtype, cudnn):
    """(input, weight, bias) gradients of ``case`` on ``device`` in
    ``dtype``, as autograd computes them, with cuDNN on or off
    (``conv_route``); the tensors keep their memory layout."""
    x, w, gy = (t.to(device, dtype) for t in (case.x, case.weight, case.gy))
    with conv_route(cudnn):
        gx, gw, gb = torch.ops.aten.convolution_backward(
            gy, x, w, [w.shape[0]] if case.bias else None, case.stride, case.padding,
            case.dilation, False, [0, 0], case.groups, [True, True, case.bias])
    return gx, gw, gb


def _rel(got, ref, scale):
    return float((got.double().cpu() - ref).abs().max()) / scale


def check(cases, routes, device="cuda"):
    """Each case's gradients on ``device`` through each route ({label:
    cudnn on/off}) against float64 on the CPU -> [row]: {case, grad, scale,
    cpu (the CPU float32 error), label: error, 'excess ' + label: error /
    (RATIO x cpu + ATOL)}. Errors are relative to the gradient's max
    |float64|."""
    rows = []
    for case in cases:
        ref = gradients(case, "cpu", torch.float64, True)
        cpu = gradients(case, "cpu", torch.float32, True)
        got = {label: gradients(case, device, torch.float32, on)
               for label, on in routes.items()}
        for i, grad in enumerate(GRADS):
            if ref[i] is None:
                continue
            scale = max(float(ref[i].abs().max()), 1e-30)
            row = {"case": case, "grad": grad, "scale": scale,
                   "cpu": _rel(cpu[i], ref[i], scale)}
            for label in routes:
                row[label] = _rel(got[label][i], ref[i], scale)
                row["excess " + label] = row[label] / (RATIO * row["cpu"] + ATOL)
            rows.append(row)
        del ref, cpu, got
    return rows


def recipe_step(recipe, device="cuda", seed=0, **kwargs):
    """(module, state, batch) of ``recipe`` ("dmsct" or "dcmcs3di") at the
    reference config's batch and crop, full width unless ``kwargs`` say
    otherwise (the module's keywords), seeded random weights and images on
    ``device``."""
    from color_transfer_tpu_torch.run.modules import DCMCS3DIModule, DMSCTModule

    batch_size, (h, w) = kwargs.pop("batch_size", RECIPES[recipe][0]), kwargs.pop(
        "crop", RECIPES[recipe][1])
    module = (DMSCTModule if recipe == "dmsct" else DCMCS3DIModule)(**kwargs)
    g = torch.Generator().manual_seed(seed)
    base = torch.rand(batch_size, h, w + 8, 3, generator=g)
    batch = {"gt": base[:, :, 8:].contiguous().to(device),
             "reference": base[:, :, :-8].contiguous().to(device)}
    state = module.init_state(seed, batch, num_train_steps=10)
    return module, state, batch


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--recipe", choices=sorted(RECIPES), action="append")
    parser.add_argument("--routes", nargs="+", choices=["cudnn", "aten"], default=None,
                        help="default: the module's own route")
    args = parser.parse_args(argv)
    failed = False
    for recipe in args.recipe or sorted(RECIPES):
        module, state, batch = recipe_step(recipe)
        t0 = time.perf_counter()
        cases = capture(module, state, batch)
        own = {"own": module.backward_cudnn}
        routes = {r: r == "cudnn" for r in args.routes} if args.routes else own
        rows = check(cases, routes)
        for row in rows:
            print(f"{recipe} {row['case'].describe()} {row['grad']}: CPU f32 {row['cpu']:.2e}, "
                  + ", ".join(f"{r} {row[r]:.2e} (excess {row['excess ' + r]:.3f})"
                              for r in routes), flush=True)
        worst = max(rows, key=lambda r: max(r["excess " + k] for k in routes))
        print(f"{recipe}: {len(cases)} distinct convs, {len(rows)} gradients "
              f"({time.perf_counter() - t0:.1f} s); worst excess "
              f"{max(worst['excess ' + k] for k in routes):.3f}")
        if not args.routes:
            failed |= any(r["excess own"] > 1.0 for r in rows)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
