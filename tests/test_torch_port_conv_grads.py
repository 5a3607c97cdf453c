"""The float64 rule's machinery on the CPU (color_transfer_tpu_torch/tools/
conv_grads.py, core/precision.py::conv_route and the modules' backward
routes). The card check itself (every distinct f32 conv of each recipe's
step at the recipe's shape against float64) is in
test_torch_port_kernels_cuda.py and chip_smoke.py phases 7 and 10.

Here, at tiny widths: ``capture`` finds every conv of a train step (the
calls of its cases add up to the step's convs) without changing the step
(the variables after it bit-equal to a plain step's); ``gradients``
computes what autograd computes (bit-equal on the CPU); ``check`` holds
the CPU against float64 under the rule; each module's train step runs its
backward convolutions through the route its ``backward_cudnn`` names.
"""

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from color_transfer_tpu_torch.run.modules import DCMCS3DIModule, DMSCTModule
from color_transfer_tpu_torch.tools import conv_grads as cg
from test_torch_port_core import one_torch_thread  # noqa: F401  (an autouse fixture)

SMALL = {"dcmcs3di": dict(extraction_layers=2, transfer_layers=1, channels=8),
         "dmsct": dict(matcher_num_layers=1, matcher_num_reg_refine=1)}
CROP = dict(batch_size=2, crop=(32, 64))


def _step(recipe, seed=0):
    return cg.recipe_step(recipe, "cpu", seed=seed, **CROP, **SMALL[recipe])


@pytest.mark.parametrize("recipe,calls", [("dcmcs3di", 1 + 2 * 2 + 2 + 2 + 1 + 1 + 2 * 1 + 2),
                                          ("dmsct", None)])
def test_capture_finds_every_conv_and_leaves_the_step(recipe, calls):
    module, state, batch = _step(recipe)
    _, plain, _ = _step(recipe)
    if calls is None:  # the encoder's convs twice (both views), decoder and head once
        enc = sum(isinstance(m, torch.nn.Conv2d) for m in module.model.encoder.modules())
        calls = 2 * enc + 2 * len(module.model.decoder.blocks) + 1
    cases = cg.capture(module, state, batch)
    assert sum(c.calls for c in cases) == calls
    names = {c.name for c in cases}
    assert all(n in {k.removesuffix(".weight") for k in state.variables} for n in names)
    assert not any(n.startswith("matcher.backbone") for n in names)  # frozen: no gradient
    for c in cases:
        assert c.gy is not None and c.gy.shape[0] == c.x.shape[0]
    module.train_step(plain, batch, 0, metrics=False)
    for k, v in state.variables.items():
        assert torch.equal(v, plain.variables[k]), k


@pytest.mark.parametrize("groups,stride", [(1, 1), (4, 2)])
def test_gradients_are_autograds(groups, stride):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 11, 13, generator=g, requires_grad=True)
    w = torch.randn(8, 8 // groups, 3, 3, generator=g, requires_grad=True)
    b = torch.randn(8, generator=g, requires_grad=True)
    y = F.conv2d(x, w, b, stride, 1, 1, groups)
    gy = torch.randn(y.shape, generator=g)
    want = torch.autograd.grad(y, (x, w, b), gy)
    case = cg.ConvCase("conv", x.detach(), w.detach(), True, (stride, stride), (1, 1), (1, 1),
                       groups, gy=gy)
    for got, ref in zip(cg.gradients(case, "cpu", torch.float32, True), want):
        assert torch.equal(got, ref)
    assert (f"groups {groups}" in case.describe()) == (groups > 1)
    assert (f"stride {stride}" in case.describe()) == (stride > 1)


@pytest.mark.parametrize("recipe", ["dcmcs3di", "dmsct"])
def test_check_holds_the_cpu_to_float64(recipe):
    module, state, batch = _step(recipe)
    cases = cg.capture(module, state, batch)[:6]
    rows = cg.check(cases, {"cpu": True}, device="cpu")
    assert {r["grad"] for r in rows} <= set(cg.GRADS) and len(rows) >= 2 * len(cases)
    for r in rows:
        assert r["cpu"] == r["cpu"] and r["cpu"] < 1e-5  # float32 against float64
        assert r["excess cpu"] <= 1.0 / cg.RATIO


class _Backends(TorchDispatchMode):
    """Records cuDNN's flag at every conv backward."""

    def __init__(self):
        super().__init__()
        self.flags = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution_backward.default:
            self.flags.append(torch.backends.cudnn.enabled)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("recipe,cls,cudnn", [("dcmcs3di", DCMCS3DIModule, False),
                                              ("dmsct", DMSCTModule, True)])
def test_train_step_backward_route(recipe, cls, cudnn):
    """DCMCS3DI's backward convs through ATen (cuDNN's weight gradient of
    its channels-last 3x3 conv sits at 0.83 of the rule's line on the
    card), DMSCT's through cuDNN; the caller's flag comes back after."""
    assert cls.backward_cudnn is cudnn
    module, state, batch = _step(recipe)
    before = torch.backends.cudnn.enabled
    with _Backends() as mode:
        module.train_step(state, batch, 0, metrics=False)
    assert mode.flags and set(mode.flags) == {cudnn}
    assert torch.backends.cudnn.enabled == before
