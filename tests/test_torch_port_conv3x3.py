"""The conv3x3 route on the CPU (color_transfer_tpu_torch/ops/conv3x3.py and
models/layers.py::conv). The kernels run only on the card
(test_torch_port_kernels_cuda.py); here a CPU tensor takes the Function's
plain version, so these tests reach its wiring:

  * ``layers.takes_conv3x3``, case by case: a float32 3x3 64 -> 64 conv
    with padding 1, no row shard and cuDNN off takes the route; float64
    weights, a 1x1 kernel, 3 -> 64 channels, an active row shard and cuDNN
    on keep F.conv2d;
  * the Function's forward and backward against F.conv2d's autograd,
    bit-equal in float64 and float32 (the plain backward is the
    ``aten.convolution_backward`` call autograd makes), on contiguous NHWC
    inputs and on permuted views, with and without a bias;
  * a DCMCS3DI train step at 64 channels through the route against the
    same step with the route turned off: the same loss and gradients, bit
    for bit, and the kernels' counters unmoved; the same for the bf16
    recipe, whose only f32 3x3 64 -> 64 convs, the matcher head's two, take
    the route;
  * DMSCT's train step and evaluation forward never reach the route;
  * ``layers.takes_resb``, case by case: a float32 ResB block for which
    autograd records nothing takes ``conv3x3.resb``; recording autograd,
    float64 weights, a bf16 compute dtype and a row shard keep the block's
    convs on ``layers.conv``;
  * ``resb_plain`` (the CPU's side of ``resb``) bit-equal to the block's
    own forward, on either conv route;
  * DCMCS3DI's inference forward (the materialised matcher, the kernel
    route, ``valid_w``) bit-equal with ``resb`` taken and not, every ResB
    block through it; the train steps never reach it.
"""

import pytest
import torch
import torch.nn.functional as F

from color_transfer_tpu_torch.core.precision import conv_route
from color_transfer_tpu_torch.models import layers
from color_transfer_tpu_torch.ops import conv3x3 as c3
from color_transfer_tpu_torch.parallel.row_attention_sp import row_shard
from color_transfer_tpu_torch.utils.profiling import counter
from test_torch_port_core import one_torch_thread  # noqa: F401  (an autouse fixture)

COUNTERS = ("conv3x3.launches", "conv3x3.dgrad_launches", "conv3x3.wgrad_launches",
            "conv3x3.resb_launches")


def _counts():
    return [counter(name) for name in COUNTERS]


# (weight shape, padding, dtype, row shard, cuDNN on) -> takes the route
ROUTE_CASES = {
    "engaged": ((64, 64, 3, 3), (1, 1), torch.float32, False, False, True),
    "int_padding": ((64, 64, 3, 3), 1, torch.float32, False, False, True),
    "float64": ((64, 64, 3, 3), (1, 1), torch.float64, False, False, False),
    "1x1": ((64, 64, 1, 1), (0, 0), torch.float32, False, False, False),
    "3_to_64": ((64, 3, 3, 3), (1, 1), torch.float32, False, False, False),
    "row_shard": ((64, 64, 3, 3), (1, 1), torch.float32, True, False, False),
    "cudnn_on": ((64, 64, 3, 3), (1, 1), torch.float32, False, True, False),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_takes_conv3x3(case):
    shape, padding, dtype, sharded, cudnn, want = ROUTE_CASES[case]
    x = torch.zeros(1, 4, 5, shape[1], dtype=dtype)
    weight = torch.zeros(shape, dtype=dtype)
    with conv_route(cudnn):
        if sharded:
            with row_shard(object()):
                assert layers.takes_conv3x3(x, weight, padding) is want
        else:
            assert layers.takes_conv3x3(x, weight, padding) is want


@pytest.mark.parametrize("case", ["engaged", "int_padding", "float64", "1x1", "3_to_64",
                                  "cudnn_on"])
def test_conv_on_a_cpu_tensor(case, monkeypatch):
    """``layers.conv`` on a CPU tensor: the route's plain version where it
    engages, F.conv2d elsewhere; the same values either way, and no kernel
    launch counted."""
    shape, padding, dtype, _, cudnn, want = ROUTE_CASES[case]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 7, 9, shape[1], generator=g, dtype=dtype)
    weight = torch.randn(shape, generator=g, dtype=dtype) / 24
    bias = torch.randn(shape[0], generator=g, dtype=dtype)
    calls = []
    monkeypatch.setattr(layers, "conv3x3", lambda *a: calls.append(1) or c3.conv3x3(*a))
    before = _counts()
    with conv_route(cudnn):
        got = layers.conv(x, weight, bias, padding)
    want_y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, padding=padding).permute(0, 2, 3, 1)
    assert torch.equal(got, want_y)
    assert len(calls) == int(want)
    assert _counts() == before


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("layout", ["nhwc", "permuted"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_function_is_conv2d_autograd(dtype, layout, with_bias):
    g = torch.Generator().manual_seed(1)
    shape = (2, 9, 13, 64)
    if layout == "nhwc":
        x0 = torch.randn(*shape, generator=g, dtype=dtype)
    else:  # an NCHW tensor seen as NHWC
        x0 = torch.randn(shape[0], shape[3], shape[1], shape[2], generator=g,
                         dtype=dtype).permute(0, 2, 3, 1)
    w0 = torch.randn(64, 64, 3, 3, generator=g, dtype=dtype) / 24
    b0 = torch.randn(64, generator=g, dtype=dtype) if with_bias else None
    gy = torch.randn(shape, generator=g, dtype=dtype)

    def run(fn):
        leaves = [t.clone().requires_grad_(True) for t in (x0, w0, b0) if t is not None]
        x, w, b = leaves if with_bias else (*leaves, None)
        y = fn(x, w, b)
        return (y, *torch.autograd.grad(y, leaves, gy))

    before = _counts()
    got = run(c3.conv3x3)
    want = run(c3.conv3x3_plain)
    assert len(got) == len(want) == 3 + with_bias
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)
    assert _counts() == before


def _dc_step(monkeypatch, route, recipe="dcmcs3di"):
    """One train step of ``recipe`` (tools/conv_grads.py's RECIPES) at 64
    channels on the CPU -> (loss, gradients, the variables after the step,
    conv3x3 calls); ``route`` False turns the route off. The step never
    runs a block through ``resb`` (autograd records every block)."""
    from color_transfer_tpu_torch.tools import conv_grads as cg

    calls = []
    monkeypatch.setattr(layers, "conv3x3", lambda *a: calls.append(1) or c3.conv3x3(*a))
    monkeypatch.setattr(layers, "resb", lambda *a: pytest.fail("a train step took resb"))
    if not route:
        monkeypatch.setattr(layers, "takes_conv3x3", lambda *a: False)
    module, state, batch = cg.recipe_step(recipe, "cpu", batch_size=2, crop=(12, 24),
                                          extraction_layers=2, transfer_layers=1)
    grads = {}
    step = state.optimizer.step

    def keep_grads(*args, **kwargs):
        grads.update({k: v.grad.clone() for k, v in state.variables.items()
                      if v.grad is not None})
        return step(*args, **kwargs)

    monkeypatch.setattr(state.optimizer, "step", keep_grads)
    _, logs = module.train_step(state, batch, 3, metrics=False)
    monkeypatch.undo()
    return logs["Training Total Loss"], grads, state.variables, len(calls)


def test_dcmcs3di_train_step_unchanged(monkeypatch):
    before = _counts()
    loss, grads, variables, calls = _dc_step(monkeypatch, True)
    loss0, grads0, variables0, calls0 = _dc_step(monkeypatch, False)
    # 2 extraction and 1 transfer ResB of 2 convs each, the matcher head's 2
    assert (calls, calls0) == (2 * 2 + 2 * 1 + 2, 0)
    assert torch.equal(torch.as_tensor(loss), torch.as_tensor(loss0))
    assert grads.keys() == grads0.keys() and len(grads) == len(variables)
    for k in grads:
        assert torch.equal(grads[k], grads0[k]), k
    for k in variables:
        assert torch.equal(variables[k], variables0[k]), k
    assert _counts() == before


def test_dcmcs3di_bf16_step_takes_conv3x3_for_the_matcher_head(monkeypatch):
    """The bf16 recipe runs its extraction and transfer convs in bf16 and
    the matcher in f32: the matcher head's ResB (two 3x3 64 -> 64 convs)
    takes the route in training, as in the f32 recipe, with the loss and
    gradients of the route turned off."""
    before = _counts()
    loss, grads, variables, calls = _dc_step(monkeypatch, True, "dcmcs3di_bf16")
    loss0, grads0, variables0, calls0 = _dc_step(monkeypatch, False, "dcmcs3di_bf16")
    assert (calls, calls0) == (2, 0)
    assert torch.equal(torch.as_tensor(loss), torch.as_tensor(loss0))
    assert grads.keys() == grads0.keys() and len(grads) == len(variables)
    for k in grads:
        assert torch.equal(grads[k], grads0[k]), k
    assert _counts() == before


def test_flops():
    # the extractor's shape: 16 x 160 x 320 pixels, 9 x 64 x 64 multiply-adds each
    assert c3.flops(16, 160, 320) == 60_397_977_600


def test_dmsct_never_takes_conv3x3(monkeypatch):
    """DMSCT (the serving and the four-card cells) calls no
    ``layers.conv``: neither its train step (its decoder's forward runs
    with cuDNN off) nor its evaluation forward reaches conv3x3."""
    from color_transfer_tpu_torch.tools import conv_grads as cg

    calls = []
    apply = c3._Conv3x3.apply
    monkeypatch.setattr(c3._Conv3x3, "apply",
                        staticmethod(lambda *a: calls.append(1) or apply(*a)))
    module, state, batch = cg.recipe_step("dmsct", "cpu", batch_size=2, crop=(32, 64),
                                          matcher_num_layers=1, matcher_num_reg_refine=1)
    module.train_step(state, batch, 0, metrics=False)
    with conv_route(False):
        module.eval_forward(state.variables, {"target": batch["gt"],
                                              "reference": batch["reference"]})
    assert calls == []
    # the spy counts a DCMCS3DI call
    x = torch.zeros(1, 4, 5, 64)
    with conv_route(False):
        layers.conv(x, torch.zeros(64, 64, 3, 3), torch.zeros(64), (1, 1))
    assert calls == [1]


# -- a ResB block at inference: ``conv3x3.resb`` ---------------------------------

# (grad mode, what requires grad, weight dtype, compute dtype, row shard) ->
# the block takes ``resb``
RESB_CASES = {
    "no_grad": (False, "params", torch.float32, None, False, True),
    "nothing_requires_grad": (True, "nothing", torch.float32, None, False, True),
    "input_requires_grad_under_no_grad": (False, "input", torch.float32, None, False, True),
    "recording_params": (True, "params", torch.float32, None, False, False),
    "recording_input": (True, "input", torch.float32, None, False, False),
    "float64": (False, "params", torch.float64, None, False, False),
    "bf16_compute": (False, "params", torch.float32, torch.bfloat16, False, False),
    "row_shard": (False, "params", torch.float32, None, True, False),
}


def _resb_block(dtype=torch.float32, compute_dtype=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    blk = layers.ResB(64, dtype=compute_dtype)
    for i in (0, 2):
        layers.init_uniform_(blk.body[i], g)
    return blk.to(dtype), g


@pytest.mark.parametrize("case", sorted(RESB_CASES))
def test_takes_resb(case):
    grad, requires, dtype, compute, sharded, want = RESB_CASES[case]
    blk, _ = _resb_block(dtype, compute)
    blk.requires_grad_(requires == "params")
    x = torch.zeros(1, 4, 5, 64, dtype=dtype, requires_grad=requires == "input")
    with torch.set_grad_enabled(grad):
        if sharded:
            with row_shard(object()):
                assert layers.takes_resb(x, blk.body[0], blk.body[2]) is want
        else:
            assert layers.takes_resb(x, blk.body[0], blk.body[2]) is want


@pytest.mark.parametrize("cudnn", [True, False])
@pytest.mark.parametrize("shape", [(2, 9, 13, 64), (1, 5, 7, 64)])
def test_resb_plain_is_the_block(shape, cudnn, monkeypatch):
    """``resb_plain`` against the block's own forward (``x + body(x)``:
    ``layers.conv``, ``leaky_relu``, the add), bit for bit, with cuDNN's
    flag either way (off, the convs take conv3x3's plain version); the
    block's forward without grad reaches ``resb`` once and counts no
    launch."""
    blk, g = _resb_block()
    x = torch.randn(*shape, generator=g)
    calls = []
    monkeypatch.setattr(layers, "resb", lambda *a: calls.append(1) or c3.resb(*a))
    before = _counts()
    with torch.no_grad(), conv_route(cudnn):
        want = x + blk.body(x)
        got = c3.resb_plain(x, blk.body[0].weight, blk.body[0].bias, blk.body[2].weight,
                            blk.body[2].bias)
        routed = blk(x)
    assert torch.equal(got, want) and torch.equal(routed, want)
    assert len(calls) == 1 and _counts() == before


@pytest.mark.parametrize("route", ["materialised", "kernels", "valid_w"])
def test_dcmcs3di_inference_takes_resb(route, monkeypatch):
    """DCMCS3DI's inference forward with every ResB block through ``resb``
    (2 extraction and 1 transfer block, the matcher head's) against the same
    forward with the route turned off: the same corrected frame and
    auxiliary outputs, bit for bit."""
    from color_transfer_tpu_torch.models import dcmcs3di as dc

    torch.manual_seed(5)
    model = dc.DCMCS3DI(extraction_layers=2, transfer_layers=1, channels=64)
    g = torch.Generator().manual_seed(6)
    left, right = torch.rand(1, 10, 36, 3, generator=g), torch.rand(1, 10, 36, 3, generator=g)
    kw = {"materialised": {}, "kernels": {"use_kernels": True},
          "valid_w": {"valid_w": 30}}[route]
    calls = []
    monkeypatch.setattr(layers, "resb", lambda *a: calls.append(1) or c3.resb(*a))
    with torch.no_grad():
        got = model(left, right, inference=True, **kw)
        monkeypatch.setattr(layers, "takes_resb", lambda *a: False)
        want = model(left, right, inference=True, **kw)
    assert len(calls) == 2 + 1 + 1
    got, want = ([t for t in torch.utils._pytree.tree_leaves(out) if t is not None]
                 for out in (got, want))
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
