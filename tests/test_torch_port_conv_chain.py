"""Port parity: the ResB conv chain's plain torch version
(color_transfer_tpu_torch/ops/conv_chain.py) against the JAX package's
Pallas kernel run in interpret mode, and against a chain of the port's own
per-conv ResB modules.

Lines:
  * f32: atol 2e-5, rtol 1e-5, the line of JAX's own kernel test (f32 on
    both sides, sums in another order);
  * bf16: max|d| <= max(1, max|ref|) / 64, a few bf16 ulps (2^-8 relative)
    of the output scale. Both sides round to bf16 at the same places; a
    difference in the f32 sum order can flip one rounding by an ulp, and
    later blocks carry the flip along.
The CUDA kernel itself needs the card: tests/test_torch_port_kernels_cuda.py
and chip_smoke.py hold it against this plain version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from color_transfer_tpu.ops.conv_chain import resb_chain as jax_resb_chain
from color_transfer_tpu_torch.models.layers import ResB
from color_transfer_tpu_torch.ops import conv_chain as cc

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _make(rng, layers, shape):
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    k = (rng.standard_normal((layers, 2, 3, 3, c, c)) / np.sqrt(9 * c)).astype(np.float32)
    b = (rng.standard_normal((layers, 2, c)) * 0.1).astype(np.float32)
    return x, k, b


def _group(layers, group=3):
    """The group the JAX Extractor.fused picks: the largest divisor of the
    layer count up to ``group``."""
    g = min(group, layers)
    while layers % g:
        g -= 1
    return g


def _check(got, want, dtype):
    assert got.shape == want.shape and got.dtype == np.float32
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    else:
        err = np.abs(got - want).max()
        assert err <= max(1.0, np.abs(want).max()) / 64, err


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("layers,shape,rows", [
    (2, (1, 16, 40, 8), 16),   # one strip, one group
    (3, (2, 13, 37, 8), 8),    # ragged H and W, two strips per image
    (5, (1, 11, 19, 16), 8),   # 5 layers: the group divisor falls to 1
])
def test_plain_matches_jax(rng, dtype, layers, shape, rows):
    x, k, b = _make(rng, layers, shape)
    jd, td = DTYPES[dtype]
    want = np.asarray(jax_resb_chain(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), group=_group(layers),
        rows=rows, compute_dtype=jd, interpret=True,
    ))
    got = cc.resb_chain(torch.from_numpy(x), torch.from_numpy(k),
                        torch.from_numpy(b), td)
    _check(got.numpy(), want, dtype)


def test_plain_matches_resb_modules(rng):
    """f32: the plain chain equals the port's per-conv ResB modules run one
    after another (atol 2e-5, rtol 1e-5)."""
    layers, c = 3, 16
    x, k, b = _make(rng, layers, (2, 9, 21, c))
    blocks = [ResB(c) for _ in range(layers)]
    with torch.no_grad():
        for blk, kl, bl in zip(blocks, k, b):
            for conv, kj, bj in zip((blk.body[0], blk.body[2]), kl, bl):
                conv.weight.copy_(torch.from_numpy(kj).permute(3, 2, 0, 1))
                conv.bias.copy_(torch.from_numpy(bj))
        want = torch.from_numpy(x)
        for blk in blocks:
            want = blk(want)
        got = cc.resb_chain(torch.from_numpy(x), torch.from_numpy(k),
                            torch.from_numpy(b), torch.float32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=1e-5)


def test_does_not_write_its_input(rng):
    x, k, b = _make(rng, 2, (1, 8, 16, 16))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    before = xt.clone()
    cc.resb_chain(xt, torch.from_numpy(k), torch.from_numpy(b), torch.bfloat16)
    assert torch.equal(xt, before)


@pytest.mark.parametrize("case", ["channels", "kernels", "biases", "dtype", "rank",
                                  "integer"])
def test_kernel_input_checks(rng, case):
    x, k, b = (torch.from_numpy(a) for a in _make(rng, 2, (1, 8, 16, 16)))
    cd = torch.bfloat16
    if case == "channels":
        x, k, b = (torch.from_numpy(a) for a in _make(rng, 2, (1, 8, 16, 8)))
    elif case == "kernels":
        k = k[:, :, :2]
    elif case == "biases":
        b = b[:1]
    elif case == "dtype":
        cd = torch.float16
    elif case == "integer":
        x = x.to(torch.int32)
    else:
        x = x[0]
    with pytest.raises(ValueError):
        cc.check_kernel_inputs(x, k, b, cd)
    cc.check_kernel_inputs(*(torch.from_numpy(a) for a in _make(rng, 2, (1, 8, 16, 16))),
                           torch.float32)


def test_other_devices_raise(rng):
    x, k, b = (torch.from_numpy(a).to("meta") for a in _make(rng, 1, (1, 4, 4, 16)))
    with pytest.raises(ValueError):
        cc.resb_chain(x, k, b)
