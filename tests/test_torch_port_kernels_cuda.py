"""The port's hand-written CUDA kernels against their plain torch versions,
on the card. Every test needs a CUDA device and skips without one (a CUDA
kernel has no CPU mode; the plain versions are held to JAX by the other
test_torch_port_*.py files). This file imports neither jax nor the JAX
package, so it runs on a machine with torch alone:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_port_kernels_cuda.py

Lines: f32 max|d| <= 1e-4 * max(1, max|ref|) (sums in another order);
bf16 as stated at each test.
"""

import math

import pytest
import torch

from color_transfer_tpu_torch.ops import conv_chain as cc
from color_transfer_tpu_torch.ops import local_corr as lc
from color_transfer_tpu_torch.ops import row_attention as ra

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.Generator().manual_seed(0)


def _randn(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen) * scale).cuda()


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("shape", [(1, 13, 37, 16, 1), (2, 9, 20, 128, 4)])
def test_local_corr(gen, shape):
    b, h, w, c, r = shape
    f0, f1 = _randn(gen, b, h, w, c), _randn(gen, b, h, w, c)
    flow = _randn(gen, b, h, w, 2, scale=3.0)
    before = lc.local_correlation_with_flow.launches
    with torch.no_grad():
        got = lc.local_correlation_with_flow(f0, f1, flow, r)
        want = lc.local_correlation_with_flow_plain(f0, f1, flow, r)
    assert lc.local_correlation_with_flow.launches == before + 1
    assert _rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 13, 37, 16), (2, 35, 19, 64), (1, 5, 40, 32)])
def test_resb_chain(gen, dtype, shape):
    """bf16 line: 4 bf16 ulps of the output scale (a rounding flipped by a
    different f32 sum order, carried through 3 blocks)."""
    layers, c = 3, shape[-1]
    x = _randn(gen, *shape)
    k = _randn(gen, layers, 2, 3, 3, c, c, scale=(9 * c) ** -0.5)
    b = _randn(gen, layers, 2, c, scale=0.05)
    before = cc.resb_chain.launches
    with torch.no_grad():
        got = cc.resb_chain(x, k, b, dtype)
        want = cc.resb_chain_plain(x, k, b, dtype)
    assert cc.resb_chain.launches == before + 2 * layers
    assert got.dtype == torch.float32 and got.shape == shape
    scale = max(1.0, float(want.abs().max()))
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-4 * scale
    else:
        ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
        assert float((got - want).abs().max()) <= 4 * ulp


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("shape", [(2, 5, 97, 32), (1, 3, 200, 64), (1, 2, 50, 16)])
def test_row_attention(gen, precise, shape):
    """bf16 line on out: 2^-8 max|v|, the bound if every att entry's bf16
    rounding flipped by an ulp; colsum (f32 att) on the f32 line."""
    q, k = _randn(gen, *shape, scale=3.0), _randn(gen, *shape, scale=3.0)
    v = _randn(gen, *shape)
    scale = 1.0 / shape[-1]
    before = ra.row_attention_warp.launches
    with torch.no_grad():
        out, cs = ra.row_attention_warp(q, k, v, scale, precise)
        none, cs_only = ra.row_attention_warp(q, k, None, scale, precise)
        want_out, want_cs = ra.row_attention_warp_plain(q, k, v, scale, precise)
    assert ra.row_attention_warp.launches == before + 2 and none is None
    line = 1e-4 * max(1.0, float(want_out.abs().max())) if precise else \
        2.0 ** -8 * float(v.abs().max())
    assert float((out - want_out).abs().max()) <= line
    assert _rel_err(cs, want_cs) <= 1e-4 and _rel_err(cs_only, want_cs) <= 1e-4


def test_no_fallback_on_bad_input(gen):
    """A CUDA tensor the kernel does not take raises; it never reaches the
    plain version."""
    x = _randn(gen, 1, 4, 4, 8)
    with pytest.raises(ValueError):
        cc.resb_chain(x, _randn(gen, 1, 2, 3, 3, 8, 8), _randn(gen, 1, 2, 8))
    with pytest.raises(ValueError):
        ra.row_attention_warp(x, x, x, 0.125)
