"""The port's hand-written CUDA kernels against their plain torch versions,
on the card. Every test needs a CUDA device and skips without one (a CUDA
kernel has no CPU mode; the plain versions are held to JAX by the other
test_torch_port_*.py files). This file imports neither jax nor the JAX
package, so it runs on a machine with torch alone:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_port_kernels_cuda.py

Lines: f32 max|d| <= 1e-4 * max(1, max|ref|) (sums in another order);
bf16 as stated at each test. B3 and B4 round operation by operation as
their plain versions do (IEEE division, no FMA contraction): B3 within
1e-6 * bins (4 ulps at the table's top value), B4 within 1e-6 of values ~1.
"""

import math

import pytest
import torch

from color_transfer_tpu_torch.ops import conv_chain as cc
from color_transfer_tpu_torch.ops import idt_apply as ia
from color_transfer_tpu_torch.ops import local_corr as lc
from color_transfer_tpu_torch.ops import regrain_stencil as rs
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


def _idt_tables(gen, rows, bins):
    """Monotone tables in bin units on per-row grids, and samples that also
    fall below grid_lo and above right_edge."""
    fp = torch.sort(torch.rand(rows, bins, generator=gen) * bins, dim=-1).values
    grid_lo = torch.rand(rows, generator=gen) * 0.4 - 0.5
    step = 0.004 + torch.rand(rows, generator=gen) * 0.004
    right_edge = grid_lo + step * (bins - 1)
    return [t.cuda() for t in (grid_lo, step, fp, right_edge)]


@pytest.mark.parametrize("frames,n,bins", [(8, 1080 * 1920, 255), (2, 4099, 255),
                                           (1, 1000, 64), (1, 517, 256)])
def test_idt_apply(gen, frames, n, bins):
    """B3 at a 1080p chunk (8 frames x 3 axes), at a ragged N (scalar
    loads) and at other table sizes."""
    grid_lo, step, fp, right_edge = _idt_tables(gen, frames * 3, bins)
    x = (torch.rand(frames * 3, n, generator=gen) * 1.8 - 0.7).cuda()
    x[:, 0], x[:, 1] = grid_lo, right_edge
    shape = (frames, 3)
    args = [t.reshape(*shape, *t.shape[1:]) for t in (x, grid_lo, step, fp, right_edge)]
    before = ia.transport_apply.launches
    got = ia.transport_apply(*args)
    want = ia.transport_apply_plain(*args)
    assert ia.transport_apply.launches == before + 1
    assert float((got - want).abs().max()) <= 1e-6 * bins


@pytest.mark.parametrize("frames,h,w,nbit", [(1, 1080, 1920, 4), (8, 34, 60, 64),
                                             (2, 13, 22, 7), (1, 1, 5, 3)])
def test_regrain_sweeps(gen, frames, h, w, nbit):
    """B4 at 1080p level 0, the smallest 1080p level with its 64 sweeps,
    JAX's odd 13 x 22 case and a one-row image."""
    out0 = torch.rand(frames, h, w, 3, generator=gen).cuda()
    const = torch.rand(frames, h, w, 3, generator=gen).cuda()
    phis = (torch.rand(frames, 4, h, w, generator=gen) * 15).cuda()
    invd = (0.8 / (phis.sum(1) + torch.rand(frames, h, w, generator=gen).cuda() + 1e-6))
    before = rs.regrain_sweeps.launches
    got = rs.regrain_sweeps(out0, const, phis, invd.contiguous(), nbit)
    want = rs.regrain_sweeps_plain(out0, const, phis, invd, nbit)
    assert rs.regrain_sweeps.launches == before + 1
    assert float((got - want).abs().max()) <= 1e-6 * max(1.0, float(want.abs().max()))


def test_no_fallback_on_bad_input(gen):
    """A CUDA tensor the kernel does not take raises; it never reaches the
    plain version."""
    x = _randn(gen, 1, 4, 4, 8)
    with pytest.raises(ValueError):
        cc.resb_chain(x, _randn(gen, 1, 2, 3, 3, 8, 8), _randn(gen, 1, 2, 8))
    with pytest.raises(ValueError):
        ra.row_attention_warp(x, x, x, 0.125)
    table = torch.zeros(1, 300, device="cuda")
    with pytest.raises(ValueError):  # more than 256 bins
        ia.transport_apply(torch.zeros(1, 8, device="cuda"), table[:, 0], table[:, 0],
                           table, table[:, 0])
    img = torch.zeros(1, 4, 5, 3, device="cuda")
    with pytest.raises(ValueError):  # phis in the wrong layout
        rs.regrain_sweeps(img, img, torch.zeros(1, 4, 5, 4, device="cuda"),
                          torch.zeros(1, 4, 5, device="cuda"), 2)
