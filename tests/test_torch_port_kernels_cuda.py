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
B4 is also held bit-equal (torch.equal) at the six 1080p levels and on
each of its two routes. B1's routes are forced by the flow (staged,
per-pixel, both in one call) and its two runs are bit-equal.
B7's float atomics add in an order that changes from run to run: within
1e-5 * max(1, max|ref|). The training recipes' f32 convs (not kernels of
the port, but the float64 rule's subject): every distinct conv of one step
at each recipe's shape, its input, weight and bias gradients through the
module's route within 4x the CPU float32 error + 1e-5 of a float64 run
(tools/conv_grads.py). B2a, B2b and B2c on the f32 line: every product
is 3xTF32 MMAs (f32's error scale), against cuBLAS's f32 products; sums in
another order.
"""

import math

import pytest
import torch

from color_transfer_tpu_torch.ops import conv_chain as cc
from color_transfer_tpu_torch.ops import idt_apply as ia
from color_transfer_tpu_torch.ops import local_corr as lc
from color_transfer_tpu_torch.ops import regrain_stencil as rs
from color_transfer_tpu_torch.ops import row_attention as ra
from color_transfer_tpu_torch.ops import warp_adjoint as wa
from color_transfer_tpu_torch.ops import win_attention as wn

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


def _smooth_flow(b, h, w):
    """A slowly varying field that keeps every window inside the image."""
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    flow = torch.stack([3.5 + 0.3 * torch.sin(yy / 5.0) - 0.02 * xx,
                        -2.25 + 0.2 * torch.cos(xx / 7.0)], -1)
    return flow[None].repeat(b, 1, 1, 1).cuda()


def _b1_flow(gen, kind, b, h, w):
    if kind == "smooth":
        return _smooth_flow(b, h, w)
    mixed = _mixed_flow(gen, b, h, w)
    if kind == "mixed":
        return mixed
    if kind == "clamped":  # every window pushed past the image's edges
        return torch.where(mixed >= 0, 1e4, -1e4)
    left = torch.arange(w, device="cuda")[None, None, :, None] < w // 2
    return torch.where(left, _smooth_flow(b, h, w), mixed)  # "step"


@pytest.mark.parametrize("kind", ["smooth", "mixed", "step", "clamped"])
@pytest.mark.parametrize("shape", [(2, 40, 72, 128, 4), (1, 13, 37, 16, 1), (2, 24, 33, 64, 2)])
def test_local_corr_routes(gen, shape, kind):
    """B1's two routes, forced by the flow: every tile of a smooth flow is
    staged, the mixed flow sends tiles to the per-pixel route, the step
    runs both in one call, the clamped flow has no live pixel (zeros). The
    kernel's route of each tile is tile_boxes'; two runs are bit-equal."""
    b, h, w, c, r = shape
    f0, f1 = _randn(gen, b, h, w, c), _randn(gen, b, h, w, c)
    flow = _b1_flow(gen, kind, b, h, w).contiguous()
    with torch.no_grad():
        got, routes = lc._launch(f0, f1, flow, r, routes=True)
        again = lc._launch(f0, f1, flow, r)
        want = lc.local_correlation_with_flow_plain(f0, f1, flow, r)
    staged = lc.tile_boxes(flow, r, lc.launch_plan(c, r))["staged"]
    assert torch.equal(routes.bool(), staged)
    assert torch.equal(got, again)
    assert _rel_err(got, want) <= 1e-4
    if kind in ("smooth", "clamped"):
        assert bool(staged.all())
    if kind == "clamped":
        assert not bool(got.any())
    if kind == "step" and shape[0] == 2 and r == 4:
        assert 0 < int(staged.sum()) < staged.numel()
    if kind == "mixed" and r == 4:
        assert not bool(staged.all())


@pytest.mark.parametrize("r", [0, 1, 2, 3, 4])
def test_local_corr_radii(gen, r):
    """Every instantiated radius, on both routes (a step flow)."""
    b, h, w, c = 1, 19, 45, 32
    f0, f1 = _randn(gen, b, h, w, c), _randn(gen, b, h, w, c)
    flow = _b1_flow(gen, "step", b, h, w).contiguous()
    with torch.no_grad():
        got = lc.local_correlation_with_flow(f0, f1, flow, r)
        want = lc.local_correlation_with_flow_plain(f0, f1, flow, r)
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


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("shape", [(2, 5, 97, 32), (1, 3, 200, 64), (1, 2, 50, 16),
                                   (1, 2, 129, 64), (1, 1, 64, 16), (1, 2, 700, 64)])
def test_row_attention_instantiations(gen, precise, shape):
    """Out only, colsum only and both, at ragged widths (W a multiple of
    neither the 64-key tile nor the 128-query group, W below a tile, W of
    exactly one tile, several groups): the same values whichever
    instantiation formed them, one launch each, and two runs bit-equal (the
    column sums use no atomics)."""
    q, k = _randn(gen, *shape, scale=3.0), _randn(gen, *shape, scale=3.0)
    v = _randn(gen, *shape)
    scale = 1.0 / shape[-1]
    before = ra.row_attention_warp.launches
    with torch.no_grad():
        out, cs = ra.row_attention_warp(q, k, v, scale, precise)
        _, cs_only = ra.row_attention_warp(q, k, None, scale, precise)
        out_only, no_cs = ra._attend(q, k, v, scale, precise, colsum=False)
        again = ra.row_attention_warp(q, k, v, scale, precise)
        want_out, want_cs = ra.row_attention_warp_plain(q, k, v, scale, precise)
    assert ra.row_attention_warp.launches == before + 4 and no_cs is None
    assert torch.equal(out, again[0]) and torch.equal(cs, again[1])
    assert torch.equal(out_only, out)  # the same products in the same order
    line = 1e-4 * max(1.0, float(want_out.abs().max())) if precise else \
        2.0 ** -8 * float(v.abs().max())
    assert float((out_only - want_out).abs().max()) <= line
    assert _rel_err(cs, want_cs) <= 1e-4 and _rel_err(cs_only, want_cs) <= 1e-4


@pytest.mark.parametrize("splits", [1, 2, 3, 6])
def test_row_attention_blocks_per_row(gen, splits):
    """The column sums do not depend on how a row's query groups are shared
    among blocks beyond rounding (partial sums are added in a fixed order),
    and out does not depend on it at all."""
    shape = (1, 3, 700, 64)  # 6 query groups
    q, k, v = _randn(gen, *shape, scale=3.0), _randn(gen, *shape, scale=3.0), _randn(gen, *shape)
    with torch.no_grad():
        out, cs = ra._launch(q, k, v, 1 / 64, False, True, splits)
        out1, cs1 = ra._launch(q, k, v, 1 / 64, False, True, 1)
        again = ra._launch(q, k, v, 1 / 64, False, True, splits)
        _, want_cs = ra.row_attention_warp_plain(q, k, v, 1 / 64)
    assert torch.equal(out, out1) and torch.equal(cs, again[1])
    assert _rel_err(cs, want_cs) <= 1e-4 and _rel_err(cs1, want_cs) <= 1e-4
    with pytest.raises(ValueError, match="splits"):
        ra._launch(q, k, v, 1 / 64, False, True, 7)


@pytest.mark.parametrize("scale", [-0.05, 0.0])
def test_row_attention_scale_sign(gen, scale):
    """The bf16 kernel takes a positive scale; the wrapper negates (or zeroes)
    q for the others."""
    shape = (1, 3, 150, 32)
    q, k, v = _randn(gen, *shape, scale=3.0), _randn(gen, *shape, scale=3.0), _randn(gen, *shape)
    with torch.no_grad():
        out, cs = ra.row_attention_warp(q, k, v, scale)
        want_out, want_cs = ra.row_attention_warp_plain(q, k, v, scale)
    assert float((out - want_out).abs().max()) <= 2.0 ** -8 * float(v.abs().max())
    assert _rel_err(cs, want_cs) <= 1e-4


def test_mma_fragment_maps(gen):
    """One m16n8k16 MMA through the kernels' ldmatrix and mma helpers
    against torch.matmul: the fragment maps the bf16 kernels are built on.
    bf16 products are exact in f32, so only the sum order differs."""
    import ctypes

    from color_transfer_tpu_torch.ops import _build

    fn = _build.load("row_attention").row_attention_mma_probe
    fn.argtypes = [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    a = _randn(gen, 16, 16).bfloat16()
    b = _randn(gen, 8, 16).bfloat16()
    d = torch.zeros(16, 8, device="cuda")
    assert fn(a.data_ptr(), b.data_ptr(), d.data_ptr(),
              torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert float((d - a.float() @ b.float().T).abs().max()) <= 1e-5


@pytest.mark.parametrize("c", [16, 32, 64])
@pytest.mark.parametrize("tap", range(9))
def test_resb_chain_single_tap(gen, c, tap):
    """One tap of the first conv at a time (the second conv is the identity
    on its centre tap), at a shape ragged against the tiles (12 x 32; 6 x 64
    at C = 64): each tap's shifted window of the halo and its weights reach
    the right MMA. At C = 64 this is the wgmma kernel, whose operand starts
    dx rows into the swizzled halo row."""
    x = _randn(gen, 1, 20, 45, c)
    k = torch.zeros(1, 2, 3, 3, c, c, device="cuda")
    b = torch.zeros(1, 2, c, device="cuda")
    k[0, 0, tap // 3, tap % 3] = _randn(gen, c, c, scale=c ** -0.5)
    k[0, 1, 1, 1] = torch.eye(c, device="cuda")
    with torch.no_grad():
        got = cc.resb_chain(x, k, b, torch.bfloat16)
        want = cc.resb_chain_plain(x, k, b, torch.bfloat16)
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 2 * 2.0 ** (math.floor(math.log2(scale)) - 7)


@pytest.mark.parametrize("shape", [(1, 13, 37, 64), (2, 50, 130, 64), (1, 6, 64, 64)])
def test_resb_chain_routes_agree(gen, shape):
    """At C = 64 the wgmma kernel and the mma.sync kernel sum the same bf16
    products in f32 and round at the same places: the same values, a bf16
    ulp apart at most where the sum order flips a rounding."""
    x = _randn(gen, *shape)
    k = _randn(gen, 2, 2, 3, 3, 64, 64, scale=(9 * 64) ** -0.5)
    b = _randn(gen, 2, 2, 64, scale=0.05)
    with torch.no_grad():
        wgmma = cc.resb_chain(x, k, b, torch.bfloat16)
        mma = cc._launch(x, k, b, torch.bfloat16, mma_sync=True)
        want = cc.resb_chain_plain(x, k, b, torch.bfloat16)
    scale = max(1.0, float(want.abs().max()))
    ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
    assert float((wgmma - mma).abs().max()) <= 2 * ulp
    assert float((wgmma - want).abs().max()) <= 4 * ulp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resb_chain_reads_its_input_in_place(gen, dtype):
    """An input already in the compute dtype is read where it lies and never
    written; the result is a float32 tensor of its own, twice bit-equal."""
    x = _randn(gen, 1, 30, 50, 32).to(dtype)
    k = _randn(gen, 2, 2, 3, 3, 32, 32, scale=(9 * 32) ** -0.5)
    b = _randn(gen, 2, 2, 32, scale=0.05)
    kept = x.clone()
    with torch.no_grad():
        got = cc.resb_chain(x, k, b, dtype)
        again = cc.resb_chain(x, k, b, dtype)
        want = cc.resb_chain_plain(x, k, b, dtype)
    assert torch.equal(x, kept) and got.dtype == torch.float32
    assert got.data_ptr() != x.data_ptr() and torch.equal(got, again)
    scale = max(1.0, float(want.abs().max()))
    line = 1e-4 * scale if dtype == torch.float32 else 4 * 2.0 ** (math.floor(math.log2(scale)) - 7)
    assert float((got - want).abs().max()) <= line


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


@pytest.mark.parametrize("h,w,nbit", [(1080, 1920, 4), (540, 960, 16), (270, 480, 32),
                                      (135, 240, 64), (68, 120, 64), (34, 60, 64)])
def test_regrain_sweeps_levels_bit_equal(gen, h, w, nbit):
    """B4 at the six levels of a 1080p chunk (two frames): bit-equal to the
    plain version, on the route and plan launch_plan picks."""
    out0, const, phis, invd = _regrain_inputs(gen, 2, h, w)
    got = rs.regrain_sweeps(out0, const, phis, invd, nbit)
    assert torch.equal(got, rs.regrain_sweeps_plain(out0, const, phis, invd, nbit))


@pytest.mark.parametrize("h,w,nbit,route,sweeps,tile", [
    (13, 22, 7, "trapezoid", 3, (4, 8)),      # odd sizes, a short last pass
    (13, 22, 7, "trapezoid", 7, (8, 8)),      # halos wider than tiles
    (1, 9, 5, "trapezoid", 2, (1, 4)),        # one row
    (6, 3, 4, "trapezoid", 4, (2, 4)),        # narrower than a thread's four columns
    (37, 50, 9, "trapezoid", 4, (24, 56)),    # one tile across, ragged down
    (13, 22, 7, "cluster", 7, (2, 22)),       # seven bands
    (135, 240, 64, "cluster", 64, (17, 240)), # the 135 x 240 level's cluster of 8
    (34, 60, 64, "cluster", 64, (34, 60)),    # a cluster of one block
    (1, 5, 3, "cluster", 3, (1, 5)),
])
def test_regrain_sweeps_forced_routes(gen, h, w, nbit, route, sweeps, tile):
    """Each route forced by a plan, at odd sizes and tiles that straddle
    the border: bit-equal to the plain version, also with misaligned
    inputs (the scalar loads)."""
    th, tw = tile
    if route == "trapezoid":
        rh, rw = th + 2 * sweeps, tw + 2 * sweeps
    else:
        rh, rw = th, tw
    strip, threads = rs._strip_for(rh, rw)
    plan = rs.LevelPlan(route, sweeps, -(-nbit // sweeps), th, tw, strip, threads,
                        rs._smem(rh, rw), -(-h // th) if route == "cluster" else 1)
    for misaligned in (False, True):
        out0, const, phis, invd = _regrain_inputs(gen, 2, h, w)
        if misaligned:  # one float past a 16-byte boundary
            out0 = torch.cat([out0.new_zeros(1), out0.flatten()])[1:].view(out0.shape)
        got = rs._launch(out0, const, phis, invd, nbit, 0.2, plan=plan)
        assert torch.equal(got, rs.regrain_sweeps_plain(out0, const, phis, invd, nbit))


def _regrain_inputs(gen, frames, h, w):
    out0 = torch.rand(frames, h, w, 3, generator=gen).cuda()
    const = torch.rand(frames, h, w, 3, generator=gen).cuda()
    phis = (torch.rand(frames, 4, h, w, generator=gen) * 15).cuda()
    invd = (0.8 / (phis.sum(1) + 1.0)).contiguous()
    return out0, const, phis, invd


def _mixed_flow(gen, b, h, w):
    """Sub-pixel, zero and far (clamped) displacements, one kind per pixel."""
    frac = torch.randn(b, h, w, 2, generator=gen) * 3.0
    far = torch.sign(torch.randn(b, h, w, 2, generator=gen)) * (
        60.0 + torch.rand(b, h, w, 2, generator=gen) * 500.0)
    kind = torch.randint(0, 3, (b, h, w, 1), generator=gen)
    return torch.where(kind == 0, frac, torch.where(kind == 1, 0.0 * frac, far)).cuda()


@pytest.mark.parametrize("shape", [(12, 128, 240, 32), (12, 64, 120, 24), (12, 32, 60, 48),
                                   (12, 16, 30, 120), (2, 13, 37, 5), (1, 9, 11, 7)])
def test_warp_adjoint(gen, shape):
    """B7 at DMSCT's four training levels (batch 12, 256 x 480 crops) and at
    ragged shapes (C not a multiple of 4: scalar loads)."""
    b, h, w, c = shape
    g = _randn(gen, *shape)
    flow = _mixed_flow(gen, b, h, w)
    before = wa.warp_adjoint.launches
    got = wa.warp_adjoint(g, flow)
    want = wa.warp_adjoint_plain(g, flow)
    assert wa.warp_adjoint.launches == before + 1 and got.shape == shape
    assert _rel_err(got, want) <= 1e-5


def _flow(gen, kind, b, h, w):
    """The mixed flow, its sub-pixel kind alone (in the image but near its
    edges), or its far kind alone (every sample clamped to the border)."""
    if kind == "mixed":
        return _mixed_flow(gen, b, h, w)
    if kind == "frac":
        return (torch.randn(b, h, w, 2, generator=gen) * 3.0).cuda()
    return (torch.sign(torch.randn(b, h, w, 2, generator=gen)) * (
        60.0 + torch.rand(b, h, w, 2, generator=gen) * 500.0)).cuda()


@pytest.mark.parametrize("kind", ["frac", "clamped"])
@pytest.mark.parametrize("shape", [(12, 128, 240, 32), (12, 16, 30, 120), (3, 17, 23, 5),
                                   (2, 9, 11, 7)])
def test_warp_adjoint_flows(gen, shape, kind):
    """B7 on an in-image flow and on an all-clamped one (every pixel on the
    border corners: the block's shared corner sums), at two training levels
    and at C = 5 and 7 (the scalar path), against the plain version; the
    vector path runs exactly when C is a multiple of 4."""
    b, h, w, c = shape
    g = _randn(gen, *shape)
    flow = _flow(gen, kind, b, h, w)
    before, vec_before = wa.warp_adjoint.launches, wa.warp_adjoint.vector_launches
    got = wa.warp_adjoint(g, flow)
    want = wa.warp_adjoint_plain(g, flow)
    assert wa.warp_adjoint.launches == before + 1
    assert wa.warp_adjoint.vector_launches == vec_before + (c % 4 == 0)
    assert _rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("shape", [(12, 64, 120, 24), (2, 13, 37, 5)])
def test_warp_adjoint_runs_agree(gen, shape):
    """Float atomics add in an order that changes from run to run: two runs
    on one input agree to the B7 line, not bit for bit."""
    b, h, w, c = shape
    g = _randn(gen, *shape)
    flow = _mixed_flow(gen, b, h, w)
    first, second = wa.warp_adjoint(g, flow), wa.warp_adjoint(g, flow)
    assert _rel_err(first, second) <= 1e-5


def test_flow_warp_batched_backward_on_the_card(gen):
    """The autograd backward launches B7 for the feature cotangent and
    matches torch's autograd of the plain gather; the flow cotangent (plain
    torch) matches too."""
    from color_transfer_tpu_torch.core.sampling import flow_warp, flow_warp_batched

    feat = _randn(gen, 2, 24, 40, 16)
    flow = _randn(gen, 2, 24, 40, 2, scale=2.0)
    g = _randn(gen, 2, 24, 40, 16)
    f1, fl1 = feat.clone().requires_grad_(True), flow.clone().requires_grad_(True)
    before = wa.warp_adjoint.launches
    (flow_warp_batched(f1, fl1) * g).sum().backward()
    assert wa.warp_adjoint.launches == before + 1
    f2, fl2 = feat.clone().requires_grad_(True), flow.clone().requires_grad_(True)
    (flow_warp(f2, fl2) * g).sum().backward()
    assert _rel_err(f1.grad, f2.grad) <= 1e-5
    assert _rel_err(fl1.grad, fl2.grad) <= 1e-4


def test_dmsct_train_step_on_the_card():
    """One DMSCT train step (a small model, drop-connect off, one fed matcher
    output, the same targets) on the card and on the CPU in float32, against
    the CPU in float64: the loss within 1e-5 relative of the CPU's; each
    corrector gradient (relative to its tensor's max|ref|, floored at 1e-2 of
    the largest) no further from float64 than 4 times the CPU's distance plus
    1e-5 (train-mode BatchNorm's backward cancels, so both float32 runs
    carry rounding of ~1e-3 there); 4 B7 launches (levels 1-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from color_transfer_tpu_torch.run.modules import DMSCTModule

    rng = torch.Generator().manual_seed(3)
    batch = {"gt": torch.rand(2, 64, 96, 3, generator=rng),
             "reference": torch.rand(2, 64, 96, 3, generator=rng)}
    target = (batch["gt"] ** 1.3 * 0.9 + 0.04).clamp(0, 1)
    fed = {"flow": torch.randn(2, 64, 96, 2, generator=rng) * 2.5,
           "fwd_occ": (torch.rand(2, 64, 96, 1, generator=rng) < 0.1).float()}
    results = {}
    for device, dtype in (("cpu", torch.float64), ("cpu", torch.float32),
                          ("cuda", torch.float32)):
        module = DMSCTModule(matcher_num_layers=1, matcher_num_reg_refine=1,
                             heavy_metrics=False)
        module.model.encoder.drop_connect_rate = 0.0
        on = {k: v.to(device, dtype) for k, v in fed.items()}
        module.model.matcher.forward = lambda *a, on=on, **k: on
        module.synthesize_targets = lambda b, gen, t=target.to(device, dtype): {**b, "target": t}
        b = {k: v.to(device, dtype) for k, v in batch.items()}
        state = module.init_state(0, b, num_train_steps=5)
        state.variables = {k: v.detach().to(dtype).requires_grad_(v.requires_grad)
                           if v.is_floating_point() else v
                           for k, v in state.variables.items()}
        state.optimizer = torch.optim.AdamW(
            [v for v in state.variables.values() if v.requires_grad], lr=3e-4)
        grads = {}
        apply_gradients = module.apply_gradients

        def record(st, apply_gradients=apply_gradients, grads=grads):
            grads.update({k: v.grad.detach().cpu().double() for k, v in st.variables.items()
                          if v.grad is not None})
            apply_gradients(st)

        module.apply_gradients = record
        before = wa.warp_adjoint.launches
        _, logs = module.train_step(state, b, seed=0, metrics=False)
        if device == "cuda":
            torch.cuda.synchronize()
        results[device, dtype] = (float(logs["Training Total Loss"]), grads,
                                  wa.warp_adjoint.launches - before)
    _, g64, _ = results["cpu", torch.float64]
    loss_cpu, g_cpu, launches_cpu = results["cpu", torch.float32]
    loss_card, g_card, launches_card = results["cuda", torch.float32]
    assert launches_cpu == 0 and launches_card == 4
    assert abs(loss_card - loss_cpu) <= 1e-5 * abs(loss_cpu)
    floor = 1e-2 * max(float(g.abs().max()) for g in g64.values())
    for name, ref in g64.items():
        scale = max(float(ref.abs().max()), floor)
        e_cpu = float((g_cpu[name] - ref).abs().max()) / scale
        e_card = float((g_card[name] - ref).abs().max()) / scale
        assert e_card <= 4 * e_cpu + 1e-5, (name, e_card, e_cpu)


# (windows, L, C) with a swin geometry (k, hs, ws): 1080p scale 1, the train
# shape's two scales, ragged ones (L not a multiple of the 32-row query
# tile or the 64-key tile: the last block has nq < 32 rows, the last key
# tile a share without keys), and L up to the kernels' 1024.
B2_SHAPES = [((128, 448, 128), (8, 16, 28)), ((96, 480, 128), (2, 16, 30)),
             ((1536, 120, 128), (8, 8, 15)), ((8, 35, 128), (2, 5, 7)),
             ((4, 1000, 128), (2, 20, 50)), ((12, 91, 128), (2, 7, 13)),
             ((4, 1024, 128), (2, 32, 32))]


@pytest.mark.parametrize("mode", ["none", "shift", "mask"])
@pytest.mark.parametrize("shape,geom", B2_SHAPES)
def test_window_attention(gen, shape, geom, mode):
    """B2a in its three mask modes: none, the swin mask from geometry, an
    additive (k^2, L, L) mask operand (the same swin mask, tiled)."""
    q, k, v = (_randn(gen, *shape) for _ in range(3))
    kwargs = {}
    if mode == "shift":
        kwargs["shift_windows"] = geom
    elif mode == "mask":
        kwargs["mask"] = wn.geometry_mask(*geom, device="cuda")
    before = wn.window_attention_fused.launches
    with torch.no_grad():
        got = wn.window_attention_fused(q, k, v, **kwargs)
        want = wn.window_attention_plain(q, k, v, **kwargs)
    assert wn.window_attention_fused.launches == before + 1
    assert _rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("mode", ["none", "shift", "mask"])
def test_window_attention_runs_bit_equal(gen, mode):
    """The key shares' softmax states merge in a fixed order and no atomics
    run: two B2a runs are bit-equal."""
    shape, geom = (12, 91, 128), (2, 7, 13)
    q, k, v = (_randn(gen, *shape, scale=2.0) for _ in range(3))
    kwargs = {"shift": {"shift_windows": geom},
              "mask": {"mask": wn.geometry_mask(*geom, device="cuda")}}.get(mode, {})
    with torch.no_grad():
        first = wn.window_attention_fused(q, k, v, **kwargs)
        second = wn.window_attention_fused(q, k, v, **kwargs)
    assert torch.equal(first, second)


def _sublayer_weights(gen, c):
    return (_randn(gen, c, c, scale=c**-0.5), _randn(gen, c, 2 * c, scale=c**-0.5),
            _randn(gen, c, c, scale=c**-0.5), 1 + _randn(gen, c, scale=0.1),
            _randn(gen, c, scale=0.1))


@pytest.mark.parametrize("self_attn", [True, False])
@pytest.mark.parametrize("shape,geom", B2_SHAPES)
def test_window_sublayer(gen, shape, geom, self_attn):
    """B2b as a block uses it: self-attention with the shift mask and the
    residual, cross-attention unshifted without."""
    xs = _randn(gen, *shape)
    xt = xs if self_attn else _randn(gen, *shape)
    w = _sublayer_weights(gen, shape[-1])
    kwargs = {"shift_windows": geom, "add_residual": True} if self_attn else {}
    before = wn.window_sublayer_fused.launches
    with torch.no_grad():
        got = wn.window_sublayer_fused(xs, xt, *w, **kwargs)
        want = wn.window_sublayer_plain(xs, xt, *w, **kwargs)
    assert wn.window_sublayer_fused.launches == before + 1
    assert _rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("shape,f", [((128, 448, 128), 1024), ((1536, 120, 128), 1024),
                                     ((3, 37, 128), 64), ((8, 35, 128), 1024)])
def test_ffn(gen, shape, f):
    c = shape[-1]
    xs, xm = _randn(gen, *shape), _randn(gen, *shape)
    w0, w2 = _randn(gen, 2 * c, f, scale=(2 * c) ** -0.5), _randn(gen, f, c, scale=f**-0.5)
    ns, nb = 1 + _randn(gen, c, scale=0.1), _randn(gen, c, scale=0.1)
    before = wn.ffn_fused.launches
    with torch.no_grad():
        got = wn.ffn_fused(xs, xm, w0, w2, ns, nb, add_residual=True)
        want = wn.ffn_plain(xs, xm, w0, w2, ns, nb, add_residual=True)
    assert wn.ffn_fused.launches == before + 1
    assert _rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("shape,f", [((3, 37, 128), 64), ((8, 35, 128), 1024),
                                     ((96, 480, 128), 1024)])
def test_ffn_runs_bit_equal(gen, shape, f):
    """B2c sums in a fixed order (no atomics; the four F quarters added in
    the epilogue in one order): two runs are bit-equal, also for token
    counts that are not a multiple of its 64-token tile."""
    c = shape[-1]
    xs, xm = _randn(gen, *shape), _randn(gen, *shape)
    w0, w2 = _randn(gen, 2 * c, f, scale=(2 * c) ** -0.5), _randn(gen, f, c, scale=f**-0.5)
    ns, nb = 1 + _randn(gen, c, scale=0.1), _randn(gen, c, scale=0.1)
    with torch.no_grad():
        first = wn.ffn_fused(xs, xm, w0, w2, ns, nb, add_residual=True)
        second = wn.ffn_fused(xs, xm, w0, w2, ns, nb, add_residual=True)
    assert torch.equal(first, second)


@pytest.mark.parametrize("self_attn", [True, False])
@pytest.mark.parametrize("shape,geom", [((12, 91, 128), (2, 7, 13)),
                                        ((4, 1024, 128), (2, 32, 32))])
def test_window_sublayer_runs_bit_equal(gen, shape, geom, self_attn):
    """B2b: the projections and the attention core sum in a fixed order, so
    two runs are bit-equal (L = 91 and 1024: ragged 32-query and 64-token
    tiles, and the longest window)."""
    xs = _randn(gen, *shape)
    xt = xs if self_attn else _randn(gen, *shape)
    w = _sublayer_weights(gen, shape[-1])
    kwargs = {"shift_windows": geom, "add_residual": True} if self_attn else {}
    with torch.no_grad():
        first = wn.window_sublayer_fused(xs, xt, *w, **kwargs)
        second = wn.window_sublayer_fused(xs, xt, *w, **kwargs)
    assert torch.equal(first, second)


def test_window_sublayer_gradient_on_the_card(gen):
    """The autograd Function: the forward launches B2b, the backward is
    autograd of the plain version; the gradients match the CPU's."""
    shape, geom = (8, 35, 128), (2, 5, 7)
    xs = _randn(gen, *shape)
    w = _sublayer_weights(gen, shape[-1])
    g = _randn(gen, *shape)
    grads = {}
    for device in ("cuda", "cpu"):
        ins = [t.to(device).clone().requires_grad_(True) for t in (xs, *w)]
        before = wn.window_sublayer_fused.launches
        out = wn.window_sublayer_fused(ins[0], ins[0], *ins[1:], shift_windows=geom,
                                       add_residual=True)
        (out * g.to(device)).sum().backward()
        assert wn.window_sublayer_fused.launches == before + (device == "cuda")
        grads[device] = [t.grad.cpu() for t in ins]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert _rel_err(got, want) <= 1e-4


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
    with pytest.raises(ValueError):  # flow of another shape
        wa.warp_adjoint(img, torch.zeros(1, 4, 6, 2, device="cuda"))
    tokens = torch.zeros(4, 8, 32, device="cuda")
    with pytest.raises(ValueError):  # the kernels take C = 128
        wn.window_attention_fused(tokens, tokens, tokens)
    with pytest.raises(ValueError):  # and float32 only
        wn.ffn_fused(*(torch.zeros(4, 8, 128, device="cuda", dtype=torch.bfloat16),) * 2,
                     torch.zeros(256, 64, device="cuda"), torch.zeros(64, 128, device="cuda"),
                     torch.ones(128, device="cuda"), torch.zeros(128, device="cuda"))


@pytest.mark.parametrize("recipe", ["dcmcs3di", "dmsct"])
def test_training_conv_gradients_float64_rule(gen, recipe):
    """One full-width train step of each recipe at its config's batch and
    crop: every distinct f32 conv's gradients, recomputed through the
    module's backward route from the step's own tensors, against float64 on
    the CPU."""
    from color_transfer_tpu_torch.tools import conv_grads as cg

    module, state, batch = cg.recipe_step(recipe)
    cases = cg.capture(module, state, batch)
    del state, batch
    rows = cg.check(cases, {"own": module.backward_cudnn})
    worst = max(rows, key=lambda r: r["excess own"])
    assert worst["excess own"] <= 1.0, (worst["case"].describe(), worst["grad"],
                                        worst["own"], worst["cpu"])
