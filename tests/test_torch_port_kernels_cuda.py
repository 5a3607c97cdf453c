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
another order. Data parallelism on the card: serving split over
["cuda:0", "cuda:0"] bit-equal to the one-device call; two gloo ranks'
collectives on CUDA tensors (the zero-buffer gather, its gradient, the
global BatchNorm moments), exactly. The row-sharded evaluation's halo
conv (two gloo ranks, 8 rows each) against the unsharded conv: f32 1e-5
of scale, bf16 one ulp. DCMCS3DI's bf16 train step, the card against the
CPU stage by stage on each conv route (chip_smoke.py's DC_BF16_ULPS).
conv3x3 (DCMCS3DI's f32 training convs): the output and the input, weight
and bias gradients against float64 within 1e-5 of max|float64| (C3_LINE
says why it holds), on contiguous NHWC inputs and permuted views, two runs
bit-equal, one launch of each kernel a call. Its inference epilogues
(a ResB block as two launches): bit-equal to conv3x3's forward, then
``leaky_relu`` and ATen's add; a 1080x1920 batch-2 block within C3_LINE of
float64, its gap reported beside cuDNN f32's.
"""

import math

import pytest
import torch

from color_transfer_tpu_torch.ops import conv3x3 as c3
from color_transfer_tpu_torch.ops import conv_chain as cc
from color_transfer_tpu_torch.ops import idt_apply as ia
from color_transfer_tpu_torch.ops import local_corr as lc
from color_transfer_tpu_torch.ops import regrain_stencil as rs
from color_transfer_tpu_torch.ops import row_attention as ra
from color_transfer_tpu_torch.ops import warp_adjoint as wa
from color_transfer_tpu_torch.ops import win_attention as wn
from color_transfer_tpu_torch.utils.profiling import counter

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


def _route_counts(kernel):
    """B2a's or B2b's bf16 launches by route (utils/profiling.py's counters)."""
    return {r: counter(f"{kernel}.bf16_route.{r}") for r in wn.ROUTES}


@pytest.mark.parametrize("shape", [(1, 13, 37, 16, 1), (2, 9, 20, 128, 4)])
def test_local_corr(gen, shape):
    b, h, w, c, r = shape
    f0, f1 = _randn(gen, b, h, w, c), _randn(gen, b, h, w, c)
    flow = _randn(gen, b, h, w, 2, scale=3.0)
    before = counter("local_corr.launches")
    with torch.no_grad():
        got = lc.local_correlation_with_flow(f0, f1, flow, r)
        want = lc.local_correlation_with_flow_plain(f0, f1, flow, r)
    assert counter("local_corr.launches") == before + 1
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
    before = counter("resb_chain.launches")
    with torch.no_grad():
        got = cc.resb_chain(x, k, b, dtype)
        want = cc.resb_chain_plain(x, k, b, dtype)
    assert counter("resb_chain.launches") == before + 2 * layers
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
    before = counter("row_attention.launches")
    with torch.no_grad():
        out, cs = ra.row_attention_warp(q, k, v, scale, precise)
        none, cs_only = ra.row_attention_warp(q, k, None, scale, precise)
        want_out, want_cs = ra.row_attention_warp_plain(q, k, v, scale, precise)
    assert counter("row_attention.launches") == before + 2 and none is None
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
    before = counter("row_attention.launches")
    with torch.no_grad():
        out, cs = ra.row_attention_warp(q, k, v, scale, precise)
        _, cs_only = ra.row_attention_warp(q, k, None, scale, precise)
        out_only, no_cs = ra._attend(q, k, v, scale, precise, colsum=False)
        again = ra.row_attention_warp(q, k, v, scale, precise)
        want_out, want_cs = ra.row_attention_warp_plain(q, k, v, scale, precise)
    assert counter("row_attention.launches") == before + 4 and no_cs is None
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


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_dcmcs3di_serving_route(gen, compute_dtype, monkeypatch):
    """DCMCS3DIModule.eval_forward on a CUDA batch takes the materialised
    matcher where its volumes fit (no B5 launch), else the row-attention
    route: two B5 launches a frame, on float32 operands in the f32 recipe
    (which then matches the materialised matcher on the f32 line) and on
    bf16 ones beside B6 in the bf16 recipe."""
    from color_transfer_tpu_torch.run import modules

    kw = dict(extraction_layers=2, transfer_layers=1, channels=64, compute_dtype=compute_dtype)
    variables = modules.DCMCS3DIModule(**kw).init_eval_variables(seed=3, device="cuda")
    t = torch.rand(1, 24, 200, 3, generator=gen).cuda()
    batch = {"target": t, "reference": (t * 0.9 + 0.05).roll(7, dims=2)}
    names = ("row_attention.launches", "row_attention.f32_launches", "resb_chain.launches")

    def launches():  # a new module: each keeps its route by shape
        before = [counter(n) for n in names]
        out = modules.DCMCS3DIModule(**kw).eval_forward(variables, batch)
        torch.cuda.synchronize()
        return out, [counter(n) - b for n, b in zip(names, before)]

    assert modules.materialised_matcher_fits(t)
    want, got = launches()
    assert got == [0, 0, 0]
    monkeypatch.setattr(modules, "materialised_matcher_fits", lambda target: False)
    out, got = launches()
    f32 = compute_dtype is None
    assert got == [2, 2 if f32 else 0, 0 if f32 else 2 * 3]
    if f32:
        assert _rel_err(out, want) <= 1e-4


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
    before = counter("idt_apply.launches")
    got = ia.transport_apply(*args)
    want = ia.transport_apply_plain(*args)
    assert counter("idt_apply.launches") == before + 1
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
    before = counter("regrain_stencil.launches")
    got = rs.regrain_sweeps(out0, const, phis, invd.contiguous(), nbit)
    want = rs.regrain_sweeps_plain(out0, const, phis, invd, nbit)
    assert counter("regrain_stencil.launches") == before + 1
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
    before = counter("warp_adjoint.launches")
    got = wa.warp_adjoint(g, flow)
    want = wa.warp_adjoint_plain(g, flow)
    assert counter("warp_adjoint.launches") == before + 1 and got.shape == shape
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
    before, vec_before = counter("warp_adjoint.launches"), counter("warp_adjoint.vector_launches")
    got = wa.warp_adjoint(g, flow)
    want = wa.warp_adjoint_plain(g, flow)
    assert counter("warp_adjoint.launches") == before + 1
    assert counter("warp_adjoint.vector_launches") == vec_before + (c % 4 == 0)
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
    before = counter("warp_adjoint.launches")
    (flow_warp_batched(f1, fl1) * g).sum().backward()
    assert counter("warp_adjoint.launches") == before + 1
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
        before = counter("warp_adjoint.launches")
        _, logs = module.train_step(state, b, seed=0, metrics=False)
        if device == "cuda":
            torch.cuda.synchronize()
        results[device, dtype] = (float(logs["Training Total Loss"]), grads,
                                  counter("warp_adjoint.launches") - before)
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
    before = counter("win_attention.launches")
    with torch.no_grad():
        got = wn.window_attention_fused(q, k, v, **kwargs)
        want = wn.window_attention_plain(q, k, v, **kwargs)
    assert counter("win_attention.launches") == before + 1
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
    before = counter("win_sublayer.launches")
    with torch.no_grad():
        got = wn.window_sublayer_fused(xs, xt, *w, **kwargs)
        want = wn.window_sublayer_plain(xs, xt, *w, **kwargs)
    assert counter("win_sublayer.launches") == before + 1
    assert _rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("shape,f", [((128, 448, 128), 1024), ((1536, 120, 128), 1024),
                                     ((3, 37, 128), 64), ((8, 35, 128), 1024)])
def test_ffn(gen, shape, f):
    c = shape[-1]
    xs, xm = _randn(gen, *shape), _randn(gen, *shape)
    w0, w2 = _randn(gen, 2 * c, f, scale=(2 * c) ** -0.5), _randn(gen, f, c, scale=f**-0.5)
    ns, nb = 1 + _randn(gen, c, scale=0.1), _randn(gen, c, scale=0.1)
    before = counter("win_ffn.launches")
    with torch.no_grad():
        got = wn.ffn_fused(xs, xm, w0, w2, ns, nb, add_residual=True)
        want = wn.ffn_plain(xs, xm, w0, w2, ns, nb, add_residual=True)
    assert counter("win_ffn.launches") == before + 1
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
        before = counter("win_sublayer.launches")
        out = wn.window_sublayer_fused(ins[0], ins[0], *ins[1:], shift_windows=geom,
                                       add_residual=True)
        (out * g.to(device)).sum().backward()
        assert counter("win_sublayer.launches") == before + (device == "cuda")
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
    with pytest.raises(ValueError):  # conv3x3 takes 64 channels
        c3.conv3x3(torch.zeros(1, 4, 5, 32, device="cuda"),
                   torch.zeros(64, 64, 3, 3, device="cuda"))
    with pytest.raises(ValueError):  # and float32 only
        c3.conv3x3(torch.zeros(1, 4, 5, 64, device="cuda", dtype=torch.float64),
                   torch.zeros(64, 64, 3, 3, device="cuda", dtype=torch.float64))
    with pytest.raises(ValueError):  # a ResB block: float32 only
        c3.resb(torch.zeros(1, 4, 5, 64, device="cuda", dtype=torch.float64),
                *(torch.zeros(s, device="cuda", dtype=torch.float64)
                  for s in ((64, 64, 3, 3), (64,), (64, 64, 3, 3), (64,))))
    with pytest.raises(ValueError):  # and float32 only
        wn.ffn_fused(*(torch.zeros(4, 8, 128, device="cuda", dtype=torch.bfloat16),) * 2,
                     torch.zeros(256, 64, device="cuda"), torch.zeros(64, 128, device="cuda"),
                     torch.ones(128, device="cuda"), torch.zeros(128, device="cuda"))


@pytest.mark.parametrize("recipe", ["dcmcs3di", "dcmcs3di_bf16", "dmsct"])
def test_training_conv_gradients_float64_rule(gen, recipe):
    """One full-width train step of each recipe at its config's batch and
    crop: every distinct f32 conv's gradients, recomputed through the
    module's backward route (DCMCS3DI's 3x3 64 -> 64 convs through the
    conv3x3 kernels) from the step's own tensors, against float64 on the
    CPU."""
    from color_transfer_tpu_torch.tools import conv_grads as cg

    module, state, batch = cg.recipe_step(recipe)
    cases = cg.capture(module, state, batch)
    del state, batch
    rows = cg.check(cases, ("own",), module)
    worst = max(rows, key=lambda r: r["excess own"])
    assert worst["excess own"] <= 1.0, (worst["case"].describe(), worst["grad"],
                                        worst["own"], worst["cpu"])


# -- conv3x3: DCMCS3DI's f32 training convolutions -----------------------------

# The extractor's and the matcher head's shape (both views stacked), the
# transfer net's, and ragged ones: H and W off the 8 x 32 tile, batch 1, an
# image narrower than a tile.
C3_SHAPES = [(16, 160, 320, 64), (8, 160, 320, 64), (2, 37, 45, 64), (1, 13, 37, 64),
             (3, 17, 20, 64), (1, 5, 7, 64)]
# Each output of the forward is one f32 sum of 576 products in ATen's order,
# of the input gradient four sums of 144 added in order, each weight
# gradient a thread's f32 sum over a band of pixels (~9,300 at the
# extractor's shape) and then the bands' sums: rounding of ~sqrt(n) eps of
# the terms. Measured on the card (PERF.md): at most 1.8e-6 of max|float64|
# at the full shapes, the forward's as ATen's own f32 GEMM. The line is the
# float64 rule's ATOL (tools/conv_grads.py), 1e-5 of max|float64|.
C3_LINE = 1e-5


def _c3_inputs(gen, shape, layout):
    b, h, w, c = shape
    if layout == "nhwc":
        x = _randn(gen, *shape)
        gy = _randn(gen, *shape)
    else:  # NCHW tensors seen as NHWC
        x = _randn(gen, b, c, h, w).permute(0, 2, 3, 1)
        gy = _randn(gen, b, c, h, w).permute(0, 2, 3, 1)
    return x, _randn(gen, 64, 64, 3, 3, scale=1 / 24), _randn(gen, 64), gy


@pytest.mark.parametrize("layout", ["nhwc", "permuted"])
@pytest.mark.parametrize("shape", C3_SHAPES)
def test_conv3x3(gen, shape, layout):
    """The output, input, weight and bias gradients of conv3x3 (its
    autograd Function on the card) against float64 F.conv2d and autograd;
    one launch of each kernel a call."""
    x, w, b, gy = _c3_inputs(gen, shape, layout)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    before = [counter(n) for n in ("conv3x3.launches", "conv3x3.dgrad_launches",
                                   "conv3x3.wgrad_launches")]
    y = c3.conv3x3(*leaves)
    got = (y, *torch.autograd.grad(y, leaves, gy))
    after = [counter(n) for n in ("conv3x3.launches", "conv3x3.dgrad_launches",
                                  "conv3x3.wgrad_launches")]
    assert [a - c for a, c in zip(after, before)] == [1, 1, 1]
    ref = [t.double().requires_grad_(True) for t in (x, w, b)]
    y64 = c3.conv3x3_plain(*ref)
    want = (y64, *torch.autograd.grad(y64, ref, gy.double()))
    for name, a, r in zip(("y", "gx", "gw", "gb"), got, want):
        assert a.shape == r.shape and a.dtype == torch.float32
        err = float((a.detach().double() - r.detach()).abs().max() / r.detach().abs().max())
        assert err <= C3_LINE, (name, err)


@pytest.mark.parametrize("shape", [(16, 160, 320, 64), (8, 160, 320, 64)])
def test_conv3x3_forward_is_atens(gen, shape):
    """The forward sums each output's products in the order of ATen's
    im2col GEMM, the route it replaces (cuDNN off, TF32 off): the same bits
    at the training step's two shapes. Not at every shape: at (3, 17, 20,
    64) (340 pixels an image) the two differ, cuBLAS summing there in
    another order."""
    from color_transfer_tpu_torch.core.precision import conv_route, full_f32

    x, w, b, _ = _c3_inputs(gen, shape, "nhwc")
    with full_f32(), conv_route(False):
        want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, b, padding=1)
    assert torch.equal(c3.forward_kernel(x, w, b), want.permute(0, 2, 3, 1))


@pytest.mark.parametrize("shape", [(16, 160, 320, 64), (3, 17, 20, 64)])
def test_conv3x3_runs_bit_equal(gen, shape):
    """No float atomics: two calls of each kernel give the same bits."""
    x, w, b, gy = _c3_inputs(gen, shape, "nhwc")
    runs = [(c3.forward_kernel(x, w, b), c3.input_grad_kernel(gy, w),
             *c3.weight_grad_kernel(x, gy)) for _ in range(2)]
    for a, r in zip(*runs):
        assert torch.equal(a, r)


def _resb_weights(gen):
    return (_randn(gen, 64, 64, 3, 3, scale=1 / 24), _randn(gen, 64, scale=0.1),
            _randn(gen, 64, 64, 3, 3, scale=1 / 24), _randn(gen, 64, scale=0.1))


@pytest.mark.parametrize("shape", [(2, 72, 160, 64), (1, 67, 97, 64)])
def test_resb_epilogues_bit_equal(gen, shape):
    """Each epilogue launch against conv3x3's forward and the elementwise
    step it takes in (``layers.leaky_relu``, ATen's add), bit for bit, on
    the tiled and on a ragged shape; ``resb`` is the two launches, counted
    in ``conv3x3.resb_launches`` and not in ``conv3x3.launches``."""
    from color_transfer_tpu_torch.models.layers import leaky_relu

    x = _randn(gen, *shape)
    w0, b0, w1, b1 = _resb_weights(gen)
    y1 = c3.epilogue_kernel(x, w0, b0, c3.LEAKY_RELU)
    assert torch.equal(y1, leaky_relu(c3.forward_kernel(x, w0, b0)))
    assert bool((y1 < 0).any())  # the slope was taken
    out = c3.epilogue_kernel(y1, w1, b1, c3.RESIDUAL, x)
    assert torch.equal(out, x + c3.forward_kernel(y1, w1, b1))
    names = ("conv3x3.resb_launches", "conv3x3.launches")
    before = [counter(n) for n in names]
    got = c3.resb(x, w0, b0, w1, b1)
    assert [counter(n) - b for n, b in zip(names, before)] == [2, 0]
    assert torch.equal(got, out)


def test_resb_at_1080p_against_float64(gen):
    """A ResB block at the served extractor's shape, (2, 1080, 1920, 64)
    (16,200 blocks a launch), against float64 on the card within C3_LINE of
    max|float64|; cuDNN f32's gap (the route it replaces, TF32 off) beside
    it."""
    from color_transfer_tpu_torch.core.precision import conv_route, full_f32

    x = _randn(gen, 2, 1080, 1920, 64)
    params = _resb_weights(gen)
    got = c3.resb(x, *params)
    with full_f32(), conv_route(True):
        library = c3.resb_plain(x, *params)
    want = c3.resb_plain(x.double(), *(p.double() for p in params))
    scale = float(want.abs().max())
    err = float((got.double() - want).abs().max()) / scale
    lib_err = float((library.double() - want).abs().max()) / scale
    print(f"resb (2, 1080, 1920, 64) of max|float64|: conv3x3 {err:.3e}, cuDNN f32 {lib_err:.3e}")
    assert err <= C3_LINE, (err, lib_err)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_dcmcs3di_inference_resb_launches(gen, compute_dtype, monkeypatch):
    """DCMCS3DIModule.eval_forward on a CUDA batch runs every f32 ResB
    block through ``resb``: two launches a block (the f32 recipe's 2 + 1
    stack blocks and the matcher head; the bf16 recipe's head alone), none
    of the training Function's; on the f32 line of the same forward with
    the route off (cuDNN's convs)."""
    from color_transfer_tpu_torch.models import layers
    from color_transfer_tpu_torch.run import modules

    kw = dict(extraction_layers=2, transfer_layers=1, channels=64, compute_dtype=compute_dtype)
    variables = modules.DCMCS3DIModule(**kw).init_eval_variables(seed=3, device="cuda")
    t = torch.rand(1, 24, 200, 3, generator=gen).cuda()
    batch = {"target": t, "reference": (t * 0.9 + 0.05).roll(7, dims=2)}
    names = ("conv3x3.resb_launches", "conv3x3.launches")
    before = [counter(n) for n in names]
    got = modules.DCMCS3DIModule(**kw).eval_forward(variables, batch)
    torch.cuda.synchronize()
    blocks = 2 + 1 + 1 if compute_dtype is None else 1
    assert [counter(n) - b for n, b in zip(names, before)] == [2 * blocks, 0]
    monkeypatch.setattr(layers, "takes_resb", lambda *a: False)
    want = modules.DCMCS3DIModule(**kw).eval_forward(variables, batch)
    assert _rel_err(got, want) <= 1e-4


# -- data parallelism on the card ---------------------------------------------


@pytest.mark.parametrize("method", ["dmsct", "automated_color_grading"])
def test_split_serving_bit_equal_on_card(gen, method):
    """A chunk split over ["cuda:0", "cuda:0"] (the one card named twice)
    is bit-equal to the one-device call, a ragged chunk included."""
    from color_transfer_tpu_torch.methods.video import color_transfer_between_videos

    t = torch.rand(3, 64, 96, 3, generator=gen)
    r = (t.roll(4, dims=2) * 0.9 + 0.05).clamp(0, 1)
    kw = {}
    if method == "dmsct":
        from color_transfer_tpu_torch.run.modules import DMSCTModule

        module = DMSCTModule(matcher_num_layers=1, matcher_num_reg_refine=1)
        kw = {"module": module, "variables": module.init_eval_variables(0, device="cuda:0")}
    one = color_transfer_between_videos(t, r, method=method, device="cuda:0", **kw)
    if "variables" in kw:
        kw["devices"] = ["cuda:0", "cuda:0"]
        split = color_transfer_between_videos(t, r, method=method, **kw)
    else:
        split = color_transfer_between_videos(t, r, method=method, batch_size=2,
                                              devices=["cuda:0", "cuda:0"])
        # "cuda" without an index: the current card, as before device lists
        one = color_transfer_between_videos(t, r, method=method, device="cuda", batch_size=1)
    assert one.device == split.device == torch.device("cuda:0") and torch.equal(one, split)


_GLOO_CUDA = """
import sys, torch
from color_transfer_tpu_torch.parallel import data_parallel as dp, multihost
rank = int(sys.argv[1])
multihost.initialize_distributed(sys.argv[2], 2, rank, backend="gloo", device="cuda:0",
                                 timeout=60)
x = torch.full((3,), float(rank + 1), device="cuda:0", requires_grad=True)
both = dp.gather_rows(x)
assert torch.equal(both.detach().cpu(), torch.tensor([[1.0] * 3, [2.0] * 3])), both
(both.sum() * (rank + 1)).backward()
assert torch.equal(x.grad.cpu(), torch.full((3,), 3.0)), x.grad
mean, var = dp.batch_moments(torch.arange(8.0, device="cuda:0").reshape(2, 4)[rank:rank + 1] * 1.0, (0, 1))
want_var, want_mean = torch.var_mean(torch.arange(8.0), correction=0)
assert torch.allclose(mean.cpu(), want_mean) and torch.allclose(var.cpu(), want_var)
print(f"OK rank {rank}")
"""


def test_gloo_collectives_on_cuda_tensors(gen, tmp_path):
    """Two gloo ranks on the one card: the zero-buffer gather and its
    gradient, and the global moments (the collectives phase 12 runs)."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "gloo_cuda.py"
    script.write_text(_GLOO_CUDA)
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]))
    procs = [subprocess.Popen([sys.executable, str(script), str(r), f"127.0.0.1:{port}"],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"OK rank {r}" in out, out[-3000:]


# -- the bf16 instantiations (DMSCT's bf16 recipes) ---------------------------------
# Lines in bf16 ulps of the output's magnitude: B2a, B2b, B2c round at the
# TPU kernel's points as their plain versions do, summing exact bf16
# products in f32 in other orders, so a value within an f32 rounding of a
# bf16 boundary rounds the other way and, in B2b's and B2c's chains, feeds
# the next rounding: 2 ulps. B1's output is f32 from exact products: f32
# rounding only, 1/64 ulp.


def _bf16_ulps(got, want):
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / 2.0 ** (math.floor(math.log2(scale)) - 7)


@pytest.mark.parametrize("shape,r", [((2, 128, 224, 128), 4), ((24, 64, 120, 128), 4),
                                     ((1, 13, 37, 16), 1), ((3, 20, 24, 256), 4),
                                     ((2, 24, 33, 72), 2)])
@pytest.mark.parametrize("kind", ["mixed", "smooth", "rough", "step", "clamped"])
def test_local_corr_bf16(gen, shape, r, kind):
    """B1's bf16 instantiation (corr_dtype=bfloat16) on both routes (the
    per-pixel one on the tensor cores, C from 16 to 256 channels, 72 a
    ragged count of 16-byte vectors a lane): held to the plain version, the
    routes to tile_boxes, two runs bit-equal, its launch counted as bf16.
    The rough flow (sub-pixel and x40 displacements) sends most tiles to
    the per-pixel route."""
    b, h, w, c = shape
    f0, f1 = (_randn(gen, *shape).to(torch.bfloat16) for _ in range(2))
    if kind == "rough":
        flow = _randn(gen, b, h, w, 2, scale=3.0)
        flow = torch.where(_randn(gen, b, h, w, 1) > 0.5, flow * 40, flow).contiguous()
    else:
        flow = _b1_flow(gen, kind, b, h, w).contiguous()
    before = counter("local_corr.bf16_launches")
    with torch.no_grad():
        got = lc.local_correlation_with_flow(f0, f1, flow, r, corr_dtype=torch.bfloat16)
        again, routes = lc._launch(f0, f1, flow, r, routes=True)
        want = lc.local_correlation_with_flow_plain(f0, f1, flow, r)
    assert counter("local_corr.bf16_launches") == before + 2
    assert got.dtype == torch.float32 and torch.equal(got, again)
    staged = lc.tile_boxes(flow, r, lc.launch_plan(c, r, 2))["staged"]
    assert torch.equal(routes.bool(), staged)
    if kind in ("mixed", "rough") and r == 4:
        assert not bool(staged.all())
    if kind == "clamped":  # no live pixel: zeros, as the plain version's
        assert not bool(got.any()) and not bool(want.any())
    else:
        assert _bf16_ulps(got, want) <= 1 / 64


@pytest.mark.parametrize("r", [0, 1, 2, 3, 4])
def test_local_corr_bf16_radii(gen, r):
    """Every instantiated radius in bf16, at the served width C = 128, on a
    step flow (both routes from r = 2 on)."""
    b, h, w, c = 2, 19, 45, 128
    f0, f1 = (_randn(gen, b, h, w, c).to(torch.bfloat16) for _ in range(2))
    flow = _b1_flow(gen, "step", b, h, w).contiguous()
    with torch.no_grad():
        got, routes = lc._launch(f0, f1, flow, r, routes=True)
        want = lc.local_correlation_with_flow_plain(f0, f1, flow, r)
    staged = lc.tile_boxes(flow, r, lc.launch_plan(c, r, 2))["staged"]
    assert torch.equal(routes.bool(), staged)
    if r >= 2:  # smaller windows' boxes all fit
        assert not bool(staged.all())
    assert _bf16_ulps(got, want) <= 1 / 64


# The bf16 recipe's shapes, a streamed L (1024, and 1000 ragged), ragged Ls
# (200, 35, 91) and L = 1. B2a and B2b run on every route their plan allows
# (ops/win_attention.py::attention_plan: the resident one where it fits, the
# streamed one always); the routes do the same arithmetic: bit-equal.
B2_BF16_SHAPES = [((256, 448, 128), (8, 16, 28)), ((96, 480, 128), (2, 16, 30)),
                  ((3072, 120, 128), (8, 8, 15)), ((8, 35, 128), (2, 5, 7)),
                  ((4, 1000, 128), (2, 20, 50)), ((12, 91, 128), (2, 7, 13)),
                  ((16, 1024, 128), (2, 32, 32)), ((64, 200, 128), (2, 10, 20)),
                  ((4, 1, 128), (2, 1, 1))]


def _routes(shape, sublayer):
    plan = wn.attention_plan(shape[1], shape[0], sublayer=sublayer)
    return ["resident", "streamed"] if plan.route == "resident" else ["streamed"]


@pytest.mark.parametrize("mode", ["none", "shift", "mask"])
@pytest.mark.parametrize("shape,geom", B2_BF16_SHAPES)
def test_window_attention_bf16(gen, shape, geom, mode):
    """B2a in bf16 on each route its plan allows, held to the plain version;
    two runs and the routes bit-equal; launches counted by route."""
    q, k, v = (_randn(gen, *shape).to(torch.bfloat16) for _ in range(3))
    mask = wn.geometry_mask(*geom, device="cuda") if mode == "mask" else None
    geom = geom if mode == "shift" else None
    kwargs = {} if mask is None else {"mask": mask}
    routes = _routes(shape, False)
    before = counter("win_attention.bf16_launches")
    by_route = _route_counts("win_attention")
    with torch.no_grad():
        got = wn.window_attention_fused(q, k, v, shift_windows=geom, **kwargs)
        again = wn.window_attention_fused(q, k, v, shift_windows=geom, **kwargs)
        forced = [wn._launch_attention(q, k, v, mask, shift_windows=geom, route=r)
                  for r in routes]
        want = wn.window_attention_plain(q, k, v, shift_windows=geom, **kwargs)
    assert counter("win_attention.bf16_launches") == before + 2 + len(routes)
    plan = wn.attention_plan(shape[1], shape[0]).route
    assert {r: n - by_route[r] for r, n in _route_counts("win_attention").items()} == {
        r: 2 * (r == plan) + (r in routes) for r in wn.ROUTES}
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    assert all(torch.equal(got, f) for f in forced)
    assert _bf16_ulps(got, want) <= 2


@pytest.mark.parametrize("self_attn", [True, False])
@pytest.mark.parametrize("shape,geom", B2_BF16_SHAPES)
def test_window_sublayer_bf16(gen, shape, geom, self_attn):
    """B2b in bf16 (self: the shift and the residual; cross: neither) on each
    route its plan allows, as test_window_attention_bf16."""
    xs = _randn(gen, *shape).to(torch.bfloat16)
    xt = xs if self_attn else _randn(gen, *shape).to(torch.bfloat16)
    w = [t.to(torch.bfloat16) if t.ndim == 2 else t for t in _sublayer_weights(gen, shape[-1])]
    kwargs = {"shift_windows": geom, "add_residual": True} if self_attn else {}
    routes = _routes(shape, True)
    before = counter("win_sublayer.bf16_launches")
    by_route = _route_counts("win_sublayer")
    with torch.no_grad():
        got = wn.window_sublayer_fused(xs, xt, *w, **kwargs)
        again = wn.window_sublayer_fused(xs, xt, *w, **kwargs)
        forced = [wn._launch_sublayer(xs, xt, *w, route=r, **kwargs) for r in routes]
        want = wn.window_sublayer_plain(xs, xt, *w, **kwargs)
    assert counter("win_sublayer.bf16_launches") == before + 2 + len(routes)
    plan = wn.attention_plan(shape[1], shape[0], sublayer=True).route
    assert {r: n - by_route[r] for r, n in _route_counts("win_sublayer").items()} == {
        r: 2 * (r == plan) + (r in routes) for r in wn.ROUTES}
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    assert all(torch.equal(got, f) for f in forced)
    assert _bf16_ulps(got, want) <= 2


def test_attention_plan_matches_the_library(gen):
    """attention_plan's shared memory is the kernel library's sum
    (win_common.cuh::attention_smem_bf16) for every L and route; a route
    that does not fit raises, on the plan and in the launcher (no
    fallback)."""
    import ctypes

    smem = wn._kernel("win_attention", "window_attention_bf16_smem", [ctypes.c_int] * 3)
    for length in range(1, wn._MAX_L + 1):
        for sub in (False, True):
            for route in wn.ROUTES:
                lib = smem(wn.ROUTES.index(route), length, int(sub))
                if lib > wn.BLOCK_SMEM_LIMIT:
                    with pytest.raises(ValueError):
                        wn.attention_plan(length, 1, sublayer=sub, route=route)
                else:
                    assert wn.attention_plan(length, 1, sublayer=sub, route=route).smem == lib
    q = _randn(gen, 2, 1024, 128).to(torch.bfloat16)
    with pytest.raises(ValueError, match="resident"):
        wn._launch_attention(q, q, q, None, route="resident")
    w = [t.to(torch.bfloat16) if t.ndim == 2 else t for t in _sublayer_weights(gen, 128)]
    x = _randn(gen, 2, 600, 128).to(torch.bfloat16)
    with pytest.raises(ValueError, match="resident"):
        wn._launch_sublayer(x, x, *w, route="resident")


# B2c bf16: the bf16 recipe's shapes, ragged token counts (a partial
# 128-token block; (3, 37) and (4, 1) a single block) and F = 64, 512, 1024,
# 2048.
FFN_BF16_CASES = [((256, 448, 128), 1024), ((3072, 120, 128), 1024), ((96, 480, 128), 1024),
                  ((3, 37, 128), 64), ((8, 35, 128), 1024), ((64, 200, 128), 512),
                  ((4, 1, 128), 1024), ((5, 77, 128), 2048)]


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("shape,f", FFN_BF16_CASES)
def test_ffn_bf16(gen, shape, f, residual):
    """B2c in bf16 held to the plain version at 2 ulps; two runs
    bit-equal (the same sums in the same order)."""
    c = shape[-1]
    bf = torch.bfloat16
    xs, xm = _randn(gen, *shape).to(bf), _randn(gen, *shape).to(bf)
    w0 = _randn(gen, 2 * c, f, scale=(2 * c) ** -0.5).to(bf)
    w2 = _randn(gen, f, c, scale=f**-0.5).to(bf)
    ns, nb = 1 + _randn(gen, c, scale=0.1), _randn(gen, c, scale=0.1)
    before = counter("win_ffn.bf16_launches")
    with torch.no_grad():
        got = wn.ffn_fused(xs, xm, w0, w2, ns, nb, add_residual=residual)
        again = wn.ffn_fused(xs, xm, w0, w2, ns, nb, add_residual=residual)
        want = wn.ffn_plain(xs, xm, w0, w2, ns, nb, add_residual=residual)
    assert counter("win_ffn.bf16_launches") == before + 2
    assert got.dtype == bf and torch.equal(got, again)
    assert _bf16_ulps(got, want) <= 2


def test_ffn_plan_matches_the_library(gen):
    """ffn_plan's shared memory is the kernel library's (ffn_bf16_smem) at
    every F tried; an F that is not a multiple of 64 raises on the plan and
    in the launcher (no fallback)."""
    smem = wn._kernel("win_ffn", "ffn_bf16_smem", [])()
    for f in range(64, 2049, 64):
        assert wn.ffn_plan(1000, f).smem == smem <= wn.BLOCK_SMEM_LIMIT
    x = _randn(gen, 2, 35, 128).to(torch.bfloat16)
    w0 = _randn(gen, 256, 96).to(torch.bfloat16)
    w2 = _randn(gen, 96, 128).to(torch.bfloat16)
    ns, nb = _randn(gen, 128), _randn(gen, 128)
    before = counter("win_ffn.launches")
    with pytest.raises(ValueError, match="multiple of 64"):
        wn.ffn_fused(x, x, w0, w2, ns, nb)
    with pytest.raises(ValueError, match="multiple of 64"):
        wn.ffn_plan(70, 96)
    assert counter("win_ffn.launches") == before


def _ffn_probe(symbol, argtypes):
    """A probe of csrc/win_ffn.cu: its pointer arguments, then the stream."""
    import ctypes

    return wn._kernel("win_ffn", symbol, [ctypes.c_void_p] * (argtypes + 1))


def test_wgmma_64x64_mn_major_b(gen):
    """hopper.cuh's wgmma_64x64x16_tb (B2c bf16's first product): A K-major
    and B MN-major in shared memory under the 128-byte swizzle, against
    torch.matmul (exact bf16 products, f32 sums in another order)."""
    a = _randn(gen, 64, 16).bfloat16()
    b = _randn(gen, 16, 64).bfloat16()
    d = torch.full((64, 64), float("nan"), device="cuda")
    fn = _ffn_probe("ffn_wgmma_probe", 3)
    assert fn(a.data_ptr(), b.data_ptr(), d.data_ptr(),
              torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert float((d - a.float() @ b.float()).abs().max()) <= 1e-5


def test_ffn_gelu_against_plain(gen):
    """B2c bf16's GELU (gelu_pair: h rounded to bf16, the A&S erf with
    __frcp_rn in place of the division, rounded) against the plain
    version's gelu_as on the card, over h values in [-8, 8]: a value within
    an f32 rounding of a bf16 boundary may round the other way (the plain
    version's ops round one by one, the kernel's contract into FMAs), so
    within one bf16 ulp of each value, and nearly all equal."""
    n = 1 << 16
    x = (torch.rand(n, 2, generator=gen) * 16 - 8).cuda()
    y = torch.empty(2 * n, dtype=torch.int32, device="cuda")
    import ctypes

    fn = wn._kernel("win_ffn", "ffn_gelu_probe",
                    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    assert fn(x.data_ptr(), y.data_ptr(), n, torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    got = y[:n].view(torch.bfloat16).reshape(n, 2).float()
    want = wn.gelu_as(x.bfloat16()).float()
    ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want.abs().clamp(min=2.0**-126))[1] - 8)
    assert bool(((got - want).abs() <= ulp).all())
    assert float((got == want).float().mean()) >= 0.999


def test_bf16_tokens_need_bf16_weights(gen):
    """A bf16 tensor a wrapper cannot take raises on the card; it does not
    fall back to the plain version."""
    x = _randn(gen, 8, 35, 128).to(torch.bfloat16)
    w = _sublayer_weights(gen, 128)  # f32 weights
    before = counter("win_sublayer.launches")
    with pytest.raises(ValueError):
        wn.window_sublayer_fused(x, x, *w)
    with pytest.raises(ValueError, match="multiple of 8"):
        f = _randn(gen, 1, 4, 6, 12).to(torch.bfloat16)
        lc.local_correlation_with_flow(f, f, _randn(gen, 1, 4, 6, 2), 1,
                                       corr_dtype=torch.bfloat16)
    assert counter("win_sublayer.launches") == before


# -- the row-sharded evaluation's halo conv and DCMCS3DI's bf16 train step ----------

_HALO_CUDA = """
import sys, torch
from color_transfer_tpu_torch.models.layers import conv
from color_transfer_tpu_torch.parallel import multihost
from color_transfer_tpu_torch.parallel.mesh import process_mesh
from color_transfer_tpu_torch.parallel.row_attention_sp import row_shard
rank = int(sys.argv[1])
multihost.initialize_distributed(sys.argv[2], 2, rank, backend="gloo", device="cuda:0",
                                 timeout=60)
torch.backends.cudnn.allow_tf32 = False
g = torch.Generator().manual_seed(0)
x = torch.randn(2, 16, 24, 8, generator=g).cuda()
w, b = torch.randn(8, 8, 3, 3, generator=g).cuda(), torch.randn(8, generator=g).cuda()
mesh = process_mesh((1, 2), ("data", "seq"))
with torch.no_grad():
    for dtype in (None, torch.bfloat16):
        want = conv(x, w, b, (1, 1), dtype)[:, rank * 8:(rank + 1) * 8].float()
        with row_shard(mesh["seq"]):
            got = conv(x[:, rank * 8:(rank + 1) * 8], w, b, (1, 1), dtype).float()
        err = float((got - want).abs().max()) / float(want.abs().max())
        line = 1e-5 if dtype is None else 2.0 ** -8
        assert err <= line, (dtype, err)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
print(f"OK rank {rank}")
"""


def test_halo_conv_against_the_unsharded_conv(gen, tmp_path):
    """Two gloo ranks on the one card, each holding 8 of 16 image rows: a
    3x3 conv with its halo rows from the other rank equals the unsharded
    conv's rows (f32 1e-5 of scale: the conv on 10 rows against 16 may pick
    another algorithm; bf16 one ulp of scale)."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "halo_cuda.py"
    script.write_text(_HALO_CUDA)
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]))
    procs = [subprocess.Popen([sys.executable, str(script), str(r), f"127.0.0.1:{port}"],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"OK rank {r}" in out, out[-3000:]


@pytest.mark.parametrize("route", ["cudnn", "aten"])
def test_dcmcs3di_bf16_step_stages_on_the_card(gen, route):
    """DCMCS3DI's bf16 train step at full width on (2, 32, 64), the card
    against the port's CPU run, stage by stage, in bf16 ulps
    (chip_smoke.py::check_dc_bf16_small and its DC_BF16_ULPS lines), with
    its bf16 convs on each route."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    worst, _ = smoke.check_dc_bf16_small(route)
    assert max(worst.values()) <= 1.0, worst
