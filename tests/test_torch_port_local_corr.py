"""Port parity: the local correlation's plain torch version
(color_transfer_tpu_torch/ops/local_corr.py) against the JAX package's XLA
path and its Pallas kernel run in interpret mode (both schedules).

Tolerance: max|d| <= 1e-5 * max(1, max|ref|) — f32 on both sides, the
channel sums taken in another order. The CUDA kernel itself needs the card;
chip_smoke.py holds it against this plain version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from color_transfer_tpu.models.gmflow import _local_correlation_with_flow_xla
from color_transfer_tpu.ops.local_corr import local_correlation_with_flow_pallas
from color_transfer_tpu_torch.ops import local_corr as lc
from color_transfer_tpu_torch.utils.profiling import counter

SHAPES = {16: (2, 6, 10), 128: (1, 5, 7)}  # 120 and 35 pixels: no block multiple


def _inputs(rng, c, flow_kind):
    b, h, w = SHAPES[c]
    f0 = rng.normal(size=(b, h, w, c)).astype(np.float32)
    f1 = rng.normal(size=(b, h, w, c)).astype(np.float32)
    frac = rng.normal(size=(b, h, w, 2)) * 1.5
    far = np.sign(rng.normal(size=(b, h, w, 2))) * rng.uniform(30, 400, (b, h, w, 2))
    if flow_kind == "fractional":
        flow = frac
    elif flow_kind == "zero":
        flow = np.zeros((b, h, w, 2))
    elif flow_kind == "outside":
        flow = far
    else:  # a mix of all three, per pixel
        kind = rng.integers(0, 3, (b, h, w, 1))
        flow = np.where(kind == 0, frac, np.where(kind == 1, 0.0, far))
    return f0, f1, flow.astype(np.float32)


def _check(got, want):
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= 1e-5 * max(1.0, np.abs(want).max()), err


def _plain(f0, f1, flow, r):
    return lc.local_correlation_with_flow_plain(
        torch.from_numpy(f0), torch.from_numpy(f1), torch.from_numpy(flow), r
    ).numpy()


@pytest.mark.parametrize("flow_kind", ["fractional", "zero", "outside"])
@pytest.mark.parametrize("c", [16, 128])
@pytest.mark.parametrize("r", [1, 4])
def test_plain_matches_xla(rng, r, c, flow_kind):
    f0, f1, flow = _inputs(rng, c, flow_kind)
    want = _local_correlation_with_flow_xla(
        jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(flow), r, jnp.float32
    )
    _check(_plain(f0, f1, flow, r), np.asarray(want))


@pytest.mark.parametrize("variant", ["vpu", "mxu"])
@pytest.mark.parametrize("c", [16, 128])
@pytest.mark.parametrize("r", [1, 4])
def test_plain_matches_pallas_interpret(rng, r, c, variant):
    f0, f1, flow = _inputs(rng, c, "mixed")
    want = local_correlation_with_flow_pallas(
        jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(flow), r,
        corr_dtype=jnp.float32, p_blk=32, interpret=True, variant=variant,
    )
    _check(_plain(f0, f1, flow, r), np.asarray(want))


def test_wrapper_takes_plain_path_on_cpu(rng):
    f0, f1, flow = (torch.from_numpy(a) for a in _inputs(rng, 16, "mixed"))
    before = counter("local_corr.launches")
    got = lc.local_correlation_with_flow(f0, f1, flow, 4)
    assert counter("local_corr.launches") == before == 0
    torch.testing.assert_close(
        got, lc.local_correlation_with_flow_plain(f0, f1, flow, 4), rtol=0, atol=0
    )


@pytest.mark.parametrize("bad", ["dtype", "channels", "noncontiguous", "misaligned",
                                 "flow_shape", "radius", "negative_radius",
                                 "wide"])
def test_kernel_input_checks(bad):
    f0 = torch.zeros(1, 4, 6, 16)
    f1 = torch.zeros(1, 4, 6, 16)
    flow = torch.zeros(1, 4, 6, 2)
    r = 4
    lc.check_kernel_inputs(f0, f1, flow, r)  # the good case passes
    if bad == "dtype":
        f0, f1 = f0.double(), f1.double()
    elif bad == "channels":
        f0, f1 = torch.zeros(1, 4, 6, 18), torch.zeros(1, 4, 6, 18)
    elif bad == "noncontiguous":
        f1 = torch.zeros(1, 6, 4, 16).transpose(1, 2)
    elif bad == "misaligned":  # contiguous, but 4 bytes past a float4 boundary
        f0 = torch.zeros(1 + 4 * 6 * 16)[1:].view(1, 4, 6, 16)
    elif bad == "flow_shape":
        flow = torch.zeros(1, 4, 6, 3)
    elif bad == "negative_radius":
        r = -1
    elif bad == "wide":  # past MAX_CHANNELS
        f0, f1 = torch.zeros(1, 4, 6, 260), torch.zeros(1, 4, 6, 260)
    else:
        r = 5  # past MAX_RADIUS
    with pytest.raises(ValueError):
        lc.check_kernel_inputs(f0, f1, flow, r)


# --- The kernel's design, checked on the CPU --------------------------------
# The CUDA kernel computes (2r+2)^2 dots a pixel (the plain version and the
# TPU kernels (2r+3)^2), stages each tile's bounding box of windows in shared
# memory when it fits launch_plan's budget, and reads zeros there for
# positions outside the image. Its arithmetic runs only on the card; what
# surrounds it is held here to the plain version.


def _dots(f0, f1, flow, r, k):
    """The plain version's integer-grid dots over a k x k window (its own
    gather, the (2r+3)^2 one at k = 2r+3): (B, HW, k, k)."""
    b, h, w, c = f0.shape
    sx, sy, _, _, _ = lc.window_starts(flow, r)
    pad = 2 * r + 4
    wp = w + 2 * pad
    start = ((sy + pad) * wp + (sx + pad)).reshape(b, h * w, 1)
    f1p = torch.nn.functional.pad(f1, (0, 0, pad, pad, pad, pad)).reshape(b, -1, c)
    cols = torch.arange(k)
    bidx = torch.arange(b)[:, None, None]
    rows = [torch.matmul(f1p[bidx, start + i * wp + cols], f0.reshape(b, h * w, c, 1))[..., 0]
            for i in range(k)]
    return torch.stack(rows, dim=2)


def _phases(flow, r):
    b, h, w, _ = flow.shape
    _, _, wx, wy, _ = lc.window_starts(flow, r)
    return wx.reshape(b, h * w, 1, 1), wy.reshape(b, h * w, 1, 1)


@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_window_of_2r_plus_2_taps_is_enough(rng, r):
    """With the dots cut to (2r+2)^2 the output is bit-equal to the (2r+3)^2
    one, and to the plain version: the epilogue never reads the last row
    and column of dots."""
    f0, f1, flow = (torch.from_numpy(a) for a in _inputs(rng, 16, "mixed"))
    b, h, w, c = f0.shape
    dots = _dots(f0, f1, flow, r, 2 * r + 3)
    wx, wy = _phases(flow, r)
    full = lc._bilinear_epilogue(dots, wx, wy, r, c)
    cut = lc._bilinear_epilogue(dots[..., : 2 * r + 2, : 2 * r + 2], wx, wy, r, c)
    assert torch.equal(full, cut)
    poisoned = dots.clone()
    poisoned[..., 2 * r + 2, :] = float("nan")
    poisoned[..., :, 2 * r + 2] = float("nan")
    assert torch.equal(lc._bilinear_epilogue(poisoned, wx, wy, r, c), full)
    plain = lc.local_correlation_with_flow_plain(f0, f1, flow, r)
    assert torch.equal(cut.reshape(plain.shape), plain)


@pytest.mark.parametrize("r", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("c", [4, 16, 128, 256])
def test_launch_plan_fits_the_card(r, c):
    """The plan fits 227 KB a block and two blocks an SM (233,472 bytes,
    1 KB reserved a block, the kernel's static arrays) for every C the
    wrapper takes, and a stage can hold the tile's dots at the end."""
    plan = lc.launch_plan(c, r)
    assert plan.smem + lc.KERNEL_STATIC <= 227 * 1024
    assert 2 * (plan.smem + lc.KERNEL_STATIC + lc.BLOCK_RESERVED) <= lc.SM_SMEM
    assert plan.smem == plan.stages * (plan.budget + lc.MAX_TILE_PX) * plan.slice * 4
    npx = plan.tile_h * plan.tile_w
    assert npx % 32 == 0 and npx <= lc.MAX_TILE_PX
    assert plan.threads == npx * (r + 1) and plan.threads % 32 == 0
    assert plan.budget * plan.slice >= npx * (2 * r + 2) ** 2
    # A smooth flow's 8 x 8 tile (a 17 x 17 box at r = 4) fits with room.
    assert (plan.tile_h + 2 * r + 1) * (plan.tile_w + 2 * r + 1) <= plan.budget
    with pytest.raises(ValueError):
        lc.launch_plan(c + 2, r)
    with pytest.raises(ValueError):
        lc.launch_plan(c, lc.MAX_RADIUS + 1)


def _flow(rng, kind, b, h, w):
    """smooth: a slowly varying field that moves every window far inside
    the image; mixed: sub-pixel, zero and far-out displacements per pixel;
    clamped: every window pushed past the image's edges; step: smooth on
    the left half, mixed on the right."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    smooth = np.stack([3.5 + 0.3 * np.sin(yy / 5.0) - 0.05 * xx,
                       -2.25 + 0.2 * np.cos(xx / 7.0)], -1)[None].repeat(b, 0)
    frac = rng.normal(size=(b, h, w, 2)) * 3.0
    far = np.sign(rng.normal(size=(b, h, w, 2))) * rng.uniform(60, 560, (b, h, w, 2))
    kind_px = rng.integers(0, 3, (b, h, w, 1))
    mixed = np.where(kind_px == 0, frac, np.where(kind_px == 1, 0.0, far))
    flows = {"smooth": smooth, "mixed": mixed,
             "clamped": np.sign(rng.normal(size=(b, h, w, 2))) * 1e4,
             "step": np.where(xx[None, ..., None] < w // 2, smooth, mixed)}
    return torch.from_numpy(flows[kind].astype(np.float32))


def _staged_emulation(f0, f1, flow, r, plan):
    """The staged route's index arithmetic on every tile, whatever its
    route: the box from tile_boxes, f1's box filled with zeros outside the
    image, a tap (i, j) of pixel p read at box[sy_p - y0 + i][sx_p - x0 +
    j], the (2r+2)^2 dots, then the epilogue; pixels whose window misses
    the image give zeros. Also returns how many tiles the kernel stages."""
    b, h, w, c = f0.shape
    k, m = 2 * r + 2, 2 * r + 1
    sx, sy, wx, wy, live = lc.window_starts(flow, r)
    boxes = lc.tile_boxes(flow, r, plan)
    out = torch.zeros(b, h, w, m * m)
    for bi in range(b):
        for ty in range(boxes["x0"].shape[1]):
            for tx in range(boxes["x0"].shape[2]):
                x0, y0 = int(boxes["x0"][bi, ty, tx]), int(boxes["y0"][bi, ty, tx])
                bw, bh = int(boxes["w"][bi, ty, tx]), int(boxes["h"][bi, ty, tx])
                box = torch.zeros(bh, bw, c)
                ys, xs = range(max(0, y0), min(h, y0 + bh)), range(max(0, x0), min(w, x0 + bw))
                if len(ys) and len(xs):
                    box[ys.start - y0:ys.stop - y0, xs.start - x0:xs.stop - x0] = \
                        f1[bi, ys.start:ys.stop, xs.start:xs.stop]
                for y in range(ty * plan.tile_h, min(h, (ty + 1) * plan.tile_h)):
                    for x in range(tx * plan.tile_w, min(w, (tx + 1) * plan.tile_w)):
                        if not live[bi, y, x]:
                            continue
                        oy, ox = int(sy[bi, y, x]) - y0, int(sx[bi, y, x]) - x0
                        assert 0 <= oy and oy + k <= bh and 0 <= ox and ox + k <= bw
                        dots = box[oy:oy + k, ox:ox + k] @ f0[bi, y, x]
                        out[bi, y, x] = lc._bilinear_epilogue(
                            dots.reshape(1, 1, k, k), wx[bi, y, x], wy[bi, y, x], r, c
                        ).reshape(-1)
    return out, int(boxes["staged"].sum())


@pytest.mark.parametrize("kind", ["smooth", "mixed", "clamped", "step"])
@pytest.mark.parametrize("r", [1, 4])
def test_staged_route_emulation_matches_plain(rng, r, kind):
    """13 x 21 (ragged tiles at the bottom and right) in two frames; the
    smooth flow stages every tile, the mixed flow not all at r = 4 (the
    image is small enough for some of its boxes to fit), the clamped flow
    stages its empty boxes (no live pixel), the step both routes."""
    b, h, w, c = 2, 13, 21, 16
    f0 = torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(np.float32))
    f1 = torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(np.float32))
    flow = _flow(rng, kind, b, h, w)
    plan = lc.launch_plan(c, r)
    got, staged = _staged_emulation(f0, f1, flow, r, plan)
    want = lc.local_correlation_with_flow_plain(f0, f1, flow, r)
    _check(got.numpy(), want.numpy())
    n_tiles = b * 2 * 3
    expect = {"smooth": n_tiles, "clamped": n_tiles}
    if kind in expect:
        assert staged == expect[kind]
    elif kind in ("mixed", "step") and r == 4:
        assert 0 < staged < n_tiles
    if kind == "clamped":
        assert not lc.window_starts(flow, r)[4].any() and not want.abs().max()


def test_tile_boxes_hold_every_live_window(rng):
    """Every live pixel's window lies inside its tile's box, and the box is
    the tightest one: its edges touch a window."""
    flow = _flow(rng, "step", 1, 19, 30)
    r, k = 4, 10
    plan = lc.launch_plan(16, r)
    sx, sy, _, _, live = lc.window_starts(flow, r)
    boxes = lc.tile_boxes(flow, r, plan)
    for ty in range(boxes["x0"].shape[1]):
        for tx in range(boxes["x0"].shape[2]):
            rows = slice(ty * plan.tile_h, (ty + 1) * plan.tile_h)
            cols = slice(tx * plan.tile_w, (tx + 1) * plan.tile_w)
            lv = live[0, rows, cols]
            x0, y0 = int(boxes["x0"][0, ty, tx]), int(boxes["y0"][0, ty, tx])
            bw, bh = int(boxes["w"][0, ty, tx]), int(boxes["h"][0, ty, tx])
            if not lv.any():
                assert bw == bh == 0 and bool(boxes["staged"][0, ty, tx])
                continue
            xs, ys = sx[0, rows, cols][lv], sy[0, rows, cols][lv]
            assert int(xs.min()) == x0 and int(xs.max()) + k == x0 + bw
            assert int(ys.min()) == y0 and int(ys.max()) + k == y0 + bh
            assert bool(boxes["staged"][0, ty, tx]) == (bw * bh <= plan.budget)
