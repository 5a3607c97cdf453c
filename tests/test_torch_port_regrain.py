"""Port parity for automated colour grading's regrain solver: the shifts,
the loop invariants, kernel B4's plain version (ops/regrain_stencil.py),
the pyramid, grading end to end and its batched chunk form.

JAX runs on the CPU. Tolerances, each with its reason:
  * shifts: exact (data movement);
  * the invariants: rtol 1e-5, atol 1e-6 — the same f32 formulae; XLA:CPU
    may contract a multiply-add into an FMA where torch rounds twice;
  * B4's plain version against JAX's ``_solve`` and against
    ``regrain_sweeps_pallas(..., interpret=True)``: rtol 2e-5, atol 2e-6,
    the JAX test's own line for the kernel against the fori_loop
    (tests/test_methods.py), here for a few ulps per sweep on values ~1;
  * ``_regrain`` over a 3-level pyramid: atol 1e-5 (the same sweeps through
    two resizes per level);
  * grading end to end: IDT's lines (test_torch_port_idt.py: max 6.8e-3,
    mean 1e-4; the regrain smooths, it does not amplify), and _regrain on
    JAX's own IDT output at atol 1e-5;
  * the batched chunk form against the per-image form: atol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from color_transfer_tpu.methods import iterative as jit_
from color_transfer_tpu.ops.regrain_stencil import regrain_sweeps_pallas
from color_transfer_tpu_torch.methods import iterative as it
from color_transfer_tpu_torch.ops import regrain_stencil as rs

SWEEP_RTOL, SWEEP_ATOL = 2e-5, 2e-6
IDT_MAX, IDT_MEAN = 3**0.5 / 255, 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _images(rng, *shape):
    return [rng.uniform(0, 1, shape).astype(np.float32) for _ in range(3)]


def test_shifts_match_jax(rng):
    x = rng.uniform(0, 1, (5, 7, 3)).astype(np.float32)
    for name in ("down", "right", "up", "left"):
        want = np.asarray(getattr(jit_, f"_shift_{name}")(jnp.asarray(x)))
        got = getattr(rs, f"shift_{name}")(_t(x))
        np.testing.assert_array_equal(got.numpy(), want)
    # The JAX package's naming: "left" reads x+1, "up" reads y+1.
    assert rs.shift_left(_t(x))[2, 3, 0] == x[2, 4, 0]
    assert rs.shift_up(_t(x))[2, 3, 0] == x[3, 3, 0]


@pytest.mark.parametrize("level", [0, 3])
def test_solve_invariants_match_jax(rng, level):
    img_in, img_col, _ = _images(rng, 13, 22, 3)
    want = jit_._solve_invariants(jnp.asarray(img_in), jnp.asarray(img_col), level)
    got = it._solve_invariants(_t(img_in), _t(img_col), level)
    for w, g in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(list(got)),
                    strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def _invariants(img_in, img_col, level):
    const, phis, invd = jit_._solve_invariants(jnp.asarray(img_in), jnp.asarray(img_col), level)
    phis = np.stack([np.asarray(p[..., 0]) for p in phis])
    return np.asarray(const), phis, np.asarray(invd[..., 0])


@pytest.mark.parametrize("hw,nbit,level", [((13, 22), 7, 1), ((34, 60), 64, 5),
                                           ((1, 5), 3, 0)])
def test_sweeps_plain_matches_jax(rng, hw, nbit, level):
    """JAX's odd 13 x 22 case, the smallest 1080p level with its 64 sweeps,
    and a one-row image (every vertical neighbour is the pixel itself)."""
    img_in, img_col, img_out = _images(rng, *hw, 3)
    want = np.asarray(jit_._solve(jnp.asarray(img_out), jnp.asarray(img_in),
                                  jnp.asarray(img_col), nbit, level))
    const, phis, invd = _invariants(img_in, img_col, level)
    got = rs.regrain_sweeps_plain(_t(img_out), _t(const), _t(phis), _t(invd), nbit, rho=0.2)
    np.testing.assert_allclose(got.numpy(), want, rtol=SWEEP_RTOL, atol=SWEEP_ATOL)
    pallas = np.asarray(regrain_sweeps_pallas(
        jnp.asarray(img_out), jnp.asarray(const), jnp.asarray(phis), jnp.asarray(invd),
        nbit, rho=0.2, interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=SWEEP_RTOL, atol=SWEEP_ATOL)
    # The CPU route is the plain version, also through the port's _solve.
    routed = rs.regrain_sweeps(_t(img_out)[None], _t(const)[None], _t(phis)[None],
                               _t(invd)[None], nbit)
    torch.testing.assert_close(routed[0], got, atol=0, rtol=0)
    solved = it._solve(_t(img_out), _t(img_in), _t(img_col), nbit, level)
    np.testing.assert_allclose(solved.numpy(), want, rtol=SWEEP_RTOL, atol=SWEEP_ATOL)


def test_sweeps_check_kernel_inputs():
    out = torch.zeros(2, 5, 6, 3)
    args = (torch.zeros(2, 5, 6, 3), torch.zeros(2, 4, 5, 6), torch.zeros(2, 5, 6))
    rs.check_kernel_inputs(out, *args)
    with pytest.raises(ValueError):
        rs.check_kernel_inputs(out, args[0], torch.zeros(2, 4, 6, 5), args[2])
    with pytest.raises(ValueError):
        rs.check_kernel_inputs(out.double(), *args)
    with pytest.raises(ValueError):
        rs.check_kernel_inputs(out, args[0], args[1], torch.zeros(2, 6, 5).transpose(1, 2))
    with pytest.raises(ValueError):
        rs.regrain_sweeps(out, *args, nbit=0)
    many = torch.zeros(2**16, 1, 1, 3)  # past the launch grid's frames
    with pytest.raises(ValueError):
        rs.check_kernel_inputs(many, many, torch.zeros(2**16, 4, 1, 1), torch.zeros(2**16, 1, 1))


def test_regrain_pyramid_matches_jax(rng):
    """96 x 128: levels 96x128, 48x64, 24x32 (12 x 16 stops the recursion)."""
    img_in, img_col, _ = _images(rng, 96, 128, 3)
    img_col = (0.5 * img_col + 0.5 * img_in).astype(np.float32)
    want = np.asarray(jax.jit(jit_._regrain)(jnp.asarray(img_in), jnp.asarray(img_col)))
    got = it._regrain(_t(img_in), _t(img_col))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_grading_matches_jax(rng):
    t = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
    r = np.clip(rng.normal(0.45, 0.2, (40, 56, 3)), 0, 1).astype(np.float32)
    rot = np.asarray(jit_.random_rotations(jax.random.PRNGKey(42), 4))
    want = np.asarray(jit_.automated_color_grading(jnp.asarray(t), jnp.asarray(r)))
    got = it.automated_color_grading(_t(t), _t(r), rotations=rot).numpy()
    assert got.shape == t.shape
    d = np.abs(got - want)
    assert d.max() <= IDT_MAX and d.mean() <= IDT_MEAN, (d.max(), d.mean())
    graded = jit_.iterative_distribution_transfer(jnp.asarray(t), jnp.asarray(r))
    on_jax_idt = it._regrain(_t(t), _t(np.asarray(graded)))
    np.testing.assert_allclose(on_jax_idt.numpy(), want, atol=1e-5, rtol=0)


def test_grading_batched_equals_per_frame(rng):
    t = rng.uniform(0, 1, (2, 44, 50, 3)).astype(np.float32)
    r = rng.uniform(0.2, 0.9, (2, 44, 50, 3)).astype(np.float32)
    gen = torch.Generator().manual_seed(3)
    rot = it.random_rotations(gen, 4)
    chunk = it.automated_color_grading.batched(_t(t), _t(r), rotations=rot)
    for i in range(2):
        want = it.automated_color_grading(_t(t[i]), _t(r[i]), rotations=rot)
        torch.testing.assert_close(chunk[i], want, atol=1e-6, rtol=0)


# --- B4's launch plan and pass schedule, checked on the CPU ------------------
# The CUDA kernel runs a level's sweeps in shared memory: trapezoid passes of
# s sweeps over tiles with an s-pixel halo (large levels) or a cluster of
# blocks holding a frame's level for all its sweeps (small levels). Its
# arithmetic runs only on the card; the schedule is emulated here from the
# plan and held bit-equal to the plain version.

LEVELS_1080P = ((1080, 1920, 4), (540, 960, 16), (270, 480, 32), (135, 240, 64),
                (68, 120, 64), (34, 60, 64))


@pytest.mark.parametrize("h,w,nbit", LEVELS_1080P)
def test_launch_plan_at_the_1080p_levels(h, w, nbit):
    """The three large levels take trapezoid passes (level 0: its 4 sweeps
    in one pass), the three small ones a cluster of at most 8 blocks that
    holds the frame for all 64 sweeps; every block inside the card's
    limits."""
    plan = rs.launch_plan(h, w, nbit)
    assert plan.threads <= rs.MAX_THREADS[plan.strip - 1]
    assert plan.smem <= rs.SMEM_LIMIT
    if h * w > 100_000:
        assert plan.route == "trapezoid" and plan.cluster == 1
        assert plan.passes == -(-nbit // plan.sweeps) and plan.sweeps > 1
        rh, rw = plan.tile_h + 2 * plan.sweeps, plan.tile_w + 2 * plan.sweeps
        groups = -(-rw // rs.VX)  # a thread owns four columns
        assert plan.smem == 2 * 3 * rh * groups * rs.VX * 4 <= rs.TRAPEZOID_SMEM
        assert -(-rh // plan.strip) * groups <= plan.threads
        assert plan.threads <= rs.MAX_THREADS[plan.strip - 1] // 2
        assert plan.strip <= rs.TRAPEZOID_MAX_STRIP
        if nbit == 4:
            assert (plan.sweeps, plan.passes) == (4, 1)
    else:
        assert plan.route == "cluster" and plan.passes == 1 and plan.sweeps == nbit
        assert 1 <= plan.cluster <= rs.MAX_CLUSTER
        assert (plan.cluster - 1) * plan.tile_h < h <= plan.cluster * plan.tile_h
        assert plan.tile_w == w and plan.smem == 2 * 3 * plan.tile_h * -(-w // rs.VX) * rs.VX * 4
        assert -(-plan.tile_h // plan.strip) * -(-w // rs.VX) <= plan.threads


def _emulate(img_out, const, phis, inv_den, nbit, plan, rho=0.2):
    """The kernel's schedule in torch. Trapezoid: each pass of s sweeps
    computes every tile from its region (the tile and an s-pixel halo,
    clipped to the image) alone, edges replicated at the region's border:
    right at the image border, wrong at a halo's, whose error moves one
    pixel in a sweep and stops s pixels out, short of the tile. Cluster:
    each sweep computes every band from the band and its neighbours' edge
    rows."""
    h, w = img_out.shape[-3], img_out.shape[-2]

    def sweep(region, ys, xs, n):
        return rs.regrain_sweeps_plain(region, const[..., ys, xs, :], phis[..., ys, xs],
                                       inv_den[..., ys, xs], n, rho)

    out = img_out
    if plan.route == "cluster":
        for _ in range(nbit):
            new = torch.empty_like(out)
            for r0 in range(0, h, plan.tile_h):
                r1 = min(h, r0 + plan.tile_h)
                ys = slice(max(0, r0 - 1), min(h, r1 + 1))
                res = sweep(out[..., ys, :, :], ys, slice(None), 1)
                new[..., r0:r1, :, :] = res[..., r0 - ys.start:r1 - ys.start, :, :]
            out = new
        return out
    for done in range(0, nbit, plan.sweeps):
        s = min(plan.sweeps, nbit - done)
        new = torch.empty_like(out)
        for y0 in range(0, h, plan.tile_h):
            for x0 in range(0, w, plan.tile_w):
                y1, x1 = min(h, y0 + plan.tile_h), min(w, x0 + plan.tile_w)
                ys = slice(max(0, y0 - s), min(h, y1 + s))
                xs = slice(max(0, x0 - s), min(w, x1 + s))
                res = sweep(out[..., ys, xs, :], ys, xs, s)
                new[..., y0:y1, x0:x1, :] = res[..., y0 - ys.start:y1 - ys.start,
                                               x0 - xs.start:x1 - xs.start, :]
        out = new
    return out


def _plan(route, sweeps, tile_h, tile_w, nbit, h):
    passes = -(-nbit // sweeps)
    cluster = -(-h // tile_h) if route == "cluster" else 1
    return rs.LevelPlan(route, sweeps, passes, tile_h, tile_w, 1, 1, 0, cluster)


@pytest.mark.parametrize("h,w,nbit,route,sweeps,tile", [
    ((13, 22, 7, "trapezoid", 3, (4, 5))),     # odd sizes, ragged tiles, a short last pass
    ((13, 22, 7, "trapezoid", 7, (5, 8))),     # halos wider than tiles
    ((1, 9, 5, "trapezoid", 2, (1, 4))),       # one row: every vertical neighbour is itself
    ((6, 1, 4, "trapezoid", 4, (2, 1))),       # one column
    ((9, 10, 6, "trapezoid", 6, (9, 10))),     # one tile, the whole image
    ((13, 22, 7, "cluster", 7, (2, 22))),      # seven bands
    ((34, 60, 64, "cluster", 64, (5, 60))),    # the smallest 1080p level's plan
    ((1, 5, 3, "cluster", 3, (1, 5))),         # one row, one block
])
def test_pass_schedule_matches_plain_bit_equal(rng, h, w, nbit, route, sweeps, tile):
    img_in, img_col, img_out = _images(rng, 2, h, w, 3)
    const, phis, invd = (torch.from_numpy(np.ascontiguousarray(x)) for x in
                         _batched_invariants(img_in, img_col, 1))
    plan = _plan(route, sweeps, *tile, nbit, h)
    want = rs.regrain_sweeps_plain(_t(img_out), const, phis, invd, nbit, rho=0.2)
    got = _emulate(_t(img_out), const, phis, invd, nbit, plan)
    assert torch.equal(got, want)


@pytest.mark.parametrize("h,w,nbit", [(37, 50, 5), (40, 33, 16), (21, 90, 32)])
def test_launch_plans_schedule_matches_plain_bit_equal(rng, h, w, nbit, monkeypatch):
    """The plan's own choice at small shapes, on both routes: the cluster
    route it picks, and the trapezoid route it picks when a cluster cannot
    hold the level (here: shared memory cut to force it)."""
    img_in, img_col, img_out = _images(rng, 1, h, w, 3)
    const, phis, invd = (torch.from_numpy(np.ascontiguousarray(x)) for x in
                         _batched_invariants(img_in, img_col, 2))
    want = rs.regrain_sweeps_plain(_t(img_out), const, phis, invd, nbit, rho=0.2)
    plans = [rs.launch_plan(h, w, nbit)]
    rs.launch_plan.cache_clear()
    monkeypatch.setattr(rs, "SMEM_LIMIT", 1024)
    plans.append(rs.launch_plan(h, w, nbit))
    rs.launch_plan.cache_clear()
    assert [p.route for p in plans] == ["cluster", "trapezoid"]
    for plan in plans:
        assert torch.equal(_emulate(_t(img_out), const, phis, invd, nbit, plan), want)


def _batched_invariants(img_in, img_col, level):
    out = [it._solve_invariants(_t(a), _t(c), level) for a, c in zip(img_in, img_col)]
    const = torch.stack([o[0] for o in out]).numpy()
    phis = torch.stack([torch.stack([p[..., 0] for p in o[1]]) for o in out]).numpy()
    invd = torch.stack([o[2][..., 0] for o in out]).numpy()
    return const, phis, invd
