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
