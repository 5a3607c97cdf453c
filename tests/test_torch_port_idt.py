"""Port parity for Iterative Distribution Transfer: histograms, the small
interp, kernel B3's plain version (ops/idt_apply.py), the rotations, IDT
end to end and its batched chunk form.

JAX runs on the CPU; its rotations (``random_rotations(PRNGKey(k), n)``)
are handed to the port as numpy arrays. Tolerances, each with its reason:
  * histograms, searchsorted interp: exact (integer counts; the same f32
    operations in the same order);
  * B3's plain version against JAX's ``_interp_uniform_tables``: atol 1e-4
    in bin units (values up to 255, where one f32 ulp is 1.5e-5) — the same
    formula with a gather in place of the one-hot matmul;
  * against ``_apply_tables_pallas(..., interpret=True)``: atol 2e-3, the
    JAX test's bound for its hi/lo bf16 table split (tests/test_methods.py);
  * one IDT step (``_histogram_transfer_axes``) on JAX's projections:
    atol 1e-4 in projection units (values ~1) — XLA:CPU contracts
    multiply-adds into FMAs where torch rounds twice (the bin edges
    lo + step * k differ by one ulp in ~30% of entries), which moves a
    transported value by far less than this;
  * IDT end to end: max|d| <= 6.8e-3 and mean|d| <= 1e-4 on images in
    [0, 1]. The iteration is chaotic under rounding: after a step differs
    by ulps, a sample within an ulp of a bin edge falls into the next bin,
    which moves its CDF by 1/N and one table entry by up to one bin's
    width (at most sqrt(3) / 255 = 6.8e-3 for projections of [0, 1]^3).
    The mean bounds how many samples that may touch; each step is held
    tightly by the test above;
  * the batched chunk form against the per-image form: atol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from color_transfer_tpu.methods import iterative as jit_
from color_transfer_tpu_torch.methods import iterative as it
from color_transfer_tpu_torch.ops import idt_apply

STEP_ATOL = 1e-4
IDT_MAX, IDT_MEAN = 3**0.5 / 255, 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _rotations(seed, n_iter=4):
    return np.asarray(jit_.random_rotations(jax.random.PRNGKey(seed), n_iter))


def _pair(rng, t_hw=(24, 32), r_hw=(20, 30)):
    t = rng.uniform(0, 1, (*t_hw, 3)).astype(np.float32)
    t[..., 1] = 0.5 * t[..., 1] + 0.3 * t[..., 0]  # correlated channels
    r = np.clip(rng.normal(0.5, 0.2, (*r_hw, 3)), 0, 1).astype(np.float32)
    return t, r


def test_uniform_histograms(rng):
    bins = 255
    scaled = rng.uniform(-3, bins + 3, (3, 5000)).astype(np.float32)
    scaled[:, :4] = [0.0, bins - 1e-3, bins, -1e-4]  # edges and clipped samples
    want = np.asarray(jit_._uniform_histograms(jnp.asarray(scaled), bins))
    got = it._uniform_histograms(_t(scaled), bins)
    assert got.dtype == torch.float32 and got.shape == (3, bins)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum(-1).tolist() == [5000.0] * 3
    batched = it._uniform_histograms(_t(np.stack([scaled, scaled[::-1]])), bins)
    np.testing.assert_array_equal(batched[0].numpy(), want)


def test_interp_small(rng):
    xp = np.cumsum(rng.integers(0, 3, (3, 255)), axis=1).astype(np.float32)  # ties
    xp /= xp[:, -1:]
    x = np.cumsum(rng.uniform(0, 1, (3, 255)), axis=1).astype(np.float32)
    x /= x[:, -1:]
    x[:, 0] = -0.1
    fp = np.sort(rng.uniform(0, 1, (3, 255)), axis=1).astype(np.float32)
    want = np.stack([np.asarray(jit_._interp_small(jnp.asarray(x[a]), jnp.asarray(xp[a]),
                                                   jnp.asarray(fp[a]))) for a in range(3)])
    got = it._interp_small(_t(x), _t(xp), _t(fp))
    np.testing.assert_array_equal(got.numpy(), want)


def _tables(rng, rows=3, bins=255):
    fp = np.sort(rng.uniform(0, bins, (rows, bins)), axis=1).astype(np.float32)
    grid_lo = rng.uniform(-0.5, 0.2, rows).astype(np.float32)
    step = rng.uniform(0.004, 0.008, rows).astype(np.float32)
    right_edge = (grid_lo + step * (bins - 1)).astype(np.float32)
    return grid_lo, step, fp, right_edge


@pytest.mark.parametrize("bins", [255, 64, 256])
def test_transport_apply_plain_matches_interp_uniform_tables(rng, bins):
    grid_lo, step, fp, right_edge = _tables(rng, bins=bins)
    lo_edge = grid_lo.min() - 0.2
    x = rng.uniform(lo_edge, (right_edge + 0.2).max(), (3, 4099)).astype(np.float32)
    x[:, 0], x[:, 1] = grid_lo, right_edge  # exactly on both edges
    want = np.asarray(jit_._interp_uniform_tables(
        jnp.asarray(x), jnp.asarray(grid_lo), jnp.asarray(step), jnp.asarray(fp),
        left=0.0, right=float(bins), right_edge=jnp.asarray(right_edge)))
    got = idt_apply.transport_apply_plain(_t(x), _t(grid_lo), _t(step), _t(fp),
                                          _t(right_edge))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    # The CPU route is the plain version; a leading frame axis changes nothing.
    routed = idt_apply.transport_apply(_t(x)[None], _t(grid_lo)[None], _t(step)[None],
                                       _t(fp)[None], _t(right_edge)[None])
    torch.testing.assert_close(routed[0], got, atol=0, rtol=0)


def test_transport_apply_plain_matches_pallas_interpret(rng):
    grid_lo, step, fp, right_edge = _tables(rng)
    x = rng.uniform(-0.5, 1.5, (3, 4096)).astype(np.float32)
    want = np.asarray(jit_._apply_tables_pallas(
        jnp.asarray(x), jnp.asarray(grid_lo), jnp.asarray(step), jnp.asarray(fp),
        jnp.asarray(right_edge), interpret=True))
    got = idt_apply.transport_apply_plain(_t(x), _t(grid_lo), _t(step), _t(fp),
                                          _t(right_edge))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=0)


def test_transport_apply_checks_kernel_inputs():
    x = torch.zeros(2, 3, 10)
    args = (torch.zeros(2, 3), torch.ones(2, 3), torch.zeros(2, 3, 255), torch.ones(2, 3))
    idt_apply.check_kernel_inputs(x, *args)
    with pytest.raises(ValueError):
        idt_apply.check_kernel_inputs(x, *args[:2], torch.zeros(2, 3, 257), args[3])
    with pytest.raises(ValueError):
        idt_apply.check_kernel_inputs(x.double(), *args)
    with pytest.raises(ValueError):
        idt_apply.check_kernel_inputs(x.transpose(1, 2), *args)
    with pytest.raises(ValueError):
        idt_apply.check_kernel_inputs(x, args[0][:1], *args[1:])


@pytest.mark.parametrize("seed", [0, 7])
def test_random_rotations_are_special_orthogonal(seed):
    rot = it.random_rotations(torch.Generator().manual_seed(seed), 16)
    assert rot.shape == (16, 3, 3) and rot.dtype == torch.float32
    eye = torch.eye(3).expand(16, 3, 3)
    torch.testing.assert_close(rot @ rot.transpose(1, 2), eye, atol=1e-6, rtol=0)
    torch.testing.assert_close(torch.linalg.det(rot), torch.ones(16), atol=1e-6, rtol=0)
    again = it.random_rotations(torch.Generator().manual_seed(seed), 16)
    assert torch.equal(rot, again)
    with pytest.raises(ValueError):
        it.random_rotations(torch.Generator(), 2, dim=4)


def test_jax_rotations_are_special_orthogonal():
    rot = _rotations(3, 8)
    np.testing.assert_allclose(rot @ rot.transpose(0, 2, 1), np.broadcast_to(np.eye(3), rot.shape),
                               atol=1e-6)
    np.testing.assert_allclose(np.linalg.det(rot), 1.0, atol=1e-6)


@pytest.mark.parametrize("bins", [255, 64])
def test_idt_step_matches_jax(rng, bins):
    """Every iteration's histogram transfer, fed JAX's projections of
    JAX's iterate (target and reference of different pixel counts)."""
    t, r = _pair(rng)
    t, r = t.reshape(-1, 3), r.reshape(-1, 3)
    step = jax.jit(jit_._histogram_transfer_axes, static_argnums=2)
    for rot in _rotations(42):
        d0, d1 = rot @ t.T, rot @ r.T
        d = np.asarray(step(jnp.asarray(d0), jnp.asarray(d1), bins))
        got = it._histogram_transfer_axes(_t(d0)[None], _t(d1)[None], bins)[0]
        np.testing.assert_allclose(got.numpy(), d, atol=STEP_ATOL, rtol=0)
        t = (rot.T @ (d - d0)).T + t


def _assert_idt_close(got, want):
    d = np.abs(got - want)
    assert d.max() <= IDT_MAX and d.mean() <= IDT_MEAN, (d.max(), d.mean())


@pytest.mark.parametrize("seed,n_iter,bins", [(42, 4, 255), (1, 3, 255), (5, 2, 64)])
def test_idt_matches_jax(rng, seed, n_iter, bins):
    """Target and reference of different pixel counts, JAX's rotations."""
    t, r = _pair(rng, (64, 80), (56, 72))
    rot = _rotations(seed, n_iter)
    want = np.asarray(jit_.iterative_distribution_transfer(
        jnp.asarray(t), jnp.asarray(r), bins=bins, n_iter=n_iter,
        key=jax.random.PRNGKey(seed)))
    got = it.iterative_distribution_transfer(_t(t), _t(r), bins=bins, n_iter=n_iter,
                                             rotations=rot)
    assert got.shape == t.shape and got.dtype == torch.float32
    _assert_idt_close(got.numpy(), want)


def test_idt_default_rotations_and_errors(rng):
    t, r = _pair(rng, (8, 10), (8, 10))
    default = it.iterative_distribution_transfer(_t(t), _t(r))
    seeded = it.iterative_distribution_transfer(
        _t(t), _t(r), generator=torch.Generator().manual_seed(it.DEFAULT_SEED))
    torch.testing.assert_close(default, seeded, atol=0, rtol=0)
    with pytest.raises(ValueError, match="bins"):
        it.iterative_distribution_transfer(_t(t), _t(r), bins=257)
    with pytest.raises(ValueError, match="rotations"):
        it.iterative_distribution_transfer(_t(t), _t(r), n_iter=3, rotations=_rotations(0, 4))


def test_idt_batched_equals_per_frame(rng):
    """The (F, H, W, 3) chunk form equals the per-image form frame by frame,
    with per-frame references and with one reference for every frame."""
    t = rng.uniform(0, 1, (3, 12, 16, 3)).astype(np.float32)
    r = rng.uniform(0.2, 0.9, (3, 12, 16, 3)).astype(np.float32)
    rot = _rotations(2)
    chunk = it.iterative_distribution_transfer.batched(_t(t), _t(r), rotations=rot)
    single = it.iterative_distribution_transfer.batched(_t(t), _t(r[:1]), rotations=rot)
    for i in range(3):
        for out, ref in ((chunk, r[i]), (single, r[0])):
            want = it.iterative_distribution_transfer(_t(t[i]), _t(ref), rotations=rot)
            torch.testing.assert_close(out[i], want, atol=1e-6, rtol=0)
