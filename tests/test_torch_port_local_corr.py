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
    before = lc.local_correlation_with_flow.launches
    got = lc.local_correlation_with_flow(f0, f1, flow, 4)
    assert lc.local_correlation_with_flow.launches == before == 0
    torch.testing.assert_close(
        got, lc.local_correlation_with_flow_plain(f0, f1, flow, 4), rtol=0, atol=0
    )


@pytest.mark.parametrize("bad", ["dtype", "channels", "noncontiguous", "misaligned",
                                 "flow_shape", "radius"])
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
    else:
        r = 40
    with pytest.raises(ValueError):
        lc.check_kernel_inputs(f0, f1, flow, r)
