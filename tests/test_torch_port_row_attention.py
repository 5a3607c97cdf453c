"""Port parity: the row-wise parallax attention's plain torch version
(color_transfer_tpu_torch/ops/row_attention.py) against the JAX package's
Pallas kernel run in interpret mode.

Lines:
  * precise (f32 operands): atol 2e-5 on out and colsum, the line of JAX's
    own kernel test; the valid masks equal;
  * bf16 operands: atol 1e-3 on out (att is rounded to bf16 before att.v on
    both sides; a different f32 sum order can flip one rounding, and one
    bf16 ulp of an att entry below 1 is at most 2^-9 times a |v| of about
    3), atol 2e-5 on colsum (f32 att on both sides).
The CUDA kernel itself needs the card: tests/test_torch_port_kernels_cuda.py
and chip_smoke.py hold it against this plain version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from color_transfer_tpu.ops.row_attention import (
    fused_parallax_inference as jax_fused,
    row_attention_warp as jax_row_attention,
)
from color_transfer_tpu_torch.ops import row_attention as ra

OUT_ATOL = {True: 2e-5, False: 1e-3}
CS_ATOL = 2e-5


def _inputs(rng, shape, n=3):
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("precise", [True, False])
@pytest.mark.parametrize("shape,tq", [
    ((2, 3, 96, 16), 32),   # W a multiple of the JAX tile
    ((1, 2, 50, 8), 16),    # W = 50: a multiple of no tile, padded in JAX
    ((1, 3, 37, 16), 64),   # W below the JAX tile
])
def test_plain_matches_jax(rng, precise, shape, tq):
    q, k, v = _inputs(rng, shape)
    scale = 1.0 / shape[-1]
    want_out, want_cs = jax_row_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, tq=tq,
        interpret=True, precise=precise,
    )
    out, cs = ra.row_attention_warp(*map(torch.from_numpy, (q, k, v)), scale, precise)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=OUT_ATOL[precise])
    np.testing.assert_allclose(cs.numpy(), np.asarray(want_cs), atol=CS_ATOL)
    _, cs_only = ra.row_attention_warp(torch.from_numpy(q), torch.from_numpy(k),
                                       None, scale, precise)
    assert torch.equal(cs_only, cs)


@pytest.mark.parametrize("precise", [True, False])
def test_fused_parallax_inference_matches_jax(rng, precise):
    shape = (1, 4, 70, 8)
    arrays = _inputs(rng, shape, n=5)
    scale = 1.0 / shape[-1]
    want_warp, want_mask = jax_fused(*map(jnp.asarray, arrays), scale,
                                     interpret=True, precise=precise)
    warped, mask = ra.fused_parallax_inference(*map(torch.from_numpy, arrays),
                                               scale, precise)
    np.testing.assert_allclose(warped.numpy(), np.asarray(want_warp),
                               atol=OUT_ATOL[precise])
    assert mask.dtype == torch.bool and mask.shape == (*shape[:3], 1)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))


def test_plain_bands_match_one_band(rng, monkeypatch):
    """The plain version's row bands do not change the result."""
    q, k, v = map(torch.from_numpy, _inputs(rng, (2, 5, 24, 16)))
    whole = ra.row_attention_warp_plain(q, k, v, 0.0625, True)
    monkeypatch.setattr(ra, "_PLAIN_BAND", 2 * 24 * 24)  # one row per band
    banded = ra.row_attention_warp_plain(q, k, v, 0.0625, True)
    for a, b in zip(whole, banded):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("case", ["channels", "k_shape", "v_shape", "rank", "width",
                                  "integer"])
def test_kernel_input_checks(case):
    q = k = v = torch.zeros(1, 2, 8, 16)
    if case == "channels":
        q = k = v = torch.zeros(1, 2, 8, 12)
    elif case == "k_shape":
        k = torch.zeros(1, 2, 9, 16)
    elif case == "v_shape":
        v = torch.zeros(1, 2, 8, 32)
    elif case == "rank":
        q = k = v = torch.zeros(2, 8, 16)
    elif case == "integer":
        k = torch.zeros(1, 2, 8, 16, dtype=torch.int64)
    else:
        q = k = v = torch.zeros(1, 1, ra._MAX_W + 1, 16)
    with pytest.raises(ValueError):
        ra.check_kernel_inputs(q, k, v)
    ra.check_kernel_inputs(torch.zeros(1, 2, 8, 16), torch.zeros(1, 2, 8, 16), None)
