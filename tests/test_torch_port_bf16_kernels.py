"""The bf16 halves of kernels B1, B2a, B2b and B2c: each plain version
(color_transfer_tpu_torch/ops/local_corr.py, ops/win_attention.py; the
CUDA kernels' statement on the CPU) against the JAX package's TPU kernel in
interpret mode on its bf16 route, on the same bf16 inputs.

Lines, in bf16 ulps of the output's magnitude (2^(floor(log2 max|ref|) - 7)):
  * B2a, B2b, B2c: both sides round at the TPU kernel's points (B2a: p to
    bf16 before P.V, the output; B2b also q, [k | v], the message, the merge
    output, LayerNorm's output and the residual sum; B2c the FFN's hidden
    values before and after the GELU, its output, LayerNorm's and the
    residual sum), and sum bf16 x bf16 products exactly in f32, in another
    order. A value within an f32 rounding of a bf16 boundary can round the
    other way: one ulp of the element, and through B2b's and B2c's chains
    a flip feeds the next rounding. B2A_ULPS = 1 (measured 0), B2B_ULPS = 1
    (measured 0.5), B2C_ULPS = 2 (measured 1);
  * B1 (f32 output): both features rounded to bf16, products exact in f32,
    f32 sums and an f32 bilinear epilogue: f32 rounding only,
    B1_ULPS = 1/64 (measured 5e-5). The JAX XLA twin's distance from the
    TPU kernel is printed beside it.
Each also holds the CPU route's dtypes: bf16 in, bf16 out (B1: f32 out).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from color_transfer_tpu.models import gmflow as jg
from color_transfer_tpu.ops import win_attention as jw
from color_transfer_tpu_torch.ops import local_corr as lc
from color_transfer_tpu_torch.ops import win_attention as tw

B1_ULPS, B2A_ULPS, B2B_ULPS, B2C_ULPS = 1 / 64, 1, 1, 2
BF = torch.bfloat16
C = 128
# (windows, L) with their swin geometry (k, hs, ws): two window rows of
# 4x6, ragged 5x7 windows, many 2x3 windows, and the card's bf16 B2a and
# B2b routes' edge cases: a ragged L of 200 (a partial 64-key tile and a
# partial 128-row block) and L = 1024 (the streamed route, K not resident)
# with few windows.
SHAPES = [((8, 24), (2, 4, 6)), ((16, 35), (2, 5, 7)), ((128, 6), (8, 2, 3)),
          ((4, 200), (2, 10, 20)), ((4, 1024), (2, 32, 32))]


def _ulps(got, want):
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert g.shape == w.shape
    scale = float(np.abs(w).max())
    return float(np.abs(g - w).max()) / 2.0 ** (math.floor(math.log2(scale)) - 7)


def _pair(a):
    """(torch bf16, jax bf16) of one f32 array."""
    return torch.from_numpy(a).to(BF), jnp.asarray(a).astype(jnp.bfloat16)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("mode", ["none", "shift", "mask"])
@pytest.mark.parametrize("shape,geom", SHAPES)
def test_b2a_bf16_matches_jax_interpret(rng, shape, geom, mode):
    (tq, jq), (tk, jk), (tv, jv) = (_pair(rng.normal(size=(*shape, C)).astype(np.float32))
                                    for _ in range(3))
    kw, hs, ws = geom
    mask = jw.shift_window_mask(kw * hs, kw * ws, kw)
    targs, jargs, kws = (tq, tk, tv), (jq, jk, jv), {}
    if mode == "shift":
        kws = {"shift_windows": geom}
    elif mode == "mask":
        targs, jargs = (*targs, torch.from_numpy(mask)), (*jargs, jnp.asarray(mask))
    got = tw.window_attention_fused(*targs, **kws)
    want = jw.window_attention_fused(*jargs, interpret=True, **kws)
    assert got.dtype == BF
    assert _ulps(got, want) <= B2A_ULPS


@pytest.mark.parametrize("self_attn", [True, False])
@pytest.mark.parametrize("shape,geom", SHAPES)
def test_b2b_bf16_matches_jax_interpret(rng, shape, geom, self_attn):
    """Self-attention with the shift and the residual (the no-FFN layer),
    cross-attention without."""
    (tx, jx), (ty, jy) = (_pair(rng.normal(size=(*shape, C)).astype(np.float32))
                          for _ in range(2))
    w = [_pair((rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32))
         for s in ((C, C), (C, 2 * C), (C, C))]
    ns = (1 + 0.1 * rng.normal(size=C)).astype(np.float32)
    nb = (0.1 * rng.normal(size=C)).astype(np.float32)
    kw = {"shift_windows": geom, "add_residual": True} if self_attn else {}
    tsrc, ttgt = (tx, tx) if self_attn else (tx, ty)
    jsrc, jtgt = (jx, jx) if self_attn else (jx, jy)
    got = tw.window_sublayer_fused(tsrc, ttgt, *(a for a, _ in w), torch.from_numpy(ns),
                                   torch.from_numpy(nb), **kw)
    want = jw.window_sublayer_fused(jsrc, jtgt, *(b for _, b in w), jnp.asarray(ns),
                                    jnp.asarray(nb), interpret=True, **kw)
    assert got.dtype == BF
    assert _ulps(got, want) <= B2B_ULPS


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("shape,geom", SHAPES)
def test_b2c_bf16_matches_jax_interpret(rng, shape, geom, residual):
    del geom
    (tx, jx), (tm, jm) = (_pair(rng.normal(size=(*shape, C)).astype(np.float32))
                          for _ in range(2))
    f = 512
    (t0, j0), (t2, j2) = (_pair((rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32))
                          for s in ((2 * C, f), (f, C)))
    ns = (1 + 0.1 * rng.normal(size=C)).astype(np.float32)
    nb = (0.1 * rng.normal(size=C)).astype(np.float32)
    got = tw.ffn_fused(tx, tm, t0, t2, torch.from_numpy(ns), torch.from_numpy(nb),
                       add_residual=residual)
    want = jw.ffn_fused(jx, jm, j0, j2, jnp.asarray(ns), jnp.asarray(nb),
                        add_residual=residual, interpret=True)
    assert got.dtype == BF
    assert _ulps(got, want) <= B2C_ULPS


def test_gelu_is_the_tpu_kernels(rng):
    """The bf16 FFN's GELU is JAX's _gelu_exact_kernel (A&S erf): equal on
    bf16 inputs, within an f32 rounding before the cast."""
    x = rng.normal(size=4096).astype(np.float32) * 3
    tx, jx = _pair(x)
    got = tw.gelu_as(tx).float().numpy()
    want = np.asarray(jw._gelu_exact_kernel(jx).astype(jnp.float32))
    assert np.abs(got - want).max() <= 2.0 ** -8 * np.abs(want).max()


@pytest.mark.parametrize("shape,r", [((2, 12, 20, 128), 4), ((1, 9, 13, 32), 4),
                                     ((1, 7, 11, 16), 1)])
def test_b1_bf16_matches_jax_mxu_interpret(rng, shape, r, capsys):
    """B1 in bf16 (``corr_dtype=torch.bfloat16``) against the TPU kernel's
    MXU variant, bf16 operands, in interpret mode
    (models/gmflow.py::_local_corr_pallas_ad(r, bfloat16, True, "mxu")),
    on a mixed flow (fractional, zero and far-outside displacements)."""
    b, h, w, c = shape
    f0, f1 = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    flow = (rng.normal(size=(b, h, w, 2)) * 3).astype(np.float32)
    flow[:, ::3] *= 40.0
    args = [jnp.asarray(a) for a in (f0, f1, flow)]
    want = jg._local_corr_pallas_ad(r, jnp.dtype(jnp.bfloat16), True, "mxu", *args)
    got = lc.local_correlation_with_flow(*(torch.from_numpy(a) for a in (f0, f1, flow)), r,
                                         corr_dtype=BF)
    twin = jg._local_correlation_with_flow_xla(*args, r, jnp.bfloat16)
    assert got.dtype == torch.float32
    err = _ulps(got, want)
    with capsys.disabled():
        print(f"\nB1 bf16 {shape} r={r}: port plain vs the MXU kernel {err:.2e} ulps; "
              f"JAX's XLA twin vs the MXU kernel "
              f"{_ulps(torch.from_numpy(np.array(twin)), want):.2e} ulps")
    assert err <= B1_ULPS
    # corr_dtype float32 is the f32 route: the features' bf16 rounding is what differs
    f32 = lc.local_correlation_with_flow(*(torch.from_numpy(a) for a in (f0, f1, flow)), r)
    assert not torch.equal(f32, got)


def test_bf16_kernel_inputs_checked():
    f = torch.zeros(1, 4, 6, 16, dtype=BF)
    flow = torch.zeros(1, 4, 6, 2)
    lc.check_kernel_inputs(f, f, flow, 4)  # bf16 features, f32 flow
    with pytest.raises(ValueError, match="multiple of 8"):
        g = torch.zeros(1, 4, 6, 12, dtype=BF)
        lc.check_kernel_inputs(g, g, flow, 4)
    with pytest.raises(ValueError):  # mixed feature dtypes
        lc.check_kernel_inputs(f, f.float(), flow, 4)
    with pytest.raises(ValueError):  # a bf16 flow
        lc.check_kernel_inputs(f, f, flow.to(BF), 4)
    with pytest.raises(ValueError, match="corr_dtype"):
        lc.local_correlation_with_flow(f, f, flow, 4, corr_dtype=torch.float16)
    assert lc.launch_plan(128, 4, 2).slice == 64 and lc.launch_plan(128, 4).slice == 32
    assert lc.launch_plan(128, 4, 2).budget == lc.launch_plan(128, 4).budget
    x = torch.zeros(2, 8, 128, dtype=BF)
    tw.check_kernel_inputs(x, [x], f32=[torch.zeros(128)])
    with pytest.raises(ValueError, match="float32"):  # bf16 LayerNorm parameters
        tw.check_kernel_inputs(x, [x], f32=[torch.zeros(128, dtype=BF)])
    with pytest.raises(ValueError):  # f32 weights with bf16 tokens
        tw.check_kernel_inputs(x, [x.float()])
    with pytest.raises(ValueError):
        tw.check_kernel_inputs(x.half(), [x.half()])


@pytest.mark.parametrize("tokens", [0, 1, 127, 128, 129, 256 * 448, 3072 * 120, 2**31 - 129])
def test_ffn_plan(tokens):
    """The bf16 B2c launch plan: 128 tokens a block (the grid rounds up),
    F in 64-column chunks through a ring of three 48 KB slots, so a block's
    shared memory is the same for every F multiple of 64 up to 2048 and
    within a block's 232,448 bytes: the 64 KB token tile, the ring, four
    8-byte barriers, three 4-byte slot counts and 1 KB for alignment. An F
    that is not a positive multiple of 64, and token counts past the
    kernel's int rows, raise."""
    for f in range(64, 2049, 64):
        plan = tw.ffn_plan(tokens, f)
        assert (plan.rows, plan.chunk, plan.slots) == (128, 64, 3)
        assert plan.smem == 65536 + 3 * 49152 + 8 * 4 + 4 * 3 + 1024 <= tw.BLOCK_SMEM_LIMIT
        assert plan.grid == -(-tokens // 128)
    for bad in (0, -64, 32, 100, 1000):
        with pytest.raises(ValueError, match="multiple of 64"):
            tw.ffn_plan(tokens, bad)
    with pytest.raises(ValueError, match="tokens"):
        tw.ffn_plan(tokens + 2**31, 64)


def test_ffn_variants_apply_to_the_source():
    """tools/ffn_variants.py edits csrc/win_ffn.cu's own lines: every
    variant still finds them (a kernel edit that moves them fails here, not
    on the card)."""
    from color_transfer_tpu_torch.tools import ffn_variants as fv

    base = fv.variant_source([])
    for name, edits in fv.VARIANTS.items():
        src = fv.variant_source(edits)
        assert (src == base) == (not edits), name


@pytest.mark.parametrize("sublayer,resident_to", [(False, 640), (True, 512)])
def test_attention_plan_routes(sublayer, resident_to):
    """The bf16 B2a / B2b route plan: the window's K resident in shared
    memory up to L = 640 (B2a) or 512 (B2b, whose block also holds a 32 KB
    weight), which covers the served L = 448 and the training L = 480 and
    120; streamed beyond, up to 1024. Every L fits a block's 232,448 bytes;
    the grid is (query blocks of 128 rows, windows)."""
    for length in range(1, tw._MAX_L + 1):
        plan = tw.attention_plan(length, 7, sublayer=sublayer)
        assert plan.route == ("resident" if length <= resident_to else "streamed")
        assert plan.smem <= tw.BLOCK_SMEM_LIMIT == 232448
        assert plan.k_slots == (-(-length // 64) if plan.route == "resident" else 4)
        assert plan.grid == (-(-length // 128), 7)
        # the streamed route fits every L; the resident one raises past its L
        streamed = tw.attention_plan(length, 7, sublayer=sublayer, route="streamed")
        assert streamed.smem <= tw.BLOCK_SMEM_LIMIT and streamed.k_slots == 4
        if length > resident_to:
            with pytest.raises(ValueError, match="resident"):
                tw.attention_plan(length, 7, sublayer=sublayer, route="resident")
    for length in (448, 480, 120):
        assert tw.attention_plan(length, 256, sublayer=sublayer).route == "resident"
    # the byte count: query tile, K slots and the two V stages of 16 KB, B2b's
    # weight, 3 KB of labels, barriers and alignment
    assert tw.attention_plan(448, 256, sublayer=sublayer).smem == (
        32768 + (7 + 2) * 16384 + 32768 * sublayer + 3072)
    assert tw.attention_plan(448, 256).grid == (4, 256)
    for bad in ((-1, 1), (1025, 1), (64, -1), (64, 65536)):
        with pytest.raises(ValueError):
            tw.attention_plan(*bad, sublayer=sublayer)
    # empty inputs launch nothing (the launcher returns at once): a plan, no error
    assert tw.attention_plan(0, 4, sublayer=sublayer).grid == (0, 4)
    assert tw.attention_plan(64, 0, sublayer=sublayer).grid == (1, 0)
    with pytest.raises(ValueError, match="route"):
        tw.attention_plan(64, 1, route="cached")
