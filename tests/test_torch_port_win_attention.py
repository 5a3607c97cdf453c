"""Port parity: the matcher transformer's fused window ops
(color_transfer_tpu_torch/ops/win_attention.py: B2a windowed attention, B2b
attention sublayer, B2c FFN) on the CPU, where they take their plain
versions, against color_transfer_tpu/ops/win_attention.py: the Pallas
kernels in interpret mode and their XLA twins, on the same numpy inputs.

Lines: atol 1e-5 (float32 on both sides, sums in another order; the JAX
package's own line for its sublayer and FFN kernels, tests/test_win_attention.py);
the FFN against the interpret kernel, whose GELU uses the Abramowitz & Stegun
erf (|err| <= 1.5e-7), at the same atol. Gradients: the port's autograd
Function (backward = autograd of the plain version) against jax.grad of the
fused function (its custom VJP runs the XLA twin) on JAX's own gradient line,
rtol 1e-5 and atol 1e-5 (weight gradients sum over every token and reach
~20). The routing guards must agree with JAX's exactly.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from color_transfer_tpu.ops import win_attention as jw
from color_transfer_tpu_torch.ops import win_attention as tw
from color_transfer_tpu_torch.utils.profiling import counter
from test_torch_port_core import one_torch_thread  # noqa: F401  (an autouse fixture)

ATOL = 1e-5


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy()).requires_grad_(grad)


def _close(got, want, rtol=0.0):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=rtol)


def _close_grad(got, want):
    _close(got, want, rtol=1e-5)


def _tokens(rng, bp, length, c):
    return rng.normal(size=(bp, length, c)).astype(np.float32)


def _sublayer_weights(rng, c):
    def mk(shape):
        return (rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32)

    ns = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
    nb = (0.1 * rng.normal(size=c)).astype(np.float32)
    return mk((c, c)), mk((c, 2 * c)), mk((c, c)), ns, nb


def _ffn_weights(rng, c, f):
    def mk(shape):
        return (rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32)

    ns = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
    nb = (0.1 * rng.normal(size=c)).astype(np.float32)
    return mk((2 * c, f)), mk((f, c)), ns, nb


# -- B2a: windowed attention, three mask modes --------------------------------


@pytest.mark.parametrize("bp,length,c", [(8, 24, 32), (3, 8, 32), (2, 20, 128)])
def test_attention_unmasked(rng, bp, length, c):
    q, k, v = (_tokens(rng, bp, length, c) for _ in range(3))
    got = tw.window_attention_fused(_t(q), _t(k), _t(v))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(got, jw.window_attention_fused(jq, jk, jv, interpret=True))
    _close(got, jw.window_attention_xla(jq, jk, jv))


def test_attention_mask_operand(rng):
    bp, length, c, n_mask = 8, 24, 32, 4
    q, k, v = (_tokens(rng, bp, length, c) for _ in range(3))
    mask = np.where(rng.uniform(size=(n_mask, length, length)) > 0.7, -100.0,
                    0.0).astype(np.float32)
    got = tw.window_attention_fused(_t(q), _t(k), _t(v), _t(mask))
    args = tuple(map(jnp.asarray, (q, k, v, mask)))
    _close(got, jw.window_attention_fused(*args, interpret=True))
    _close(got, jw.window_attention_xla(*args))


@pytest.mark.parametrize("kw,hs,ws,imgs", [(2, 4, 6, 1), (2, 5, 7, 2), (4, 2, 3, 1),
                                           (8, 1, 2, 1)])
def test_attention_shift_geometry(rng, kw, hs, ws, imgs):
    """Odd and even windows, and one-row windows (the 8x16 features of a
    64x128 matcher input at 8 splits), where the JAX mask's bands overlap."""
    bp, length, c = imgs * kw * kw, hs * ws, 32
    q, k, v = (_tokens(rng, bp, length, c) for _ in range(3))
    got = tw.window_attention_fused(_t(q), _t(k), _t(v), shift_windows=(kw, hs, ws))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(got, jw.window_attention_fused(jq, jk, jv, shift_windows=(kw, hs, ws),
                                          interpret=True))
    mask = jnp.asarray(jw.shift_window_mask(kw * hs, kw * ws, kw))
    _close(got, jw.window_attention_xla(jq, jk, jv, mask))


@pytest.mark.parametrize("kw,hs,ws", [(2, 4, 6), (2, 5, 7), (4, 2, 3), (8, 1, 2),
                                      (8, 16, 28), (2, 32, 56)])
def test_region_labels_give_the_shift_mask(kw, hs, ws):
    """The geometry mask (from the region labels) is JAX's numpy swin mask,
    for every window geometry, up to the 1080p matcher's two scales."""
    np.testing.assert_array_equal(tw.geometry_mask(kw, hs, ws).numpy(),
                                  jw.shift_window_mask(kw * hs, kw * ws, kw))


def test_attention_gradient(rng):
    kw, hs, ws, c = 2, 4, 6, 32
    q, k, v = (_tokens(rng, kw * kw, hs * ws, c) for _ in range(3))
    g = rng.normal(size=q.shape).astype(np.float32)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    (tw.window_attention_fused(tq, tk, tv, shift_windows=(kw, hs, ws)) * _t(g)).sum().backward()
    want = jax.grad(lambda a, b, d: (jw.window_attention_fused(
        a, b, d, shift_windows=(kw, hs, ws), interpret=True) * g).sum(),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close_grad(got, w)


def test_attention_argument_checks(rng):
    q = _t(_tokens(rng, 6, 8, 32))
    with pytest.raises(ValueError, match="not both"):
        tw.window_attention_fused(q[:4], q[:4], q[:4], torch.zeros(4, 8, 8),
                                  shift_windows=(2, 2, 4))
    with pytest.raises(ValueError, match="mask periods"):
        tw.window_attention_fused(q, q, q, torch.zeros(4, 8, 8))
    with pytest.raises(ValueError, match="inconsistent"):
        tw.window_attention_fused(q, q, q, shift_windows=(2, 2, 4))


# -- the card's 3xTF32 recipe, emulated ---------------------------------------
#
# The attention core on the card (csrc/win_common.cuh::attend) multiplies on
# the tensor cores in TF32: each f32 operand x is split as big = tf32(x),
# small = tf32(x - big) (cvt.rna: round to nearest, ties away from zero, to
# TF32's 10 stored mantissa bits) and each product is small*big + big*small
# + big*big, summed in f32. A TF32 product is exact in f32 (11 x 11 bits),
# so torch's f32 matmul of TF32 values on the CPU computes the same terms.

KERNEL_RTOL = 1e-4  # the card's line for B2a against its plain version


def tf32_round(x):
    """cvt.rna.tf32.f32 on f32 bits: add half of the 13 dropped bits' range
    to the magnitude (sign-magnitude, so ties go away from zero; a carry
    moves into the exponent), then clear them. inf and NaN pass through."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def _split(x):
    big = tf32_round(x)
    return big, tf32_round(x - big)


def _matmul_3xtf32(a, b):
    (ab, as_), (bb, bs) = _split(a), _split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def _matmul_1xtf32(a, b):
    return tf32_round(a) @ tf32_round(b)


def _attention_emulated(matmul, q, k, v, mask=None):
    """window_attention_plain's math with both products through ``matmul``."""
    scores = matmul(q, k.transpose(-1, -2)) * np.float32(1.0 / np.sqrt(q.shape[-1]))
    if mask is not None:
        n = mask.shape[0]
        scores = (scores.reshape(-1, n, *scores.shape[1:]) + mask).reshape(scores.shape)
    return matmul(torch.softmax(scores, dim=-1), v)


def _tf32_reference(x):
    """The rounding rule on one float, with exact fractions: the nearest
    multiple of TF32's spacing at x's binade (2^(e - 10), and 2^-136 below
    the normal range), ties away from zero; past the largest finite value,
    inf."""
    from fractions import Fraction

    if not np.isfinite(x) or x == 0.0:
        return x
    mag = Fraction(abs(x))
    e = max(mag.numerator.bit_length() - mag.denominator.bit_length(), -126)
    if Fraction(2) ** e > mag:
        e -= 1
    e = max(e, -126)
    step = Fraction(2) ** (e - 10)
    q = mag / step
    n = int(q)
    if q - n >= Fraction(1, 2):
        n += 1
    out = n * step
    if out >= Fraction(2) ** 128:
        return float(np.copysign(np.inf, x))
    return float(np.copysign(float(out), x))


def test_tf32_rounding_rule():
    """The bit trick against the rule on hand-picked values: exact TF32
    values, ties (up and away from zero, both signs), the carry into the
    exponent, subnormals (and a tie among them), the largest finite value
    (which rounds to inf), +-inf and 0."""
    tie = 1.0 + 2.0**-11  # halfway between two TF32 neighbours of 1
    values = [1.0, -1.0, 0.0, -0.0, tie, -tie, 1.0 + 3 * 2.0**-11, 1.0 + 2.0**-11 - 2.0**-23,
              2.0 - 2.0**-23, 3.14159265, -2.71828, 1e-40, -1e-40, 2.0**-140 * 3,
              2.0**-149, 2.0**-137, 5.9e-39, 1.17549435e-38, 3.4028235e38, np.inf, -np.inf,
              65504.0, 1e30, -7.25e-20]
    x = torch.tensor(values, dtype=torch.float32)
    got = tf32_round(x)
    want = torch.tensor([_tf32_reference(float(v)) for v in x], dtype=torch.float32)
    assert torch.equal(got, want), [(float(a), float(b), float(c))
                                    for a, b, c in zip(x, got, want) if a != a or b != c]
    assert float(tf32_round(torch.tensor([tie]))) == 1.0 + 2.0**-10  # away from zero
    assert torch.isnan(tf32_round(torch.tensor([float("nan")]))).all()


@pytest.mark.parametrize("mode", ["none", "shift", "mask"])
def test_3xtf32_attention_matches_jax(rng, mode, capsys):
    """Window attention through the card's 3xTF32 arithmetic, in the three
    mask modes, against JAX's window_attention_xla (f32) within the card's
    line (1e-4 of max(1, max|ref|)); plain TF32 (1xTF32) printed beside it."""
    kw, hs, ws, c = 2, 5, 7, 128
    bp, length = 2 * kw * kw, hs * ws
    q, k, v = (_tokens(rng, bp, length, c) * 2 for _ in range(3))
    mask = None
    if mode == "shift":
        mask = jw.shift_window_mask(kw * hs, kw * ws, kw).astype(np.float32)
    elif mode == "mask":
        mask = np.where(rng.uniform(size=(kw * kw, length, length)) > 0.7, -100.0,
                        0.0).astype(np.float32)
    want = np.asarray(jw.window_attention_xla(
        *map(jnp.asarray, (q, k, v)), None if mask is None else jnp.asarray(mask)))
    args = (_t(q), _t(k), _t(v), None if mask is None else _t(mask))
    line = KERNEL_RTOL * max(1.0, float(np.abs(want).max()))
    err3, err1 = (float(np.abs(_attention_emulated(mm, *args).numpy() - want).max())
                  for mm in (_matmul_3xtf32, _matmul_1xtf32))
    with capsys.disabled():
        print(f"\n3xTF32 attention ({mode}): max|d| {err3:.2e}; 1xTF32 {err1:.2e}; "
              f"line {line:.2e}")
    assert err3 <= line and err1 > err3


def _ffn_emulated(matmul, xs, xm, w0, w2, ns, nb):
    """ffn_plain's math with both products through ``matmul``: B2c's
    arithmetic on the card, where gelu(h) is split as it leaves the first
    product's accumulator."""
    h = F.gelu(matmul(torch.cat([xs, xm], dim=-1), w0))
    return xs + tw.layer_norm(matmul(h, w2), ns, nb)


def _sublayer_emulated(matmul, xs, xt, wq, wkv, wm, ns, nb, mask=None):
    """window_sublayer_plain's math with the three projections and the
    attention's two products through ``matmul`` (B2b on the card)."""
    c = wq.shape[1]
    kv = matmul(xt, wkv)
    msg = _attention_emulated(matmul, matmul(xs, wq), kv[..., :c], kv[..., c:], mask)
    return tw.layer_norm(matmul(msg, wm), ns, nb)


def _report(label, err3, err1, line):
    print(f"\n3xTF32 {label}: max|d| {err3:.2e}; 1xTF32 {err1:.2e}; line {line:.2e}")
    assert err3 <= line and err1 > err3


@pytest.mark.parametrize("f", [64, 1024])
def test_3xtf32_ffn_matches_jax(rng, f, capsys):
    """B2c through the card's 3xTF32 arithmetic (both products, the exact
    GELU, JAX's LayerNorm, the residual) against JAX's ffn_xla at f32
    HIGHEST, within the card's line; 1xTF32 printed beside it."""
    c = 128
    xs, xm = _tokens(rng, 3, 37, c), _tokens(rng, 3, 37, c)
    w0, w2, ns, nb = _ffn_weights(rng, c, f)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jw.ffn_xla(*map(jnp.asarray, (xs, xm, w0, w2)),
                                     norm=(jnp.asarray(ns), jnp.asarray(nb)), add_residual=True))
    args = tuple(map(_t, (xs, xm, w0, w2, ns, nb)))
    line = KERNEL_RTOL * max(1.0, float(np.abs(want).max()))
    err3, err1 = (float(np.abs(_ffn_emulated(mm, *args).numpy() - want).max())
                  for mm in (_matmul_3xtf32, _matmul_1xtf32))
    with capsys.disabled():
        _report(f"FFN (F = {f})", err3, err1, line)


@pytest.mark.parametrize("shift", [False, True])
def test_3xtf32_sublayer_matches_jax(rng, shift, capsys):
    """B2b through the card's 3xTF32 arithmetic (the q, k/v and merge
    projections and the attention's two products) against JAX's
    window_sublayer_xla at f32 HIGHEST, shifted and unshifted."""
    kw, hs, ws, c = 2, 5, 7, 128
    bp, length = 2 * kw * kw, hs * ws
    xs, xt = _tokens(rng, bp, length, c), _tokens(rng, bp, length, c)
    w = _sublayer_weights(rng, c)
    mask = jw.shift_window_mask(kw * hs, kw * ws, kw).astype(np.float32) if shift else None
    with jax.default_matmul_precision("highest"):
        jargs = tuple(map(jnp.asarray, (xs, xt, *w)))
        want = np.asarray(jw.window_sublayer_xla(
            *jargs[:5], None if mask is None else jnp.asarray(mask), norm=jargs[5:]))
    args = tuple(map(_t, (xs, xt, *w))) + (None if mask is None else _t(mask),)
    line = KERNEL_RTOL * max(1.0, float(np.abs(want).max()))
    err3, err1 = (float(np.abs(_sublayer_emulated(mm, *args).numpy() - want).max())
                  for mm in (_matmul_3xtf32, _matmul_1xtf32))
    with capsys.disabled():
        _report(f"sublayer ({'shifted' if shift else 'unshifted'})", err3, err1, line)


# -- B2b: the attention sublayer ------------------------------------------------


@pytest.mark.parametrize("self_attn", [True, False])
@pytest.mark.parametrize("residual", [False, True])
def test_sublayer_unshifted(rng, self_attn, residual):
    bp, length, c = 8, 24, 32
    xs = _tokens(rng, bp, length, c)
    xt = xs if self_attn else _tokens(rng, bp, length, c)
    w = _sublayer_weights(rng, c)
    got = tw.window_sublayer_fused(_t(xs), _t(xt), *map(_t, w), add_residual=residual)
    jargs = tuple(map(jnp.asarray, (xs, xt, *w)))
    _close(got, jw.window_sublayer_fused(*jargs, add_residual=residual, interpret=True))
    _close(got, jw.window_sublayer_xla(*jargs[:5], norm=jargs[5:], add_residual=residual))


@pytest.mark.parametrize("self_attn,residual", [(True, True), (False, False)])
@pytest.mark.parametrize("kw,hs,ws,imgs", [(2, 4, 6, 1), (2, 5, 7, 2), (8, 2, 3, 1)])
def test_sublayer_shifted(rng, kw, hs, ws, imgs, self_attn, residual):
    """The two uses in a block: self-attention with the residual (no FFN),
    cross-attention without; C = 128 at the smallest geometry."""
    c = 128 if kw == 8 else 32
    bp, length = imgs * kw * kw, hs * ws
    xs = _tokens(rng, bp, length, c)
    xt = xs if self_attn else _tokens(rng, bp, length, c)
    w = _sublayer_weights(rng, c)
    got = tw.window_sublayer_fused(_t(xs), _t(xt), *map(_t, w), shift_windows=(kw, hs, ws),
                                   add_residual=residual)
    jargs = tuple(map(jnp.asarray, (xs, xt, *w)))
    _close(got, jw.window_sublayer_fused(*jargs, shift_windows=(kw, hs, ws),
                                         add_residual=residual, interpret=True))
    mask = jnp.asarray(jw.shift_window_mask(kw * hs, kw * ws, kw))
    _close(got, jw.window_sublayer_xla(*jargs[:5], mask, norm=jargs[5:],
                                       add_residual=residual))


def test_sublayer_gradient(rng):
    """Self-attention (one tensor twice: autograd sums the cotangents), the
    shift geometry, the residual; every input's gradient."""
    bp, length, c = 4, 12, 32
    xs = _tokens(rng, bp, length, c)
    w = _sublayer_weights(rng, c)
    g = rng.normal(size=xs.shape).astype(np.float32)
    ins = [_t(a, True) for a in (xs, *w)]
    out = tw.window_sublayer_fused(ins[0], ins[0], *ins[1:], shift_windows=(2, 3, 4),
                                   add_residual=True)
    (out * _t(g)).sum().backward()
    want = jax.grad(lambda x, *ws_: (jw.window_sublayer_fused(
        x, x, *ws_, shift_windows=(2, 3, 4), add_residual=True, interpret=True) * g).sum(),
        argnums=tuple(range(6)))(*map(jnp.asarray, (xs, *w)))
    for got, wnt in zip(ins, want):
        _close_grad(got.grad, wnt)


def test_sublayer_weight_shapes_checked(rng):
    xs = torch.zeros(4, 8, 32)
    ns = torch.ones(32)
    with pytest.raises(ValueError, match="weight shapes"):
        tw.window_sublayer_fused(xs, xs, torch.zeros(32, 32), torch.zeros(32, 32),
                                 torch.zeros(32, 32), ns, ns)


# -- B2c: the FFN ---------------------------------------------------------------


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("c,f", [(32, 64), (128, 1024)])
def test_ffn(rng, residual, c, f):
    xs, xm = _tokens(rng, 6, 16, c), _tokens(rng, 6, 16, c)
    w = _ffn_weights(rng, c, f)
    got = tw.ffn_fused(_t(xs), _t(xm), *map(_t, w), add_residual=residual)
    jargs = tuple(map(jnp.asarray, (xs, xm, *w)))
    _close(got, jw.ffn_xla(*jargs[:4], norm=jargs[4:], add_residual=residual))
    _close(got, jw.ffn_fused(*jargs, add_residual=residual, interpret=True))


def test_ffn_gradient(rng):
    xs, xm = _tokens(rng, 4, 8, 32), _tokens(rng, 4, 8, 32)
    w = _ffn_weights(rng, 32, 64)
    g = rng.normal(size=xs.shape).astype(np.float32)
    ins = [_t(a, True) for a in (xs, xm, *w)]
    (tw.ffn_fused(*ins, add_residual=True) * _t(g)).sum().backward()
    want = jax.grad(lambda *a: (jw.ffn_fused(*a, add_residual=True, interpret=True)
                                * g).sum(), argnums=tuple(range(6)))(
        *map(jnp.asarray, (xs, xm, *w)))
    for got, wnt in zip(ins, want):
        _close_grad(got.grad, wnt)


def test_ffn_weight_shapes_checked(rng):
    xs = _t(_tokens(rng, 2, 4, 32))
    w0, w2, ns, nb = map(_t, _ffn_weights(rng, 32, 64))
    with pytest.raises(ValueError, match="inconsistent"):
        tw.ffn_fused(xs, xs, w0[:10], w2, ns, nb)


# -- routing guards and the CPU route -----------------------------------------

GUARD_SHAPES = [(128, 448, 128), (8, 1792, 128), (96, 480, 128), (1536, 120, 128),
                (6144, 120, 128), (256, 448, 128), (2, 799, 128), (2, 800, 128),
                (5, 700, 128), (8, 4096, 128), (4, 24, 32), (3072, 120, 128)]


@pytest.mark.parametrize("shape", GUARD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_guards_match_jax(shape, dtype):
    """The 1080p scales (128, 448) and (8, 1792), the train shape's (96, 480)
    and (1536, 120), the f32 bound L = 799 and shapes around it."""
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    assert tw.eligible(shape, td) == jw.eligible(shape, jd)
    mask = (64, shape[1], shape[1])
    assert tw.eligible(shape, td, mask) == jw.eligible(shape, jd, mask)
    for f in (1024, 65536):
        assert tw.ffn_eligible(shape, td, f) == jw.ffn_eligible(shape, jd, f)


def test_guards_route_the_1080p_and_train_scales():
    f32 = torch.float32
    assert tw.eligible((128, 448, 128), f32) and tw.ffn_eligible((128, 448, 128), f32, 1024)
    assert not tw.eligible((8, 1792, 128), f32)
    assert not tw.ffn_eligible((8, 1792, 128), f32, 1024)
    for shape in ((96, 480, 128), (1536, 120, 128)):
        assert tw.eligible(shape, f32) and tw.ffn_eligible(shape, f32, 1024)


def test_cpu_route_launches_no_kernel(rng):
    names = [f"{k}.launches" for k in ("win_attention", "win_sublayer", "win_ffn")]
    counts = [counter(n) for n in names]
    x = _t(_tokens(rng, 4, 8, 32))
    tw.window_attention_fused(x, x, x)
    tw.window_sublayer_fused(x, x, *map(_t, _sublayer_weights(rng, 32)))
    tw.ffn_fused(x, x, *map(_t, _ffn_weights(rng, 32, 64)))
    assert [counter(n) for n in names] == counts
