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
B7's float atomics add in an order that changes from run to run: within
1e-5 * max(1, max|ref|).
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
