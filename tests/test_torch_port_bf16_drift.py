"""Whose is the bf16 recipe's drift: DCMCS3DI ``bf16`` in the port against
the JAX package's, on shared weights, through the drift gate's arithmetic.

Both packages run their kernel route (JAX ``use_pallas=True`` in interpret
mode, the port ``use_kernels=True`` with the kernels' plain versions on the
CPU) in float32 and in the bf16 recipe on one set of weights, one stereo pair
(``tools/deep_gate.py::load_pair``) and the same distorted targets (the
port's grid distortions, handed to both as numpy). Every output is measured
with the port's metrics, so a difference between the two packages' rows is a
difference of their models, not of their metrics.

Per distortion the comparison gives, for each package, the gate's deltas
(bf16 against f32: dPSNR, dSSIM, diCID against the clean plate), and
directly port bf16 against JAX bf16 (max|d|, pair PSNR, the difference of
their SSIM against the clean plate), the same for f32.

The tier-1 tests run it at a small size. As a script it prints the whole
table, at full width:

    JAX_PLATFORMS=cpu python tests/test_torch_port_bf16_drift.py \\
        --height 64 --width 96 --weights torch:0

``--weights torch:S`` are the port's own seeded weights (what the gate on
the card draws for seed S), carried to JAX with ``convert_dcmcs3di``;
``numpy:S`` are drawn with numpy in the JAX layout and carried to the port
with ``dcmcs3di_state_dict_from_jax``.
"""

import argparse
import json

import numpy as np
import torch

import jax
import jax.numpy as jnp

from color_transfer_tpu.models import dcmcs3di as jdc
from color_transfer_tpu.tools.convert_checkpoints import convert_dcmcs3di
from color_transfer_tpu_torch import metrics
from color_transfer_tpu_torch.data.distortions import setup_grid_distortions
from color_transfer_tpu_torch.models import dcmcs3di as tdc
from color_transfer_tpu_torch.run.modules import DCMCS3DIModule
from color_transfer_tpu_torch.tools.convert import dcmcs3di_state_dict_from_jax
from color_transfer_tpu_torch.tools.deep_gate import load_pair

# The tier-1 lines, port bf16 against JAX bf16 at SMALL (see the tests).
SSIM_LINE = 1e-4
SMALL = dict(height=32, width=64, ext=3, tra=2, channels=16, indices=(0, 7, 19))


def shared_weights(source, seed, ext, tra, channels):
    """(JAX params, port state_dict) holding the same numbers."""
    if source == "torch":
        module = DCMCS3DIModule(ext, tra, channels)
        sd = {k: v.cpu() for k, v in module.init_eval_variables(seed=seed).items()}
        params = convert_dcmcs3di({k: v.numpy() for k, v in sd.items()},
                                  extraction_layers=ext, transfer_layers=tra)
        return params, sd
    model = jdc.DCMCS3DI(extraction_layers=ext, transfer_layers=tra, channels=channels)
    x = jnp.zeros((1, 16, 16, 3), jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, x)["params"]
    rng = np.random.default_rng(seed)

    def fill(path, s):
        fan_in = int(np.prod(s.shape[:-1])) if path[-1].key == "kernel" else 9 * channels
        bound = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    return params, dcmcs3di_state_dict_from_jax(params)


def _forwards(params, sd, ext, tra, channels):
    """{(package, recipe): fn(target, reference) -> (1, H, W, 3) numpy}."""
    fns = {}
    for recipe, (jd, td) in {"f32": (None, None),
                             "bf16": (jnp.bfloat16, torch.bfloat16)}.items():
        jmodel = jdc.DCMCS3DI(ext, tra, channels, compute_dtype=jd)
        jfwd = jax.jit(lambda t, r, m=jmodel: m.apply(
            {"params": params}, t, r, inference=True, use_pallas=True,
            pallas_interpret=True)[0])
        fns["jax", recipe] = lambda t, r, f=jfwd: np.array(
            jnp.clip(f(jnp.asarray(t), jnp.asarray(r)), 0.0, 1.0), np.float32)
        port = tdc.DCMCS3DI(ext, tra, channels, compute_dtype=td).eval()
        port.load_state_dict(sd, strict=True)

        def pfwd(t, r, m=port):
            with torch.no_grad():
                out = m(torch.from_numpy(t), torch.from_numpy(r), inference=True,
                        use_kernels=True)[0]
            return out.clamp(0.0, 1.0).float().numpy()
        fns["port", recipe] = pfwd
    return fns


def _quality(out, gt):
    o, g = torch.from_numpy(out), torch.from_numpy(gt)
    return {"psnr": float(metrics.psnr(o, g)), "ssim": float(metrics.ssim(o, g)),
            "icid": float(metrics.icid(o, g))}


def compare(height, width, indices=None, weights="numpy", seed=0, ext=18, tra=6,
            channels=64):
    """One row per grid distortion in ``indices`` (None: all 31)."""
    params, sd = shared_weights(weights, seed, ext, tra, channels)
    fns = _forwards(params, sd, ext, tra, channels)
    gt, ref = load_pair(height, width)
    g4, r4 = gt[None].copy(), np.ascontiguousarray(ref[None])
    grid = setup_grid_distortions()
    rows = []
    for i in (range(len(grid)) if indices is None else indices):
        t4 = grid[i](torch.from_numpy(gt)).clamp(0.0, 1.0)[None].numpy()
        out = {key: fn(t4, r4) for key, fn in fns.items()}
        q = {key: _quality(o, g4) for key, o in out.items()}
        row = {"i": i}
        for pkg in ("jax", "port"):
            for m in ("psnr", "ssim", "icid"):
                row[f"{pkg}_d_{m}"] = q[pkg, "bf16"][m] - q[pkg, "f32"][m]
        for recipe in ("f32", "bf16"):
            a, b = out["port", recipe], out["jax", recipe]
            row[f"{recipe}_max_abs"] = float(np.abs(a - b).max())
            row[f"{recipe}_pair_psnr"] = float(
                metrics.psnr(torch.from_numpy(a), torch.from_numpy(b)))
            row[f"{recipe}_ssim_diff"] = q["port", recipe]["ssim"] - q["jax", recipe]["ssim"]
        rows.append(row)
    return rows


# -- tier-1 -----------------------------------------------------------------

import pytest  # noqa: E402

from test_torch_port_core import one_torch_thread  # noqa: E402,F401  (autouse)


@pytest.fixture(scope="module")
def small_rows():
    s = SMALL
    return compare(s["height"], s["width"], s["indices"], "numpy", 11, s["ext"],
                   s["tra"], s["channels"])


def test_port_bf16_tracks_jax_bf16_in_ssim(small_rows):
    """The port's bf16 output scores the same SSIM against the clean plate
    as JAX's bf16 output on the same weights: a one-sided bias of the port
    of the card gate's size (5e-4) would show here five times over. The
    f32 outputs agree far closer still."""
    for row in small_rows:
        assert abs(row["bf16_ssim_diff"]) < SSIM_LINE, row
        assert abs(row["f32_ssim_diff"]) < 1e-5, row
        assert row["f32_max_abs"] < 1e-4, row


def test_gate_deltas_agree_between_packages(small_rows):
    """dSSIM and dPSNR of the recipe (bf16 against f32), the numbers the
    gate judges, agree between the packages per distortion."""
    for row in small_rows:
        assert abs(row["port_d_ssim"] - row["jax_d_ssim"]) < SSIM_LINE, row
        assert abs(row["port_d_psnr"] - row["jax_d_psnr"]) < 0.01, row
    # no bias of one sign between the packages' bf16 outputs
    mean = np.mean([r["bf16_ssim_diff"] for r in small_rows])
    assert abs(mean) < SSIM_LINE / 2, mean


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--width", type=int, default=96)
    ap.add_argument("--weights", default="numpy:0", help="numpy:SEED or torch:SEED")
    ap.add_argument("--limit", type=int, default=0, help="first N distortions (0: all)")
    ap.add_argument("--extraction_layers", type=int, default=18)
    ap.add_argument("--transfer_layers", type=int, default=6)
    ap.add_argument("--channels", type=int, default=64)
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    source, seed = args.weights.split(":")
    rows = compare(args.height, args.width, range(args.limit) if args.limit else None,
                   source, int(seed), args.extraction_layers, args.transfer_layers,
                   args.channels)
    for row in rows:
        print(json.dumps({k: (round(v, 7) if isinstance(v, float) else v)
                          for k, v in row.items()}), flush=True)
    summary = {"weights": args.weights, "size": [args.height, args.width], "n": len(rows)}
    for k in rows[0]:
        if k != "i":
            vals = [r[k] for r in rows]
            summary[k] = {"min": round(min(vals), 7), "max": round(max(vals), 7),
                          "mean": round(float(np.mean(vals)), 7)}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
