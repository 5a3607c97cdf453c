"""Numeric-drift gate for the deep models' opt-in recipes — port of
examples/deep_gate.py.

Runs DMSCT or DCMCS3DI twice on identical weights and inputs, once in the
float32 default and once in an opt-in recipe, over the 31 distortions of the
reference's test grid (data/distortions.py::setup_grid_distortions), and
reports the drift between the two outputs: max|delta| and PSNR(recipe, f32)
per distortion, and the change of PSNR, SSIM and iCID against the clean
plate. A recipe passes when, over the whole grid, |dPSNR| < 0.05 dB, |dSSIM|
< 5e-4 and |diCID| < 5e-4 (examples/deep_gate.py:12-13, 199-201). The
weights are a seeded random init shared by both runs (no published
checkpoint can be read here), the harder case for drift: an untrained
corrector's residual is high-frequency noise, so rounding does not cancel.

    python -m color_transfer_tpu_torch.tools.deep_gate --model dmsct --recipe fused
    python -m color_transfer_tpu_torch.tools.deep_gate --model dcmcs3di --recipe bf16
    # on the CPU, a tiny model (the module's keywords as --model.<name>):
    python -m color_transfer_tpu_torch.tools.deep_gate --model dmsct --recipe fused \\
        --device cpu --height 64 --width 96 --limit 2 \\
        --model.matcher_num_layers 1 --model.matcher_num_reg_refine 1

The recipes (the JAX gate's names and keywords, examples/deep_gate.py::
build_model):
  * DMSCT ``fused``: the matcher transformer's fused route
    (``matcher_fused_attention=True``, kernels B2b and B2c on the card);
  * DMSCT ``bf16``: the matcher's correlation (B1) and compute dtypes and
    the corrector's in bfloat16 (the transformer fused: "auto" fuses in
    bf16); ``bf16+fused`` with the fused route asked for, ``bf16-nofuse``
    unfused; ``bf16m`` the matcher only, ``bf16c`` the corrector only;
    ``bf16+refine32``: ``bf16`` with the matcher's flow arithmetic after the
    transformer in float32 (``matcher_refine_dtype``, a keyword of the model
    that the module does not take: the gate builds the model with it, as
    the JAX gate does);
  * DCMCS3DI ``bf16``: ``compute_dtype="bfloat16"``; both of its runs take
    the kernel route (``inference=True, use_kernels=True``), as the JAX gate
    runs ``use_pallas=True``;
  * ``""``: the float32 default against itself (no drift).
Runs on the card unless ``--device cpu``; the summary is the JAX gate's JSON
line, and the exit code is 1 when the recipe fails the gate.
"""

import argparse
import json
import math

import numpy as np
import torch

from color_transfer_tpu_torch import metrics
from color_transfer_tpu_torch.data.distortions import setup_grid_distortions

GATE_DB, GATE_SSIM, GATE_ICID = 0.05, 5e-4, 5e-4
_BF16_ALL = {"matcher_corr_dtype": "bfloat16", "matcher_compute_dtype": "bfloat16",
             "corrector_compute_dtype": "bfloat16"}
RECIPES = {
    "dmsct": {
        "": {},
        "fused": {"matcher_fused_attention": True},
        "bf16": _BF16_ALL,
        "bf16+fused": {**_BF16_ALL, "matcher_fused_attention": True},
        "bf16-nofuse": {**_BF16_ALL, "matcher_fused_attention": False},
        "bf16m": {"matcher_corr_dtype": "bfloat16", "matcher_compute_dtype": "bfloat16"},
        "bf16c": {"corrector_compute_dtype": "bfloat16"},
        "bf16+refine32": {**_BF16_ALL, "matcher_refine_dtype": "float32"},
    },
    "dcmcs3di": {"": {}, "bf16": {"compute_dtype": "bfloat16"}},
}


def recipe_kwargs(model, recipe):
    """The keywords of ``recipe`` for ``model`` (the JAX gate's for the same
    name); raises for a recipe neither package has."""
    if model not in RECIPES:
        raise ValueError(f"unknown model {model!r}")
    if recipe in RECIPES[model]:
        return dict(RECIPES[model][recipe])
    if model == "dcmcs3di" and "fused" in recipe:
        raise ValueError("the fused recipe applies to the DMSCT matcher only")
    raise ValueError(f"unknown {model} recipe {recipe!r} (have {sorted(RECIPES[model])})")


def build(model, recipe, module_kwargs=None):
    """The module of ``model`` in ``recipe``. DMSCT's
    ``matcher_refine_dtype`` is a keyword of the model, not of the module:
    the module's model is rebuilt with it."""
    from color_transfer_tpu_torch.models.dmsct import DMSCT
    from color_transfer_tpu_torch.run.modules import DCMCS3DIModule, DMSCTModule

    cls = {"dmsct": DMSCTModule, "dcmcs3di": DCMCS3DIModule}[model]
    kwargs = {**dict(module_kwargs or {}), **recipe_kwargs(model, recipe)}
    refine = kwargs.pop("matcher_refine_dtype", None)
    module = cls(**kwargs)
    if refine is not None:
        module.model = DMSCT(**module.model_kwargs, matcher_refine_dtype=refine).eval()
    return module


def forward(model, module, variables):
    """target, reference (1, H, W, 3) -> the corrected target, as the JAX
    gate calls each model: DMSCT's inference forward, DCMCS3DI on its kernel
    route; TF32 off."""
    from color_transfer_tpu_torch.core.precision import full_f32_inference

    if model == "dmsct":
        return lambda t, r: module.eval_forward(variables, {"target": t, "reference": r})

    def fwd(t, r):
        with full_f32_inference():
            return torch.func.functional_call(
                module.model, variables, (t, r),
                {"inference": True, "use_kernels": True}, strict=True)[0]
    return fwd


def load_pair(height=544, width=960, left=None, right=None, downscale=1):
    """(gt, ref) (H, W, 3) float32 in [0, 1]: a stereo pair from PNGs, or the
    JAX gate's synthetic one (a smooth plate plus seeded noise, the right
    view the left rolled 8 pixels)."""
    if left and right:
        from color_transfer_tpu_torch.run.predict import _read_float

        gt, ref = _read_float(left), _read_float(right)
        return gt[::downscale, ::downscale], ref[::downscale, ::downscale]
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    base = np.stack([
        0.5 + 0.4 * np.sin(xx / 37.0) * np.cos(yy / 29.0),
        0.5 + 0.3 * np.cos(xx / 23.0 + yy / 41.0),
        0.5 + 0.35 * np.sin((xx + yy) / 53.0),
    ], axis=-1)
    rng = np.random.default_rng(3)
    gt = np.clip(base + 0.05 * rng.standard_normal(base.shape), 0, 1).astype(np.float32)
    return gt, np.roll(gt, 8, axis=1)


def run_gate(model, recipe, *, height=544, width=960, left=None, right=None,
             downscale=1, gate_db=GATE_DB, limit=0, seed=0, device=None,
             module_kwargs=None, baseline=None):
    """Both runs over the grid. Returns (summary, rows): the JAX gate's
    summary keys, and per distortion its max|delta|, pair PSNR and metric
    deltas. ``baseline``: a dict that keeps the float32 run's outputs
    between calls on the same model, weights, pair and module keywords
    (one f32 run for several recipes); None runs it each time."""
    from color_transfer_tpu_torch.methods.video import resolve_device

    device = resolve_device(device)
    gt, ref = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
               for a in load_pair(height, width, left, right, downscale))
    base, rec = build(model, "", module_kwargs), build(model, recipe, module_kwargs)
    variables = base.init_eval_variables(seed=seed, device=device)
    base_fwd, rec_fwd = forward(model, base, variables), forward(model, rec, variables)
    grid = setup_grid_distortions()
    if limit:
        grid = grid[:limit]
    g4, r4 = gt[None], ref[None]
    rows = []
    key = (model, seed, height, width, left, right, downscale,
           tuple(sorted(dict(module_kwargs or {}).items())))
    with torch.no_grad():
        for i, dist_fn in enumerate(grid):
            t4 = dist_fn(gt).clamp(0.0, 1.0)[None]
            if baseline is not None and (key, i) in baseline:
                out_f32 = baseline[key, i]
            else:
                out_f32 = base_fwd(t4, r4).clamp(0.0, 1.0)
                if baseline is not None:
                    baseline[key, i] = out_f32
            out_rec = rec_fwd(t4, r4).clamp(0.0, 1.0).float()
            rows.append({
                "i": i,
                "max_abs": float((out_rec - out_f32).abs().max()),
                "pair_psnr": float(metrics.psnr(out_rec, out_f32)),
                "d_psnr": float(metrics.psnr(out_rec, g4)) - float(metrics.psnr(out_f32, g4)),
                "d_ssim": float(metrics.ssim(out_rec, g4)) - float(metrics.ssim(out_f32, g4)),
                "d_icid": float(metrics.icid(out_rec, g4)) - float(metrics.icid(out_f32, g4)),
            })
    worst = {"max_abs": max(r["max_abs"] for r in rows),
             "pair_psnr": min(r["pair_psnr"] for r in rows)}
    for k in ("d_psnr", "d_ssim", "d_icid"):
        worst[k] = max((r[k] for r in rows), key=abs)
    summary = {
        "model": model,
        "recipe": recipe,
        "n_distortions": len(grid),
        "worst_max_abs": round(worst["max_abs"], 6),
        "worst_pair_psnr_db": round(worst["pair_psnr"], 2),
        "worst_d_psnr_db": round(worst["d_psnr"], 4),
        "worst_d_ssim": round(worst["d_ssim"], 6),
        "worst_d_icid": round(worst["d_icid"], 6),
        "gate_db": gate_db,
        "pass": bool(abs(worst["d_psnr"]) < gate_db and abs(worst["d_ssim"]) < GATE_SSIM
                     and abs(worst["d_icid"]) < GATE_ICID),
    }
    return summary, rows


def occlusion_flips(row, *, height=544, width=960, seed=0, device=None,
                    module_kwargs=None, radius=32):
    """Why one row of DMSCT's ``fused`` gate reads below the others: at
    distortion ``row`` of the grid, the matcher's output fused against
    float32 on shared weights. GMFlow's forward/backward consistency check
    thresholds the flow into occlusion masks, and the corrector reads the
    forward mask, so a flow that moves by a rounding can flip a pixel's flag.
    Returns the pixels whose forward and backward flags flip, the flow's
    max|d| at the flipped forward pixels and elsewhere, the corrected
    image's pair PSNR and max|d| at and away from those pixels, and the
    share of the image's squared difference within ``radius`` pixels of a
    flipped one (the corrector's convolutions spread a flip). A report, not
    a check."""
    from color_transfer_tpu_torch.core.precision import full_f32_inference
    from color_transfer_tpu_torch.core.resize import derive_matcher_size
    from color_transfer_tpu_torch.methods.video import resolve_device

    device = resolve_device(device)
    gt, ref = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
               for a in load_pair(height, width))
    modules = {"f32": build("dmsct", "", module_kwargs),
               "fused": build("dmsct", "fused", module_kwargs)}
    variables = modules["f32"].init_eval_variables(seed=seed, device=device)
    mv = {k[len("matcher."):]: v for k, v in variables.items() if k.startswith("matcher.")}
    t4 = setup_grid_distortions()[row](gt).clamp(0.0, 1.0)[None]
    r4 = ref[None]
    size = derive_matcher_size(height, width)
    with full_f32_inference():
        flows = {name: torch.func.functional_call(m.model.matcher, mv, (t4 * 255.0, r4 * 255.0),
                                                  {"inference_size": size})
                 for name, m in modules.items()}
        images = {name: forward("dmsct", m, variables)(t4, r4).clamp(0.0, 1.0)
                  for name, m in modules.items()}
    a, b = flows["fused"], flows["f32"]
    fwd = (a["fwd_occ"] != b["fwd_occ"])[..., 0]
    bwd = (a["bwd_occ"] != b["bwd_occ"])[..., 0]
    dflow = (a["flow"] - b["flow"]).abs().amax(dim=-1)
    dimg = (images["fused"] - images["f32"]).abs().amax(dim=-1)

    def peak(x, where):
        return float(x[where].max()) if bool(where.any()) else 0.0

    near = torch.nn.functional.max_pool2d(fwd[:, None].float(), 2 * radius + 1, stride=1,
                                          padding=radius)[:, 0] > 0
    sq = ((images["fused"] - images["f32"]) ** 2).sum(dim=-1)
    total = float(sq.sum())

    return {"row": row, "pixels": int(fwd.numel()),
            "fwd_occ_flips": int(fwd.sum()), "bwd_occ_flips": int(bwd.sum()),
            "fwd_occluded_f32": int(b["fwd_occ"].sum()),
            "flow_max_d_at_flips": peak(dflow, fwd), "flow_max_d_elsewhere": peak(dflow, ~fwd),
            "pair_psnr": float(metrics.psnr(images["fused"], images["f32"])),
            "image_max_d_at_flips": peak(dimg, fwd), "image_max_d_elsewhere": peak(dimg, ~fwd),
            f"image_sq_d_share_within_{radius}px": float(sq[near].sum()) / total if total else 0.0}


def rows_finite(rows):
    return all(math.isfinite(v) for r in rows for v in r.values())


def main(argv=None):
    from color_transfer_tpu_torch.run.cli import _value

    ap = argparse.ArgumentParser(prog="color_transfer_tpu_torch.tools.deep_gate")
    ap.add_argument("--model", default="dmsct", choices=sorted(RECIPES))
    ap.add_argument("--recipe", default="fused",
                    help="dmsct: fused, bf16, bf16+fused, bf16-nofuse, bf16m, bf16c, "
                         "bf16+refine32; dcmcs3di: bf16")
    ap.add_argument("--left")
    ap.add_argument("--right")
    ap.add_argument("--downscale", type=int, default=1)
    ap.add_argument("--height", type=int, default=544)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--gate_db", type=float, default=GATE_DB,
                    help="max admissible |PSNR-vs-gt delta| in dB")
    ap.add_argument("--limit", type=int, default=0,
                    help="only run the first N grid distortions (0 = all 31)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu to run on the CPU)")
    args, extra = ap.parse_known_args(argv)
    module_kwargs = {}
    for key, value in zip(extra[::2], extra[1::2]):
        if not key.startswith("--model."):
            ap.error(f"unexpected argument {key}")
        module_kwargs[key[len("--model."):]] = _value(value)
    if len(extra) % 2:
        ap.error(f"{extra[-1]} needs a value")

    pair = (f"{args.left} / {args.right}" if args.left else
            f"{args.height}x{args.width}")
    print(f"[gate] {args.model} recipe={args.recipe} input {pair}", flush=True)
    summary, _ = run_gate(
        args.model, args.recipe, height=args.height, width=args.width, left=args.left,
        right=args.right, downscale=args.downscale, gate_db=args.gate_db,
        limit=args.limit, device=args.device,
        module_kwargs=module_kwargs)
    print(json.dumps(summary))
    return 0 if summary["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
