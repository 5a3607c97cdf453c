"""One-command published-table parity sweep — port of
color_transfer_tpu/tools/parity_sweep.py.

The day the reference's assets land (the stereo dataset and the W&B
checkpoints DCMCS3DI epoch=96-step=10185 and DMSCT epoch=72-step=7665),
this reads the checkpoints (tools/convert_checkpoints.py), runs the
paper's evaluation (``Trainer.test``: the artificial set x the
31-distortion grid, and the real-world set) for the four classical methods
of the published table and both deep methods, and prints a markdown table
shaped as BASELINE.md (the reference's README.md:74-83):

    python -m color_transfer_tpu_torch.tools.parity_sweep \\
        --data_dir "Stereo Dataset Root" \\
        --dcmcs3di_ckpt "epoch=96-step=10185.ckpt" \\
        --dmsct_ckpt "epoch=72-step=7665.ckpt" \\
        --eval_buckets 64 --out parity_table.md

Runs on the card unless ``--device cpu``. Smoke-tested on fabricated
reference-layout checkpoints and a synthetic mini set
(tests/test_torch_port_parity_sweep.py).
"""

import argparse
import json
from pathlib import Path

from color_transfer_tpu_torch.tools.convert_checkpoints import load_reference_ckpt, module_for

CLASSICAL = [
    ("Reinhard et al.", "reinhard"),
    ("Xiao et al.", "correlated_color_space"),
    ("Pitie et al. (linear MK)", "monge_kantorovitch"),
    ("Pitie et al. (iterative)", "automated_color_grading"),
]

# The published artificial-dataset table (the reference's
# graphics/comparison.webp, README.md:74-83), for side-by-side deltas when
# the real dataset is used.
PUBLISHED_ARTIFICIAL = {
    "Reinhard et al.": {"PSNR": 34.03, "SSIM": 0.960, "FSIM": 0.984, "iCID": 0.124},
    "Xiao et al.": {"PSNR": 33.11, "SSIM": 0.951, "FSIM": 0.982, "iCID": 0.161},
    "Pitie et al. (linear MK)": {"PSNR": 34.11, "SSIM": 0.958, "FSIM": 0.985, "iCID": 0.124},
    "Pitie et al. (iterative)": {"PSNR": 31.02, "SSIM": 0.949, "FSIM": 0.974, "iCID": 0.168},
    "Croci et al. (DCMCS3DI)": {"PSNR": 33.02, "SSIM": 0.979, "FSIM": 0.984, "iCID": 0.084},
    "Ours (DMSCT)": {"PSNR": 35.26, "SSIM": 0.988, "FSIM": 0.992, "iCID": 0.073},
}


def load_deep(path, kind, device=None, **module_kwargs):
    """A reference checkpoint of ``kind`` -> (the port's module, its
    variables on ``device``; None: the card). ``module_kwargs`` go to the
    module beside the checkpoint's hparams (DMSCT's
    ``matcher_corr_dtype``)."""
    from color_transfer_tpu_torch.methods.video import resolve_device

    ckpt = load_reference_ckpt(path, kind)
    device = resolve_device(device)
    return module_for(kind, ckpt.hparams, **module_kwargs), {
        k: v.to(device) for k, v in ckpt.state_dict.items()}


def run_sweep(data_dir, dcmcs3di_ckpt=None, dmsct_ckpt=None, classical=True,
              eval_buckets=None, max_batches=None, batch_size=1, num_workers=4,
              log_dir="runs/parity_sweep", seed=42, device=None,
              matcher_corr_dtype="float32"):
    """Returns {method_name: {"Test PSNR/dataloader_idx_0": ..., ...}}.
    ``matcher_corr_dtype``: DMSCT's GRU-loop correlation (kernel B1) in
    float32 (bit-strict, the default) or bfloat16, as the JAX sweep."""
    from color_transfer_tpu_torch.run.datamodule import DataModule
    from color_transfer_tpu_torch.run.modules import ClassicalModule
    from color_transfer_tpu_torch.run.trainer import Trainer

    datamodule = DataModule(data_dir, batch_size=batch_size, num_workers=num_workers,
                            seed=seed)
    results = {}

    def trainer_for(name):
        return Trainer(log_dir=str(Path(log_dir) / name), seed=seed, device=device)

    if classical:
        for label, spec in CLASSICAL:
            results[label] = trainer_for(spec).test(
                ClassicalModule(func_spec=spec, seed=seed), datamodule,
                max_batches=max_batches)
    if dcmcs3di_ckpt is not None:
        trainer = trainer_for("dcmcs3di")
        module, variables = load_deep(dcmcs3di_ckpt, "dcmcs3di", trainer.device)
        results["Croci et al. (DCMCS3DI)"] = trainer.test(
            module, datamodule, variables=variables, max_batches=max_batches,
            eval_buckets=eval_buckets)
    if dmsct_ckpt is not None:
        trainer = trainer_for("dmsct")
        module, variables = load_deep(dmsct_ckpt, "dmsct", trainer.device,
                                      matcher_corr_dtype=matcher_corr_dtype)
        results["Ours (DMSCT)"] = trainer.test(module, datamodule, variables=variables,
                                               max_batches=max_batches)
    return results


def format_table(results, published=None):
    """BASELINE.md-shaped markdown: one row per (method, dataset)."""
    metrics = ["PSNR", "SSIM", "FSIM", "iCID"]
    datasets = [("Artificial", 0), ("Real-World", 1)]
    lines = [
        "| Method | Dataset | " + " | ".join(metrics) + " | published PSNR |",
        "|---|---|" + "---|" * (len(metrics) + 1),
    ]
    for name, res in results.items():
        for ds_name, idx in datasets:
            vals = [res.get(f"Test {m}/dataloader_idx_{idx}") for m in metrics]
            if all(v is None for v in vals):
                continue
            pub = (published or {}).get(name, {}).get("PSNR")
            pub_s = f"{pub:.2f}" if (pub is not None and ds_name == "Artificial") else "-"
            cells = " | ".join("-" if v is None else f"{v:.3f}" for v in vals)
            lines.append(f"| {name} | {ds_name} | {cells} | {pub_s} |")
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--dcmcs3di_ckpt", default=None)
    parser.add_argument("--dmsct_ckpt", default=None)
    parser.add_argument("--no_classical", action="store_true")
    parser.add_argument("--eval_buckets", type=int, default=None)
    parser.add_argument("--max_batches", type=int, default=None)
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--matcher_corr_dtype", default="float32",
                        help="float32 for bit-strict parity (default); "
                             "bfloat16 for speed after the drift is gated")
    parser.add_argument("--device", default=None, help="cpu; default: the card")
    parser.add_argument("--out", default=None, help="write the markdown table here")
    args = parser.parse_args(argv)

    results = run_sweep(
        args.data_dir,
        dcmcs3di_ckpt=args.dcmcs3di_ckpt,
        dmsct_ckpt=args.dmsct_ckpt,
        classical=not args.no_classical,
        eval_buckets=args.eval_buckets,
        max_batches=args.max_batches,
        num_workers=args.num_workers,
        device=args.device,
        matcher_corr_dtype=args.matcher_corr_dtype,
    )
    table = format_table(results, published=PUBLISHED_ARTIFICIAL)
    print(json.dumps(results, indent=2))
    print()
    print(table)
    if args.out:
        Path(args.out).write_text(table + "\n")
        print(f"\nwrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
