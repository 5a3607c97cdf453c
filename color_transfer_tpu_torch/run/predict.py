"""Batch prediction — correct stereo pairs from the CLI; port of
color_transfer_tpu/run/predict.py:

    python -m color_transfer_tpu_torch.cli predict --method monge_kantorovitch \
        --target T.png --reference R.png --output OUT.png
    python -m color_transfer_tpu_torch.cli predict --method dmsct \
        --target T.png --reference R.png --output OUT.png
    python -m color_transfer_tpu_torch.cli predict --method dcmcs3di \
        --input_dir "Real-World Dataset/Test" --output_dir corrected/ \
        --model.compute_dtype bfloat16

Directory mode walks the reference dataset layout: the corrected view is
``*_LD.*`` (the real-world distorted target) when present, else ``*_L.*``;
the reference view is the matching ``*_R.*``. Same-shape pairs run as one
clip through methods/video.py. Images are read and written with PIL,
imported at first use.
"""

from pathlib import Path

import numpy as np


def _read_float(path):
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0


def _write_png(path, img):
    from PIL import Image

    arr = np.asarray(np.clip(img, 0.0, 1.0) * 255.0 + 0.5, dtype=np.uint8)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(path)


def collect_pairs(input_dir):
    """(target, reference, relative output path) triples from a
    dataset-layout directory, recursing into scene directories."""
    input_dir = Path(input_dir)
    pairs = []
    for ref in sorted(input_dir.glob("**/*_R.*")):
        stem = ref.name[: -len("_R" + ref.suffix)]
        distorted = sorted(ref.parent.glob(f"{stem}_LD.*"))
        left = sorted(ref.parent.glob(f"{stem}_L.*"))
        target = distorted[0] if distorted else (left[0] if left else None)
        if target is None:
            continue
        rel = ref.parent.relative_to(input_dir) / f"{stem}_C.png"
        pairs.append((target, ref, rel))
    return pairs


def predict_pairs(pairs, output_dir, method="monge_kantorovitch", ckpt_path=None,
                  module_kwargs=None, batch_size=None, device=None):
    """Correct (target_path, reference_path, out_rel) triples into
    output_dir. Pairs are grouped by image shape and each group runs as one
    clip, in chunks of ``batch_size`` frames (None: 8 for the classical
    methods, 1 for the deep ones); a deep method's module and variables are
    built once. ``device`` None means the card (raises without one).
    Returns the written paths."""
    from color_transfer_tpu_torch.methods.video import (
        DEEP_METHODS,
        build_deep,
        color_transfer_between_videos,
        resolve_device,
    )

    if not pairs:
        return []
    device = resolve_device(device)
    module = variables = None
    if method in DEEP_METHODS:
        module, variables = build_deep(method, None, None, module_kwargs, ckpt_path,
                                       device)
    groups = {}
    for target, ref, rel in pairs:
        t = _read_float(target)
        r = _read_float(ref)
        if t.shape != r.shape:
            raise ValueError(
                f"target/reference shape mismatch for {rel}: {t.shape} vs {r.shape}"
            )
        groups.setdefault(t.shape, []).append((t, r, rel))

    output_dir = Path(output_dir)
    written = []
    for items in groups.values():
        out = color_transfer_between_videos(
            np.stack([t for t, _, _ in items]),
            np.stack([r for _, r, _ in items]),
            method=method, batch_size=batch_size, device=device, module=module,
            variables=variables,
        )
        out = out.cpu().numpy()
        for i, (_, _, rel) in enumerate(items):
            path = output_dir / rel
            _write_png(path, out[i])
            written.append(path)
    return written


def run_predict(args, model_init_args=None):
    """The ``predict`` subcommand: single-pair mode (--target/--reference/--output) or
    directory mode (--input_dir/--output_dir)."""
    from color_transfer_tpu_torch.methods.video import DEEP_METHODS

    deep = args.method in DEEP_METHODS
    if args.ckpt_path and not deep:
        import warnings

        warnings.warn(
            f"--ckpt_path ignored: method '{args.method}' is parameterless",
            stacklevel=1,
        )
    kwargs = dict(method=args.method, ckpt_path=args.ckpt_path if deep else None,
                  module_kwargs=dict(model_init_args or {}) if deep else None,
                  batch_size=args.batch_size, device=args.device)
    if args.target or args.reference or args.output:
        if not (args.target and args.reference and args.output):
            raise SystemExit(
                "single-pair mode needs --target, --reference and --output"
            )
        out = Path(args.output)
        pairs = [(Path(args.target), Path(args.reference), Path(out.name))]
        written = predict_pairs(pairs, out.parent, **kwargs)
    else:
        if not (args.input_dir and args.output_dir):
            raise SystemExit(
                "predict needs --target/--reference/--output or "
                "--input_dir/--output_dir"
            )
        pairs = collect_pairs(args.input_dir)
        if not pairs:
            raise SystemExit(f"no *_R.* / *_L(D).* pairs found under {args.input_dir}")
        written = predict_pairs(pairs, args.output_dir, **kwargs)
    for path in written:
        print(path)
    return 0
