"""Command line of the torch port; port of color_transfer_tpu/run/cli.py's
``fit``, ``validate`` and ``predict`` subcommands:

    python -m color_transfer_tpu_torch.cli fit --config configs/dmsct.yaml \
        --data.data_dir "Artificial Dataset"
    python -m color_transfer_tpu_torch.cli validate --config configs/dmsct.yaml \
        --ckpt_path runs/dmsct/checkpoints/best
    python -m color_transfer_tpu_torch.cli predict --method dmsct \
        --ckpt_path runs/dmsct/checkpoints/best \
        --input_dir "Real-World Dataset/Test" --output_dir corrected/
    python -m color_transfer_tpu_torch.cli predict --method automated_color_grading \
        --target T.png --reference R.png --output OUT.png

Everything runs on the card unless ``--device cpu`` is given; without a
card the subcommands raise. ``fit`` and ``validate`` take a config and
dotted overrides (``--trainer.max_epochs 2``, ``--model.learning_rate
1e-4``; see run/config.py). ``predict``'s ``--method`` defaults to
monge_kantorovitch, as in the JAX package, and ``--model.<name> <value>``
passes a keyword to a deep method's module (``--model.matcher_num_layers
2``); an unknown name raises. predict's values are parsed as Python
literals (``true``/``false``/``null`` too) and otherwise kept as strings.
"""

import argparse
import ast
import json
import sys

_LITERALS = {"true": True, "false": False, "null": None, "none": None}


def _value(text):
    if text.lower() in _LITERALS:
        return _LITERALS[text.lower()]
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def _parse(argv):
    """(args, overrides): for predict, overrides are the ``--model.*``
    keywords with the prefix stripped and their values parsed; for fit and
    validate, every ``--a.b value`` as given (the config coerces it)."""
    parser = argparse.ArgumentParser(prog="color_transfer_tpu_torch.cli")
    parser.add_argument("subcommand", choices=["fit", "validate", "predict"])
    parser.add_argument("--config", default=None)
    parser.add_argument("--ckpt_path", default=None)
    parser.add_argument("--log_dir", default=None)
    parser.add_argument("--max_batches", type=int, default=None)
    parser.add_argument("--method", default="monge_kantorovitch",
                        help="registry name of a classical method, or dmsct / dcmcs3di")
    parser.add_argument("--target", default=None)
    parser.add_argument("--reference", default=None)
    parser.add_argument("--output", default=None)
    parser.add_argument("--input_dir", default=None)
    parser.add_argument("--output_dir", default=None)
    parser.add_argument("--batch_size", type=int, default=None,
                        help="frames per chunk (default 8 for the classical "
                             "methods, 1 for the deep ones)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; cpu to run on the CPU)")
    args, unknown = parser.parse_known_args(argv)

    overrides = {}
    i = 0
    while i < len(unknown):
        tok = unknown[i]
        if not tok.startswith("--") or "." not in tok.split("=", 1)[0]:
            raise SystemExit(f"unexpected argument: {tok}")
        if "=" in tok:
            key, val = tok[2:].split("=", 1)
            i += 1
        elif i + 1 < len(unknown):
            key, val = tok[2:], unknown[i + 1]
            i += 2
        else:
            raise SystemExit(f"{tok} needs a value")
        overrides[key] = val
    if args.subcommand != "predict":
        return args, overrides
    model_args = {}
    for key, val in overrides.items():
        if not key.startswith("model."):
            raise SystemExit(f"unexpected argument: --{key}")
        model_args[key[len("model."):]] = _value(val)
    return args, model_args


def main(argv=None):
    args, overrides = _parse(sys.argv[1:] if argv is None else argv)
    if args.subcommand == "predict":
        from color_transfer_tpu_torch.run.predict import run_predict

        return run_predict(args, overrides)

    from color_transfer_tpu_torch.run.config import build_from_config, load_config

    cfg = load_config(args.config, overrides)
    module, datamodule, trainer = build_from_config(cfg, log_dir=args.log_dir,
                                                    device=args.device)
    if datamodule is None:
        raise SystemExit("config must provide data.init_args.data_dir")
    if args.subcommand == "fit":
        trainer.fit(module, datamodule, resume=args.ckpt_path)
        return 0

    # validate: the checkpoint's variables, or the seed's random init.
    from color_transfer_tpu_torch.run.checkpoint import restore_eval_variables

    sample = trainer.device_batch(datamodule.val_loaders()[0].first_batch())
    state = module.init_state(trainer.seed, sample)
    if args.ckpt_path is not None:
        restored = restore_eval_variables(module, args.ckpt_path, trainer.device)
        state.variables = {k: v.to(state.variables[k].dtype) for k, v in restored.items()}
    results = trainer.validate(module, datamodule, state, step=0,
                               max_batches=args.max_batches)
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
