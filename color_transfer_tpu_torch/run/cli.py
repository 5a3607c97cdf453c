"""Command line of the torch port; port of color_transfer_tpu/run/cli.py:

    python -m color_transfer_tpu_torch.cli fit --config configs/dcmcs3di.yaml \
        --data.data_dir "Artificial Dataset"
    python -m color_transfer_tpu_torch.cli test --config configs/others.yaml \
        --model.func_spec methods.linear.color_transfer_between_images
    python -m color_transfer_tpu_torch.cli test --config configs/dcmcs3di.yaml \
        --ckpt_path runs/dcmcs3di/checkpoints/best [--eval_buckets 64]
    python -m color_transfer_tpu_torch.cli validate --config configs/dmsct.yaml \
        --ckpt_path runs/dmsct/checkpoints/best
    python -m color_transfer_tpu_torch.cli predict --method dmsct \
        --ckpt_path runs/dmsct/checkpoints/best \
        --input_dir "Real-World Dataset/Test" --output_dir corrected/
    python -m color_transfer_tpu_torch.cli predict --method automated_color_grading \
        --target T.png --reference R.png --output OUT.png

Everything runs on the card unless ``--device cpu`` is given; without a
card the subcommands raise. ``fit`` runs data parallel under torchrun, one
process per card (``--device cuda:0`` puts every rank on card 0, ``--device
cpu`` on the CPU with gloo; ``--distributed.backend gloo`` picks the
backend; parallel/multihost.py):

    torchrun --nproc_per_node 8 -m color_transfer_tpu_torch.cli fit \
        --config configs/dmsct.yaml --data.data_dir "Artificial Dataset"

``test`` and ``validate`` under torchrun run on rank 0 alone. ``predict``
splits each chunk of frames over every visible card unless ``--device``
names one. ``fit``, ``test`` and ``validate`` take a
config and dotted overrides (``--trainer.max_epochs 2``,
``--model.learning_rate 1e-4``; see run/config.py); ``test`` and
``validate`` print their results as JSON, from the checkpoint's variables
or, without ``--ckpt_path``, the seed's random init. ``predict`` resolves
its method as the JAX package does: ``--method``, else the ``class_path``
of the config's model section (``--config configs/dmsct.yaml`` serves
DMSCT with the config's ``init_args``), else the classical
``--model.func_spec``, else monge_kantorovitch. ``--model.<name> <value>`` passes a keyword to a deep
method's module (``--model.matcher_num_layers 2``); an unknown name raises.
A config's ``init_args`` reach the module only when the method is the
config's own class. predict's values are parsed as Python literals
(``true``/``false``/``null`` too) and otherwise kept as strings.
``--allow_ungated`` acknowledges serving a recipe whose recorded gate
verdict is FAIL (methods/gates.py).
"""

import argparse
import ast
import json
import sys
import warnings

_LITERALS = {"true": True, "false": False, "null": None, "none": None}


def _value(text):
    if text.lower() in _LITERALS:
        return _LITERALS[text.lower()]
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def _resolve_predict(args, cfg):
    """predict's method and module keywords from ``--method`` and the
    config's model section, as color_transfer_tpu/run/cli.py resolves them.
    Sets ``args.method``; returns the keywords (a classical method takes
    none: run_predict drops them)."""
    model_cfg = cfg.get("model", {}) or {}
    class_path = model_cfg.get("class_path")
    init_args = dict(model_cfg.get("init_args", {}) or {})
    # --model.X without a class_path lands flat in the model section.
    flat_args = {k: v for k, v in model_cfg.items()
                 if k not in ("class_path", "init_args")}
    if args.method is None:
        init_args.update(flat_args)
        if class_path in (None, "classical"):
            args.method = init_args.pop("func_spec", None) or "monge_kantorovitch"
        else:
            args.method = class_path
    elif args.method != class_path:
        # The config's init_args construct another class: only the flat
        # command-line keywords apply.
        init_args = flat_args
    else:
        init_args.update(flat_args)
    return init_args


def _parse(argv):
    """(args, overrides): for predict, the method is resolved
    (_resolve_predict) and overrides are the module keywords, their
    command-line values parsed; for fit and validate, every ``--a.b value``
    as given (the config coerces it)."""
    parser = argparse.ArgumentParser(prog="color_transfer_tpu_torch.cli")
    parser.add_argument("subcommand", choices=["fit", "test", "validate", "predict"])
    parser.add_argument("--config", default=None)
    parser.add_argument("--ckpt_path", default=None)
    parser.add_argument("--log_dir", default=None)
    parser.add_argument("--max_batches", type=int, default=None)
    parser.add_argument("--eval_buckets", type=int, default=None,
                        help="test: pad each item to a multiple of this and score "
                             "its true region (run/bucketing.py)")
    parser.add_argument("--method", default=None,
                        help="predict: registry name of a classical method, or "
                             "dmsct / dcmcs3di (default: the config's model "
                             "class_path, else monge_kantorovitch)")
    parser.add_argument("--target", default=None)
    parser.add_argument("--reference", default=None)
    parser.add_argument("--output", default=None)
    parser.add_argument("--input_dir", default=None)
    parser.add_argument("--output_dir", default=None)
    parser.add_argument("--batch_size", type=int, default=None,
                        help="frames per chunk (default 8 a device for the classical "
                             "methods, 1 a device for the deep ones)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; cpu to run on the CPU)")
    parser.add_argument("--allow_ungated", action="store_true",
                        help="acknowledge serving a recipe whose recorded "
                             "gate verdict is FAIL (methods/gates.py)")
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
    from color_transfer_tpu_torch.run.config import load_config

    for key in overrides:
        if not key.startswith("model."):
            raise SystemExit(f"unexpected argument: --{key}")
    cfg = load_config(args.config, {k: _value(v) for k, v in overrides.items()})
    return args, _resolve_predict(args, cfg)


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
    if not trainer.is_main:  # test and validate run on rank 0 alone
        from color_transfer_tpu_torch.parallel.data_parallel import barrier

        barrier()
        return 0

    from color_transfer_tpu_torch.run.checkpoint import restore_eval_variables

    variables = None
    if args.ckpt_path is not None:
        variables = restore_eval_variables(module, args.ckpt_path, trainer.device)
        if variables is None:
            warnings.warn(f"--ckpt_path ignored: module '{module.name}' is parameterless",
                          stacklevel=1)

    if args.subcommand == "validate":
        sample = trainer.device_batch(datamodule.val_loaders()[0].first_batch())
        state = module.init_state(trainer.seed, sample)
        if variables is not None:
            state.variables = {k: v.to(state.variables[k].dtype)
                               for k, v in variables.items()}
        results = trainer.validate(module, datamodule, state, step=0,
                                   max_batches=args.max_batches)
    else:
        results = trainer.test(module, datamodule, variables=variables,
                               max_batches=args.max_batches,
                               eval_buckets=args.eval_buckets)
    print(json.dumps(results, indent=2))
    if trainer.world > 1:
        from color_transfer_tpu_torch.parallel.data_parallel import barrier

        barrier()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
