"""Command line of the torch port; port of color_transfer_tpu/run/cli.py's
``predict`` subcommand (the other subcommands are not ported yet):

    python -m color_transfer_tpu_torch.cli predict --method dmsct \
        --input_dir "Real-World Dataset/Test" --output_dir corrected/
    python -m color_transfer_tpu_torch.cli predict --method automated_color_grading \
        --target T.png --reference R.png --output OUT.png

``--method`` defaults to monge_kantorovitch, as in the JAX package.
``--model.<name> <value>`` passes a keyword to a deep method's module, e.g.
``--model.matcher_num_layers 2`` (DMSCT) or ``--model.compute_dtype
bfloat16`` (DCMCS3DI); an unknown name raises. Values are parsed as Python
literals (``true``/``false``/``null`` too) and otherwise kept as strings.
"""

import argparse
import ast
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
    parser = argparse.ArgumentParser(prog="color_transfer_tpu_torch.cli")
    parser.add_argument("subcommand", choices=["predict"])
    parser.add_argument("--method", default="monge_kantorovitch",
                        help="registry name of a classical method, or dmsct / dcmcs3di")
    parser.add_argument("--ckpt_path", default=None)
    parser.add_argument("--target", default=None)
    parser.add_argument("--reference", default=None)
    parser.add_argument("--output", default=None)
    parser.add_argument("--input_dir", default=None)
    parser.add_argument("--output_dir", default=None)
    parser.add_argument("--batch_size", type=int, default=None,
                        help="frames per chunk (default 8 for the classical "
                             "methods, 1 for the deep ones)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda when available)")
    args, unknown = parser.parse_known_args(argv)

    model_args = {}
    i = 0
    while i < len(unknown):
        tok = unknown[i]
        if not tok.startswith("--model."):
            raise SystemExit(f"unexpected argument: {tok}")
        if "=" in tok:
            key, val = tok[len("--model."):].split("=", 1)
            i += 1
        elif i + 1 < len(unknown):
            key, val = tok[len("--model."):], unknown[i + 1]
            i += 2
        else:
            raise SystemExit(f"{tok} needs a value")
        model_args[key] = _value(val)
    return args, model_args


def main(argv=None):
    from color_transfer_tpu_torch.run.predict import run_predict

    args, model_args = _parse(sys.argv[1:] if argv is None else argv)
    return run_predict(args, model_args)


if __name__ == "__main__":
    raise SystemExit(main())
