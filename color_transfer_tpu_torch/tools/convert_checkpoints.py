"""Readers of the reference's published Lightning checkpoints — port of
color_transfer_tpu/tools/convert_checkpoints.py.

The reference ships its trained DCMCS3DI (epoch=96-step=10185) and DMSCT
(epoch=72-step=7665) as Lightning ``.ckpt`` files. The port names its
parameters as the reference does (tools/convert.py), so reading them is a
key map with checks: ``load_reference_ckpt`` takes the file's
``state_dict`` and ``hyper_parameters``, and returns the model's
state_dict, strict (every key the model has, each of its shape, nothing
else), with the hyper-parameters the JAX package reads (its defaults where
the file has none). Keys of the reference's modules that the port does not
build are dropped and listed, as the JAX converter skips them: the smp
encoder's blocks past the taps DMSCT uses and its ``_conv_head``/``_bn1``,
and the unimatch heads the flow model does not use.

    python -m color_transfer_tpu_torch.tools.convert_checkpoints \\
        --kind dcmcs3di --torch_ckpt epoch=96-step=10185.ckpt --out dcmcs3di_port
    python -m color_transfer_tpu_torch.tools.convert_checkpoints \\
        --kind dmsct --torch_ckpt epoch=72-step=7665.ckpt --out dmsct_port

``--out`` is a checkpoint directory (``state.pt``, ``meta.json``) that
``test --ckpt_path``, ``validate --ckpt_path`` and ``predict --ckpt_path``
restore (run/checkpoint.py).
"""

import argparse
import dataclasses
import json
from pathlib import Path

import torch

from color_transfer_tpu_torch.tools.convert_gmflow import float_tensor

# The hyper-parameters the JAX package reads from a reference checkpoint,
# with its defaults (color_transfer_tpu/tools/parity_sweep.py:53-96).
# Reference DMSCT checkpoints carry no matcher hyper-parameters: the GMFlow
# configuration is fixed (6 transformer layers, 6 refinements).
HPARAMS = {
    "dmsct": {"encoder_name": "efficientnet-b2", "encoder_depth": 4,
              "decoder_channels": (256, 128, 64, 32), "matcher_num_layers": 6,
              "matcher_num_reg_refine": 6},
    "dcmcs3di": {"extraction_layers": 18, "transfer_layers": 6, "channels": 64},
}
# Reference keys of modules the port does not build (dropped, listed); a
# transformer layer past the model's count is not one of them.
_UNBUILT = ("encoder._blocks.", "encoder._conv_head.", "encoder._bn1.", "matcher.")


def _unbuilt(key):
    return key.startswith(_UNBUILT) and not key.startswith("matcher.transformer.")


@dataclasses.dataclass
class ReferenceCheckpoint:
    kind: str          # "dmsct" or "dcmcs3di"
    state_dict: dict   # the model's, strict (float32 CPU tensors)
    hparams: dict      # HPARAMS[kind]'s keys
    dropped: list      # reference keys the port does not build


def kind_of(state_dict):
    """"dmsct" or "dcmcs3di" from a reference state_dict's keys."""
    if any(k.startswith("matcher.backbone.") for k in state_dict):
        return "dmsct"
    if any(k.startswith("extraction.") for k in state_dict):
        return "dcmcs3di"
    raise ValueError("neither a DMSCT nor a DCMCS3DI state_dict")


def module_for(kind, hparams, **kwargs):
    """The port's module (run/modules.py) of ``kind`` with ``hparams``."""
    from color_transfer_tpu_torch.run.modules import DCMCS3DIModule, DMSCTModule

    cls = DMSCTModule if kind == "dmsct" else DCMCS3DIModule
    return cls(**{**hparams, **kwargs})


def model_template(kind, hparams):
    """{key: tensor on the meta device} of the port's model."""
    from color_transfer_tpu_torch.models.dcmcs3di import DCMCS3DI
    from color_transfer_tpu_torch.models.dmsct import DMSCT

    with torch.device("meta"):
        model = DMSCT(**hparams) if kind == "dmsct" else DCMCS3DI(**hparams)
    return model.state_dict()


def strict_state_dict(state_dict, kind, hparams):
    """(the model's state_dict, dropped keys) from a reference state_dict:
    every model key with its shape (BatchNorm's ``num_batches_tracked`` is 0
    where the file has none); a reference key the port does not build is
    dropped; any other key, a missing key or a wrong shape raises."""
    template = model_template(kind, hparams)
    out, missing = {}, []
    for k, ref in template.items():
        if k in state_dict:
            value = state_dict[k]
            out[k] = (torch.as_tensor(value).to(torch.long) if ref.dtype == torch.long
                      else float_tensor(value))
        elif k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.long)
        else:
            missing.append(k)
        if k in out and tuple(out[k].shape) != tuple(ref.shape):
            raise ValueError(f"{k} is {tuple(out[k].shape)}, the port's {kind} has "
                             f"{tuple(ref.shape)}")
    extra = sorted(set(state_dict) - set(template))
    unknown = [k for k in extra if kind != "dmsct" or not _unbuilt(k)]
    if missing or unknown:
        raise KeyError(f"not a reference {kind} state_dict at these hyper-parameters: "
                       f"missing {missing[:5]}, unknown {unknown[:5]}")
    return out, extra


def load_reference_ckpt(path, kind=None):
    """A reference Lightning ``.ckpt`` -> ReferenceCheckpoint (``kind``
    from the keys when None)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["state_dict"]
    kind = kind or kind_of(sd)
    given = ckpt.get("hyper_parameters", {}) or {}
    hparams = {k: given.get(k, v) for k, v in HPARAMS[kind].items()}
    if "decoder_channels" in hparams:
        hparams["decoder_channels"] = tuple(hparams["decoder_channels"])
    state_dict, dropped = strict_state_dict(sd, kind, hparams)
    return ReferenceCheckpoint(kind, state_dict, hparams, dropped)


def write_checkpoint(ckpt, out_dir):
    """A checkpoint directory of the port's layout (run/checkpoint.py)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.save({"variables": ckpt.state_dict, "step": 0}, out_dir / "state.pt")
    hparams = {k: list(v) if isinstance(v, tuple) else v for k, v in ckpt.hparams.items()}
    (out_dir / "meta.json").write_text(json.dumps({"step": 0, "epoch": None,
                                                   "hparams": hparams}))
    return out_dir


def main(argv=None):
    parser = argparse.ArgumentParser(description="a reference Lightning .ckpt -> a "
                                     "checkpoint directory of the port")
    parser.add_argument("--kind", choices=["dcmcs3di", "dmsct"], required=True)
    parser.add_argument("--torch_ckpt", required=True)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    ckpt = load_reference_ckpt(args.torch_ckpt, args.kind)
    write_checkpoint(ckpt, args.out)
    print(f"wrote {args.out}: {len(ckpt.state_dict)} tensors, hyper-parameters "
          f"{ckpt.hparams}, {len(ckpt.dropped)} reference keys the port does not build")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
