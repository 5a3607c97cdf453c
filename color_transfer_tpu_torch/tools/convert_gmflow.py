"""Readers of GMFlow matcher weights for the port — port of
color_transfer_tpu/tools/convert_gmflow.py.

The port's GMFlow keeps unimatch's parameter names (models/gmflow.py), so
reading the published checkpoint is a key map with checks, not a
transpose. ``load_matcher(path)`` reads the three formats that DMSCT's
``matcher_checkpoint`` accepts and returns the matcher's state_dict (keys
without the ``matcher.`` prefix, float32 CPU tensors):

  * unimatch's ``.pth`` (``gmflow-scale2-regrefine6-mixdata-*.pth``): a
    torch file whose ``model`` entry (or the file itself, as the JAX
    converter reads it) is the whole unimatch state_dict; only the keys the
    flow model uses are kept (the upsampler and any other head are not);
  * the JAX converter's pickle of its flax tree (``{"core": {...}}``,
    written by ``python -m color_transfer_tpu.tools.convert_gmflow``):
    mapped back to unimatch's names (tools/convert.py's inverse maps); a
    leaf the map does not read raises;
  * a state_dict of the port's (what this module's CLI writes), with or
    without the ``matcher.`` prefix; an unknown key raises.

    python -m color_transfer_tpu_torch.tools.convert_gmflow \\
        --torch_ckpt gmflow-scale2-regrefine6-mixdata-*.pth --out gmflow_port.pt
"""

import argparse
import pickle
import zipfile

import numpy as np
import torch

PREFIX = "matcher."


def num_layers_of(keys):
    """The transformer's layer count from ``transformer.layers.N`` keys."""
    return 1 + max(int(k.split(".")[2]) for k in keys if k.startswith("transformer.layers."))


def matcher_template(num_layers):
    """{key: shape} of the port's GMFlow with ``num_layers`` transformer
    layers (built on the meta device: no weights are allocated)."""
    from color_transfer_tpu_torch.models.gmflow import GMFlow

    with torch.device("meta"):
        model = GMFlow(num_transformer_layers=num_layers)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def float_tensor(value):
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32))


def gmflow_state_dict(sd):
    """A unimatch state_dict (tensors or numpy arrays) -> the port's GMFlow
    state_dict: the keys the flow model uses, each checked for its shape;
    a missing one raises."""
    template = matcher_template(num_layers_of(sd))
    missing = sorted(set(template) - set(sd))
    if missing:
        raise KeyError(f"not a GMFlow state_dict: missing {missing[:5]}")
    out = {k: float_tensor(sd[k]) for k in template}
    for k, shape in template.items():
        if tuple(out[k].shape) != shape:
            raise ValueError(f"{k} is {tuple(out[k].shape)}, GMFlow has {shape}")
    return out


class _Tracked(dict):
    """A dict that records which of its keys were read, recursively."""

    def __init__(self, tree, path=""):
        super().__init__({k: _Tracked(v, f"{path}/{k}") if isinstance(v, dict) else v
                          for k, v in tree.items()})
        self.path = path
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)

    def unread(self):
        out = []
        for k, v in self.items():
            if k not in self.read:
                out.append(f"{self.path}/{k}")
            elif isinstance(v, _Tracked):
                out += v.unread()
        return out


def from_jax_tree(params):
    """The JAX converter's flax tree of GMFlow (``{"core": {...}}``, numpy
    leaves) -> the port's state_dict; a leaf the inverse map does not read
    raises."""
    from color_transfer_tpu_torch.tools.convert import _gmflow, _StateDict

    tree = _Tracked(params)
    sd = _StateDict()
    _gmflow(sd, "", tree["core"])
    unread = tree.unread()
    if unread:
        raise KeyError(f"unexpected params in the flax tree: {unread[:5]}")
    return gmflow_state_dict(dict(sd))


def load_unimatch(path):
    """unimatch's ``.pth`` -> the port's GMFlow state_dict (the flow
    model's keys of ``ckpt.get("model", ckpt)``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return gmflow_state_dict(ckpt.get("model", ckpt))


def load_matcher(path):
    """The matcher's state_dict (no prefix) from any of the three formats
    (module docstring)."""
    if not zipfile.is_zipfile(path):  # torch.save writes a zip archive
        with open(path, "rb") as f:
            return from_jax_tree(pickle.load(f))
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in ckpt:
        return gmflow_state_dict(ckpt["model"])
    return {k.removeprefix(PREFIX): float_tensor(v) for k, v in ckpt.items()}


def main(argv=None):
    parser = argparse.ArgumentParser(description="unimatch GMFlow .pth -> the port's "
                                     "matcher state_dict (DMSCT's matcher_checkpoint)")
    parser.add_argument("--torch_ckpt", required=True)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    sd = load_unimatch(args.torch_ckpt)
    torch.save(sd, args.out)
    print(f"wrote {args.out} ({len(sd)} tensors, {num_layers_of(sd)} transformer layers)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
