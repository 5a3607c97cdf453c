"""YAML configs in the reference's LightningCLI shape — port of
color_transfer_tpu/run/config.py:

    seed_everything: 42
    model: {class_path: ..., init_args: {...}}
    data:  {init_args: {data_dir: ..., ...}}
    trainer: {max_epochs: ..., logger: ..., callbacks: [...]}

plus dotted overrides (``--model.init_args.learning_rate 1e-4``). The
shorthand ``--section.X`` means ``--section.init_args.X`` whenever the
section has a ``class_path`` or an ``init_args`` (the JAX package applies it
only with a ``class_path``, so there ``--data.data_dir`` lands beside
``configs/dmsct.yaml``'s ``data.init_args`` and is not read).
"""

import copy

import yaml

from color_transfer_tpu_torch.run.datamodule import DataModule
from color_transfer_tpu_torch.run.trainer import Trainer

_TRAINER_KEYS = {"max_epochs", "log_every", "seed", "monitor", "use_wandb",
                 "val_every", "log_dir"}


def _module_registry():
    from color_transfer_tpu_torch.run.modules import DMSCTModule

    return {"dmsct": DMSCTModule, "methods.dmsct.DMSCT": DMSCTModule}


def load_config(path=None, overrides=None):
    cfg = {}
    if path is not None:
        with open(path) as f:
            cfg = yaml.safe_load(f) or {}
    for dotted, value in (overrides or {}).items():
        _apply_override(cfg, dotted, value)
    return cfg


def _coerce(value):
    """A command-line value as YAML reads it; numbers YAML 1.1 leaves as
    strings ("1e-4") become floats."""
    if not isinstance(value, str):
        return value
    try:
        value = yaml.safe_load(value)
    except yaml.YAMLError:
        return value
    if isinstance(value, str):
        try:
            return float(value)
        except ValueError:
            pass
    return value


def _apply_override(cfg, dotted, value):
    keys = dotted.lstrip("-").split(".")
    node = cfg
    for i, k in enumerate(keys[:-1]):
        if k not in node or not isinstance(node[k], dict):
            node[k] = {}
        node = node[k]
        if (i == 0 and ("class_path" in node or "init_args" in node)
                and keys[i + 1] not in ("class_path", "init_args")):
            node = node.setdefault("init_args", {})
    node[keys[-1]] = _coerce(value)


def build_module(class_path, init_args=None):
    registry = _module_registry()
    if class_path not in registry:
        raise NotImplementedError(
            f"module {class_path!r}: the port trains and validates "
            f"{sorted(registry)} so far (DCMCS3DI training and the classical "
            "runner are not ported yet)"
        )
    return registry[class_path](**dict(init_args or {}))


def build_from_config(cfg, log_dir=None, device=None):
    """(module, datamodule, trainer) from a config dict; the trainer runs on
    ``device`` (default: the card)."""
    cfg = copy.deepcopy(cfg)
    model_cfg = cfg.get("model", {})
    module = build_module(model_cfg.get("class_path", "classical"),
                          model_cfg.get("init_args", {}))

    data_cfg = cfg.get("data", {})
    data_args = dict(data_cfg.get("init_args", data_cfg if "class_path" not in data_cfg else {}))
    num_workers = data_args.pop("num_workers", None)
    if num_workers is not None:
        data_args["num_workers"] = max(1, int(num_workers))
    datamodule = DataModule(**data_args) if data_args.get("data_dir") else None

    trainer_cfg = dict(cfg.get("trainer", {}))
    logger_cfg = trainer_cfg.pop("logger", None)
    monitor = "Validation PSNR/dataloader_idx_0"
    for cb in trainer_cfg.pop("callbacks", None) or []:
        monitor = (cb or {}).get("init_args", {}).get("monitor", monitor)
    kwargs = {k: v for k, v in trainer_cfg.items() if k in _TRAINER_KEYS}
    kwargs.setdefault("seed", cfg.get("seed_everything", 42))
    kwargs["use_wandb"] = bool(logger_cfg) and logger_cfg not in (False, "false", "False")
    kwargs.setdefault("monitor", monitor)
    if log_dir is not None:
        kwargs["log_dir"] = log_dir
    return module, datamodule, Trainer(**kwargs, device=device)
