"""Method registry — every classical transfer method addressable by name;
port of color_transfer_tpu/methods/__init__.py, with the same names and the
reference's aliases. ``get_method`` also takes the reference's dotted
func_spec tails (``methods.linear.color_transfer_between_images``).

A registered method maps (H, W, 3) target and reference tensors in [0, 1]
to the corrected (H, W, 3) image. Where it has a ``batched`` attribute (the
built-in methods do), the video path runs a whole chunk of frames through
it; otherwise frame by frame.
"""

from color_transfer_tpu_torch.methods import iterative, linear

_REGISTRY = {}


def register(name, fn=None):
    """Register a transfer method under ``name`` (usable as decorator)."""
    if fn is None:
        return lambda f: register(name, f)
    if name in _REGISTRY and _REGISTRY[name] is not fn:
        raise ValueError(f"method {name!r} already registered")
    _REGISTRY[name] = fn
    return fn


def get_method(name):
    """Resolve a method by registry name or dotted func_spec tail."""
    key = name if name in _REGISTRY else name.rsplit(".", 1)[-1]
    if key not in _REGISTRY:
        raise KeyError(f"unknown method {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def available_methods():
    return sorted(_REGISTRY)


register("reinhard", linear.reinhard)
register("color_transfer_between_images", linear.reinhard)

register("correlated_color_space", linear.correlated_color_space)
register("color_transfer_in_correlated_color_space", linear.correlated_color_space)

register("monge_kantorovitch", linear.monge_kantorovitch)
register("monge_kantorovitch_color_transfer", linear.monge_kantorovitch)

register("idt", iterative.iterative_distribution_transfer)
register("iterative_distribution_transfer", iterative.iterative_distribution_transfer)

register("automated_color_grading", iterative.automated_color_grading)


def color_transfer_between_videos(*args, **kwargs):
    from color_transfer_tpu_torch.methods.video import color_transfer_between_videos as fn

    return fn(*args, **kwargs)


__all__ = [
    "register",
    "get_method",
    "available_methods",
    "color_transfer_between_videos",
    "linear",
    "iterative",
]
