"""Tensor parallelism for the matcher transformer — the port of
color_transfer_tpu/parallel/tensor_parallel.py on ``torch.distributed``.

The transformer's projection and FFN weights shard over a ``model`` axis of
ranks in the Megatron pairing: column-parallel producers (``q_proj``,
``k_proj``, ``v_proj`` and ``mlp.0`` split on their output features)
feeding row-parallel consumers (``merge`` and ``mlp.2`` split on their
input features). Everything else replicates. A torch ``Linear.weight`` is
(out, in), so a column slice splits dim 0 and a row slice dim 1.

The JAX package leaves the collectives to GSPMD; here the transformer
writes them out where GSPMD inserts them, when it runs inside
``tensor_parallel(axis)``:
  * GMFlow's attention has one head, so column-parallel q and k split the
    scores' contraction. The layer gathers q and k over the axis (two
    (tokens, C) f32 tensors: 59 MB a frame at the 1080p matcher's 1/4
    scale, 57,344 tokens) rather than summing partial scores ((windows, L,
    L): 103 MB, 128 windows of 448 tokens), and computes the whole scores
    and softmax on every rank; v stays sliced, so each rank's message holds
    its channels;
  * after ``merge`` and ``mlp.2`` (row-parallel) the partial products are
    summed over the axis. In a reduced-precision recipe each partial is
    summed in f32 and the sum rounded once, where the unsharded product
    rounds.
The fused window kernels take whole weight matrices, so under tensor
parallelism the layers run unfused: ``fused_attention="auto"`` takes the
unfused route and ``fused_attention=True`` raises.

At this model's size (d_model 128) tensor parallelism meets no memory wall;
it splits one frame's transformer over several cards.
"""

import contextlib
import contextvars

COLUMN = ("q_proj", "k_proj", "v_proj", "mlp.0")
ROW = ("merge", "mlp.2")

_TP = contextvars.ContextVar("color_transfer_tpu_torch_tensor_parallel", default=None)


def current_axis():
    """The ``model`` mesh axis of the tensor-parallel call running, or None."""
    return _TP.get()


@contextlib.contextmanager
def tensor_parallel(axis):
    """Run the matcher transformer's layers on this rank's weight slices
    over ``axis`` (a parallel.mesh ``Axis``, e.g. ``process_mesh(...)
    ["model"]``), with the collectives written out."""
    token = _TP.set(axis)
    try:
        yield axis
    finally:
        _TP.reset(token)


def _layer_name(name):
    """The transformer projection a state_dict key is the weight of
    (``q_proj``, ..., ``mlp.0``), or None."""
    parts = name.split(".")
    if "transformer" not in parts or parts[-1] != "weight":
        return None
    if parts[-3] == "mlp":
        return "mlp." + parts[-2]
    return parts[-2]


def matcher_tp_specs(state_dict):
    """name -> "column", "row" or "replicated" for a GMFlow / UniMatchFlow
    (or DMSCT: the ``matcher.`` prefix) state_dict."""
    specs = {}
    for name, value in state_dict.items():
        layer = _layer_name(name) if value.ndim == 2 else None
        specs[name] = ("column" if layer in COLUMN else "row" if layer in ROW
                       else "replicated")
    return specs


def shard_matcher_state(state_dict, axis):
    """This rank's variables: the column- and row-parallel weights cut to
    the rank's slice along ``axis``, every other tensor as it is. A sliced
    dimension must divide by the axis's size."""
    out = {}
    for name, spec in matcher_tp_specs(state_dict).items():
        value = state_dict[name]
        if spec != "replicated":
            dim = 0 if spec == "column" else 1
            if value.shape[dim] % axis.size:
                raise ValueError(f"{name}: {value.shape[dim]} features do not split over "
                                 f"{axis.size} ranks")
            value = value.chunk(axis.size, dim=dim)[axis.index]
        out[name] = value
    return out
