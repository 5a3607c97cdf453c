"""Weight bridge: the JAX package's DMSCT and DCMCS3DI variables -> this
port's state_dicts.

The port names its parameters in the reference torch layout (unimatch,
efficientnet-pytorch, smp, pasmnet), the layout color_transfer_tpu's
``tools/convert_checkpoints.convert_dmsct`` and ``convert_dcmcs3di`` map
onto the JAX tree; this module is those maps' inverse, written against
plain nested dicts of numpy arrays so it needs nothing from the JAX
package:

    params, batch_stats  (flax trees, numpy leaves)
        -> dmsct_state_dict_from_jax -> {name: torch.Tensor}
        -> DMSCT.load_state_dict(..., strict=True)
    params -> dcmcs3di_state_dict_from_jax -> DCMCS3DI.load_state_dict

Layout transforms: flax conv (kh, kw, I, O) -> torch (O, I, kh, kw) (the
depthwise (kh, kw, 1, C) -> (C, 1, kh, kw) is the same transpose); flax
dense (I, O) -> torch (O, I); LayerNorm / BatchNorm scale -> weight; BN
mean/var -> running_mean/running_var.
"""

import numpy as np
import torch

from color_transfer_tpu_torch.models.efficientnet import (
    _B0_STAGES,
    _COEFFS,
    _TAPS,
    round_repeats,
)


class _StateDict(dict):
    def put(self, key, array):
        self[key] = torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32))

    def conv(self, key, mod):
        self.put(f"{key}.weight", np.transpose(np.asarray(mod["kernel"]), (3, 2, 0, 1)))
        if "bias" in mod:
            self.put(f"{key}.bias", mod["bias"])

    def dense(self, key, mod):
        self.put(f"{key}.weight", np.transpose(np.asarray(mod["kernel"])))
        if "bias" in mod:
            self.put(f"{key}.bias", mod["bias"])

    def norm(self, key, mod):
        self.put(f"{key}.weight", mod["scale"])
        self.put(f"{key}.bias", mod["bias"])

    def batch_norm(self, key, params, stats):
        self.norm(key, params["BatchNorm_0"])
        self.put(f"{key}.running_mean", stats["BatchNorm_0"]["mean"])
        self.put(f"{key}.running_var", stats["BatchNorm_0"]["var"])
        self[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _gmflow(sd, prefix, core):
    bb = core["backbone"]
    sd.conv(f"{prefix}backbone.conv1", bb["conv1"])
    sd.conv(f"{prefix}backbone.conv2", bb["conv2"])
    sd.conv(f"{prefix}backbone.trident_conv", {"kernel": bb["trident_kernel"]})
    for name in ("layer1", "layer2", "layer3"):
        for i in range(2):
            blk = bb[f"{name}_{i}"]
            base = f"{prefix}backbone.{name}.{i}"
            sd.conv(f"{base}.conv1", blk["conv1"])
            sd.conv(f"{base}.conv2", blk["conv2"])
            if "downsample_conv" in blk:
                sd.conv(f"{base}.downsample.0", blk["downsample_conv"])

    layers = core["transformer"]
    for i in range(len(layers)):
        layer = layers[f"layer_{i}"]
        for sub, with_ffn in (("self_attn", False), ("cross_attn_ffn", True)):
            mod = layer[sub]
            base = f"{prefix}transformer.layers.{i}.{sub}"
            for proj in ("q_proj", "k_proj", "v_proj", "merge"):
                sd.dense(f"{base}.{proj}", mod[proj])
            sd.norm(f"{base}.norm1", mod["norm1"])
            if with_ffn:
                sd.dense(f"{base}.mlp.0", mod["mlp_0"])
                sd.dense(f"{base}.mlp.2", mod["mlp_2"])
                sd.norm(f"{base}.norm2", mod["norm2"])

    for proj in ("q_proj", "k_proj"):
        sd.dense(f"{prefix}feature_flow_attn.{proj}", core["feature_flow_attn"][proj])
    sd.conv(f"{prefix}refine_proj", core["refine_proj"])
    refine = core["refine"]
    for name in ("convc1", "convc2", "convf1", "convf2", "conv"):
        sd.conv(f"{prefix}refine.encoder.{name}", refine["encoder"][name])
    for name in ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2"):
        sd.conv(f"{prefix}refine.gru.{name}", refine["gru"][name])
    sd.conv(f"{prefix}refine.flow_head.conv1", refine["flow_head"]["conv1"])
    sd.conv(f"{prefix}refine.flow_head.conv2", refine["flow_head"]["conv2"])
    sd.conv(f"{prefix}refine.mask.0", refine["mask_0"])
    sd.conv(f"{prefix}refine.mask.2", refine["mask_2"])


def _efficientnet(sd, prefix, params, stats, name_variant, depth):
    _, depth_c = _COEFFS[name_variant]
    sd.conv(f"{prefix}._conv_stem", params["stem_conv"])
    sd.batch_norm(f"{prefix}._bn0", params["stem_bn"], stats["stem_bn"])
    flat, produced = 0, 2  # input + the stem tap
    for stage_idx, (_, _, expand, _, base_r) in enumerate(_B0_STAGES):
        if produced >= depth + 1:
            break
        for r in range(round_repeats(base_r, depth_c)):
            p, st = params[f"stage{stage_idx}_block{r}"], stats[f"stage{stage_idx}_block{r}"]
            base = f"{prefix}._blocks.{flat}"
            if expand != 1:
                sd.conv(f"{base}._expand_conv", p["expand_conv"])
                sd.batch_norm(f"{base}._bn0", p["bn0"], st["bn0"])
            sd.conv(f"{base}._depthwise_conv", p["depthwise_conv"])
            sd.batch_norm(f"{base}._bn1", p["bn1"], st["bn1"])
            sd.conv(f"{base}._se_reduce", p["se_reduce"])
            sd.conv(f"{base}._se_expand", p["se_expand"])
            sd.conv(f"{base}._project_conv", p["project_conv"])
            sd.batch_norm(f"{base}._bn2", p["bn2"], st["bn2"])
            flat += 1
        if stage_idx in _TAPS and _TAPS[stage_idx] <= depth:
            produced += 1


def dmsct_state_dict_from_jax(params, batch_stats, encoder_name="efficientnet-b2",
                              encoder_depth=4):
    """JAX DMSCT variables (params, batch_stats as nested dicts of arrays) ->
    state_dict of models.dmsct.DMSCT (float32 CPU tensors)."""
    sd = _StateDict()
    _gmflow(sd, "matcher.", params["matcher"]["core"])
    _efficientnet(sd, "encoder", params["encoder"], batch_stats["encoder"],
                  encoder_name, encoder_depth)
    for i in range(len(params["decoder"])):
        blk = params["decoder"][f"block{i}"]
        sd.conv(f"decoder.blocks.{i}.conv1.0", blk["conv1"])
        sd.conv(f"decoder.blocks.{i}.conv2.0", blk["conv2"])
    sd.conv("head.0", params["head"]["conv"])
    return dict(sd)


def _resb(sd, key, mod):
    """A ResB's Conv_0 / Conv_1 (each a layers.Conv around nn.Conv) ->
    body.0 / body.2."""
    sd.conv(f"{key}.body.0", mod["Conv_0"]["Conv_0"])
    sd.conv(f"{key}.body.2", mod["Conv_1"]["Conv_0"])


def dcmcs3di_state_dict_from_jax(params):
    """JAX DCMCS3DI params (nested dicts of arrays) -> state_dict of
    models.dcmcs3di.DCMCS3DI (float32 CPU tensors); the layer counts are
    read from the tree."""
    sd = _StateDict()
    ext, mat, tra = params["extraction"], params["matcher"], params["transfer"]
    sd.conv("extraction.0", ext["Conv_0"]["Conv_0"])
    for i in range(sum(k.startswith("ResB_") for k in ext)):
        _resb(sd, f"extraction.{i + 1}", ext[f"ResB_{i}"])
    _resb(sd, "matcher.head", mat["head"])
    for name in ("query", "key", "value"):
        sd.conv(f"matcher.{name}", mat[name]["Conv_0"])
    n = sum(k.startswith("ResB_") for k in tra)
    sd.conv("transfer.0", tra["Conv_0"]["Conv_0"])
    for i in range(n):
        _resb(sd, f"transfer.{i + 1}", tra[f"ResB_{i}"])
    sd.conv(f"transfer.{n + 1}", tra["Conv_1"]["Conv_0"])
    sd.conv(f"transfer.{n + 2}", tra["Conv_2"]["Conv_0"])
    return dict(sd)
