"""Weight bridge: JAX CABiNet variables -> the port's torch state dict.

Carries its own copy of the key table of `cabinet_tpu.utils.torch_convert`
(`cabinet_mapping` and its helpers), so the port needs nothing of the JAX
package. Transforms: conv HWIO -> OIHW (depthwise (kH,kW,1,C) -> (C,1,kH,kW)
is the same transpose), dense (in,out) -> (out,in), BatchNorm
scale/bias/mean/var -> weight/bias/running_mean/running_var.

The same table names the int8 sites both ways (`jax_site_keys`,
`port_module_names`): the JAX package keys its activation scales by
`"/".join(mod.path)` of each conv, the port by the conv's module name.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from cabinet_tpu_torch.models.layers import make_divisible

# Entry kinds describe the tensor transform between frameworks.
CONV = "conv"        # OIHW <-> HWIO
LINEAR = "linear"    # (out,in) <-> (in,out)
BN = "bn"            # 4 tensors: weight,bias,running_mean,running_var
PARAM = "param"      # copied as-is (e.g. CAB gamma, biases)

MapEntry = Tuple[str, Tuple[str, ...], str]
# (torch_prefix, flax_path (under params/ or batch_stats/), kind)


def _bn(torch_prefix: str, flax_path: Tuple[str, ...]) -> List[MapEntry]:
    return [(torch_prefix, flax_path, BN)]


def _conv(torch_key: str, flax_path: Tuple[str, ...]) -> List[MapEntry]:
    return [(torch_key, flax_path, CONV)]


def mobilenetv3_mapping(cfgs: Sequence[Sequence[float]],
                        prefix: str = "mobile.",
                        flax_prefix: Tuple[str, ...] = ("mobile",)) -> List[MapEntry]:
    """Mapping for the MobileNetV3 trunk (torch Sequential indices -> names)."""
    entries: List[MapEntry] = []
    p, fp = prefix, flax_prefix

    # Stem: features.0 = Sequential(conv, bn, act)
    entries += _conv(f"{p}features.0.0.weight", fp + ("stem", "kernel"))
    entries += _bn(f"{p}features.0.1", fp + ("stem_bn",))

    input_channel = make_divisible(16, 8)
    for i, (k, t, c, use_se, use_hs, s) in enumerate(cfgs):
        tp = f"{p}features.{i + 1}.conv"
        bp = fp + (f"block_{i}",)
        hidden = make_divisible(input_channel * t, 8)
        out_ch = make_divisible(c, 8)
        if input_channel == hidden:
            # [0]=dw,[1]=bn,[2]=act,[3]=SE|Id,[4]=pw,[5]=bn
            entries += _conv(f"{tp}.0.weight", bp + ("dw", "kernel"))
            entries += _bn(f"{tp}.1", bp + ("dw_bn",))
            if use_se:
                entries += _se(f"{tp}.3", bp + ("se",))
            entries += _conv(f"{tp}.4.weight", bp + ("project", "kernel"))
            entries += _bn(f"{tp}.5", bp + ("project_bn",))
        else:
            # [0]=pw,[1]=bn,[2]=act,[3]=dw,[4]=bn,[5]=SE|Id,[6]=act,[7]=pw,[8]=bn
            entries += _conv(f"{tp}.0.weight", bp + ("expand", "kernel"))
            entries += _bn(f"{tp}.1", bp + ("expand_bn",))
            entries += _conv(f"{tp}.3.weight", bp + ("dw", "kernel"))
            entries += _bn(f"{tp}.4", bp + ("dw_bn",))
            if use_se:
                entries += _se(f"{tp}.5", bp + ("se",))
            entries += _conv(f"{tp}.7.weight", bp + ("project", "kernel"))
            entries += _bn(f"{tp}.8", bp + ("project_bn",))
        input_channel = out_ch

    # Final 1x1: conv = Sequential(conv, bn, act)
    entries += _conv(f"{p}conv.0.weight", fp + ("head", "kernel"))
    entries += _bn(f"{p}conv.1", fp + ("head_bn",))
    return entries


def _se(torch_prefix: str, flax_path: Tuple[str, ...]) -> List[MapEntry]:
    """SELayer: fc = Sequential(Linear, ReLU, Linear, HardSigmoid)."""
    return [
        (f"{torch_prefix}.fc.0.weight", flax_path + ("fc1", "kernel"), LINEAR),
        (f"{torch_prefix}.fc.0.bias", flax_path + ("fc1", "bias"), PARAM),
        (f"{torch_prefix}.fc.2.weight", flax_path + ("fc2", "kernel"), LINEAR),
        (f"{torch_prefix}.fc.2.bias", flax_path + ("fc2", "bias"), PARAM),
    ]


def _conv_bn_relu(torch_prefix: str, flax_path: Tuple[str, ...]) -> List[MapEntry]:
    """Reference ConvBNReLU: .conv + .bn children."""
    return (_conv(f"{torch_prefix}.conv.weight", flax_path + ("conv", "kernel"))
            + _bn(f"{torch_prefix}.bn", flax_path + ("bn",)))


def _dwconv_block(torch_prefix: str, flax_path: Tuple[str, ...]) -> List[MapEntry]:
    """Reference cab.DWConv: .block.0 conv, .block.1 bn."""
    return (_conv(f"{torch_prefix}.block.0.weight", flax_path + ("conv", "kernel"))
            + _bn(f"{torch_prefix}.block.1", flax_path + ("bn",)))


def cab_mapping(torch_prefix: str, flax_path: Tuple[str, ...]) -> List[MapEntry]:
    """ContextAggregationBlock mapping."""
    e: List[MapEntry] = []
    ga_t, ga_f = f"{torch_prefix}.global_attn", flax_path + ("global_attn",)
    e += _conv(f"{ga_t}.to_query.0.weight", ga_f + ("to_query", "kernel"))
    e += _bn(f"{ga_t}.to_query.1", ga_f + ("query_bn",))
    e += _conv(f"{ga_t}.to_key.0.weight", ga_f + ("to_key", "kernel"))
    e += _bn(f"{ga_t}.to_key.1", ga_f + ("key_bn",))
    e += _conv(f"{ga_t}.to_value.weight", ga_f + ("to_value", "kernel"))
    e += _conv(f"{ga_t}.psp_key.project.weight", ga_f + ("psp_key", "project", "kernel"))
    e += _conv(f"{ga_t}.psp_value.project.weight", ga_f + ("psp_value", "project", "kernel"))
    e += _conv(f"{ga_t}.project_out.weight", ga_f + ("project_out", "kernel"))
    la_t, la_f = f"{torch_prefix}.local_attn", flax_path + ("local_attn",)
    for i in range(3):
        e += _dwconv_block(f"{la_t}.refine.{i}", la_f + (f"refine_{i}",))
    e.append((f"{torch_prefix}.gamma", flax_path + ("gamma",), PARAM))
    return e


def cabinet_mapping(cfgs: Sequence[Sequence[float]]) -> List[MapEntry]:
    """Full CABiNet state-dict mapping (reference cabinet.py module tree)."""
    e: List[MapEntry] = []
    e += mobilenetv3_mapping(cfgs)

    # Spatial branch.
    for name in ("conv1", "conv2", "conv3", "conv_out"):
        e += _conv_bn_relu(f"sb.{name}", ("sb", name))

    # Attention branch.
    e += _conv("ab.conva.0.weight", ("ab", "conva", "kernel"))
    e += _bn("ab.conva.1", ("ab", "conva_bn"))
    e += cab_mapping("ab.a2block", ("ab", "a2block"))
    e += _conv("ab.convb.weight", ("ab", "convb", "kernel"))
    e.append(("ab.convb.bias", ("ab", "convb", "bias"), PARAM))
    e += _conv("ab.b1.weight", ("ab", "b1", "kernel"))
    e += _bn("ab.b2", ("ab", "b2"))
    e += _conv("ab.b4.weight", ("ab", "b4", "kernel"))
    e.append(("ab.b4.bias", ("ab", "b4", "bias"), PARAM))

    # FFM.
    e += _conv_bn_relu("ffm.convblk", ("ffm", "convblk"))
    e += _conv("ffm.conv1.weight", ("ffm", "conv1", "kernel"))
    e += _conv("ffm.conv2.weight", ("ffm", "conv2", "kernel"))

    # Output head.
    e += _conv_bn_relu("conv_out.conv", ("conv_out", "conv"))
    e += _conv("conv_out.conv_out.weight", ("conv_out", "conv_out", "kernel"))
    return e


def jax_site_keys(cfgs: Sequence[Sequence[float]]) -> Dict[str, str]:
    """{port conv module name: JAX site key}, e.g. "sb.conv_out.conv" ->
    "sb/conv_out/conv", "mobile.features.1.conv.0" -> "mobile/block_0/dw":
    the conv's kernel path in the table without its last part."""
    return {torch_key[:-len(".weight")]: "/".join(flax_path[:-1])
            for torch_key, flax_path, kind in cabinet_mapping(cfgs) if kind == CONV}


def port_module_names(cfgs: Sequence[Sequence[float]]) -> Dict[str, str]:
    """{JAX site key: port conv module name}, the inverse of `jax_site_keys`."""
    return {key: name for name, key in jax_site_keys(cfgs).items()}


def _nested(variables: Mapping[str, Any]) -> Dict[str, Any]:
    """Accept nested {"params": ..., "batch_stats": ...} or the flat
    "params/a/b" keys of an npz fixture."""
    if "params" in variables:
        return dict(variables)
    tree: Dict[str, Any] = {}
    for key, value in variables.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def _get(tree: Mapping[str, Any], path: Tuple[str, ...]) -> torch.Tensor:
    node: Any = tree
    for part in path:
        node = node[part]
    arr = np.asarray(node)
    if arr.dtype == np.float16:  # fixtures store f32 weights as f16
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr))


def state_dict_from_jax(variables: Mapping[str, Any],
                        cfgs: Sequence[Sequence[float]]) -> Dict[str, torch.Tensor]:
    """JAX CABiNet variables (numpy arrays, nested or flat) -> the port's
    state dict, which `CABiNet.load_state_dict(strict=True)` accepts."""
    tree = _nested(variables)
    params, stats = tree["params"], tree.get("batch_stats", {})
    out: Dict[str, torch.Tensor] = {}
    for torch_key, flax_path, kind in cabinet_mapping(cfgs):
        if kind == BN:
            out[f"{torch_key}.weight"] = _get(params, flax_path + ("scale",))
            out[f"{torch_key}.bias"] = _get(params, flax_path + ("bias",))
            out[f"{torch_key}.running_mean"] = _get(stats, flax_path + ("mean",))
            out[f"{torch_key}.running_var"] = _get(stats, flax_path + ("var",))
            out[f"{torch_key}.num_batches_tracked"] = torch.tensor(0)
            continue
        tensor = _get(params, flax_path)
        if kind == CONV:
            tensor = tensor.permute(3, 2, 0, 1)
        elif kind == LINEAR:
            tensor = tensor.t()
        out[torch_key] = tensor.contiguous()
    return out
