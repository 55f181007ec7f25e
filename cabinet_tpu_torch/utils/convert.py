"""Weight bridge: JAX variables -> the port's torch state dict, for both
model families.

Carries its own copy of the key table of `cabinet_tpu.utils.torch_convert`
(`cabinet_mapping` and its helpers), so the port needs nothing of the JAX
package, and a table of YOLO-sem built from its variant
(`yolosem_mapping`: the port's module names are the flax paths, joined by
dots). Transforms: conv HWIO -> OIHW (depthwise (kH,kW,1,C) -> (C,1,kH,kW)
is the same transpose), dense (in,out) -> (out,in), BatchNorm
scale/bias/mean/var -> weight/bias/running_mean/running_var.

The same tables name the int8 sites both ways (`site_keys`,
`jax_site_keys`, `port_module_names`): the JAX package keys its activation
scales by `"/".join(mod.path)` of each conv, the port by the conv's module
name.
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


def yolosem_mapping(variant: str) -> List[MapEntry]:
    """YOLO-sem's state-dict mapping for a variant (the module tree of
    `cabinet_tpu.models.yolosem.YOLOSem`): every ConvBNSiLU's `conv` and
    `bn`, and the two class heads' kernels and biases."""
    from cabinet_tpu_torch.models.yolosem import YOLOSEM_VARIANTS, _depth

    d, _, _, deep = YOLOSEM_VARIANTS[variant]

    def c2f(name: str, n: int) -> List[str]:
        inner = [f"{name}.m{i}.{cv}" for i in range(n) for cv in ("cv1", "cv2")]
        return [f"{name}.cv1", *inner, f"{name}.cv2"]

    blocks = (["stem", "down2", *c2f("c2f_2", _depth(d, 3)), "down3",
               *c2f("c2f_3", _depth(d, 6)), "down4", *c2f("c2f_4", _depth(d, 6)),
               "down5", *c2f("c2f_5", _depth(d, 3) + deep), "sppf.cv1", "sppf.cv2",
               *c2f("fpn_4", _depth(d, 3)), *c2f("fpn_3", _depth(d, 3)),
               "head0", "head1", "head2", "aux1"])
    e: List[MapEntry] = []
    for name in blocks:
        e += _conv_bn_relu(name, tuple(name.split(".")))
    for head in ("classifier", "aux_classifier"):
        e += _conv(f"{head}.weight", (head, "kernel"))
        e.append((f"{head}.bias", (head, "bias"), PARAM))
    return e


def _site_keys(mapping: List[MapEntry]) -> Dict[str, str]:
    return {torch_key[:-len(".weight")]: "/".join(flax_path[:-1])
            for torch_key, flax_path, kind in mapping if kind == CONV}


def jax_site_keys(cfgs: Sequence[Sequence[float]]) -> Dict[str, str]:
    """{port conv module name: JAX site key} of a CABiNet, e.g.
    "sb.conv_out.conv" -> "sb/conv_out/conv", "mobile.features.1.conv.0" ->
    "mobile/block_0/dw": the conv's kernel path in the table without its
    last part."""
    return _site_keys(cabinet_mapping(cfgs))


def yolosem_site_keys(variant: str) -> Dict[str, str]:
    """{port conv module name: JAX site key} of a YOLO-sem variant, e.g.
    "c2f_2.m0.cv1.conv" -> "c2f_2/m0/cv1/conv"."""
    return _site_keys(yolosem_mapping(variant))


def _is_yolosem(model: Any) -> bool:
    from cabinet_tpu_torch.models.yolosem import YOLOSem

    return isinstance(model, YOLOSem)


def site_keys(model: Any) -> Dict[str, str]:
    """{port conv module name: JAX site key} of a CABiNet or a YOLOSem."""
    return yolosem_site_keys(model.variant) if _is_yolosem(model) else jax_site_keys(model.cfgs)


def port_module_names(cfgs: Sequence[Sequence[float]]) -> Dict[str, str]:
    """{JAX site key: port conv module name} of a CABiNet, the inverse of
    `jax_site_keys`."""
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
    return _state_dict(variables, cabinet_mapping(cfgs))


def yolosem_state_dict_from_jax(variables: Mapping[str, Any],
                                variant: str = "n") -> Dict[str, torch.Tensor]:
    """JAX YOLOSem variables (numpy arrays, nested or flat) -> the port's
    state dict, which `YOLOSem.load_state_dict(strict=True)` accepts."""
    return _state_dict(variables, yolosem_mapping(variant))


def model_state_dict_from_jax(variables: Mapping[str, Any], model: Any
                              ) -> Dict[str, torch.Tensor]:
    """The state dict for `model`, a CABiNet or a YOLOSem, from JAX variables."""
    if _is_yolosem(model):
        return yolosem_state_dict_from_jax(variables, model.variant)
    return state_dict_from_jax(variables, model.cfgs)


def _state_dict(variables: Mapping[str, Any], mapping: List[MapEntry]
                ) -> Dict[str, torch.Tensor]:
    tree = _nested(variables)
    params, stats = tree["params"], tree.get("batch_stats", {})
    out: Dict[str, torch.Tensor] = {}
    for torch_key, flax_path, kind in mapping:
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


# ---------------------------------------------------------------------------
# The other direction, numpy only: the counterparts of the JAX package's
# `torch_to_flax` (utils/torch_convert.py:196) and `flax_to_torch` (:257)
# ---------------------------------------------------------------------------


def _np(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _set_path(tree: Dict[str, Any], path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for part in path[:-1]:
        node = node.setdefault(part, {})
    node[path[-1]] = value


def jax_variables_from_state_dict(state_dict: Mapping[str, Any],
                                  cfgs: Sequence[Sequence[float]],
                                  strict: bool = True) -> Dict[str, Any]:
    """A reference (or the port's) CABiNet state dict -> JAX variables
    {"params": ..., "batch_stats": ...} of numpy arrays, as
    `cabinet_tpu.utils.torch_convert.torch_to_flax` gives them. With
    strict=False, missing keys are skipped; with strict=True they raise, as
    does a key the table does not consume (the backbone's ImageNet
    classifier and the BN step counters aside)."""
    from cabinet_tpu_torch.core.exceptions import ModelLoadError

    sd = {k: _np(v) for k, v in state_dict.items()}
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    consumed = set()
    for torch_key, flax_path, kind in cabinet_mapping(cfgs):
        if kind == BN:
            names = {"scale": f"{torch_key}.weight", "bias": f"{torch_key}.bias",
                     "mean": f"{torch_key}.running_mean", "var": f"{torch_key}.running_var"}
            missing = [k for k in names.values() if k not in sd]
            if missing:
                if strict:
                    raise ModelLoadError(f"Missing BN tensors: {missing}")
                continue
            _set_path(params, flax_path + ("scale",), sd[names["scale"]])
            _set_path(params, flax_path + ("bias",), sd[names["bias"]])
            _set_path(stats, flax_path + ("mean",), sd[names["mean"]])
            _set_path(stats, flax_path + ("var",), sd[names["var"]])
            consumed.update(names.values())
            continue
        if torch_key not in sd:
            if strict:
                raise ModelLoadError(f"Missing torch key: {torch_key}")
            continue
        tensor = sd[torch_key]
        consumed.add(torch_key)
        if kind == CONV:
            tensor = tensor.transpose(2, 3, 1, 0)
        elif kind == LINEAR:
            tensor = tensor.transpose(1, 0)
        _set_path(params, flax_path, tensor)
    if strict:
        leftovers = [k for k in sd if k not in consumed
                     and not k.startswith("mobile.classifier")
                     and "num_batches_tracked" not in k]
        if leftovers:
            raise ModelLoadError(f"Unconsumed torch keys: {leftovers[:8]}")
    return {"params": params, "batch_stats": stats}


def reference_state_dict(variables: Mapping[str, Any],
                         cfgs: Sequence[Sequence[float]]) -> Dict[str, np.ndarray]:
    """JAX CABiNet variables (nested or flat) -> a reference-compatible
    state dict of numpy arrays, in the table's order and without BN step
    counters, as `cabinet_tpu.utils.torch_convert.flax_to_torch` gives it."""
    tree = _nested(variables)
    params, stats = tree["params"], tree.get("batch_stats", {})

    def get(coll: Mapping[str, Any], path: Tuple[str, ...]) -> np.ndarray:
        node: Any = coll
        for part in path:
            node = node[part]
        return _np(node)  # dtype kept, as flax_to_torch keeps it

    out: Dict[str, np.ndarray] = {}
    for torch_key, flax_path, kind in cabinet_mapping(cfgs):
        if kind == BN:
            for name, coll, leaf in (("weight", params, "scale"), ("bias", params, "bias"),
                                     ("running_mean", stats, "mean"),
                                     ("running_var", stats, "var")):
                out[f"{torch_key}.{name}"] = get(coll, flax_path + (leaf,))
            continue
        tensor = get(params, flax_path)
        if kind == CONV:
            tensor = tensor.transpose(3, 2, 0, 1)
        elif kind == LINEAR:
            tensor = tensor.transpose(1, 0)
        out[torch_key] = tensor
    return out


def flat_variables(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Nested JAX variables -> the flat "params/a/b" keys of a `.npz`."""
    out: Dict[str, np.ndarray] = {}

    def walk(node: Any, prefix: str) -> None:
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        else:
            out[prefix] = np.ascontiguousarray(np.asarray(node))
    walk(variables, "")
    return out
