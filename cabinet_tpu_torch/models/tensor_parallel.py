"""Tensor parallelism for CABiNet: wide layers' channels split over the
ranks of a model group (counterpart of the JAX package's model-axis
sharding, `cabinet_tpu/core/mesh.py:85-121`, whose collectives GSPMD
inserts; here they are placed by hand, and the math is the replicated
model's).

Which leaves split is JAX's rule (`core/mesh.py:tensor_parallel_spec`) on
each leaf's JAX shape, read through the port's copy of the key table
(`utils/convert.py:cabinet_mapping`): a conv kernel's trailing HWIO dim is
its output channel, dim 0 of the OIHW weight; a dense kernel's is the
output dim of the `nn.Linear`; BatchNorm's scale, bias and statistics and
a bias are per channel. `tensor_parallel(model, mesh)` cuts every such
leaf to this rank's slice of dim 0, in place, and swaps each conv, linear
and BatchNorm for a sharded twin that keeps the module's name, so that
the state dict has the model's keys and the slices' shapes.

The sharded modules pair up as Megatron's do, and find out from the
channels of their input whether it arrives whole or as this rank's
slice:
  - a layer whose weight splits computes its slice of the output
    channels (column-parallel): from a whole input directly, from a slice
    after gathering it (`gather`);
  - per-channel work keeps the slice: BatchNorm (statistics over the data
    group, on this rank's channels), the activations, a depthwise conv,
    the SE gate's product, pooling, resizes (in CABiNet each of these
    follows a conv of its channel count, so its input is split as its
    own leaves are);
  - a layer whose weight is replicated but whose input is a slice uses
    its input-channel slice of the weight and all-reduces the partial
    output over the model group (row-parallel, `reduce`); the weight's
    gradient is then this rank's part only (`row_parallel`);
  - where a slice has to leave whole (a concatenation, the attention's
    q, k and v, the logits), the model's code gathers it
    (`full_channels`).

Every rank of a model group computes the whole loss. So the autograd
functions follow Megatron's f and g: `copy` (identity forward, the
gradient all-reduced over the model group backward) in front of a
column-parallel layer, whose input's gradient is otherwise only this
rank's share; `reduce` (all-reduce forward, identity backward) after a
row-parallel one; and `gather` (all-gather forward, the own slice of
the whole gradient backward). Every collective is an all-reduce over the
model group (an all-gather is one of a zero-padded buffer), tagged
`tp_forward` or `tp_backward`, run in f32.

On CUDA tensors every sharded conv runs its forward and backward with
cuDNN off (`SHARDED_CUDNN`, PyTorch's own convolution kernels;
`bounded_conv2d`): at a rank's shapes cuDNN's heuristic, deterministic
algorithms or not, takes a 16.7 GiB workspace for the split output head's
3x3 (`tp_memory.py --variants`), more than a one-rank step's whole peak.
The flag is set around those convs alone, in both directions.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Optional, Set, Tuple

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from cabinet_tpu_torch.core import mesh as _mesh
from cabinet_tpu_torch.models.layers import BatchNorm2d

DIM = 1  # the channel dim of NCHW activations and of (B, C) features


# ---------------------------------------------------------------------------
# Collectives over the model group, as autograd functions
# ---------------------------------------------------------------------------

def _all_reduce(t: torch.Tensor, m: _mesh.Mesh, tag: str) -> torch.Tensor:
    """The sum over the model group, in f32, back in `t`'s dtype."""
    buf = t.float().clone() if t.dtype != torch.float32 else t.clone()
    _mesh.all_reduce_(buf, tag=tag, group=m.model_group)
    return buf.to(t.dtype)


def _gather(t: torch.Tensor, m: _mesh.Mesh, tag: str) -> torch.Tensor:
    """The whole channels from every rank's slice (exact: the other ranks
    add zeros)."""
    shape = list(t.shape)
    shape[DIM] *= m.n_model
    full = torch.zeros(shape, dtype=torch.float32, device=t.device)
    _mesh.shard_slice(full, DIM, m).copy_(t)
    _mesh.all_reduce_(full, tag=tag, group=m.model_group)
    return full.to(t.dtype)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m):
        ctx.m = m
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.m, "tp_backward"), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m):
        return _all_reduce(x, m, "tp_forward")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m):
        ctx.m = m
        return _gather(x, m, "tp_forward")

    @staticmethod
    def backward(ctx, g):
        return _mesh.shard_slice(g, DIM, ctx.m).contiguous(), None


def copy(x: torch.Tensor, m: _mesh.Mesh) -> torch.Tensor:
    return _Copy.apply(x, m)


def reduce(x: torch.Tensor, m: _mesh.Mesh) -> torch.Tensor:
    return _Reduce.apply(x, m)


def gather(x: torch.Tensor, m: _mesh.Mesh) -> torch.Tensor:
    return _Gather.apply(x, m)


def full_channels(x: torch.Tensor, channels: int, owner: nn.Module) -> torch.Tensor:
    """`x` with all its `channels` channels: as it is when whole or when
    `owner` is not sharded, else gathered over `owner`'s model group."""
    m = getattr(owner, "tp_mesh", None)
    if m is None or x.shape[DIM] == channels:
        return x
    return gather(x, m)


def applied_to(p: torch.Tensor, x: torch.Tensor, channels: int,
               owner: nn.Module) -> torch.Tensor:
    """A replicated parameter `p` as used on `x`: when `x` is a slice of its
    `channels` channels, its gradient is this rank's part only, so it is
    summed over the model group in the backward (`copy`)."""
    m = getattr(owner, "tp_mesh", None)
    if m is None or x.shape[DIM] == channels:
        return p
    return copy(p, m)


# ---------------------------------------------------------------------------
# cuDNN's workspace, kept out of the sharded convs
# ---------------------------------------------------------------------------

SHARDED_CUDNN = {"enabled": False}


@contextlib.contextmanager
def _cudnn(settings):
    """`torch.backends.cudnn`'s flags set to `settings` inside the block
    (the others as they are: TF32 stays as the caller set it)."""
    cudnn = torch.backends.cudnn
    saved = {k: getattr(cudnn, k) for k in settings}
    for k, v in settings.items():
        setattr(cudnn, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(cudnn, k, v)


class _BoundedConv(torch.autograd.Function):
    """F.conv2d whose forward and backward both run under `SHARDED_CUDNN`
    (autocast's dtype applied by hand, as autocast would, since the
    backward runs outside it)."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, dilation, groups):
        dtype = (torch.get_autocast_dtype(x.device.type)
                 if torch.is_autocast_enabled(x.device.type) else x.dtype)
        xs, ws = x.to(dtype), weight.to(dtype)
        bs = None if bias is None else bias.to(dtype)
        with torch.autocast(x.device.type, enabled=False), _cudnn(SHARDED_CUDNN):
            y = F.conv2d(xs, ws, bs, stride, padding, dilation, groups)
        ctx.save_for_backward(xs, ws)
        ctx.conf = (stride, padding, dilation, groups)
        ctx.dtypes = (x.dtype, weight.dtype, None if bias is None else bias.dtype)
        return y

    @staticmethod
    def backward(ctx, g):
        xs, ws = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conf
        has_bias = ctx.dtypes[2] is not None
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                has_bias and ctx.needs_input_grad[2]]
        with _cudnn(SHARDED_CUDNN):
            grads = torch.ops.aten.convolution_backward(
                g.to(xs.dtype), xs, ws, [ws.shape[0]] if has_bias else None, list(stride),
                list(padding), list(dilation), False, [0, 0], groups, mask)
        out = [None if t is None or dt is None else t.to(dt)
               for t, dt in zip(grads, ctx.dtypes)]
        return (*out, None, None, None, None)


def bounded_conv2d(x, weight, bias, stride, padding, dilation, groups) -> torch.Tensor:
    """F.conv2d, under `SHARDED_CUDNN`'s cuDNN flags on CUDA tensors."""
    if not x.is_cuda:
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)
    return _BoundedConv.apply(x, weight, bias, tuple(stride), tuple(padding),
                              tuple(dilation), groups)


# ---------------------------------------------------------------------------
# The sharded modules
# ---------------------------------------------------------------------------

class _Sharded:
    """What a sharded module knows: its mesh, whether its own leaves are
    split (`split`), and the whole channel count of its input (`full_in`),
    by which it tells a slice from a whole input."""

    tp_mesh: _mesh.Mesh
    split: bool
    full_in: int

    def _setup(self, m: _mesh.Mesh, split: bool, full_in: int) -> None:
        self.tp_mesh, self.split, self.full_in = m, bool(split), int(full_in)
        self.row_parallel = False  # set once a forward took a slice into a whole weight

    def sharded_parameters(self) -> List[nn.Parameter]:
        return [p for p in self.parameters(recurse=False)] if self.split else []


class ShardedConv2d(_Sharded, nn.Conv2d):
    """A conv (or depthwise conv) of a tensor-parallel model: with `split`
    its slice of the output channels, else the whole weight; cuDNN's
    workspace kept out on CUDA (`bounded_conv2d`)."""

    def _conv_forward(self, x: torch.Tensor, weight: torch.Tensor, bias) -> torch.Tensor:
        return bounded_conv2d(x, weight, bias, self.stride, self.padding, self.dilation,
                              self.groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self.tp_mesh
        if self.groups > 1:  # depthwise: channel for channel, split as its input
            return self._conv_forward(x, self.weight, self.bias)
        sliced = x.shape[DIM] != self.full_in
        if self.split:  # column-parallel
            return self._conv_forward(copy(gather(x, m) if sliced else x, m),
                                      self.weight, self.bias)
        if not sliced:
            return self._conv_forward(x, self.weight, self.bias)
        self.row_parallel = True
        y = reduce(self._conv_forward(x, _mesh.shard_slice(self.weight, 1, m), None), m)
        return y if self.bias is None else y + self.bias.to(y.dtype)[None, :, None, None]


class ShardedLinear(_Sharded, nn.Linear):
    """An `nn.Linear` of a tensor-parallel model (the SE layers' FCs)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self.tp_mesh
        sliced = x.shape[-1] != self.full_in
        if self.split:
            return F.linear(copy(gather(x, m) if sliced else x, m), self.weight, self.bias)
        if not sliced:
            return F.linear(x, self.weight, self.bias)
        self.row_parallel = True
        y = reduce(F.linear(x, _mesh.shard_slice(self.weight, 1, m)), m)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class ShardedBatchNorm2d(_Sharded, BatchNorm2d):
    """BatchNorm of a tensor-parallel model: with `split` this rank's
    channels (their statistics over the data group, as every BatchNorm's)."""


# ---------------------------------------------------------------------------
# JAX's rule through the key table, and the model cut to its slices
# ---------------------------------------------------------------------------

def jax_leaves(model: nn.Module) -> Dict[str, Tuple[str, Tuple[int, ...], int]]:
    """{state-dict key: (JAX name "params/..." or "batch_stats/...", JAX
    shape, the torch dim that JAX's trailing dim is)} of a whole CABiNet,
    from the key table (`utils/convert.py:cabinet_mapping`)."""
    from cabinet_tpu_torch.utils.convert import BN, CONV, LINEAR, cabinet_mapping

    if not hasattr(model, "cfgs") or not hasattr(model, "mobile"):
        raise ValueError("tensor parallelism covers CABiNet only (the JAX package's "
                         "YOLO-sem main never reads runtime.model_axis)")
    sd = model.state_dict()
    out: Dict[str, Tuple[str, Tuple[int, ...], int]] = {}
    for torch_key, path, kind in cabinet_mapping(model.cfgs):
        name = "/".join(path)
        if kind == BN:
            for suffix, coll, leaf in (("weight", "params", "scale"),
                                       ("bias", "params", "bias"),
                                       ("running_mean", "batch_stats", "mean"),
                                       ("running_var", "batch_stats", "var")):
                key = f"{torch_key}.{suffix}"
                out[key] = (f"{coll}/{name}/{leaf}", tuple(sd[key].shape), 0)
            continue
        shape = tuple(sd[torch_key].shape)
        if kind == CONV:  # OIHW -> HWIO: the trailing dim is O
            out[torch_key] = (f"params/{name}", (shape[2], shape[3], shape[1], shape[0]), 0)
        elif kind == LINEAR:  # (out, in) -> (in, out)
            out[torch_key] = (f"params/{name}", (shape[1], shape[0]), 0)
        else:
            out[torch_key] = (f"params/{name}", shape, len(shape) - 1)
    return out


def sharded_dims(model: nn.Module, n_model: int, min_features: int = 256
                 ) -> Dict[str, Optional[int]]:
    """{state-dict key: the torch dim it splits along, or None} of a whole
    CABiNet under JAX's rule at `n_model`, `min_features`."""
    return {k: (dim if _mesh.tensor_parallel_spec(shape, n_model, min_features) else None)
            for k, (_, shape, dim) in jax_leaves(model).items()}


def _split_of(module: nn.Module, name: str, dims: Mapping[str, Optional[int]]) -> bool:
    """Whether `module`'s own leaves split: all or none of them do, along
    dim 0 (the rule reads one channel count per module)."""
    keys = [f"{name}.{p}" for p, _ in module.named_parameters(recurse=False)]
    got = {dims.get(k) for k in keys}
    if len(got) != 1 or got - {None, 0}:
        raise ValueError(f"{name}: leaves split unevenly {dict((k, dims.get(k)) for k in keys)}")
    return got == {0}


def _sharded_twin(module: nn.Module, split: bool, m: _mesh.Mesh) -> nn.Module:
    w = module.weight
    kw = dict(device=w.device, dtype=w.dtype)
    n = m.n_model if split else 1
    if isinstance(module, nn.Conv2d):
        depthwise = module.groups > 1
        if module.padding_mode != "zeros" or isinstance(module.padding, str):
            raise ValueError(f"conv {module} is not sharded (padding)")
        if depthwise and module.groups != module.in_channels:
            raise ValueError(f"grouped conv {module} is not sharded")
        out_ch = module.out_channels // n
        new = ShardedConv2d(out_ch if depthwise else module.in_channels, out_ch,
                            module.kernel_size, module.stride, module.padding,
                            module.dilation, out_ch if depthwise else 1,
                            module.bias is not None, module.padding_mode, **kw)
        full_in = module.in_channels
    elif isinstance(module, nn.Linear):
        new = ShardedLinear(module.in_features, module.out_features // n,
                            module.bias is not None, **kw)
        full_in = module.in_features
    else:
        new = ShardedBatchNorm2d(module.num_features // n, module.eps, module.momentum,
                                 module.affine, module.track_running_stats, **kw)
        full_in = module.num_features
    with torch.no_grad():
        for key, t in module.state_dict().items():
            cut = split and key != "num_batches_tracked"
            getattr(new, key).copy_(_mesh.shard_slice(t, 0, m) if cut else t)
    new._setup(m, split, full_in)
    new.train(module.training)
    return new


def tensor_parallel(model: nn.Module, m: _mesh.Mesh, min_features: int = 256) -> nn.Module:
    """`model` (a whole CABiNet, the same on every rank of the model group)
    cut in place to this rank's slices under JAX's rule, its convs,
    linears and BatchNorms swapped for their sharded twins (each rank's
    slice of a split leaf is its model index's part of dim 0); every
    module carries `tp_mesh`. Returns `model`. A mesh of one model rank
    leaves it as it is."""
    if m.n_model == 1:
        return model
    dims = sharded_dims(model, m.n_model, min_features)
    for name, module in list(model.named_modules()):
        for child_name, child in list(module.named_children()):
            if isinstance(child, (nn.Conv2d, nn.Linear, BatchNorm2d)) \
                    and not isinstance(child, _Sharded):
                full = f"{name}.{child_name}" if name else child_name
                module._modules[child_name] = _sharded_twin(
                    child, _split_of(child, full, dims), m)
    for module in model.modules():
        module.tp_mesh = m
    return model


def mesh_of(module: nn.Module) -> Optional[_mesh.Mesh]:
    """The mesh `module` is sharded over, or None (not sharded)."""
    m = getattr(module, "tp_mesh", None)
    if m is None:
        m = next((s.tp_mesh for s in module.modules() if isinstance(s, _Sharded)), None)
    return m if m is not None and m.n_model > 1 else None


def state_dims(module: nn.Module) -> Dict[str, Optional[int]]:
    """{state-dict key: 0 for a leaf split over the model group, None}
    of a (sharded) module."""
    dims: Dict[str, Optional[int]] = {k: None for k in module.state_dict()}
    for name, sub in module.named_modules():
        if isinstance(sub, _Sharded) and sub.split:
            for key in sub.state_dict():
                if key != "num_batches_tracked":
                    dims[f"{name}.{key}" if name else key] = 0
    return dims


def param_roles(module: nn.Module) -> Dict[int, str]:
    """{id(parameter): role} for the gradient's reduction: "sharded" (a
    slice, whole on no rank), "partial" (a replicated weight used
    row-parallel: each rank holds its part of the gradient) or
    "replicated" (computed whole on every rank of the model group)."""
    roles = {id(p): "replicated" for p in module.parameters()}
    for sub in module.modules():
        if isinstance(sub, _Sharded):
            for p in sub.sharded_parameters():
                roles[id(p)] = "sharded"
            if not sub.split and sub.row_parallel:
                roles[id(sub.weight)] = "partial"
    return roles


def sharded_parameter_ids(module: nn.Module) -> Set[int]:
    """ids of `module`'s parameters that are slices (none if not sharded)."""
    if mesh_of(module) is None:
        return set()
    return {i for i, r in param_roles(module).items() if r == "sharded"}


def gather_state(tree: Mapping[str, torch.Tensor], module: nn.Module,
                 tag: str = "tp_gather") -> Dict[str, torch.Tensor]:
    """The whole state dict from `module`'s slices `tree` (a collective over
    its model group); `tree` itself when `module` is not sharded."""
    m = mesh_of(module)
    if m is None:
        return dict(tree)
    return _mesh.gather_model_parallel(tree, m, state_dims(module), tag=tag)


def shard_state(tree: Mapping[str, torch.Tensor], module: nn.Module) -> Dict[str, torch.Tensor]:
    """This rank's slices of a whole state dict, as `module` holds them."""
    m = mesh_of(module)
    if m is None:
        return dict(tree)
    return _mesh.shard_model_parallel(tree, m, state_dims(module))


def reshard_state(tree: Mapping[str, torch.Tensor], src: nn.Module, dst: nn.Module
                  ) -> Dict[str, torch.Tensor]:
    """`src`'s slices `tree` as `dst` holds them: the same tensors when both
    are sharded alike, else gathered over `src`'s model group and cut for
    `dst`'s."""
    if mesh_of(src) is mesh_of(dst) and state_dims(src) == state_dims(dst):
        return dict(tree)
    return shard_state(gather_state(tree, src), dst)


def by_name(params: Iterable[nn.Parameter], module: nn.Module) -> List[str]:
    """The names in `module` of `params`, in their order."""
    names = {id(p): n for n, p in module.named_parameters()}
    return [names[id(p)] for p in params]
