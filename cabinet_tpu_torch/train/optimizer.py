"""SGD with momentum over parameter groups, its learning rate scheduled by
the optimizer-step count, and clipping by the global norm (counterpart of
`cabinet_tpu.train.optimizer`): CABiNet's 4 groups with linear warmup +
poly decay (`GroupedSGD`), and YOLO-sem's 2 groups at a uniform LR with
linear warmup + one-cycle cosine (`build_sgd`, `warmup_cosine_schedule`).

The numbers are the JAX package's (reference src/utils/optimizer.py:34-156):
  - lr(it) = warmup_start + (it/warmup) * (lr0 - warmup_start) below
    `warmup`, else lr0 * r^power with r = (max_iter - it)/(max_iter - warmup)
    clamped to [0, 1], so steps past max_iter give lr 0; computed in f32;
  - `it` counts optimizer steps, not micro-batches;
  - a parameter gets weight decay iff it is a conv kernel (the 4-D weight
    of an `nn.Conv2d`; BN affine, biases, the SE `nn.Linear` weights and
    the CAB `gamma` get none), and x`lr_multiplier` iff its top-level module
    is a decoder module (`ab`, `ffm`, `conv_out`);
  - torch SGD's update order, which is optax's chain: g += wd*p,
    buf = mu*buf + g, p -= lr*buf;
  - clipping in optax's form: g * max/|g| is (g / |g|) * max, applied when
    |g| >= max, with no epsilon (`torch.nn.utils.clip_grad_norm_` divides by
    |g| + 1e-6);
  - YOLO-sem (`build_sgd`): every conv kernel gets weight decay, the class
    heads' included; biases and BN parameters get none; one LR for all;
    lr(x) = lr0 * ((1 - cos(pi x)) / 2 * (lrf - 1) + 1), x the share of the
    steps after warmup, clamped to [0, 1], in f32, op by op as the JAX
    function computes it (XLA's fused program may contract a multiply-add
    into one rounding, 1 ulp apart at some counts);
  - over a tensor-parallel model (`models/tensor_parallel.py`) the
    momentum of a split leaf is this rank's slice, and the clip's global
    norm is optax's over the whole arrays: each slice's squares summed
    over the model group, each replicated leaf's counted once.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

import numpy as np
import torch
from torch import nn

DECODER_MODULES = ("ffm", "conv_out", "ab")  # cabinet_tpu/models/cabinet.py:32

WD = "wd"
NOWD = "nowd"
WD_X = "wd_x10"
NOWD_X = "nowd_x10"
GROUPS = (WD, NOWD, WD_X, NOWD_X)


def warmup_poly_schedule(lr0: float, max_iter: int, power: float = 0.9,
                         warmup_steps: int = 0, warmup_start_lr: float = 1e-5
                         ) -> Callable[[int], float]:
    """count -> lr as an f32 value (reference optimizer.py:124-138), in the
    JAX package's form."""
    f32 = np.float32

    def schedule(count: int) -> float:
        c = f32(count)
        if warmup_steps > 0 and c < warmup_steps:
            return float(f32(warmup_start_lr)
                         + (c / f32(max(warmup_steps, 1))) * f32(lr0 - warmup_start_lr))
        remaining = np.clip((f32(max_iter) - c) / f32(max(float(max_iter) - warmup_steps, 1.0)),
                            f32(0.0), f32(1.0))
        return float(f32(lr0) * remaining ** f32(power))

    return schedule


def warmup_cosine_schedule(lr0: float, lrf: float, total_steps: int,
                           warmup_steps: int = 0, warmup_start_lr: float = 0.0
                           ) -> Callable[[int], float]:
    """count -> lr as an f32 value: linear warmup, then the ultralytics
    one-cycle cosine down to lr0 * lrf (JAX `warmup_cosine_schedule`)."""
    f32 = np.float32

    def schedule(count: int) -> float:
        c = f32(count)
        if warmup_steps > 0 and c < warmup_steps:
            return float(f32(warmup_start_lr)
                         + (c / f32(max(warmup_steps, 1))) * f32(lr0 - warmup_start_lr))
        x = np.clip((c - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1)),
                    f32(0.0), f32(1.0))
        return float(f32(lr0) * ((f32(1.0) - _cosf(f32(np.pi) * x)) / f32(2.0)
                                 * f32(lrf - 1.0) + f32(1.0)))

    return schedule


@functools.lru_cache(maxsize=1)
def _libm_cosf() -> Callable[[float], float]:
    libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    libm.cosf.restype = ctypes.c_float
    libm.cosf.argtypes = [ctypes.c_float]
    return libm.cosf


def _cosf(x: np.float32) -> np.float32:
    """cos of an f32 as the C library's `cosf` rounds it, which is what XLA's
    CPU backend calls for `jnp.cos` in f32 (numpy's and torch's f32 cos
    differ from it in the last bit at some arguments)."""
    return np.float32(_libm_cosf()(float(x)))


def param_labels(model: nn.Module,
                 decoder_modules: Sequence[str] = DECODER_MODULES) -> Dict[str, str]:
    """{parameter name: group}, as `cabinet_tpu.train.optimizer.param_labels`
    labels the same parameters."""
    conv_kernels = {f"{name}.weight" for name, m in model.named_modules()
                    if isinstance(m, nn.Conv2d)}
    labels = {}
    for name, p in model.named_parameters():
        kernel = name in conv_kernels and p.dim() == 4
        if name.split(".")[0] in decoder_modules:
            labels[name] = WD_X if kernel else NOWD_X
        else:
            labels[name] = WD if kernel else NOWD
    return labels


def param_groups(model: nn.Module, wd: float, lr_multiplier: float = 10.0,
                 decoder_modules: Sequence[str] = DECODER_MODULES) -> List[dict]:
    """The 4 groups, each with its `weight_decay` and `lr_scale`, in
    `GROUPS` order; a group with no parameter is left out."""
    labels = param_labels(model, decoder_modules)
    settings = {WD: (wd, 1.0), NOWD: (0.0, 1.0), WD_X: (wd, lr_multiplier),
                NOWD_X: (0.0, lr_multiplier)}
    groups = []
    for g in GROUPS:
        params = [p for n, p in model.named_parameters() if labels[n] == g]
        if params:
            groups.append({"params": params, "name": g, "weight_decay": settings[g][0],
                           "lr_scale": settings[g][1], "lr": 0.0})
    return groups


class ScheduledSGD:
    """`torch.optim.SGD` (momentum, dampening 0, no Nesterov) over `groups`
    (`param_groups`' dicts), with the lr of each group, schedule(count)
    times its `lr_scale`, set from the optimizer-step count before every
    step, and optax's clipping of the global norm. `model` given, its
    tensor-parallel slices (if any) count once in that norm."""

    def __init__(self, groups: List[dict], schedule: Callable[[int], float],
                 momentum: float, max_grad_norm=None, model: Optional[nn.Module] = None):
        from cabinet_tpu_torch.models import tensor_parallel as tp

        self.schedule = schedule
        self.max_grad_norm = float(max_grad_norm) if max_grad_norm else None
        self.sgd = torch.optim.SGD(groups, lr=0.0, momentum=momentum, dampening=0.0,
                                   nesterov=False)
        self.tp_mesh = None if model is None else tp.mesh_of(model)
        self.sharded: Set[int] = set() if model is None else tp.sharded_parameter_ids(model)

    def set_lr(self, count: int) -> None:
        lr = np.float32(self.schedule(count))
        for g in self.sgd.param_groups:
            g["lr"] = float(lr * np.float32(g["lr_scale"]))

    def step(self, count: int) -> None:
        """One update from the gradients in `.grad`, at optimizer step
        `count` (the count before this step, as optax's)."""
        if self.max_grad_norm is not None:
            clip_by_global_norm(self.parameters(), self.max_grad_norm,
                                self.sharded, self.tp_mesh)
        self.set_lr(count)
        self.sgd.step()

    def parameters(self) -> List[torch.Tensor]:
        return [p for g in self.sgd.param_groups for p in g["params"]]

    def state_dict(self) -> dict:
        return self.sgd.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.sgd.load_state_dict(state)


class GroupedSGD(ScheduledSGD):
    """CABiNet's optimizer: the 4 groups with warmup + poly decay."""

    def __init__(self, model: nn.Module, lr0: float, max_iter: int,
                 momentum: float = 0.9, wd: float = 5e-4, power: float = 0.9,
                 warmup_steps: int = 0, warmup_start_lr: float = 1e-5,
                 lr_multiplier: float = 10.0, max_grad_norm=None,
                 decoder_modules: Sequence[str] = DECODER_MODULES):
        super().__init__(param_groups(model, wd, lr_multiplier, decoder_modules),
                         warmup_poly_schedule(lr0, max_iter, power, warmup_steps,
                                              warmup_start_lr),
                         momentum, max_grad_norm, model)


def build_sgd(model: nn.Module, schedule: Callable[[int], float],
              momentum: float = 0.937, wd: float = 5e-4, max_grad_norm=None
              ) -> ScheduledSGD:
    """YOLO-sem's optimizer (JAX `build_sgd`): groups `wd` (every 4-D conv
    kernel, the class heads' included) and `nowd` (biases, BN affine) at
    one LR, `schedule`'s."""
    return ScheduledSGD(param_groups(model, wd, 1.0, decoder_modules=()), schedule,
                        momentum, max_grad_norm)


@torch.no_grad()
def squared_norm(params: Sequence[torch.Tensor], sharded: Set[int], tp_mesh: Any
                 ) -> torch.Tensor:
    """The sum of squares of the `.grad` of `params` in f32, the slices'
    (`sharded`, by id) summed over `tp_mesh`'s model group: the whole
    arrays' sum, on every rank of the group."""
    from cabinet_tpu_torch.core import mesh

    grads = [p for p in params if p.grad is not None]
    part = [p.grad.float().square().sum() for p in grads if id(p) in sharded]
    rest = [p.grad.float().square().sum() for p in grads if id(p) not in sharded]
    sq = torch.stack(rest).sum() if rest else torch.zeros(())
    if part:
        sq = sq + mesh.all_reduce_(torch.stack(part).sum().reshape(1), tag="tp_grad_norm",
                                   group=tp_mesh.model_group)[0]
    return sq


@torch.no_grad()
def clip_by_global_norm(params: Sequence[torch.Tensor], max_norm: float,
                        sharded: Set[int] = frozenset(), tp_mesh: Any = None) -> torch.Tensor:
    """Clip the `.grad` of `params` in optax's form; returns the norm (over
    the whole arrays of a tensor-parallel model: `squared_norm`). No host
    sync: the clipped and unclipped values are selected on the device."""
    norm = torch.sqrt(squared_norm(params, sharded, tp_mesh))
    clip_to_norm_([p.grad for p in params if p.grad is not None], norm, max_norm)
    return norm


@torch.no_grad()
def clip_to_norm_(grads: Sequence[torch.Tensor], norm: torch.Tensor, max_norm: float) -> None:
    """In place, optax's clip of `grads` whose global norm is `norm`: each
    g * max/|g| as (g / |g|) * max where |g| >= max, selected on the device."""
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
