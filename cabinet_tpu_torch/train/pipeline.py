"""Pipeline-parallel training: a model split into stages, each on its own
device (counterpart of `cabinet_tpu.train.pipeline`).

A stage is a module of its own (`Stage`) holding whole top-level modules of
the model (CABiNet's backbone `mobile` | the rest; YOLO-sem's trunk | neck
and heads, or the trunk cut at P3 for 3 stages), named as in the full
model, so that the stages' state dicts together are the model's. Each
stage has its own `ScheduledSGD` (built without clipping) and its own
`ModelEMA`. One window of M microbatches is dispatched in JAX's 1F1B order:
stage i's backward of microbatch m follows its forward of microbatch
m + (n - 1 - i), and a reverse-order pass drains the rest. On CUDA every
device runs its queue in that order, so a later stage works on microbatch
m while an earlier one runs m + 1; activations and cotangents move with
`.to(device, non_blocking=True)`, and nothing in a window waits on the
host: the loss is read once, after it.

The numbers are the fused trainer's (`train/trainer.py`) at
`accum_steps=M` over the same microbatches, as in JAX:
  - the loss stage takes the value and the gradients with respect to its
    parameters and to its incoming activation (the cotangent that the
    stage before it backpropagates), each microbatch's loss scaled 1/M;
  - every other stage runs its forward without a graph and recomputes it
    in its backward (GPipe's checkpointing), its BatchNorm running
    statistics kept (`models/mobilenetv3.py:_running_stats_kept`), so that
    they advance exactly once a microbatch;
  - the gradients are clipped by one global norm over every stage's, in
    optax's form, and each stage's optimizer and EMA advance once a window;
  - a trailing partial window keeps the 1/M scale (`n_micro`);
  - the attention runs its einsum path (`trainer.einsum_attention`): the
    attention kernel K1 has no backward.

`aug_fn` (device augmentation) runs on stage 0's device; the batch it
warps feeds stage 0 and rides to the loss stage as data, with the labels.

Stage placement (`make_pipeline_devices`): stage i on cuda:(i mod the
card count) from the caller's card, or every stage on the CPU when the
CPU is asked for. With fewer cards than stages the stages share cards,
which a log line says; JAX raises there instead. Inside a process group
of R > 1 ranks (`core/mesh.py`; `runtime.pipeline_dp`), each rank runs the
whole pipeline on its own card over its share of every microbatch:
BatchNorm, OHEM and the CE take the global microbatch, and each stage's
gradients are all-reduced before the clip (JAX runs the pipeline in one
process and refuses several).

Tensor-parallel stages (`runtime.pipeline_tp`, JAX's per-stage model
axis): when `model` is cut to its slices (`models/tensor_parallel.py`),
each stage holds its modules' slices and runs them over the model group
of the current mesh (`core/mesh.py`), whose data group then carries the
microbatch's share; the gradients are reduced by role
(`trainer._all_reduce_grads`) and the clip's norm counts each slice once.
`merged` gives the slices, `PipelineTrainLoop.full_weights` the whole
tensors.
"""

from __future__ import annotations

import copy
import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from cabinet_tpu_torch.core import mesh
from cabinet_tpu_torch.core.device import resolve_device
from cabinet_tpu_torch.models import tensor_parallel as tp
from cabinet_tpu_torch.models.cabinet import CABiNet
from cabinet_tpu_torch.models.mobilenetv3 import _running_stats_kept
from cabinet_tpu_torch.models.yolosem import YOLOSem
from cabinet_tpu_torch.train.ema import ModelEMA
from cabinet_tpu_torch.train.optimizer import ScheduledSGD, clip_to_norm_, squared_norm
from cabinet_tpu_torch.train.trainer import (
    TrainState,
    _all_reduce_grads,
    _autocast,
    _seg_loss,
    batch_to,
    einsum_attention,
)

log = logging.getLogger(__name__)

# CABiNet's top-level modules (models/cabinet.py): the backbone | everything
# that reads its /32 features (the spatial branch reads the image, which
# rides to stage 1 as data).
CABINET_STAGE_KEYS: Tuple[Tuple[str, ...], ...] = (
    ("mobile",),
    ("sb", "ab", "ffm", "conv_out"),
)

# YOLO-sem (models/yolosem.py): CSP trunk | PAN-FPN neck + heads; the
# activation between them is the (P3, P4, P5) pyramid.
YOLOSEM_STAGE_KEYS: Tuple[Tuple[str, ...], ...] = (
    ("stem", "down2", "c2f_2", "down3", "c2f_3", "down4", "c2f_4",
     "down5", "c2f_5", "sppf"),
    ("fpn_4", "fpn_3", "head0", "head1", "head2", "classifier",
     "aux1", "aux_classifier"),
)

# 3 stages: trunk front (image -> P3) | trunk back (P3 -> pyramid) | neck +
# heads. CABiNet cannot go past 2: its whole backbone is one module.
YOLOSEM_STAGE_KEYS_3: Tuple[Tuple[str, ...], ...] = (
    ("stem", "down2", "c2f_2", "down3", "c2f_3"),
    ("down4", "c2f_4", "down5", "c2f_5", "sppf"),
    ("fpn_4", "fpn_3", "head0", "head1", "head2", "classifier",
     "aux1", "aux_classifier"),
)

Tree = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


def _tree_map(fn: Callable[[torch.Tensor], Any], tree: Tree) -> Any:
    if isinstance(tree, (tuple, list)):
        return tuple(fn(t) for t in tree)
    return fn(tree)


def _leaves(tree: Tree) -> List[torch.Tensor]:
    return list(tree) if isinstance(tree, (tuple, list)) else [tree]


def _to(tree: Tree, device: torch.device) -> Any:
    return _tree_map(lambda t: t.to(device, non_blocking=True), tree)


def _module_of(key: str) -> str:
    return key.split(".", 1)[0]


def split_variables(state_dict: Dict[str, torch.Tensor],
                    stage_keys: Sequence[Sequence[str]]) -> List[Dict[str, torch.Tensor]]:
    """A model state dict partitioned by top-level module name, one dict a
    stage; raises for a module no stage covers (one that holds only
    buffers included)."""
    owner = {k: i for i, keys in enumerate(stage_keys) for k in keys}
    missing = sorted({_module_of(k) for k in state_dict if _module_of(k) not in owner})
    if missing:
        raise ValueError(f"stage_keys do not cover modules: {missing}")
    parts: List[Dict[str, torch.Tensor]] = [{} for _ in stage_keys]
    for k, v in state_dict.items():
        parts[owner[_module_of(k)]][k] = v
    return parts


def merge_variables(parts: Sequence[Dict[str, torch.Tensor]],
                    device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    """The inverse of `split_variables`: one state dict keyed as the full
    model's, each tensor where it is, or copied to `device` (device to
    device on CUDA)."""
    merged: Dict[str, torch.Tensor] = {}
    for part in parts:
        merged.update(part if device is None
                      else {k: v.to(device, non_blocking=True) for k, v in part.items()})
    return merged


def make_pipeline_devices(n_stages: int, device: Union[str, torch.device] = "cuda"
                          ) -> List[torch.device]:
    """Stage i's device: cuda:((first + i) mod the card count) from the
    card `device` names (every stage on this rank's card inside a process
    group of several ranks), or `device` itself off CUDA."""
    device = resolve_device(device)
    if device.type != "cuda":
        return [device] * n_stages
    first = device.index if device.index is not None else torch.cuda.current_device()
    if mesh.is_distributed():
        devices = [torch.device("cuda", first)] * n_stages
    else:
        cards = torch.cuda.device_count()
        devices = [torch.device("cuda", (first + i) % cards) for i in range(n_stages)]
    if len(set(devices)) < n_stages:
        log.info(f"pipeline: {n_stages} stages share {len(set(devices))} card(s) "
                 f"({', '.join(str(d) for d in devices)})")
    return devices


class Stage(nn.Module):
    """The top-level modules `keys` of a model, registered under their own
    names, so that a stage's state dict is its part of the model's."""

    def __init__(self, modules: Dict[str, nn.Module]):
        super().__init__()
        for name, module in modules.items():
            self.add_module(name, module)


# Stage methods: the first maps (stage, image NCHW) -> activation, a middle
# one (stage, activation) -> activation, the last (stage, image, activation)
# -> (final, aux) logits. They run the model class's own methods with the
# stage as `self`, so the pipeline has no model code of its own.
def _cabinet_backbone(stage: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return stage.mobile(x)


def _cabinet_decode(stage: nn.Module, x: torch.Tensor, feat: Tree):
    return CABiNet._decode(stage, x, feat)


def _yolosem_front(stage: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return YOLOSem.backbone_front(stage, x)


def _yolosem_back(stage: nn.Module, feat: torch.Tensor) -> Tree:
    return YOLOSem.backbone_back(stage, feat)


def _yolosem_backbone(stage: nn.Module, x: torch.Tensor) -> Tree:
    return _yolosem_back(stage, _yolosem_front(stage, x))


def _yolosem_decode(stage: nn.Module, x: torch.Tensor, feat: Tree):
    return YOLOSem.decode(stage, x, feat)


CABINET_STAGE_METHODS = (_cabinet_backbone, _cabinet_decode)
YOLOSEM_STAGE_METHODS = (_yolosem_backbone, _yolosem_decode)
YOLOSEM_STAGE_METHODS_3 = (_yolosem_front, _yolosem_back, _yolosem_decode)


class CabinetPipeline:
    """N-stage GPipe trainer, a stage a device (`devices`).

    `tx_factory(stage_module)` builds a stage's optimizer without clipping
    (`max_grad_norm=None`); the pipeline clips by the global norm of every
    stage's gradients itself. The default stages are CABiNet's 2;
    `stage_keys` and `stage_methods` give others (YOLO-sem's 2 or 3).
    `aug_fn(raw_batch, step, micro_step) -> (images NHWC, labels)` on
    stage 0's device, when given, turns each microbatch's raw loader batch
    into the one trained on. `train_step` returns the stages' states
    (`train/trainer.py:TrainState`, updated in place) and the sum of the
    1/M-scaled microbatch losses, a 0-dim tensor on the last device (the
    global batch's inside a process group)."""

    def __init__(
        self,
        model: nn.Module,
        tx_factory: Callable[[nn.Module], ScheduledSGD],
        n_min: int,
        num_microbatches: int,
        devices: Sequence[Union[str, torch.device]],
        thresh: float = 0.7,
        ignore_label: int = 255,
        class_weights=None,
        aux_weight: float = 1.0,
        loss_type: str = "ohem",
        ohem_method: str = "bisect",
        compute_dtype: torch.dtype = torch.float32,
        max_grad_norm: Optional[float] = None,
        ema_decay: float = 0.9999,
        ema_tau: float = 2000.0,
        stage_keys: Sequence[Sequence[str]] = CABINET_STAGE_KEYS,
        stage_methods: Optional[Sequence[Callable]] = None,
        aug_fn: Optional[Callable] = None,
    ) -> None:
        n_stages = len(devices)
        if n_stages < 2:
            raise ValueError(f"pipeline needs >= 2 devices, got {n_stages}")
        self.stage_keys = tuple(tuple(k) for k in stage_keys)
        if len(self.stage_keys) != n_stages:
            raise ValueError(f"{n_stages} devices but {len(self.stage_keys)} stage_keys entries")
        if stage_methods is None:
            if n_stages != 2:
                raise ValueError(
                    "stage_methods is required for n_stages != 2; the default is "
                    "CABiNet's backbone | decode split, and CABiNet cannot split "
                    "deeper (stage_keys partition top-level modules; its backbone "
                    "is one module)")
            stage_methods = CABINET_STAGE_METHODS
        if len(stage_methods) != n_stages:
            raise ValueError(f"{n_stages} devices but {len(stage_methods)} stage_methods")
        self.model = model
        self.methods = tuple(stage_methods)
        self.devices = [torch.device(d) for d in devices]
        self.tx_factory = tx_factory
        self.M = int(num_microbatches)
        self.aug_fn = aug_fn
        self.max_grad_norm = float(max_grad_norm) if max_grad_norm else None
        self.ema_decay, self.ema_tau = float(ema_decay), float(ema_tau)
        self.aux_weight = float(aux_weight)
        self.compute_dtype = compute_dtype
        self.seg_loss = _seg_loss(loss_type, n_min, thresh, ignore_label, class_weights,
                                  ohem_method)

    # -- state ------------------------------------------------------------

    def init_state(self, variables: Dict[str, torch.Tensor]) -> List[TrainState]:
        """Each stage's modules (copies of the model's), loaded from its part
        of the state dict `variables` (a tensor-parallel model's: its
        slices), on its device, with its optimizer and EMA."""
        states = []
        for keys, part, device in zip(self.stage_keys,
                                      split_variables(variables, self.stage_keys),
                                      self.devices):
            stage = Stage({k: copy.deepcopy(getattr(self.model, k)) for k in keys})
            stage.load_state_dict(part, strict=True)
            stage.to(device)
            states.append(TrainState(stage, self.tx_factory(stage),
                                     ModelEMA(stage, self.ema_decay, self.ema_tau)))
        return states

    # -- one stage ----------------------------------------------------------

    def _run(self, i: int, stage: nn.Module, *args) -> Any:
        with _autocast(self.devices[i], self.compute_dtype):
            return self.methods[i](stage, *args)

    def _forward(self, i: int, stage: nn.Module, a: Tree) -> Tree:
        """Stage i < n-1 without a graph (its backward recomputes it)."""
        with torch.no_grad(), einsum_attention(stage):
            return self._run(i, stage, a)

    def _backward(self, i: int, stage: nn.Module, a: Tree, cot: Tree) -> Optional[Tree]:
        """Stage i < n-1 recomputed with its BatchNorm statistics kept, its
        output's cotangent `cot` backpropagated into the parameters' `.grad`;
        returns the cotangent of its input (None for stage 0, whose input is
        data)."""
        if i > 0:
            a = _tree_map(lambda t: t.detach().requires_grad_(True), a)
        with _running_stats_kept(stage), einsum_attention(stage):
            out = self._run(i, stage, a)
        torch.autograd.backward(_leaves(out), _leaves(cot))
        return None if i == 0 else _tree_map(lambda t: t.grad, a)

    def _loss(self, stage: nn.Module, x: torch.Tensor, feat: Tree, labels: torch.Tensor
              ) -> Tuple[torch.Tensor, Tree]:
        """The loss stage: its 1/M-scaled loss (detached) after its backward,
        and the cotangent of its incoming activation."""
        feat = _tree_map(lambda t: t.detach().requires_grad_(True), feat)
        with einsum_attention(stage):
            final, aux = self._run(len(self.devices) - 1, stage, x, feat)
        share = mesh.data_world()[1] > 1
        loss = (self.seg_loss(final, labels, share)
                + self.aux_weight * self.seg_loss(aux, labels, share)) / self.M
        loss.backward()
        return loss.detach(), _tree_map(lambda t: t.grad, feat)

    # -- the step ----------------------------------------------------------

    def train_step(self, states: List[TrainState], images, labels,
                   n_micro: Optional[int] = None) -> Tuple[List[TrainState], torch.Tensor]:
        """One optimizer step over `images` split into M (or `n_micro`, a
        trailing partial window: the 1/M scale kept) microbatches."""
        M = self.M if n_micro is None else int(n_micro)
        B = images.shape[0]
        if B % M != 0:
            raise ValueError(f"batch {B} not divisible by {M} microbatches")
        mb = B // M
        return self.train_step_micro(states, [(images[m * mb:(m + 1) * mb],
                                               labels[m * mb:(m + 1) * mb])
                                              for m in range(M)])

    def _stage_in(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """A microbatch as (NHWC images on stage 0's device, labels there):
        `aug_fn`'s output from (raw batch, (step, micro_step)), or the
        (images, labels) given, copied."""
        if self.aug_fn is not None:
            raw, draw = batch
            return self.aug_fn(raw, *draw)
        return batch_to(batch, self.devices[0])

    def train_step_micro(self, states: List[TrainState], microbatches: Sequence[Tuple]
                         ) -> Tuple[List[TrainState], torch.Tensor]:
        """One optimizer step over the microbatches given: (images, labels),
        or with `aug_fn` (raw loader batch, (step, micro_step))."""
        n = len(states)
        stages = [s.model for s in states]
        for s in stages:
            s.train()
        last = self.devices[-1]
        losses: List[torch.Tensor] = []
        # per non-loss stage: forward inputs awaiting their recomputed
        # backward, and output cotangents ready to consume, by microbatch
        inputs: List[Dict[int, Any]] = [{} for _ in range(n - 1)]
        cots: List[List[Tuple[int, Any]]] = [[] for _ in range(n - 1)]

        def drain(i: int) -> None:
            m_, cot = cots[i].pop(0)
            g_in = self._backward(i, stages[i], inputs[i].pop(m_), cot)
            if i > 0:
                cots[i - 1].append((m_, _to(g_in, self.devices[i - 1])))

        for m, batch in enumerate(microbatches):
            images, labels = self._stage_in(batch)
            x0 = images.permute(0, 3, 1, 2)
            x_last, y = x0.to(last, non_blocking=True), labels.to(last, non_blocking=True)
            prev: Any = x0
            inputs[0][m] = x0
            for i in range(n - 1):
                if i > 0:
                    prev = _to(prev, self.devices[i])
                    inputs[i][m] = prev
                prev = self._forward(i, stages[i], prev)
            loss_m, g_feat = self._loss(stages[-1], x_last, _to(prev, last), y)
            losses.append(loss_m)
            cots[n - 2].append((m, _to(g_feat, self.devices[n - 2])))
            for i in range(n - 2, -1, -1):
                while cots[i] and cots[i][0][0] <= m - (n - 1 - i):
                    drain(i)
        # the flush: one reverse-order pass drains everything (stage i's
        # drain feeds stage i-1's queue before the pass reaches it)
        for i in range(n - 2, -1, -1):
            while cots[i]:
                drain(i)
        assert not any(inputs), "pipeline flush left undrained backwards"
        self._update(states)
        loss = torch.stack(losses).sum()
        if mesh.data_world()[1] > 1:
            mesh.all_reduce_(loss, tag="pipeline_loss", group=mesh.data_group())
        return states, loss

    def _update(self, states: List[TrainState]) -> None:
        """The window's update: each stage's gradients (all-reduced over the
        ranks), clipped by the norm of them all, then its optimizer and EMA."""
        grads, sqs = [], []
        for s in states:
            params = s.optimizer.parameters()
            for p in params:
                if p.grad is None:  # a parameter off the graph still decays, as in optax
                    p.grad = torch.zeros_like(p)
            if mesh.is_distributed():
                _all_reduce_grads(params, tag="pipeline_grad_all_reduce", model=s.model)
            grads.append([p.grad for p in params])
            if self.max_grad_norm is not None:  # a slice's squares over its model group
                sqs.append(squared_norm(params, tp.sharded_parameter_ids(s.model),
                                        tp.mesh_of(s.model)))
        if self.max_grad_norm is not None:
            for d, gs in zip(self.devices, grads):
                norm = torch.sqrt(sum(sq.to(d, non_blocking=True) for sq in sqs))
                clip_to_norm_(gs, norm, self.max_grad_norm)
        for s in states:
            s.optimizer.step(s.step)
            s.ema.update(s.model)
            s.step += 1
            s.optimizer.sgd.zero_grad(set_to_none=True)


def merged(states: Sequence[TrainState], ema: bool = False,
           device: Optional[Union[str, torch.device]] = None) -> Dict[str, torch.Tensor]:
    """The stages' variables (their EMA shadows with `ema`) as one state dict
    keyed as the full model's: each tensor where it is, or copied to
    `device`, device to device."""
    return merge_variables([s.ema.state_dict() if ema else s.model.state_dict()
                            for s in states], None if device is None else torch.device(device))


class PipelineTrainLoop:
    """The train CLIs' loop over the pipeline, with the fused loop's surface
    (`train/trainer.py:TrainLoop`): one loader batch is one microbatch.
    `feed` buffers microbatches and runs a window once M have arrived,
    returning the window's mean unscaled microbatch loss (the fused step's
    per-microbatch loss), else None; `flush` runs a trailing partial window
    with the 1/M scale kept, as the fused trainer's flush does, and returns
    its loss (None when nothing is buffered). `state` is the stages' list
    (what `CheckpointManager.save_full` takes); `weights` merges them.

    With an `aug_fn`, `feed` takes the loader's raw batch and the draw key
    `draw` of its augmentation, by default (optimizer step, position in
    the window): the fused trainer's (step, micro_step), so that both draw
    the same crops."""

    def __init__(self, pipe: CabinetPipeline, state: List[TrainState]) -> None:
        self.pipe = pipe
        self.state = state
        self._micro: List[Tuple] = []

    def feed(self, *batch: Any, draw: Optional[Tuple[int, int]] = None) -> Optional[float]:
        if self.pipe.aug_fn is not None:
            self._micro.append((batch, draw if draw is not None
                                else (self.step, len(self._micro))))
        else:
            self._micro.append(batch[:2])
        if len(self._micro) < self.pipe.M:
            return None
        return self._run_window()

    def flush(self) -> Optional[float]:
        if not self._micro:
            return None
        return self._run_window()

    def _run_window(self) -> float:
        micro, self._micro = self._micro, []
        self.state, loss = self.pipe.train_step_micro(self.state, micro)
        # the sum of 1/M-scaled losses; the mean unscaled one is x M/n
        return float(loss) * self.pipe.M / len(micro)

    @property
    def step(self) -> int:
        return int(self.state[0].step)

    def weights(self, ema: bool = False,
                device: Optional[Union[str, torch.device]] = None) -> Dict[str, torch.Tensor]:
        return merged(self.state, ema, device)

    def full_weights(self, ema: bool = False) -> Dict[str, torch.Tensor]:
        """`weights`, tensor-parallel stages' slices gathered whole."""
        return merge_variables([tp.gather_state(s.ema.state_dict() if ema
                                                else s.model.state_dict(), s.model)
                                for s in self.state])
