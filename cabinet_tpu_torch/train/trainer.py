"""The training step: dual-head loss, gradient accumulation, clipping,
scheduled SGD and EMA (counterpart of `cabinet_tpu.train.trainer`, one
device), for CABiNet and YOLO-sem.

As in the JAX package (reference src/scripts/train.py:411-480):
  - loss = seg(final) + aux_weight * seg(aux), seg OHEM (CABiNet's recipe,
    aux_weight 1) or the weighted CE mean (`loss_type="ce"`, YOLO-sem's,
    aux_weight 0.4), each micro-batch's loss scaled by 1/accum_steps before
    its backward;
  - the gradients of `accum_steps` micro-batches sum in `.grad` (the JAX
    TrainState's `accum_grads`); the optimizer steps once per window, and
    `make_flush_step` applies a trailing partial window (a no-op on an
    empty one);
  - the global-norm clipping acts on the summed gradients at step time;
  - the EMA advances once per real optimizer step, from the parameters
    after it and the BatchNorm statistics of the micro-step that took it.

`TrainLoop` drives the step and its flush for the train CLIs, with the
surface of the pipeline's loop (`train/pipeline.py:PipelineTrainLoop`).

`compute_dtype=torch.bfloat16` is bf16 autocast over f32 master parameters
with no loss scaler, the counterpart of JAX's bf16 matmuls over f32 params
(no GradScaler: bf16 has f32's exponent range).

Inside a process group of R > 1 ranks (`core/mesh.py`; data parallelism)
each rank steps on its share of the global batch: the losses are the
global batch's (`share=True`: the OHEM cut and the CE divisor span every
data rank's pixels), BatchNorm's statistics too (`models/layers.py`), the
window's summed gradients are all-reduced once at the update, before the
clipping, and the optimizer, EMA and counters then advance identically on
every rank. The loss a step returns is the global one. The model is not
wrapped in `DistributedDataParallel`, which would reduce at every
backward.

On a (data, model) mesh (`models/tensor_parallel.py`: the model's wide
layers cut to this rank's slices), each kind of gradient is reduced once
at the update (`_all_reduce_grads`): a slice's over its data group; a
replicated weight used row-parallel, whose ranks each hold a part, over
every rank; any other replicated parameter, whole on every rank of the
model group, over its data group and then sent from the group's first
rank, so that the replicated parameters stay one copy bit for bit. The
clip's norm counts each slice once (`optimizer.py:ScheduledSGD`).

On a row-striped model (`models/spatial_parallel.py`, spatial
partitioning) each rank is handed the whole global batch, takes its stripe
of every image's rows (`core/mesh.py:spatial_sharding`) and runs the
forward and backward on it inside `stripes`; the losses and BatchNorm
reduce over the data group's pixels, and the gradients are reduced as
under data parallelism. The val loss runs whole frames.

The step always runs the CAB's einsum attention (on a model with a CAB),
the function that the JAX wrapper computes off the TPU and which is
differentiable: the attention kernel K1 has no backward
(`ops/_build.refuse_grad` raises under autograd).
The step sets that mode for its forward and puts the model's own back
after it, so the val loss and the evaluations still run K1 when the model
was built with `attention="kernel"`.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from cabinet_tpu_torch.core import mesh
from cabinet_tpu_torch.models import spatial_parallel
from cabinet_tpu_torch.train.ema import ModelEMA
from cabinet_tpu_torch.train.losses import cross_entropy_mean, ohem_cross_entropy
from cabinet_tpu_torch.train.optimizer import ScheduledSGD
from cabinet_tpu_torch.utils.profiler import span


@dataclass
class TrainState:
    model: nn.Module
    optimizer: ScheduledSGD
    ema: ModelEMA
    step: int = 0          # optimizer steps taken (reference optim.it)
    micro_step: int = 0    # position within the accumulation window

    @property
    def accum_grads(self) -> Dict[str, torch.Tensor]:
        """The running sum of the window's gradients (zeros between
        windows), by parameter name."""
        return {n: (p.grad.detach() if p.grad is not None else torch.zeros_like(p))
                for n, p in self.model.named_parameters()}

    def load_accum_grads(self, grads: Dict[str, torch.Tensor]) -> None:
        for n, p in self.model.named_parameters():
            p.grad = grads[n].to(p.device).clone() if self.micro_step > 0 else None

    @property
    def ema_variables(self) -> Dict[str, torch.Tensor]:
        return self.ema.state_dict()


def create_train_state(model: nn.Module, optimizer: ScheduledSGD,
                       ema_decay: float = 0.9999, ema_tau: float = 2000.0) -> TrainState:
    return TrainState(model, optimizer, ModelEMA(model, ema_decay, ema_tau))


def _autocast(device: torch.device, compute_dtype: torch.dtype):
    if compute_dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=compute_dtype)


def _forward(model: nn.Module, images: torch.Tensor, compute_dtype: torch.dtype
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(final, aux) NCHW logits of NHWC images."""
    x = images.permute(0, 3, 1, 2)
    with _autocast(x.device, compute_dtype):
        return model(x)


@contextlib.contextmanager
def einsum_attention(model: nn.Module):
    """Run the CAB's global attention on its einsum path inside the block
    (nothing changes on a model with no CAB)."""
    attns = [m for m in model.modules() if hasattr(m, "attention")
             and hasattr(m, "project_out")]
    saved = [m.attention for m in attns]
    for m in attns:
        m.attention = "einsum"
    try:
        yield
    finally:
        for m, a in zip(attns, saved):
            m.attention = a


def _flat_op(grads, fn) -> None:
    """`fn` on one flat buffer of `grads`, copied back."""
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    fn(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def _all_reduce_grads(params, tag: str = "grad_all_reduce",
                      model: Optional[nn.Module] = None) -> None:
    """Sum the `.grad` of `params` over the data axis, in one flat buffer;
    on a mesh with a model axis (`model` sharded) each by its role
    (module docstring), tagged `tag`, `tp_grad_all_reduce` and
    `tp_grad_broadcast`."""
    from cabinet_tpu_torch.models import tensor_parallel as tp

    m = tp.mesh_of(model) if model is not None else None
    if m is None:
        _flat_op([p.grad for p in params],
                 lambda f: mesh.all_reduce_(f, tag=tag, group=mesh.data_group()))
        return
    roles = tp.param_roles(model)
    kinds: Dict[str, list] = {"sharded": [], "partial": [], "replicated": []}
    for p in params:
        kinds[roles[id(p)]].append(p.grad)
    _flat_op(kinds["sharded"] + kinds["replicated"],
             lambda f: mesh.all_reduce_(f, tag=tag, group=m.data_group))
    _flat_op(kinds["partial"], lambda f: mesh.all_reduce_(f, tag="tp_grad_all_reduce"))
    _flat_op(kinds["replicated"], lambda f: mesh.broadcast_(
        f, m.model_src(), tag="tp_grad_broadcast", group=m.model_group))


def _apply_update(state: TrainState) -> None:
    """Spans: `train.update` over `train.optimizer` and `train.ema`."""
    params = state.optimizer.parameters()
    dev = params[0].device if params else None
    with span("train.update", device=dev):
        for p in params:
            if p.grad is None:  # a parameter off the graph still decays, as in optax
                p.grad = torch.zeros_like(p)
        if mesh.is_distributed():
            _all_reduce_grads(params, model=state.model)
        with span("train.optimizer", device=dev):
            state.optimizer.step(state.step)
        with span("train.ema", device=dev):
            state.ema.update(state.model)
        state.step += 1
        state.micro_step = 0
        state.optimizer.sgd.zero_grad(set_to_none=True)


def _seg_loss(loss_type: str, n_min: int, thresh: float, ignore_label: int,
              class_weights, ohem_method: str = "bisect"
              ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """logits, labels -> the loss of one head: "ohem" (`ohem_method`) or
    "ce"."""
    if loss_type not in ("ohem", "ce"):
        raise ValueError(f"loss_type must be 'ohem' or 'ce', got {loss_type!r}")
    cw = None if class_weights is None else torch.as_tensor(class_weights,
                                                           dtype=torch.float32)

    def seg_loss(logits, labels, share=False):
        w = None if cw is None else cw.to(logits.device)
        if loss_type == "ohem":
            return ohem_cross_entropy(logits, labels, n_min, thresh, ignore_label, w,
                                      method=ohem_method, share=share)
        return cross_entropy_mean(logits, labels, ignore_label, w, share=share)

    return seg_loss


def make_train_step(
    n_min: int, thresh: float = 0.7, ignore_label: int = 255,
    class_weights=None, accum_steps: int = 1,
    compute_dtype: torch.dtype = torch.float32,
    loss_type: str = "ohem", aux_weight: float = 1.0, ohem_method: str = "bisect",
) -> Callable[[TrainState, torch.Tensor, torch.Tensor], Tuple[TrainState, torch.Tensor]]:
    """`train_step(state, images NHWC, labels) -> (state, loss)`: one
    micro-step on `state` (updated in place and returned), the loss of the
    micro-batch unscaled, a 0-dim tensor (no host sync). The loss is
    seg(final) + aux_weight * seg(aux), seg OHEM (`ohem_method`, bisect by
    default, as in JAX; CABiNet) or the
    CE mean (`loss_type="ce"`; YOLO-sem). In a group of several ranks,
    `images` and `labels` are this rank's share of the global batch (on a
    row-striped model the whole global batch, of which it takes its rows) and
    the loss is the global batch's; `n_min` is sized from the global
    batch."""
    seg_loss = _seg_loss(loss_type, n_min, thresh, ignore_label, class_weights, ohem_method)

    def train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor
                   ) -> Tuple[TrainState, torch.Tensor]:
        model = state.model
        model.train()
        share = mesh.data_world()[1] > 1
        sp = spatial_parallel.mesh_of(model)
        if sp is not None:  # this data rank's rows of the global batch
            images, labels = (mesh.spatial_sharding(sp, t.dim())(t) for t in (images, labels))
        with einsum_attention(model), spatial_parallel.stripes(model):
            with span("train.forward", device=images.device):
                final, aux = _forward(model, images, compute_dtype)
                loss = (seg_loss(final, labels, share)
                        + aux_weight * seg_loss(aux, labels, share)) / accum_steps
            with span("train.backward", device=images.device):
                loss.backward()  # a rematerialised block recomputes on its stripe
        state.micro_step += 1
        if state.micro_step >= accum_steps:
            _apply_update(state)
        loss = loss.detach() * accum_steps
        if share:
            loss = mesh.all_reduce_(loss, tag="loss", group=mesh.data_group())
        return state, loss

    return train_step


def make_flush_step() -> Callable[[TrainState], TrainState]:
    """End-of-epoch flush of a trailing partial window (reference
    train.py:479-480); a no-op when the window is empty."""

    def flush(state: TrainState) -> TrainState:
        if state.micro_step > 0:
            _apply_update(state)
        return state

    return flush


def batch_to(batch, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A loader batch's (images, labels), arrays or tensors, on `device`."""
    return tuple(torch.as_tensor(a).to(device, non_blocking=True) for a in batch[:2])


class TrainLoop:
    """The train CLIs' loop over the fused step: one loader batch is one
    micro-step. Its surface is the pipeline's
    (`train/pipeline.py:PipelineTrainLoop`), so that a CLI drives either:
      - `feed(*batch, draw=None)` runs a micro-step on the loader's batch,
        made by `aug_fn(batch, *draw)` when there is one (`draw` by default
        the state's (step, micro_step)), else its (images, labels) copied to
        `device`, and returns the micro-batch's loss (a 0-dim tensor);
      - `flush()` applies a trailing partial window and returns None;
      - `step`, `state` (what `CheckpointManager.save_full` takes),
        `weights(ema=False, device=None)` (a tensor-parallel model's
        slices) and `full_weights(ema=False)` (whole: a collective over
        the model group, which every rank of it must call)."""

    def __init__(self, state: TrainState, train_step: Callable, device: torch.device,
                 aug_fn: Optional[Callable] = None) -> None:
        self.state = state
        self.train_step = train_step
        self.flush_step = make_flush_step()
        self.device = torch.device(device)
        self.aug_fn = aug_fn

    def feed(self, *batch, draw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """Spans: `train.step` over `train.augment` (`aug_fn`) or
        `train.upload` (`batch_to`) and the step's."""
        st = self.state
        with span("train.step"):
            if self.aug_fn is not None:
                with span("train.augment", device=self.device):
                    images, labels = self.aug_fn(batch, *(draw if draw is not None else
                                                          (st.step, st.micro_step)))
            else:
                with span("train.upload", device=self.device):
                    images, labels = batch_to(batch, self.device)
            self.state, loss = self.train_step(st, images, labels)
        return loss

    def flush(self) -> None:
        self.state = self.flush_step(self.state)

    @property
    def step(self) -> int:
        return int(self.state.step)

    def weights(self, ema: bool = False, device: Optional[torch.device] = None
                ) -> Dict[str, torch.Tensor]:
        """The model's variables, or its EMA's, copied to `device` if given."""
        sd = self.state.ema.state_dict() if ema else self.state.model.state_dict()
        return sd if device is None else {k: v.to(device, non_blocking=True)
                                          for k, v in sd.items()}

    def full_weights(self, ema: bool = False) -> Dict[str, torch.Tensor]:
        """`weights`, a tensor-parallel model's slices gathered whole."""
        from cabinet_tpu_torch.models.tensor_parallel import gather_state

        return gather_state(self.weights(ema), self.state.model)


def make_eval_loss_step(
    model: nn.Module, n_min: int, thresh: float = 0.7, ignore_label: int = 255,
    class_weights=None, compute_dtype: torch.dtype = torch.float32,
    loss_type: str = "ohem", aux_weight: float = 1.0,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Validation loss of `model`'s raw weights in eval mode, full
    resolution (reference train.py:443-456): the train step's loss on both
    heads (OHEM (bisect) and aux_weight 1 by default, the JAX function's),
    under no_grad, with the model's own attention (K1 when it was built with
    `attention="kernel"`)."""
    seg_loss = _seg_loss(loss_type, n_min, thresh, ignore_label, class_weights)

    @torch.no_grad()
    def eval_loss(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        model.eval()
        final, aux = _forward(model, images, compute_dtype)
        return seg_loss(final, labels) + aux_weight * seg_loss(aux, labels)

    return eval_loss
