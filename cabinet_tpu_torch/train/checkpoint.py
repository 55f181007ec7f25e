"""Checkpoints of the training state and of model variables, as `.pth`
files (counterpart of `cabinet_tpu.train.checkpoint`, whose format is
orbax).

`CheckpointManager.save_full` writes `<name>.pth` with the fields of the JAX
tree (`checkpoint.py:48-72`): `params` and `batch_stats` (the model's
parameters and BatchNorm buffers, by state-dict key), `opt_state` (the SGD
momentum, `torch.optim` state dict), `step`, `micro_step`, `accum_grads`
(the window's summed gradients, by parameter name), `ema_variables` (the
EMA shadow, a state dict) and `ema_updates`; and the same
`<name>.meta.json` sidecar (epoch, best mIoU and loss, early-stop state).
`restore_full` puts all of it back, so that a resumed run continues
bit-exactly. Given a list of stage states, both go to
`save_pipeline_full` and `restore_pipeline_full`, which do the same for a
pipeline-parallel run (`train/pipeline.py`): one tree a stage (its
part of the variables, its optimizer state, step and EMA; a window never
spans a checkpoint, the epoch's flush closes it) under `stages`, and
`pipeline_stages` in the sidecar, as the JAX package writes them.
`save_variables` writes a model state dict (the EMA weights of
`<name>_best` and the final `<name>`), the reference `.pth` format that
`cli/evaluate.py` and `cli/infer.py` load.

A tensor-parallel run (`models/tensor_parallel.py`) writes the same files
as a one-rank run, as JAX's orbax save writes global arrays: its slices
(the model's, the momentum's, the EMA's and the window's gradients) are
gathered whole over the model group before the write, so every rank of
the group calls `save_full`; a restore cuts the whole tensors to the
slices the state holds, under any layout. The manager writes on the
process group's rank 0 only.

An orbax checkpoint directory raises: reading one needs orbax and
tensorstore. Convert it with the JAX package's `cli/convert_checkpoint.py`.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from cabinet_tpu_torch.core import mesh
from cabinet_tpu_torch.core.exceptions import ModelLoadError
from cabinet_tpu_torch.models import tensor_parallel as tp

_NO_META = {"epoch": 0, "best_miou": 0.0, "best_loss": float("inf"),
            "early_stop_best_fitness": 0.0, "early_stop_best_epoch": 0}


def _cpu(tree: Any) -> Any:
    """A copy of `tree` with every tensor on the CPU (torch.save keeps the
    device otherwise)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _save(obj: Any, path: Path) -> None:
    """torch.save through a temporary file and a rename, so that a reader
    never sees half a checkpoint."""
    tmp = path.with_name(path.name + f".tmp{os.getpid()}")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _load(path: Path) -> Any:
    return torch.load(str(path), map_location="cpu", weights_only=True)


def _momentum(optimizer: Any, model: Any, fn: Any) -> dict:
    """The optimizer's state dict with its momentum buffers, by parameter
    name, replaced by `fn(buffers)`'s."""
    sd = optimizer.state_dict()
    names = tp.by_name(optimizer.parameters(), model)
    bufs = {names[i]: st["momentum_buffer"] for i, st in sd["state"].items()
            if st.get("momentum_buffer") is not None}
    new = fn(bufs)
    return {**sd, "state": {i: ({**st, "momentum_buffer": new[names[i]]}
                                if names[i] in new else st)
                            for i, st in sd["state"].items()}}


class CheckpointManager:
    """`.pth` checkpoints under `directory`, with a metadata sidecar,
    written by the process group's rank 0 (`writes`)."""

    def __init__(self, directory: Union[str, Path]):
        self.directory = Path(directory).resolve()
        self.writes = mesh.world()[0] == 0
        if self.writes:
            self.directory.mkdir(parents=True, exist_ok=True)

    def path(self, name: str) -> Path:
        return self.directory / f"{name}.pth"

    # ---------------------------------------------------------------- full
    @staticmethod
    def _state_tree(state: Any) -> Dict[str, Any]:
        """The state's tree, a tensor-parallel model's slices gathered whole
        (a collective over its model group)."""
        model = state.model
        params = dict(model.named_parameters())
        sd = tp.gather_state(model.state_dict(), model)
        return {
            "params": {k: v for k, v in sd.items() if k in params},
            "batch_stats": {k: v for k, v in sd.items() if k not in params},
            "opt_state": _momentum(state.optimizer, model,
                                   lambda b: tp.gather_state(b, model)),
            "step": int(state.step),
            "ema_variables": tp.gather_state(state.ema.state_dict(), model),
            "ema_updates": int(state.ema.updates),
        }

    @staticmethod
    def _restore_state(state: Any, tree: Dict[str, Any]) -> None:
        """Into `state`, whole tensors cut to the slices its model holds."""
        model = state.model
        model.load_state_dict(tp.shard_state({**tree["params"], **tree["batch_stats"]}, model),
                              strict=True)
        state.optimizer.load_state_dict(tree["opt_state"])
        if tp.mesh_of(model) is not None:
            sliced = _momentum(state.optimizer, model, lambda b: tp.shard_state(b, model))
            state.optimizer.load_state_dict(sliced)
        state.step = int(tree["step"])
        state.ema.load_state_dict(tp.shard_state(tree["ema_variables"], model),
                                  tree["ema_updates"])

    def _save_tree(self, name: str, tree: Dict[str, Any], epoch: int, best_miou: float,
                   best_loss: float, stopper_state: Dict[str, Any], **extra) -> Path:
        path = self.path(name)
        if not self.writes:
            return path
        _save(_cpu(tree), path)
        meta = {
            "epoch": int(epoch),
            "best_miou": float(best_miou),
            "best_loss": float(best_loss),
            "early_stop_best_fitness": float(stopper_state["best_fitness"]),
            "early_stop_best_epoch": int(stopper_state["best_epoch"]),
            **extra,
        }
        (self.directory / f"{name}.meta.json").write_text(json.dumps(meta))
        return path

    def _load_tree(self, name: str) -> Optional[Tuple[Dict[str, Any], Dict[str, Any]]]:
        path = self.path(name)
        if not path.exists():
            return None
        meta_path = self.directory / f"{name}.meta.json"
        meta = json.loads(meta_path.read_text()) if meta_path.exists() else dict(_NO_META)
        return _load(path), meta

    def save_full(self, name: str, state: Any, epoch: int, best_miou: float,
                  best_loss: float, stopper_state: Dict[str, Any]) -> Path:
        """`state` a `TrainState`, or a pipeline's list of stage states
        (`save_pipeline_full`). Every rank of a tensor-parallel model's
        group calls it."""
        if isinstance(state, (list, tuple)):
            return self.save_pipeline_full(name, state, epoch, best_miou, best_loss,
                                           stopper_state)
        if not self.writes and tp.mesh_of(state.model) is None:
            return self.path(name)
        tree = {**self._state_tree(state), "micro_step": int(state.micro_step),
                "accum_grads": tp.gather_state(state.accum_grads, state.model)}
        return self._save_tree(name, tree, epoch, best_miou, best_loss, stopper_state)

    def restore_full(self, name: str, state: Any) -> Optional[Dict[str, Any]]:
        """Restore into `state` (its model, optimizer, EMA and counters, in
        place; a pipeline's list of stage states through
        `restore_pipeline_full`); None if the checkpoint is absent."""
        if isinstance(state, (list, tuple)):
            return self.restore_pipeline_full(name, state)
        loaded = self._load_tree(name)
        if loaded is None:
            return None
        tree, meta = loaded
        self._restore_state(state, tree)
        state.micro_step = int(tree["micro_step"])
        state.load_accum_grads(tp.shard_state(tree["accum_grads"], state.model))
        return {"state": state, **meta}

    # ------------------------------------------------------------ pipeline
    def save_pipeline_full(self, name: str, states: Sequence[Any], epoch: int,
                           best_miou: float, best_loss: float,
                           stopper_state: Dict[str, Any]) -> Path:
        """A pipeline-parallel run's full state: one tree a stage."""
        if not self.writes and all(tp.mesh_of(s.model) is None for s in states):
            return self.path(name)
        tree = {"stages": [self._state_tree(s) for s in states]}
        return self._save_tree(name, tree, epoch, best_miou, best_loss, stopper_state,
                               pipeline_stages=len(states))

    def restore_pipeline_full(self, name: str, states: Sequence[Any]
                              ) -> Optional[Dict[str, Any]]:
        """Restore each stage's state in place; None if the checkpoint is
        absent. Raises when it holds another number of stages."""
        loaded = self._load_tree(name)
        if loaded is None:
            return None
        tree, meta = loaded
        if len(tree.get("stages", ())) != len(states):
            raise ModelLoadError(f"{self.path(name)} holds {len(tree.get('stages', ()))} "
                                 f"pipeline stages, the run has {len(states)}")
        for s, t in zip(states, tree["stages"]):
            self._restore_state(s, t)
        return {"states": list(states), **meta}

    # ------------------------------------------------------------ variables
    def save_variables(self, name: str, variables: Dict[str, torch.Tensor]) -> Path:
        """A whole state dict (a tensor-parallel run's gathered first)."""
        path = self.path(name)
        if self.writes:
            _save(_cpu(dict(variables)), path)
        return path

    def restore_variables(self, name: str) -> Dict[str, torch.Tensor]:
        path = self.path(name)
        if not path.exists():
            raise ModelLoadError(f"Checkpoint not found: {path}")
        return _load(path)


def load_any_checkpoint(path: Union[str, Path], model: Any = None
                        ) -> Dict[str, torch.Tensor]:
    """A model state dict from a `.pth` (a state dict, a full training
    checkpoint of `save_full` or `save_pipeline_full`, whose raw params and
    BN buffers it takes,
    or a reference training checkpoint with `model_state`/`ema_state`) or
    from a JAX variables `.npz` of a CABiNet or a YOLOSem (through
    `utils.convert`, which needs `model` for its key table: the cfg table or
    the variant). An orbax directory raises NotImplementedError."""
    path = Path(path)
    if path.is_dir():
        raise NotImplementedError(
            f"{path} is a directory: orbax checkpoints need orbax and tensorstore, "
            f"which the port does not use; convert it with the JAX package's "
            f"cli/convert_checkpoint.py to a .pth or .npz")
    if path.suffix in (".pth", ".pt"):
        blob = _load(path)
        if isinstance(blob, dict) and "params" in blob and "opt_state" in blob:
            return {**blob["params"], **blob["batch_stats"]}
        if isinstance(blob, dict) and "stages" in blob:  # save_pipeline_full's
            return {k: v for t in blob["stages"] for k, v in {**t["params"],
                                                              **t["batch_stats"]}.items()}
        if isinstance(blob, dict) and "model_state" in blob:
            blob = blob.get("ema_state") or blob["model_state"]
        if not isinstance(blob, dict):
            raise ModelLoadError(f"Unrecognized checkpoint format: {path}")
        return blob
    if path.suffix == ".npz":
        from cabinet_tpu_torch.utils.convert import model_state_dict_from_jax

        if model is None:
            raise ModelLoadError(f"{path}: a JAX .npz needs the model's key table")
        with np.load(path) as data:
            return model_state_dict_from_jax({k: data[k] for k in data.files}, model)
    raise ModelLoadError(f"Unrecognized checkpoint: {path}")
