"""Shared CLI plumbing (counterpart of `cabinet_tpu.cli.common`): config
composition (a legacy JSON too), seeding, model, dataset and loader
construction, checkpoint loading, the warm start and the pretrained
backbone, and the eval settings.

`eval_tile_mesh` gives the rank group that shares each image's tiles in
`MscEval` (tile-sharded eval). Orbax checkpoint directories raise: the JAX
package's `cli/convert_checkpoint.py` turns them into a `.pth` or `.npz`.
"""

from __future__ import annotations

import argparse
import random
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cabinet_tpu_torch.core.config import Config, compose
from cabinet_tpu_torch.core.exceptions import ConfigurationError

REPO_ROOT = Path(__file__).resolve().parents[2]
CONFIG_DIR = REPO_ROOT / "configs"

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def parse_cli(argv: Optional[Sequence[str]], default_config: str,
              description: str) -> Tuple[Config, argparse.Namespace]:
    """Hydra-style CLI: positional key=value overrides, --config-name, and
    --device (CUDA unless "cpu" is asked for).

    ``--legacy-config path.json`` instead migrates a pre-Hydra legacy JSON
    (reference legacy/train_*.json) onto the modern ``train`` tree;
    positional overrides still apply on top (`core.legacy_config`)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config-name", default=default_config)
    p.add_argument("--config-dir", default=str(CONFIG_DIR))
    p.add_argument("--legacy-config", default=None, metavar="JSON",
                   help="pre-Hydra legacy JSON config to migrate and run")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    p.add_argument("overrides", nargs="*", help="key=value overrides")
    args = p.parse_args(argv)
    if args.legacy_config:
        from cabinet_tpu_torch.core.legacy_config import load_legacy_config

        cfg = load_legacy_config(args.legacy_config, args.config_dir, args.overrides)
    else:
        cfg = compose(args.config_dir, args.config_name, args.overrides)
    return cfg, args


def seed_everything(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators (reference
    train.py:36-43); the model's random init draws from torch's."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def compute_dtype_of(cfg: Config) -> torch.dtype:
    name = str(cfg.select("runtime.compute_dtype", "float32"))
    return _DTYPES[name]


def remat_of(cfg: Config) -> Any:
    """`runtime.remat`: false | true (every backbone block) | int N (the first
    N blocks). A bool() here would turn N into every block."""
    v = cfg.select("runtime.remat", False)
    if isinstance(v, (bool, int)):
        return v
    s = str(v).strip().lower()
    if s in ("true", "false"):
        return s == "true"
    try:
        return int(s)
    except ValueError:
        raise ConfigurationError(
            f"runtime.remat must be true|false|<int N>, got {v!r}") from None


def build_model(cfg: Config, n_classes: int):
    """CABiNet from `model.mode` and `model.cfgs`; `runtime.use_pallas`
    picks the attention kernel K1 for the CAB, else its einsum path;
    `runtime.remat` the backbone blocks rematerialised in training."""
    from cabinet_tpu_torch.models.cabinet import CABiNet

    return CABiNet(n_classes, mode=cfg.model.mode,
                   cfgs=[list(row) for row in cfg.model.cfgs],
                   attention="kernel" if bool(cfg.select("runtime.use_pallas", False))
                   else "einsum", remat=remat_of(cfg))


def build_datasets(cfg: Config, modes: Sequence[str]) -> List[Any]:
    from cabinet_tpu_torch.data.datasets import DATASET_KWARGS_BUILDERS, DATASET_REGISTRY

    name = cfg.dataset.name
    if name not in DATASET_REGISTRY:
        raise ConfigurationError(
            f"Unknown dataset '{name}'. Available: {sorted(DATASET_REGISTRY)}")
    cls = DATASET_REGISTRY[name]
    builder = DATASET_KWARGS_BUILDERS[name]
    if not cfg.dataset.dataset_path:
        raise ConfigurationError(
            "dataset_path is empty — set the dataset root env var for "
            f"'{name}' (see configs/dataset/{name}.yaml)")
    return [cls(**builder(cfg, mode)) for mode in modes]


def guard_val_batch(cfg: Config, dataset: Any, batch_size: int) -> None:
    """Variable-resolution datasets can't stack val batches > 1
    (reference train.py:233-241)."""
    if not getattr(dataset, "UNIFORM_RESOLUTION", True) and batch_size != 1:
        raise ConfigurationError(
            f"{dataset.NAME} has mixed native resolutions; "
            f"validation batch_size must be 1 (got {batch_size}).")


def load_model_variables(checkpoint_path: str, model: Any) -> Dict[str, torch.Tensor]:
    """The state dict for `model` from a `.pth` (a state dict, a reference
    training checkpoint, or a full training checkpoint of
    `train.checkpoint.CheckpointManager.save_full`) or a JAX variables
    `.npz`. An orbax directory raises (`train.checkpoint.load_any_checkpoint`)."""
    from cabinet_tpu_torch.cli.infer import load_state_dict

    return load_state_dict(checkpoint_path, model)


def warm_start(model: torch.nn.Module, checkpoint_path: str) -> List[str]:
    """Cross-dataset warm start (reference train.py:126-176): load the
    tensors of a `.pth` or `.npz` whose names and shapes match the model's,
    keep the model's own elsewhere (a classifier head of another class
    count is skipped), as `merge_variables(match_shapes=True)` of the JAX
    package does. Returns the keys loaded."""
    from cabinet_tpu_torch.train.checkpoint import load_any_checkpoint

    loaded = load_any_checkpoint(checkpoint_path, model)
    own = model.state_dict()
    keys = [k for k, v in loaded.items()
            if k in own and tuple(v.shape) == tuple(own[k].shape)]
    model.load_state_dict({**own, **{k: loaded[k] for k in keys}}, strict=True)
    return keys


def load_pretrained_backbone(model: torch.nn.Module, path: Path) -> List[str]:
    """Load an ImageNet MobileNetV3 `.pth` (keys `features.*`, `conv.*`,
    `classifier.*`) into `model.mobile`: `features.*` -> `mobile.features.*`,
    the classifier skipped, as `backbone_torch_to_flax` of the JAX package
    maps it. Every backbone tensor of the model must be in the file (BN step
    counters aside). Returns the keys loaded."""
    from cabinet_tpu_torch.train.checkpoint import load_any_checkpoint

    blob = load_any_checkpoint(path)
    sd = {f"mobile.{k}": v for k, v in blob.items() if not k.startswith("classifier")}
    own = model.state_dict()
    need = [k for k in own if k.startswith("mobile.")
            and not k.endswith("num_batches_tracked")]
    missing = [k for k in need if k not in sd]
    if missing:
        raise ConfigurationError(f"{path} lacks backbone tensors, e.g. {missing[:3]}")
    keys = [k for k in own if k in sd]
    model.load_state_dict({**own, **{k: sd[k] for k in keys}}, strict=True)
    return keys


def make_loader(cfg: Config, dataset: Any, batch_size: int, *,
                shuffle: bool = False, drop_last: bool = False,
                num_workers: int = 4, seed: int = 0,
                shard: Any = None) -> Any:
    """The input pipeline of `runtime.loader`: `thread` (data/loader.py, the
    default) or `grain` (data/grain_loader.py, worker processes), with the
    JAX package's batch order for `shuffle`, `drop_last`, `seed` and
    `shard=(index, count)`: the thread loader takes every count-th sample
    of the order from `index` on (the JAX loader's), the process loader a
    contiguous share (grain's)."""
    kind = str(cfg.select("runtime.loader", "thread")).lower()
    if kind == "grain":
        from cabinet_tpu_torch.data.grain_loader import GrainLoader

        return GrainLoader(dataset, batch_size, shuffle=shuffle, drop_last=drop_last,
                           num_workers=num_workers, seed=seed, shard=shard)
    if kind != "thread":
        raise ConfigurationError(
            f"runtime.loader must be 'thread' or 'grain', got {kind!r}")
    from cabinet_tpu_torch.data.loader import DataLoader

    return DataLoader(dataset, batch_size, shuffle=shuffle, drop_last=drop_last,
                      num_workers=num_workers, seed=seed, shard=shard)


def eval_tile_batch(cfg: Config) -> int:
    """Tiles folded into one sliding-window forward (runtime.eval_tile_batch;
    0 = auto: the port's `MscEval` `TILE_BATCH`, not the 64 the JAX package
    measured on a TPU)."""
    from cabinet_tpu_torch.eval.evaluator import TILE_BATCH

    return int(cfg.select("runtime.eval_tile_batch", 0)) or TILE_BATCH


def eval_acc_dtype(cfg: Config) -> Optional[torch.dtype]:
    """Probability-accumulation dtype (runtime.eval_acc_dtype):
    auto (None -> MscEval follows compute_dtype) | float32 | bfloat16."""
    s = str(cfg.select("runtime.eval_acc_dtype", "auto")).lower()
    try:
        return {"auto": None, "float32": torch.float32,
                "bfloat16": torch.bfloat16}[s]
    except KeyError:
        raise ConfigurationError(
            f"runtime.eval_acc_dtype must be auto|float32|bfloat16, got {s!r}") from None


def eval_pad_to(cfg: Config) -> Any:
    """(H, W) eval resolution bucket (validation_config.eval_pad_to), or the
    dataset's declared bucket (dataset.eval_pad_to), or None."""
    return (cfg.select("validation_config.eval_pad_to", None)
            or cfg.select("dataset.eval_pad_to", None))


def eval_tile_mesh(cfg: Config) -> Optional[Tuple[int, int]]:
    """The rank group `(rank, R)` whose ranks share each image's tile grid in
    `MscEval` (tile-sharded eval), when this process is one of R > 1 ranks
    on the data axis of the current mesh (`core/mesh.py:current`) and
    runtime.tile_parallel_eval is true (the default); else None, and each
    data rank scores its share of the frames."""
    from cabinet_tpu_torch.core import mesh

    d, n_data = mesh.data_world()
    if not bool(cfg.select("runtime.tile_parallel_eval", True)) or n_data == 1:
        return None
    return d, n_data
