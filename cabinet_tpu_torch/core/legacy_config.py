"""Pre-Hydra legacy JSON config loader (counterpart of
`cabinet_tpu.core.legacy_config`; reference legacy/train_*.json).

The reference ships two historical JSON configs (``legacy/train_uavid.json``,
``legacy/train_citys.json``) from before its Hydra migration; they are still
read by the Cityscapes ``__main__`` smoke test (reference
src/datasets/cityscapes.py:177-199). Rather than carrying the old schema
through the framework, this module MIGRATES a legacy JSON onto the composed
modern config tree: the dataset/model groups are selected from the JSON's
``dataset_config.name`` / ``training_config.backbone_weights`` and every
legacy key is mapped to its dotted modern path, so ``cli.train`` runs a
legacy file unchanged::

    python -m cabinet_tpu_torch.cli.train --legacy-config legacy/train_uavid.json

Key mapping quirks preserved from the reference schema:
- ``warmup_stemps`` (the reference's typo, legacy/train_citys.json:19) and
  ``warmup_steps`` both map to ``training_config.warmup_steps``.
- ``msg_iterations`` maps to ``training_config.log_iter``.
- ``gpu_id`` / ``shuffle`` are accepted and ignored (the device is the
  CLI's ``--device``; the train loader always shuffles, reference
  train.py:250).
- an empty/missing ``dataset_path`` keeps the modern ``${oc.env:...}``
  resolver instead of clobbering it with ''.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

from cabinet_tpu_torch.core.config import Config, compose
from cabinet_tpu_torch.core.exceptions import ConfigurationError

# legacy key -> modern dotted path (None = accepted but ignored)
_DATASET_KEYS = {
    "name": None,  # handled as the dataset group selection
    "dataset_config_file": "dataset.config_file",
    "num_classes": "dataset.num_classes",
    "cropsize": "dataset.cropsize",
    "dataset_path": "dataset.dataset_path",
    "ignore_idx": "dataset.ignore_idx",
    "shuffle": None,
}
_TRAINING_KEYS = {
    "batch_size": "training_config.batch_size",
    "num_workers": "training_config.num_workers",
    "gpu_id": None,
    "optimizer_momentum": "training_config.optimizer_momentum",
    "optimizer_weight_decay": "training_config.optimizer_weight_decay",
    "optimizer_lr_start": "training_config.optimizer_lr_start",
    "optimizer_power": "training_config.optimizer_power",
    "warmup_stemps": "training_config.warmup_steps",
    "warmup_steps": "training_config.warmup_steps",
    "warmup_start_lr": "training_config.warmup_start_lr",
    "max_iterations": "training_config.max_iterations",
    "msg_iterations": "training_config.log_iter",
    "experiments_path": "training_config.experiments_path",
    "model_save_name": "training_config.model_save_name",
    "backbone_weights": None,  # handled as the model group selection
    "epochs": "training_config.epochs",
}
_VALIDATION_KEYS = {
    "batch_size": "validation_config.batch_size",
    "eval_scales": "validation_config.eval_scales",
    "validation_output_folder": "validation_config.results_path",
    "flip": "validation_config.flip",
}


def _fmt(value: Any) -> str:
    """Render a JSON value as a CLI-override literal the composer parses back.

    Floats are rendered in non-exponent decimal: ``str(1e-5)`` is ``'1e-05'``,
    which the YAML 1.1 float regex (requires a dot in the mantissa) parses
    back as a STRING — ``warmup_start_lr`` from both shipped legacy JSONs
    would land in the config as ``str``. ``Decimal(repr(v))``
    keeps the shortest-repr digits exactly.
    """
    if isinstance(value, float):
        from decimal import Decimal

        return format(Decimal(repr(value)), "f")
    if isinstance(value, list):
        # json.dumps(1e-05) emits '1e-05' — the same YAML-regex trap as the
        # scalar case, just nested (e.g. eval_scales) — so floats (and
        # sublists) recurse through this formatter; strings keep their JSON
        # quoting (top-level strings stay bare for path-like values)
        return "[" + ", ".join(
            _fmt(v) if isinstance(v, (float, list)) else json.dumps(v)
            for v in value) + "]"
    return json.dumps(value) if isinstance(value, bool) else str(value)


def legacy_to_overrides(data: Dict[str, Any]) -> List[str]:
    """Translate a legacy JSON dict into (group + dotted) override strings."""
    for section in ("dataset_config", "training_config", "validation_config"):
        if section not in data:
            raise ConfigurationError(
                f"legacy config missing required section '{section}'")

    overrides: List[str] = []

    name = data["dataset_config"].get("name")
    if not name:
        raise ConfigurationError("legacy dataset_config.name is required")
    overrides.append(f"dataset={name}")

    backbone = str(data["training_config"].get("backbone_weights", ""))
    if backbone:
        mode = "small" if "small" in backbone else "large"
        overrides.append(f"model=mobilenetv3_{mode}")

    for section, table in (("dataset_config", _DATASET_KEYS),
                           ("training_config", _TRAINING_KEYS),
                           ("validation_config", _VALIDATION_KEYS)):
        for key, value in data[section].items():
            if key not in table:
                raise ConfigurationError(
                    f"unknown legacy key '{section}.{key}' "
                    f"(known: {sorted(table)})")
            path = table[key]
            if path is None:
                continue
            if key in ("dataset_path", "dataset_config_file") and not value:
                continue  # keep the modern env-resolver / built-in palette
            overrides.append(f"{path}={_fmt(value)}")
    return overrides


def load_legacy_config(
    json_path: Union[str, Path],
    config_dir: Optional[Union[str, Path]] = None,
    extra_overrides: Sequence[str] = (),
) -> Config:
    """Compose the modern ``train`` tree with a legacy JSON mapped on top.

    ``extra_overrides`` (CLI ``key=value`` strings) apply AFTER the legacy
    values, so users can migrate incrementally.
    """
    path = Path(json_path)
    if not path.exists():
        raise ConfigurationError(f"legacy config not found: {path}")
    try:
        data = json.loads(path.read_text())
    except json.JSONDecodeError as e:
        raise ConfigurationError(f"legacy config {path} is not valid JSON: {e}")

    if config_dir is None:
        config_dir = Path(__file__).resolve().parents[2] / "configs"
    overrides = legacy_to_overrides(data) + list(extra_overrides)
    return compose(config_dir, "train", overrides)
