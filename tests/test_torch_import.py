"""The port stands alone: cabinet_tpu_torch imports no JAX, no Flax and
nothing of cabinet_tpu, and its entry points never drop to the CPU
unasked."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

PKG = Path(__file__).resolve().parent.parent / "cabinet_tpu_torch"

_GUARD = r"""
import importlib, pkgutil, sys
import cabinet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cabinet_tpu_torch.__path__,
                                              "cabinet_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "cabinet_tpu"))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 44, names
required = {"cabinet_tpu_torch." + m for m in (
    "cli.train", "cli.common", "core.logging", "core.config", "core.yaml_subset",
    "data.transforms", "data.class_weights", "data.datasets", "train",
    "train.losses", "train.optimizer", "train.ema", "train.early_stopping",
    "train.trainer", "train.checkpoint", "ops.photometric", "ops.geometric")}
assert required <= set(names), sorted(required - set(names))
"""


def test_import_guard_subprocess():
    """A fresh interpreter (tests/conftest.py imports jax into this one)
    imports every submodule and finds no JAX-side module loaded."""
    res = subprocess.run([sys.executable, "-c", _GUARD], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_source_scan_has_no_jax_imports():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|cabinet_tpu)(\.|\s|$)",
        re.MULTILINE)
    offenders = [str(p) for p in PKG.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert not offenders, offenders


def test_no_kernel_build_at_import():
    """Importing the kernel modules compiles and loads nothing."""
    from cabinet_tpu_torch.ops import _build

    import cabinet_tpu_torch.ops.attention  # noqa: F401
    import cabinet_tpu_torch.ops.decoder_tail  # noqa: F401
    import cabinet_tpu_torch.ops.early_stage  # noqa: F401

    assert _build._LOADED == {}


@pytest.mark.parametrize("entry", ["segmenter", "fused_tail", "fused_apply",
                                   "msc_eval", "eval_forward", "evaluate_main",
                                   "resolve_device", "train_main", "train_and_evaluate"])
def test_entry_points_default_to_cuda(entry, tmp_path):
    """Without device="cpu" the entry points ask for CUDA, and raise where
    there is none instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs there")
    from cabinet_tpu_torch.cli.evaluate import main as evaluate_main
    from cabinet_tpu_torch.cli.evaluate import make_eval_forward
    from cabinet_tpu_torch.cli.common import CONFIG_DIR
    from cabinet_tpu_torch.cli.infer import Segmenter
    from cabinet_tpu_torch.cli.train import main as train_main
    from cabinet_tpu_torch.cli.train import train_and_evaluate
    from cabinet_tpu_torch.core.config import compose
    from cabinet_tpu_torch.core.device import resolve_device
    from cabinet_tpu_torch.eval.evaluator import MscEval
    from cabinet_tpu_torch.models.cabinet import CABiNet
    from cabinet_tpu_torch.models.fused import make_fused_apply, make_fused_tail_apply

    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "segmenter":
            Segmenter(str(tmp_path / "unused.pth"), "uavid", imgsz=64)
        elif entry == "fused_tail":
            make_fused_tail_apply(CABiNet(8, "small", cfgs=[[3, 1, 16, 1, 0, 2]]))
        elif entry == "fused_apply":
            make_fused_apply(CABiNet(8, "large", cfgs=[[3, 1, 16, 0, 0, 1]]))
        elif entry == "msc_eval":
            MscEval(lambda v, x: (x, x), 8)
        elif entry == "eval_forward":
            make_eval_forward(CABiNet(8, "small", cfgs=[[3, 1, 16, 1, 0, 2]]), 256)
        elif entry == "evaluate_main":
            evaluate_main([f"checkpoint_path={tmp_path / 'unused.pth'}",
                           f"dataset.dataset_path={tmp_path}"])
        elif entry == "train_main":
            train_main([f"dataset.dataset_path={tmp_path}"])
        elif entry == "train_and_evaluate":
            train_and_evaluate(compose(CONFIG_DIR, "train",
                                       [f"dataset.dataset_path={tmp_path}"]))
        else:
            resolve_device()
