"""Checkpoint conversion CLI: reference torch .pth <-> the port's .pth or a
JAX variables .npz (counterpart of `cabinet_tpu.cli.convert_checkpoint`,
whose other side is an orbax directory).

Both interop directions (reference train.py:54-123 checkpoint kinds):
  - import: a published HF / reference .pth (raw state dict, EMA dict, or a
    full training checkpoint) -> the port's .pth (a state dict that
    `CABiNet.load_state_dict(strict=True)` takes) or, for a `dst` ending in
    `.npz`, JAX variables under flat "params/..." / "batch_stats/..." keys
    (`utils/convert.py:jax_variables_from_state_dict`, JAX's
    `torch_to_flax`);
  - export: the port's .pth (any checkpoint `train/checkpoint.py` reads) or
    a JAX variables .npz -> a reference-compatible torch state dict
    (`utils/convert.py:reference_state_dict`, JAX's `flax_to_torch`),
    loadable by the reference's evaluate.py / train.py warm start.
Orbax directories are not read: orbax is not a dependency of the port.

Usage:
    python -m cabinet_tpu_torch.cli.convert_checkpoint import cabinet.pth out.pth \\
        [--mode large|small|auto]
    python -m cabinet_tpu_torch.cli.convert_checkpoint import cabinet.pth out.npz
    python -m cabinet_tpu_torch.cli.convert_checkpoint export ck.pth out.pth \\
        --mode large --n-classes 8
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch


def _detect_mode(sd) -> str:
    for k, v in sd.items():
        if k == "mobile.conv.0.weight" and hasattr(v, "shape"):
            return "large" if v.shape[0] == 960 else "small"
    return "large"


def _checked(sd: Dict[str, torch.Tensor], n_classes: int, mode: str, cfgs) -> None:
    """Raise unless `sd` loads into a CABiNet of that shape with
    load_state_dict(strict=True) (BN step counters may be absent)."""
    from cabinet_tpu_torch.models.cabinet import CABiNet

    model = CABiNet(n_classes, mode=mode, cfgs=cfgs)
    own = model.state_dict()
    model.load_state_dict({**{k: v for k, v in own.items()
                              if k.endswith("num_batches_tracked")}, **sd}, strict=True)


def do_import(src: Path, dst: Path, mode: str = "auto", cfgs=None) -> Dict[str, np.ndarray]:
    """Write `src`'s weights to `dst` (.pth: the port's state dict; .npz:
    JAX variables, as the JAX import's `torch_to_flax(..., strict=False)`
    gives them); returns what was written, as numpy arrays."""
    from cabinet_tpu_torch.models.mobilenetv3 import default_cfgs
    from cabinet_tpu_torch.train.checkpoint import _save, load_any_checkpoint
    from cabinet_tpu_torch.utils.convert import (
        flat_variables,
        jax_variables_from_state_dict,
        state_dict_from_jax,
    )

    sd = load_any_checkpoint(src)
    if mode == "auto":
        mode = _detect_mode(sd)
    cfgs = cfgs or default_cfgs(mode)
    variables = jax_variables_from_state_dict(sd, cfgs, strict=dst.suffix != ".npz")
    dst.parent.mkdir(parents=True, exist_ok=True)
    if dst.suffix == ".npz":
        flat = flat_variables(variables)
        np.savez(dst, **flat)
        print(f"[DONE] {src} ({mode}) -> {dst} ({len(flat)} arrays)")
        return flat
    port = state_dict_from_jax(variables, cfgs)
    _checked(port, int(port["conv_out.conv_out.weight"].shape[0]), mode, cfgs)
    port = {k: v for k, v in port.items() if not k.endswith("num_batches_tracked")}
    _save(port, dst)
    print(f"[DONE] {src} ({mode}) -> {dst} ({len(port)} tensors)")
    return {k: v.numpy() for k, v in port.items()}


def do_export(src: Path, dst: Path, mode: str = "large", n_classes: int = 8,
              cfgs=None) -> Dict[str, torch.Tensor]:
    """Write `src` (the port's .pth or a JAX variables .npz) as a
    reference-compatible state dict to `dst`; returns it."""
    from cabinet_tpu_torch.models.mobilenetv3 import default_cfgs
    from cabinet_tpu_torch.train.checkpoint import _save, load_any_checkpoint
    from cabinet_tpu_torch.utils.convert import (
        jax_variables_from_state_dict,
        reference_state_dict,
    )

    cfgs = cfgs or default_cfgs(mode)
    if src.suffix == ".npz":
        with np.load(src) as data:
            variables = {k: data[k] for k in data.files}
    else:
        variables = jax_variables_from_state_dict(load_any_checkpoint(src), cfgs)
    sd = {k: torch.from_numpy(v.copy()) for k, v in reference_state_dict(variables, cfgs).items()}
    _checked(sd, n_classes, mode, cfgs)
    dst.parent.mkdir(parents=True, exist_ok=True)
    _save(sd, dst)
    print(f"[DONE] {src} -> {dst} ({len(sd)} tensors)")
    return sd


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("import", help="reference .pth -> the port's .pth or JAX .npz")
    pi.add_argument("src", type=Path)
    pi.add_argument("dst", type=Path)
    pi.add_argument("--mode", default="auto", choices=["auto", "large", "small"])

    pe = sub.add_parser("export", help="the port's .pth or JAX .npz -> reference .pth")
    pe.add_argument("src", type=Path)
    pe.add_argument("dst", type=Path)
    pe.add_argument("--mode", default="large", choices=["large", "small"])
    pe.add_argument("--n-classes", type=int, default=8)

    args = p.parse_args(argv)
    if args.cmd == "import":
        do_import(args.src, args.dst, args.mode)
    else:
        do_export(args.src, args.dst, args.mode, args.n_classes)


if __name__ == "__main__":
    main()
