"""Prediction visualizer (counterpart of `cabinet_tpu.cli.visualize`;
reference src/scripts/visualize.py:24-248).

Writes input / colorized prediction / overlay / colorized GT PNGs for up to
VISUALIZATION_SAMPLE_LIMIT samples of a split, with the multi-scale + flip
inference of `MscEval` through `cli/evaluate.py:make_eval_forward`: with
`runtime.use_pallas=true` in bf16 the CAB runs the attention kernel K1 and
the decoder tail K2 and K3 on CUDA. Works for any registered dataset
(palettes from data/palettes.py); the PNGs are written by the port's own
encoder (`data/decode.py:save_png`).

Usage (CUDA unless --device cpu):
    python -m cabinet_tpu_torch.cli.visualize checkpoint_path=... dataset=uavid \\
        +num_samples=10 +output_dir=viz

Under torchrun the ranks share each frame's tiles (tile-sharded eval,
`cli/common.py:eval_tile_mesh`) and rank 0 writes the PNGs.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np
import torch

from cabinet_tpu_torch.cli import common
from cabinet_tpu_torch.core.constants import VISUALIZATION_SAMPLE_LIMIT
from cabinet_tpu_torch.core.logging import setup_logger


def visualize(cfg, device: Union[str, torch.device] = "cuda") -> Path:
    from cabinet_tpu_torch.cli.evaluate import make_eval_forward
    from cabinet_tpu_torch.cli.train import join_ranks
    from cabinet_tpu_torch.core import mesh
    from cabinet_tpu_torch.data.decode import save_png
    from cabinet_tpu_torch.data.loader import DataLoader
    from cabinet_tpu_torch.data.palettes import PALETTES, colorize_mask
    from cabinet_tpu_torch.eval.evaluator import MscEval

    logger = setup_logger("cabinet_tpu_torch.visualize")
    device = join_ranks(cfg, device)
    primary = mesh.world()[0] == 0
    vc = cfg.validation_config
    split = cfg.get("split", "val")
    (dataset,) = common.build_datasets(cfg, [split])

    n_classes = cfg.dataset.num_classes
    model = common.build_model(cfg, n_classes)
    model.load_state_dict(common.load_model_variables(cfg.checkpoint_path, model),
                          strict=True)
    crop = max(cfg.dataset.cropsize)
    dtype = common.compute_dtype_of(cfg)
    fused_tail = str(cfg.select("runtime.fused_tail", "auto")).lower()
    fwd = make_eval_forward(model, crop, device, dtype,
                            use_pallas=bool(cfg.select("runtime.use_pallas", False)),
                            fused_tail=fused_tail if fused_tail in ("auto", "true") else "false")
    evaluator = MscEval(fwd, n_classes, ignore_label=cfg.dataset.ignore_idx,
                        scales=tuple(vc.eval_scales), flip=bool(vc.flip), cropsize=crop,
                        compute_dtype=dtype, tile_batch=common.eval_tile_batch(cfg),
                        acc_dtype=common.eval_acc_dtype(cfg), device=device,
                        tile_mesh=common.eval_tile_mesh(cfg))

    classes = PALETTES[cfg.dataset.name]
    out_dir = Path(cfg.get("output_dir", "visualizations"))
    out_dir.mkdir(parents=True, exist_ok=True)
    limit = min(int(cfg.get("num_samples", VISUALIZATION_SAMPLE_LIMIT)),
                VISUALIZATION_SAMPLE_LIMIT)

    mean = np.asarray(dataset.MEAN, np.float32)
    std = np.asarray(dataset.STD, np.float32)

    dl = DataLoader(dataset, batch_size=1, num_workers=2)
    for i, (img, lb) in enumerate(dl):
        if i >= limit:
            break
        preds, _ = evaluator.evaluate_batch(None, img, lb)
        if not primary:
            continue
        pred = preds[0]
        rgb = np.clip((img[0] * std + mean) * 255, 0, 255).astype(np.uint8)
        pred_rgb = colorize_mask(pred, classes)
        gt_rgb = colorize_mask(lb[0], classes)
        overlay = (0.5 * rgb + 0.5 * pred_rgb).astype(np.uint8)

        save_png(out_dir / f"{i:04d}_input.png", rgb)
        save_png(out_dir / f"{i:04d}_pred.png", pred_rgb)
        save_png(out_dir / f"{i:04d}_overlay.png", overlay)
        save_png(out_dir / f"{i:04d}_gt.png", gt_rgb)
        logger.info(f"saved sample {i}")
    return out_dir


def main(argv: Optional[Sequence[str]] = None) -> Path:
    from cabinet_tpu_torch.core import mesh

    cfg, args = common.parse_cli(argv, "evaluate", "Visualize predictions")
    try:
        out = visualize(cfg, device=args.device)
    finally:
        mesh.teardown()
    print(f"Visualizations written to {out}")
    return out


if __name__ == "__main__":
    main()
