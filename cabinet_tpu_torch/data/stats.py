"""Dataset mean/std computation (counterpart of `cabinet_tpu.data.stats`),
reading images with the port's `data.decode.open_rgb`: PNG of every colour
type by its own reader, other formats through the PIL backend."""

from __future__ import annotations

import os
import os.path as osp
from typing import Tuple

import numpy as np

from cabinet_tpu_torch.data.decode import open_rgb


def compute_dataset_stats(image_dir: str,
                          extensions: Tuple[str, ...] = (".png", ".jpg", ".jpeg"),
                          max_images: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel mean/std over images in a directory (values in [0,1]).

    The JAX package's accumulation (the reference scripts', e.g.
    compute_uavid_stats.py:13-27): float64 sums of per-image channel means
    and squared means, then float32.
    """
    files = sorted(f for f in os.listdir(image_dir)
                   if f.lower().endswith(extensions))
    if max_images:
        files = files[:max_images]
    if not files:
        raise FileNotFoundError(f"No images found in {image_dir}")

    mean = np.zeros(3, dtype=np.float64)
    sq = np.zeros(3, dtype=np.float64)
    for f in files:
        arr = open_rgb(osp.join(image_dir, f)).astype(np.float64) / 255.0
        mean += arr.mean(axis=(0, 1))
        sq += (arr ** 2).mean(axis=(0, 1))
    mean /= len(files)
    sq /= len(files)
    std = np.sqrt(np.maximum(sq - mean ** 2, 0))
    return mean.astype(np.float32), std.astype(np.float32)
