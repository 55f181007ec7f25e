"""Class-frequency weighting (copy of `cabinet_tpu.data.class_weights`;
reference src/utils/class_weights.py:26-90).

`get_class_pixel_counts` reads at most `max_samples` items evenly spaced
through the dataset's `__getitem__`, so the weights reflect the augmented
pixel distribution, as the reference's do; `compute_class_weights` applies
the ENet formula w_c = (1 / ln(1.02 + p_c)) ** cls_pw (cls_pw 0: uniform).
"""

from __future__ import annotations

from typing import Any

import numpy as np


def get_class_pixel_counts(dataset: Any, num_classes: int, ignore_label: int = 255,
                           max_samples: int = 200) -> np.ndarray:
    n = len(dataset)
    take = min(n, max_samples)
    idxs = np.linspace(0, n - 1, take).astype(int) if take > 1 else np.zeros(1, int)
    counts = np.zeros(num_classes, dtype=np.int64)
    for i in idxs:
        label = np.asarray(dataset[int(i)][1])
        valid = label[label != ignore_label]
        counts += np.bincount(valid.astype(np.int64), minlength=num_classes)[:num_classes]
    return counts


def compute_class_weights(counts: np.ndarray, cls_pw: float = 0.5) -> np.ndarray:
    """ENet weighting, exponentiated by cls_pw (reference class_weights.py:77-90)."""
    counts = np.asarray(counts, dtype=np.float64)
    if cls_pw == 0:
        return np.ones_like(counts, dtype=np.float32)
    total = counts.sum()
    p = counts / max(total, 1)
    weights = (1.0 / np.log(1.02 + p)) ** cls_pw
    return weights.astype(np.float32)
