"""Segmentation metrics (counterpart of `cabinet_tpu.eval.metrics`).

The confusion matrix is computed on the tensors' device with one
`torch.bincount`, in exact integers; only the (C, C) matrix goes to the host.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from cabinet_tpu_torch.core.constants import DEFAULT_IGNORE_LABEL


def confusion_matrix(pred: torch.Tensor, label: torch.Tensor, n_classes: int,
                     ignore_label: int = DEFAULT_IGNORE_LABEL) -> torch.Tensor:
    """(C, C) int64 histogram, rows = pred, cols = label (reference
    compute_hist indexing: pred * C + label). Pixels whose label is
    `ignore_label` are left out; other predictions and labels are clipped
    to [0, C-1], as in the JAX package."""
    valid = (label != ignore_label).reshape(-1)
    p = torch.clamp(pred.reshape(-1).long(), 0, n_classes - 1)
    lb = torch.clamp(label.reshape(-1).long(), 0, n_classes - 1)
    idx = (p * n_classes + lb)[valid]
    return torch.bincount(idx, minlength=n_classes * n_classes).reshape(
        n_classes, n_classes)


def metrics_from_hist(hist: np.ndarray) -> Dict[str, object]:
    """mIoU / accuracy / per-class IoU from an accumulated confusion matrix
    (reference evaluate.py:238-251)."""
    hist = np.asarray(hist, dtype=np.float64)
    diag = np.diag(hist)
    ious = diag / (hist.sum(axis=0) + hist.sum(axis=1) - diag + 1e-8)
    with np.errstate(invalid="ignore"):
        miou = float(np.nanmean(ious))
    total = hist.sum()
    acc = float(diag.sum() / total) if total > 0 else 0.0
    return {
        "mIoU": miou,
        "accuracy": acc,
        "iou_per_class": {f"class_{i}": float(v) for i, v in enumerate(ious)},
        "confusion_matrix": hist,
    }
