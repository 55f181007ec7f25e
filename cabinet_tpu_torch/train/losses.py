"""Segmentation losses (counterpart of `cabinet_tpu.train.losses`).

Logits are NCHW (B, C, H, W), labels (B, H, W) integers, as
`F.cross_entropy` takes them; every loss is computed in f32 whatever the
logits' dtype. The forms are the JAX package's, so that values and
gradients match it:

  - the per-pixel CE picks the label's logit with a one-hot product
    (`sum(logits * onehot) - logsumexp`), and class weights the same way;
  - OHEM (reference src/utils/loss.py:38-80) has static shapes and no host
    sync: invalid pixels get loss -inf, and the mean of every valid loss
    above `thresh` or the mean of the top `n_min` (clamped to the valid
    count) is chosen by where the `n_min`-th largest valid loss lies; an
    empty valid mask gives 0;
  - `method="bisect"` (the trainer's) finds the cut value by 40 halvings of
    [0, max + 1] and fills the tied remainder with it under stop-gradient,
    so that the tied pixels get no gradient through the fill term.
    `torch.topk` gives the same value with a gradient on the tied
    elements, which is why `"topk"` is not the trainer's method.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cabinet_tpu_torch.core.constants import DEFAULT_IGNORE_LABEL

_NEG_INF = float("-inf")


def _onehot(safe_labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, H, W) int -> (B, C, H, W) f32 one-hot."""
    shape = (safe_labels.shape[0], num_classes) + tuple(safe_labels.shape[1:])
    out = torch.zeros(shape, dtype=torch.float32, device=safe_labels.device)
    return out.scatter_(1, safe_labels.unsqueeze(1), 1.0)


def _pixel_weights(onehot: torch.Tensor, class_weights) -> torch.Tensor:
    cw = torch.as_tensor(class_weights, dtype=torch.float32, device=onehot.device)
    return (onehot * cw.view(1, -1, 1, 1)).sum(dim=1)


def _per_pixel_ce(logits: torch.Tensor, labels: torch.Tensor, ignore_label: int,
                  class_weights=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel weighted CE (B, H, W) f32, 0 where ignored, and the validity
    mask; `F.cross_entropy(reduction='none', ignore_index, weight)`."""
    valid = labels != ignore_label
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logits = logits.float()
    onehot = _onehot(safe, logits.shape[1])
    loss = torch.logsumexp(logits, dim=1) - (logits * onehot).sum(dim=1)
    if class_weights is not None:
        loss = loss * _pixel_weights(onehot, class_weights)
    return torch.where(valid, loss, torch.zeros_like(loss)), valid


def ohem_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, n_min: int,
                       thresh: float = 0.7,
                       ignore_label: int = DEFAULT_IGNORE_LABEL,
                       class_weights=None, method: str = "topk") -> torch.Tensor:
    """Online-hard-example-mining CE, a 0-dim f32 tensor. `n_min` is a
    Python int (the trainer's batch * crop_h * crop_w // OHEM_DIVISOR);
    `method` is "topk" (exact, a sort) or "bisect" (O(N) passes, exact up
    to 2^-40 of the largest loss; the trainer's)."""
    loss, valid = _per_pixel_ce(logits, labels, ignore_label, class_weights)
    flat = torch.where(valid.reshape(-1), loss.reshape(-1),
                       torch.full_like(loss.reshape(-1), _NEG_INF))
    n_valid = valid.sum()
    n_min = int(min(max(n_min, 1), flat.numel()))
    n_top = torch.clamp(n_valid, max=n_min)
    zero = torch.zeros((), dtype=torch.float32, device=flat.device)

    above = flat > thresh  # -inf entries are never above
    mean_above = (torch.where(above, flat, zero).sum()
                  / torch.clamp(above.sum(), min=1))

    if method == "topk":
        top = torch.topk(flat, n_min).values  # -inf beyond n_valid
        top_is_valid = top > _NEG_INF
        kth = torch.where(top_is_valid, top, torch.full_like(top, float("inf"))).min()
        mean_top = torch.where(top_is_valid, top, zero).sum() / torch.clamp(n_top, min=1)
    elif method == "bisect":
        with torch.no_grad():  # the cut is stop-gradient, as in JAX
            vals = torch.where(flat > _NEG_INF, flat, zero)
            hi = vals.max() + 1.0
            lo = zero.clone()
            for _ in range(40):
                mid = 0.5 * (lo + hi)
                ge = (flat > mid).sum() >= n_top
                lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid)
        kth = lo
        strictly = flat > hi
        sum_top = (torch.where(strictly, flat, zero).sum()
                   + (n_top - strictly.sum()) * kth)
        mean_top = sum_top / torch.clamp(n_top, min=1)
    else:
        raise ValueError(f"Unknown OHEM method: {method}")

    picked = torch.where(kth > thresh, mean_above, mean_top)
    return torch.where(n_valid > 0, picked, zero)


def softmax_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                       gamma: float = 2.0, class_weights=None,
                       ignore_label: int = DEFAULT_IGNORE_LABEL) -> torch.Tensor:
    """Focal loss of the reference (src/utils/loss.py:86-127): nll of
    (1-p)^gamma * log p with torch's weighted-mean semantics (the sum of
    weighted losses over the sum of the picked class weights)."""
    valid = labels != ignore_label
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logits = logits.float()
    p = torch.softmax(logits, dim=1)
    logp = torch.log_softmax(logits, dim=1)
    onehot = _onehot(safe, logits.shape[1])
    picked = ((1.0 - p) ** gamma * logp * onehot).sum(dim=1)
    w = (_pixel_weights(onehot, class_weights) if class_weights is not None
         else torch.ones_like(picked))
    zero = torch.zeros_like(w)
    w = torch.where(valid, w, zero)
    num = -(w * torch.where(valid, picked, zero)).sum()
    den = w.sum()
    return torch.where(den > 0, num / torch.clamp(den, min=1e-12), den.new_zeros(()))


def cross_entropy_mean(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_label: int = DEFAULT_IGNORE_LABEL,
                       class_weights=None) -> torch.Tensor:
    """Masked-mean CE with torch's mean semantics: with class weights the
    denominator is the sum of the picked weights."""
    loss, valid = _per_pixel_ce(logits, labels, ignore_label, class_weights)
    if class_weights is not None:
        safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
        w = _pixel_weights(_onehot(safe, logits.shape[1]), class_weights)
        den = torch.where(valid, w, torch.zeros_like(w)).sum()
    else:
        den = valid.sum().float()
    return torch.where(den > 0, loss.sum() / torch.clamp(den, min=1e-12),
                       loss.new_zeros(()))
