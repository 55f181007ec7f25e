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

With `share=True` and R > 1 ranks on the data axis (data parallelism;
`core/mesh.py:current`, whose data group the reductions span), OHEM and
the CE mean are the global batch's: the valid
count, the k-th loss and the sums above it span every rank's pixels, and
each rank returns its share of the global loss (its own pixels' part of
the sums over the global divisors), so that the shares add up to the
loss of the concatenated batch and their gradients, summed over the
ranks, to its gradient. The reductions are integer counts and maxima
(exact), so every rank takes the same branch and the same cut. Their
cost: `bisect` all-reduces one count per halving (40 a head), `topk` the
ranks' local top `n_min` losses (R * n_min floats) and the tie counts.
One body serves both: without sharing, or with one rank, the reductions
are the values themselves.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cabinet_tpu_torch.core import mesh
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
                       class_weights=None, method: str = "topk",
                       share: bool = False) -> torch.Tensor:
    """Online-hard-example-mining CE, a 0-dim f32 tensor. `n_min` is a
    Python int (the trainer's batch * crop_h * crop_w // OHEM_DIVISOR, of
    the global batch); `method` is "topk" (exact, a sort) or "bisect" (O(N)
    passes, exact up to 2^-40 of the largest loss; the trainer's).
    `share=True` in a group of several ranks: this rank's share of the
    global batch's loss (module docstring). Every count and maximum goes
    through `total`, over the ranks when sharing and the value itself
    otherwise; with one rank the row gather, the tie split and the rank-0
    fill below are the plain selection."""
    if method not in ("topk", "bisect"):
        raise ValueError(f"Unknown OHEM method: {method}")
    rank, size = mesh.data_world() if share else (0, 1)
    group = mesh.data_group()

    def total(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return mesh.all_reduce_(t, op=op, tag="loss", group=group) if size > 1 else t

    loss, valid = _per_pixel_ce(logits, labels, ignore_label, class_weights)
    flat = torch.where(valid.reshape(-1), loss.reshape(-1),
                       torch.full_like(loss.reshape(-1), _NEG_INF))
    n_all = flat.numel()
    if size > 1:
        n_all = int(total(torch.tensor(n_all, dtype=torch.int64, device=flat.device)))
    n_valid = total(valid.sum())
    n_min = int(min(max(n_min, 1), n_all))
    n_top = torch.clamp(n_valid, max=n_min)
    zero = torch.zeros((), dtype=torch.float32, device=flat.device)

    above = flat > thresh  # -inf entries are never above
    mean_above = (torch.where(above, flat, zero).sum()
                  / torch.clamp(total(above.sum()), min=1))

    if method == "topk":
        k = min(n_min, flat.numel())
        top = torch.topk(flat, k).values  # this rank's candidates, -inf beyond n_valid
        # every rank's top k, one row a rank (the others add 0), re-ranked
        rows = torch.zeros((size, n_min), dtype=torch.float32, device=flat.device)
        rows[rank, :k] = top.detach()
        rows[rank, k:] = _NEG_INF
        best = torch.topk(total(rows).reshape(-1), n_min).values
        is_valid = best > _NEG_INF
        kth = torch.where(is_valid, best, torch.full_like(best, float("inf"))).min()
        # the ties at kth that the global top n_top takes, given out by rank
        tie = top == kth
        ties = torch.zeros(size, dtype=torch.int64, device=flat.device)
        ties[rank] = tie.sum()
        ties = total(ties)
        want = n_top - total((flat > kth).sum())
        mine = torch.clamp(want - ties[:rank].sum(), min=0).clamp(max=ties[rank])
        picked_top = (top > kth) | (tie & (torch.cumsum(tie.long(), 0) <= mine))
        mean_top = torch.where(picked_top, top, zero).sum() / torch.clamp(n_top, min=1)
    else:  # bisect
        with torch.no_grad():  # the cut is stop-gradient, as in JAX
            vals = torch.where(flat > _NEG_INF, flat, zero)
            hi = total(vals.max(), op="max") + 1.0
            lo = zero.clone()
            for _ in range(40):
                mid = 0.5 * (lo + hi)
                ge = total((flat > mid).sum()) >= n_top
                lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid)
        kth = lo
        strictly = flat > hi
        fill = (n_top - total(strictly.sum())) * kth  # every rank counts; rank 0 adds it
        fill = fill if rank == 0 else zero
        sum_top = torch.where(strictly, flat, zero).sum() + fill
        mean_top = sum_top / torch.clamp(n_top, min=1)

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
                       class_weights=None, share: bool = False) -> torch.Tensor:
    """Masked-mean CE with torch's mean semantics: with class weights the
    denominator is the sum of the picked weights. `share=True` in a group
    of several ranks: this rank's sum over the global denominator."""
    loss, valid = _per_pixel_ce(logits, labels, ignore_label, class_weights)
    if class_weights is not None:
        safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
        w = _pixel_weights(_onehot(safe, logits.shape[1]), class_weights)
        den = torch.where(valid, w, torch.zeros_like(w)).sum()
    else:
        den = valid.sum().float()
    if share and mesh.data_world()[1] > 1:
        den = mesh.all_reduce_(den.detach().clone(), tag="loss", group=mesh.data_group())
    return torch.where(den > 0, loss.sum() / torch.clamp(den, min=1e-12),
                       loss.new_zeros(()))
