"""CABiNet's training step in plain PyTorch, the benchmark's frozen
reference: the dual-head OHEM loss (the bisect cut: every valid pixel's
weighted cross-entropy, the mean of those above the threshold or of the
top n_min), the backward, the clip of the global norm in optax's form,
SGD with momentum over CABiNet's four groups (weight decay on conv
kernels, x10 learning rate on the decoder) at the warm-up + poly
learning rate, and the EMA of the weights.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch import nn

DECODER = ("ab", "ffm", "conv_out")


def class_weights(trainids: torch.Tensor, n_classes: int, ignore: int, cls_pw: float
                  ) -> torch.Tensor:
    """ENet's weights, (1 / ln(1.02 + p_c)) ** cls_pw, p_c the share of the
    valid pixels of class c."""
    valid = trainids[trainids != ignore].long()
    counts = torch.bincount(valid, minlength=n_classes)[:n_classes].double()
    p = counts / counts.sum().clamp_min(1)
    return ((1.0 / torch.log(1.02 + p)) ** cls_pw).float()


def ohem(logits: torch.Tensor, labels: torch.Tensor, n_min: int, thresh: float,
         ignore: int, weights: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    valid = labels != ignore
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    ce = torch.logsumexp(logits, 1) - logits.gather(1, safe[:, None])[:, 0]
    ce = ce * weights[safe]
    flat = torch.where(valid, ce, torch.full_like(ce, float("-inf"))).reshape(-1)
    n_valid = valid.sum()
    n_top = torch.clamp(n_valid, max=max(1, min(n_min, flat.numel())))
    zero = flat.new_zeros(())
    above = flat > thresh
    mean_above = torch.where(above, flat, zero).sum() / torch.clamp(above.sum(), min=1)
    with torch.no_grad():  # the cut by 40 halvings of [0, max + 1]
        lo = zero.clone()
        hi = torch.where(flat > float("-inf"), flat, zero).max() + 1.0
        for _ in range(40):
            mid = 0.5 * (lo + hi)
            ge = (flat > mid).sum() >= n_top
            lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid)
    strictly = flat > hi
    mean_top = ((torch.where(strictly, flat, zero).sum() + (n_top - strictly.sum()) * lo)
                / torch.clamp(n_top, min=1))
    return torch.where(n_valid > 0, torch.where(lo > thresh, mean_above, mean_top), zero)


def groups(model: nn.Module) -> Dict[str, tuple]:
    """{parameter name: (weight decay applies, learning-rate multiplier applies)}."""
    kernels = {f"{n}.weight" for n, m in model.named_modules() if isinstance(m, nn.Conv2d)}
    return {n: (n in kernels and p.dim() == 4, n.split(".")[0] in DECODER)
            for n, p in model.named_parameters()}


def lr_at(count: int, t: Dict) -> float:
    f32 = np.float32
    c, warm = f32(count), int(t["warmup_steps"])
    if warm > 0 and c < warm:
        return float(f32(t["warmup_start_lr"]) + (c / f32(warm))
                     * f32(t["lr0"] - t["warmup_start_lr"]))
    r = np.clip((f32(t["max_iterations"]) - c) / f32(max(t["max_iterations"] - warm, 1)),
                f32(0.0), f32(1.0))
    return float(f32(t["lr0"]) * r ** f32(t["power"]))


class Trainer:
    """The reference's model, momentum and EMA, stepped by `step`."""

    def __init__(self, model: nn.Module, t: Dict, start_step: int):
        self.model, self.t, self.count = model, t, int(start_step)
        self.labels = groups(model)
        self.params = dict(model.named_parameters())
        self.buf: Dict[str, torch.Tensor] = {}
        self.ema = {k: v.detach().clone() for k, v in model.state_dict().items()}
        self.updates = 0
        self.first_grads: Dict[str, torch.Tensor] = {}

    def step(self, images: torch.Tensor, labels: torch.Tensor, n_min: int,
             weights: torch.Tensor, ignore: int) -> float:
        t = self.t
        self.model.train()
        for p in self.params.values():
            p.grad = None
        final, aux = self.model(images.permute(0, 3, 1, 2))
        loss = (ohem(final, labels, n_min, t["ohem_thresh"], ignore, weights)
                + t["aux_weight"] * ohem(aux, labels, n_min, t["ohem_thresh"], ignore, weights))
        loss.backward()
        with torch.no_grad():
            grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                     for n, p in self.params.items()}
            norm = torch.sqrt(sum(g.float().square().sum() for g in grads.values()))
            if float(norm) >= t["max_grad_norm"]:
                grads = {n: (g / norm) * t["max_grad_norm"] for n, g in grads.items()}
            if not self.first_grads:
                self.first_grads = {n: g.clone() for n, g in grads.items()}
            lr = np.float32(lr_at(self.count, t))
            for n, p in self.params.items():
                wd, x10 = self.labels[n]
                d = grads[n] + t["weight_decay"] * p if wd else grads[n]
                b = self.buf.get(n)
                self.buf[n] = d.clone() if b is None else b.mul_(t["momentum"]).add_(d)
                p.sub_(float(lr * np.float32(t["lr_multiplier"] if x10 else 1.0)) * self.buf[n])
            self.updates += 1
            f32 = np.float32
            dec = f32(t["ema_decay"]) * (f32(1.0) - np.exp(-f32(self.updates) / f32(t["ema_tau"])))
            live = self.model.state_dict()
            for k, v in self.ema.items():
                if v.is_floating_point():
                    v.mul_(float(dec)).add_(live[k].detach() * float(f32(1.0) - dec))
        self.count += 1
        return float(loss.detach())


def weights_now(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def names_moved(first_grads: Dict[str, torch.Tensor], rel: float = 1e-3) -> List[str]:
    """The leaves whose first gradient is above `rel` of the median leaf's
    norm: the others move by weight decay or round-off alone."""
    norms = {n: float(g.double().norm()) for n, g in first_grads.items()}
    med = float(np.median(list(norms.values())))
    return [n for n, v in norms.items() if v >= rel * med]
