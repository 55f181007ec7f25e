"""Shared NN building blocks (PyTorch / NCHW).

Counterpart of `cabinet_tpu.models.layers`. Module and attribute names follow
the reference torch state-dict keys, so a reference `.pth` loads with
`load_state_dict(strict=True)`. BatchNorm uses eps 1e-5 and torch momentum 0.1
(flax momentum 0.9), as in the JAX package; in train mode the running
variance takes the biased batch variance, as flax's does. Inside a process
group whose data axis holds more than one rank (`core/mesh.py:current`),
train-mode statistics are taken over every data rank's batch (data
parallelism: the statistics of the global batch).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def make_divisible(v: float, divisor: int, min_value: Optional[int] = None) -> int:
    """Channel rounding used by every MobileNet width computation
    (reference mobilenetv3.py:18-35)."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """relu6(x + 3) / 6 (reference mobilenetv3.py:38-50)."""
    return torch.clamp(x + 3.0, 0.0, 6.0) * (1.0 / 6.0)


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    """x * hard_sigmoid(x) (reference mobilenetv3.py:53-65)."""
    return x * hard_sigmoid(x)


class HardSigmoid(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return hard_sigmoid(x)


class HardSwish(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return hard_swish(x)


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` with flax's running variance.

    Train mode normalises with the biased batch variance, as both
    frameworks do. flax's `BatchNorm` stores that biased variance in its
    running average (`ra_var = m * ra_var + (1 - m) * var`); torch's layer
    stores the unbiased one, n/(n-1) times larger for n = B*H*W pixels a
    channel. So after torch's own train-mode forward (one pass over the
    input, its statistics in f32 whatever the input's dtype), the running
    variance is corrected on the C channels alone: torch added
    momentum * var * n/(n-1), flax adds momentum * var, so 1/n of the added
    term comes off. Eval mode, the state-dict keys (`num_batches_tracked`
    included) and the momentum are torch's.

    With more than one rank on the data axis (`core/mesh.py:current`), a
    train-mode forward takes its statistics over the global batch
    (`_global_forward`); a tensor-parallel model's BatchNorm of split
    channels (`models/tensor_parallel.py`) does so on this rank's channels. `torch.nn.SyncBatchNorm` does not serve: it runs
    on CUDA tensors only and keeps torch's unbiased running variance."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        from cabinet_tpu_torch.core import mesh

        if mesh.data_world()[1] > 1:
            return self._global_forward(x)
        before = self.running_var.clone()
        y = super().forward(x)
        with torch.no_grad():
            # a new tensor: autograd keeps the one torch's forward updated
            n = x.numel() // x.shape[1]
            added = self.running_var - (1.0 - self.momentum) * before
            self.running_var = self.running_var - added / n
        return y

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over every data rank's pixels. Each rank takes its
        pixels' count, mean and sum of squared deviations per channel in
        f32; one differentiable all-reduce over the data group of a buffer
        with a row per data rank (the other rows zero) gives every rank all
        of them, and Chan's parallel
        formula merges them (mean of the means by count; the deviations
        plus count * (rank mean - mean)^2), so that no E[x^2] - E[x]^2
        cancels: a channel of small variance and large mean would lose its
        variance to rounding there, and rounding in another order on R
        ranks would then move the gradients by percents. Gradients flow
        back through the all-reduce to every rank; the running averages
        take the biased variance, as flax's do; the output is in x's
        dtype."""
        from cabinet_tpu_torch.core import mesh

        rank, ranks = mesh.data_world()
        C = x.shape[1]
        xf = x.float()
        m = xf.mean(dim=(0, 2, 3))
        m2 = ((xf - m[None, :, None, None]) ** 2).sum(dim=(0, 2, 3))
        mine = torch.cat([m, m2, xf.new_full((1,), float(xf.numel() // C))])
        zero = torch.zeros_like(mine)
        rows = mesh.all_reduce_grad(torch.stack([mine if r == rank else zero
                                                 for r in range(ranks)]), tag="batch_norm",
                                      group=mesh.data_group())
        means, m2s, counts = rows[:, :C], rows[:, C:2 * C], rows[:, 2 * C:]
        n = counts.sum()
        mean = (counts * means).sum(dim=0) / n
        var = (m2s.sum(dim=0) + (counts * (means - mean) ** 2).sum(dim=0)) / n
        inv = torch.rsqrt(var + self.eps)
        y = ((xf - mean[None, :, None, None]) * (inv * self.weight)[None, :, None, None]
             + self.bias[None, :, None, None])
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.detach() * m)
            self.running_var.mul_(1.0 - m).add_(var.detach() * m)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


def batch_norm(channels: int) -> BatchNorm2d:
    """BatchNorm with the JAX package's numerics (eps 1e-5, flax's running
    variance)."""
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class DepthwiseConv2D(nn.Conv2d):
    """Bias-free depthwise conv; weight (C, 1, k, k), padding (k-1)//2 unless
    given."""

    def __init__(self, channels: int, kernel_size: int = 3, stride: int = 1,
                 padding: Optional[int] = None):
        pad = padding if padding is not None else (kernel_size - 1) // 2
        super().__init__(channels, channels, kernel_size, stride, pad,
                         groups=channels, bias=False)


class ConvBNReLU(nn.Module):
    """Conv(no bias) + BN + ReLU (reference cabinet.py:19-51); children
    `conv` and `bn`."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                              padding, dilation=dilation, bias=False)
        self.bn = batch_norm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class DWConv(nn.Module):
    """3x3 depthwise conv + BN + ReLU (reference cab.py:18-38); child
    `block` = (conv, bn, relu)."""

    def __init__(self, channels: int, stride: int = 1):
        super().__init__()
        self.block = nn.Sequential(DepthwiseConv2D(channels, 3, stride),
                                   batch_norm(channels), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class SELayer(nn.Module):
    """Squeeze-and-excite: GAP -> FC(c/4) -> ReLU -> FC(c) -> hard_sigmoid ->
    scale (reference mobilenetv3.py:68-83); child `fc` = (fc1, relu, fc2,
    hard_sigmoid)."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        hidden = make_divisible(channels // reduction, 8)
        self.fc = nn.Sequential(nn.Linear(channels, hidden), nn.ReLU(),
                                nn.Linear(hidden, channels), HardSigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.fc(x.mean(dim=(2, 3)))
        return x * y[:, :, None, None]


def adaptive_avg_pool2d(x: torch.Tensor, output_size: Tuple[int, int]
                        ) -> torch.Tensor:
    """torch AdaptiveAvgPool2d on NCHW: bin i covers
    [floor(i*H/s), ceil((i+1)*H/s)), the bins of the JAX matmul form."""
    return F.adaptive_avg_pool2d(x, output_size)
