"""MobileNetV3 backbone (PyTorch / NCHW), cfg-table driven.

Counterpart of `cabinet_tpu.models.mobilenetv3`: same cfg rows
[k, t, c, SE, HS, s], same channel rounding, the two InvertedResidual
variants with their SE placement, and `forward` returns the pre-pool feature
map after the final 1x1 conv (960ch large / 576ch small). Children follow the
reference state-dict keys: `features.0` is the stem, `features.{i+1}.conv.{j}`
block i, `conv` the final 1x1.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from cabinet_tpu_torch.models.layers import (
    DepthwiseConv2D,
    HardSwish,
    SELayer,
    batch_norm,
    make_divisible,
)

# Canonical cfg tables (reference mobilenetv3.py:240-257, 263-276):
# rows are [kernel, expand_ratio, channels, use_se, use_hs, stride].
MOBILENETV3_LARGE_CFGS: List[List[float]] = [
    [3, 1, 16, 0, 0, 1],
    [3, 4, 24, 0, 0, 2],
    [3, 3, 24, 0, 0, 1],
    [5, 3, 40, 1, 0, 2],
    [5, 3, 40, 1, 0, 1],
    [5, 3, 40, 1, 0, 1],
    [3, 6, 80, 0, 1, 2],
    [3, 2.5, 80, 0, 1, 1],
    [3, 2.3, 80, 0, 1, 1],
    [3, 2.3, 80, 0, 1, 1],
    [3, 6, 112, 1, 1, 1],
    [3, 6, 112, 1, 1, 1],
    [5, 6, 160, 1, 1, 2],
    [5, 6, 160, 1, 1, 1],
    [5, 6, 160, 1, 1, 1],
]

MOBILENETV3_SMALL_CFGS: List[List[float]] = [
    [3, 1, 16, 1, 0, 2],
    [3, 4.5, 24, 0, 0, 2],
    [3, 3.67, 24, 0, 0, 1],
    [5, 4, 40, 1, 1, 2],
    [5, 6, 40, 1, 1, 1],
    [5, 6, 40, 1, 1, 1],
    [5, 3, 48, 1, 1, 1],
    [5, 3, 48, 1, 1, 1],
    [5, 6, 96, 1, 1, 2],
    [5, 6, 96, 1, 1, 1],
    [5, 6, 96, 1, 1, 1],
]


def default_cfgs(mode: str) -> List[List[float]]:
    if mode == "large":
        return MOBILENETV3_LARGE_CFGS
    if mode == "small":
        return MOBILENETV3_SMALL_CFGS
    raise ValueError(f"mode must be 'large' or 'small', got '{mode}'")


class InvertedResidual(nn.Module):
    """MobileNetV3 inverted-residual block (reference mobilenetv3.py:102-159).

    - no-expand (inp == hidden): dw -> bn -> act -> [SE] -> pw -> bn
    - expand: pw -> bn -> act -> dw -> bn -> [SE] -> act -> pw -> bn
    Residual connection iff stride == 1 and inp == oup.
    """

    def __init__(self, inp: int, hidden_dim: int, oup: int, kernel: int,
                 stride: int, use_se: bool, use_hs: bool):
        super().__init__()
        self.identity = stride == 1 and inp == oup
        act = HardSwish if use_hs else nn.ReLU
        se = SELayer(hidden_dim) if use_se else nn.Identity()
        if inp == hidden_dim:
            self.conv = nn.Sequential(
                DepthwiseConv2D(hidden_dim, kernel, stride),
                batch_norm(hidden_dim), act(), se,
                nn.Conv2d(hidden_dim, oup, 1, bias=False), batch_norm(oup))
        else:
            self.conv = nn.Sequential(
                nn.Conv2d(inp, hidden_dim, 1, bias=False),
                batch_norm(hidden_dim), act(),
                DepthwiseConv2D(hidden_dim, kernel, stride),
                batch_norm(hidden_dim), se, act(),
                nn.Conv2d(hidden_dim, oup, 1, bias=False), batch_norm(oup))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return x + y if self.identity else y


class MobileNetV3(nn.Module):
    """MobileNetV3 trunk. Input (B,3,H,W); output (B,960|576,h,w).

    Two entry points over the same parameters: `forward` (full trunk) and
    `tail` (from block_1 on, given block_0's output), the seam where the
    stem+block_0 kernel plugs in.
    """

    def __init__(self, cfgs: Sequence[Sequence[float]], mode: str = "large",
                 width_mult: float = 1.0):
        super().__init__()
        if mode not in ("large", "small"):
            raise ValueError(f"mode must be 'large' or 'small', got '{mode}'")
        input_channel = make_divisible(16 * width_mult, 8)
        layers = [nn.Sequential(
            nn.Conv2d(3, input_channel, 3, 2, 1, bias=False),
            batch_norm(input_channel), HardSwish())]
        exp_size = input_channel
        for k, t, c, use_se, use_hs, s in cfgs:
            output_channel = make_divisible(c * width_mult, 8)
            exp_size = make_divisible(input_channel * t, 8)
            layers.append(InvertedResidual(
                input_channel, exp_size, output_channel, int(k), int(s),
                bool(use_se), bool(use_hs)))
            input_channel = output_channel
        self.features = nn.Sequential(*layers)
        self.conv = nn.Sequential(
            nn.Conv2d(input_channel, exp_size, 1, bias=False),
            batch_norm(exp_size), HardSwish())
        self.out_channels = exp_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tail(self.features[1](self.features[0](x)))

    def tail(self, x: torch.Tensor) -> torch.Tensor:
        """Forward from block_1 on, given block_0's output (B,16,H/2,W/2)."""
        for blk in self.features[2:]:
            x = blk(x)
        return self.conv(x)
