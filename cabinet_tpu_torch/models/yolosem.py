"""YOLO-sem: CSP backbone + PAN-FPN neck + dense semantic head (PyTorch /
NCHW).

Counterpart of `cabinet_tpu.models.yolosem`, the in-repo stand-in for the
reference's `yolo26{n,s,m,l,x}-sem` (reference configs/train_yolo.yaml):
five width/depth-scaled variants with semantic logits at input resolution.

  backbone: stem s2 -> 4 stages of ConvBNSiLU s2 + C2f (P2..P5) -> SPPF
  neck: PAN-FPN top-down (P5->P4->P3) with C2f fusion
  head: P3 + up(P4) + up(P5) at /8, 1x1 reduce, two 3x3 ConvBNSiLU, 1x1
        classifier; aux head off P4; both bilinearly resized to the input.

`forward(x) -> (logits, aux)`, as `CABiNet` returns. Modules are named after
the flax attributes (`stem.conv`, `c2f_2.m0.cv1.bn`, `classifier`, ...), so a
state-dict key reads as its flax path. BatchNorm is flax's
`BatchNorm(momentum=0.97, epsilon=1e-3)`: the port's `BatchNorm2d` (flax's
biased running variance) at eps 1e-3 and torch momentum 0.03.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cabinet_tpu_torch.models.cab import resize_bilinear
from cabinet_tpu_torch.models.layers import BatchNorm2d

# (depth_multiple, width_multiple, max_channels, extra /32 C2f repeats), the
# JAX package's table (cabinet_tpu/models/yolosem.py:40).
YOLOSEM_VARIANTS: Dict[str, Tuple[float, float, int, int]] = {
    "n": (0.25, 0.2375, 896, 2),
    "s": (0.50, 0.375, 896, 4),
    "m": (0.50, 0.75, 640, 1),
    "l": (0.60, 0.8125, 640, 1),
    "x": (0.70, 1.225, 640, 1),
}


def _ch(width: float, c: int, max_channels: int) -> int:
    return int(min(c, max_channels) * width // 8) * 8 or 8


def _depth(depth: float, n: int) -> int:
    return max(1, round(n * depth))


class ConvBNSiLU(nn.Module):
    """Bias-free k x k conv (padding (k-1)//2) + BN + SiLU; children `conv`
    and `bn`."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, bias=False)
        self.bn = BatchNorm2d(cout, eps=1e-3, momentum=0.03)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = ConvBNSiLU(cin, features, 3)
        self.cv2 = ConvBNSiLU(features, features, 3)
        self.add = shortcut and cin == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """Cross-stage partial block with n bottlenecks (YOLOv8 C2f); the split
    is on channels (dim 1)."""

    def __init__(self, cin: int, features: int, n: int = 1, shortcut: bool = True):
        super().__init__()
        self.half = features // 2
        self.n = n
        self.cv1 = ConvBNSiLU(cin, features, 1)
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(self.half, self.half, shortcut))
        self.cv2 = ConvBNSiLU(features + n * self.half, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        a, b = y[:, :self.half], y[:, self.half:]
        outs = [a, b]
        for i in range(self.n):
            b = getattr(self, f"m{i}")(b)
            outs.append(b)
        return self.cv2(torch.cat(outs, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling - fast: 3 chained 5x5 SAME max pools (torch
    pads with -inf)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        half = max(features // 2, 8)
        self.cv1 = ConvBNSiLU(cin, half, 1)
        self.cv2 = ConvBNSiLU(4 * half, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x)
        p1 = F.max_pool2d(x, 5, 1, 2)
        p2 = F.max_pool2d(p1, 5, 1, 2)
        p3 = F.max_pool2d(p2, 5, 1, 2)
        return self.cv2(torch.cat([x, p1, p2, p3], dim=1))


class YOLOSem(nn.Module):
    """Semantic segmentation YOLO: (B,3,H,W) -> (logits, aux), both
    (B,n_classes,H,W).

    `backbone`, `backbone_front`/`backbone_back` (the 3-stage pipeline cut at
    P3) and `decode` are the JAX module's methods, the seams its pipeline
    engine cuts at; backbone(x) == backbone_back(backbone_front(x))."""

    def __init__(self, n_classes: int, variant: str = "n"):
        super().__init__()
        if variant not in YOLOSEM_VARIANTS:
            raise ValueError(f"Unknown YOLO-sem variant: {variant}")
        self.n_classes = n_classes
        self.variant = variant
        d, w, mc, deep = YOLOSEM_VARIANTS[variant]
        C = lambda c: _ch(w, c, mc)  # noqa: E731
        N = lambda n: _depth(d, n)  # noqa: E731

        # Backbone
        self.stem = ConvBNSiLU(3, C(64), 3, 2)
        self.down2 = ConvBNSiLU(C(64), C(128), 3, 2)
        self.c2f_2 = C2f(C(128), C(128), N(3))                        # /4
        self.down3 = ConvBNSiLU(C(128), C(256), 3, 2)
        self.c2f_3 = C2f(C(256), C(256), N(6))                        # /8  P3
        self.down4 = ConvBNSiLU(C(256), C(512), 3, 2)
        self.c2f_4 = C2f(C(512), C(512), N(6))                        # /16 P4
        self.down5 = ConvBNSiLU(C(512), C(1024), 3, 2)
        self.c2f_5 = C2f(C(1024), C(1024), N(3) + deep)               # /32
        self.sppf = SPPF(C(1024), C(1024))                            # P5

        # PAN-FPN top-down + heads
        self.fpn_4 = C2f(C(1024) + C(512), C(512), N(3), shortcut=False)
        self.fpn_3 = C2f(C(512) + C(256), C(256), N(3), shortcut=False)
        self.head0 = ConvBNSiLU(C(256) + C(512) + C(1024), C(256), 1)
        self.head1 = ConvBNSiLU(C(256), C(256), 3)
        self.head2 = ConvBNSiLU(C(256), C(256), 3)
        self.classifier = nn.Conv2d(C(256), n_classes, 1)
        self.aux1 = ConvBNSiLU(C(512), C(256), 3)
        self.aux_classifier = nn.Conv2d(C(256), n_classes, 1)
        self._init_weights()

    def _init_weights(self) -> None:
        """flax's defaults: conv kernels lecun_normal (truncated normal of
        variance 1/fan_in), biases zero; BN scale 1, bias 0."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)

    def backbone(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """CSP trunk: image -> (P3 /8, P4 /16, P5 /32)."""
        return self.backbone_back(self.backbone_front(x))

    def backbone_front(self, x: torch.Tensor) -> torch.Tensor:
        """First half of the trunk: image -> P3."""
        x2 = self.c2f_2(self.down2(self.stem(x)))
        return self.c2f_3(self.down3(x2))

    def backbone_back(self, x3: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Second half of the trunk: P3 -> the pyramid (P3 passes through)."""
        x4 = self.c2f_4(self.down4(x3))
        x5 = self.sppf(self.c2f_5(self.down5(x4)))
        return x3, x4, x5

    def decode(self, x: torch.Tensor, feats: Tuple[torch.Tensor, ...]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """PAN-FPN neck + dense heads; `x` supplies only the output (H, W)."""
        x3, x4, x5 = feats
        H, W = x.shape[2:]
        p4 = self.fpn_4(torch.cat([resize_bilinear(x5, x4.shape[2:]), x4], dim=1))
        p3 = self.fpn_3(torch.cat([resize_bilinear(p4, x3.shape[2:]), x3], dim=1))
        fused = torch.cat([p3, resize_bilinear(p4, p3.shape[2:]),
                           resize_bilinear(x5, p3.shape[2:])], dim=1)
        logits = self.classifier(self.head2(self.head1(self.head0(fused))))
        aux = self.aux_classifier(self.aux1(p4))
        return resize_bilinear(logits, (H, W)), resize_bilinear(aux, (H, W))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.decode(x, self.backbone(x))


def build_yolosem(n_classes: int, model_name: str = "yolo26n-sem") -> YOLOSem:
    """Factory taking reference-style names (yolo26{n,s,m,l,x}-sem, or the
    bare variant letter)."""
    name = model_name.lower()
    for v in ("n", "s", "m", "l", "x"):
        if f"26{v}" in name or name.endswith(f"{v}-sem") or name == v:
            return YOLOSem(n_classes=n_classes, variant=v)
    raise ValueError(f"Unrecognized YOLO-sem model name: {model_name}")
