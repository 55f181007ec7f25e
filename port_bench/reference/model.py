"""CABiNet in plain PyTorch (NCHW), the benchmark's frozen reference.

A copy of the architecture that the port runs (MobileNetV3 trunk, spatial
branch, attention branch with the context aggregation block, feature
fusion, output head), written again without any of the program's kernels,
sharding hooks or fused paths, so that the benchmark can judge what the
program computes. Module and attribute names follow the reference
state-dict keys, so one state dict loads into both.

Every convolution, linear layer and attention product goes through
`Conv2d`, `Linear` and `_matmul`, which compute in float32 (the caller
turns TF32 off) or, with `set_fp8(model, True)`, as fp8 training does:
both operands rounded to float8 e4m3 and the gradient of the product to
float8 e5m2, each tensor scaled by its largest magnitude. That is the
control that a lower precision than the program's bfloat16 has to fail.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0  # the largest finite float8 e4m3 value

LARGE_CFGS: List[List[float]] = [
    [3, 1, 16, 0, 0, 1], [3, 4, 24, 0, 0, 2], [3, 3, 24, 0, 0, 1],
    [5, 3, 40, 1, 0, 2], [5, 3, 40, 1, 0, 1], [5, 3, 40, 1, 0, 1],
    [3, 6, 80, 0, 1, 2], [3, 2.5, 80, 0, 1, 1], [3, 2.3, 80, 0, 1, 1],
    [3, 2.3, 80, 0, 1, 1], [3, 6, 112, 1, 1, 1], [3, 6, 112, 1, 1, 1],
    [5, 6, 160, 1, 1, 2], [5, 6, 160, 1, 1, 1], [5, 6, 160, 1, 1, 1],
]


def _to_fp8(t: torch.Tensor, dtype: torch.dtype, fmax: float) -> torch.Tensor:
    scale = t.abs().amax().clamp_min(1e-30) / fmax
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Fp8Operand(torch.autograd.Function):
    """An operand rounded to float8 e4m3 (per-tensor scale); the gradient
    passes through."""

    @staticmethod
    def forward(ctx, t):
        return _to_fp8(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Grad(torch.autograd.Function):
    """The identity, whose incoming gradient is rounded to float8 e5m2 (per-
    tensor scale), as fp8 training feeds a layer's output gradient to both
    of its backward products."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _to_fp8(g, torch.float8_e5m2, 57344.0)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    return _Fp8Operand.apply(t)


def fp8_product(y: torch.Tensor) -> torch.Tensor:
    return _Fp8Grad.apply(y)


class Conv2d(nn.Conv2d):
    fp8 = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return super().forward(x)
        return fp8_product(self._conv_forward(fp8_round(x), fp8_round(self.weight), self.bias))


class Linear(nn.Linear):
    fp8 = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return super().forward(x)
        return fp8_product(F.linear(fp8_round(x), fp8_round(self.weight), self.bias))


def set_fp8(model: nn.Module, on: bool) -> None:
    for m in model.modules():
        if isinstance(m, (Conv2d, Linear, GlobalContextAttention)):
            m.fp8 = on


def make_divisible(v: float, divisor: int, min_value: int = None) -> int:
    min_value = divisor if min_value is None else min_value
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x + 3.0, 0.0, 6.0) * (1.0 / 6.0)


class HardSigmoid(nn.Module):
    def forward(self, x):
        return hard_sigmoid(x)


class HardSwish(nn.Module):
    def forward(self, x):
        return x * hard_sigmoid(x)


def bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Half-pixel bilinear, 2 taps, never anti-aliased."""
    size = (int(size[0]), int(size[1]))
    if size == tuple(x.shape[2:]):
        return x
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False)


class DepthwiseConv2D(Conv2d):
    def __init__(self, c: int, k: int = 3, stride: int = 1):
        super().__init__(c, c, k, stride, (k - 1) // 2, groups=c, bias=False)


class ConvBNReLU(nn.Module):
    def __init__(self, cin, cout, kernel_size=3, stride=1, padding=1):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel_size, stride, padding, bias=False)
        self.bn = bn(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class DWConv(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.block = nn.Sequential(DepthwiseConv2D(c, 3, 1), bn(c), nn.ReLU())

    def forward(self, x):
        return self.block(x)


class SELayer(nn.Module):
    def __init__(self, c: int, reduction: int = 4):
        super().__init__()
        hidden = make_divisible(c // reduction, 8)
        self.fc = nn.Sequential(Linear(c, hidden), nn.ReLU(), Linear(hidden, c),
                                HardSigmoid())

    def forward(self, x):
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


class InvertedResidual(nn.Module):
    def __init__(self, inp, hidden, oup, k, stride, use_se, use_hs):
        super().__init__()
        self.identity = stride == 1 and inp == oup
        act = HardSwish if use_hs else nn.ReLU
        se = SELayer(hidden) if use_se else nn.Identity()
        if inp == hidden:
            self.conv = nn.Sequential(DepthwiseConv2D(hidden, k, stride), bn(hidden), act(),
                                      se, Conv2d(hidden, oup, 1, bias=False), bn(oup))
        else:
            self.conv = nn.Sequential(Conv2d(inp, hidden, 1, bias=False), bn(hidden), act(),
                                      DepthwiseConv2D(hidden, k, stride), bn(hidden), se,
                                      act(), Conv2d(hidden, oup, 1, bias=False), bn(oup))

    def forward(self, x):
        y = self.conv(x)
        return x + y if self.identity else y


def _maybe_checkpoint(fn, x, on: bool):
    """fn(x), recomputed in the backward when `on` and gradients are on: the
    reference trains at the program's batch in float32 inside the memory
    the program used in bfloat16. Batch statistics are the same in the
    recomputation; running statistics are not compared."""
    if on and torch.is_grad_enabled():
        return checkpoint(fn, x, use_reentrant=False)
    return fn(x)


class MobileNetV3(nn.Module):
    def __init__(self, cfgs: Sequence[Sequence[float]]):
        super().__init__()
        cin = 16
        layers = [nn.Sequential(Conv2d(3, cin, 3, 2, 1, bias=False), bn(cin), HardSwish())]
        exp = cin
        for k, t, c, se, hs, s in cfgs:
            cout = make_divisible(c, 8)
            exp = make_divisible(cin * t, 8)
            layers.append(InvertedResidual(cin, exp, cout, int(k), int(s), bool(se), bool(hs)))
            cin = cout
        self.features = nn.Sequential(*layers)
        self.conv = nn.Sequential(Conv2d(cin, exp, 1, bias=False), bn(exp), HardSwish())
        self.out_channels = exp
        self.remat = False

    def forward(self, x):
        for f in self.features:
            x = _maybe_checkpoint(f, x, self.remat)
        return self.conv(x)


class PSPModule(nn.Module):
    def __init__(self, c: int, sizes=(1, 3, 6, 8)):
        super().__init__()
        self.sizes = tuple(sizes)
        self.project = Conv2d(c * (len(self.sizes) + 1), c, 1, bias=False)

    def forward(self, x):
        hw = x.shape[2:]
        priors = [x] + [resize_bilinear(F.adaptive_avg_pool2d(x, (s, s)), hw)
                        for s in self.sizes]
        return self.project(torch.cat(priors, dim=1))


class GlobalContextAttention(nn.Module):
    """softmax(q k^T / sqrt(K)) v over every token of the /32 map, the
    probabilities kept in float32 through the value product."""

    fp8 = False

    def __init__(self, cin: int, kc: int, vc: int, cout: int):
        super().__init__()
        self.vc = vc
        self.to_query = nn.Sequential(Conv2d(cin, kc, 1, bias=False), bn(kc), nn.ReLU())
        self.to_key = nn.Sequential(Conv2d(cin, kc, 1, bias=False), bn(kc), nn.ReLU())
        self.to_value = Conv2d(cin, vc, 1, bias=False)
        self.psp_key = PSPModule(kc)
        self.psp_value = PSPModule(vc)
        self.project_out = Conv2d(vc, cout, 1, bias=False)

    def _matmul(self, a, b):
        if not self.fp8:
            return torch.matmul(a, b)
        return fp8_product(torch.matmul(fp8_round(a), fp8_round(b)))

    def forward(self, x):
        B, _, H, W = x.shape

        def tokens(t):
            return t.flatten(2).transpose(1, 2)

        q = tokens(self.to_query(x))
        k = tokens(self.psp_key(self.to_key(x)))
        v = tokens(self.psp_value(self.to_value(x)))
        attn = torch.softmax(self._matmul(q, k.transpose(1, 2)) * (q.shape[-1] ** -0.5), -1)
        ctx = self._matmul(attn, v).transpose(1, 2).reshape(B, self.vc, H, W)
        return self.project_out(ctx)


class LocalAttention(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.refine = nn.Sequential(DWConv(c), DWConv(c), DWConv(c))

    def forward(self, x):
        return x + x * torch.sigmoid(self.refine(x))


class ContextAggregationBlock(nn.Module):
    def __init__(self, c: int, vc: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))
        self.global_attn = GlobalContextAttention(c, c // 2, vc, c)
        self.local_attn = LocalAttention(c)

    def forward(self, x):
        return self.gamma * self.global_attn(x) + self.local_attn(x)


class SpatialBranch(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = ConvBNReLU(3, 64, 7, 2, 3)
        self.conv2 = ConvBNReLU(64, 64, 3, 2, 1)
        self.conv3 = ConvBNReLU(64, 64, 3, 2, 1)
        self.conv_out = ConvBNReLU(64, 128, 1, 1, 0)
        self.remat = False

    def forward(self, x):
        for m in (self.conv1, self.conv2, self.conv3, self.conv_out):
            x = _maybe_checkpoint(m, x, self.remat)
        return x


class AttentionBranch(nn.Module):
    def __init__(self, cin: int, mid: int, cout: int, n_classes: int):
        super().__init__()
        self.conva = nn.Sequential(Conv2d(cin, mid, 3, padding=1, bias=False), bn(mid),
                                   nn.ReLU())
        self.a2block = ContextAggregationBlock(mid, mid // 2)
        self.convb = Conv2d(mid, cout, 1, bias=True)
        self.b1 = Conv2d(cin + mid, cout, 3, padding=1, bias=False)
        self.b2 = bn(cout)
        self.b3 = nn.ReLU()
        self.b4 = Conv2d(cout, n_classes, 1, bias=True)

    def forward(self, x):
        feat = self.a2block(self.conva(x))
        fused = self.b3(self.b2(self.b1(torch.cat([x, feat], dim=1))))
        return self.convb(feat), self.b4(fused)


class FeatureFusionModule(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.convblk = ConvBNReLU(cin, cout, 1, 1, 0)
        self.conv1 = Conv2d(cout, cout // 4, 1, bias=False)
        self.conv2 = Conv2d(cout // 4, cout, 1, bias=False)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], dim=1))
        atten = feat.mean(dim=(2, 3), keepdim=True)
        atten = torch.sigmoid(self.conv2(F.relu(self.conv1(atten))))
        return feat * atten + feat


class CABiNetOutput(nn.Module):
    def __init__(self, cin: int, mid: int, n_classes: int):
        super().__init__()
        self.conv = ConvBNReLU(cin, mid, 3, 1, 1)
        self.conv_out = Conv2d(mid, n_classes, 1, bias=False)

    def forward(self, x):
        return self.conv_out(self.conv(x))


class CABiNet(nn.Module):
    """(B,3,H,W) -> (final logits, aux logits), both (B,C,H,W)."""

    def __init__(self, n_classes: int, cfgs: Sequence[Sequence[float]] = LARGE_CFGS):
        super().__init__()
        self.n_classes = n_classes
        self.sb = SpatialBranch()
        self.mobile = MobileNetV3(cfgs)
        self.ab = AttentionBranch(self.mobile.out_channels, 256, 256, n_classes)
        self.ffm = FeatureFusionModule(128 + 256, 256)
        self.conv_out = CABiNetOutput(256, 256, n_classes)

    def set_remat(self, on: bool) -> None:
        self.mobile.remat = self.sb.remat = on

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        H, W = x.shape[2:]
        feat_sb = self.sb(x)
        low_res, aux = self.ab(self.mobile(x))
        sb_hw = feat_sb.shape[2:]
        fuse = self.ffm(feat_sb, resize_bilinear(low_res, sb_hw))
        final = resize_bilinear(self.conv_out(fuse), (H, W))
        aux = resize_bilinear(resize_bilinear(aux, sb_hw), (H, W))
        return final, aux


def state_shapes(n_classes: int, cfgs=LARGE_CFGS) -> dict:
    """{key: (shape, dtype)} of the state dict, without allocating it."""
    with torch.device("meta"):
        sd = CABiNet(n_classes, cfgs).state_dict()
    return {k: (tuple(v.shape), v.dtype) for k, v in sd.items()}


def fan_in(shape) -> int:
    return max(1, math.prod(shape[1:]))
