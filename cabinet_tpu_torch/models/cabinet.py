"""CABiNet dual-branch segmentation network (PyTorch / NCHW).

Counterpart of `cabinet_tpu.models.cabinet`:
  - SpatialBranch: 7x7 s2 -> 3x3 s2 -> 3x3 s2 -> 1x1, 128ch @ H/8,
  - AttentionBranch: conva 3x3 -> CAB -> convb 1x1 plus the fusion path
    b1..b4 emitting aux class logits,
  - FeatureFusionModule: concat -> 1x1 ConvBNReLU -> SE-style channel
    attention, feat*atten + feat,
  - CABiNetOutput: 3x3 ConvBNReLU -> bias-free 1x1 classifier,
  - CABiNet.forward: (final logits, aux logits), both bilinearly upsampled to
    the input size.

Modules take and return NCHW; children follow the reference state-dict keys.
In a tensor-parallel model (`models/tensor_parallel.py`) a slice of
channels is gathered where the branches concatenate and at the logits
(`full_channels`).
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cabinet_tpu_torch.core.constants import MODEL_CONFIG
from cabinet_tpu_torch.models.cab import ContextAggregationBlock, resize_bilinear
from cabinet_tpu_torch.models.layers import ConvBNReLU, batch_norm
from cabinet_tpu_torch.models.mobilenetv3 import MobileNetV3, default_cfgs
from cabinet_tpu_torch.models.tensor_parallel import full_channels


class SpatialBranch(nn.Module):
    """High-resolution detail branch: (B,3,H,W) -> (B,128,H/8,W/8)."""

    def __init__(self):
        super().__init__()
        self.conv1 = ConvBNReLU(3, 64, kernel_size=7, stride=2, padding=3)
        self.conv2 = ConvBNReLU(64, 64, kernel_size=3, stride=2, padding=1)
        self.conv3 = ConvBNReLU(64, 64, kernel_size=3, stride=2, padding=1)
        self.conv_out = ConvBNReLU(64, 128, kernel_size=1, stride=1, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_out(self.conv3(self.conv2(self.conv1(x))))


class AttentionBranch(nn.Module):
    """Context branch head over backbone features; returns (low_res_out,
    aux_out): 256-ch features for fusion and num_classes aux logits."""

    def __init__(self, inplanes: int, interplanes: int, outplanes: int,
                 num_classes: int, attention: str = "einsum"):
        super().__init__()
        self.inplanes, self.interplanes, self.num_classes = inplanes, interplanes, num_classes
        self.conva = nn.Sequential(
            nn.Conv2d(inplanes, interplanes, 3, padding=1, bias=False),
            batch_norm(interplanes), nn.ReLU())
        self.a2block = ContextAggregationBlock(interplanes, interplanes // 2,
                                               attention=attention)
        self.convb = nn.Conv2d(interplanes, outplanes, 1, bias=True)
        self.b1 = nn.Conv2d(inplanes + interplanes, outplanes, 3, padding=1,
                            bias=False)
        self.b2 = batch_norm(outplanes)
        self.b3 = nn.ReLU()
        self.b4 = nn.Conv2d(outplanes, num_classes, 1, bias=True)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = full_channels(x, self.inplanes, self)  # for conva and b1's concatenation
        feat = full_channels(self.a2block(self.conva(x)), self.interplanes, self)
        low_res_out = self.convb(feat)
        fused = self.b3(self.b2(self.b1(torch.cat([x, feat], dim=1))))
        return low_res_out, full_channels(self.b4(fused), self.num_classes, self)


class FeatureFusionModule(nn.Module):
    """Concat + 1x1 ConvBNReLU + SE-style channel attention (feat*atten + feat)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.convblk = ConvBNReLU(in_channels, out_channels, kernel_size=1,
                                  stride=1, padding=0)
        self.conv1 = nn.Conv2d(out_channels, out_channels // 4, 1, bias=False)
        self.conv2 = nn.Conv2d(out_channels // 4, out_channels, 1, bias=False)

    def forward(self, fsp: torch.Tensor, fcp: torch.Tensor) -> torch.Tensor:
        feat = self.convblk(torch.cat([fsp, fcp], dim=1))
        atten = feat.mean(dim=(2, 3), keepdim=True)
        atten = torch.sigmoid(self.conv2(F.relu(self.conv1(atten))))
        return feat * atten + feat


class CABiNetOutput(nn.Module):
    """3x3 ConvBNReLU + bias-free 1x1 classifier."""

    def __init__(self, in_channels: int, mid_channels: int, n_classes: int):
        super().__init__()
        self.n_classes = n_classes
        self.conv = ConvBNReLU(in_channels, mid_channels, kernel_size=3, padding=1)
        self.conv_out = nn.Conv2d(mid_channels, n_classes, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return full_channels(self.conv_out(self.conv(x)), self.n_classes, self)


class CABiNet(nn.Module):
    """Dual-branch real-time segmentation network.

    forward(x: (B,3,H,W)) -> (final_logits, aux_logits), both
    (B,n_classes,H,W). `attention` picks the CAB's global attention:
    "kernel" (the CUDA kernel K1; its plain version for CPU tensors), "plain"
    (K1's plain version on any device) or "einsum" (JAX's non-kernel path).
    `remat` (False, True or N) rematerialises backbone blocks in the
    backward (`MobileNetV3`).
    """

    def __init__(self, n_classes: int, mode: str = "large",
                 cfgs: Optional[Sequence[Sequence[float]]] = None,
                 attention: str = "einsum", remat: Any = False):
        super().__init__()
        if mode not in MODEL_CONFIG:
            raise ValueError(f"Invalid mode: {mode}. Must be 'large' or 'small'")
        self.n_classes = n_classes
        self.mode = mode
        self.cfgs = [list(r) for r in (cfgs if cfgs is not None
                                       else default_cfgs(mode))]
        self.sb = SpatialBranch()
        self.mobile = MobileNetV3(self.cfgs, mode=mode, remat=remat)
        self.ab = AttentionBranch(self.mobile.out_channels, 256, 256, n_classes,
                                  attention=attention)
        self.ffm = FeatureFusionModule(128 + 256, 256)
        self.conv_out = CABiNetOutput(256, 256, n_classes)
        self._init_weights()

    def _init_weights(self) -> None:
        """Reference init: MobileNet convs N(0, 2/(k*k*out)) and Linear
        N(0, 0.01) (mobilenetv3.py:224-235); decoder convs kaiming-normal
        a=1, std 1/sqrt(fan_in) (cabinet.py:47-51); the CAB's gamma and
        project_out stay zero."""
        for m in self.mobile.modules():
            if isinstance(m, nn.Conv2d):
                k = m.kernel_size[0] * m.kernel_size[1]
                nn.init.normal_(m.weight, 0.0, math.sqrt(2.0 / (k * m.out_channels)))
            elif isinstance(m, nn.Linear):
                nn.init.normal_(m.weight, 0.0, 0.01)
                nn.init.zeros_(m.bias)
        project_out = self.ab.a2block.global_attn.project_out
        for mod in (self.sb, self.ab, self.ffm, self.conv_out):
            for m in mod.modules():
                if isinstance(m, nn.Conv2d) and m is not project_out:
                    nn.init.kaiming_normal_(m.weight, a=1, mode="fan_in")
                    if m.bias is not None:
                        nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._decode(x, self.mobile(x))

    def forward_from_early(self, x: torch.Tensor, early: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Forward with a precomputed stem+block_0 output `early`
        (B,16,H/2,W/2), the seam for the stem+block_0 kernel."""
        return self._decode(x, self.mobile.tail(early))

    def _decode(self, x: torch.Tensor, mobile_feat: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        H, W = x.shape[2:]
        feat_sb = full_channels(self.sb(x), 128, self.ffm)  # FFM's concatenation
        low_res, aux = self.ab(mobile_feat)
        low_res = full_channels(low_res, 256, self.ffm)  # before the resize: 1/16 the bytes
        sb_hw = feat_sb.shape[2:]
        feat_fuse = self.ffm(feat_sb, resize_bilinear(low_res, sb_hw))
        final = resize_bilinear(self.conv_out(feat_fuse), (H, W))
        aux_full = resize_bilinear(resize_bilinear(aux, sb_hw), (H, W))
        return final, aux_full


def build_cabinet(n_classes: int, mode: str = "large",
                  cfgs: Optional[Sequence[Sequence[float]]] = None,
                  attention: str = "einsum") -> CABiNet:
    """Factory mirroring the reference constructor surface."""
    return CABiNet(n_classes=n_classes, mode=mode, cfgs=cfgs,
                   attention=attention)
