"""Context Aggregation Block (PyTorch / NCHW).

Counterpart of `cabinet_tpu.models.cab`: PSPModule, GlobalContextAttention
(with `attention` choosing the CUDA attention kernel K1, its plain version or
the einsum path, in place of JAX's `use_pallas`), LocalAttention and
ContextAggregationBlock. Children follow the
reference state-dict keys (`global_attn.to_query.0`, `local_attn.refine.0.block.0`,
`gamma`, ...). In a tensor-parallel model (`models/tensor_parallel.py`)
the PSP's concatenation and the attention's q, k and v take whole
channels: a slice is gathered first (`full_channels`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cabinet_tpu_torch.models.layers import DWConv, adaptive_avg_pool2d, batch_norm
from cabinet_tpu_torch.models.tensor_parallel import applied_to, full_channels
from cabinet_tpu_torch.ops.attention import (
    fused_global_attention,
    global_attention_plain,
)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear NCHW resize, half-pixel centres, 2-tap in both directions.

    `F.interpolate(mode="bilinear", align_corners=False, antialias=False)`
    has the semantics of the JAX interpolation matrices: sample positions
    (o + 0.5) * n_in/n_out - 0.5 clamped to the edge, two taps, and no
    anti-aliasing on a downscale (the reference evaluation protocol resizes
    with torch's own F.interpolate).
    """
    out_h, out_w = int(size[0]), int(size[1])
    if (out_h, out_w) == tuple(x.shape[2:]):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=False, antialias=False)


def attention_einsum(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> torch.Tensor:
    """softmax(q k^T * K^-0.5) v with the probabilities cast to v's dtype
    before the value product: the JAX package's non-kernel path
    (`models/cab.py`, reference cab.py:149-153). q,k (B,N,K), v (B,N,V)."""
    attn = torch.matmul(q.float(), k.float().transpose(1, 2))
    attn = torch.softmax(attn * (q.shape[-1] ** -0.5), dim=-1).to(v.dtype)
    return torch.matmul(attn.float(), v.float()).to(v.dtype)


# The CAB's (q, k, v) -> context function by name. "kernel" is JAX's
# use_pallas=True: K1 on CUDA tensors, its plain version on CPU tensors.
# "plain" is K1's plain version on any device, the reference the kernel is
# held against on the card. "einsum" is JAX's use_pallas=False path.
ATTENTION = {"kernel": fused_global_attention, "plain": global_attention_plain,
             "einsum": attention_einsum}


class PSPModule(nn.Module):
    """Pyramid pooling with residual feature preservation; (B,C,H,W)->(B,C,H,W)."""

    def __init__(self, channels: int, sizes: Sequence[int] = (1, 3, 6, 8)):
        super().__init__()
        self.sizes = tuple(sizes)
        self.channels = channels
        self.project = nn.Conv2d(channels * (len(self.sizes) + 1), channels, 1,
                                 bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = full_channels(x, self.channels, self)
        hw = x.shape[2:]
        priors = [x] + [resize_bilinear(adaptive_avg_pool2d(x, (s, s)), hw)
                        for s in self.sizes]
        return self.project(torch.cat(priors, dim=1))


class GlobalContextAttention(nn.Module):
    """Reduced non-local attention with PSP-enhanced key/value encoding."""

    def __init__(self, in_channels: int, key_channels: int, value_channels: int,
                 out_channels: Optional[int] = None, scale: int = 1,
                 psp_sizes: Sequence[int] = (1, 3, 6, 8),
                 attention: str = "einsum"):
        super().__init__()
        if attention not in ATTENTION:
            raise ValueError(f"attention must be one of {sorted(ATTENTION)}, "
                             f"got {attention!r}")
        self.scale = scale
        self.in_channels, self.key_channels = in_channels, key_channels
        self.value_channels = value_channels
        self.attention = attention
        self.to_query = nn.Sequential(
            nn.Conv2d(in_channels, key_channels, 1, bias=False),
            batch_norm(key_channels), nn.ReLU())
        self.to_key = nn.Sequential(
            nn.Conv2d(in_channels, key_channels, 1, bias=False),
            batch_norm(key_channels), nn.ReLU())
        self.to_value = nn.Conv2d(in_channels, value_channels, 1, bias=False)
        self.psp_key = PSPModule(key_channels, psp_sizes)
        self.psp_value = PSPModule(value_channels, psp_sizes)
        self.project_out = nn.Conv2d(value_channels, out_channels or in_channels,
                                     1, bias=False)
        nn.init.zeros_(self.project_out.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = full_channels(x, self.in_channels, self)  # one gather for q, k and v
        B, _, H, W = x.shape
        x_down = x
        if self.scale > 1:
            x_down = F.max_pool2d(x, self.scale, self.scale)
        Hd, Wd = x_down.shape[2:]

        def tokens(t: torch.Tensor) -> torch.Tensor:  # (B,C,h,w) -> (B,h*w,C)
            return t.flatten(2).transpose(1, 2).contiguous()

        kc, vc = self.key_channels, self.value_channels
        q = tokens(full_channels(self.to_query(x_down), kc, self))
        k = tokens(full_channels(self.psp_key(self.to_key(x_down)), kc, self))
        v = tokens(full_channels(self.psp_value(self.to_value(x_down)), vc, self))
        context = ATTENTION[self.attention](q, k, v)
        context = context.transpose(1, 2).reshape(B, self.value_channels, Hd, Wd)
        context = self.project_out(context)
        if self.scale > 1:
            context = resize_bilinear(context, (H, W))
        return context


class LocalAttention(nn.Module):
    """Local spatial-channel refinement: x + x * sigmoid(DWConv^3(x))."""

    def __init__(self, channels: int):
        super().__init__()
        self.refine = nn.Sequential(DWConv(channels), DWConv(channels),
                                    DWConv(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + x * torch.sigmoid(self.refine(x))


class ContextAggregationBlock(nn.Module):
    """gamma * global_attn(x) + local_attn(x); gamma zero-init scalar."""

    def __init__(self, in_channels: int, value_channels: int,
                 attention: str = "einsum"):
        super().__init__()
        self.channels = in_channels
        self.gamma = nn.Parameter(torch.zeros(1))
        self.global_attn = GlobalContextAttention(
            in_channels, key_channels=in_channels // 2,
            value_channels=value_channels, out_channels=in_channels, scale=1,
            attention=attention)
        self.local_attn = LocalAttention(in_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        global_feat = self.global_attn(x)
        gamma = applied_to(self.gamma, global_feat, self.channels, self)
        return gamma.to(x.dtype) * global_feat + self.local_attn(x)
