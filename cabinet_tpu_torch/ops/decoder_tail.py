"""Fused FFM + output head (decoder tail): kernels K2 and K3, their plain
versions, the BN fold and the SE glue between them.

Counterpart of `cabinet_tpu/ops/decoder_tail.py`:

  K2 `ffm_pointwise` (replaces `_k1_kernel`): feat = relu(fsp.W1_sp +
     fcp.W1_cp + b1), the FFM 1x1 ConvBNReLU with the concat removed by
     splitting the weight and BN folded, plus f32 channel sums per tile of
     FFM_TILE pixels for the SE mean. Source `csrc/decoder_tail.cu`.
  glue (plain torch, tiny): mean -> SE bottleneck -> scale = sigmoid(..)+1,
     which folds feat*atten + feat into one per-channel scale.
  K3 `head_conv3x3` (replaces `_k2_kernel`): feat*scale (scale cast to feat's
     dtype; zeros outside the image), 3x3 conv 256->256 with f32
     accumulation, +b3, relu, rounded to feat's dtype, 1x1 classifier.
     Source `csrc/decoder_tail.cu`.

Layouts are NHWC, as in the JAX package. The per-tile sums are reduced in
the glue, in a fixed order: no atomics, so the result does not depend on
the order in which blocks run.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch
import torch.nn.functional as F

from cabinet_tpu_torch.ops import _build

ROW_TILE = 16
LANES = 128
FFM_TILE = 64      # pixels per row of K2's sums: FFM_TILE_IN_CU in csrc/decoder_tail.cu
C_SP, C_CP, C_MID = 128, 256, 256  # fsp, fcp and FFM/head widths (architecture)


def _row_tile(s: int) -> int:
    """Largest divisor of S in [4, ROW_TILE] (0 if none), as in the JAX
    package: S=128 -> 16, S=90 -> 15, S=40 -> 10."""
    for rt in range(min(ROW_TILE, s // 2), 3, -1):
        if s % rt == 0:
            return rt
    return 0


def fused_tail_supported(s_h: int, s_w: int, n_classes: int = None) -> bool:
    """The JAX package's predicate for routing to the fused tail, kept as it
    is so that both packages pick the same path: a square /8 grid with a row
    tile of 4-16 that divides it, a plane within the TPU's VMEM budget, and
    at most 128 classes. The CUDA kernels tile by pixels and take any
    grid; they need only n_classes <= 128."""
    rt = _row_tile(s_h)
    return (s_h == s_w and rt > 0 and s_h >= 2 * rt
            and s_h * s_w * 256 * 2 <= 12 * 2 ** 20
            and (n_classes is None or n_classes <= LANES))


def _fold_bn(weight: torch.Tensor, bn: torch.nn.BatchNorm2d):
    """Fold eval-mode BatchNorm into a bias-free OIHW conv (in f32)."""
    scale = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    bias = bn.bias.float() - bn.running_mean.float() * scale
    return weight.float() * scale[:, None, None, None], bias


@torch.no_grad()
def fold_tail_params(model, dtype: torch.dtype = torch.bfloat16
                     ) -> Dict[str, torch.Tensor]:
    """Fold the FFM and output-head parameters of a CABiNet into kernel
    operands, once, in f32 from the model's parameters. Layouts are the JAX
    package's ([in, out] matrices, w3 as (9, in, out)), except that the
    classifier wc is padded to a multiple of 16 columns (the MMA tile), not
    to 128."""
    ffm, head = model.ffm, model.conv_out
    w1, b1 = _fold_bn(ffm.convblk.conv.weight, ffm.convblk.bn)
    w1 = w1[:, :, 0, 0].t()                                  # (384, 256)
    w3, b3 = _fold_bn(head.conv.conv.weight, head.conv.bn)   # (256,256,3,3)
    wc = head.conv_out.weight.float()[:, :, 0, 0].t()        # (256, n)
    n_classes = wc.shape[1]
    if n_classes > LANES:
        raise ValueError(f"fused decoder tail supports at most {LANES} "
                         f"classes; got {n_classes}")
    n_pad = -(-n_classes // 16) * 16
    return {
        "w1_sp": w1[:C_SP].to(dtype).contiguous(),
        "w1_cp": w1[C_SP:].to(dtype).contiguous(),
        "b1": b1.contiguous(),
        "w_se1": ffm.conv1.weight.float()[:, :, 0, 0].t().contiguous(),
        "w_se2": ffm.conv2.weight.float()[:, :, 0, 0].t().contiguous(),
        "w3": w3.permute(2, 3, 1, 0).reshape(9, w3.shape[1], w3.shape[0])
        .to(dtype).contiguous(),
        "b3": b3.contiguous(),
        "wc": F.pad(wc, (0, n_pad - n_classes)).to(dtype).contiguous(),
        "n_classes": n_classes,
    }


# ---------------------------------------------------------------------------
# K2: FFM 1x1 + per-tile channel sums
# ---------------------------------------------------------------------------


def ffm_pointwise_plain(fsp, fcp, w1_sp, w1_cp, b1):
    """Plain version of K2: (B,H,W,128), (B,H,W,256) -> feat (B,H,W,256) in
    fcp's dtype and sums (B, n_tiles, 256) f32, one sum per FFM_TILE pixels
    of the flattened image, over relu(...) in f32."""
    B, H, W, _ = fsp.shape
    y = (torch.matmul(fsp.float(), w1_sp.float())
         + torch.matmul(fcp.float(), w1_cp.float()) + b1.float())
    y = torch.relu(y)
    P = H * W
    n_tiles = -(-P // FFM_TILE)
    flat = F.pad(y.reshape(B, P, -1), (0, 0, 0, n_tiles * FFM_TILE - P))
    sums = flat.reshape(B, n_tiles, FFM_TILE, -1).sum(dim=2)
    return y.to(fcp.dtype), sums


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (the "
                         f"kernels read 16 bytes at a time)")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The library with its launchers' signatures set, once: a launch
    costs the host only the call."""
    lib = _build.load("decoder_tail")
    lib.cabinet_ffm_pointwise.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.cabinet_head_conv3x3.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.cabinet_ffm_pointwise.restype = ctypes.c_int
    lib.cabinet_head_conv3x3.restype = ctypes.c_int
    return lib


def ffm_pointwise(fsp, fcp, w1_sp, w1_cp, b1):
    """K2 wrapper; see `ffm_pointwise_plain` for the function. CPU tensors
    take the plain version; CUDA tensors launch the kernel, which takes
    bf16 NHWC contiguous activations and weights, and f32 b1."""
    if fsp.device.type == "cpu":
        return ffm_pointwise_plain(fsp, fcp, w1_sp, w1_cp, b1)
    if fsp.device.type != "cuda":
        raise ValueError(f"ffm_pointwise: unsupported device {fsp.device}")
    B, H, W, _ = fsp.shape
    dev, bf = fsp.device, torch.bfloat16
    _check("fsp", fsp, (B, H, W, C_SP), bf, dev)
    _check("fcp", fcp, (B, H, W, C_CP), bf, dev)
    _check("w1_sp", w1_sp, (C_SP, C_MID), bf, dev)
    _check("w1_cp", w1_cp, (C_CP, C_MID), bf, dev)
    _check("b1", b1, (C_MID,), torch.float32, dev)
    P = H * W
    n_tiles = -(-P // FFM_TILE)
    feat = torch.empty((B, H, W, C_MID), dtype=bf, device=dev)
    sums = torch.empty((B, n_tiles, C_MID), dtype=torch.float32, device=dev)
    rc = _lib().cabinet_ffm_pointwise(
        fsp.data_ptr(), fcp.data_ptr(), w1_sp.data_ptr(), w1_cp.data_ptr(),
        b1.data_ptr(), feat.data_ptr(), sums.data_ptr(), B, P, n_tiles,
        _build.stream_ptr(dev))
    _build.check_launch(rc, "ffm_pointwise")
    ffm_pointwise.launches += 1
    return feat, sums


ffm_pointwise.launches = 0


# ---------------------------------------------------------------------------
# K3: scale + 3x3 conv + bias + relu + classifier
# ---------------------------------------------------------------------------


def head_conv3x3_plain(feat, scale, w3, b3, wc, n_classes):
    """Plain version of K3: feat (B,H,W,256), scale (B,256) f32 ->
    logits (B,H,W,n_classes) in feat's dtype."""
    x = feat * scale.to(feat.dtype)[:, None, None, :]
    w = w3.float().reshape(3, 3, C_MID, C_MID).permute(3, 2, 0, 1)
    acc = F.conv2d(x.float().permute(0, 3, 1, 2), w, padding=1)
    y = torch.relu(acc.permute(0, 2, 3, 1) + b3.float()).to(feat.dtype)
    logits = torch.matmul(y.float(), wc[:, :n_classes].float())
    return logits.to(feat.dtype)


def head_conv3x3(feat, scale, w3, b3, wc, n_classes):
    """K3 wrapper; see `head_conv3x3_plain` for the function. CPU tensors
    take the plain version; CUDA tensors launch the kernel, which takes
    bf16 NHWC contiguous feat and weights (wc padded to a multiple of 16
    columns, at most 128), f32 scale and b3."""
    if feat.device.type == "cpu":
        return head_conv3x3_plain(feat, scale, w3, b3, wc, n_classes)
    if feat.device.type != "cuda":
        raise ValueError(f"head_conv3x3: unsupported device {feat.device}")
    B, H, W, _ = feat.shape
    dev, bf = feat.device, torch.bfloat16
    n_pad = wc.shape[1]
    if n_pad % 16 or not (0 < n_classes <= n_pad <= LANES):
        raise ValueError(f"wc must have a multiple of 16 columns, at most "
                         f"{LANES}, covering n_classes={n_classes}; got {n_pad}")
    _check("feat", feat, (B, H, W, C_MID), bf, dev)
    _check("scale", scale, (B, C_MID), torch.float32, dev)
    _check("w3", w3, (9, C_MID, C_MID), bf, dev)
    _check("b3", b3, (C_MID,), torch.float32, dev)
    _check("wc", wc, (C_MID, n_pad), bf, dev)
    out = torch.empty((B, H, W, n_classes), dtype=bf, device=dev)
    rc = _lib().cabinet_head_conv3x3(
        feat.data_ptr(), scale.data_ptr(), w3.data_ptr(), b3.data_ptr(),
        wc.data_ptr(), out.data_ptr(), B, H, W, n_classes, n_pad,
        _build.stream_ptr(dev))
    _build.check_launch(rc, "head_conv3x3")
    head_conv3x3.launches += 1
    return out


head_conv3x3.launches = 0


# ---------------------------------------------------------------------------
# The tail: K2 -> SE glue -> K3
# ---------------------------------------------------------------------------


def se_scale(sums: torch.Tensor, n_pixels: int, w_se1: torch.Tensor,
             w_se2: torch.Tensor) -> torch.Tensor:
    """SE glue: mean over H*W -> bottleneck -> sigmoid(..)+1, (B,256) f32."""
    mean = sums.sum(dim=1) / float(n_pixels)
    a = torch.relu(mean @ w_se1)
    return torch.sigmoid(a @ w_se2) + 1.0


def fused_ffm_head(fsp: torch.Tensor, fcp: torch.Tensor,
                   folded: Dict[str, torch.Tensor],
                   kernels: bool = True) -> torch.Tensor:
    """(B,S,S,128) + (B,S,S,256) -> (B,S,S,n_classes) logits. `kernels=False`
    runs the plain versions on any device (the reference the kernels are
    held against on the card)."""
    B, S, S2, _ = fsp.shape
    if not fused_tail_supported(S, S2, folded["n_classes"]):
        raise ValueError(f"fused tail unsupported for S={S}x{S2}")
    k2 = ffm_pointwise if kernels else ffm_pointwise_plain
    k3 = head_conv3x3 if kernels else head_conv3x3_plain
    feat, sums = k2(fsp, fcp, folded["w1_sp"], folded["w1_cp"], folded["b1"])
    scale = se_scale(sums, S * S2, folded["w_se1"], folded["w_se2"])
    return k3(feat, scale, folded["w3"], folded["b3"], folded["wc"],
              folded["n_classes"])
