"""Fused inference forwards for CABiNet.

Counterpart of `cabinet_tpu.models.fused`:

  - `make_fused_apply`: the stem+block_0 kernel K4 (`ops/early_stage.py`) in
    front of the model's own `forward_from_early`;
  - `make_fused_tail_apply`: the backbone and both branches as PyTorch
    modules, the CAB attention through the model's `attention` choice, and
    the decoder tail (FFM + output head) through kernels K2 and K3
    (`ops/decoder_tail.py`); with `use_early`, stem and block_0 through K4.

BN folds once, on the host, in f32. Both return NHWC logits, as the JAX
package does.
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import torch

from cabinet_tpu_torch.core.device import resolve_device
from cabinet_tpu_torch.models.cab import resize_bilinear
from cabinet_tpu_torch.models.cabinet import CABiNet
from cabinet_tpu_torch.ops.decoder_tail import (
    fold_tail_params,
    fused_ffm_head,
    fused_tail_supported,
)
from cabinet_tpu_torch.ops.early_stage import (
    fold_stem_block0_params,
    fused_stem_block0,
    stem_block0_plain,
)

F_BAND = 32  # the JAX kernel's output rows per band (its band rule below)

Forward = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def fused_early_supported(shape: Tuple[int, ...]) -> bool:
    """The JAX predicate for routing to the stem+block_0 kernel, in its
    interpret-mode form, so that both packages pick the same path: even H
    and W, and H/2 a whole number of min(32, H/2)-row bands. The JAX
    compiled path also needs W/2 % 128 == 0; that lane rule is Mosaic's
    alone, and the CUDA kernel takes any even H and W."""
    H, W = shape[1], shape[2]
    if H % 2 or W % 2:
        return False
    h2 = H // 2
    return h2 > 0 and h2 % min(F_BAND, h2) == 0


def _check_kernels(model: CABiNet, kernels: bool) -> None:
    if not kernels and model.ab.a2block.global_attn.attention == "kernel":
        raise ValueError("kernels=False takes a model whose attention is not "
                         "the kernel; build it with attention='plain'")


def _early_stage(model: CABiNet, device: torch.device, dtype: torch.dtype,
                 kernels: bool) -> Callable[[torch.Tensor], torch.Tensor]:
    """images (B,H,W,3) -> block_0's output planes (B,16,H/2,W/2) in
    `dtype`, through K4 (or its plain version with `kernels=False`), from
    weights folded now, before the model moves."""
    folded = tuple(t.to(device) for t in fold_stem_block0_params(model.mobile))
    k4 = fused_stem_block0 if kernels else stem_block0_plain

    def early(images: torch.Tensor) -> torch.Tensor:
        if not fused_early_supported(tuple(images.shape)):
            raise ValueError(f"fused early stage unsupported for input "
                             f"{tuple(images.shape)}; use the model's forward")
        return k4(images.contiguous(), *folded, out_dtype=dtype)

    return early


def make_fused_apply(
    model: CABiNet, device: Union[str, torch.device] = "cuda",
    dtype: torch.dtype = torch.bfloat16, kernels: bool = True,
) -> Forward:
    """Return `forward(images) -> (final_logits, aux_logits)`, images
    (B,H,W,3), logits NHWC: K4 computes stem and block_0, and the model's
    `forward_from_early` the rest, with the CAB attention of the model's
    `attention` choice. Only the MobileNetV3-Large block_0 (3x3 depthwise,
    no expansion, no SE, stride 1, 16 channels) is supported; other cfg
    tables raise. The stem and block_0 BN fold from the model's parameters
    as they are; then `model` is moved to `device` and `dtype` in place and
    set to eval mode. `kernels=False` runs K4's plain version (with a model
    built with attention="plain", the reference on the card)."""
    k, t, c, use_se, _, s = model.cfgs[0]
    if not (int(k) == 3 and float(t) == 1 and int(c) == 16
            and not use_se and int(s) == 1):
        raise ValueError("fused early stage supports the MobileNetV3-Large "
                         f"block_0 only, got cfg row {model.cfgs[0]}")
    _check_kernels(model, kernels)
    device = resolve_device(device)
    early = _early_stage(model, device, dtype, kernels)
    model.to(device=device, dtype=dtype).eval()

    @torch.no_grad()
    def forward(images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        images = images.to(device)
        planes = early(images)
        final, aux = model.forward_from_early(
            images.to(dtype).permute(0, 3, 1, 2), planes)
        return _nhwc(final), _nhwc(aux)

    return forward


def make_fused_tail_apply(
    model: CABiNet, device: Union[str, torch.device] = "cuda",
    dtype: torch.dtype = torch.bfloat16, kernels: bool = True,
    use_early: bool = False,
) -> Forward:
    """Return `forward(images) -> (final_logits, aux_logits)`, images
    (B,H,W,3) and logits (B,H,W,n_classes), NHWC as in the JAX package.

    The tail's BN folds from the model's parameters as they are (f32 for a
    freshly loaded model); then `model` is moved to `device` and `dtype` in
    place and set to eval mode. On CUDA the attention (when the model was
    built with `attention="kernel"`) and the tail launch the hand-written
    kernels; on the CPU their wrappers run the plain versions. `use_early`
    routes stem and block_0 through K4 where `fused_early_supported` holds
    for the input. `kernels=False` runs the tail's (and K4's) plain versions
    on any device; with a model built with `attention="plain"` that is the
    reference the kernel path is held against on the card.
    """
    _check_kernels(model, kernels)
    device = resolve_device(device)
    folded = {k: (v.to(device) if torch.is_tensor(v) else v)
              for k, v in fold_tail_params(model, dtype=dtype).items()}
    early = _early_stage(model, device, dtype, kernels) if use_early else None
    model.to(device=device, dtype=dtype).eval()

    @torch.no_grad()
    def forward(images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        images = images.to(device)
        x = images.to(dtype).permute(0, 3, 1, 2)
        H, W = x.shape[2:]
        if early is not None and fused_early_supported(tuple(images.shape)):
            mob = model.mobile.tail(early(images))
        else:
            mob = model.mobile(x)
        feat_sb = model.sb(x)
        low_res, aux = model.ab(mob)
        sb_hw = tuple(feat_sb.shape[2:])
        if not fused_tail_supported(*sb_hw, folded["n_classes"]):
            raise ValueError(f"fused decoder tail unsupported for /8 grid "
                             f"{sb_hw}; use the model's forward")
        fcp = resize_bilinear(low_res, sb_hw)
        final_small = fused_ffm_head(_nhwc(feat_sb).contiguous(),
                                     _nhwc(fcp).contiguous(), folded,
                                     kernels=kernels)
        final = resize_bilinear(final_small.permute(0, 3, 1, 2), (H, W))
        aux_full = resize_bilinear(resize_bilinear(aux, sb_hw), (H, W))
        return _nhwc(final), _nhwc(aux_full)

    return forward
