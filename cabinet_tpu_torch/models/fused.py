"""Fused-tail inference forward for CABiNet.

Counterpart of `cabinet_tpu.models.fused.make_fused_tail_apply` (without the
stem+block_0 kernel, which is not ported yet): the backbone and both branches
run as PyTorch modules, the CAB attention through the model's `attention`
choice, and the decoder tail (FFM + output head) through kernels K2 and K3
(`ops/decoder_tail.py`). BN folds once, on the host, in f32.
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


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def make_fused_tail_apply(
    model: CABiNet, device: Union[str, torch.device] = "cuda",
    dtype: torch.dtype = torch.bfloat16, kernels: bool = True,
) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Return `forward(images) -> (final_logits, aux_logits)`, images
    (B,H,W,3) and logits (B,H,W,n_classes), NHWC as in the JAX package.

    The tail's BN folds from the model's parameters as they are (f32 for a
    freshly loaded model); then `model` is moved to `device` and `dtype` in
    place and set to eval mode. On CUDA the attention (when the model was
    built with `attention="kernel"`) and the tail launch the hand-written
    kernels; on the CPU their wrappers run the plain versions. `kernels=False`
    runs the tail's plain versions on any device; with a model built with
    `attention="plain"` that is the reference the kernel path is held
    against on the card.
    """
    if not kernels and model.ab.a2block.global_attn.attention == "kernel":
        raise ValueError("kernels=False takes a model whose attention is not "
                         "the kernel; build it with attention='plain'")
    device = resolve_device(device)
    folded = {k: (v.to(device) if torch.is_tensor(v) else v)
              for k, v in fold_tail_params(model, dtype=dtype).items()}
    model.to(device=device, dtype=dtype).eval()

    @torch.no_grad()
    def forward(images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = images.to(device=device, dtype=dtype).permute(0, 3, 1, 2)
        H, W = x.shape[2:]
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
