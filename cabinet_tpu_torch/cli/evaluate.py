"""Checkpoint evaluation on the GPU (counterpart of `cabinet_tpu.cli.evaluate`).

This slice holds the choice of forward only (`make_eval_forward`, mirroring
`cabinet_tpu/cli/evaluate.py:74-108`); config composition, the datasets and
the loader of the JAX CLI's `main` are not ported yet. Use it with
`eval.evaluator.MscEval`:

    fwd = make_eval_forward(model, cropsize=1024, compute_dtype=torch.bfloat16,
                            use_pallas=True)
    ev = MscEval(fwd, n_classes, scales=(0.75, 1.0, 1.25), flip=True,
                 cropsize=1024, compute_dtype=torch.bfloat16)
    metrics = ev.evaluate(None, loader)
"""

from __future__ import annotations

from typing import Any, Callable, Tuple, Union

import torch

from cabinet_tpu_torch.core.device import resolve_device
from cabinet_tpu_torch.models.cabinet import CABiNet


def make_eval_forward(
    model: CABiNet, cropsize: int, device: Union[str, torch.device] = "cuda",
    compute_dtype: torch.dtype = torch.float32, use_pallas: bool = False,
    fused_tail: str = "auto", quantize: str = "",
) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """Return `apply_fn(variables, images) -> (logits, aux)` (NHWC, the
    `variables` argument ignored) for `MscEval`, as the JAX CLI picks it:

      - `use_pallas` (runtime.use_pallas) sets the model's CAB attention to
        the attention kernel K1 (bf16 or f32 by `compute_dtype`; its plain
        version on the CPU) or, when false, to the einsum path;
      - `fused_tail` (runtime.fused_tail): "auto" runs the fused decoder
        tail (K2, K3) on CUDA when `compute_dtype` is bf16 and the crop's
        /8 grid is supported; "true" runs it wherever both hold and raises
        where they do not; "false" runs the model's forward;
      - `quantize` (runtime.quantize, int8 PTQ) is not ported yet and raises.

    The model is moved to `device` and `compute_dtype` in place and set to
    eval mode. The returned function's `route` is "fused_tail" or "model".
    """
    if quantize:
        raise NotImplementedError(f"runtime.quantize={quantize} is not ported "
                                  f"yet (int8 PTQ)")
    mode = str(fused_tail).lower()
    if mode not in ("auto", "true", "false"):
        raise ValueError(f"fused_tail must be auto, true or false; got {fused_tail!r}")
    from cabinet_tpu_torch.ops.decoder_tail import fused_tail_supported

    device = resolve_device(device)
    model.ab.a2block.global_attn.attention = "kernel" if use_pallas else "einsum"
    s8 = cropsize // 8
    why = None
    if not fused_tail_supported(s8, s8, model.n_classes):
        why = (f"crop/8 grid {s8}x{s8} with {model.n_classes} classes is "
               f"outside kernel support")
    elif compute_dtype != torch.bfloat16:
        why = "requires runtime.compute_dtype=bfloat16"
    elif mode == "auto" and device.type != "cuda":
        why = "auto mode enables only on CUDA"

    if mode != "false" and why is None:
        from cabinet_tpu_torch.models.fused import make_fused_tail_apply

        forward = make_fused_tail_apply(model, device, compute_dtype)
        route = "fused_tail"
    elif mode == "true":
        raise ValueError(f"runtime.fused_tail=true but the fused decoder tail "
                         f"cannot be enabled: {why}")
    else:
        model.to(device=device, dtype=compute_dtype).eval()

        @torch.no_grad()
        def forward(images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
            x = images.to(device=device, dtype=compute_dtype)
            return tuple(t.permute(0, 2, 3, 1)
                         for t in model(x.permute(0, 3, 1, 2)))

        route = "model"

    def apply_fn(variables: Any, images: torch.Tensor):
        return forward(images)

    apply_fn.route = route
    return apply_fn
