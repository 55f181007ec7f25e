"""Checkpoint evaluation on the GPU (counterpart of `cabinet_tpu.cli.evaluate`).

Usage (CUDA unless --device cpu):
    python -m cabinet_tpu_torch.cli.evaluate checkpoint_path=... dataset=uavid \
        validation_config.batch_size=1
    python -m cabinet_tpu_torch.cli.evaluate checkpoint_path=... split=test \
        validation_config.eval_scales=[1.0] validation_config.flip=false

`configs/evaluate.yaml` defaults to float32 without the attention kernel;
`runtime.compute_dtype=bfloat16 runtime.use_pallas=true` runs the attention
kernel K1 and, through the fused decoder tail, K2 and K3 on every tile
forward; `runtime.use_pallas=true` alone runs the float32 K1.
`+runtime.quantize=int8` runs int8 post-training quantization
(`cabinet_tpu_torch/quant.py`), calibrated on the first
`runtime.calib_batches` (default 2) batches of the split; `int8dw` also
quantizes the depthwise convs.
`checkpoint_path` takes a reference `.pth` or a JAX variables `.npz`.

Under torchrun (`python -m torch.distributed.run --nproc_per_node R -m
cabinet_tpu_torch.cli.evaluate ...`, `+runtime.dist_backend=gloo` for ranks
sharing a card or the CPU) the ranks join a process group and share each
image's tiles (tile-sharded eval, `eval/evaluator.py`; every rank holds
the same confusion matrix); with `runtime.tile_parallel_eval=false` each
rank scores its share of the frames instead and the matrices are summed.
Rank 0 prints.
"""

from __future__ import annotations

import copy
import itertools
import json
import time
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from cabinet_tpu_torch.cli import common
from cabinet_tpu_torch.core.device import resolve_device
from cabinet_tpu_torch.core.exceptions import ConfigurationError
from cabinet_tpu_torch.models.cabinet import CABiNet


def make_eval_forward(
    model: CABiNet, cropsize: int, device: Union[str, torch.device] = "cuda",
    compute_dtype: torch.dtype = torch.float32, use_pallas: bool = False,
    fused_tail: str = "auto", act_scales: Optional[Mapping[str, float]] = None,
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
      - `act_scales` (runtime.quantize: `calibration_scales`' result) runs
        int8 at those conv sites, in the model's forward and in the branches
        the fused tail runs; the tail's own convs run float inside K2 and
        K3, as in JAX.

    The model's attention is set. Without `act_scales` the model is moved
    to `device` and `compute_dtype` in place and set to eval mode; with
    them a quantized copy is (`quant.make_quantized_apply`, its int8
    weights made from the model's f32 weights), and the model keeps its
    float convs. The returned function's `route` is "fused_tail" or
    "model".
    """
    mode = str(fused_tail).lower()
    if mode not in ("auto", "true", "false"):
        raise ValueError(f"fused_tail must be auto, true or false; got {fused_tail!r}")
    from cabinet_tpu_torch.ops.decoder_tail import fused_tail_supported

    device = resolve_device(device)
    model.ab.a2block.global_attn.attention = "kernel" if use_pallas else "einsum"
    if act_scales is not None:
        from cabinet_tpu_torch.quant import make_quantized_apply

        model = make_quantized_apply(model, act_scales)
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


def calibration_scales(model: CABiNet, loader: Iterable, n_batches: int, crop: int,
                       device: Union[str, torch.device], dtype: torch.dtype,
                       depthwise: bool = False) -> Tuple[Dict[str, float], int]:
    """(act_scales, batches used): the JAX CLI's calibration. The first
    `n_batches` (images, labels) batches of `loader`, cropped to
    [:crop, :crop] and cast to `dtype`, through the forward of a copy of
    `model` (its attention as it is) on `device`; `depthwise` adds the
    depthwise sites (int8dw). The loader's pass is closed after them."""
    from cabinet_tpu_torch.quant import collect_act_scales

    device = resolve_device(device)
    it = iter(loader)
    try:
        batches = [torch.from_numpy(np.ascontiguousarray(images, np.float32))
                   .to(device).to(dtype)[:, :crop, :crop].permute(0, 3, 1, 2)
                   for images, _ in itertools.islice(it, n_batches)]
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()
    calib = copy.deepcopy(model).to(device=device, dtype=dtype)
    return collect_act_scales(calib, batches, quantize_depthwise=depthwise), len(batches)


def evaluate_checkpoint(cfg, device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """Multi-scale metrics of `cfg.checkpoint_path` on `cfg.split` of
    `cfg.dataset`, as `cabinet_tpu.cli.evaluate.evaluate_checkpoint` gives
    them, on this process's device (one rank of several under torchrun):
    the result of `MscEval.evaluate`."""
    from cabinet_tpu_torch.cli.train import join_ranks
    from cabinet_tpu_torch.core import mesh
    from cabinet_tpu_torch.eval.evaluator import MscEval

    split = cfg.get("split", "val")
    if split == "train":
        # Train mode applies augmentation — metrics would be corrupted
        # (reference evaluate.py:280-286).
        raise ConfigurationError(
            "split=train is not supported for evaluation; use val or test.")
    device = join_ranks(cfg, device)
    rank, ranks = mesh.world()
    tile_mesh = common.eval_tile_mesh(cfg)

    vc = cfg.validation_config
    (dataset,) = common.build_datasets(cfg, [split])
    common.guard_val_batch(cfg, dataset, vc.batch_size)
    shard = (rank, ranks) if ranks > 1 and tile_mesh is None else None
    dl = common.make_loader(cfg, dataset, vc.batch_size, num_workers=vc.num_workers,
                            shard=shard)

    n_classes = cfg.dataset.num_classes
    model = common.build_model(cfg, n_classes)
    model.load_state_dict(common.load_model_variables(cfg.checkpoint_path, model),
                          strict=True)
    crop = max(cfg.dataset.cropsize)
    dtype = common.compute_dtype_of(cfg)
    # the JAX CLI quantizes on "int8" and "int8dw" and ignores other values
    quantize = str(cfg.select("runtime.quantize", ""))
    # the JAX CLI reads only "auto" and "true"; any other value runs the model
    fused_tail = str(cfg.select("runtime.fused_tail", "auto")).lower()
    try:  # stops runtime.loader=grain's worker processes at the end
        act_scales = None
        if quantize in ("int8", "int8dw"):
            # every rank calibrates on the split's first batches, not its share's
            calib = dl if shard is None else common.make_loader(
                cfg, dataset, vc.batch_size, num_workers=vc.num_workers)
            try:
                act_scales, n_calib = calibration_scales(
                    model, calib, int(cfg.select("runtime.calib_batches", 2)), crop,
                    device, dtype, depthwise=quantize == "int8dw")
            finally:
                if calib is not dl:
                    calib.close()
            print(f"[info] int8 PTQ: {len(act_scales)} convs quantized, calibrated "
                  f"on {n_calib} batches", flush=True)
        try:
            fwd = make_eval_forward(
                model, crop, device, dtype,
                use_pallas=bool(cfg.select("runtime.use_pallas", False)),
                fused_tail=fused_tail if fused_tail in ("auto", "true") else "false",
                act_scales=act_scales)
        except ValueError as e:  # runtime.fused_tail=true where it cannot run
            raise ConfigurationError(f"{e}. Drop the setting (or fix the config) "
                                     f"to run the model's forward.") from None
        if fwd.route == "fused_tail":
            print("[info] fused decoder tail enabled", flush=True)

        evaluator = MscEval(fwd, n_classes, ignore_label=cfg.dataset.ignore_idx,
                            scales=tuple(vc.eval_scales), flip=bool(vc.flip),
                            cropsize=crop, compute_dtype=dtype,
                            # strict native-resolution protocol by default; opt
                            # into bucketing with validation_config.eval_pad_to
                            pad_to=cfg.select("validation_config.eval_pad_to", None),
                            tile_batch=common.eval_tile_batch(cfg),
                            acc_dtype=common.eval_acc_dtype(cfg), device=device,
                            tile_mesh=tile_mesh)
        return evaluator.evaluate(None, dl, progress=rank == 0)
    finally:
        dl.close()


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Print the metrics of a checkpoint, ending with the JAX CLI's JSON
    line {"mIoU", "accuracy", "iou_per_class"}; returns the full result."""
    from cabinet_tpu_torch.core import mesh

    t0 = time.perf_counter()
    cfg, args = common.parse_cli(argv, "evaluate", "Evaluate a CABiNet checkpoint")
    try:
        res = evaluate_checkpoint(cfg, device=args.device)
    finally:
        mesh.teardown()
    timing = res["timing"]
    timing["main_seconds"] = time.perf_counter() - t0
    if mesh.env_world()[0] != 0:
        return res
    print(f"mIoU: {res['mIoU']:.4f}  accuracy: {res['accuracy']:.4f}")
    for k, v in res["iou_per_class"].items():
        print(f"  {k}: {v:.4f}")
    print(f"frames: {timing['frames']}  main: {timing['main_seconds']:.3f} s  "
          f"evaluation: {timing['seconds']:.3f} s  waiting on the loader: "
          f"{timing['loader_wait_seconds']:.3f} s")
    print(json.dumps({"mIoU": res["mIoU"], "accuracy": res["accuracy"],
                      "iou_per_class": res["iou_per_class"]}), flush=True)
    return res


if __name__ == "__main__":
    main()
