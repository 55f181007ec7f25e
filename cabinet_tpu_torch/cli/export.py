"""Export a CABiNet checkpoint as a standalone serving artifact
(counterpart of `cabinet_tpu.cli.export`).

The artifact is one `torch.export` program with the weights and the
preprocessing inside; see `cabinet_tpu_torch/export.py` for its contract.
It runs the model's own path, holds none of the hand-written kernels, and
runs only on the device type it was exported for.

Usage (CUDA unless --device cpu):
    python -m cabinet_tpu_torch.cli.export --checkpoint ck.pth --dataset uavid \\
        --out artifacts/uavid_large [--imgsz 1024] [--batch 1|b] \\
        [--mode large] [--dtype bfloat16] [--device cuda] [--check] \\
        [--quantize int8|int8dw --calib 'val/*.png']

``--batch b`` exports a symbolic batch dimension (one artifact, any batch).
``--quantize`` bakes int8 post-training quantization into the artifact
(`cabinet_tpu_torch/quant.py`), its activation scales calibrated on at most
16 frames of ``--calib``, resized to ``--imgsz`` and normalised as the
artifact normalises.
``--check`` loads the artifact back on the same device and requires it to
match the live serving module bit for bit (cuDNN's autotuner off, so that
both runs pick the same algorithms).
"""

from __future__ import annotations

import argparse
import glob
import time
from typing import Optional, Sequence

import numpy as np
import torch


def calibrate(model, paths: Sequence[str], mean: Sequence[float], std: Sequence[float],
              imgsz: int, dtype: torch.dtype, device: torch.device,
              depthwise: bool = False) -> dict:
    """The activation scales of `model` on the frames at `paths` as one
    batch, as the JAX CLI calibrates: each frame decoded to RGB
    (`data/decode.py:open_rgb`), resized to imgsz x imgsz as PIL's
    BILINEAR resizes (`cli/infer.py:_resize_like_pil`), normalised in numpy
    f32, cast to `dtype`, through a copy of the model on `device`."""
    import copy

    from cabinet_tpu_torch.cli.infer import _resize_like_pil
    from cabinet_tpu_torch.data.decode import open_rgb
    from cabinet_tpu_torch.quant import collect_act_scales

    mean, std = np.asarray(mean, np.float32), np.asarray(std, np.float32)
    frames = []
    for path in paths:
        rgb = torch.from_numpy(open_rgb(path)).permute(2, 0, 1)[None]
        rgb = _resize_like_pil(rgb, (imgsz, imgsz))[0].permute(1, 2, 0).numpy()
        frames.append((rgb.astype(np.float32) / 255.0 - mean) / std)
    calib = torch.from_numpy(np.stack(frames)).to(device).to(dtype).permute(0, 3, 1, 2)
    return collect_act_scales(copy.deepcopy(model).to(device=device, dtype=dtype),
                              [calib], quantize_depthwise=depthwise)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", required=True,
                   help="reference .pth state dict, a .pth of the port's "
                        "trainer, or a JAX variables .npz")
    p.add_argument("--dataset", required=True,
                   help="dataset name (class count + normalization stats)")
    p.add_argument("--out", required=True, help="artifact output directory")
    p.add_argument("--imgsz", type=int, default=1024)
    p.add_argument("--batch", default="1",
                   help="int for a fixed batch, or a dim name (e.g. 'b') "
                        "for a symbolic batch")
    p.add_argument("--family", default="cabinet",
                   choices=("cabinet", "yolosem"))
    p.add_argument("--mode", default="large", choices=("large", "small"),
                   help="CABiNet size (family=cabinet)")
    p.add_argument("--variant", default="n",
                   help="YOLO-sem variant (family=yolosem): n/s/m/l/x")
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--quantize", default=None, choices=("int8", "int8dw"),
                   help="bake the int8 PTQ serving path into the artifact "
                        "(cabinet_tpu_torch/quant.py; int8dw also quantizes "
                        "the depthwise convs); requires --calib")
    p.add_argument("--calib", default=None, metavar="GLOB",
                   help="calibration images for --quantize (glob of PNG/JPG "
                        "files, e.g. 'val/*.png'; activation scales are "
                        "computed through the normalization the artifact "
                        "bakes in)")
    p.add_argument("--device", default="cuda",
                   help="torch device the program is exported for and runs on")
    p.add_argument("--check", action="store_true",
                   help="load the artifact back and verify it against the "
                        "live serving module")
    args = p.parse_args(argv)
    calib_paths = []
    if args.quantize:
        if not args.calib:
            raise SystemExit(f"--quantize {args.quantize} requires --calib <glob>")
        calib_paths = sorted(glob.glob(args.calib))[:16]  # a handful saturates the absmax
        if not calib_paths:
            raise SystemExit(f"--calib matched no files: {args.calib}")
    if args.family == "yolosem":
        raise NotImplementedError(
            "--family yolosem: the YOLO-sem family is not ported yet "
            "(ROADMAP.md Queue 1 item 6)")

    from cabinet_tpu_torch.cli.infer import load_state_dict
    from cabinet_tpu_torch.core.device import resolve_device
    from cabinet_tpu_torch.data.datasets import DATASET_REGISTRY
    from cabinet_tpu_torch.data.palettes import PALETTES, trainid_palette
    from cabinet_tpu_torch.export import (
        export_serving,
        load_artifact,
        make_serving_fn,
        save_artifact,
    )
    from cabinet_tpu_torch.models.cabinet import CABiNet

    device = resolve_device(args.device)
    ds_cls = DATASET_REGISTRY[args.dataset]
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[args.dtype]
    model = CABiNet(ds_cls.NUM_CLASSES, mode=args.mode, attention="einsum")
    model.load_state_dict(load_state_dict(args.checkpoint, model), strict=True)
    if args.quantize:
        from cabinet_tpu_torch.quant import make_quantized_apply

        scales = calibrate(model, calib_paths, ds_cls.MEAN, ds_cls.STD, args.imgsz,
                           dtype, device, depthwise=args.quantize == "int8dw")
        model = make_quantized_apply(model, scales)
        print(f"[INFO] int8 PTQ: calibrated {len(scales)} conv sites on "
              f"{len(calib_paths)} frames", flush=True)
    try:
        batch = int(args.batch)
    except ValueError:
        batch = args.batch  # symbolic dim name
    t0 = time.perf_counter()
    program = export_serving(model, mean=ds_cls.MEAN, std=ds_cls.STD,
                             imgsz=args.imgsz, batch=batch, dtype=dtype,
                             device=device)
    palette = (trainid_palette(PALETTES[args.dataset])
               if args.dataset in PALETTES else None)
    out = save_artifact(program, args.out, {
        "family": args.family,
        "variant": None,
        "quantize": args.quantize,
        "dataset": args.dataset,
        "n_classes": ds_cls.NUM_CLASSES,
        "imgsz": args.imgsz,
        "batch": args.batch,
        "mode": args.mode,
        "dtype": args.dtype,
        "mean": list(ds_cls.MEAN),
        "std": list(ds_cls.STD),
        "palette": None if palette is None else np.asarray(palette).tolist(),
        "input": "uint8 RGB (B,H,W,3)",
        "output": "int32 class IDs (B,H,W)",
    })
    print(f"[INFO] exported serving artifact -> {out} (device={args.device}, "
          f"batch={args.batch}, {args.imgsz}^2, "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)

    if args.check:
        serve, _meta = load_artifact(out, device)
        b = batch if isinstance(batch, int) else 2
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.integers(0, 256, (b, args.imgsz, args.imgsz, 3),
                                          dtype=np.uint8)).to(device)
        live = make_serving_fn(model, ds_cls.MEAN, ds_cls.STD, dtype).to(device)
        benchmark = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = False
        try:
            with torch.no_grad():
                got, want = serve(x), live(x)
        finally:
            torch.backends.cudnn.benchmark = benchmark
        if not torch.equal(got, want):
            raise SystemExit(
                "round-trip check FAILED: artifact disagrees with the live "
                f"module on {int((got != want).sum())} / {got.numel()} pixels")
        print("[INFO] round-trip check passed (bit-exact vs the live module)",
              flush=True)


if __name__ == "__main__":
    main()
