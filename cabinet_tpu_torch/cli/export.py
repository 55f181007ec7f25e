"""Export a CABiNet checkpoint as a standalone serving artifact
(counterpart of `cabinet_tpu.cli.export`).

The artifact is one `torch.export` program with the weights and the
preprocessing inside; see `cabinet_tpu_torch/export.py` for its contract.
It runs the model's own path, holds none of the hand-written kernels, and
runs only on the device type it was exported for.

Usage (CUDA unless --device cpu):
    python -m cabinet_tpu_torch.cli.export --checkpoint ck.pth --dataset uavid \\
        --out artifacts/uavid_large [--imgsz 1024] [--batch 1|b] \\
        [--mode large] [--dtype bfloat16] [--device cuda] [--check]

``--batch b`` exports a symbolic batch dimension (one artifact, any batch).
``--check`` loads the artifact back on the same device and requires it to
match the live serving module bit for bit (cuDNN's autotuner off, so that
both runs pick the same algorithms).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch


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
                   help="the int8 PTQ serving path (not ported yet)")
    p.add_argument("--device", default="cuda",
                   help="torch device the program is exported for and runs on")
    p.add_argument("--check", action="store_true",
                   help="load the artifact back and verify it against the "
                        "live serving module")
    args = p.parse_args(argv)
    if args.quantize:
        raise NotImplementedError(
            f"--quantize {args.quantize}: the int8 PTQ path (cabinet_tpu/quant.py) "
            f"is not ported yet (ROADMAP.md Queue 1 item 5)")
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
