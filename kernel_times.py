#!/usr/bin/env python3
"""Times the decoder-tail and bf16 attention wrappers of one checkout of the
port on one CUDA card, so that two commits can be compared in one run:

    python3 kernel_times.py [--root DIR] [--label NAME]

`--root` holds the `cabinet_tpu_torch` to time (by default the one beside
this file); its kernels are built there. For K1 bf16 (N=1024, K=V=128), K2
and K3 (S=128, 8 classes), each at batch 1 and 8, it prints one JSON line
per kernel and shape with the median of 5 timings of:
  - `ms`: CUDA events around back-to-back calls of the wrapper, the host's
    time where launching takes longer (chip_smoke.py's `ms`);
  - `device_ms`: the same calls replayed from a CUDA graph, the device's
    time alone (chip_smoke.py's `device_ms`).
It calls only the wrappers' public signatures, which every version of the
port shares. To compare two commits, time parent, change, change, parent
on one card, one after another.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import chip_smoke

REPEATS = 5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent)
    ap.add_argument("--label", default="")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_times: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    from cabinet_tpu_torch.ops import decoder_tail as dt
    from cabinet_tpu_torch.ops.attention import fused_global_attention

    dev = chip_smoke.DEVICE
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for B in (1, 8):
        q, k, v = (torch.randn(B, 1024, 128, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        cases.append(("attention", f"B={B} N=1024 K=V=128",
                      lambda q=q, k=k, v=v: fused_global_attention(q, k, v)))
    for B in (1, 8):
        o = chip_smoke.tail_operands(torch, 128, 8, B, gen)
        k2 = (o["fsp"], o["fcp"], o["w1_sp"], o["w1_cp"], o["b1"])
        feat, _ = dt.ffm_pointwise(*k2)
        scale = torch.rand(B, 256, generator=gen, device=dev) + 1.0
        k3 = (feat, scale, o["w3"], o["b3"], o["wc"], 8)
        shape = f"B={B} S=128 n_classes=8"
        cases.append(("ffm_pointwise", shape, lambda k2=k2: dt.ffm_pointwise(*k2)))
        cases.append(("head_conv3x3", shape, lambda k3=k3: dt.head_conv3x3(*k3)))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    for name, shape, fn in cases:
        ms = [chip_smoke.time_ms(fn) for _ in range(REPEATS)]
        dms = [chip_smoke.graph_ms(fn) for _ in range(REPEATS)]
        print(json.dumps({"label": args.label, "card": smi, "name": name,
                          "shape": shape, "ms": statistics.median(ms),
                          "device_ms": statistics.median(dms)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
