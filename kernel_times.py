#!/usr/bin/env python3
"""Times the kernel wrappers of one checkout of the port on one CUDA card,
so that two commits can be compared in one run:

    python3 kernel_times.py [--root DIR] [--label NAME]

`--root` holds the `cabinet_tpu_torch` to time (by default the one beside
this file); its kernels are built there. For K1 in bf16 and in f32 (N=1024,
K=V=128), K2 and K3 (S=128, 8 classes), each at batch 1 and 8, and for K4
on (8,1024,1024,3) and (2,720,1280,3) in bf16 and in f32 (x and planes of
one dtype; the weights as views of one buffer), it prints one JSON line per kernel and shape with the median of
5 timings of:
  - `ms`: CUDA events around back-to-back calls of the wrapper, the host's
    time where launching takes longer (chip_smoke.py's `ms`);
  - `device_ms`: the same calls replayed from a CUDA graph, the device's
    time alone (chip_smoke.py's `device_ms`).
It calls only the wrappers' public signatures, which every version of the
port shares. To compare two commits, time parent, change, change, parent
on one card, one after another.

With `--splits`, it also times K1 (bf16 and f32, batch 1 and 8) with the
wrapper's split count `key_splits` replaced by each of 1, 2, 4, 8 and 16
(at most one a key tile): rows named `attention splits=S` and
`attention_f32 splits=S`. A checkout whose wrapper does not call
`key_splits` for a dtype gives that dtype's rows the same time at every S.
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


def with_splits(attn, n: int, fn):
    """fn with the attention wrapper's `key_splits` returning n (at most
    the key tiles' count) during each call."""
    rule = attn.key_splits

    def call():
        attn.key_splits = lambda B, N, n_sm: min(n, -(-N // attn.BLOCK))
        try:
            return fn()
        finally:
            attn.key_splits = rule
    return call


def packed_views(torch, ws):
    """K4's six weights copied one after another into one buffer and
    returned as views of it, the form `models/fused.py` holds them in (a
    wrapper that takes them packed launches from it as it is)."""
    buf = torch.cat([t.reshape(-1) for t in ws])
    ends = [0]
    for t in ws:
        ends.append(ends[-1] + t.numel())
    return tuple(buf[a:b].view(t.shape) for t, a, b in zip(ws, ends, ends[1:]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent)
    ap.add_argument("--label", default="")
    ap.add_argument("--splits", action="store_true",
                    help="also sweep K1's split count")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_times: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    from cabinet_tpu_torch.ops import attention as attn
    from cabinet_tpu_torch.ops import decoder_tail as dt
    from cabinet_tpu_torch.ops import early_stage as es

    dev = chip_smoke.DEVICE
    gen = torch.Generator(device=dev).manual_seed(0)
    cases, sweep = [], []
    for name, dtype in (("attention", torch.bfloat16), ("attention_f32", torch.float32)):
        for B in (1, 8):
            q, k, v = (torch.randn(B, 1024, 128, generator=gen, device=dev)
                       .to(dtype) for _ in range(3))
            shape = f"B={B} N=1024 K=V=128" + (" f32" if dtype == torch.float32 else "")
            fn = lambda q=q, k=k, v=v: attn.fused_global_attention(q, k, v)  # noqa: E731
            cases.append((name, shape, fn))
            sweep += [(f"{name} splits={n}", shape, with_splits(attn, n, fn))
                      for n in (1, 2, 4, 8, 16)]
    for B in (1, 8):
        o = chip_smoke.tail_operands(torch, 128, 8, B, gen)
        k2 = (o["fsp"], o["fcp"], o["w1_sp"], o["w1_cp"], o["b1"])
        feat, _ = dt.ffm_pointwise(*k2)
        scale = torch.rand(B, 256, generator=gen, device=dev) + 1.0
        k3 = (feat, scale, o["w3"], o["b3"], o["wc"], 8)
        shape = f"B={B} S=128 n_classes=8"
        cases.append(("ffm_pointwise", shape, lambda k2=k2: dt.ffm_pointwise(*k2)))
        cases.append(("head_conv3x3", shape, lambda k3=k3: dt.head_conv3x3(*k3)))
    w = packed_views(torch, chip_smoke.stem_weights(torch, gen))
    for shape in ((8, 1024, 1024, 3), (2, 720, 1280, 3)):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(*shape, generator=gen, device=dev).to(dtype)
            cases.append(("stem_block0", f"{shape} {str(dtype)[6:]}",
                          lambda x=x, dtype=dtype: es.fused_stem_block0(
                              x, *w, out_dtype=dtype)))

    if args.splits:
        cases += sweep

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
