#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (cabinet_tpu_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It drives the port's main paths through the entry points a user calls, and
holds every hand-written kernel against its plain PyTorch version. Phases:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    compile csrc/*.cu (one nvcc per source, in parallel); print
              ptxas' registers and spills and, from the SASS, each kernel's
              FFMAs by operand kind and its ULDC, LDS and HMMA counts
  3. kernels  K1 attention (bf16 and f32), K2 FFM 1x1, K3 3x3 head and K4
              stem+block_0 at the main paths' shapes against their plain
              versions, with times of the kernel's wrapper, the plain
              version and one library call: called back to back (`ms`,
              `plain_ms`, `library_ms`: the host's time where launching
              takes longer), and the same calls replayed from a CUDA graph
              (`device_ms`, `plain_device_ms`, `library_device_ms`: the
              device's time alone)
  4. main     each path driven with the launch counts set to 0 just before
              it and read just after:
              - the fused-tail forward on the trained Large fixture
                (tests/fixtures/miou_large_cabinet_v1.npz) on single-class
                palette images (K1-K3);
              - Segmenter.predict / predict_batch in bf16 at batch 1 (K1-K3,
                not K4) and 8 (K1-K4), on seeded uavid weights saved as a
                .pth, each mask held against the plain path;
              - Segmenter in float32 at batch 8 (K4 and the f32 K1 through
                make_fused_apply) against the plain path;
              then forward ms/img with K4 and without it at batch 1 and 8,
              timed in turns, back to back and replayed from a CUDA graph
  5. attn     the fixture with its zero gamma/project_out perturbed: the
              kernel path against the plain path, logits and argmax, and
              how far the attention moves the logits (the same forward
              with gamma 0), which must exceed the logit bound 4 times
  6. eval     MscEval on the fixture: in f32 with the f32 K1 against the
              reference's cached confusion matrices
              (tests/fixtures/miou_ref_outputs_large_v1.npz) under the gates
              of tests/parity/test_miou_at_scale_large.py; in bf16 through
              make_eval_forward(fused_tail="true", use_pallas=True) (K1-K3)
              on a 1024x2048 image at 3 scales against the plain path
  7. evaluate_main  `cli/evaluate.py:main` as a user runs it, over a
              Cityscapes-layout val split of 2048x1024 PNG frames that this
              script writes with the port's `save_png`: in bf16 with
              runtime.use_pallas=true (K1-K3 on every tile forward, at
              evaluate.yaml's six scales with flip, crop 1024, batch 2)
              against the plain path's confusion matrix and argmax, and in
              float32 on one frame at scale 1 (the f32 K1) against the f32
              plain path's, near ties allowed; with main's seconds per
              frame, the share of its loop spent waiting on the loader, and
              the PNG reader's ms per frame and per mask
  8. train_step  the port's trainer on CABiNet-Large, 19 classes (the full
              published table): one optimizer step (accum_steps=2) in f32
              on the card against the same step on the CPU, 512^2, batch 2;
              then batch 4 at 1024^2 in bf16 with attention="kernel", 30
              steps on one fixed batch: the loss must fall and K1 must not
              launch in the steps (the val loss launches it); ms per step,
              images/s, peak memory, and the steps with torch's own
              BatchNorm in turns with the port's
  9. train_main  `cli/train.py:main` as a user runs it, dataset=cityscapes
              over a split of 8 train and 2 val 2048x1024 frames this
              script writes, configs/train.yaml as it is apart from epochs,
              warmup, loader threads, log_iter and runtime.use_pallas=true
              (bf16, batch 4, crop 1024, six scales with flip at the end):
              metrics.jsonl, the checkpoints, K1 in the evaluations and
              not in the steps, a resume from step 4 to 6, and the final
              EMA weights scored by evaluate main; with main's seconds, the
              loop's seconds per optimizer step, its loader-wait share and
              the host ms per augmented frame
  10. device_augs  the device augmentation at full size (batch 4, canvas
              2048, crop 1024): the exact and the shared warp, each with
              the aerial and the street chain, on the card against the
              same on the CPU from the same host-drawn params and noise,
              and timed on the card beside its byte bound; then
              `cli/train.py:main` twice over a Cityscapes split like phase
              9's with runtime.device_geometric=true and a decode cache,
              cold then warm, and once over a UAVid-layout split of
              3840x2160 frames with runtime.device_geometric=shared and
              runtime.remat=true (one eval scale): each run's loss finite
              and falling, K1 in its evaluations and never in its steps,
              the loop's seconds per step, loader-wait share and device
              augmentation seconds, the host ms per canvas frame; and the
              train step at batch 4, 1024^2, bf16 with remat false / 4 /
              true: ms per step and peak memory
  11. serve  serving and export at CABiNet-Large, 1024^2, on seeded
              uavid weights saved as a .pth: (a) `cli/export.py:main` (bf16,
              symbolic batch, --check on the card), its seconds and bytes,
              and the artifact's ms/img at batch 1 and 8 beside the kernel
              route's; (b) `cli/serve.py`'s checkpoint server in bf16
              (max_batch 8, deadline 3 ms, queue 64) over HTTP on 16
              1920x1080 PNG frames: 8 solo requests, then 32 concurrent
              clients x 4 requests (requests/s, p50/p99, mean batch size),
              every mask held against the plain path by phase 4's rule, K1-K4
              launched; the host steps' ms apart; (c) backpressure (queue 2,
              50 ms submit timeout, 32 requests at once): a 503 and no lost
              request; (d) the f32 server (the f32 K1 and K4, not K2/K3); (e)
              the server on (a)'s artifact, each batch bit-equal to the live
              serving module; then, in fresh processes with lazy and with
              eager module loading, where a server's first requests go
  12. data   the data layer as a user meets it, from a raw UAVid download:
              a raw tree (<split>/<seq>/{Images,Labels}, 8 train and 2 val
              3840x2160 frames, images Paeth-filtered, labels in UAVid's
              colours with patches of unknown ones); `cli/convert.py uavid
              --workers <cores>`, every mask held against a plain numpy
              remap of its label (unknown colours 255) and every image a
              link; `cli/compute_stats.py` on images/train against a numpy
              recomputation; the process loader's first batches (worker
              start-up); `cli/train.py:main` (CABiNet-Large, bf16,
              use_pallas, crop 1024, 8 loader workers) with
              runtime.loader=thread (1 epoch) and =grain (2 epochs) in
              turns, once each, on the host recipe and on the device canvas
              (device_geometric=true), the batches of the epoch both take
              bit-equal between the loaders,
              with each run's loop s per step and loader-wait share; and
              `cli/evaluate.py:main` on the EMA weights (bf16, use_pallas,
              K1-K3) with each loader, the confusion matrices equal
  13. quant  int8 post-training quantization (cabinet_tpu_torch/quant.py):
              (a) every int8dw site of CABiNet-Large at its input shape at
              1024^2, batch 1 and 8: int8 inputs, int32 sums and outputs on
              the card equal to the CPU's bit for bit; (b)
              `cli/evaluate.py:main` on the trained fixture over 2 of phase
              7's frames (bf16, use_pallas, six scales with flip, batch 1):
              float, +runtime.quantize=int8, =int8dw and =int8dw with
              runtime.loader=grain, then float again, each quantized run
              printing its 46 or 64 quantized convs, launching K1-K3 on
              every tile forward (K1 also in its 2 calibration forwards)
              and no K4, within 0.5% of the pixels and 0.01 mIoU of the
              float run; (c) `cli/export.py
              --quantize int8dw --calib` on those frames with --check, and
              the checkpoint-less server on that artifact answering 8
              requests, each batch bit-equal to the live quantized module;
              (d) the fused-tail forward's ms/img float, int8 and int8dw at
              batch 1 and 8, in turns, back to back and from a CUDA graph
  14. yolo   the YOLO-sem family (models/yolosem.py; no kernel on its
              path): (a) each of the five variants' f32 forward on the card
              against the CPU at 256^2 (TF32 off), and yolo26n-sem's and
              yolo26x-sem's bf16 forward ms/img at 1024^2, batch 1 and 8,
              back to back and from a CUDA graph; (b)
              `cli/train_yolo.py:main` on phase 12's converted UAVid tree
              (yolo26n-sem, imgsz 1024, batch 4, bf16, nbs 8 = accum 2,
              epochs 2, close_mosaic 1, 8 workers of the process loader),
              then resume=true to epoch 3, then mode=val on the `final`
              EMA weights at the native 3840x2160: s per step, loader-wait
              share, the class counts' seconds, peak memory, finite
              losses, the mIoU; (c) yolo26x-sem
              train steps at batch 4, 1024^2, bf16: ms per step and peak
              memory; (d) `cli/export.py --family yolosem --check` on
              `final`, and the checkpoint-less server on that artifact
              answering 8 requests, each batch bit-equal to the live
              serving module; (e) no kernel launched in the phase
  15. tools  (a) `cli/visualize.py:main` on phase 9's EMA weights over 2 of
              phase 7's 2048x1024 frames (bf16, use_pallas, six scales with
              flip): the four PNGs of each frame, the pred PNG equal to
              evaluate's argmax colours, K1-K3 launched; (b)
              `cli/convert_checkpoint.py` export then import of those
              weights, bit-equal and loaded strict; (c)
              `PerformanceProfiler.run_full_benchmark` on Segmenter's bf16
              forward at 1024^2, batch 1 (K1-K3) and 8 (K1-K4), its FLOPs
              equal to FlopCounterMode's count of the plain route; then a
              `trace` of 10 batch-8 forwards: the top 10 device ops and
              the device's busy share; (d) `cli/train.py:main
              --legacy-config legacy/train_citys.json` on phase 9's split,
              batch 4, 2 optimizer steps
  16. dp     `cli/train.py:main` under torchrun (`--rank-main`, below) on
              phase 9's split, global batch 4, 2 epochs of 2 steps, f32 with
              TF32 off: R=1 on NCCL, R=2 on gloo sharing the card; the
              losses and weights of R=2 held against R=1's, the ranks'
              weights and EMA bit-equal, one set of outputs (rank 0's), K1
              in the evaluations (R=2: frame-sharded, each rank its share
              of the frames, the matrices summed) and in no step; each
              step's ms and its
              collectives' host ms; then 2 steps of `cli/train_yolo.py:main`
              on 2 ranks; no rank left. Every 2-rank job of phases 16-18
              runs here, in one torchrun (`run_two_ranks`), and each phase
              holds its own. Two ranks on one card through gloo
              stage every collective through the host: not a multi-card
              figure
  17. pipeline  pipeline-parallel training (train/pipeline.py) and
              tile-sharded eval on CABiNet-Large, 19 classes, 1024^2, both
              stages on the card: (a) one window (M=2, microbatch 2, f32,
              TF32 off) against make_train_step(accum_steps=2) on the same
              weights and microbatches (the loss within 1e-5, weights, BN
              statistics and EMA within phase 8's bound, no K1 launched);
              (b) ms per optimizer step (the median of steps 2-4) and peak
              memory, pipeline against fused, bf16, microbatch 4; (c)
              `cli/train.py:main` with runtime.pipeline=2 on phase 9's
              split (bf16, use_pallas, accum 2, one eval scale), 1 epoch
              and a resume, K1 in the evaluations and in no window, and
              evaluate main on its EMA `.pth` (K1-K3); (d)
              `cli/train_yolo.py:main` with +runtime.pipeline=3 on
              yolo26x-sem at imgsz 512, 2 steps; (e) the pipeline main on
              2 gloo ranks sharing the card (runtime.pipeline_dp=2, f32)
              against 1 rank within phase 16's bounds, its evaluations
              tile-sharded; evaluate main on 2 ranks over 2 of phase 7's
              frames (bf16, six scales with flip, one tile a forward)
              tile-sharded, frame-sharded (runtime.tile_parallel_eval=
              false) and frame-sharded with int8 PTQ, each against 1 rank:
              equal but for near ties, the route read from the
              collectives, each rank's K1-K3 launches its own tiles or
              frames, the split's s a frame and the collectives' host ms,
              and the bytes the tile all-reduce moves a frame at 5 and 19
              classes
  18. tp     tensor parallelism (models/tensor_parallel.py) on
              CABiNet-Large, 19 classes, phase 9's split, global batch 4,
              f32 with TF32 off, gloo ranks sharing the card: (a)
              `cli/train.py:main` with runtime.model_axis=2 on 2 ranks
              (data 1 x model 2), 2 epochs of 2 steps, against phase 16's
              R=1 run within its bounds, the weights and EMA read whole
              from the `.pth` files, the model ranks' replicated leaves
              bit-equal, K1 in the evaluations (each rank R=1's count,
              `tp_k1_launches`) and in no step; (b) 4 ranks, data 2 x
              model 2, one epoch, against
              phase 16's R=1 run after its first epoch; (c)
              runtime.pipeline=2 +runtime.pipeline_tp=2
              +runtime.eval_model_axis=2 on 2 ranks, one window, against
              phase 17's R=1 pipeline run after its first window; (d)
              `cli/evaluate.py:main` on (a)'s EMA `.pth` (bf16, use_pallas:
              K1-K3); each part's step ms, its collectives' host ms and
              calls by tag, and each rank's peak memory against R=1's
  19. no process left: the process loader's forkserver and resource
      tracker stopped and reaped, and no process this run started (a
      child, or any process carrying the run's mark in its environment)
      still there
  20. a {"kernels": [...]} line, then the {"ok": true, ...} line.

`python3 chip_smoke.py --rank-main MODULE OUT ARGV...` is one rank of
phases 16-18 (torchrun starts it): `cabinet_tpu_torch.cli.MODULE.main(
ARGV)` with its steps (or pipeline windows) timed, its launches counted,
its peak memory read, and its weights (a train main's; also those after
its SNAPSHOT_STEP-th step) or its confusion matrix (an evaluate main's)
written to OUT.

The packages the port may lack on the card's machine (yaml, PIL, cv2,
torchvision, rich, tqdm) are listed first; the port needs none of them.

Any failure exits non-zero before the last line. Without a CUDA device, or
without the package beside this file, it exits non-zero and prints no
result. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
RUN_MARK = "CHIP_SMOKE_RUN"  # in the environment of every process the run starts
FIXTURE = ROOT / "tests" / "fixtures" / "miou_large_cabinet_v1.npz"
REF_OUTPUTS = FIXTURE.with_name("miou_ref_outputs_large_v1.npz")

# Palette task of the trained fixture (5 classes), copied from the fixture's
# generator so this script needs nothing under tests/ but the fixtures.
PALETTE = [[220, 40, 40], [40, 220, 40], [40, 40, 220], [220, 220, 40],
           [140, 40, 220]]

# Dense peak rates of the cards this script has run on (NVIDIA data sheet):
# bf16 tensor FLOP/s, f32 FLOP/s outside the tensor cores (SIMT) and memory
# bytes/s, by a fragment of the card's name.
PEAKS = [("H100 80GB HBM3", 989e12, 67e12, 3.35e12)]  # H100 SXM

# Stated bounds, max abs error against max|plain| (bf16 step: 2^-8 of a
# value, at most 2^-7 of the largest one).
#  K1/K2 outputs are one bf16 rounding of f32 values that differ only in
#  summation order (and, in K1, P kept as bf16 hi+lo, ~2^-17): 2^-7.
#  K2 sums are f32 sums of <=64x384 products in another order: 1e-4.
#  K3 rounds twice (relu output, logits): 2^-6.
#  The whole forward carries those differences through the branches and
#  the upsampling, rounding in bf16 at every layer: 2^-5.
BOUND_K1 = 2 ** -7
BOUND_K2 = 2 ** -7
BOUND_K2_SUMS = 1e-4
BOUND_K3 = 2 ** -6
BOUND_FORWARD = 2 ** -5
#  The f32 K1 and f32 K4 planes: f32 sums in another order (over N=1024
#  keys; over 27, 9 and 16 terms): 1e-5. bf16 K4 planes: one rounding.
BOUND_F32 = 1e-5
BOUND_K4_BF16 = 2 ** -7
#  An f32 forward carries f32 reorderings through ~60 layers: 1e-4.
BOUND_FORWARD_F32 = 1e-4
# The reference's protocol for the cached confusion matrices, and its gates
# (tests/parity/test_miou_at_scale_large.py, tests/parity/miou_fixture.py).
EVAL_SCALES, EVAL_CROP, TIE_EPS = (0.75, 1.25), 256, 1e-5
# The perturbed attention must move the logits by this many logit bounds,
# so that a K1 returning zeros cannot pass phase 5.
ATTENTION_SHIFT_MIN = 4


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


STARTED = time.perf_counter()


def say(phase: str, **fields) -> None:
    """One line of results, `at_s` the seconds since the script started."""
    fields["at_s"] = round(time.perf_counter() - STARTED, 1)
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call from CUDA events around `iters` back-to-back calls:
    the card's time, or the host's where launching takes longer (a wrapper's
    checks and allocations, a forward's ~300 launches)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, warmup: int = 3, replays: int = 5) -> float:
    """Mean device ms per call: `iters` calls captured in one CUDA graph and
    timed by CUDA events over `replays` replays, so the host's cost of
    launching (the wrapper's checks, ctypes, allocation) is not counted."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def timings(kernel, plain, library, iters: int = 20) -> dict:
    """The wrapper's, the plain version's and the library call's times,
    back to back (`ms`, ...) and replayed from a CUDA graph
    (`device_ms`, ...)."""
    out = {}
    for prefix, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        out[f"{prefix}ms"] = time_ms(fn, iters)
        out[f"{prefix}device_ms"] = graph_ms(fn, iters)
    return out


def max_err(got, ref):
    """(max abs error, max |ref|) in f32."""
    return (float((got.float() - ref.float()).abs().max()),
            float(ref.float().abs().max()))


def _kernel_of(line: str) -> str:
    """The `..._kernel` name inside a mangled name on a ptxas line, or "":
    the last length-prefixed identifier that ends so."""
    names = [m.group(2)[:int(m.group(1))]
             for m in re.finditer(r"(?=(\d+)([A-Za-z_]\w*))", line)]
    return next((n for n in reversed(names) if n.endswith("_kernel")), "")


def ptxas_report():
    """ptxas' registers, spills and wgmma notes for each kernel, from the
    build logs, as "source/kernel: line"."""
    from cabinet_tpu_torch.ops import _build

    out = []
    for src in _build.SOURCES:
        log = _build.BUILD_DIR / f"{src}.log"
        kernel = ""
        for ln in log.read_text().splitlines() if log.exists() else ():
            if "Compiling entry function" in ln:
                kernel = _kernel_of(ln)
            elif "registers" in ln or "spill" in ln or "wgmma" in ln:
                out.append(f"{src}/{kernel}: {ln.strip()}")
    return out


def sass_report():
    """For each kernel of the built libraries, from `cuobjdump -sass`: its
    FFMAs by where their second source comes from (a constant-bank operand
    c[..], a uniform register UR, a register), and its ULDC, LDS and HMMA
    (tensor-core) instructions, as "source/kernel#instance: counts"."""
    import shutil

    from cabinet_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.is_file() and shutil.which("cuobjdump") is None:
        return ["cuobjdump not found"]
    out = []
    for src in _build.SOURCES:
        sass = subprocess.run([str(tool) if tool.is_file() else "cuobjdump", "-sass",
                               str(_build.library_path(src))],
                              capture_output=True, text=True).stdout
        seen = {}
        for block in sass.split("Function : ")[1:]:
            name = _kernel_of(block.split(None, 1)[0])
            seen[name] = seen.get(name, -1) + 1
            ffma = [ln for ln in block.splitlines() if " FFMA" in ln]
            count = {
                "FFMA": len(ffma),
                "FFMA_c": sum("c[0x" in ln for ln in ffma),
                "FFMA_UR": sum(re.search(r"\bUR\d", ln) is not None for ln in ffma),
                **{op: sum(f" {op}" in ln for ln in block.splitlines())
                   for op in ("ULDC", "LDS", "HMMA")}}
            out.append(f"{src}/{name}#{seen[name]}: "
                       + " ".join(f"{k}={v}" for k, v in count.items()))
    return out


class Peaks:
    def __init__(self, name: str):
        for frag, flops, flops_f32, bw in PEAKS:
            if frag in name:
                self.flops, self.flops_f32, self.bw = flops, flops_f32, bw
                return
        raise SmokeFailure(f"no peak rates known for card {name!r}")

    def bound(self, n_bytes: float, tensor_flops: float = 0.0, f32_flops: float = 0.0):
        """(bound ms, what bounds it): the largest of bytes over the memory
        rate, bf16 operations over the tensor cores' rate and f32 FMAs over
        the CUDA cores' rate (the two units run side by side)."""
        t_mem = n_bytes / self.bw
        t_ops = max(tensor_flops / self.flops, f32_flops / self.flops_f32)
        return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def add_rate(row, flops: float) -> None:
    """The kernel's TFLOP/s and its time over its bound, into `row`."""
    row["tflops"] = flops / (row["ms"] * 1e9)
    row["ms_over_bound"] = row["ms"] / row["bound_ms"]


def check_attention(torch, peaks, B, N=1024, D=128, gen=None):
    """The bf16 K1 against its plain version; `splits` is how many key
    ranges the kernel splits each query tile into on this card."""
    import torch.nn.functional as F

    from cabinet_tpu_torch.ops.attention import (
        fused_global_attention,
        global_attention_plain,
        key_splits,
    )

    q, k, v = (torch.randn(B, N, D, generator=gen, device=DEVICE).to(torch.bfloat16)
               for _ in range(3))
    got = fused_global_attention(q, k, v)
    torch.cuda.synchronize()
    ref = global_attention_plain(q, k, v)
    err, top = max_err(got, ref)
    bound = BOUND_K1 * top
    row = {
        "shape": f"B={B} N={N} K=V={D}", "max_abs_err": err, "bound": bound,
        "splits": key_splits(B, N, torch.cuda.get_device_properties(0).multi_processor_count),
        **timings(lambda: fused_global_attention(q, k, v),
                  lambda: global_attention_plain(q, k, v),
                  lambda: F.scaled_dot_product_attention(q, k, v)),
    }
    flops = 2 * B * N * N * 2 * D
    row["bound_ms"], row["bound_by"] = peaks.bound(B * N * 4 * D * 2, flops)
    add_rate(row, flops)
    say("kernels", name="attention", **row)
    check(err <= bound, f"attention B={B}: max err {err} > bound {bound}")
    return row


def check_attention_f32(torch, peaks, B, N=1024, D=128, gen=None):
    """The f32 K1 against its plain version (f32, TF32 off)."""
    import torch.nn.functional as F

    from cabinet_tpu_torch.ops.attention import (
        fused_global_attention,
        global_attention_plain,
    )

    q, k, v = (torch.randn(B, N, D, generator=gen, device=DEVICE) for _ in range(3))
    got = fused_global_attention(q, k, v)
    torch.cuda.synchronize()
    check(got.dtype == torch.float32, f"f32 attention returned {got.dtype}")
    err, top = max_err(got, global_attention_plain(q, k, v))
    bound = BOUND_F32 * top
    row = {
        "shape": f"B={B} N={N} K=V={D} f32", "max_abs_err": err, "bound": bound,
        **timings(lambda: fused_global_attention(q, k, v),
                  lambda: global_attention_plain(q, k, v),
                  lambda: F.scaled_dot_product_attention(q, k, v), iters=10),
    }
    row["bound_ms"], row["bound_by"] = peaks.bound(
        B * N * 4 * D * 4, f32_flops=2 * B * N * N * 2 * D)
    say("kernels", name="attention_f32", **row)
    check(err <= bound, f"attention_f32 B={B}: max err {err} > bound {bound}")
    return row


def stem_weights(torch, gen):
    """K4's folded f32 weights (wstem, bstem, wdw, bdw, wpw, bpw), drawn at
    the scales of the unit tests."""
    def rnd(*s, std):
        return torch.randn(*s, generator=gen, device=DEVICE) * std

    return (rnd(16, 27, std=0.2), rnd(16, std=0.1), rnd(3, 3, 16, std=0.2),
            rnd(16, std=0.1), rnd(16, 16, std=0.2), rnd(16, std=0.1))


def check_stem_block0(torch, peaks, shape, dtype, gen):
    """K4 against its plain version on x of `dtype` with planes of `dtype`,
    the weights packed once as `models/fused.py` holds them; the library
    call is cuDNN's conv chain in the same dtype. The bound prices the
    stem's multiply-adds as the kernel does them, each f32 weight as three
    bf16 parts on the tensor cores, and the depthwise and pointwise as f32
    FMAs."""
    import torch.nn.functional as F

    from cabinet_tpu_torch.models.layers import hard_swish
    from cabinet_tpu_torch.ops import early_stage as es

    w = es.pack_stem_block0_weights(*stem_weights(torch, gen))
    x = torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)
    got = es.fused_stem_block0(x, *w, out_dtype=dtype)
    torch.cuda.synchronize()
    err, top = max_err(got, es.stem_block0_plain(x, *w, out_dtype=dtype))
    bound = (BOUND_F32 if dtype == torch.float32 else BOUND_K4_BF16) * top

    x_cl = x.permute(0, 3, 1, 2)  # channels_last view, no copy
    ws = w[0].reshape(16, 3, 3, 3).to(dtype).contiguous(memory_format=torch.channels_last)
    wd = w[2].permute(2, 0, 1)[:, None].to(dtype).contiguous()
    wp = w[4][:, :, None, None].to(dtype).contiguous(memory_format=torch.channels_last)
    bs, bd, bp = (t.to(dtype) for t in (w[1], w[3], w[5]))

    def lib_k4():
        stem = hard_swish(F.conv2d(x_cl, ws, bs, stride=2, padding=1))
        dw = torch.relu(F.conv2d(stem, wd, bd, padding=1, groups=16))
        return F.conv2d(dw, wp, bp) + stem

    B, H, W, _ = shape
    n_out = B * (H // 2) * (W // 2)
    row = {"shape": f"{tuple(shape)} {str(dtype)[6:]}", "max_abs_err": err,
           "bound": bound,
           **timings(lambda: es.fused_stem_block0(x, *w, out_dtype=dtype),
                     lambda: es.stem_block0_plain(x, *w, out_dtype=dtype),
                     lib_k4, iters=10)}
    row["bound_ms"], row["bound_by"] = peaks.bound(
        x.numel() * x.element_size() + 16 * n_out * got.element_size() + 880 * 4,
        tensor_flops=3 * 2 * n_out * 16 * 27, f32_flops=2 * n_out * (16 * 9 + 16 * 16))
    say("kernels", name="stem_block0", **row)
    check(err <= bound, f"stem_block0 {shape} {dtype}: max err {err} > bound {bound}")
    return row


def tail_operands(torch, S, n_classes, B, gen):
    """Folded-weight operands of K2/K3 with the FFM/head's real widths."""
    import torch.nn.functional as F

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device=DEVICE) * std

    bf = torch.bfloat16
    n_pad = -(-n_classes // 16) * 16
    return {
        "fsp": torch.relu(rnd(B, S, S, 128)).to(bf),
        "fcp": rnd(B, S, S, 256).to(bf),
        "w1_sp": rnd(128, 256, std=384 ** -0.5).to(bf),
        "w1_cp": rnd(256, 256, std=384 ** -0.5).to(bf),
        "b1": rnd(256, std=0.1),
        "w_se1": rnd(256, 64, std=256 ** -0.5),
        "w_se2": rnd(64, 256, std=64 ** -0.5),
        "w3": rnd(9, 256, 256, std=2304 ** -0.5).to(bf),
        "b3": rnd(256, std=0.1),
        "wc": F.pad(rnd(256, n_classes, std=256 ** -0.5), (0, n_pad - n_classes)).to(bf),
        "n_classes": n_classes,
    }


def check_tail(torch, peaks, S, n_classes, B, gen):
    import torch.nn.functional as F

    from cabinet_tpu_torch.ops import decoder_tail as dt

    o = tail_operands(torch, S, n_classes, B, gen)
    k2_args = (o["fsp"], o["fcp"], o["w1_sp"], o["w1_cp"], o["b1"])
    feat, sums = dt.ffm_pointwise(*k2_args)
    torch.cuda.synchronize()
    feat_ref, sums_ref = dt.ffm_pointwise_plain(*k2_args)
    err2, top2 = max_err(feat, feat_ref)
    err_s, top_s = max_err(sums, sums_ref)
    scale = dt.se_scale(sums_ref, S * S, o["w_se1"], o["w_se2"])
    k3_args = (feat_ref, scale, o["w3"], o["b3"], o["wc"], n_classes)
    logits = dt.head_conv3x3(*k3_args)
    torch.cuda.synchronize()
    err3, top3 = max_err(logits, dt.head_conv3x3_plain(*k3_args))
    shape = f"B={B} S={S} n_classes={n_classes}"

    fcat = torch.cat([o["fsp"], o["fcp"]], -1).reshape(-1, 384)
    w1 = torch.cat([o["w1_sp"], o["w1_cp"]], 0)
    x_cl = feat_ref.permute(0, 3, 1, 2)  # channels_last view, no copy
    w3_oihw = o["w3"].reshape(3, 3, 256, 256).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    wc = o["wc"][:, :n_classes]

    def lib_k3():
        y = F.conv2d(x_cl, w3_oihw, padding=1)
        return torch.matmul(y.permute(0, 2, 3, 1), wc)

    P = B * S * S
    k2 = {"shape": shape, "max_abs_err": err2, "bound": BOUND_K2 * top2,
          "sums_err": err_s, "sums_bound": BOUND_K2_SUMS * top_s,
          **timings(lambda: dt.ffm_pointwise(*k2_args),
                    lambda: dt.ffm_pointwise_plain(*k2_args),
                    lambda: torch.matmul(fcat, w1))}
    k2_flops = 2 * P * 384 * 256
    k2["bound_ms"], k2["bound_by"] = peaks.bound(
        P * (128 + 256 + 256) * 2 + sums.numel() * 4 + (384 * 256) * 2 + 256 * 4,
        k2_flops)
    add_rate(k2, k2_flops)
    k3 = {"shape": shape, "max_abs_err": err3, "bound": BOUND_K3 * top3,
          **timings(lambda: dt.head_conv3x3(*k3_args),
                    lambda: dt.head_conv3x3_plain(*k3_args), lib_k3)}
    k3_flops = 2 * P * 256 * (9 * 256 + n_classes)
    k3["bound_ms"], k3["bound_by"] = peaks.bound(
        P * (256 + n_classes) * 2 + B * 256 * 4 + (9 * 256 * 256 + 256 * n_classes) * 2
        + 256 * 4, k3_flops)
    add_rate(k3, k3_flops)
    say("kernels", name="ffm_pointwise", **k2)
    say("kernels", name="head_conv3x3", **k3)
    check(err2 <= k2["bound"], f"ffm_pointwise {shape}: feat err {err2} > {k2['bound']}")
    check(err_s <= k2["sums_bound"],
          f"ffm_pointwise {shape}: sums err {err_s} > {k2['sums_bound']}")
    check(err3 <= k3["bound"], f"head_conv3x3 {shape}: err {err3} > {k3['bound']}")
    return k2, k3


# ---------------------------------------------------------------------------
# Phase 4/5: the main path
# ---------------------------------------------------------------------------


def _counters():
    """{kernel name: (wrapper, attribute of its launch count)}."""
    from cabinet_tpu_torch.ops.attention import fused_global_attention
    from cabinet_tpu_torch.ops.decoder_tail import ffm_pointwise, head_conv3x3
    from cabinet_tpu_torch.ops.early_stage import fused_stem_block0

    return {"attention": (fused_global_attention, "launches"),
            "attention_f32": (fused_global_attention, "launches_f32"),
            "ffm_pointwise": (ffm_pointwise, "launches"),
            "head_conv3x3": (head_conv3x3, "launches"),
            "stem_block0": (fused_stem_block0, "launches")}


def kernel_counts():
    return {name: getattr(fn, attr) for name, (fn, attr) in _counters().items()}


def reset_counts() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


TAIL = ("attention", "ffm_pointwise", "head_conv3x3")


def launched_each(fn, expect=TAIL, absent=()):
    """Run fn(); fail unless each kernel of `expect` launched during it and
    none of `absent` did."""
    before = kernel_counts()
    out = fn()
    after = kernel_counts()
    missing = [k for k in expect if after[k] <= before[k]]
    check(not missing, f"forward did not launch {missing}")
    extra = [k for k in absent if after[k] > before[k]]
    check(not extra, f"forward launched {extra}")
    return out


class MainPaths:
    """Drives each main path with the launch counts set to 0 just before it
    and read just after; `totals` sums the launches over the paths."""

    def __init__(self):
        self.totals = dict.fromkeys(_counters(), 0)
        self.per_path = {}
        self.kept = {}  # runs a later phase is held against, by name

    def drive(self, name, fn, *args):
        reset_counts()
        out = fn(*args)
        self._add(name, kernel_counts())
        return out

    def record(self, name, ranks):
        """A path driven in other processes (ranks under torchrun), each
        counting from 0 at its start and reporting its counts at its end:
        the sum over the ranks."""
        self._add(name, {k: sum(r["launches"][k] for r in ranks) for k in self.totals})

    def _add(self, name, counts):
        self.per_path[name] = counts
        for k, n in counts.items():
            self.totals[k] += n
        say("main", path=name, launches=counts)


def fixture_model(torch, attention: str = "kernel", gamma=None, seed: int = 0):
    """The trained fixture; with `gamma`, its zero gamma set to it and its
    zero project_out drawn from N(0, 0.5^2)."""
    import numpy as np

    from cabinet_tpu_torch.models.cabinet import CABiNet
    from cabinet_tpu_torch.utils.convert import state_dict_from_jax

    model = CABiNet(5, "large", attention=attention)
    with np.load(FIXTURE) as data:
        sd = state_dict_from_jax({k: data[k] for k in data.files}, model.cfgs)
    if gamma is not None:
        check(float(sd["ab.a2block.gamma"][0]) == 0.0, "fixture gamma is not zero")
        g = torch.Generator().manual_seed(seed)
        key = "ab.a2block.global_attn.project_out.weight"
        sd["ab.a2block.gamma"] = torch.tensor([float(gamma)])
        sd[key] = torch.randn(sd[key].shape, generator=g) * 0.5
    model.load_state_dict(sd, strict=True)
    return model


def palette_images(torch, size: int):
    """One single-class palette image per class, unnormalised, noise 0.02
    from default_rng(99), as the fixture's confidence gate builds them."""
    import numpy as np

    rng = np.random.default_rng(99)
    pal = np.asarray(PALETTE, np.float32) / 255.0
    imgs = np.stack([(pal[np.full((size, size), c)]
                      + rng.normal(0, 0.02, (size, size, 3))).astype(np.float32)
                     for c in range(len(PALETTE))])
    return torch.from_numpy(imgs)


def run_fixture(torch, size: int):
    """The fused forward on the trained fixture: each class on >=99.9%."""
    from cabinet_tpu_torch.models.fused import make_fused_tail_apply

    fwd = make_fused_tail_apply(fixture_model(torch), DEVICE, torch.bfloat16)
    images = palette_images(torch, size)
    shares = []
    for c in range(len(PALETTE)):
        final, _ = launched_each(lambda: fwd(images[c:c + 1]))
        check(tuple(final.shape) == (1, size, size, 5), f"logits {tuple(final.shape)}")
        check(bool(torch.isfinite(final.float()).all()), "non-finite logits")
        shares.append(float((final[0].argmax(-1) == c).float().mean()))
    say("main", part="fixture", size=size, class_shares=shares)
    check(min(shares) >= 0.999, f"fixture class shares {shares} below 0.999")


def seeded_uavid_checkpoint(torch, path: Path, seed: int = 0):
    from cabinet_tpu_torch.models.cabinet import CABiNet

    torch.manual_seed(seed)
    model = CABiNet(8, "large")
    with torch.no_grad():
        model.ab.a2block.gamma.fill_(0.5)
        torch.nn.init.normal_(model.ab.a2block.global_attn.project_out.weight, 0, 0.05)
    torch.save(model.state_dict(), path)


def plain_forward(torch, ckpt: Path, route: str, dtype):
    """The plain path a Segmenter route is held against: the same forward
    on a model built with attention="plain" and the plain versions of the
    tail and of K4."""
    from cabinet_tpu_torch.cli.infer import load_state_dict
    from cabinet_tpu_torch.models.cabinet import CABiNet
    from cabinet_tpu_torch.models.fused import make_fused_apply, make_fused_tail_apply

    model = CABiNet(8, "large", attention="plain")
    model.load_state_dict(load_state_dict(ckpt, model), strict=True)
    if route == "fused_early":
        return make_fused_apply(model, DEVICE, dtype, kernels=False)
    return make_fused_tail_apply(model, DEVICE, dtype, kernels=False,
                                 use_early=route == "fused_tail_early")


def run_segmenter(torch, size: int, ckpt: Path, rgbs, dtype_name: str,
                  batch: int, route: str, expect, absent, bound: float,
                  min_agree: float, n_requests: int = 3):
    """Segmenter at one batch (1: predict, else predict_batch) on `route`,
    every request launching the kernels of `expect` and none of `absent`,
    each mask held against the plain path's argmax: on at least
    `min_agree` of the pixels, and on every pixel whose plain-path margin
    exceeds twice the forward's logit bound (`bound` of max|logit|).
    Returns (engine, its normalised inputs)."""
    from cabinet_tpu_torch.cli.infer import Segmenter

    seg = Segmenter(str(ckpt), "uavid", mode="large", imgsz=size,
                    dtype_name=dtype_name, batch=batch, device=DEVICE)
    check(seg.route == route, f"Segmenter {dtype_name} batch {batch} routes "
          f"{seg.route}, expected {route}")
    plain = plain_forward(torch, ckpt, route, seg.dtype)

    def answer():
        """The requests and the wall ms per image (host clock; the masks
        come back to the host, which syncs)."""
        t0 = time.perf_counter()
        if batch == 1:
            out = [launched_each(lambda: seg.predict(r), expect, absent)
                   for r in rgbs[:n_requests]]
        else:
            out = launched_each(lambda: seg.predict_batch(rgbs[:batch]),
                                expect, absent)
        return out, (time.perf_counter() - t0) * 1e3 / len(out)

    masks, wall_ms = answer()      # first calls: lazy loads, allocations
    _, warm_ms = answer()          # the same requests again
    agree, sure_agree = [], []
    for rgb, mask in zip(rgbs, masks):
        check(mask.shape == (size, size), f"mask shape {mask.shape}")
        logits = plain(seg._preprocess(rgb)[None])[0][0].float()
        top2 = logits.topk(2, dim=-1).values
        # pixels whose plain-path margin exceeds twice the forward's
        # logit bound cannot flip between the two paths
        sure = ((top2[..., 0] - top2[..., 1])
                > 2 * bound * float(logits.abs().max())).cpu().numpy()
        same = mask == logits.argmax(-1).cpu().numpy()
        agree.append(float(same.mean()))
        sure_agree.append(float(same[sure].mean()))
    say("main", part="segmenter", dtype=dtype_name, batch=batch, route=route,
        requests=len(masks), wall_ms_per_img_first_calls=wall_ms,
        wall_ms_per_img_warm=warm_ms, argmax_agreement=agree,
        agreement_beyond_bound=sure_agree)
    check(min(sure_agree) == 1.0 and min(agree) >= min_agree,
          f"segmenter {dtype_name} batch {batch}: agreement {agree}, "
          f"beyond the bound {sure_agree}")
    return seg, torch.stack([seg._preprocess(r) for r in rgbs[:batch]])


def time_early_stage(torch, ckpt: Path, size: int, rounds: int = 5):
    """bf16 fused-tail forward ms/img with stem and block_0 through K4
    (use_early) and through the plain modules, at batch 1 and 8, timed in
    turns within this call: `rounds` of (without, with, with, without), so
    10 pairs of one timing each, back to back (`ms`, the host included) and
    replayed from a CUDA graph (`device_ms`, the device alone). Per batch
    and timer: each side's median, and in how many pairs the forward with
    K4 was the faster."""
    import statistics

    from cabinet_tpu_torch.cli.infer import load_state_dict
    from cabinet_tpu_torch.models.cabinet import CABiNet
    from cabinet_tpu_torch.models.fused import make_fused_tail_apply

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    x = torch.randn(8, size, size, 3, generator=gen, device=DEVICE).to(torch.bfloat16)
    fwds = {}
    for use_early in (False, True):
        model = CABiNet(8, "large", attention="kernel")
        model.load_state_dict(load_state_dict(ckpt, model), strict=True)
        fwds[use_early] = make_fused_tail_apply(model, DEVICE, torch.bfloat16,
                                                use_early=use_early)
    out = {}
    for b in (1, 8):
        ms = {(t, k4): [] for t in ("ms", "device_ms") for k4 in (False, True)}
        for _ in range(rounds):
            for use_early in (False, True, True, False):
                fn = lambda: fwds[use_early](x[:b])  # noqa: E731
                ms["ms", use_early].append(time_ms(fn, iters=10) / b)
                ms["device_ms", use_early].append(
                    graph_ms(fn, iters=3, warmup=1, replays=3) / b)
        out[b] = {}
        for t in ("ms", "device_ms"):
            without, with_k4 = ms[t, False], ms[t, True]
            out[b][t] = {"without_k4": without, "with_k4": with_k4,
                         "median_without_k4": statistics.median(without),
                         "median_with_k4": statistics.median(with_k4),
                         "pairs_k4_faster": sum(w < o for w, o in zip(with_k4, without)),
                         "pairs": len(with_k4)}
            say("main", part="forward_ms_per_img_k4_on_off_in_turns", batch=b,
                timer=t, **out[b][t])
    return out


def run_attention_forward(torch, size: int):
    """Perturbed attention: kernel path against plain path at full size,
    and the plain path with gamma 0 to show the attention's share of the
    logits is well above the bound the two paths are held to."""
    from cabinet_tpu_torch.models.fused import make_fused_tail_apply

    def forward(attention, gamma):
        return make_fused_tail_apply(fixture_model(torch, attention, gamma),
                                     DEVICE, torch.bfloat16,
                                     kernels=attention == "kernel")

    images = palette_images(torch, size)[:2]
    got, _ = launched_each(lambda: forward("kernel", 1.0)(images))
    ref, _ = forward("plain", 1.0)(images)
    no_attn, _ = forward("plain", 0.0)(images)
    err, top = max_err(got, ref)
    shift, _ = max_err(no_attn, ref)
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    bound = BOUND_FORWARD * top
    say("attn", size=size, max_logit_err=err, bound=bound, argmax_agreement=agree,
        attention_shift=shift, shift_over_bound=shift / bound)
    check(err <= bound, f"perturbed-attention forward: err {err} > {bound}")
    check(agree >= 0.999, f"perturbed-attention argmax agreement {agree}")
    check(shift >= ATTENTION_SHIFT_MIN * bound,
          f"the attention moves the logits by {shift}, under "
          f"{ATTENTION_SHIFT_MIN} x the bound {bound}")


# ---------------------------------------------------------------------------
# Phase 6: the eval protocol
# ---------------------------------------------------------------------------


def synthetic_palette(np, rng, h: int, w: int, block: int):
    """Blocky label map and its palette rendering with noise 0.02, as the
    fixture tests' `synthetic` draws them (square when h == w)."""
    pal = np.asarray(PALETTE, np.float32) / 255.0
    labels = np.kron(rng.integers(0, len(PALETTE), (h // block, w // block)),
                     np.ones((block, block), np.int64))
    image = pal[labels] + rng.normal(0, 0.02, (*labels.shape, 3))
    return image.astype(np.float32), labels


def ties_hist(np, probs, labels):
    """(near-tie pixels, confusion matrix rows=pred cols=label) of summed
    probabilities, as tests/parity/miou_fixture.py:probs_ties_hist."""
    top2 = np.partition(probs, -2, axis=-1)
    ties = int(((top2[..., -1] - top2[..., -2]) < TIE_EPS).sum())
    valid = labels != 255
    n = len(PALETTE)
    idx = probs.argmax(-1)[valid] * n + labels[valid]
    return ties, np.bincount(idx, minlength=n * n).reshape(n, n).astype(np.float64)


def run_eval_reference(torch):
    """The trained fixture in f32 through MscEval with the f32 K1 (TF32
    off), against the reference engine's confusion matrices cached for
    these weights and this protocol, under its gates."""
    import hashlib

    import numpy as np

    from cabinet_tpu_torch.cli.evaluate import make_eval_forward
    from cabinet_tpu_torch.eval.evaluator import MscEval
    from cabinet_tpu_torch.eval.metrics import metrics_from_hist

    pal = np.asarray(PALETTE, np.float32) / 255.0
    protocol = json.dumps({
        "scales": EVAL_SCALES, "cropsize": EVAL_CROP, "n_classes": len(PALETTE),
        "palette": pal.tolist(), "rng": 13, "ignore_rows": 32,
        "multi_block": 64, "mode": "large"}, sort_keys=True)
    with np.load(REF_OUTPUTS) as data:
        ref = {k: data[k] for k in data.files}
    sha = hashlib.sha256(FIXTURE.read_bytes() + protocol.encode()).hexdigest()
    check(str(ref["weights_sha"]) == sha,
          "the cached reference outputs are not for these weights and protocol")

    fwd = make_eval_forward(fixture_model(torch), EVAL_CROP, DEVICE,
                            torch.float32, use_pallas=True)
    check(fwd.route == "model", f"f32 eval forward route {fwd.route}")
    ev = MscEval(fwd, len(PALETTE), ignore_label=255, scales=EVAL_SCALES,
                 flip=True, cropsize=EVAL_CROP, compute_dtype=torch.float32,
                 device=DEVICE)
    f32_only = dict(expect=("attention_f32",),
                    absent=("attention", "ffm_pointwise", "head_conv3x3", "stem_block0"))

    rng = np.random.default_rng(13)
    lbl = np.zeros((512, 512), np.int64)
    img = (pal[lbl] + rng.normal(0, 0.02, (512, 512, 3))).astype(np.float32)
    lbl[:32] = 255
    probs = launched_each(lambda: ev.prob_batch(None, img[None]), **f32_only)
    ties, hist = ties_hist(np, probs, lbl[None])
    c0_diff = float(np.abs(hist - ref["c0_hist"]).sum() / 2)

    image, mlbl = synthetic_palette(np, rng, 512, 512, 64)
    mlbl[:32] = 255
    probs = launched_each(lambda: ev.prob_batch(None, image[None]), **f32_only)
    _, mhist = ties_hist(np, probs, mlbl[None])
    miou = metrics_from_hist(mhist)["mIoU"]
    m_diff = float(np.abs(mhist - ref["multi_hist"]).sum() / 2)
    say("eval", part="f32_reference", c0_disagree=c0_diff, c0_near_ties=ties,
        multi_disagree=m_diff, multi_pixels=float(mhist.sum()), mIoU=miou,
        ref_mIoU=float(ref["multi_miou"]))
    check(ties < 1e-3 * img.shape[0] * img.shape[1],
          f"{ties} near-tie pixels on the single-class image")
    check(c0_diff <= ties, f"single-class image: {c0_diff} pixels disagree, "
          f"{ties} near ties")
    check(hist[0, 0] > 0.95 * (512 - 32) * 512, f"single-class hist {hist[0, 0]}")
    check(m_diff <= 1e-3 * mhist.sum(), f"multi-class: {m_diff} pixels disagree")
    check(abs(miou - float(ref["multi_miou"])) < 5e-3 and miou > 0.9,
          f"multi-class mIoU {miou} against {float(ref['multi_miou'])}")


def run_eval_kernels(torch, h: int = 1024, w: int = 2048, crop: int = 1024):
    """bf16 MscEval through make_eval_forward(fused_tail="true",
    use_pallas=True) on an h x w palette image, scales (0.75, 1.0, 1.25),
    flip, crop `crop`, against the same protocol on the plain path.
    Returns seconds per image (warm, host clock around a synced call)."""
    import numpy as np

    from cabinet_tpu_torch.cli.evaluate import make_eval_forward
    from cabinet_tpu_torch.eval.evaluator import MscEval
    from cabinet_tpu_torch.eval.metrics import metrics_from_hist
    from cabinet_tpu_torch.models.fused import make_fused_tail_apply

    image, labels = synthetic_palette(np, np.random.default_rng(21), h, w, crop // 8)
    image, labels = image[None], labels[None]
    protocol = dict(n_classes=len(PALETTE), ignore_label=255,
                    scales=(0.75, 1.0, 1.25), flip=True, cropsize=crop,
                    compute_dtype=torch.bfloat16, device=DEVICE)
    fwd = make_eval_forward(fixture_model(torch, "plain"), crop, DEVICE,
                            torch.bfloat16, use_pallas=True, fused_tail="true")
    ev = MscEval(fwd, **protocol)
    launched_each(lambda: ev.evaluate_batch(None, image, labels), absent=(
        "attention_f32", "stem_block0"))
    t0 = time.perf_counter()
    preds, hist = ev.evaluate_batch(None, image, labels)
    seconds = time.perf_counter() - t0

    plain = make_fused_tail_apply(fixture_model(torch, "plain"), DEVICE,
                                  torch.bfloat16, kernels=False)
    ref_preds, ref_hist = MscEval(lambda v, x: plain(x), **protocol
                                  ).evaluate_batch(None, image, labels)
    agree = float((preds == ref_preds).mean())
    miou, ref_miou = (metrics_from_hist(h)["mIoU"] for h in (hist, ref_hist))
    say("eval", part="bf16_kernels", image=f"{h}x{w}", seconds_per_img=seconds,
        argmax_agreement=agree, mIoU=miou, plain_mIoU=ref_miou)
    check(agree >= 0.999, f"bf16 eval argmax agreement {agree}")
    check(abs(miou - ref_miou) < 5e-3, f"bf16 eval mIoU {miou} against {ref_miou}")
    return seconds


# ---------------------------------------------------------------------------
# Phase 7: cli/evaluate.py main over a split read from disk
# ---------------------------------------------------------------------------

# Raw Cityscapes ids whose trainIds are 0-4 (road, sidewalk, building, wall,
# fence), and the rows of raw id 0 (unlabeled: the ignore label) on top.
CITY_RAW_IDS = (7, 8, 11, 12, 13)
CITY_IGNORE_ROWS = 64
# Cityscapes' native frame, the crop of configs/dataset/cityscapes.yaml
EVAL_MAIN_FRAMES, FRAME_H, FRAME_W, EVAL_MAIN_CROP = 4, 1024, 2048, 1024


def optional_packages() -> dict:
    """Which of the packages the port does without import here (in a child
    process, so that this one loads none of them)."""
    names = ("yaml", "PIL", "cv2", "torchvision", "rich", "tqdm")
    code = ("import importlib, json\nout = {}\nfor m in %r:\n"
            "    try:\n        importlib.import_module(m)\n        out[m] = True\n"
            "    except Exception:\n        out[m] = False\nprint(json.dumps(out))" % (names,))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    return json.loads(res.stdout.strip().splitlines()[-1])


def thread_pool():
    """Threads, one a core, for the synthetic splits' encoding and checks
    (numpy and zlib leave the GIL for the bulk of a frame). The random
    draws stay on the caller's thread, in order, so that a seed gives the
    frames it always gave."""
    import concurrent.futures

    return concurrent.futures.ThreadPoolExecutor(len(os.sched_getaffinity(0)))


def in_threads(fn, items) -> list:
    """[fn(item) for item in items] on `thread_pool`'s threads."""
    with thread_pool() as pool:
        return list(pool.map(fn, items))


def write_city_split(np, root: Path, n_frames: int, h: int, w: int, seed: int = 31,
                     split: str = "val"):
    """A Cityscapes-layout split of `n_frames` h x w frames:
    leftImg8bit/<split>/<city>/*_leftImg8bit.png and
    gtFine/<split>/<city>/*_gtFine_labelIds.png, written with the port's
    save_png, each frame encoded on a thread (`thread_pool`). Each frame is
    the fixture's palette task
    (`synthetic_palette`, 128-pixel blocks) stored so that Cityscapes'
    normalisation gives back the palette values plus noise; its labels are
    CITY_RAW_IDS, with CITY_IGNORE_ROWS rows of raw id 0 on top."""
    from cabinet_tpu_torch.data.datasets import CityScapes
    from cabinet_tpu_torch.data.decode import save_png

    mean = np.asarray(CityScapes.MEAN, np.float32)
    std = np.asarray(CityScapes.STD, np.float32)
    rng = np.random.default_rng(seed)
    raw_ids = np.asarray(CITY_RAW_IDS, np.uint8)
    for city in ("frankfurt", "lindau", "munster")[:n_frames]:
        (root / "leftImg8bit" / split / city).mkdir(parents=True, exist_ok=True)
        (root / "gtFine" / split / city).mkdir(parents=True, exist_ok=True)

    def frame(i, image, labels):
        city = ("frankfurt", "lindau", "munster")[i % 3]
        u8 = np.clip(np.rint(255.0 * (mean + std * image)), 0, 255).astype(np.uint8)
        raw = raw_ids[labels]
        raw[:CITY_IGNORE_ROWS] = 0
        base = f"{city}_{i:06d}_000019"
        save_png(root / "leftImg8bit" / split / city / f"{base}_leftImg8bit.png", u8,
                 compress_level=1)
        save_png(root / "gtFine" / split / city / f"{base}_gtFine_labelIds.png", raw,
                 compress_level=1)

    with thread_pool() as pool:
        jobs = [pool.submit(frame, i, *synthetic_palette(np, rng, h, w, 128))
                for i in range(n_frames)]
    for job in jobs:
        job.result()


def paeth_png(np, path: Path, rgb) -> None:
    """An 8-bit RGB PNG with every row Paeth-filtered, the filter the
    reader's anti-diagonal sweep pays most for (encoders that pick a filter
    per row, as libpng and PIL do, write many such rows)."""
    import struct
    import zlib

    from cabinet_tpu_torch.data.decode import PNG_SIGNATURE

    h, w, _ = rgb.shape
    r = rgb.reshape(h, -1).astype(np.int16)
    up = np.vstack([np.zeros((1, r.shape[1]), np.int16), r[:-1]])
    left = np.hstack([np.zeros((h, 3), np.int16), r[:, :-3]])
    upleft = np.hstack([np.zeros((h, 3), np.int16), up[:, :-3]])
    pa, pb, pc = (np.abs(up - upleft), np.abs(left - upleft),
                  np.abs(left + up - 2 * upleft))
    pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    rows = np.hstack([np.full((h, 1), 4, np.uint8), ((r - pred) & 255).astype(np.uint8)])

    def chunk(t, payload):
        return (struct.pack(">I", len(payload)) + t + payload
                + struct.pack(">I", zlib.crc32(t + payload)))

    path.write_bytes(PNG_SIGNATURE
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
                     + chunk(b"IEND", b""))


def png_reader_ms(np, root: Path, reps: int = 3) -> dict:
    """The port's PNG reader on the split's first frame and mask (filter 0,
    as save_png writes), and on the same frame Paeth-filtered: mean host ms
    per read over `reps` reads, each checked against the first."""
    from cabinet_tpu_torch.data.decode import open_mask, open_rgb

    img = sorted((root / "leftImg8bit" / "val").rglob("*.png"))[0]
    mask = sorted((root / "gtFine" / "val").rglob("*.png"))[0]
    rgb = open_rgb(img)
    paeth = root / "paeth.png"
    paeth_png(np, paeth, rgb)
    out = {}
    for name, fn, path in (("rgb_frame", open_rgb, img), ("mask", open_mask, mask),
                           ("rgb_frame_paeth", open_rgb, paeth)):
        t0 = time.perf_counter()
        for _ in range(reps):
            got = fn(path)
        out[name] = (time.perf_counter() - t0) * 1e3 / reps
        check(got.shape[:2] == rgb.shape[:2], f"{name}: shape {got.shape}")
    check(np.array_equal(open_rgb(paeth), rgb), "Paeth-filtered frame reads back wrong")
    paeth.unlink()
    return out


def run_main(argv):
    """`cli/evaluate.py:main(argv)` in this process (`run_cli`), its JSON
    line parsed. Returns (result, JSON line, host s)."""
    from cabinet_tpu_torch.cli.evaluate import main as evaluate_main

    res, seconds, lines = run_cli(evaluate_main, argv, "main")
    line = json.loads(lines[-1])
    check(set(line) == {"mIoU", "accuracy", "iou_per_class"}, f"main's JSON line {line}")
    check(line["mIoU"] == res["mIoU"], "main's JSON line is not its result")
    return res, line, seconds


def run_cli(main_fn, argv, tag: str, keep: int = 0):
    """main_fn(argv) in this process with its standard output caught and
    shown with a prefix (so that no line of it looks like this script's
    result lines), the last `keep` lines only when keep > 0. Returns
    (result, host s, the output's lines)."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = main_fn(argv)
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    for ln in lines[-keep:] if keep else lines:
        print(f"  {tag}| {ln}")
    return res, seconds, lines


def plain_eval(torch, dtype, scales, flip, crop):
    """MscEval on the plain path: the fixture with attention="plain" and
    the plain versions of K2 and K3 (bf16), or its modules (float32)."""
    from cabinet_tpu_torch.eval.evaluator import MscEval
    from cabinet_tpu_torch.models.fused import make_fused_tail_apply

    model = fixture_model(torch, "plain")
    if dtype == torch.bfloat16:
        plain = make_fused_tail_apply(model, DEVICE, dtype, kernels=False)

        def fwd(v, x):
            return plain(x)
    else:
        model.to(DEVICE).eval()

        @torch.no_grad()
        def fwd(v, x):
            return tuple(t.permute(0, 2, 3, 1) for t in model(x.permute(0, 3, 1, 2)))
    return MscEval(fwd, len(PALETTE), ignore_label=255, scales=scales, flip=flip,
                   cropsize=crop, compute_dtype=dtype, device=DEVICE)



def run_evaluate_main(torch, paths, tmp: Path, n_frames: int = EVAL_MAIN_FRAMES,
                      h: int = FRAME_H, w: int = FRAME_W, crop: int = EVAL_MAIN_CROP):
    """Phase 7 on `n_frames` h x w frames at `crop` (cityscapes.yaml's own
    at 1024); returns what it measured."""
    import shutil

    import numpy as np

    from cabinet_tpu_torch.cli.common import CONFIG_DIR
    from cabinet_tpu_torch.core.config import load_yaml
    from cabinet_tpu_torch.data.datasets import CityScapes
    from cabinet_tpu_torch.data.loader import DataLoader
    from cabinet_tpu_torch.eval.metrics import metrics_from_hist

    root = tmp / "cityscapes"
    t0 = time.perf_counter()
    write_city_split(np, root, n_frames, h, w)
    say("evaluate_main", part="split", frames=n_frames, size=f"{w}x{h}",
        write_seconds=time.perf_counter() - t0)
    png_ms = png_reader_ms(np, root)
    say("evaluate_main", part="png_reader", ms=png_ms)

    scales = tuple(load_yaml(CONFIG_DIR / "evaluate.yaml")["validation_config"]["eval_scales"])
    common = [f"checkpoint_path={FIXTURE}", "dataset=cityscapes", "dataset.num_classes=5"]
    if crop != max(load_yaml(CONFIG_DIR / "dataset" / "cityscapes.yaml")["cropsize"]):
        common.append(f"dataset.cropsize=[{crop},{crop}]")

    # bf16 on the kernels: K1, K2 and K3 on every tile forward, no K4
    argv = common + [f"dataset.dataset_path={root}", "validation_config.batch_size=2",
                     "runtime.compute_dtype=bfloat16", "runtime.use_pallas=true",
                     "--device", DEVICE]
    res, _, main_s = paths.drive("evaluate_main_bf16", run_main, argv)
    counts = paths.per_path["evaluate_main_bf16"]
    check(all(counts[k] > 0 for k in TAIL), f"evaluate main bf16 launches {counts}")
    check(counts["attention_f32"] == 0 and counts["stem_block0"] == 0,
          f"evaluate main bf16 launched the f32 K1 or K4: {counts}")
    timing = res["timing"]
    check(timing["frames"] == n_frames, f"main evaluated {timing['frames']} frames")

    dataset = CityScapes(255, str(root), [crop] * 2, mode="val")
    ref = plain_eval(torch, torch.bfloat16, scales, True, crop).evaluate(
        None, DataLoader(dataset, 2, num_workers=8))
    hist, ref_hist = res["confusion_matrix"], ref["confusion_matrix"]
    pixels = float(hist.sum())
    disagree = float(np.abs(hist - ref_hist).sum() / 2)
    agreement = 1.0 - disagree / pixels
    check(pixels == n_frames * (h - CITY_IGNORE_ROWS) * w == ref_hist.sum(),
          f"confusion matrices count {pixels} and {ref_hist.sum()} pixels")
    say("evaluate_main", part="bf16_kernels", scales=list(scales), flip=True,
        batch=2, frames=timing["frames"], mIoU=res["mIoU"], plain_mIoU=ref["mIoU"],
        hist_agreement=agreement, main_seconds=main_s,
        main_seconds_per_frame=main_s / timing["frames"],
        loop_seconds_per_frame=timing["seconds"] / timing["frames"],
        loader_wait_seconds=timing["loader_wait_seconds"],
        loader_wait_share=timing["loader_wait_seconds"] / timing["seconds"],
        loader_wait_seconds_per_batch=timing["loader_wait_seconds_per_batch"],
        plain_loop_seconds_per_frame=ref["timing"]["seconds"] / timing["frames"])
    check(agreement >= 0.999, f"evaluate main bf16: the confusion matrices differ on "
          f"{disagree} of {pixels} pixels")
    check(abs(res["mIoU"] - ref["mIoU"]) < 5e-3,
          f"evaluate main bf16 mIoU {res['mIoU']} against the plain path's {ref['mIoU']}")

    # float32 on one frame at scale 1: the f32 K1
    one = tmp / "cityscapes_one"
    for sub in ("leftImg8bit", "gtFine"):
        first = sorted((root / sub / "val").rglob("*.png"))[0]
        dst = one / sub / "val" / first.parent.name
        dst.mkdir(parents=True)
        shutil.copy(first, dst / first.name)
    argv = common + [f"dataset.dataset_path={one}", "validation_config.batch_size=1",
                     "validation_config.eval_scales=[1.0]", "validation_config.flip=false",
                     "runtime.use_pallas=true", "--device", DEVICE]
    res32, _, main32_s = paths.drive("evaluate_main_f32", run_main, argv)
    counts = paths.per_path["evaluate_main_f32"]
    check(counts["attention_f32"] > 0, f"evaluate main f32 launches {counts}")
    check(all(counts[k] == 0 for k in ("attention", "ffm_pointwise", "head_conv3x3",
                                       "stem_block0")),
          f"evaluate main f32 launched a bf16 kernel or K4: {counts}")
    image, labels = CityScapes(255, str(one), [crop] * 2, mode="val")[0]
    probs = plain_eval(torch, torch.float32, (1.0,), False, crop).prob_batch(None, image[None])
    ties, hist32_ref = ties_hist(np, probs, labels[None])
    disagree32 = float(np.abs(res32["confusion_matrix"] - hist32_ref).sum() / 2)
    say("evaluate_main", part="f32_kernel", frames=1, mIoU=res32["mIoU"],
        plain_mIoU=metrics_from_hist(hist32_ref)["mIoU"], disagree=disagree32,
        near_ties=ties, main_seconds=main32_s)
    check(disagree32 <= ties, f"evaluate main f32: {disagree32} pixels disagree with the "
          f"plain path, {ties} near ties")
    return {"png_ms": png_ms, "main_seconds_per_frame": main_s / timing["frames"],
            "loader_wait_share": timing["loader_wait_seconds"] / timing["seconds"]}



# ---------------------------------------------------------------------------
# Phase 8: the train step
# ---------------------------------------------------------------------------

N_CLASSES_TRAIN = 19  # Cityscapes, the published CABiNet-Large cell
# Card against CPU, f32 with TF32 off. The loss within 1e-4 of |cpu|. Each
# tensor of params, BN statistics and EMA within 0.1 of the CPU step's own
# change of it, plus 4 f32 ulps of its magnitude, plus 2e-3 of the step's
# largest change of its kind (a gradient that nearly cancels, or is zero in
# exact arithmetic); a running mean plus 1e-4 of its channel's scale instead
# of the ulps (`updates_err`). And the update of each kind as a whole,
# |card - cpu|_2 / |cpu - start|_2, within 2e-2. cuDNN and the CPU add in
# other orders, and at random init the backward through 15 blocks of
# train-mode BN, each subtracting its batch means from the gradient,
# amplifies those differences: on the H100 the whole update agreed to
# 2.5e-3 and an early depthwise kernel (/4 resolution) to 3.3% of its change.
BOUND_TRAIN_LOSS = 1e-4
BOUND_TRAIN_UPDATE = 0.1
BOUND_TRAIN_NORM = 2e-2
TRAIN_ULPS = 2.0 ** -21
BOUND_BN_MEAN = 1e-4
TRAIN_NOISE = 2e-3


def seeded_large(torch, n_classes: int, attention: str = "einsum", seed: int = 0):
    """Seeded CABiNet-Large (the full published table) with its zero gamma
    set to 0.5 and its zero project_out drawn from N(0, 0.05^2), so that
    gradients reach the global attention."""
    from cabinet_tpu_torch.models.cabinet import CABiNet

    torch.manual_seed(seed)
    model = CABiNet(n_classes, "large", attention=attention)
    with torch.no_grad():
        model.ab.a2block.gamma.fill_(0.5)
        torch.nn.init.normal_(model.ab.a2block.global_attn.project_out.weight, 0, 0.05)
    return model


def palette_batch(torch, np, n: int, size: int, seed: int):
    """n palette images (5 learnable classes of the 19) and their labels."""
    rng = np.random.default_rng(seed)
    pairs = [synthetic_palette(np, rng, size, size, 64) for _ in range(n)]
    return (torch.from_numpy(np.stack([p[0] for p in pairs])),
            torch.from_numpy(np.stack([p[1] for p in pairs])))


def train_one_update(torch, sd, batches, device, accum: int):
    """One optimizer step (accum micro-batches) of the port's trainer from
    state dict `sd` on `device`, f32: (losses, variables, EMA variables)."""
    from cabinet_tpu_torch.train import trainer as T
    from cabinet_tpu_torch.train.optimizer import GroupedSGD

    model = seeded_large(torch, N_CLASSES_TRAIN)
    model.load_state_dict(sd, strict=True)
    model.to(device)
    opt = GroupedSGD(model, lr0=0.05, max_iter=10, momentum=0.9, wd=5e-4,
                     warmup_steps=0, max_grad_norm=1.0)
    state = T.create_train_state(model, opt, 0.9, 2.0)
    x0, y0 = batches[0]
    step = T.make_train_step(n_min=x0.shape[0] * x0.shape[1] * x0.shape[2] // 16,
                             accum_steps=accum)
    losses = [float(step(state, x.to(device), y.to(device))[1]) for x, y in batches]
    check(state.step == 1 and state.micro_step == 0, f"{device}: step {state.step}")
    return (losses, {k: v.cpu() for k, v in model.state_dict().items()},
            {k: v.cpu() for k, v in state.ema.shadow.items()})


def updates_err(torch, got, ref, start):
    """{kind: (worst error over its bound, tensor, error, change)} over the
    float tensors, by kind: parameters, running means, running variances.
    Each tensor's bound is BOUND_TRAIN_UPDATE of its own change in the
    reference step, plus TRAIN_ULPS of its magnitude, plus TRAIN_NOISE of the
    largest change of its kind in the step: a tensor whose gradient nearly
    cancels, or is zero in exact arithmetic (the bias of a BN that a conv
    and a train-mode BN follow), moves by rounding alone. Also the update
    of all tensors of the kind together, |got - ref|_2 / |ref - start|_2. A running mean's change can cancel to
    nothing (a channel whose batch mean is ~0), so its bound adds
    BOUND_BN_MEAN of the channel's scale sqrt(running_var) instead."""
    def kind_of(k):
        return k.rsplit(".", 1)[-1] if k.endswith(("running_mean", "running_var")) else "param"

    floats = [k for k, r in ref.items() if torch.is_floating_point(r)]
    change = {k: float((ref[k] - start[k]).abs().max()) for k in floats}
    largest = {}
    for k in floats:
        largest[kind_of(k)] = max(largest.get(kind_of(k), 0.0), change[k])
    worst, sq = {}, {}
    for k in floats:
        r, kind, d = ref[k], kind_of(k), change[k]
        num, den = sq.get(kind, (0.0, 0.0))
        sq[kind] = (num + float(((got[k] - r).double() ** 2).sum()),
                    den + float(((r - start[k]).double() ** 2).sum()))
        err = float((got[k] - r).abs().max())
        bound = BOUND_TRAIN_UPDATE * d + TRAIN_NOISE * largest[kind]
        if kind == "running_mean":
            bound += BOUND_BN_MEAN * float(ref[k[:-len("mean")] + "var"].sqrt().max())
        else:
            bound += TRAIN_ULPS * float(r.abs().max())
        ratio = err / bound if bound > 0 else (0.0 if err == 0 else float("inf"))
        if ratio >= worst.get(kind, (-1.0,))[0]:
            worst[kind] = (ratio, k, err, d)
    for kind, (num, den) in sq.items():
        worst[kind] += ((num / den) ** 0.5 if den > 0 else 0.0,)
    return worst


def run_train_card_vs_cpu(torch, size: int = 512, batch: int = 2):
    """Phase 8a: one optimizer step (accum_steps=2) of CABiNet-Large, 19
    classes, f32, on the card and on the CPU from the same weights and
    micro-batches, held against each other."""
    import numpy as np

    model = seeded_large(torch, N_CLASSES_TRAIN)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    batches = [palette_batch(torch, np, batch, size, seed) for seed in (41, 42)]
    t0 = time.perf_counter()
    cpu = train_one_update(torch, sd, batches, "cpu", 2)
    cpu_s = time.perf_counter() - t0
    card = train_one_update(torch, sd, batches, DEVICE, 2)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0]))
    var_err = updates_err(torch, card[1], cpu[1], sd)
    ema_err = updates_err(torch, card[2], cpu[2], sd)
    say("train_step", part="card_vs_cpu", size=size, batch=batch, accum=2,
        losses_card=card[0], losses_cpu=cpu[0], loss_rel_err=loss_err,
        variables_err_over_bound=var_err, ema_err_over_bound=ema_err, cpu_seconds=cpu_s)
    check(all(np.isfinite(card[0])), f"card losses {card[0]}")
    check(loss_err <= BOUND_TRAIN_LOSS, f"train loss card/cpu rel err {loss_err}")
    for what, worst in (("params/BN", var_err), ("EMA", ema_err)):
        for kind, (ratio, key, err, d, norm) in worst.items():
            check(ratio <= 1.0, f"{what} after the step: {key} err {err} (change {d}) "
                  f"at {ratio} x the bound")
            check(norm <= BOUND_TRAIN_NORM, f"{what} after the step: the {kind} update "
                  f"differs by {norm} of its norm")
    moved = [k for k in cpu[1] if k.endswith("running_var")
             and not torch.equal(cpu[1][k], sd[k])]
    check(len(moved) > 0, "train mode did not update the BN statistics")


def run_train_full_width(torch, steps: int = 30, batch: int = 4, size: int = 1024):
    """Phase 8b: CABiNet-Large, 19 classes, batch 4 at 1024^2, bf16 autocast,
    attention="kernel" (runtime.use_pallas=true), warmup 0, lr0 5e-3: `steps`
    steps on one fixed batch. The loss must fall, and K1 must not launch in
    the steps (the step runs the einsum attention; K1 has no backward); the
    val loss on the same weights launches it. Then the steps timed with the
    port's BatchNorm and with torch's own (unbiased running variance), in
    turns."""
    import numpy as np
    from torch import nn

    from cabinet_tpu_torch.models.layers import BatchNorm2d
    from cabinet_tpu_torch.train import trainer as T
    from cabinet_tpu_torch.train.optimizer import GroupedSGD

    model = seeded_large(torch, N_CLASSES_TRAIN, attention="kernel").to(DEVICE)
    opt = GroupedSGD(model, lr0=5e-3, max_iter=steps, momentum=0.9, wd=5e-4,
                     warmup_steps=0, max_grad_norm=1.0)
    state = T.create_train_state(model, opt)
    x, y = palette_batch(torch, np, batch, size, 43)
    x, y = x.to(DEVICE), y.to(DEVICE)
    n_min = batch * size * size // 16
    step = T.make_train_step(n_min=n_min, compute_dtype=torch.bfloat16)
    losses = []
    warm = 5
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = kernel_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for i in range(steps):
        if i == warm:
            start.record()
        losses.append(step(state, x, y)[1])
        if i == steps - 1:
            end.record()
    torch.cuda.synchronize()
    after = kernel_counts()
    ms = start.elapsed_time(end) / (steps - warm)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(v) for v in losses]
    in_steps = {k: after[k] - before[k] for k in ("attention", "attention_f32")}
    val = float(T.make_eval_loss_step(model, n_min, compute_dtype=torch.bfloat16)(x, y))
    k1_eval = kernel_counts()["attention"] - after["attention"]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))

    def timed(n: int = 5) -> float:
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        step(state, x, y)
        s.record()
        for _ in range(n):
            step(state, x, y)
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / n

    ours = BatchNorm2d.forward
    bn_ms = {"port": [], "torch": []}
    try:
        for form in ("port", "torch", "torch", "port"):
            BatchNorm2d.forward = ours if form == "port" else nn.BatchNorm2d.forward
            bn_ms[form].append(timed())
    finally:
        BatchNorm2d.forward = ours
    say("train_step", part="full_width", batch=batch, size=size, steps=steps,
        dtype="bfloat16", loss_first5=first, loss_last5=last, losses=losses,
        ms_per_step=ms, images_per_s=batch * 1e3 / ms, peak_allocated_gib=peak_gib,
        k1_launches_in_steps=in_steps, val_loss=val, k1_launches_val_loss=k1_eval,
        bn_ms_per_step=bn_ms)
    check(all(np.isfinite(losses)) and np.isfinite(val), f"losses {losses}, val {val}")
    check(last < first, f"the loss did not fall: first 5 {first}, last 5 {last}")
    check(in_steps == {"attention": 0, "attention_f32": 0},
          f"K1 launched inside the train steps: {in_steps}")
    check(k1_eval > 0, "the val loss on attention='kernel' did not launch K1")
    return {"ms_per_step": ms, "images_per_s": batch * 1e3 / ms,
            "peak_allocated_gib": peak_gib, "bn_ms_per_step": bn_ms}


# ---------------------------------------------------------------------------
# Phase 9: cli/train.py main over a split read from disk
# ---------------------------------------------------------------------------

TRAIN_MAIN_FRAMES, TRAIN_MAIN_VAL_FRAMES = 8, 2


def augment_ms(np, root: Path, crop: int, n: int = 4) -> float:
    """Host ms per augmented train sample (decode, the street recipe,
    normalisation) of the split's frames, one thread."""
    from cabinet_tpu_torch.data.datasets import CityScapes

    ds = CityScapes(255, str(root), [crop, crop], mode="train")
    t0 = time.perf_counter()
    for i in range(n):
        img, lb = ds[i % len(ds)]
        check(img.shape == (crop, crop, 3) and lb.shape == (crop, crop),
              f"augmented sample {img.shape} {lb.shape}")
    return (time.perf_counter() - t0) * 1e3 / n


def run_train_main(torch, paths, tmp: Path, n_train: int = TRAIN_MAIN_FRAMES,
                   n_val: int = TRAIN_MAIN_VAL_FRAMES, h: int = FRAME_H,
                   w: int = FRAME_W, crop: int = EVAL_MAIN_CROP):
    """Phase 9: `cli/train.py:main` as a user runs it, with dataset=cityscapes
    on a split this script writes, configs/train.yaml as it is apart from
    epochs=2, warmup_steps=2, the loader threads (8), log_iter=1 (2 batches
    an epoch, under the default 20) and runtime.use_pallas=true; then a
    resume to epoch 3, and the final EMA weights scored by evaluate main."""
    import math

    import numpy as np

    from cabinet_tpu_torch.cli.train import main as train_main
    from cabinet_tpu_torch.train import trainer as trainer_mod

    root, exp = tmp / "cityscapes", tmp / "experiment"
    t0 = time.perf_counter()
    write_city_split(np, root, n_train, h, w, seed=51, split="train")
    write_city_split(np, root, n_val, h, w, seed=52, split="val")
    say("train_main", part="split", train=n_train, val=n_val, size=f"{w}x{h}",
        write_seconds=time.perf_counter() - t0)
    argv = ["dataset=cityscapes", f"dataset.dataset_path={root}",
            "training_config.epochs=2", "training_config.warmup_steps=2",
            "training_config.num_workers=8", "validation_config.num_workers=8",
            "training_config.log_iter=1", f"training_config.experiments_path={exp}",
            "runtime.use_pallas=true"]
    if crop != EVAL_MAIN_CROP:
        argv.append(f"dataset.cropsize=[{crop},{crop}]")

    inside = dict.fromkeys(_counters(), 0)
    make_step = trainer_mod.make_train_step

    def counting(*args, **kwargs):  # launches inside the train steps alone
        step = make_step(*args, **kwargs)

        def counted(state, images, labels):
            before = kernel_counts()
            out = step(state, images, labels)
            for k, n in kernel_counts().items():
                inside[k] += n - before[k]
            return out
        return counted

    trainer_mod.make_train_step = counting
    try:
        res, main_s, _ = paths.drive("train_main", run_cli, train_main,
                                     argv + ["--device", DEVICE], "train", 4)
        counts = dict(paths.per_path["train_main"])
        res2, resume_s, _ = paths.drive("train_main_resume", run_cli, train_main,
                                        argv + ["training_config.resume=true",
                                                "training_config.epochs=3", "--device", DEVICE],
                                        "train", 4)
    finally:
        trainer_mod.make_train_step = make_step
    lines = [json.loads(ln) for ln in (exp / "metrics.jsonl").read_text().splitlines()]
    say("train_main", part="metrics", lines=lines)
    check(len(lines) == 5, f"metrics.jsonl has {len(lines)} lines, expected 5")
    check(lines[0].get("start_epoch") == 0 and lines[3].get("start_epoch") == 2,
          f"run markers {lines[0]}, {lines[3]}")
    for ln, epoch, step in ((lines[1], 0, 2), (lines[2], 1, 4), (lines[4], 2, 6)):
        check(ln["epoch"] == epoch and ln["step"] == step, f"epoch line {ln}")
        check(all(isinstance(ln[k], float) and math.isfinite(ln[k])
                  for k in ("train_loss", "val_loss", "mIoU")), f"epoch line {ln}")
    for f in ("checkpoint_last.pth", "cabinet_best.pth", "cabinet.pth", "config.yaml"):
        check((exp / f).is_file(), f"train main wrote no {f}")
    check(counts["attention"] > 0, f"train main: K1 never launched {counts}")
    check(inside["attention"] == 0 and inside["attention_f32"] == 0,
          f"K1 launched inside the train steps: {inside}")
    check(all(math.isfinite(r["final"]["mIoU"]) for r in (res, res2)),
          "final mIoU not finite")
    timing = res["timing"]
    check(timing["optimizer_steps"] == 4 and res2["timing"]["optimizer_steps"] == 2,
          f"optimizer steps {timing['optimizer_steps']}, {res2['timing']['optimizer_steps']}")

    scored, _, eval_s = paths.drive("train_main_evaluate", run_main, [
        "dataset=cityscapes", f"dataset.dataset_path={root}",
        f"checkpoint_path={exp / 'cabinet.pth'}", "runtime.compute_dtype=bfloat16",
        "runtime.use_pallas=true", "--device", DEVICE])
    check(0.0 <= scored["mIoU"] <= 1.0 and scored["timing"]["frames"] == n_val,
          f"evaluate main on the trained weights: {scored['mIoU']}")
    measured = {
        "main_seconds": main_s, "resume_main_seconds": resume_s,
        "loop_seconds_per_optimizer_step": timing["train_seconds"] / timing["optimizer_steps"],
        "loader_wait_share": timing["loader_wait_seconds"] / timing["train_seconds"],
        "loader_wait_seconds": timing["loader_wait_seconds"],
        "eval_seconds": timing["eval_seconds"], "final_eval_seconds": timing["final_eval_seconds"],
        "host_ms_per_augmented_frame": augment_ms(np, root, crop),
        "launches_in_steps": inside, "launches": counts, "final_mIoU": res["final"]["mIoU"],
        "evaluate_main_mIoU": scored["mIoU"], "evaluate_main_seconds": eval_s}
    say("train_main", **measured)
    return measured


# ---------------------------------------------------------------------------
# Phase 10: device augmentation, and train main on it
# ---------------------------------------------------------------------------

AUG_BATCH, AUG_CANVAS, AUG_CROP = 4, 2048, 1024
CITY_MEAN, CITY_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
AERIAL_AUG = {"degrees": 10.0, "translate": 0.05, "scale": 0.3, "fliplr": 0.5,
              "flipud": 0.2, "hsv_h": 0.01, "hsv_s": 0.4, "hsv_v": 0.3, "mixup": 0.1}
STREET_AUG = {"fliplr": 0.5, "flipud": 0.0, "degrees": 0.0, "translate": 0.0,
              "scale_choices": (0.75, 1.0, 1.25, 1.5, 1.75, 2.0), "mixup": 0.0}
# Card against CPU: [0, 1] values within 1e-5 (so 1e-5 / min(std) after the
# normalisation); labels equal on >= 99.9% of pixels and on every pixel whose
# sampling coordinate lies more than 1e-3 px from a rounding tie.
BOUND_AUG = 1e-5
AUG_LABEL_SHARE, AUG_TIE = 0.999, 1e-3
# the canvases' frames: UAVid's 3840x2160 box-reduced by 2, Cityscapes' native
AERIAL_HW, STREET_HW = (1080, 1920), (1024, 2048)
UAVID_FRAMES, UAVID_VAL_FRAMES, UAVID_H, UAVID_W = 8, 2, 2160, 3840
AUG_MAIN_EPOCHS = 4


def aug_canvases(np, recipe: str, seed: int = 61):
    """A batch of u8 canvases as the datasets ship them: UAVid frames
    box-reduced 3840x2160 -> 1920x1080 (aerial) or native 2048x1024
    Cityscapes frames (street), palette content, labels 0-4 and 255 outside."""
    rng = np.random.default_rng(seed)
    h, w = AERIAL_HW if recipe == "aerial" else STREET_HW
    ci = np.zeros((AUG_BATCH, AUG_CANVAS, AUG_CANVAS, 3), np.uint8)
    cl = np.full((AUG_BATCH, AUG_CANVAS, AUG_CANVAS), 255, np.uint8)
    for b in range(AUG_BATCH):
        image, labels = synthetic_palette(np, rng, h, w, 120 if recipe == "aerial" else 128)
        ci[b, :h, :w] = np.clip(np.rint(255 * image), 0, 255)
        cl[b, :h, :w] = labels
    return ci, cl, np.tile(np.array([[h, w]], np.int32), (AUG_BATCH, 1))


def near_tie(*coords):
    """Pixels where a coordinate lies within AUG_TIE px of a rounding tie."""
    out = None
    for c in coords:
        c = c.double().cpu()
        t = (c - c.floor() - 0.5).abs() < AUG_TIE
        out = t if out is None else out | t
    return out


def check_device_aug_chain(torch, peaks, warp: str, recipe: str):
    """Phase 10a: the warp (`exact` or `shared`) and the recipe's chain at
    full size on the card and on the CPU, from the same params drawn on the
    host and the same noise; then the card's ms per batch (CUDA events, the
    params already on the card) beside the byte bound: the canvases' valid
    regions read once, the noise read once, the normalised crops and int64
    labels written once."""
    import numpy as np

    from cabinet_tpu_torch.ops import geometric as G
    from cabinet_tpu_torch.ops import photometric as P

    ci, cl, hw = aug_canvases(np, recipe)
    crop = (AUG_CROP, AUG_CROP)
    aug = AERIAL_AUG if recipe == "aerial" else STREET_AUG
    rng = np.random.default_rng(62)
    shared = warp == "shared"
    geo = G.sample_geometric_params(rng, AUG_BATCH, aug, hw, shared_linear=shared)
    if recipe == "aerial":
        pho, chain = P.sample_photometric(rng, AUG_BATCH, *crop, aug), P.photometric_pipeline
        mean, std = (0.480, 0.499, 0.457), (0.225, 0.208, 0.228)  # UAVid
    else:
        pho, chain = (P.sample_street_photometric(rng, AUG_BATCH, *crop),
                      P.street_photometric_pipeline)
        mean, std = CITY_MEAN, CITY_STD
    z = torch.randn((AUG_BATCH, *crop, 3), generator=torch.Generator().manual_seed(63))
    warp_fn = G.apply_geometric_shared if shared else G.apply_geometric

    def run(tensors):
        x, y = warp_fn(*tensors[:3], tensors[3], crop, 255)
        return chain(x, y, tensors[4], tensors[5], mean, std)

    def staged(dev):
        return ([torch.from_numpy(a).to(dev) for a in (ci, cl, hw)]
                + [P.params_to_device(geo, dev), P.params_to_device(pho, dev), z.to(dev)])

    t0 = time.perf_counter()
    cpu = run(staged("cpu"))
    cpu_s = time.perf_counter() - t0
    on_card = staged(DEVICE)
    card = run(on_card)
    torch.cuda.synchronize()
    err = float((card[0].cpu() - cpu[0]).abs().max())
    differ = card[1].cpu() != cpu[1]
    tp = P.params_to_device(geo, "cpu")
    if shared:
        c = G.shared_coords(torch.from_numpy(hw), tp, crop, AUG_CANVAS)
        ties = near_tie(c["xf"], c["yf"])
    else:
        c = G.geometric_coords(torch.from_numpy(hw), tp, crop)
        ties = near_tie(c["xl"], c["yl"], c["xc"], c["yc"])
    off_tie = int((differ & ~ties).sum())
    share = 1.0 - float(differ.float().mean())
    ms = time_ms(lambda: run(on_card), iters=10)
    n_out = AUG_BATCH * AUG_CROP * AUG_CROP
    n_bytes = 4 * float(np.prod(hw, axis=1).sum()) + n_out * (12 + 12 + 8)
    bound_ms, bound_by = peaks.bound(n_bytes)
    row = {"warp": warp, "recipe": recipe, "max_abs_err": err, "label_share": share,
           "labels_off_tie_differing": off_tie, "ms": ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "cpu_seconds": cpu_s,
           "ignore_share": float((card[1] == 255).float().mean())}
    say("device_augs", part="chain", **row)
    check(err <= BOUND_AUG / min(std), f"device augs {warp}/{recipe}: card vs CPU err {err}")
    check(share >= AUG_LABEL_SHARE and off_tie == 0,
          f"device augs {warp}/{recipe}: labels agree on {share}, {off_tie} off a tie")
    check(bool(torch.isfinite(card[0]).all()), f"device augs {warp}/{recipe}: not finite")
    return row


def write_uavid_split(np, root: Path, n_frames: int, split: str, seed: int,
                      h: int = UAVID_H, w: int = UAVID_W) -> None:
    """A UAVid-layout split (images/<split>/*.png, masks/<split>/*.png) of
    h x w palette frames stored so that UAVid's normalisation gives back the
    palette values plus noise, labels 0-4, written with the port's save_png,
    each frame encoded on a thread (`thread_pool`)."""
    from cabinet_tpu_torch.data.datasets import UAVid
    from cabinet_tpu_torch.data.decode import save_png

    mean = np.asarray(UAVid.MEAN, np.float32)
    std = np.asarray(UAVid.STD, np.float32)
    rng = np.random.default_rng(seed)
    (root / "images" / split).mkdir(parents=True, exist_ok=True)
    (root / "masks" / split).mkdir(parents=True, exist_ok=True)

    def frame(i, image, labels):
        u8 = np.clip(np.rint(255.0 * (mean + std * image)), 0, 255).astype(np.uint8)
        save_png(root / "images" / split / f"seq{i:02d}_000100.png", u8, compress_level=1)
        save_png(root / "masks" / split / f"seq{i:02d}_000100.png",
                 labels.astype(np.uint8), compress_level=1)

    with thread_pool() as pool:
        jobs = [pool.submit(frame, i, *synthetic_palette(np, rng, h, w, 120))
                for i in range(n_frames)]
    for job in jobs:
        job.result()


def canvas_ms(np, cls, root: Path, crop: int, cache=None, n: int = 4) -> float:
    """Host ms per canvas triple (decode, the fast resize, the copy; or the
    cache's read), one thread."""
    ds = cls(255, str(root), [crop, crop], mode="train", photometric="device",
             geometric="device", decode_cache=cache)
    t0 = time.perf_counter()
    for i in range(n):
        ci, cl, hw = ds[i % len(ds)]
        check(ci.shape == (ds.canvas, ds.canvas, 3) and cl.shape == ci.shape[:2],
              f"canvas triple {ci.shape} {cl.shape} {hw}")
    return (time.perf_counter() - t0) * 1e3 / n


def counting_steps(trainer_mod, inside):
    """make_train_step whose steps add their kernel launches to `inside`."""
    make_step = trainer_mod.make_train_step

    def counting(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def counted(state, images, labels):
            before = kernel_counts()
            out = step(state, images, labels)
            for k, n in kernel_counts().items():
                inside[k] += n - before[k]
            return out
        return counted
    return counting


def aug_main_run(torch, paths, name: str, argv, exp: Path):
    """One `cli/train.py:main` run with the device pipeline, driven as a
    main path: its result, the loss falling over its epochs, K1 in its
    evaluations and 0 in its steps, its timing."""
    import math

    from cabinet_tpu_torch.cli.train import main as train_main
    from cabinet_tpu_torch.train import trainer as trainer_mod

    inside = dict.fromkeys(_counters(), 0)
    make_step = trainer_mod.make_train_step
    trainer_mod.make_train_step = counting_steps(trainer_mod, inside)
    try:
        res, main_s, _ = paths.drive(name, run_cli, train_main, argv + [
            f"training_config.experiments_path={exp}", "--device", DEVICE], "train", 3)
    finally:
        trainer_mod.make_train_step = make_step
    counts = paths.per_path[name]
    lines = [json.loads(ln) for ln in (exp / "metrics.jsonl").read_text().splitlines()
             if '"epoch"' in ln]
    losses = [ln["train_loss"] for ln in lines]
    t = res["timing"]
    out = {"main_seconds": main_s, "train_losses": losses,
           "loop_seconds_per_optimizer_step": t["train_seconds"] / t["optimizer_steps"],
           "loader_wait_share": t["loader_wait_seconds"] / t["train_seconds"],
           "device_aug_seconds": t["device_aug_seconds"],
           "device_aug_ms_per_batch": 1e3 * t["device_aug_seconds"] / t["micro_steps"],
           "train_seconds": t["train_seconds"], "eval_seconds": t["eval_seconds"],
           "final_eval_seconds": t["final_eval_seconds"], "final_mIoU": res["final"]["mIoU"],
           "k1_launches": counts["attention"], "k1_launches_in_steps": inside["attention"]}
    say("device_augs", part="train_main", run=name, **out)
    check(len(losses) == AUG_MAIN_EPOCHS and all(math.isfinite(v) for v in losses),
          f"{name}: train losses {losses}")
    check(losses[-1] < losses[0], f"{name}: the loss did not fall: {losses}")
    check(counts["attention"] > 0, f"{name}: K1 never launched {counts}")
    check(inside["attention"] == 0 and inside["attention_f32"] == 0,
          f"{name}: K1 launched inside the train steps: {inside}")
    check(t["device_aug_seconds"] > 0 and math.isfinite(res["final"]["mIoU"]),
          f"{name}: timing {t}, final {res['final']['mIoU']}")
    return out


def remat_steps(torch, batch: int = 4, size: int = 1024, steps: int = 6):
    """Phase 10c: the train step of CABiNet-Large (19 classes), bf16, at
    batch 4 and 1024^2 with runtime.remat false, 4 and true: ms per step
    (CUDA events over `steps` steps after 2) and peak allocated memory."""
    import numpy as np

    from cabinet_tpu_torch.train import trainer as T
    from cabinet_tpu_torch.train.optimizer import GroupedSGD

    model = seeded_large(torch, N_CLASSES_TRAIN).to(DEVICE)
    state = T.create_train_state(model, GroupedSGD(model, lr0=5e-3, max_iter=100))
    x, y = palette_batch(torch, np, batch, size, 44)
    x, y = x.to(DEVICE), y.to(DEVICE)
    step = T.make_train_step(n_min=batch * size * size // 16, compute_dtype=torch.bfloat16)
    out = {}
    for remat in (False, 4, True, False):
        model.mobile.remat = remat
        step(state, x, y)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: step(state, x, y), iters=steps, warmup=1)
        key = str(remat).lower()
        out.setdefault(key, {"ms_per_step": [], "peak_allocated_gib": []})
        out[key]["ms_per_step"].append(ms)
        out[key]["peak_allocated_gib"].append(torch.cuda.max_memory_allocated() / 2 ** 30)
    model.mobile.remat = False
    say("device_augs", part="remat", batch=batch, size=size, dtype="bfloat16", **out)
    check(out["true"]["peak_allocated_gib"][0] < out["false"]["peak_allocated_gib"][0],
          f"remat did not lower the peak memory: {out}")
    return out


def run_device_augs(torch, peaks, paths, tmp: Path):
    """Phase 10: the chains at full size, the three train main runs, the
    host's canvas times, and remat's step times."""
    import numpy as np

    from cabinet_tpu_torch.data.datasets import CityScapes, UAVid

    chains = [check_device_aug_chain(torch, peaks, warp, recipe)
              for warp in ("exact", "shared") for recipe in ("aerial", "street")]

    city, uavid, cache = tmp / "cityscapes", tmp / "uavid", tmp / "decode_cache"
    t0 = time.perf_counter()
    write_city_split(np, city, TRAIN_MAIN_FRAMES, FRAME_H, FRAME_W, seed=51, split="train")
    write_city_split(np, city, TRAIN_MAIN_VAL_FRAMES, FRAME_H, FRAME_W, seed=52, split="val")
    write_uavid_split(np, uavid, UAVID_FRAMES, "train", 71)
    write_uavid_split(np, uavid, UAVID_VAL_FRAMES, "val", 72)
    say("device_augs", part="splits", write_seconds=time.perf_counter() - t0)
    host = {"city_canvas_ms": canvas_ms(np, CityScapes, city, AUG_CROP),
            "uavid_canvas_ms": canvas_ms(np, UAVid, uavid, AUG_CROP)}

    common = [f"training_config.epochs={AUG_MAIN_EPOCHS}", "training_config.warmup_steps=2",
              "training_config.num_workers=8", "validation_config.num_workers=8",
              "training_config.log_iter=1", "runtime.use_pallas=true"]
    if AUG_CROP != EVAL_MAIN_CROP:
        common.append(f"dataset.cropsize=[{AUG_CROP},{AUG_CROP}]")
    # cls_pw=0: the class-weight pass would read every frame before the
    # loop, and so fill the cache before the cold run's first epoch
    city_argv = ["dataset=cityscapes", f"dataset.dataset_path={city}",
                 "runtime.device_geometric=true", f"+runtime.decode_cache={cache}",
                 "training_config.cls_pw=0"] + common
    runs = {"city_cold": aug_main_run(torch, paths, "aug_main_city_cold", city_argv,
                                      tmp / "exp_city_cold"),
            "city_warm": aug_main_run(torch, paths, "aug_main_city_warm", city_argv,
                                      tmp / "exp_city_warm")}
    host["city_cached_canvas_ms"] = canvas_ms(np, CityScapes, city, AUG_CROP, cache)
    runs["uavid_shared_remat"] = aug_main_run(torch, paths, "aug_main_uavid_shared_remat", [
        "dataset=uavid", f"dataset.dataset_path={uavid}", "runtime.device_geometric=shared",
        "runtime.remat=true", "validation_config.eval_scales=[1.0]"] + common,
        tmp / "exp_uavid")
    say("device_augs", part="host", **host)
    remat = remat_steps(torch)
    return {"chains": chains, "runs": runs, "host": host, "remat": remat}


# ---------------------------------------------------------------------------
# Phase 11: serving and export
# ---------------------------------------------------------------------------

# 1920x1080 frames (UAVid's video size halved), the server's batch ceiling
# and its deadline, the load of phase 11b and the small frames of 11c.
SERVE_FRAMES, SERVE_H, SERVE_W, SERVE_SIZE = 16, 1080, 1920, 1024
SERVE_MAX_BATCH, SERVE_DEADLINE_MS, SERVE_QUEUE = 8, 3.0, 64
SERVE_CLIENTS, SERVE_PER_CLIENT = 32, 4
BUSY_FRAMES, BUSY_H, BUSY_W = 8, 180, 320


def serve_frames(np, n: int, h: int, w: int, seed: int):
    """n uint8 frames of uniform noise, as phase 4's: the masks compress
    poorly, so their PNG encode is at its slowest (zlib stores the
    bodies as they are, so their inflate is a copy)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def plain_references(torch, ckpt: Path, route: str, dtype, frames, bound: float):
    """For each frame, as the server resizes it: the plain path's argmax
    and the pixels whose plain-path margin exceeds twice the forward's
    logit bound (`bound` of max|logit|), both at the frame's own size by
    the server's nearest-exact rule."""
    from cabinet_tpu_torch.cli.infer import Segmenter, resize_frame
    from cabinet_tpu_torch.data.datasets import DATASET_REGISTRY

    plain = plain_forward(torch, ckpt, route, dtype)
    stats = DATASET_REGISTRY["uavid"]
    mean = torch.tensor(stats.MEAN, device=DEVICE)
    std = torch.tensor(stats.STD, device=DEVICE)
    refs = []
    for rgb in frames:
        x = resize_frame(torch.from_numpy(rgb).to(DEVICE), SERVE_SIZE)
        with torch.no_grad():
            logits = plain(((x.float() / 255.0 - mean) / std)[None])[0][0].float()
        top2 = logits.topk(2, dim=-1).values
        sure = (top2[..., 0] - top2[..., 1]) > 2 * bound * float(logits.abs().max())
        hw = rgb.shape[:2]
        refs.append((Segmenter._postprocess(logits.argmax(-1), hw),
                     Segmenter._postprocess(sure, hw).astype(bool)))
    return refs


def hold_masks(answers, refs, min_agree: float, tag: str):
    """answers: (frame index, mask) pairs, each held against its frame's
    plain reference by phase 4's rule. Returns (least agreement, least
    agreement beyond the bound)."""
    check(len(answers) > 0, f"{tag}: no mask to hold")
    agree, sure_agree = [], []
    for i, mask in answers:
        ref, sure = refs[i]
        check(mask.shape == ref.shape, f"{tag}: mask {mask.shape}, frame {ref.shape}")
        same = mask == ref
        agree.append(float(same.mean()))
        sure_agree.append(float(same[sure].mean()))
    check(min(sure_agree) == 1.0 and min(agree) >= min_agree,
          f"{tag}: agreement {min(agree)}, beyond the bound {min(sure_agree)}")
    return min(agree), min(sure_agree)


def post_raw(url: str, body: bytes, timeout: float = 120.0):
    """(HTTP status, response body, client ms to the last byte)."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    req = urllib.request.Request(f"{url}/segment", data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            data, status = r.read(), r.status
    except urllib.error.HTTPError as e:
        data, status = e.read(), e.code
    return status, data, (time.perf_counter() - t0) * 1e3


def as_mask(status: int, data: bytes):
    from cabinet_tpu_torch.data.decode import decode_png, png_mask

    return png_mask(decode_png(data)) if status == 200 else None


def post_segment(url: str, body: bytes, timeout: float = 120.0):
    """(HTTP status, mask or None, client ms to the last byte)."""
    status, data, ms = post_raw(url, body, timeout)
    return status, as_mask(status, data), ms


class Serving:
    """`make_server(engine)` on an ephemeral port, served from a thread;
    on exit the server stops and the engine's batcher closes."""

    def __init__(self, engine):
        import threading

        from cabinet_tpu_torch.cli.serve import make_server

        self.engine = engine
        self.server = make_server(engine, "127.0.0.1", 0)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self.url

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.engine.batcher.close()
        self.thread.join(timeout=10)


def percentile(values, p: float) -> float:
    v = sorted(values)
    return v[min(len(v) - 1, int(p * len(v)))]


def load_clients(url: str, folder: str, jobs) -> None:
    """The load generator, in a process of its own (`concurrent_requests`):
    one thread per client sends the bodies `folder`/<i>.png of its frame
    indices in turn, all clients starting together; each answer is written
    to `folder`/answer_<client>_<k>. Prints one JSON line: [frame index,
    status, client ms, answer file] per request, and the wall seconds."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    root = Path(folder)
    bodies = {i: (root / f"{i}.png").read_bytes() for i in {i for js in jobs for i in js}}
    barrier = threading.Barrier(len(jobs))

    def client(c):
        barrier.wait()
        out = []
        for k, i in enumerate(jobs[c]):
            status, data, ms = post_raw(url, bodies[i])
            path = root / f"answer_{c}_{k}"
            path.write_bytes(data)
            out.append([i, status, ms, str(path)])
        return out

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        answers = [a for rs in pool.map(client, range(len(jobs))) for a in rs]
    print(json.dumps({"answers": answers, "wall_s": time.perf_counter() - t0}), flush=True)


def concurrent_requests(url: str, bodies, jobs):
    """`jobs` is a list per client of frame indices, sent in turn by that
    client; all clients start together, from a process of their own
    (`load_clients`), so that the load generator's threads do not share
    the server's interpreter lock. Returns [(frame index, status, mask or
    None, client ms)] and the clients' wall seconds."""
    with tempfile.TemporaryDirectory() as folder:
        for i in {i for js in jobs for i in js}:
            (Path(folder) / f"{i}.png").write_bytes(bodies[i])
        code = ("import sys, json; sys.path.insert(0, %r); import chip_smoke; "
                "chip_smoke.load_clients(%r, %r, json.loads(sys.argv[1]))"
                % (str(ROOT), url, folder))
        res = subprocess.run([sys.executable, "-c", code, json.dumps(jobs)],
                             capture_output=True, text=True, timeout=600)
        check(res.returncode == 0, f"load clients failed: {res.stderr[-2000:]}")
        run = json.loads(res.stdout.strip().splitlines()[-1])
        answers = [(i, status, as_mask(status, Path(f).read_bytes()), ms)
                   for i, status, ms, f in run["answers"]]
    return answers, run["wall_s"]


def export_artifact(torch, ckpt: Path, out: Path):
    """Phase 11a: `cli/export.py:main` as a user runs it (Large, 1024^2,
    bf16, symbolic batch, --check on the card). Returns (seconds, bytes)."""
    from cabinet_tpu_torch.cli.export import main as export_main

    _, seconds, lines = run_cli(export_main, [
        "--checkpoint", str(ckpt), "--dataset", "uavid", "--out", str(out),
        "--imgsz", str(SERVE_SIZE), "--batch", "b", "--mode", "large",
        "--dtype", "bfloat16", "--device", DEVICE, "--check"], "export")
    check(any("round-trip check passed" in ln for ln in lines), "export --check")
    return seconds, sum(f.stat().st_size for f in out.iterdir())


def artifact_ms(torch, art: Path, ckpt: Path):
    """ms per image of the artifact (the model's own path, no kernel) and
    of the kernel route (Segmenter bf16 at batch 8: K4, the fused tail,
    K1), uint8 in and class IDs out on the card, at batch 1 and 8 (CUDA
    events, back to back)."""
    from cabinet_tpu_torch.cli.infer import Segmenter
    from cabinet_tpu_torch.export import load_artifact

    serve, _ = load_artifact(art, DEVICE)
    seg = Segmenter(str(ckpt), "uavid", imgsz=SERVE_SIZE, dtype_name="bfloat16",
                    batch=8, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    x = torch.randint(0, 256, (8, SERVE_SIZE, SERVE_SIZE, 3), generator=gen,
                      device=DEVICE, dtype=torch.uint8)
    kernel_route = lambda t: seg._forward(seg._normalise(t))  # noqa: E731
    out = {}
    with torch.no_grad():
        for b in (1, 8):
            out[f"artifact_ms_per_img_batch{b}"] = time_ms(lambda: serve(x[:b]), iters=10) / b
            out[f"kernel_route_ms_per_img_batch{b}"] = time_ms(
                lambda: kernel_route(x[:b]), iters=10) / b
    return out


def host_ms(np, body: bytes, mask, reps: int = 3):
    """The host steps of one 1920x1080 request, ms each (one thread): the
    PNG decode, the mask's resize back and its PNG encode (the frame's
    resize runs in the worker's device step)."""
    import torch

    from cabinet_tpu_torch.cli.infer import Segmenter
    from cabinet_tpu_torch.data.decode import decode_rgb, encode_png

    def ms(fn):
        best = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best.append((time.perf_counter() - t0) * 1e3)
        return min(best)

    rgb = decode_rgb(body)
    small = np.zeros((SERVE_SIZE, SERVE_SIZE), np.uint8)
    return {"decode_ms": ms(lambda: decode_rgb(body)),
            "mask_resize_ms": ms(lambda: Segmenter._postprocess(
                torch.from_numpy(small), rgb.shape[:2])),
            "encode_ms": ms(lambda: encode_png(mask))}


def run_serve_bf16(torch, ckpt: Path, bodies, refs):
    """Phase 11b: the checkpoint server in bf16 (Large, 1024^2, max_batch
    8, deadline 3 ms, queue 64): 8 solo requests in sequence, then 32
    concurrent clients of 4 requests each; every mask held against the
    plain path; K1-K4 launched by the served requests, the engine's
    warm-up aside."""
    from cabinet_tpu_torch.cli.serve import _Engine

    t0 = time.perf_counter()
    engine = _Engine(None, str(ckpt), "uavid", "large", SERVE_SIZE, "bfloat16",
                     max_batch=SERVE_MAX_BATCH, deadline_ms=SERVE_DEADLINE_MS,
                     queue_depth=SERVE_QUEUE, device=DEVICE)
    start_s = time.perf_counter() - t0
    check(engine.meta["route"] == "fused_tail_early", f"route {engine.meta}")
    warm = kernel_counts()
    step, worker_ms = engine.batcher.infer_batch, []

    def timed(xs, regime):  # the worker's device step, host clock
        t1 = time.perf_counter()
        out = step(xs, regime)
        worker_ms.append((time.perf_counter() - t1) * 1e3)
        return out

    engine.batcher.infer_batch = timed
    with Serving(engine) as url:
        solo = [(i, *post_segment(url, bodies[i])) for i in range(8)]
        worker_ms.clear()
        engine.batcher.reset_stats()
        n = len(bodies)
        jobs = [[(c * SERVE_PER_CLIENT + k) % n for k in range(SERVE_PER_CLIENT)]
                for c in range(SERVE_CLIENTS)]
        loaded, wall = concurrent_requests(url, bodies, jobs)
        stats = engine.stats()
    answers = solo + loaded
    check(all(s == 200 for _, s, _, _ in answers),
          f"statuses {sorted({s for _, s, _, _ in answers})}")
    served = {k: n - warm[k] for k, n in kernel_counts().items()}
    check(all(served[k] > 0 for k in TAIL + ("stem_block0",)),
          f"serve bf16: the requests launched {served} (the warm-up {warm})")
    agree = hold_masks([(i, m) for i, _, m, _ in answers], refs, 0.99, "serve bf16")
    check(stats["mean_batch_size"] > 1, f"mean batch size {stats['mean_batch_size']}")
    check(stats["requests"] == len(loaded) and stats["errors"] == 0, f"stats {stats}")
    client_ms = [ms for _, _, _, ms in loaded]
    return {
        "engine_start_s": start_s, "warmup_ms": engine.warmup_ms,
        "launches_warmup": warm, "launches_served": served,
        "first_request_ms": solo[0][3],
        "solo_p50_ms_after_first": percentile([ms for *_, ms in solo[1:]], 0.5),
        "requests": len(loaded), "wall_s": wall,
        "client_requests_per_s": len(loaded) / wall,
        "client_latency_ms_p50": percentile(client_ms, 0.5),
        "client_latency_ms_p99": percentile(client_ms, 0.99),
        "server": stats, "least_agreement": agree[0],
        "agreement_beyond_bound": agree[1],
        "worker_step_ms_p50": percentile(worker_ms, 0.5),
        "worker_step_ms_max": max(worker_ms),
        "worker_busy_share": sum(worker_ms) / 1e3 / wall}


def run_backpressure(torch, ckpt: Path, bodies, refs):
    """Phase 11c: queue 2, submit timeout 50 ms, 32 requests at once: at
    least one 503, every other answer a correct mask, no client past 30 s,
    close() within its join timeout."""
    from cabinet_tpu_torch.cli.serve import _Engine

    engine = _Engine(None, str(ckpt), "uavid", "large", SERVE_SIZE, "bfloat16",
                     max_batch=SERVE_MAX_BATCH, deadline_ms=SERVE_DEADLINE_MS,
                     queue_depth=2, submit_timeout_s=0.05, device=DEVICE)
    with Serving(engine) as url:
        answers, wall = concurrent_requests(
            url, bodies, [[c % len(bodies)] for c in range(32)])
        t0 = time.perf_counter()
        engine.batcher.close()
        close_s = time.perf_counter() - t0
    statuses = [s for _, s, _, _ in answers]
    busy = statuses.count(503)
    check(busy >= 1, f"no 503 under backpressure: {statuses}")
    check(all(s in (200, 503) for s in statuses), f"statuses {statuses}")
    hold_masks([(i, m) for i, s, m, _ in answers if s == 200], refs, 0.99,
               "backpressure")
    slowest = max(ms for *_, ms in answers)
    check(slowest < 30e3, f"a client waited {slowest} ms")
    check(close_s < 5.0, f"close() took {close_s} s")
    return {"responses_503": busy, "responses_200": statuses.count(200),
            "slowest_client_ms": slowest, "close_s": close_s, "wall_s": wall}


def run_serve_f32(torch, ckpt: Path, bodies, refs):
    """Phase 11d: the float32 server, 8 concurrent requests: the f32 K1 and
    K4 launched, K2 and K3 not; masks against the f32 plain path."""
    from cabinet_tpu_torch.cli.serve import _Engine

    engine = _Engine(None, str(ckpt), "uavid", "large", SERVE_SIZE, "float32",
                     max_batch=SERVE_MAX_BATCH, deadline_ms=SERVE_DEADLINE_MS,
                     device=DEVICE)
    check(engine.meta["route"] == "fused_early", f"route {engine.meta}")
    warm = kernel_counts()
    with Serving(engine) as url:
        answers, _ = concurrent_requests(url, bodies, [[i] for i in range(8)])
        stats = engine.stats()
    check(all(s == 200 for _, s, _, _ in answers), "f32 statuses")
    counts = kernel_counts()
    served = {k: n - warm[k] for k, n in counts.items()}
    check(served["attention_f32"] > 0 and served["stem_block0"] > 0
          and counts["attention"] == counts["ffm_pointwise"] == counts["head_conv3x3"] == 0,
          f"f32 server launches {served} (the warm-up {warm})")
    agree = hold_masks([(i, m) for i, _, m, _ in answers], refs, 0.999, "serve f32")
    return {"server": stats, "least_agreement": agree[0],
            "agreement_beyond_bound": agree[1]}


def run_artifact_server(torch, art: Path, ckpt: Path, frames, bodies, live_model=None):
    """Phase 11e: the server on 11a's artifact, 8 concurrent requests: no
    kernel launched; each batch the worker ran equal, bit for bit, to the
    live make_serving_fn (of `live_model`, else of the checkpoint's model)
    on the same frames resized and padded by the same rule, and each answer
    to its row brought to the frame's size."""
    import numpy as np

    from cabinet_tpu_torch.cli.infer import Segmenter, load_state_dict, resize_frame
    from cabinet_tpu_torch.cli.serve import _Engine
    from cabinet_tpu_torch.data.datasets import DATASET_REGISTRY
    from cabinet_tpu_torch.export import make_serving_fn
    from cabinet_tpu_torch.models.cabinet import CABiNet

    engine = _Engine(str(art), None, None, "large", SERVE_SIZE, "bfloat16",
                     max_batch=SERVE_MAX_BATCH, deadline_ms=SERVE_DEADLINE_MS,
                     device=DEVICE)
    batches = []
    infer = engine.batcher.infer_batch

    def recorded(xs, regime):
        out = infer(xs, regime)
        batches.append((list(xs), regime, out.copy()))
        return out

    engine.batcher.infer_batch = recorded
    with Serving(engine) as url:
        answers, _ = concurrent_requests(url, bodies, [[i] for i in range(8)])
        stats = engine.stats()
    check(all(s == 200 for _, s, _, _ in answers), "artifact statuses")
    check(all(n == 0 for n in kernel_counts().values()),
          f"the artifact launched {kernel_counts()}")
    stats_ds = DATASET_REGISTRY["uavid"]
    model = live_model
    if model is None:
        model = CABiNet(8, "large", attention="einsum")
        model.load_state_dict(load_state_dict(ckpt, model), strict=True)
    live = make_serving_fn(model, stats_ds.MEAN, stats_ds.STD, torch.bfloat16).to(DEVICE)
    rows = []
    with torch.no_grad():
        for xs, regime, out in batches:
            x = torch.zeros((regime, SERVE_SIZE, SERVE_SIZE, 3), dtype=torch.uint8,
                            device=DEVICE)
            for j, f in enumerate(xs):
                x[j] = resize_frame(torch.from_numpy(f).to(DEVICE), SERVE_SIZE)
            want = live(x)[:len(xs)].to(torch.uint8).cpu().numpy()
            check(np.array_equal(want, out), f"artifact batch (regime {regime}) "
                  f"differs from the live module on {int((want != out).sum())} pixels")
            rows += list(zip(xs, out))
    for i, _, mask, _ in answers:
        row = next(o for f, o in rows if np.array_equal(f, frames[i]))
        check(np.array_equal(mask, Segmenter._postprocess(torch.from_numpy(row),
                                                          frames[i].shape[:2])),
              f"artifact answer {i} is not its batch row")
    return {"server": stats, "batches": [(len(xs), r) for xs, r, _ in batches]}


def cold_start(ckpt: Path, loading: str) -> dict:
    """Where a fresh server process's first requests go, in a child with
    CUDA_MODULE_LOADING=`loading` (`cold_start_child`)."""
    code = ("import sys; sys.path.insert(0, %r); import chip_smoke; "
            "chip_smoke.cold_start_child(%r)" % (str(ROOT), str(ckpt)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "CUDA_MODULE_LOADING": loading})
    check(res.returncode == 0, f"cold start ({loading}) failed: {res.stderr[-2000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def cold_start_child(ckpt: str) -> None:
    """In a fresh process, host clock, each ending in a synchronize: the
    imports; the first CUDA call; the first cuBLAS and cuDNN calls (their
    handles and libraries); the kernels' ctypes loads; `_Engine`'s build
    with its first forward at each regime (`warmup_ms`: what each regime's
    first request would pay without it, the loads above aside); the first
    request after it and the next ones; then, after
    `torch.cuda.empty_cache()`, one forward per regime again (the
    allocator's growth alone: cuDNN's plans and the modules stay loaded)
    and once more warm. Prints one JSON line."""
    out = {}

    def lap(name, fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3
        return res

    t0 = time.perf_counter()
    import numpy as np
    import torch

    from cabinet_tpu_torch.cli.serve import _Engine, _regimes
    from cabinet_tpu_torch.ops import _build
    out["import_ms"] = (time.perf_counter() - t0) * 1e3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lap("cuda_init_ms", lambda: torch.zeros(1, device=DEVICE))
    a = torch.ones(64, 64, device=DEVICE)
    lap("cublas_first_ms", lambda: a @ a)
    lap("cudnn_first_ms", lambda: torch.nn.functional.conv2d(
        torch.ones(1, 3, 16, 16, device=DEVICE), torch.ones(4, 3, 3, 3, device=DEVICE)))
    lap("ctypes_load_ms", lambda: [_build.load(s) for s in _build.SOURCES])
    engine = lap("engine_ms", lambda: _Engine(
        None, ckpt, "uavid", "large", SERVE_SIZE, "bfloat16",
        max_batch=SERVE_MAX_BATCH, device=DEVICE))
    out["warmup_ms"] = engine.warmup_ms
    frame = np.random.default_rng(3).integers(0, 256, (SERVE_H, SERVE_W, 3), dtype=np.uint8)
    after = []
    for _ in range(4):
        t1 = time.perf_counter()
        engine.predict(frame)
        after.append((time.perf_counter() - t1) * 1e3)
    out["first_request_ms_after_warmup"], out["next_requests_ms"] = after[0], after[1:]
    blank = np.zeros((SERVE_SIZE, SERVE_SIZE, 3), np.uint8)
    step = engine.batcher.infer_batch
    for tag in ("after_empty_cache_ms", "warm_ms"):
        if tag == "after_empty_cache_ms":
            torch.cuda.empty_cache()
        out[tag] = {}
        for r in _regimes(SERVE_MAX_BATCH):
            t1 = time.perf_counter()
            step([blank], r)
            out[tag][r] = (time.perf_counter() - t1) * 1e3
    out["reserved_mib"] = torch.cuda.memory_reserved() / 2 ** 20
    engine.batcher.close()
    print(json.dumps(out), flush=True)


def run_serve(torch, paths, tmp: Path) -> dict:
    """Phase 11: export, the bf16 server, backpressure, the f32 server and
    the artifact server, each main path driven with the counts set to 0
    just before it; then a fresh process's first requests."""
    import numpy as np

    from cabinet_tpu_torch.data.decode import encode_png

    ckpt = tmp / "uavid_large_seeded.pth"
    seeded_uavid_checkpoint(torch, ckpt)
    art = tmp / "artifact"
    out = {}
    out["export_s"], out["artifact_bytes"] = paths.drive(
        "export_main", export_artifact, torch, ckpt, art)
    out.update(artifact_ms(torch, art, ckpt))

    frames = serve_frames(np, SERVE_FRAMES, SERVE_H, SERVE_W, seed=71)
    bodies = [encode_png(f) for f in frames]
    refs = plain_references(torch, ckpt, "fused_tail_early", torch.bfloat16, frames,
                            BOUND_FORWARD)
    out["bf16"] = paths.drive("serve_bf16", run_serve_bf16, torch, ckpt, bodies, refs)
    counts = paths.per_path["serve_bf16"]
    check(all(counts[k] > 0 for k in TAIL + ("stem_block0",)), f"serve bf16 launches {counts}")
    out["host"] = host_ms(np, bodies[0], refs[0][0])

    small = serve_frames(np, BUSY_FRAMES, BUSY_H, BUSY_W, seed=73)
    small_refs = plain_references(torch, ckpt, "fused_tail_early", torch.bfloat16,
                                  small, BOUND_FORWARD)
    out["backpressure"] = paths.drive("serve_backpressure", run_backpressure, torch,
                                      ckpt, [encode_png(f) for f in small], small_refs)

    refs_f32 = plain_references(torch, ckpt, "fused_early", torch.float32, frames[:8],
                                BOUND_FORWARD_F32)
    out["f32"] = paths.drive("serve_f32", run_serve_f32, torch, ckpt, bodies[:8], refs_f32)
    out["artifact"] = paths.drive("serve_artifact", run_artifact_server, torch, art,
                                  ckpt, frames[:8], bodies[:8])
    out["cold"] = {loading: cold_start(ckpt, loading) for loading in ("LAZY", "EAGER")}
    return out


def first_use(cold: dict) -> dict:
    """Where a fresh server's first requests go, summed over the regimes,
    ms: the allocator's growth (the first forward after `empty_cache`
    against a warm one), cuDNN's heuristics and the other first calls of a
    shape (the first forward against the one after `empty_cache`, with
    every module loaded at start-up), and the lazy module loads (the same
    difference with lazy loading, less the eager run's)."""
    def first_over_regrown(run):
        return sum(run["warmup_ms"].values()) - sum(run["after_empty_cache_ms"].values())

    lazy, eager = cold["LAZY"], cold["EAGER"]
    return {
        "allocator_growth_ms": sum(lazy["after_empty_cache_ms"].values())
        - sum(lazy["warm_ms"].values()),
        "cudnn_heuristics_and_first_calls_ms": first_over_regrown(eager),
        "lazy_module_loads_ms": first_over_regrown(lazy) - first_over_regrown(eager),
        "eager_module_loads_at_init_ms": eager["cuda_init_ms"] - lazy["cuda_init_ms"]}


def say_serve(smi: str, served: dict) -> None:
    bf16, host, busy = served["bf16"], served["host"], served["backpressure"]
    for loading, run in served["cold"].items():
        say("serve", part="cold_start", CUDA_MODULE_LOADING=loading, **run)
    say("serve", part="first_use", **first_use(served["cold"]))
    say("serve", card=smi, export_s=served["export_s"],
        artifact_bytes=served["artifact_bytes"],
        **{k: v for k, v in served.items() if k.endswith(("batch1", "batch8"))},
        requests_per_s=bf16["server"]["requests_per_s"],
        latency_ms_p50=bf16["server"]["latency_ms_p50"],
        latency_ms_p99=bf16["server"]["latency_ms_p99"],
        mean_batch_size=bf16["server"]["mean_batch_size"],
        batches=bf16["server"]["batches"],
        client_requests_per_s=bf16["client_requests_per_s"],
        client_latency_ms_p50=bf16["client_latency_ms_p50"],
        client_latency_ms_p99=bf16["client_latency_ms_p99"],
        worker_step_ms_p50_under_load=bf16["worker_step_ms_p50"],
        worker_step_ms_max_under_load=bf16["worker_step_ms_max"],
        worker_busy_share=bf16["worker_busy_share"],
        worker_step_ms_alone_fresh_process=served["cold"]["LAZY"]["warm_ms"],
        first_request_ms=bf16["first_request_ms"],
        solo_p50_ms_after_first=bf16["solo_p50_ms_after_first"],
        first_request_ms_fresh_process_after_warmup=served["cold"]["LAZY"][
            "first_request_ms_after_warmup"],
        first_forward_ms_fresh_process_by_regime=served["cold"]["LAZY"]["warmup_ms"],
        engine_start_s=bf16["engine_start_s"], agreement=bf16["least_agreement"],
        host_ms=host, responses_503=busy["responses_503"],
        responses_200=busy["responses_200"], close_s=busy["close_s"],
        f32_agreement=served["f32"]["least_agreement"],
        artifact_batches=served["artifact"]["batches"])


# ---------------------------------------------------------------------------
# Phase 12: the data layer, from a raw UAVid download to train and evaluate
# ---------------------------------------------------------------------------

# Raw UAVid as downloaded: sequences of 3840x2160 frames (train 2 x 4; val
# 1 x 2, as phase 10's split), label colours outside UAVid's table in
# DATA_UNKNOWN patches, and the train main runs per loader and recipe, in
# turns. At 2 steps an epoch these runs hold the batches and show each
# loader's start-up; `kernel_times.py --loader` times the loaders over 20
# steps in fresh processes.
DATA_SEQS = {"train": ("seq01", "seq02"), "val": ("seq03",)}
DATA_PER_SEQ = {"train": 4, "val": 2}
DATA_UNKNOWN = ((1, 2, 3), (250, 250, 250))
DATA_PATCH = 64
DATA_RUNS = 1  # thread and grain train mains per recipe, in turns
DATA_THREAD_EPOCHS = 1  # the thread mains' epochs (grain's 2): held on the first


def write_uavid_raw(np, src: Path, h: int, w: int, seed: int = 81):
    """A raw UAVid tree, <src>/<split>/<seq>/{Images,Labels}/<stem>.png:
    palette-task images stored so that UAVid's normalisation gives back the
    palette values plus noise, every row Paeth-filtered (`paeth_png`, the
    reader's slow case); labels in the class colours of the port's UAVid
    table, with patches of DATA_UNKNOWN colours; each frame encoded on a
    thread (`thread_pool`). Returns the u8 train images and every frame's
    class IDs (255 on the patches), by converted name."""
    from cabinet_tpu_torch.data.datasets import UAVid
    from cabinet_tpu_torch.data.decode import save_png
    from cabinet_tpu_torch.data.palettes import UAVID_CLASSES

    mean = np.asarray(UAVid.MEAN, np.float32)
    std = np.asarray(UAVid.STD, np.float32)
    colours = np.asarray([c["color"] for c in UAVID_CLASSES], np.uint8)
    rng = np.random.default_rng(seed)

    def frame(split, seq, stem, image, labels, patches):
        u8 = np.clip(np.rint(255.0 * (mean + std * image)), 0, 255).astype(np.uint8)
        rgb = colours[labels]
        want = labels.astype(np.uint8)
        for colour, (y, x) in zip(DATA_UNKNOWN, patches):
            rgb[y:y + DATA_PATCH, x:x + DATA_PATCH] = colour
            want[y:y + DATA_PATCH, x:x + DATA_PATCH] = 255
        paeth_png(np, src / split / seq / "Images" / f"{stem}.png", u8)
        save_png(src / split / seq / "Labels" / f"{stem}.png", rgb, compress_level=1)
        return split, f"{seq}_{stem}.png", u8, want

    jobs = []
    with thread_pool() as pool:
        for split, seqs in DATA_SEQS.items():
            for seq in seqs:
                for sub in ("Images", "Labels"):
                    (src / split / seq / sub).mkdir(parents=True)
                for k in range(DATA_PER_SEQ[split]):
                    image, labels = synthetic_palette(np, rng, h, w, 120)
                    patches = [(int(rng.integers(0, h - DATA_PATCH)),
                                int(rng.integers(0, w - DATA_PATCH))) for _ in DATA_UNKNOWN]
                    jobs.append(pool.submit(frame, split, seq, f"{100 * k:06d}", image,
                                            labels, patches))
    images, ids = {}, {}
    for job in jobs:
        split, name, u8, want = job.result()
        ids[(split, name)] = want
        if split == "train":
            images[name] = u8
    return images, ids


def plain_uavid_remap(np, rgb):
    """Class IDs of a UAVid colour label, one class colour at a time (the
    table's kept classes in trainId order), 255 elsewhere."""
    from cabinet_tpu_torch.data.palettes import UAVID_CLASSES

    key = (rgb[..., 0].astype(np.int32) << 16) | (rgb[..., 1].astype(np.int32) << 8) | rgb[..., 2]
    out = np.full(rgb.shape[:2], 255, np.uint8)
    kept = sorted((c for c in UAVID_CLASSES if not c["ignoreInEval"]), key=lambda c: c["trainId"])
    for i, c in enumerate(kept):
        r, g, b = c["color"]
        out[key == (r << 16 | g << 8 | b)] = i
    return out


def plain_stats_lines(np, images):
    """compute_stats' two lines from the images in memory, in file order."""
    mean, sq = np.zeros(3), np.zeros(3)
    for name in sorted(images):
        a = images[name].astype(np.float64) / 255.0
        mean += a.mean(axis=(0, 1))
        sq += (a ** 2).mean(axis=(0, 1))
    mean, sq = mean / len(images), sq / len(images)
    m = mean.astype(np.float32)
    s = np.sqrt(np.maximum(sq - mean ** 2, 0)).astype(np.float32)
    return [f"mean: ({m[0]:.3f}, {m[1]:.3f}, {m[2]:.3f})",
            f"std:  ({s[0]:.3f}, {s[1]:.3f}, {s[2]:.3f})"]


def run_convert_and_stats(np, src: Path, dst: Path, images, ids, workers: int):
    """cli.convert uavid and cli.compute_stats as a user runs them; every
    mask held against the plain remap of its label and the IDs it was drawn
    from, every image a link to its raw frame, the stats against the
    numpy recomputation. Returns the wall seconds of each."""
    from cabinet_tpu_torch.cli.compute_stats import main as stats_main
    from cabinet_tpu_torch.cli.convert import main as convert_main
    from cabinet_tpu_torch.data.decode import open_mask, open_rgb

    _, convert_s, lines = run_cli(convert_main, ["uavid", "--src", str(src), "--dst",
                                                 str(dst), "--workers", str(workers)],
                                  "convert")
    n = len(ids)
    check(lines[-2] == f"[DONE] Total masks written: {n}", f"cli.convert said {lines}")
    for split in DATA_SEQS:
        check(f"[INFO] {split}: converted {sum(s == split for s, _ in ids)} masks" in lines,
              f"cli.convert said {lines}")
    def held(item):  # a frame's mask and image link, checked on a thread
        (split, name), want = item
        mask = open_mask(dst / "masks" / split / name)
        seq, stem = name.split("_", 1)
        label = plain_uavid_remap(np, open_rgb(src / split / seq / "Labels" / stem))
        check(np.array_equal(label, want), f"{name}: the raw label does not hold its IDs")
        check(mask.shape == want.shape and np.array_equal(mask, want),
              f"{name}: {int((mask != want).sum())} converted mask pixels differ")
        img = dst / "images" / split / name
        check(img.is_symlink() and img.resolve() == (src / split / seq / "Images" / stem
                                                     ).resolve(), f"{img} is not its link")

    in_threads(held, ids.items())
    _, stats_s, lines = run_cli(stats_main, [str(dst / "images" / "train")], "stats")
    want = plain_stats_lines(np, images)
    check(lines == want, f"cli.compute_stats said {lines}, numpy {want}")
    return {"convert_seconds": convert_s, "compute_stats_seconds": stats_s,
            "masks": n, "stats": lines}


def cold_forkserver() -> None:
    """Stop the process loader's forkserver (it outlives its loaders), so
    that the next loader starts it afresh and pays what a new `python -m
    cabinet_tpu_torch.cli.train` pays: the server's import of torch and the
    datasets, then its workers."""
    from cabinet_tpu_torch.data.grain_loader import stop_servers

    stop_servers()


def processes_left() -> list:
    """The processes this run started that are still there: its children
    (running or not reaped) and any process that carries the run's mark in
    its environment (a grandchild, or an orphan)."""
    me, mark = os.getpid(), f"{RUN_MARK}={os.environ[RUN_MARK]}".encode()
    left = []
    for proc in Path("/proc").iterdir():
        if not proc.name.isdigit() or int(proc.name) == me:
            continue
        try:
            stat = (proc / "stat").read_text()
            env = (proc / "environ").read_bytes()
            cmd = (proc / "cmdline").read_bytes().replace(b"\0", b" ").decode()[:160]
        except OSError:  # gone meanwhile, or not ours to read
            continue
        state, ppid = stat.rsplit(")", 1)[1].split()[:2]
        if int(ppid) == me or mark in env.split(b"\0"):
            left.append(f"pid {proc.name} state {state}: {cmd}")
    return left


def stop_every_process(wait_s: float = 10.0) -> None:
    """Phase 17: stop the process loader's servers, give what is left a
    moment to end, and fail if any process this run started is still
    there."""
    cold_forkserver()
    deadline = time.monotonic() + wait_s
    while (left := processes_left()) and time.monotonic() < deadline:
        time.sleep(0.2)
    check(not left, f"processes left running: {left}")
    say("processes", left=0)


class BatchClock:
    """While entered, wraps every loader that `cli/common.py:make_loader`
    makes: for each pass, the host clock when each batch was asked for and
    when it came (`passes`, a list of [(asked, got), ...])."""

    def __init__(self) -> None:
        self.passes = []

    def __enter__(self):
        from cabinet_tpu_torch.cli import common

        self._common, self._make = common, common.make_loader
        common.make_loader = lambda *a, **kw: _Clocked(self._make(*a, **kw), self.passes)
        return self

    def __exit__(self, *exc) -> None:
        self._common.make_loader = self._make


def first_waits(passes):
    """Each pass's wait for its first batch (BatchClock's passes), s."""
    return [p[0][1] - p[0][0] for p in passes if p]


class _Clocked:
    def __init__(self, loader, passes) -> None:
        self.loader, self.passes = loader, passes

    def __len__(self) -> int:
        return len(self.loader)

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __iter__(self):
        stamps, it = [], iter(self.loader)
        self.passes.append(stamps)
        while True:
            asked = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                return
            stamps.append((asked, time.perf_counter()))
            yield batch


def grain_startup(dst: Path, workers: int, crop: int) -> dict:
    """A fresh process loader on the converted train split (host recipe,
    batch 4), its forkserver started afresh: the first batch of its first
    pass (server and workers started, records decoded) and of its second
    pass (decode only), host seconds."""
    from cabinet_tpu_torch.data.datasets import UAVid
    from cabinet_tpu_torch.data.grain_loader import GrainLoader

    def first_batch(epoch):
        grain.set_epoch(epoch)
        t0 = time.perf_counter()
        it = iter(grain)
        batch = next(it)
        seconds = time.perf_counter() - t0
        check(batch[0].shape == (4, crop, crop, 3), f"first batch {batch[0].shape}")
        for _ in it:  # the rest of the pass, so the next starts with none in flight
            pass
        return seconds

    ds = UAVid(255, str(dst), [crop, crop], mode="train")
    cold_forkserver()
    grain = GrainLoader(ds, 4, shuffle=True, drop_last=True, num_workers=workers, seed=15)
    try:
        fresh, warm = first_batch(0), first_batch(1)
    finally:
        grain.close()
    return {"grain_first_batch_s": fresh, "grain_next_pass_first_batch_s": warm,
            "grain_worker_startup_s": fresh - warm}


def recording_steps(trainer_mod, batches):
    """make_train_step whose steps keep a device copy of each batch they
    take (copied on the device; hashed after the run)."""
    make_step = trainer_mod.make_train_step

    def recording(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def recorded(state, images, labels):
            batches.append((images.clone(), labels.clone()))
            return step(state, images, labels)
        return recorded
    return recording


def data_train_run(torch, paths, name: str, argv, exp: Path, steps: int = 4) -> dict:
    """One `cli/train.py:main` run driven as a main path: the hashes of the
    batches its steps took, its losses, its loop's s per optimizer step and
    loader-wait share, and each epoch's wait for its first batch (with the
    process loader, the first holds the forkserver's and workers' start)."""
    import hashlib
    import math

    from cabinet_tpu_torch.cli.train import main as train_main
    from cabinet_tpu_torch.train import trainer as trainer_mod

    batches = []
    make_step = trainer_mod.make_train_step
    trainer_mod.make_train_step = recording_steps(trainer_mod, batches)
    try:
        with BatchClock() as clock:
            res, main_s, _ = paths.drive(name, run_cli, train_main, argv + [
                f"training_config.experiments_path={exp}", "--device", DEVICE], "train", 2)
    finally:
        trainer_mod.make_train_step = make_step
    hashes = [hashlib.sha1(x.cpu().numpy().tobytes() + y.cpu().numpy().tobytes()).hexdigest()
              for x, y in batches]
    del batches
    lines = [json.loads(ln) for ln in (exp / "metrics.jsonl").read_text().splitlines()
             if '"epoch"' in ln]
    t = res["timing"]
    out = {"main_seconds": main_s,
           "loop_seconds_per_optimizer_step": t["train_seconds"] / t["optimizer_steps"],
           "loader_wait_share": t["loader_wait_seconds"] / t["train_seconds"],
           "loader_wait_seconds": t["loader_wait_seconds"], "train_seconds": t["train_seconds"],
           "optimizer_steps": t["optimizer_steps"],
           "epoch_first_batch_wait_seconds": first_waits(clock.passes),
           "train_losses": [ln["train_loss"] for ln in lines],
           "k1_launches": paths.per_path[name]["attention"], "hashes": hashes}
    say("data", part="train_main", run=name,
        **{k: v for k, v in out.items() if k != "hashes"}, batch_sha1=[h[:12] for h in hashes])
    check(t["optimizer_steps"] == steps and len(hashes) == steps,
          f"{name}: {t['optimizer_steps']} steps, {len(hashes)} batches")
    check(all(math.isfinite(v) for v in out["train_losses"]), f"{name}: losses {lines}")
    check(out["k1_launches"] > 0, f"{name}: K1 never launched")
    return out


DATA_RECIPES = {"host": [], "canvas": ["runtime.device_geometric=true"]}


def data_train_argv(dst: Path, recipe: str, loader: str, epochs: int = 2):
    """train main's overrides for a phase 12 run: train.yaml's apart from
    the epochs, warmup 2, log_iter 1, one eval scale, use_pallas and the
    crop; the recipe's (DATA_RECIPES) and the loader."""
    crop = [f"dataset.cropsize=[{AUG_CROP},{AUG_CROP}]"] if AUG_CROP != EVAL_MAIN_CROP else []
    return ["dataset=uavid", f"dataset.dataset_path={dst}", f"training_config.epochs={epochs}",
            "training_config.warmup_steps=2", "training_config.log_iter=1",
            "runtime.use_pallas=true", "validation_config.eval_scales=[1.0]", *crop,
            *DATA_RECIPES[recipe], f"runtime.loader={loader}"]


def run_data(torch, paths, tmp: Path) -> dict:
    """Phase 12: raw UAVid -> cli.convert -> cli.compute_stats -> train main
    with the thread and the process loader in turns (host recipe and the
    device canvas) -> evaluate main on the EMA weights with each loader."""
    import numpy as np

    cores = len(os.sched_getaffinity(0))
    src, dst = tmp / "uavid_raw", tmp / "uavid"
    t0 = time.perf_counter()
    images, ids = write_uavid_raw(np, src, UAVID_H, UAVID_W)
    say("data", part="raw_tree", cores=cores, frames=len(ids), size=f"{UAVID_W}x{UAVID_H}",
        write_seconds=time.perf_counter() - t0)
    tools = run_convert_and_stats(np, src, dst, images, ids, cores)
    del images, ids
    say("data", part="tools", **tools)
    startup = grain_startup(dst, 8, AUG_CROP)
    say("data", part="startup", cores=cores, workers=8, **startup)

    crop = [f"dataset.cropsize=[{AUG_CROP},{AUG_CROP}]"] if AUG_CROP != EVAL_MAIN_CROP else []
    runs = {}
    for recipe in DATA_RECIPES:
        for k, loader in enumerate(("thread", "grain") * DATA_RUNS):
            name = f"data_{recipe}_{loader}_{k}"
            if loader == "grain":
                cold_forkserver()
            epochs = DATA_THREAD_EPOCHS if loader == "thread" else 2
            runs[name] = data_train_run(torch, paths, name,
                                        data_train_argv(dst, recipe, loader, epochs),
                                        tmp / f"exp_{name}", steps=2 * epochs)
        first = runs[f"data_{recipe}_thread_0"]["hashes"]
        differ = [n for n, r in runs.items()
                  if recipe in n and r["hashes"][:len(first)] != first]
        check(not differ, f"{recipe}: batches differ from the thread loader's in {differ}")

    ckpt = tmp / "exp_data_host_grain_1" / "cabinet.pth"
    evals = {}
    for loader in ("thread", "grain"):
        name = f"data_evaluate_{loader}"
        if loader == "grain":
            cold_forkserver()
        res, _, main_s = paths.drive(name, run_main, [
            "dataset=uavid", f"dataset.dataset_path={dst}", f"checkpoint_path={ckpt}",
            "validation_config.batch_size=1", "runtime.compute_dtype=bfloat16", *crop,
            "runtime.use_pallas=true", f"runtime.loader={loader}", "--device", DEVICE])
        counts = paths.per_path[name]
        check(all(counts[k] > 0 for k in TAIL), f"{name}: launches {counts}")
        t = res["timing"]
        first = t["loader_wait_seconds_per_batch"][0]
        evals[loader] = {"hist": res["confusion_matrix"], "mIoU": res["mIoU"],
                         "frames": t["frames"], "main_seconds_per_frame": main_s / t["frames"],
                         "loop_seconds_per_frame": t["seconds"] / t["frames"],
                         "first_frame_wait_seconds": first,
                         "loop_seconds_per_frame_after_first": (t["seconds"] - first)
                         / max(t["frames"] - 1, 1),
                         "loader_wait_seconds": t["loader_wait_seconds"],
                         "loader_wait_share": t["loader_wait_seconds"] / t["seconds"]}
        say("data", part="evaluate_main", run=name, launches=counts,
            **{k: v for k, v in evals[loader].items() if k != "hist"})
    check(evals["grain"]["frames"] == len(DATA_SEQS["val"]) * DATA_PER_SEQ["val"],
          f"evaluate main scored {evals['grain']['frames']} frames")
    check(np.array_equal(evals["grain"]["hist"], evals["thread"]["hist"]),
          "evaluate main: the process loader's confusion matrix differs from the thread's")
    return {"cores": cores, "tools": tools, "startup": startup, "runs": runs,
            "evaluate": {k: {x: y for x, y in v.items() if x != "hist"}
                         for k, v in evals.items()}}


def say_data(smi: str, data: dict) -> None:
    by = {}
    for name, r in data["runs"].items():
        _, recipe, loader, _ = name.split("_")
        key = f"{recipe}_{loader}"
        by.setdefault(f"{key}_loop_seconds_per_optimizer_step", []).append(
            r["loop_seconds_per_optimizer_step"])
        by.setdefault(f"{key}_loader_wait_share", []).append(r["loader_wait_share"])
        by.setdefault(f"{key}_epoch_first_batch_wait_seconds", []).append(
            r["epoch_first_batch_wait_seconds"])
    say("data", card=smi, cores=data["cores"],
        convert_seconds=data["tools"]["convert_seconds"],
        compute_stats_seconds=data["tools"]["compute_stats_seconds"],
        grain_worker_startup_s=data["startup"]["grain_worker_startup_s"], **by,
        **{f"evaluate_{k}_{x}": v[x] for k, v in data["evaluate"].items()
           for x in ("main_seconds_per_frame", "first_frame_wait_seconds",
                     "loop_seconds_per_frame_after_first", "loader_wait_share")})


# ---------------------------------------------------------------------------
# Phase 13: int8 post-training quantization
# ---------------------------------------------------------------------------

QUANT_FRAMES = 2  # the first frames of phase 7's split
QUANT_SITES = {"int8": 46, "int8dw": 64}  # CABiNet-Large's, as JAX counts them
QUANT_ROUNDS = 2


def check_int8_sites(torch, size: int = EVAL_MAIN_CROP, batches=(1, 8)):
    """Every int8dw site of CABiNet-Large (the trained fixture's weights)
    at its input shape in a size^2 forward, at each batch: the same bf16
    input on the card and on the CPU gives equal int8 inputs, equal sums
    (int32 from `torch._int_mm`, or the depthwise f32 convolution of the
    integers) and equal outputs, bit for bit. The FFM's 1x1 maps take the
    padded GEMM rows. Returns the count of sites and the largest |sum|."""
    import copy

    from cabinet_tpu_torch.quant import Int8Site, quantization_sites

    model = fixture_model(torch, "einsum").eval()
    sites = quantization_sites(model, quantize_depthwise=True)
    check(len(sites) == QUANT_SITES["int8dw"], f"{len(sites)} int8dw sites")
    shapes = {}

    def shape_of(name):
        def hook(mod, args):
            shapes[name] = tuple(args[0].shape[1:])
        return hook

    hooks = [m.register_forward_pre_hook(shape_of(n)) for n, m in sites.items()]
    with torch.no_grad():
        model(torch.zeros(1, 3, size, size))
    for h in hooks:
        h.remove()
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    largest = 0
    for name, conv in sites.items():
        for b in batches:
            x_d = torch.randn((b, *shapes[name]), generator=gen, device=DEVICE).to(torch.bfloat16)
            x = x_d.cpu()
            site = Int8Site(conv, float(x.float().abs().max()) / 127.0)
            site_d = copy.deepcopy(site).to(DEVICE)
            xq, xq_d = site.quantize_input(x), site_d.quantize_input(x_d)
            check(torch.equal(xq_d.cpu(), xq), f"{name} batch {b}: int8 inputs differ")
            sums, sums_d = site.sums(xq), site_d.sums(xq_d)
            check(torch.equal(sums_d.cpu(), sums), f"{name} batch {b}: sums differ "
                  f"({site.depthwise and 'depthwise' or 'dense'})")
            check(torch.equal(site_d(x_d).cpu(), site(x)), f"{name} batch {b}: outputs differ")
            largest = max(largest, int(sums.abs().max()))
            del x_d, x, xq, xq_d, sums, sums_d
    say("quant", part="sites", sites=len(sites), size=size, batches=list(batches),
        largest_abs_sum=largest)
    return {"sites": len(sites), "largest_abs_sum": largest}


def quant_main_run(torch, paths, name: str, argv) -> dict:
    """`cli/evaluate.py:main(argv)` as one main path; its result, host s and
    printed lines."""
    from cabinet_tpu_torch.cli.evaluate import main as evaluate_main

    (res, seconds, lines) = paths.drive(name, run_cli, evaluate_main, argv, "main")
    return {"res": res, "seconds": seconds, "lines": lines,
            "counts": paths.per_path[name]}


def run_quant_evaluate(torch, paths, root: Path, crop: int = EVAL_MAIN_CROP) -> dict:
    """Phase 13b: evaluate main in bf16 with runtime.use_pallas=true on the
    trained fixture over `root` (evaluate.yaml's six scales with flip,
    crop 1024, batch 1): float, then +runtime.quantize=int8 and =int8dw,
    then int8dw with runtime.loader=grain, then float again (its matrix
    the first float run's). Each quantized run: its count of
    quantized convs printed, K2 and K3 on every tile forward as in the
    float run, K1 on those and on each of the 2 calibration forwards, no
    K4; at most 0.5% of the pixels moved and |delta mIoU| < 0.01 against
    the float run; the grain run's matrix equal to the thread run's."""
    import numpy as np

    base = [f"checkpoint_path={FIXTURE}", "dataset=cityscapes", "dataset.num_classes=5",
            f"dataset.dataset_path={root}", "validation_config.batch_size=1",
            "runtime.compute_dtype=bfloat16", "runtime.use_pallas=true"]
    if crop != EVAL_MAIN_CROP:
        base.append(f"dataset.cropsize=[{crop},{crop}]")
    runs = {"float": quant_main_run(torch, paths, "quant_evaluate_float",
                                    base + ["--device", DEVICE])}
    flt = runs["float"]
    tiles = flt["counts"]["ffm_pointwise"]
    check(tiles > 0 and flt["counts"]["attention"] == tiles == flt["counts"]["head_conv3x3"],
          f"float evaluate main launches {flt['counts']}")
    pixels = float(flt["res"]["confusion_matrix"].sum())
    for mode, loader in (("int8", "thread"), ("int8dw", "thread"), ("int8dw", "grain")):
        key = mode if loader == "thread" else f"{mode}_{loader}"
        if loader == "grain":
            cold_forkserver()
        run = quant_main_run(torch, paths, f"quant_evaluate_{key}", base + [
            f"+runtime.quantize={mode}", f"runtime.loader={loader}", "--device", DEVICE])
        runs[key] = run
        counts, res = run["counts"], run["res"]
        line = f"int8 PTQ: {QUANT_SITES[mode]} convs quantized, calibrated on 2 batches"
        check(any(line in ln for ln in run["lines"]), f"{key}: no '{line}' printed")
        check(counts["ffm_pointwise"] == counts["head_conv3x3"] == tiles
              and counts["attention"] == tiles + 2
              and counts["attention_f32"] == 0 and counts["stem_block0"] == 0,
              f"{key}: launches {counts}, float run {flt['counts']}")
        moved = float(np.abs(res["confusion_matrix"] - flt["res"]["confusion_matrix"]).sum() / 2)
        run["moved_share"] = moved / pixels
        run["delta_mIoU"] = res["mIoU"] - flt["res"]["mIoU"]
        say("quant", part="evaluate_main", run=key, mIoU=res["mIoU"],
            float_mIoU=flt["res"]["mIoU"], moved_share=run["moved_share"],
            main_seconds_per_frame=run["seconds"] / res["timing"]["frames"],
            launches=counts)
        check(run["moved_share"] <= 5e-3 and abs(run["delta_mIoU"]) < 0.01,
              f"{key}: {moved} of {pixels} pixels moved, mIoU {res['mIoU']} against "
              f"{flt['res']['mIoU']}")
    check(np.array_equal(runs["int8dw_grain"]["res"]["confusion_matrix"],
                         runs["int8dw"]["res"]["confusion_matrix"]),
          "int8dw: the process loader's confusion matrix differs from the thread's")
    # float once more, last: the first run of the phase pays first-use costs
    runs["float_again"] = quant_main_run(torch, paths, "quant_evaluate_float_again",
                                         base + ["--device", DEVICE])
    check(runs["float_again"]["counts"] == flt["counts"]
          and np.array_equal(runs["float_again"]["res"]["confusion_matrix"],
                             flt["res"]["confusion_matrix"]),
          f"float evaluate main again: launches {runs['float_again']['counts']}, or "
          f"another confusion matrix")
    frames = flt["res"]["timing"]["frames"]
    return {k: {"main_seconds_per_frame": r["seconds"] / frames, "mIoU": r["res"]["mIoU"],
                **({"moved_share": r["moved_share"]} if "moved_share" in r else {})}
            for k, r in runs.items()}


def run_quant_export(torch, paths, root: Path, tmp: Path) -> dict:
    """Phase 13c: `cli/export.py --quantize int8dw --calib` on the split's
    frames (seeded uavid weights, Large, 1024^2, bf16, symbolic batch,
    --check bit-exact on the card); then the checkpoint-less server on
    that artifact answers 8 requests, each batch bit-equal to the live
    quantized module calibrated as the CLI calibrates."""
    import glob

    import numpy as np

    from cabinet_tpu_torch.cli import export as cli_export
    from cabinet_tpu_torch.cli.infer import load_state_dict
    from cabinet_tpu_torch.data.datasets import DATASET_REGISTRY
    from cabinet_tpu_torch.data.decode import encode_png
    from cabinet_tpu_torch.models.cabinet import CABiNet
    from cabinet_tpu_torch.quant import make_quantized_apply

    ckpt, art = tmp / "uavid_large_seeded.pth", tmp / "artifact_int8dw"
    seeded_uavid_checkpoint(torch, ckpt)
    calib = str(root / "leftImg8bit" / "val" / "*" / "*.png")
    _, seconds, lines = paths.drive("quant_export_main", run_cli, cli_export.main, [
        "--checkpoint", str(ckpt), "--dataset", "uavid", "--out", str(art),
        "--imgsz", str(SERVE_SIZE), "--batch", "b", "--mode", "large",
        "--dtype", "bfloat16", "--device", DEVICE, "--check",
        "--quantize", "int8dw", "--calib", calib], "export")
    check(any(f"calibrated {QUANT_SITES['int8dw']} conv sites on {QUANT_FRAMES} frames" in ln
              for ln in lines), "export: calibration line")
    check(any("round-trip check passed" in ln for ln in lines), "export --check (int8dw)")
    model = CABiNet(8, "large", attention="einsum")
    model.load_state_dict(load_state_dict(ckpt, model), strict=True)
    stats = DATASET_REGISTRY["uavid"]
    scales = cli_export.calibrate(model, sorted(glob.glob(calib))[:16], stats.MEAN,
                                  stats.STD, SERVE_SIZE, torch.bfloat16,
                                  torch.device(DEVICE), depthwise=True)
    frames = serve_frames(np, 8, SERVE_H, SERVE_W, seed=75)
    served = paths.drive("quant_serve_artifact", run_artifact_server, torch, art, ckpt,
                         frames, [encode_png(f) for f in frames],
                         make_quantized_apply(model, scales))
    return {"export_s": seconds, "artifact_bytes": sum(f.stat().st_size for f in art.iterdir()),
            "batches": served["batches"]}


def time_quant_forwards(torch, size: int = EVAL_MAIN_CROP, rounds: int = QUANT_ROUNDS):
    """bf16 fused-tail forward (K1-K3) of the trained fixture at size^2,
    ms/img float, int8 and int8dw (scales calibrated on the palette
    images), at batch 1 and 8, timed in turns within this call: `rounds`
    of (float, int8, int8dw, int8dw, int8, float), back to back (`ms`) and
    replayed from a CUDA graph (`device_ms`). Per batch and timer, each
    mode's median."""
    import statistics

    from cabinet_tpu_torch.models.fused import make_fused_tail_apply
    from cabinet_tpu_torch.quant import collect_act_scales, make_quantized_apply

    images = palette_images(torch, size)
    calib = images.to(DEVICE).to(torch.bfloat16).permute(0, 3, 1, 2)
    fwds = {"float": make_fused_tail_apply(fixture_model(torch), DEVICE, torch.bfloat16)}
    for mode in ("int8", "int8dw"):
        model = fixture_model(torch)
        scales = collect_act_scales(fixture_model(torch).to(DEVICE, torch.bfloat16), [calib],
                                    quantize_depthwise=mode == "int8dw")
        fwds[mode] = make_fused_tail_apply(make_quantized_apply(model, scales), DEVICE,
                                           torch.bfloat16)
    gen = torch.Generator(device=DEVICE).manual_seed(17)
    x = torch.randn(8, size, size, 3, generator=gen, device=DEVICE).to(torch.bfloat16)
    out = {}
    for b in (1, 8):
        ms = {(t, m): [] for t in ("ms", "device_ms") for m in fwds}
        for _ in range(rounds):
            for mode in ("float", "int8", "int8dw", "int8dw", "int8", "float"):
                fn = lambda: fwds[mode](x[:b])  # noqa: E731
                ms["ms", mode].append(time_ms(fn, iters=5) / b)
                ms["device_ms", mode].append(graph_ms(fn, iters=2, warmup=1, replays=3) / b)
        for t in ("ms", "device_ms"):
            out[f"batch{b}_{t}"] = {m: statistics.median(ms[t, m]) for m in fwds}
            say("quant", part="forward_ms_per_img_in_turns", batch=b, timer=t,
                **{m: ms[t, m] for m in fwds})
    return out


def run_quant(torch, paths, tmp: Path) -> dict:
    """Phase 13: (a) the int8 sites card against CPU, (b) evaluate main
    float / int8 / int8dw / int8dw on the process loader, (c) the int8dw
    export and the server on it, (d) the forwards' ms/img."""
    import numpy as np

    out = {"sites": check_int8_sites(torch)}
    root = tmp / "cityscapes"
    write_city_split(np, root, QUANT_FRAMES, FRAME_H, FRAME_W)
    out["evaluate"] = run_quant_evaluate(torch, paths, root)
    out["export"] = run_quant_export(torch, paths, root, tmp)
    out["forward"] = time_quant_forwards(torch)
    return out


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Phase 14: the YOLO-sem family (no kernel on its path)
# ---------------------------------------------------------------------------

YOLO_VARIANTS = "nsmlx"
YOLO_CHECK_SIZE, YOLO_SIZE = 256, 1024
BOUND_YOLO_F32 = 1e-4  # card against CPU in f32 (TF32 off), of max |cpu|
YOLO_WIDE_STEPS = 4


def check_yolo_forwards(torch) -> dict:
    """Phase 14a: every variant's f32 forward (seeded weights) on the card
    against the CPU at YOLO_CHECK_SIZE^2, batch 1, logits and aux; then the
    bf16 forward ms/img of yolo26n-sem and yolo26x-sem at 1024^2, batch 1
    and 8, back to back (`ms`) and replayed from a CUDA graph
    (`device_ms`)."""
    from cabinet_tpu_torch.models.yolosem import YOLOSem

    x = torch.randn(1, 3, YOLO_CHECK_SIZE, YOLO_CHECK_SIZE,
                    generator=torch.Generator().manual_seed(41))
    errs = {}
    for v in YOLO_VARIANTS:
        torch.manual_seed(40)
        model = YOLOSem(8, v).eval()
        with torch.no_grad():
            ref = model(x)
            got = model.to(DEVICE)(x.to(DEVICE))
        errs[v] = max(e / m for e, m in (max_err(g.cpu(), r) for g, r in zip(got, ref)))
        check(errs[v] <= BOUND_YOLO_F32, f"yolo26{v}-sem f32 card vs CPU: {errs[v]} of max")
    say("yolo", part="f32_card_vs_cpu", size=YOLO_CHECK_SIZE, rel_err=errs,
        bound=BOUND_YOLO_F32)
    gen = torch.Generator(device=DEVICE).manual_seed(43)
    x8 = torch.randn(8, 3, YOLO_SIZE, YOLO_SIZE, generator=gen, device=DEVICE).to(torch.bfloat16)
    out = {}
    for v in ("n", "x"):
        torch.manual_seed(44)
        model = YOLOSem(8, v).to(DEVICE, torch.bfloat16).eval()
        with torch.no_grad():
            for b in (1, 8):
                fn = lambda: model(x8[:b])  # noqa: E731
                out[f"{v}_batch{b}_ms_per_img"] = time_ms(fn, iters=10) / b
                out[f"{v}_batch{b}_device_ms_per_img"] = graph_ms(fn, iters=3, warmup=2,
                                                                  replays=3) / b
        del model
    say("yolo", part="bf16_forward", size=YOLO_SIZE, **out)
    return {"f32_rel_err": errs, **out}


def yolo_train_argv(dst: Path, exp: Path, epochs: int, *extra) -> list:
    """train_yolo main's overrides for phase 14: train_yolo.yaml's
    yolo26n-sem (imgsz YOLO_SIZE = 1024, batch 4, bf16, 8 loader workers) with nbs 8
    (accum 2), close_mosaic 1 and the process loader."""
    return ["dataset=uavid", f"dataset.dataset_path={dst}", f"training_config.imgsz={YOLO_SIZE}",
            "training_config.batch_size=4", "runtime.compute_dtype=bfloat16",
            "training_config.num_workers=8", "training_config.nbs=8",
            f"training_config.epochs={epochs}", "augmentation.close_mosaic=1",
            "+runtime.loader=grain", f"training_config.experiments_path={exp}", *extra,
            "--device", DEVICE]


def run_yolo_train(torch, paths, dst: Path, exp: Path) -> dict:
    """Phase 14b: `cli/train_yolo.py:main` on phase 12's converted UAVid
    tree, 2 epochs, then resume=true to epoch 3 (each with a cold process
    loader), then mode=val on the `final` EMA weights at UAVid's native
    3840x2160."""
    import math

    from cabinet_tpu_torch.cli.train_yolo import main as yolo_main

    runs = {}
    for name, epochs, extra in (("yolo_train_main", 2, []),
                                ("yolo_train_resume", 3, ["training_config.resume=true"])):
        cold_forkserver()
        torch.cuda.reset_peak_memory_stats()
        res, main_s, _ = paths.drive(name, run_cli, yolo_main,
                                     yolo_train_argv(dst, exp, epochs, *extra), "train_yolo", 4)
        t = res["timing"]
        runs[name] = {"main_seconds": main_s, "losses": res["losses"],
                      "best_miou": res["best_miou"], "micro_steps": t["micro_steps"],
                      "optimizer_steps": t["optimizer_steps"],
                      "loop_seconds_per_micro_step": t["train_seconds"] / t["micro_steps"],
                      "loop_seconds_per_optimizer_step": t["train_seconds"]
                      / max(t["optimizer_steps"], 1),
                      "loader_wait_share": t["loader_wait_seconds"] / t["train_seconds"],
                      "eval_seconds": t["eval_seconds"],
                      "class_count_seconds": t["class_count_seconds"],
                      "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        say("yolo", part="train_main", run=name, **runs[name])
        check(all(math.isfinite(v) for v in res["losses"]), f"{name}: losses {res['losses']}")
    check((runs["yolo_train_main"]["micro_steps"], runs["yolo_train_main"]["optimizer_steps"])
          == (4, 2), f"train main: {runs['yolo_train_main']}")
    check((runs["yolo_train_resume"]["micro_steps"], runs["yolo_train_resume"]["optimizer_steps"])
          == (2, 1), f"resume: {runs['yolo_train_resume']}")
    res, val_s, lines = paths.drive("yolo_val_main", run_cli, yolo_main, yolo_train_argv(
        dst, exp, 3, "mode=val", f"weights={exp / 'final'}"), "val", 3)
    check(0.0 <= res["mIoU"] <= 1.0 and any("metrics.json snippet" in ln for ln in lines),
          f"val: {res['mIoU']}")
    runs["yolo_val_main"] = {"main_seconds": val_s, "mIoU": res["mIoU"],
                             "accuracy": res["accuracy"]}
    say("yolo", part="val_main", **runs["yolo_val_main"])
    return runs


def yolo_wide_steps(torch, steps: int = YOLO_WIDE_STEPS, batch: int = 4) -> dict:
    """Phase 14c: yolo26x-sem, the widest variant at full width: train
    steps (CE, aux 0.4, build_sgd, bf16 autocast) at batch 4, 1024^2, on
    one seeded batch; ms per step after one warm-up step, peak memory."""
    import math

    from cabinet_tpu_torch.models.yolosem import YOLOSem
    from cabinet_tpu_torch.train import trainer as T
    from cabinet_tpu_torch.train.optimizer import build_sgd, warmup_cosine_schedule

    torch.manual_seed(45)
    model = YOLOSem(8, "x").to(DEVICE)
    state = T.create_train_state(model, build_sgd(
        model, warmup_cosine_schedule(0.01, 0.01, 100), max_grad_norm=10.0))
    step = T.make_train_step(n_min=1, loss_type="ce", aux_weight=0.4,
                             compute_dtype=torch.bfloat16)
    gen = torch.Generator(device=DEVICE).manual_seed(46)
    x = torch.randn(batch, YOLO_SIZE, YOLO_SIZE, 3, generator=gen, device=DEVICE)
    y = torch.randint(0, 8, (batch, YOLO_SIZE, YOLO_SIZE), generator=gen, device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [step(state, x, y)[1]]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        losses.append(step(state, x, y)[1])
    end.record()
    torch.cuda.synchronize()
    out = {"variant": "x", "batch": batch, "size": YOLO_SIZE,
           "ms_per_step": start.elapsed_time(end) / steps,
           "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "losses": [float(v) for v in losses]}
    say("yolo", part="wide_steps", **out)
    check(all(math.isfinite(v) for v in out["losses"]), f"yolo26x-sem losses {out['losses']}")
    return out


def run_yolo_export(torch, paths, ckpt: Path, tmp: Path) -> dict:
    """Phase 14d: `cli/export.py --family yolosem` on the `final` weights
    (1024^2, bf16, symbolic batch, --check on the card), then the
    checkpoint-less server on that artifact answering 8 requests, each
    batch bit-equal to the live serving module."""
    import numpy as np

    from cabinet_tpu_torch.cli import export as cli_export
    from cabinet_tpu_torch.cli.infer import load_state_dict
    from cabinet_tpu_torch.data.decode import encode_png
    from cabinet_tpu_torch.models.yolosem import YOLOSem

    art = tmp / "artifact_yolo26n"
    _, seconds, lines = paths.drive("yolo_export_main", run_cli, cli_export.main, [
        "--family", "yolosem", "--variant", "n", "--checkpoint", str(ckpt),
        "--dataset", "uavid", "--out", str(art), "--imgsz", str(SERVE_SIZE), "--batch", "b",
        "--dtype", "bfloat16", "--device", DEVICE, "--check"], "export")
    check(any("round-trip check passed" in ln for ln in lines), "export --check (yolosem)")
    meta = json.loads((art / "metadata.json").read_text())
    check((meta["family"], meta["variant"]) == ("yolosem", "n"), f"metadata {meta}")
    model = YOLOSem(8, "n")
    model.load_state_dict(load_state_dict(ckpt, model), strict=True)
    frames = serve_frames(np, 8, SERVE_H, SERVE_W, seed=77)
    served = paths.drive("yolo_serve_artifact", run_artifact_server, torch, art, ckpt,
                         frames, [encode_png(f) for f in frames], model)
    out = {"export_s": seconds, "artifact_bytes": sum(f.stat().st_size for f in art.iterdir()),
           "batches": served["batches"]}
    say("yolo", part="export_serve", **out)
    return out


def run_yolo(torch, paths, dst: Path, tmp: Path) -> dict:
    """Phase 14: (a) the forwards, (b) train, resume and val mains on
    phase 12's converted tree `dst`, (c) yolo26x-sem's steps, (d) export
    and serve; (e) no kernel launched anywhere in the phase: every part
    runs as a driven path named yolo_*, so its launches are counted from 0
    and read just after it."""
    t0 = time.perf_counter()
    out = {"forward": paths.drive("yolo_forwards", check_yolo_forwards, torch)}
    exp = tmp / "exp_yolo"
    out["train"] = run_yolo_train(torch, paths, dst, exp)
    out["wide"] = paths.drive("yolo_wide_steps", yolo_wide_steps, torch)
    out["export"] = run_yolo_export(torch, paths, exp / "final.pth", tmp)
    launched = {k: c for k, c in paths.per_path.items()
                if k.startswith("yolo_") and any(c.values())}
    check(not launched, f"phase 14 launched kernels: {launched}")
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Phase 15: the tools (visualize, checkpoint conversion, profiler, legacy config)
# ---------------------------------------------------------------------------

VIZ_FRAMES = 2      # the first frames of phase 7's split
TRACE_FORWARDS = 10  # batch-8 forwards in the profiler's trace
PROFILE_SIZE = 1024  # Segmenter's imgsz under the profiler


def visualize_reference(torch, argv, frames: int):
    """The colours of evaluate's argmax on the first `frames` frames:
    `MscEval` over `make_eval_forward`, built from the config as
    `cli/evaluate.py:evaluate_checkpoint` builds them."""
    from cabinet_tpu_torch.cli import common
    from cabinet_tpu_torch.cli.evaluate import make_eval_forward
    from cabinet_tpu_torch.core.config import compose
    from cabinet_tpu_torch.data.palettes import PALETTES, colorize_mask
    from cabinet_tpu_torch.eval.evaluator import MscEval

    cfg = compose(common.CONFIG_DIR, "evaluate", [a for a in argv if "=" in a])
    (dataset,) = common.build_datasets(cfg, ["val"])
    model = common.build_model(cfg, cfg.dataset.num_classes)
    model.load_state_dict(common.load_model_variables(cfg.checkpoint_path, model), strict=True)
    crop, dtype = max(cfg.dataset.cropsize), common.compute_dtype_of(cfg)
    vc = cfg.validation_config
    ev = MscEval(make_eval_forward(model, crop, DEVICE, dtype, use_pallas=True),
                 cfg.dataset.num_classes, ignore_label=cfg.dataset.ignore_idx,
                 scales=tuple(vc.eval_scales), flip=bool(vc.flip), cropsize=crop,
                 compute_dtype=dtype, tile_batch=common.eval_tile_batch(cfg),
                 acc_dtype=common.eval_acc_dtype(cfg), device=DEVICE)
    out = []
    for i in range(frames):
        image, labels = dataset[i]
        preds, _ = ev.evaluate_batch(None, image[None], labels[None])
        out.append(colorize_mask(preds[0], PALETTES[cfg.dataset.name]))
    return out


def run_visualize(torch, paths, ckpt: Path, frames_root: Path, out: Path) -> dict:
    """`cli/visualize.py:main` on the EMA weights over phase 7's frames
    (bf16, use_pallas, evaluate.yaml's six scales with flip): the four
    PNGs of each frame, the pred PNG equal to evaluate's argmax colours,
    K1-K3 launched and no K4 or f32 K1."""
    import numpy as np

    from cabinet_tpu_torch.cli.visualize import main as visualize_main
    from cabinet_tpu_torch.data.decode import open_rgb

    argv = ["dataset=cityscapes", f"dataset.dataset_path={frames_root}",
            f"checkpoint_path={ckpt}", "runtime.compute_dtype=bfloat16",
            "runtime.use_pallas=true", f"+num_samples={VIZ_FRAMES}", f"+output_dir={out}"]
    if EVAL_MAIN_CROP != 1024:
        argv.append(f"dataset.cropsize=[{EVAL_MAIN_CROP},{EVAL_MAIN_CROP}]")
    _, seconds, _ = paths.drive("tools_visualize", run_cli, visualize_main,
                                argv + ["--device", DEVICE], "visualize", 2)
    counts = paths.per_path["tools_visualize"]
    check(all(counts[k] > 0 for k in TAIL), f"visualize launched {counts}")
    check(counts["attention_f32"] == 0 and counts["stem_block0"] == 0,
          f"visualize launched the f32 K1 or K4: {counts}")
    names = sorted(p.name for p in out.iterdir())
    want = sorted(f"{i:04d}_{k}.png" for i in range(VIZ_FRAMES)
                  for k in ("input", "pred", "overlay", "gt"))
    check(names == want, f"visualize wrote {names}")
    refs = visualize_reference(torch, argv, VIZ_FRAMES)
    same = [float((open_rgb(out / f"{i:04d}_pred.png") == ref).all(-1).mean())
            for i, ref in enumerate(refs)]
    res = {"main_seconds": seconds, "seconds_per_frame": seconds / VIZ_FRAMES,
           "launches": counts, "pred_equal_share": same}
    say("tools", part="visualize", **res)
    check(min(same) == 1.0, f"visualize's pred PNGs differ from evaluate's argmax: {same}")
    check(all(np.asarray(open_rgb(out / n)).shape == (FRAME_H, FRAME_W, 3) for n in names),
          "visualize's PNGs are not the frames' size")
    return res


def run_convert_round_trip(torch, ckpt: Path, tmp: Path, n_classes: int) -> dict:
    """`cli/convert_checkpoint.py` export then import of a `.pth`: every
    tensor back bit for bit, the result loaded strict into CABiNet-Large."""
    from cabinet_tpu_torch.cli.convert_checkpoint import main as convert_main
    from cabinet_tpu_torch.models.cabinet import CABiNet

    t0 = time.perf_counter()
    run_cli(convert_main, ["export", str(ckpt), str(tmp / "reference.pth"), "--mode", "large",
                           "--n-classes", str(n_classes)], "convert", 1)
    t1 = time.perf_counter()
    run_cli(convert_main, ["import", str(tmp / "reference.pth"), str(tmp / "back.pth")],
            "convert", 1)
    t2 = time.perf_counter()
    orig = torch.load(ckpt, map_location="cpu")
    back = torch.load(tmp / "back.pth", map_location="cpu")
    floats = [k for k, v in orig.items() if v.is_floating_point()]
    differ = [k for k in floats if k not in back or not torch.equal(back[k], orig[k])]
    model = CABiNet(n_classes, "large")
    nbt = {k: v for k, v in model.state_dict().items() if k.endswith("num_batches_tracked")}
    model.load_state_dict({**nbt, **back}, strict=True)
    res = {"export_s": t1 - t0, "import_s": t2 - t1, "tensors": len(back),
           "reference_mb": (tmp / "reference.pth").stat().st_size / 1e6}
    say("tools", part="convert_checkpoint", **res)
    check(not differ and len(back) == len(floats),
          f"checkpoint round trip: {len(differ)} tensors differ, {len(back)} of {len(floats)}")
    return res


def plain_flops(torch, ckpt: Path, x) -> int:
    """FlopCounterMode's count of the plain route's forward: the seeded
    model with the einsum attention, its own forward, bf16."""
    from torch.utils.flop_counter import FlopCounterMode

    from cabinet_tpu_torch.cli.infer import load_state_dict
    from cabinet_tpu_torch.models.cabinet import CABiNet

    model = CABiNet(8, "large", attention="einsum")
    model.load_state_dict(load_state_dict(ckpt, model), strict=True)
    model.to(device=DEVICE, dtype=torch.bfloat16).eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(x.to(torch.bfloat16).permute(0, 3, 1, 2))
    del model
    return counter.get_total_flops()


def run_profiler(torch, paths, peaks, ckpt: Path, tmp: Path) -> dict:
    """`PerformanceProfiler.run_full_benchmark` on Segmenter's bf16 forward
    at batch 1 (K1-K3) and 8 (K1-K4), its FLOPs equal to FlopCounterMode's
    count of the plain route; then `trace` of TRACE_FORWARDS batch-8
    forwards: the top 10 device ops and the device's busy share."""
    from cabinet_tpu_torch.cli.infer import Segmenter
    from cabinet_tpu_torch.utils.profiler import PerformanceProfiler

    out = {}
    prof = PerformanceProfiler(warmup=3, repeats=5, chain=10)
    for batch, kernels in ((1, TAIL), (8, TAIL + ("stem_block0",))):
        seg = Segmenter(str(ckpt), "uavid", mode="large", imgsz=PROFILE_SIZE,
                        dtype_name="bfloat16", batch=batch, device=DEVICE)
        gen = torch.Generator(device=DEVICE).manual_seed(batch)
        x = torch.randn(batch, PROFILE_SIZE, PROFILE_SIZE, 3, generator=gen, device=DEVICE)
        name = f"tools_profiler_batch{batch}"
        res = paths.drive(name, prof.run_full_benchmark,
                          lambda v, img: seg._forward(img), seg.model, x)
        counts = paths.per_path[name]
        check(all(counts[k] > 0 for k in kernels), f"{name} launched {counts}")
        check(set(prof.last_kernel_flops) == set(kernels),
              f"{name}: kernel FLOPs of {sorted(prof.last_kernel_flops)}")
        plain = plain_flops(torch, ckpt, x)
        lat = res["latency"]
        out[batch] = {
            "latency_ms": {k: lat[k] for k in ("mean_ms", "median_ms", "min_ms", "max_ms")},
            "fps": lat["fps"], "gflops": res["flops"]["gflops"],
            "kernel_gflops": {k: v / 1e9 for k, v in prof.last_kernel_flops.items()},
            "plain_route_gflops": plain / 1e9, "memory": res["memory"],
            "params_millions": res["params"]["total_millions"],
            "tflops_per_s": res["flops"]["flops"] / (lat["median_ms"] / 1e3) / 1e12,
            "share_of_bf16_peak": res["flops"]["flops"] / (lat["median_ms"] / 1e3)
            / peaks.flops}
        say("tools", part="profiler", batch=batch, launches=counts, **out[batch])
        check(res["flops"]["flops"] == plain,
              f"{name}: {res['flops']['flops']} FLOPs, the plain route's {plain}")
        if batch == 8:
            def traced():
                with torch.no_grad(), prof.trace(str(tmp / "trace")) as p:
                    for _ in range(TRACE_FORWARDS):
                        seg._forward(x)
                return prof.device_breakdown(p)
            brk = paths.drive("tools_trace", traced)
            out["trace"] = {**brk, "forwards": TRACE_FORWARDS,
                            "trace_mb": (tmp / "trace" / "trace.pt.trace.json").stat().st_size
                            / 1e6}
            say("tools", part="trace", batch=8, forwards=TRACE_FORWARDS,
                busy_share=brk["busy_share"], busy_ms=brk["busy_ms"],
                window_ms=brk["window_ms"], device_ops=brk["device_ops"])
            for op in brk["top_ops"]:
                print(f"  trace| {op['ms']:10.3f} ms {op['count']:6d}x  {op['name'][:110]}")
            check(brk["device_ops"] > 0 and brk["busy_share"] is not None,
                  "the profiler's trace holds no device op")
        del seg
    return out


def run_legacy_train(torch, paths, split: Path, exp: Path) -> dict:
    """`cli/train.py:main --legacy-config legacy/train_citys.json` (the
    reference's pre-Hydra Cityscapes config: Large, 19 classes, crop 1024,
    its optimizer numbers) on phase 9's split, cut to batch 4 and one
    epoch (2 optimizer steps) with one eval scale."""
    import math

    from cabinet_tpu_torch.cli.train import main as train_main

    argv = ["--legacy-config", str(ROOT / "legacy" / "train_citys.json"),
            f"dataset.dataset_path={split}", "training_config.batch_size=4",
            "training_config.epochs=1", "training_config.num_workers=8",
            "training_config.log_iter=1",
            f"training_config.experiments_path={exp}", "validation_config.eval_scales=[1.0]",
            "validation_config.flip=false", "runtime.use_pallas=true", "--device", DEVICE]
    res, seconds, _ = paths.drive("tools_legacy_train", run_cli, train_main, argv, "legacy", 2)
    from cabinet_tpu_torch.core.config import load_yaml

    config = load_yaml(exp / "config.yaml")
    lines = [json.loads(ln) for ln in (exp / "metrics.jsonl").read_text().splitlines()
             if '"epoch"' in ln]
    out = {"main_seconds": seconds, "optimizer_steps": res["timing"]["optimizer_steps"],
           "train_loss": lines[0]["train_loss"] if lines else None,
           "launches": paths.per_path["tools_legacy_train"]}
    say("tools", part="legacy_train", **out)
    check(out["optimizer_steps"] == 2, f"legacy train main took {out['optimizer_steps']} steps")
    check(out["train_loss"] is not None and math.isfinite(out["train_loss"]),
          f"legacy train main's loss {out['train_loss']}")
    tc = config["training_config"]
    check(tc["warmup_steps"] == 4000 and tc["max_iterations"] == 200000
          and config["model"]["mode"] == "large" and config["dataset"]["num_classes"] == 19,
          f"the legacy JSON did not reach config.yaml: {tc}")
    check((exp / "cabinet_citys_1024x1024.pth").is_file(),
          "legacy train main wrote no cabinet_citys_1024x1024.pth")
    return out


def run_tools(torch, paths, peaks, keep: Path, tmp: Path) -> dict:
    """Phase 15."""
    ema = keep / "train" / "experiment" / "cabinet.pth"
    seeded = tmp / "uavid_large_seeded.pth"
    seeded_uavid_checkpoint(torch, seeded)
    return {
        "visualize": run_visualize(torch, paths, ema, keep / "evaluate" / "cityscapes",
                                   tmp / "viz"),
        "convert": run_convert_round_trip(torch, ema, tmp, N_CLASSES_TRAIN),
        "profiler": run_profiler(torch, paths, peaks, seeded, tmp),
        "legacy": run_legacy_train(torch, paths, keep / "train" / "cityscapes",
                                   tmp / "legacy"),
    }


# ---------------------------------------------------------------------------
# Phase 16: data parallelism across processes
# ---------------------------------------------------------------------------

DP_TIMEOUT_S = 420
#  R=2 on gloo against R=1 on NCCL, one card, f32 with TF32 off, 4 steps at
#  1024² from the same seed: the first step's loss within 1e-5 of |R=1|,
#  the later ones' within 1e-3, and every tensor of the weights and the EMA within 0.1 of its own update
#  plus 4 f32 ulps of its magnitude plus 1e-4 of the largest update of its
#  kind, the card-vs-CPU bound of phase 8 (cuDNN picks other algorithms at
#  batch 2 than at 4, and the 2-rank BN merges the ranks' statistics where
#  one rank takes cuDNN's, so the sums differ in order; train-mode BN
#  amplifies that through the backward).
BOUND_DP_FIRST_LOSS = 1e-5  # the first step: the same weights and global batch
BOUND_DP_LOSS = 1e-3        # later steps, after updates that BN amplifies


THEN = "--then"  # separates the jobs of one `--rank-main` chain
SNAPSHOT_STEP = 2  # a train job's weights are kept after this step: its first epoch


def rank_main(args) -> int:
    """One rank under torchrun: `--rank-main MODULE OUT ARGV... [--then
    MODULE OUT ARGV...]...` runs each `cabinet_tpu_torch.cli.MODULE.main(
    ARGV)` in turn in this process, in one process group (the first main
    joins it, and the group is left after the last: a group destroyed and
    joined again can read the old group's addresses from the store), each
    train step (or pipeline window) timed by CUDA events and
    its collectives by `core/mesh.py`'s tally, the kernel launches counted
    inside the steps and in all, and writes each job's record to
    OUT/rank<r>.pt: a train main's weights and EMA, per-step losses and
    times; an evaluate main's confusion matrix, mIoU, timing and
    collectives."""
    import importlib

    import torch

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from cabinet_tpu_torch.core import mesh
    from cabinet_tpu_torch.train import trainer as trainer_mod

    jobs, job = [], []
    for a in args:
        if a == THEN:
            jobs.append(job)
            job = []
        else:
            job.append(a)
    jobs.append(job)
    make_step = trainer_mod.make_train_step
    teardown, mesh.teardown = mesh.teardown, lambda: None
    for module, out, *argv in jobs:
        cli = importlib.import_module(f"cabinet_tpu_torch.cli.{module}")
        inside = dict.fromkeys(_counters(), 0)
        held, steps, windows = {}, [], []

        def timed(*a, inside=inside, held=held, steps=steps, **k):
            step = make_step(*a, **k)

            def run(state, images, labels):
                before, comm = kernel_counts(), {t: dict(v) for t, v in mesh.COMM.items()}
                if images.is_cuda:
                    start, end = (torch.cuda.Event(enable_timing=True),
                                  torch.cuda.Event(enable_timing=True))
                    start.record()
                t0 = time.perf_counter()
                result = step(state, images, labels)
                if images.is_cuda:
                    end.record()
                    end.synchronize()
                ms = (start.elapsed_time(end) if images.is_cuda
                      else (time.perf_counter() - t0) * 1e3)
                for name, n in kernel_counts().items():
                    inside[name] += n - before[name]
                steps.append({"ms": ms, "loss": float(result[1]),
                              "collectives": mesh.comm_since(comm),
                              "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                                           if images.is_cuda else 0.0)})
                held["state"] = state
                if len(steps) == SNAPSHOT_STEP:
                    held["snapshot"] = merged_of({"state": state})
                return result
            return run

        trainer_mod.make_train_step = timed
        restore = recording_windows(torch, held, windows)
        reset_counts()
        comm0 = {t: dict(v) for t, v in mesh.COMM.items()}
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            res = cli.main(argv)
        finally:
            restore()
            trainer_mod.make_train_step = make_step
        for w in windows:
            steps.append(w)
            for name, n in w["launches"].items():
                inside[name] += n
        rank = int(os.environ.get("RANK", "0"))
        record = {"rank": rank, "seconds": time.perf_counter() - t0, "steps": steps,
                  "launches": kernel_counts(), "launches_in_steps": inside,
                  "peak_allocated_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                                         if torch.cuda.is_available() else 0.0),
                  "timing": res["timing"], "snapshot": held.get("snapshot"),
                  **(merged_of(held) if "state" in held or "states" in held else {})}
        if "confusion_matrix" in res:  # an evaluate main
            record["result"] = {"confusion_matrix": res["confusion_matrix"],
                                "mIoU": res["mIoU"], "timing": res["timing"],
                                "collectives": mesh.comm_since(comm0)}
        torch.save(record, Path(out) / f"rank{rank}.pt")
    teardown()
    return 0


def torchrun_jobs(torch, ranks: int, jobs) -> list:
    """`python -m torch.distributed.run --standalone --nproc_per_node R
    chip_smoke.py --rank-main MODULE OUT ARGV... --then ...` for `jobs`, a
    list of (module, out, argv) run one after the other in the same rank
    processes, under a time limit, its output shown by prefix; returns each
    job's list of the ranks' records."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(ranks), str(ROOT / "chip_smoke.py"), "--rank-main"]
    for i, (module, out, argv) in enumerate(jobs):
        out.mkdir(parents=True, exist_ok=True)
        cmd += ([THEN] if i else []) + [module, str(out), *argv]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=DP_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    for ln in (proc.stdout.strip().splitlines()[-3:] + proc.stderr.strip().splitlines()[-3:]):
        print(f"  torchrun| {ln[:200]}")
    names = "+".join(m for m, _, _ in jobs)
    check(proc.returncode == 0, f"torchrun {names} x{ranks} exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    out = []
    for _, folder, _ in jobs:
        recs = [torch.load(folder / f"rank{r}.pt", weights_only=False) for r in range(ranks)]
        for rec in recs:
            rec["torchrun_seconds"] = seconds
        out.append(recs)
    return out


def torchrun(torch, ranks: int, module: str, out: Path, argv) -> list:
    """One job through `torchrun_jobs`: each rank's record."""
    return torchrun_jobs(torch, ranks, [(module, out, argv)])[0]


def dp_argv(split: Path, exp: Path, backend: str, *extra: str):
    crop = [f"dataset.cropsize=[{EVAL_MAIN_CROP},{EVAL_MAIN_CROP}]"] \
        if EVAL_MAIN_CROP != 1024 else []
    return ["dataset=cityscapes", f"dataset.dataset_path={split}",
            "training_config.batch_size=4", "training_config.epochs=2",
            "training_config.warmup_steps=2", "training_config.log_iter=1",
            "training_config.num_workers=4", "validation_config.num_workers=4",
            "validation_config.eval_scales=[1.0]", "validation_config.flip=false",
            "runtime.compute_dtype=float32", "runtime.use_pallas=true", *crop,
            f"+runtime.dist_backend={backend}", "+runtime.dist_timeout_s=300",
            f"training_config.experiments_path={exp}", *extra, "--device", DEVICE]


def held_against(torch, got, ref, start) -> float:
    """The largest ratio, over the tensors of `ref`, of |got - ref| to its
    bound: 0.1 of the tensor's update from `start` + 4 f32 ulps of its
    magnitude + 1e-4 of the largest update (BOUND_DP_*)."""
    floats = [k for k, v in ref.items() if v.is_floating_point()]
    ups = {k: float((ref[k].float() - start[k].float()).abs().max()) for k in floats}
    largest = max(ups.values())
    worst = 0.0
    for k in floats:
        err = float((got[k].float() - ref[k].float()).abs().max())
        bound = (BOUND_TRAIN_UPDATE * ups[k] + TRAIN_ULPS * float(ref[k].abs().max())
                 + 1e-4 * largest)
        worst = max(worst, err / bound if bound > 0 else (0.0 if err == 0 else float("inf")))
    return worst


def dp_steps(recs) -> dict:
    """Steps 2 on (the first holds cuDNN's set-up): median ms, and the
    median host ms of each kind of collective."""
    import numpy as np

    steady = recs[0]["steps"][1:]
    kinds = sorted({k for s in steady for k in s["collectives"]})
    return {"step_ms": float(np.median([s["ms"] for s in steady])),
            "collective_ms": {k: float(np.median([s["collectives"].get(k, {}).get("seconds", 0.0)
                                                  * 1e3 for s in steady])) for k in kinds},
            "collective_calls": {k: steady[-1]["collectives"].get(k, {}).get("calls", 0)
                                 for k in kinds}}


def dp_jobs(keep: Path) -> list:
    """Phase 16's jobs on 2 ranks: train main at R=2 on gloo, its
    evaluations frame-sharded (each rank its share of the frames, the
    matrices summed; phase 17e's pipeline ranks take the tile-sharded
    default), then two steps of `cli/train_yolo.py:main`."""
    split, base = keep / "train" / "cityscapes", keep / "ranks"
    return [("train", base / "dp_gloo_r2_ranks", dp_argv(
                split, base / "dp_gloo_r2", "gloo", "+runtime.tile_parallel_eval=false")),
            ("train_yolo", base / "dp_yolo_ranks", [
                "dataset=cityscapes", f"dataset.dataset_path={split}",
                "training_config.imgsz=512", "training_config.batch_size=4",
                "training_config.nbs=4", "training_config.epochs=1",
                "training_config.num_workers=4", "validation_config.num_workers=4",
                f"training_config.experiments_path={base / 'dp_yolo'}",
                "+runtime.dist_backend=gloo", "--device", DEVICE])]


def run_two_ranks(torch, paths, keep: Path) -> dict:
    """Every 2-rank job of phases 16-18 (`dp_jobs`, `pipeline_rank_jobs`,
    `tp_rank_jobs`) in one `torchrun_jobs` chain, so that a torchrun's
    start (the launcher's and the ranks' imports, the process group) is
    paid once; each phase holds its jobs' records. {out folder name: the
    ranks' records}."""
    jobs = dp_jobs(keep) + pipeline_rank_jobs(keep) + tp_rank_jobs(keep)
    return {out.name: recs for (_, out, _), recs in zip(jobs, torchrun_jobs(torch, 2, jobs))}


def run_dp(torch, paths, keep: Path) -> dict:
    """Phase 16: `cli/train.py:main` under torchrun on phase 9's split, R=1
    on NCCL and R=2 on gloo sharing the card (global batch 4, 2 epochs of
    2 steps, f32): losses and weights held, the ranks bit-equal, one set
    of outputs, K1 in the evaluations and in no step; then two steps of
    `cli/train_yolo.py:main` on 2 ranks (in the R=2 ranks' processes, after
    train main; with phases 17-18's 2-rank jobs, `run_two_ranks`); no
    process left."""
    import math

    from cabinet_tpu_torch.cli import common
    from cabinet_tpu_torch.core.config import compose

    split, tmp = keep / "train" / "cityscapes", keep / "ranks"
    runs = {"dp_nccl_r1": torchrun(torch, 1, "train", tmp / "dp_nccl_r1_ranks",
                                   dp_argv(split, tmp / "dp_nccl_r1", "nccl"))}
    two_ranks = paths.kept["two_ranks"] = run_two_ranks(torch, paths, keep)
    runs["dp_gloo_r2"], yolo = two_ranks["dp_gloo_r2_ranks"], two_ranks["dp_yolo_ranks"]
    for name, recs in runs.items():
        paths.record(name, recs)
        for rec in recs:
            check(rec["launches"]["attention_f32"] > 0,
                  f"{name} rank {rec['rank']}: K1 f32 never launched {rec['launches']}")
            check(all(n == 0 for n in rec["launches_in_steps"].values()),
                  f"{name} rank {rec['rank']}: a kernel launched in a step "
                  f"{rec['launches_in_steps']}")
            check(len(rec["steps"]) == 4 and all(math.isfinite(s["loss"]) for s in rec["steps"]),
                  f"{name} rank {rec['rank']}: steps {rec['steps']}")
    one, two = runs["dp_nccl_r1"][0], runs["dp_gloo_r2"]
    paths.kept["dp_r1"] = one  # phase 18 is held against it
    errs = [abs(a["loss"] - b["loss"]) / abs(a["loss"])
            for a, b in zip(one["steps"], two[0]["steps"])]
    cfg = compose(common.CONFIG_DIR, "train",
                  [a for a in dp_argv(split, tmp, "gloo") if "=" in a])
    common.seed_everything(cfg.runtime.seed)
    start = common.build_model(cfg, cfg.dataset.num_classes).state_dict()
    held = {k: held_against(torch, two[0][k], one[k], start) for k in ("weights", "ema")}
    identical = all(torch.equal(two[0][k][t], two[1][k][t])
                    for k in ("weights", "ema") for t in two[0][k])
    files = {n: sorted("run-*.log" if p.name.startswith("run-") else p.name
                       for p in (tmp / n).iterdir()) for n in runs}
    out = {"r1_nccl": {**dp_steps([one]), "torchrun_s": one["torchrun_seconds"]},
           "r2_gloo": {**dp_steps(two), "job_s": two[0]["seconds"]},
           "loss_rel_err": errs, "weights_bound_ratio": held["weights"],
           "ema_bound_ratio": held["ema"], "ranks_bit_identical": identical,
           "losses_r1": [s["loss"] for s in one["steps"]],
           "losses_r2": [s["loss"] for s in two[0]["steps"]],
           "launches": {n: [r["launches"] for r in recs] for n, recs in runs.items()}}
    say("dp", part="train_main", **out)
    check(errs[0] <= BOUND_DP_FIRST_LOSS and max(errs[1:]) <= BOUND_DP_LOSS,
          f"R=2 losses {errs} from R=1's")
    check(max(held.values()) <= 1.0, f"R=2 weights from R=1's: {held} x their bound")
    check(identical, "the two ranks' weights or EMA differ")
    check(files["dp_gloo_r2"] == files["dp_nccl_r1"]
          and files["dp_gloo_r2"].count("run-*.log") == 1,
          f"R=2 wrote {files['dp_gloo_r2']}, R=1 {files['dp_nccl_r1']}")
    check(out["r2_gloo"]["collective_calls"].get("grad_all_reduce") == 1,
          f"R=2 collectives a step {out['r2_gloo']['collective_calls']}")
    check(all(eval_route(r["timing"]["collectives"]) == "frames" for r in two),
          f"R=2 evaluations not frame-sharded: {[r['timing']['collectives'] for r in two]}")

    paths.record("dp_yolo_r2", yolo)
    out["yolo"] = {"steps": len(yolo[0]["steps"]), "step_ms": [s["ms"] for s in yolo[0]["steps"]],
                   "losses": [s["loss"] for s in yolo[0]["steps"]],
                   "job_s": yolo[0]["seconds"],
                   "files": sorted(p.name for p in (tmp / "dp_yolo").iterdir())}
    say("dp", part="train_yolo", **out["yolo"])
    check(all(r["timing"]["optimizer_steps"] == 2 for r in yolo), "YOLO ranks' steps")
    check(all(math.isfinite(v) for v in out["yolo"]["losses"]), "YOLO losses")
    check(all(torch.equal(yolo[0]["weights"][t], yolo[1]["weights"][t]) for t in yolo[0]["weights"]),
          "the YOLO ranks' weights differ")
    left = [p for p in processes_left() if "--rank-main" in p or "torch.distributed.run" in p]
    check(not left, f"ranks left running: {left}")
    return out


# ---------------------------------------------------------------------------
# Phase 17: pipeline-parallel training and tile-sharded eval
# ---------------------------------------------------------------------------

PIPE_MICRO, PIPE_TIME_MICRO, PIPE_M = 2, 4, 2  # (a) f32 microbatch, (b) bf16's; M
PIPE_TIME_STEPS = 4  # (b): the median of steps 2-4
PIPE_SIZE = 1024  # (a), (b): the published crop
YOLO_PIPE_SIZE = 512
TILE_EVAL_FRAMES = 2  # (e): the first frames of phase 7's split
# (a): the same weights and microbatches through the same kernels on the
# card; the window's sums and the clip's norm add in another order.
BOUND_PIPE_LOSS = 1e-5


def pipeline_engine(torch, sd, n_min: int, dtype, attention: str = "kernel"):
    """The 2-stage CABiNet-Large pipeline (train/pipeline.py) from state dict
    `sd`, its stages by `make_pipeline_devices` from the card (both on it
    here), with train_one_update's optimizer, clip and EMA."""
    from cabinet_tpu_torch.train.optimizer import GroupedSGD
    from cabinet_tpu_torch.train.pipeline import CabinetPipeline, make_pipeline_devices

    pipe = CabinetPipeline(
        seeded_large(torch, N_CLASSES_TRAIN, attention=attention),
        lambda stage: GroupedSGD(stage, lr0=0.05, max_iter=10, momentum=0.9, wd=5e-4,
                                 warmup_steps=0, max_grad_norm=None),
        n_min=n_min, num_microbatches=PIPE_M, devices=make_pipeline_devices(2, DEVICE),
        max_grad_norm=1.0, compute_dtype=dtype, ema_decay=0.9, ema_tau=2.0)
    return pipe, pipe.init_state(sd)


def run_pipeline_engine(torch) -> dict:
    """Phase 17a: one window (M=2, microbatch 2, 1024^2, f32 with TF32 off)
    of the pipeline against `make_train_step(accum_steps=2)` on the same
    weights and microbatches: the loss within 1e-5, weights, BN statistics
    and EMA within phase 8's bound, K1 never launched (the model is built
    with attention="kernel"; the window runs the einsum path)."""
    import numpy as np

    from cabinet_tpu_torch.train.pipeline import merged

    sd = {k: v.clone() for k, v in seeded_large(torch, N_CLASSES_TRAIN).state_dict().items()}
    batches = [palette_batch(torch, np, PIPE_MICRO, PIPE_SIZE, seed) for seed in (71, 72)]
    fused = train_one_update(torch, sd, batches, DEVICE, PIPE_M)
    pipe, states = pipeline_engine(torch, sd, PIPE_MICRO * PIPE_SIZE ** 2 // 16, torch.float32)
    before = kernel_counts()
    states, loss = pipe.train_step_micro(states, [(x.to(DEVICE), y.to(DEVICE))
                                                  for x, y in batches])
    loss = float(loss)
    launches = {k: n - before[k] for k, n in kernel_counts().items()}
    got = {k: v.cpu() for k, v in merged(states).items()}
    got_ema = {k: v.cpu() for k, v in merged(states, ema=True).items()}
    ref_loss = float(np.mean(fused[0]))
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    var_err, ema_err = updates_err(torch, got, fused[1], sd), updates_err(torch, got_ema,
                                                                          fused[2], sd)
    out = {"loss": loss, "fused_loss": ref_loss, "loss_rel_err": loss_err,
           "variables_err_over_bound": var_err, "ema_err_over_bound": ema_err,
           "launches": launches, "devices": [str(d) for d in pipe.devices]}
    say("pipeline", part="engine_vs_fused", **out)
    check(np.isfinite(loss) and loss_err <= BOUND_PIPE_LOSS,
          f"pipeline window loss {loss} against the fused {ref_loss}")
    for what, worst in (("params/BN", var_err), ("EMA", ema_err)):
        for kind, (ratio, key, err, d, norm) in worst.items():
            check(ratio <= 1.0 and norm <= BOUND_TRAIN_NORM,
                  f"pipeline {what}: {key} err {err} (change {d}) at {ratio} x the bound, "
                  f"the {kind} update {norm} of its norm")
    check(all(n == 0 for n in launches.values()), f"a kernel launched in the window {launches}")
    check(all(s.step == 1 for s in states), "the stages did not step once")
    return out


def run_pipeline_timing(torch) -> dict:
    """Phase 17b: ms per optimizer step (CUDA events, the median of steps
    2-4) and peak memory, the pipeline's window against the fused trainer's
    2 micro-steps, bf16, microbatch 4 at 1024^2, one after the other."""
    import numpy as np

    from cabinet_tpu_torch.train import trainer as T
    from cabinet_tpu_torch.train.optimizer import GroupedSGD

    sd = {k: v.clone() for k, v in seeded_large(torch, N_CLASSES_TRAIN).state_dict().items()}
    micro = [tuple(t.to(DEVICE) for t in palette_batch(torch, np, PIPE_TIME_MICRO, PIPE_SIZE,
                                                         seed)) for seed in (73, 74)]
    n_min = PIPE_TIME_MICRO * PIPE_SIZE ** 2 // 16

    def fused():
        model = seeded_large(torch, N_CLASSES_TRAIN, attention="kernel")
        model.load_state_dict(sd, strict=True)
        model.to(DEVICE)
        state = T.create_train_state(model, GroupedSGD(
            model, lr0=0.05, max_iter=10, momentum=0.9, wd=5e-4, warmup_steps=0,
            max_grad_norm=1.0), 0.9, 2.0)
        step = T.make_train_step(n_min=n_min, accum_steps=PIPE_M, compute_dtype=torch.bfloat16)
        return lambda: [step(state, x, y) for x, y in micro]

    def pipeline():
        pipe, states = pipeline_engine(torch, sd, n_min, torch.bfloat16)
        return lambda: pipe.train_step_micro(states, micro)

    out = {}
    for name, build in (("fused", fused), ("pipeline", pipeline)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        window, ms = build(), []
        for _ in range(PIPE_TIME_STEPS):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            window()
            e.record()
            torch.cuda.synchronize()
            ms.append(s.elapsed_time(e))
        out[name] = {"ms_per_step": float(np.median(ms[1:])), "ms": ms,
                     "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        del window
    say("pipeline", part="timing", micro=PIPE_TIME_MICRO, M=PIPE_M, dtype="bfloat16", **out)
    return out


def run_pipeline_main(torch, paths, keep: Path, tmp: Path) -> dict:
    """Phase 17c: `cli/train.py:main` with runtime.pipeline=2 on phase 9's
    split (bf16, use_pallas, batch 4 = the microbatch, accum_steps 2 = M,
    one eval scale): 1 epoch (one window), a resume to epoch 2, then
    evaluate main on the final EMA `.pth` (K1-K3)."""
    import math

    from cabinet_tpu_torch.cli.train import main as train_main

    split, exp = keep / "train" / "cityscapes", tmp / "pipeline_main"
    argv = ["dataset=cityscapes", f"dataset.dataset_path={split}",
            "training_config.accum_steps=2", "training_config.warmup_steps=2",
            "training_config.num_workers=8", "validation_config.num_workers=8",
            "training_config.log_iter=1", "validation_config.eval_scales=[1.0]",
            "validation_config.flip=false", f"training_config.experiments_path={exp}",
            "runtime.use_pallas=true", "runtime.pipeline=2"]
    if EVAL_MAIN_CROP != 1024:
        argv.append(f"dataset.cropsize=[{EVAL_MAIN_CROP},{EVAL_MAIN_CROP}]")
    held, windows = {}, []
    restore = recording_windows(torch, held, windows)
    try:
        res, main_s, _ = paths.drive("pipeline_main", run_cli, train_main,
                                     argv + ["training_config.epochs=1", "--device", DEVICE],
                                     "pipeline", 3)
        counts = dict(paths.per_path["pipeline_main"])
        res2, resume_s, _ = paths.drive("pipeline_main_resume", run_cli, train_main,
                                        argv + ["training_config.epochs=2",
                                                "training_config.resume=true",
                                                "--device", DEVICE], "pipeline", 3)
    finally:
        restore()
    inside = {k: sum(w["launches"][k] for w in windows) for k in _counters()}
    lines = [json.loads(ln) for ln in (exp / "metrics.jsonl").read_text().splitlines()]
    blob = torch.load(exp / "checkpoint_last.pth", weights_only=True)
    check([ln.get("step") for ln in lines] == [None, 1, None, 2]
          and all(math.isfinite(ln["train_loss"]) for ln in lines if "step" in ln),
          f"pipeline main metrics {lines}")
    check(len(blob.get("stages", ())) == 2, "checkpoint_last.pth holds no 2 stages")
    check(counts["attention"] > 0, f"pipeline main: K1 never launched {counts}")
    check(all(n == 0 for n in inside.values()), f"a kernel launched in a window {inside}")
    t = res["timing"]
    check(t["optimizer_steps"] == 1 and res2["timing"]["optimizer_steps"] == 1,
          f"optimizer steps {t['optimizer_steps']}, {res2['timing']['optimizer_steps']}")
    scored, _, eval_s = paths.drive("pipeline_main_evaluate", run_main, [
        "dataset=cityscapes", f"dataset.dataset_path={split}",
        f"checkpoint_path={exp / 'cabinet.pth'}", "runtime.compute_dtype=bfloat16",
        "runtime.use_pallas=true", "validation_config.eval_scales=[1.0]",
        "validation_config.flip=false", "--device", DEVICE])
    ev_counts = paths.per_path["pipeline_main_evaluate"]
    check(all(ev_counts[k] > 0 for k in TAIL), f"evaluate main launches {ev_counts}")
    check(0.0 <= scored["mIoU"] <= 1.0, f"evaluate main on the pipeline's EMA {scored['mIoU']}")
    out = {"main_seconds": main_s, "resume_main_seconds": resume_s,
           "loop_seconds_per_optimizer_step": t["train_seconds"] / t["optimizer_steps"],
           "loader_wait_share": t["loader_wait_seconds"] / t["train_seconds"],
           "eval_seconds": t["eval_seconds"], "launches": counts, "launches_in_windows": inside,
           "evaluate_main_launches": ev_counts, "evaluate_main_mIoU": scored["mIoU"],
           "evaluate_main_seconds": eval_s, "final_mIoU": res2["final"]["mIoU"]}
    say("pipeline", part="train_main", **out)
    return out


def run_pipeline_yolo(torch, paths, keep: Path, tmp: Path) -> dict:
    """Phase 17d: `cli/train_yolo.py:main` with +runtime.pipeline=3 on
    yolo26x-sem (the variant the JAX docstring names for 3 stages), imgsz
    512, batch 4, nbs 8 (M=2), 2 epochs of one window each, on phase 9's
    split."""
    import math

    from cabinet_tpu_torch.cli.train_yolo import main as yolo_main

    exp = tmp / "pipeline_yolo"
    res, main_s, _ = paths.drive("pipeline_yolo", run_cli, yolo_main, [
        "dataset=cityscapes", f"dataset.dataset_path={keep / 'train' / 'cityscapes'}",
        "yolo/model@model=yolo26x-sem", f"training_config.imgsz={YOLO_PIPE_SIZE}",
        "training_config.batch_size=4", "training_config.nbs=8", "training_config.epochs=2",
        "training_config.num_workers=8", "validation_config.num_workers=8",
        f"training_config.experiments_path={exp}", "+runtime.pipeline=3",
        "--device", DEVICE], "train_yolo", 2)
    t = res["timing"]
    out = {"main_seconds": main_s, "losses": res["losses"],
           "optimizer_steps": t["optimizer_steps"],
           "loop_seconds_per_optimizer_step": t["train_seconds"] / max(t["optimizer_steps"], 1),
           "stages": len(torch.load(exp / "last.pth", weights_only=True)["stages"])}
    say("pipeline", part="train_yolo_x_3_stages", **out)
    check(out["optimizer_steps"] == 2 and out["stages"] == 3,
          f"yolo pipeline: {out['optimizer_steps']} steps, {out['stages']} stages")
    check(all(math.isfinite(v) for v in res["losses"]), f"yolo pipeline losses {res['losses']}")
    check((exp / "final.pth").is_file(), "yolo pipeline wrote no final.pth")
    return out


def pipeline_argv(keep: Path, exp: Path, *extra: str) -> list:
    """Phase 16's train main on gloo, one window an epoch (runtime.pipeline=2,
    accum_steps 2)."""
    return [a for a in dp_argv(keep / "train" / "cityscapes", exp, "gloo")
            if a not in ("--device", DEVICE)] + [
        "training_config.accum_steps=2", "runtime.pipeline=2", *extra, "--device", DEVICE]


def pipeline_eval_argv(keep: Path) -> dict:
    """Phase 17e's evaluate main on the first TILE_EVAL_FRAMES of phase 7's
    frames (`tile_frames`), one tile a forward (so that a rank's launches
    count its tiles): tile-sharded, frame-sharded, frame-sharded int8."""
    frames = tile_frames(keep / "evaluate" / "cityscapes", keep / "ranks" / "tile_frames")
    tiles = [f"checkpoint_path={FIXTURE}", "dataset=cityscapes", "dataset.num_classes=5",
             f"dataset.dataset_path={frames}", "validation_config.batch_size=1",
             "runtime.compute_dtype=bfloat16", "runtime.use_pallas=true",
             "runtime.eval_tile_batch=1"]
    if EVAL_MAIN_CROP != 1024:
        tiles.append(f"dataset.cropsize=[{EVAL_MAIN_CROP},{EVAL_MAIN_CROP}]")
    frames_argv = tiles + ["+runtime.tile_parallel_eval=false"]
    return {"tile": tiles, "frame": frames_argv,
            "frame_int8": frames_argv + ["+runtime.quantize=int8"]}


def pipeline_rank_jobs(keep: Path) -> list:
    """Phase 17e's jobs on 2 ranks: the pipeline main at pipeline_dp=2, then
    evaluate main tile-sharded, frame-sharded and frame-sharded int8."""
    base, ev = keep / "ranks", pipeline_eval_argv(keep)
    on_ranks = ["+runtime.dist_backend=gloo", "+runtime.dist_timeout_s=300", "--device", DEVICE]
    return [("train", base / "pipe_dp_r2_ranks",
             pipeline_argv(keep, base / "pipe_dp_r2", "runtime.pipeline_dp=2")),
            ("evaluate", base / "tile_eval_ranks", ev["tile"] + on_ranks),
            ("evaluate", base / "frame_eval_ranks", ev["frame"] + on_ranks),
            ("evaluate", base / "frame_int8_eval_ranks", ev["frame_int8"] + on_ranks)]


def run_pipeline_ranks(torch, paths, keep: Path, tmp: Path) -> dict:
    """Phase 17e: two ranks on gloo sharing the card (`--rank-main`):
    `cli/train.py:main` with runtime.pipeline=2 and runtime.pipeline_dp=2
    (f32, 2 epochs of one window at global microbatch 4) against the same
    main on one rank in this process, within phase 16's bounds, its
    evaluations tile-sharded; then `cli/evaluate.py:main` on 2 of phase
    7's frames (bf16, use_pallas) tile-sharded, frame-sharded
    (runtime.tile_parallel_eval=false) and frame-sharded with int8 PTQ,
    each against one rank (`held_eval`). The 2-rank jobs ran in phase
    16's chain (`run_two_ranks`)."""
    import numpy as np

    from cabinet_tpu_torch.cli import common
    from cabinet_tpu_torch.cli.train import main as train_main
    from cabinet_tpu_torch.core.config import compose

    held, windows = {}, []
    restore = recording_windows(torch, held, windows)
    try:
        _, r1_s, _ = paths.drive("pipeline_r1", run_cli, train_main,
                                 pipeline_argv(keep, tmp / "pipe_dp_r1"), "pipeline_r1", 2)
    finally:
        restore()
    one = {**merged_of(held), "steps": windows, "snapshot": held["snapshot"]}
    paths.kept["pipeline_r1"] = one  # phase 18c is held against it
    ev = pipeline_eval_argv(keep)
    ev_argv, int8_argv = ev["tile"], ev["frame_int8"]
    ranks = paths.kept["two_ranks"]
    two, *evals = (ranks[n] for n in ("pipe_dp_r2_ranks", "tile_eval_ranks",
                                      "frame_eval_ranks", "frame_int8_eval_ranks"))
    paths.record("pipeline_r2", two)
    errs = [abs(a["loss"] - b["loss"]) / abs(a["loss"]) for a, b in zip(one["steps"],
                                                                        two[0]["steps"])]
    cfg = compose(common.CONFIG_DIR, "train",
                  [a for a in pipeline_argv(keep, tmp) if "=" in a])
    common.seed_everything(cfg.runtime.seed)
    start = common.build_model(cfg, cfg.dataset.num_classes).state_dict()
    ratios = {k: held_against(torch, two[0][k], one[k], start) for k in ("weights", "ema")}
    identical = all(torch.equal(two[0][k][t], two[1][k][t])
                    for k in ("weights", "ema") for t in two[0][k])
    out = {"loss_rel_err": errs, "weights_bound_ratio": ratios["weights"],
           "ema_bound_ratio": ratios["ema"], "ranks_bit_identical": identical,
           "r1_window_ms": [s["ms"] for s in one["steps"]],
           "r2_window_ms": [s["ms"] for s in two[0]["steps"]],
           "r2_collective_ms": {k: [w["collectives"].get(k, {}).get("seconds", 0.0) * 1e3
                                    for w in two[0]["steps"]]
                                for k in two[0]["steps"][-1]["collectives"]},
           "r1_main_seconds": r1_s, "r2_job_seconds": two[0]["seconds"],
           "r2_launches": [r["launches"] for r in two]}
    say("pipeline", part="pipeline_dp", **out)
    check(len(errs) == 2 and errs[0] <= BOUND_DP_FIRST_LOSS and errs[1] <= BOUND_DP_LOSS,
          f"pipeline R=2 window losses from R=1's: {errs}")
    check(max(ratios.values()) <= 1.0, f"pipeline R=2 weights from R=1's {ratios}")
    check(identical, "the pipeline ranks' weights or EMA differ")
    check(all(s["collectives"].get("pipeline_grad_all_reduce", {}).get("calls") == 2
              for s in two[0]["steps"]), f"pipeline R=2 collectives {two[0]['steps']}")
    check(all(r["launches_in_steps"]["attention_f32"] == 0 for r in two),
          "K1 launched in a pipeline window")
    check(all(eval_route(r["timing"]["collectives"]) == "tiles" for r in two),
          f"pipeline R=2 evaluations not tile-sharded: "
          f"{[r['timing']['collectives'] for r in two]}")

    # evaluate main on 2 ranks, tile- and frame-sharded, against 1 rank
    refs = {"bf16": paths.drive("tile_eval_r1", run_main, ev_argv + ["--device", DEVICE]),
            "int8": paths.drive("frame_int8_eval_r1", run_main,
                                int8_argv + ["--device", DEVICE])}
    r1_counts = {k: paths.per_path[n] for k, n in (("bf16", "tile_eval_r1"),
                                                    ("int8", "frame_int8_eval_r1"))}
    ev_cfg = compose(common.CONFIG_DIR, "evaluate", [a for a in ev_argv if "=" in a])
    reduced = {f"{c}_classes": tile_reduce_bytes(FRAME_H, FRAME_W, EVAL_MAIN_CROP,
                                                 ev_cfg.validation_config.eval_scales, c)
               for c in (ev_cfg.dataset.num_classes, 19)}
    for (name, route, kind), ranks in zip((("tile_eval", "tiles", "bf16"),
                                           ("frame_eval", "frames", "bf16"),
                                           ("frame_int8_eval", "frames", "int8")), evals):
        paths.record(f"{name}_r2", ranks)
        ref, _, r1_eval_s = refs[kind]
        out[name] = held_eval(name, route, ranks, ref, r1_eval_s, r1_counts[kind],
                              count_tiles=kind == "bf16",
                              **({"all_reduce_bytes_a_frame": reduced}
                                 if route == "tiles" else {}))
    left = [p for p in processes_left() if "--rank-main" in p or "torch.distributed.run" in p]
    check(not left, f"ranks left running: {left}")
    return out


def eval_route(collectives: dict) -> str:
    """How a run's evaluations shared the work over its ranks, from its
    collectives' tally: "tiles" (`tile_all_reduce`), "frames" (the
    confusion matrices summed, `eval`), or "" (neither)."""
    tiles, frames = (collectives.get(k, {}).get("calls", 0) > 0
                     for k in ("tile_all_reduce", "eval"))
    return "tiles" if tiles and not frames else "frames" if frames and not tiles else ""


def tile_reduce_bytes(h: int, w: int, crop: int, scales, n_classes: int) -> int:
    """Bytes of the f32 buffers tile-sharded eval all-reduces for one h x w
    frame (`eval/evaluator.py:_sliding_probs_tile_sharded`): a scale's
    probability map and tile counts over its canvas, padded to the crop."""
    total = 0
    for s in scales:
        fh, fw = max(int(h * s), crop), max(int(w * s), crop)
        total += 4 * fh * fw * (n_classes + 1)
    return total


def held_eval(name: str, route: str, ranks, ref: dict, r1_s: float, r1_counts: dict,
              count_tiles: bool, **extra) -> dict:
    """Evaluate main on 2 ranks (`ranks`, their records) against one rank's
    result `ref`: every rank holds one matrix, equal to one rank's but for
    near ties (phase 7's rule), the pixels and frames counted once, the
    work shared by `route` ("tiles" or "frames", read from the
    collectives), K1-K3 launched on every rank (with `count_tiles`, each
    tile or frame once: the ranks' launches sum to one rank's); the
    split's wall seconds a frame (the slower rank's) against one rank's,
    and the collectives' host ms, with `extra` on the line."""
    import numpy as np

    hist, ref_hist = ranks[0]["result"]["confusion_matrix"], ref["confusion_matrix"]
    pixels = float(ref_hist.sum())
    disagree = float(np.abs(hist - ref_hist).sum() / 2)
    n_frames = ref["timing"]["frames"]
    shares = [r["result"]["timing"]["frames"] for r in ranks]
    comm = [r["result"]["collectives"] for r in ranks]
    out = {"route": route, "r1_mIoU": ref["mIoU"], "r2_mIoU": ranks[0]["result"]["mIoU"],
           "disagree_pixels": disagree, "pixels": pixels, "frames_a_rank": shares,
           "r1_launches": r1_counts, "r2_launches": [r["launches"] for r in ranks],
           "r1_seconds_per_frame": ref["timing"]["seconds"] / n_frames,
           "r2_seconds_per_frame": max(r["result"]["timing"]["seconds"] for r in ranks)
           / n_frames,
           "r2_collective_ms": [{k: v["seconds"] * 1e3 for k, v in c.items()} for c in comm],
           "r2_collective_calls": [{k: v["calls"] for k, v in c.items()} for c in comm],
           "r1_main_seconds": r1_s, **extra}
    say("pipeline", part=name, **out)
    check(all(np.array_equal(r["result"]["confusion_matrix"], hist) for r in ranks),
          f"{name}: the ranks' confusion matrices differ")
    check(pixels == hist.sum() and sum(shares) == n_frames * (len(ranks) if route == "tiles"
                                                              else 1),
          f"{name}: {hist.sum()} pixels and {shares} frames, one rank {pixels} and {n_frames}")
    check(disagree <= 1e-3 * pixels and abs(out["r2_mIoU"] - ref["mIoU"]) < 5e-3,
          f"{name}: differs from one rank on {disagree} of {pixels} pixels")
    check(all(eval_route(c) == route for c in comm), f"{name}: collectives {comm}, not {route}")
    check(all(r["launches"][k] > 0 for r in ranks for k in TAIL)
          and (not count_tiles
               or all(sum(r["launches"][k] for r in ranks) == r1_counts[k] for k in TAIL)),
          f"{name}: the ranks' launches {[r['launches'] for r in ranks]} against one "
          f"rank's {r1_counts}")
    return out


def tile_frames(src: Path, dst: Path) -> Path:
    """The first TILE_EVAL_FRAMES frames of the Cityscapes-layout val split
    `src`, images and labels, copied to a split of their own."""
    for sub in ("leftImg8bit", "gtFine"):
        for p in sorted((src / sub / "val").rglob("*.png"))[:TILE_EVAL_FRAMES]:
            (dst / sub / "val" / p.parent.name).mkdir(parents=True, exist_ok=True)
            shutil.copy(p, dst / sub / "val" / p.parent.name / p.name)
    return dst


def recording_windows(torch, held: dict, windows: list):
    """Patch CabinetPipeline.train_step_micro so that each window is timed
    (CUDA events on the card), its loss, collectives and kernel launches
    appended to `windows`, and the stages' states kept in `held` (their
    merged weights after the first window in `held["snapshot"]`);
    returns the restore function."""
    from cabinet_tpu_torch.core import mesh
    from cabinet_tpu_torch.train.pipeline import CabinetPipeline

    plain = CabinetPipeline.train_step_micro

    def run(self, states, micro):
        before, comm = kernel_counts(), {t: dict(v) for t, v in mesh.COMM.items()}
        cuda = self.devices[0].type == "cuda"
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
        t0 = time.perf_counter()
        out = plain(self, states, micro)
        if cuda:
            end.record()
            end.synchronize()
        windows.append({"ms": start.elapsed_time(end) if cuda
                        else (time.perf_counter() - t0) * 1e3,
                        "loss": float(out[1]), "collectives": mesh.comm_since(comm),
                        "launches": {k: n - before[k] for k, n in kernel_counts().items()},
                        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0})
        held["states"] = out[0]
        if len(windows) == 1:  # the weights after the first window, kept
            held["snapshot"] = merged_of({"states": out[0]})
        return out

    CabinetPipeline.train_step_micro = run
    return lambda: setattr(CabinetPipeline, "train_step_micro", plain)


def merged_of(held: dict) -> dict:
    """The weights and EMA of the run `held` recorded, copied to the CPU (the
    live tensors move on): a fused trainer's state or a pipeline's stages
    merged."""
    from cabinet_tpu_torch.train.pipeline import merged

    if "states" in held:
        weights, ema = merged(held["states"]), merged(held["states"], ema=True)
    else:
        weights, ema = held["state"].model.state_dict(), held["state"].ema.state_dict()
    return {"weights": {k: v.detach().to("cpu", copy=True) for k, v in weights.items()},
            "ema": {k: v.detach().to("cpu", copy=True) for k, v in ema.items()}}


def run_pipeline(torch, paths, keep: Path, tmp: Path) -> dict:
    """Phase 17: the pipeline engine, its timing, the train mains on it and
    the pipeline and tile-sharded eval over two ranks."""
    engine = paths.drive("pipeline_engine", run_pipeline_engine, torch)
    timing = run_pipeline_timing(torch)
    main = run_pipeline_main(torch, paths, keep, tmp)
    yolo = run_pipeline_yolo(torch, paths, keep, tmp)
    ranks = run_pipeline_ranks(torch, paths, keep, tmp)
    return {"engine": engine, "timing": timing, "main": main, "yolo": yolo, "ranks": ranks}


# ---------------------------------------------------------------------------
# Phase 18: tensor parallelism across ranks
# ---------------------------------------------------------------------------

TP_MIN_FEATURES = 256  # configs/train.yaml's runtime.tp_min_features


def tp_whole(torch, exp: Path) -> dict:
    """A train main's weights and EMA as its files hold them, whole:
    `checkpoint_last.pth`'s parameters and BN statistics (a pipeline's
    stages merged) and EMA."""
    blob = torch.load(exp / "checkpoint_last.pth", weights_only=True)
    trees = blob["stages"] if "stages" in blob else [blob]
    weights, ema = {}, {}
    for t in trees:
        weights.update({**t["params"], **t["batch_stats"]})
        ema.update(t["ema_variables"])
    return {"weights": weights, "ema": ema}


def replicated_bit_equal(torch, recs, n_model: int, dims) -> bool:
    """Every leaf that JAX's rule leaves whole (`dims` None) bit-equal on
    the ranks of each model group (rank = d * n_model + m), in the ranks'
    weights and EMA; a split leaf has the slice's shape there."""
    for r in recs:
        group = [q for q in recs if q["rank"] // n_model == r["rank"] // n_model]
        for kind in ("weights", "ema"):
            for k, t in r[kind].items():
                if dims.get(k) is None and not torch.equal(t, group[0][kind][k]):
                    return False
    return True


def tp_k1_launches(epochs: int, n_data: int) -> int:
    """K1's launches on each rank of a train main on phase 16's split and
    config: each epoch's val loss over the val frames at batch 1, this data
    rank's share of them; each epoch's evaluation and the final one, one
    forward a frame at the one scale (its tiles, or under tile sharding
    this rank's share of them, in one batch, so the count does not fall)."""
    n = TRAIN_MAIN_VAL_FRAMES
    return epochs * (n // n_data + n) + n


def tp_part(torch, name: str, recs, ref: dict, ref_steps, r1: dict, whole: dict,
            n_model: int, dims, start, k1_each: int, r1_steps_ms=None) -> dict:
    """One part of phase 18 held against R=1 (`ref`: its weights and EMA at
    the matching step; `ref_steps`: its steps' losses): the first loss
    within 1e-5 and the later within 1e-3 of |R=1|, the whole weights and
    EMA within phase 16's bound (`held_against`), the replicated leaves
    bit-equal on each model group's ranks, K1 `k1_each` times on each rank
    (`tp_k1_launches`) and in no step; the step ms, the collectives' host
    ms and calls a step (the
    median of steps 2 on, or every window), each rank's peak memory
    against R=1's."""
    import numpy as np

    steps = recs[0]["steps"]
    errs = [abs(a["loss"] - b["loss"]) / abs(a["loss"]) for a, b in zip(ref_steps, steps)]
    ratios = {k: held_against(torch, whole[k], ref[k], start) for k in ("weights", "ema")}
    steady = steps[1:] or steps
    kinds = sorted({k for s in steady for k in s["collectives"]})
    out = {"ranks": len(recs), "loss_rel_err": errs, "weights_bound_ratio": ratios["weights"],
           "ema_bound_ratio": ratios["ema"],
           "replicated_bit_equal": replicated_bit_equal(torch, recs, n_model, dims),
           "step_ms": float(np.median([s["ms"] for s in steady])),
           "r1_step_ms": r1_steps_ms,
           "collective_ms": {k: float(np.median([s["collectives"].get(k, {}).get(
               "seconds", 0.0) * 1e3 for s in steady])) for k in kinds},
           "collective_calls": {k: steady[-1]["collectives"].get(k, {}).get("calls", 0)
                                for k in kinds},
           "peak_allocated_gib": [r["peak_allocated_gib"] for r in recs],
           "r1_peak_allocated_gib": r1["peak_allocated_gib"],
           "steps_peak_gib": [r["steps"][-1]["peak_gib"] for r in recs],
           "r1_steps_peak_gib": r1["steps"][len(steps) - 1]["peak_gib"],
           "launches": [r["launches"] for r in recs], "job_s": recs[0]["seconds"]}
    say("tp", part=name, **out)
    check(len(errs) == len(steps) and errs[0] <= BOUND_DP_FIRST_LOSS
          and max(errs) <= BOUND_DP_LOSS, f"{name}: losses from R=1's {errs}")
    check(max(ratios.values()) <= 1.0, f"{name}: weights from R=1's {ratios} x their bound")
    check(out["replicated_bit_equal"], f"{name}: a model group's replicated leaves differ")
    check(all(r["launches"]["attention_f32"] == k1_each for r in recs)
          and all(n == 0 for r in recs for n in r["launches_in_steps"].values()),
          f"{name}: K1 not {k1_each} times a rank in the evaluations, or in a step "
          f"{out['launches']}")
    check(out["collective_calls"].get("tp_forward", 0) > 0,
          f"{name}: no tensor-parallel collective {out['collective_calls']}")
    return out


def tp_argv(keep: Path, exp: Path, *extra: str) -> list:
    """Phase 16's train main on gloo at JAX's tp_min_features."""
    return [a for a in dp_argv(keep / "train" / "cityscapes", exp, "gloo")
            if a not in ("--device", DEVICE)] + [
        f"runtime.tp_min_features={TP_MIN_FEATURES}", *extra, "--device", DEVICE]


def tp_rank_jobs(keep: Path) -> list:
    """Phase 18's jobs on 2 ranks: (a) model_axis=2, 2 epochs; (c) the
    pipeline with pipeline_tp=2 and eval_model_axis=2, one window."""
    base = keep / "ranks"
    return [("train", base / "tp_1x2_ranks", tp_argv(keep, base / "tp_1x2",
                                                     "runtime.model_axis=2")),
            ("train", base / "tp_pipe_ranks", tp_argv(
                keep, base / "tp_pipe", "training_config.accum_steps=2", "runtime.pipeline=2",
                "+runtime.pipeline_tp=2", "+runtime.eval_model_axis=2",
                "training_config.epochs=1"))]


def run_tp(torch, paths, keep: Path, tmp: Path) -> dict:
    """Phase 18: tensor parallelism on 2 and 4 gloo ranks sharing the card,
    against phase 16's R=1 run and phase 17's R=1 pipeline run ((a) and (c)
    ran in phase 16's 2-rank chain, `run_two_ranks`); then evaluate main on
    the 2-rank run's EMA `.pth` (K1-K3)."""
    import math

    from cabinet_tpu_torch.cli import common
    from cabinet_tpu_torch.core.config import compose
    from cabinet_tpu_torch.models.tensor_parallel import sharded_dims

    split, base = keep / "train" / "cityscapes", keep / "ranks"
    r1, pipe_r1 = paths.kept["dp_r1"], paths.kept["pipeline_r1"]
    two, pipe = (paths.kept["two_ranks"][n] for n in ("tp_1x2_ranks", "tp_pipe_ranks"))
    four = torchrun(torch, 4, "train", tmp / "tp_2x2_ranks",
                    tp_argv(keep, tmp / "tp_2x2", "runtime.model_axis=2",
                            "training_config.epochs=1"))
    for name, recs in (("tp_1x2", two), ("tp_pipeline", pipe), ("tp_2x2", four)):
        paths.record(name, recs)
    cfg = compose(common.CONFIG_DIR, "train", [a for a in tp_argv(keep, tmp) if "=" in a])
    common.seed_everything(cfg.runtime.seed)
    model = common.build_model(cfg, cfg.dataset.num_classes)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    dims = sharded_dims(model, 2, TP_MIN_FEATURES)
    check(sum(d is not None for d in dims.values()) > 0, "JAX's rule splits no leaf")
    r1_ms = dp_steps([r1])["step_ms"]
    check(r1["launches"]["attention_f32"] == tp_k1_launches(2, 1),
          f"R=1's K1 launches {r1['launches']}, not {tp_k1_launches(2, 1)}")
    out = {"split_leaves": sum(d is not None for d in dims.values()), "leaves": len(dims)}
    out["a"] = tp_part(torch, "a_model_axis_1x2", two, r1, r1["steps"], r1,
                       tp_whole(torch, base / "tp_1x2"), 2, dims, start,
                       tp_k1_launches(2, 1), r1_ms)
    check(len(two[0]["steps"]) == 4 and all(math.isfinite(s["loss"]) for s in two[0]["steps"]),
          f"(a): steps {two[0]['steps']}")
    out["b"] = tp_part(torch, "b_model_axis_2x2", four, r1["snapshot"],
                       r1["steps"][:SNAPSHOT_STEP], r1, tp_whole(torch, tmp / "tp_2x2"), 2,
                       dims, start, tp_k1_launches(1, 2), r1_ms)
    check(len(four[0]["steps"]) == SNAPSHOT_STEP, f"(b): steps {four[0]['steps']}")
    # (c): the val loss on the pipeline's one data rank, the evaluations on
    # the (1, 2) eval mesh
    out["c"] = tp_part(torch, "c_pipeline_tp", pipe, pipe_r1["snapshot"],
                       pipe_r1["steps"][:1], r1, tp_whole(torch, base / "tp_pipe"), 2, dims,
                       start, tp_k1_launches(1, 1), pipe_r1["steps"][0]["ms"])
    check(len(pipe[0]["steps"]) == 1, f"(c): windows {pipe[0]['steps']}")
    for folder in (base / "tp_1x2", tmp / "tp_2x2", base / "tp_pipe"):  # rank 0's, once
        files = sorted(p.name for p in folder.iterdir())
        check({"cabinet.pth", "checkpoint_last.pth", "config.yaml"} <= set(files)
              and not any(".tmp" in f for f in files), f"{folder.name} wrote {files}")
    scored, _, eval_s = paths.drive("tp_evaluate_main", run_main, [
        "dataset=cityscapes", f"dataset.dataset_path={split}",
        f"checkpoint_path={base / 'tp_1x2' / 'cabinet.pth'}", "runtime.compute_dtype=bfloat16",
        "runtime.use_pallas=true", "validation_config.eval_scales=[1.0]",
        "validation_config.flip=false", "--device", DEVICE])
    counts = paths.per_path["tp_evaluate_main"]
    out["d"] = {"mIoU": scored["mIoU"], "seconds": eval_s, "launches": counts}
    say("tp", part="d_evaluate_main", **out["d"])
    check(all(counts[k] > 0 for k in TAIL), f"(d): evaluate main launches {counts}")
    check(0.0 <= scored["mIoU"] <= 1.0, f"(d): mIoU {scored['mIoU']}")
    left = [p for p in processes_left() if "--rank-main" in p or "torch.distributed.run" in p]
    check(not left, f"ranks left running: {left}")
    return out


def main() -> int:
    os.environ[RUN_MARK] = str(os.getpid())
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs "
              "a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from cabinet_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: cabinet_tpu_torch not found beside {__file__}: {e}",
              file=sys.stderr)
        return 2
    if not FIXTURE.is_file():
        print(f"chip_smoke: missing {FIXTURE}", file=sys.stderr)
        return 2

    # Plain versions compute in f32: keep cuBLAS and cuDNN out of TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    say("packages", **optional_packages())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    say("device", name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    peaks = Peaks(name)

    seconds = _build.build_all()
    say("build", seconds=round(seconds, 2), sources=list(_build.SOURCES))
    for ln in ptxas_report() + sass_report():
        print("  " + ln)

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    k1 = [check_attention(torch, peaks, B, gen=gen) for B in (1, 8)]
    k1_f32 = [check_attention_f32(torch, peaks, B, gen=gen) for B in (8, 1)]
    tails = [check_tail(torch, peaks, S, n, B, gen)
             for S, n, B in ((128, 5, 1), (128, 8, 1), (90, 12, 1), (128, 8, 8))]
    k4 = [check_stem_block0(torch, peaks, shape, dtype, gen)
          for shape in ((8, 1024, 1024, 3), (2, 720, 1280, 3))
          for dtype in (torch.bfloat16, torch.float32)]

    import numpy as np

    paths = MainPaths()
    paths.drive("fixture_bf16", run_fixture, torch, 1024)
    rgbs = [np.random.default_rng(5).integers(0, 256, (1024, 1024, 3), dtype=np.uint8)
            for _ in range(8)]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "uavid_large_seeded.pth"
        seeded_uavid_checkpoint(torch, ckpt)
        engines = {
            1: paths.drive("segmenter_bf16_batch1", run_segmenter, torch, 1024,
                           ckpt, rgbs, "bfloat16", 1, "fused_tail", TAIL,
                           ("stem_block0",), BOUND_FORWARD, 0.99),
            8: paths.drive("segmenter_bf16_batch8", run_segmenter, torch, 1024,
                           ckpt, rgbs, "bfloat16", 8, "fused_tail_early",
                           TAIL + ("stem_block0",), (), BOUND_FORWARD, 0.99)}
        paths.drive("segmenter_f32_batch8", run_segmenter, torch, 1024, ckpt,
                    rgbs, "float32", 8, "fused_early",
                    ("attention_f32", "stem_block0"),
                    ("attention", "ffm_pointwise", "head_conv3x3"),
                    BOUND_FORWARD_F32, 0.999)
        ms = {b: time_ms(lambda: seg._forward(x), iters=10) / b
              for b, (seg, x) in engines.items()}
        say("main", forward_ms_per_img_batch1=ms[1], forward_ms_per_img_batch8=ms[8])
        del engines
        time_early_stage(torch, ckpt, 1024)

    run_attention_forward(torch, 1024)

    paths.drive("eval_f32_reference", run_eval_reference, torch)
    paths.drive("eval_bf16_kernels", run_eval_kernels, torch)
    # phase 7's split and phase 9's run are kept for phases 15 and 16
    keep = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    measured = run_evaluate_main(torch, paths, keep / "evaluate")
    say("evaluate_main", card=smi, **measured)

    run_train_card_vs_cpu(torch)
    full = paths.drive("train_step_full_width", run_train_full_width, torch)
    say("train_step", card=smi, **full)
    trained = run_train_main(torch, paths, keep / "train")
    say("train_main", card=smi, main_seconds=trained["main_seconds"],
        loop_seconds_per_optimizer_step=trained["loop_seconds_per_optimizer_step"],
        loader_wait_share=trained["loader_wait_share"],
        host_ms_per_augmented_frame=trained["host_ms_per_augmented_frame"])
    with tempfile.TemporaryDirectory() as tmp:
        augs = run_device_augs(torch, peaks, paths, Path(tmp))
    say("device_augs", card=smi,
        chain_ms={f"{r['warp']}/{r['recipe']}": r["ms"] for r in augs["chains"]},
        chain_bound_ms={f"{r['warp']}/{r['recipe']}": r["bound_ms"] for r in augs["chains"]},
        **{f"{k}_loop_seconds_per_optimizer_step": v["loop_seconds_per_optimizer_step"]
           for k, v in augs["runs"].items()},
        **{f"{k}_loader_wait_share": v["loader_wait_share"] for k, v in augs["runs"].items()},
        **augs["host"])
    with tempfile.TemporaryDirectory() as tmp:
        served = run_serve(torch, paths, Path(tmp))
    say_serve(smi, served)
    with tempfile.TemporaryDirectory() as data_tmp:  # phase 14 trains on its tree
        data = run_data(torch, paths, Path(data_tmp))
        say_data(smi, data)
        with tempfile.TemporaryDirectory() as tmp:
            quant = run_quant(torch, paths, Path(tmp))
        say("quant", card=smi, **quant["forward"],
            evaluate_main_seconds_per_frame={k: v["main_seconds_per_frame"]
                                             for k, v in quant["evaluate"].items()},
            moved_share={k: v["moved_share"] for k, v in quant["evaluate"].items()
                         if "moved_share" in v},
            export_s=quant["export"]["export_s"], sites=quant["sites"]["sites"])
        with tempfile.TemporaryDirectory() as tmp:
            yolo = run_yolo(torch, paths, Path(data_tmp) / "uavid", Path(tmp))
    train_runs = yolo["train"]
    say("yolo", card=smi, seconds=yolo["seconds"], **yolo["forward"],
        train_loop_seconds_per_optimizer_step={
            k: v["loop_seconds_per_optimizer_step"] for k, v in train_runs.items()
            if "micro_steps" in v},
        train_loader_wait_share={k: v["loader_wait_share"] for k, v in train_runs.items()
                                 if "micro_steps" in v},
        train_peak_allocated_gib={k: v["peak_allocated_gib"] for k, v in train_runs.items()
                                  if "micro_steps" in v},
        val_mIoU=train_runs["yolo_val_main"]["mIoU"],
        train_class_count_seconds={k: v["class_count_seconds"]
                                   for k, v in train_runs.items() if "micro_steps" in v},
        x_ms_per_step=yolo["wide"]["ms_per_step"],
        x_peak_allocated_gib=yolo["wide"]["peak_allocated_gib"],
        export_s=yolo["export"]["export_s"])
    with tempfile.TemporaryDirectory() as tmp:
        tools = run_tools(torch, paths, peaks, keep, Path(tmp))
    say("tools", card=smi, visualize_seconds_per_frame=tools["visualize"]["seconds_per_frame"],
        convert_s=tools["convert"]["export_s"] + tools["convert"]["import_s"],
        profiler_median_ms={b: tools["profiler"][b]["latency_ms"]["median_ms"] for b in (1, 8)},
        profiler_gflops={b: tools["profiler"][b]["gflops"] for b in (1, 8)},
        profiler_peak_temp_mb={b: tools["profiler"][b]["memory"]["temp_size_mb"]
                               for b in (1, 8)},
        trace_busy_share=tools["profiler"]["trace"]["busy_share"],
        legacy_main_s=tools["legacy"]["main_seconds"])
    dp = run_dp(torch, paths, keep)
    say("dp", card=smi, r1_nccl_step_ms=dp["r1_nccl"]["step_ms"],
        r2_gloo_step_ms=dp["r2_gloo"]["step_ms"],
        r2_gloo_collective_ms=dp["r2_gloo"]["collective_ms"],
        loss_rel_err=dp["loss_rel_err"], weights_bound_ratio=dp["weights_bound_ratio"],
        note="two ranks share one card through gloo, which stages through the host: "
             "not a multi-card figure")
    with tempfile.TemporaryDirectory() as tmp:
        pipe = run_pipeline(torch, paths, keep, Path(tmp))
    say("pipeline", card=smi, fused_ms_per_step=pipe["timing"]["fused"]["ms_per_step"],
        pipeline_ms_per_step=pipe["timing"]["pipeline"]["ms_per_step"],
        fused_peak_gib=pipe["timing"]["fused"]["peak_allocated_gib"],
        pipeline_peak_gib=pipe["timing"]["pipeline"]["peak_allocated_gib"],
        main_seconds=pipe["main"]["main_seconds"],
        main_loop_seconds_per_optimizer_step=pipe["main"]["loop_seconds_per_optimizer_step"],
        yolo_x_3_stage_main_seconds=pipe["yolo"]["main_seconds"],
        r2_window_ms=pipe["ranks"]["r2_window_ms"],
        r2_collective_ms=pipe["ranks"]["r2_collective_ms"],
        eval_r1_seconds_per_frame=pipe["ranks"]["tile_eval"]["r1_seconds_per_frame"],
        **{f"{k}_r2_seconds_per_frame": pipe["ranks"][k]["r2_seconds_per_frame"]
           for k in ("tile_eval", "frame_eval", "frame_int8_eval")},
        tile_eval_r2_collective_ms=pipe["ranks"]["tile_eval"]["r2_collective_ms"],
        tile_all_reduce_bytes_a_frame=pipe["ranks"]["tile_eval"]["all_reduce_bytes_a_frame"],
        note="both stages share the one card, and the two ranks share it through gloo: "
             "not a multi-card figure")
    with tempfile.TemporaryDirectory() as tmp:
        tp = run_tp(torch, paths, keep, Path(tmp))
    say("tp", card=smi, **{f"{p}_{k}": tp[p][k] for p in "abc"
                           for k in ("step_ms", "r1_step_ms", "collective_ms",
                                     "collective_calls", "peak_allocated_gib",
                                     "r1_peak_allocated_gib", "loss_rel_err",
                                     "weights_bound_ratio")},
        evaluate_main_mIoU=tp["d"]["mIoU"], split_leaves=tp["split_leaves"],
        note="2 and 4 ranks share one card through gloo, which stages through the host: "
             "not a multi-card figure")
    shutil.rmtree(keep, ignore_errors=True)
    launches = paths.totals
    say("main", launches=launches)
    check(all(n > 0 for n in launches.values()), f"launches {launches}")
    stop_every_process()

    say("run", seconds=time.perf_counter() - STARTED)
    main_k2, main_k3 = tails[1]  # B=1, S=128, 8 classes: Segmenter on uavid
    rows = [
        ("attention", "csrc/attention.cu",
         "cabinet_tpu/ops/attention.py:26", k1[0], k1),
        ("attention_f32", "csrc/attention.cu",
         "cabinet_tpu/ops/attention.py:26", k1_f32[0], k1_f32),
        ("ffm_pointwise", "csrc/decoder_tail.cu",
         "cabinet_tpu/ops/decoder_tail.py:94", main_k2, [t[0] for t in tails]),
        ("head_conv3x3", "csrc/decoder_tail.cu",
         "cabinet_tpu/ops/decoder_tail.py:110", main_k3, [t[1] for t in tails]),
        # (8,1024,1024,3) bf16: Segmenter --batch 8 in bf16
        ("stem_block0", "csrc/early_stage.cu",
         "cabinet_tpu/ops/early_stage.py:94", k4[0], k4),
    ]
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": f"cabinet_tpu_torch/{src}",
         "replaces": rep, "launches": launches[n],
         "max_abs_err": max(r["max_abs_err"] for r in every),
         "ms": main["ms"], "plain_ms": main["plain_ms"],
         "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
         "library_ms": main["library_ms"], "device_ms": main["device_ms"],
         "plain_device_ms": main["plain_device_ms"],
         "library_device_ms": main["library_device_ms"], "shape": main["shape"]}
        for n, src, rep, main, every in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-main"]:
        sys.exit(rank_main(sys.argv[2:]))
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
