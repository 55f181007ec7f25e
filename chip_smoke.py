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
  7. a {"kernels": [...]} line, then the {"ok": true, ...} line.

Any failure exits non-zero before the last line. Without a CUDA device, or
without the package beside this file, it exits non-zero and prints no
result. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
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


def say(phase: str, **fields) -> None:
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

    def drive(self, name, fn, *args):
        reset_counts()
        out = fn(*args)
        counts = kernel_counts()
        self.per_path[name] = counts
        for k, n in counts.items():
            self.totals[k] += n
        say("main", path=name, launches=counts)
        return out


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


def main() -> int:
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
    launches = paths.totals
    say("main", launches=launches)
    check(all(n > 0 for n in launches.values()), f"launches {launches}")

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
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
