#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (cabinet_tpu_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It drives the port's main path, CABiNet-Large bf16 inference at 1024^2,
through the entry points a user calls, and holds every hand-written kernel
against its plain PyTorch version. Phases, one line each:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    compile csrc/*.cu (one nvcc per source, in parallel)
  3. kernels  K1 attention, K2 FFM 1x1, K3 3x3 head at the main path's
              shapes in bf16 against their plain versions, with times of
              the kernel, the plain version and one library call
  4. main     the fused-tail forward on the trained Large fixture
              (tests/fixtures/miou_large_cabinet_v1.npz) on single-class
              palette images, then Segmenter.predict / predict_batch at
              batch 1 and 8 on seeded uavid weights saved as a .pth; every
              forward must launch K1, K2 and K3
  5. attn     the fixture with its zero gamma/project_out perturbed: the
              kernel path against the plain path, logits and argmax, and
              how far the attention moves the logits (the same forward
              with gamma 0), which must exceed the logit bound 4 times
  6. a {"kernels": [...]} line, then the {"ok": true, ...} line.

Any failure exits non-zero before the last line. Without a CUDA device, or
without the package beside this file, it exits non-zero and prints no
result. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
FIXTURE = ROOT / "tests" / "fixtures" / "miou_large_cabinet_v1.npz"

# Palette task of the trained fixture (5 classes), copied from the fixture's
# generator so this script needs nothing under tests/ but the weights.
PALETTE = [[220, 40, 40], [40, 220, 40], [40, 40, 220], [220, 220, 40],
           [140, 40, 220]]

# Dense peak rates of the cards this script has run on (NVIDIA data sheet):
# bf16 tensor FLOP/s and memory bytes/s, by a fragment of the card's name.
PEAKS = [("H100 80GB HBM3", 989e12, 3.35e12)]  # H100 SXM

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
    """Mean ms per call from CUDA events around `iters` back-to-back calls."""
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


def max_err(got, ref):
    """(max abs error, max |ref|) in f32."""
    return (float((got.float() - ref.float()).abs().max()),
            float(ref.float().abs().max()))


class Peaks:
    def __init__(self, name: str):
        for frag, flops, bw in PEAKS:
            if frag in name:
                self.flops, self.bw, self.source = flops, bw, frag
                return
        raise SmokeFailure(f"no peak rates known for card {name!r}")

    def bound(self, n_bytes: float, n_flops: float):
        """(bound ms, what bounds it): the larger of bytes over the memory
        rate and bf16 operations over the tensor-core rate."""
        t_mem, t_ops = n_bytes / self.bw, n_flops / self.flops
        return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_attention(torch, peaks, B, N=1024, D=128, gen=None):
    import torch.nn.functional as F

    from cabinet_tpu_torch.ops.attention import (
        fused_global_attention,
        global_attention_plain,
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
        "ms": time_ms(lambda: fused_global_attention(q, k, v)),
        "plain_ms": time_ms(lambda: global_attention_plain(q, k, v)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
    }
    row["bound_ms"], row["bound_by"] = peaks.bound(
        B * N * 4 * D * 2, 2 * B * N * N * 2 * D)
    say("kernels", name="attention", **row)
    check(err <= bound, f"attention B={B}: max err {err} > bound {bound}")
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
          "ms": time_ms(lambda: dt.ffm_pointwise(*k2_args)),
          "plain_ms": time_ms(lambda: dt.ffm_pointwise_plain(*k2_args)),
          "library_ms": time_ms(lambda: torch.matmul(fcat, w1))}
    k2["bound_ms"], k2["bound_by"] = peaks.bound(
        P * (128 + 256 + 256) * 2 + sums.numel() * 4 + (384 * 256) * 2 + 256 * 4,
        2 * P * 384 * 256)
    k3 = {"shape": shape, "max_abs_err": err3, "bound": BOUND_K3 * top3,
          "ms": time_ms(lambda: dt.head_conv3x3(*k3_args)),
          "plain_ms": time_ms(lambda: dt.head_conv3x3_plain(*k3_args)),
          "library_ms": time_ms(lambda: lib_k3())}
    k3["bound_ms"], k3["bound_by"] = peaks.bound(
        P * (256 + n_classes) * 2 + B * 256 * 4 + (9 * 256 * 256 + 256 * n_classes) * 2
        + 256 * 4, 2 * P * 256 * (9 * 256 + n_classes))
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


def kernel_counts():
    from cabinet_tpu_torch.ops.attention import fused_global_attention
    from cabinet_tpu_torch.ops.decoder_tail import ffm_pointwise, head_conv3x3

    return {"attention": fused_global_attention.launches,
            "ffm_pointwise": ffm_pointwise.launches,
            "head_conv3x3": head_conv3x3.launches}


def reset_counts() -> None:
    from cabinet_tpu_torch.ops.attention import fused_global_attention
    from cabinet_tpu_torch.ops.decoder_tail import ffm_pointwise, head_conv3x3

    for fn in (fused_global_attention, ffm_pointwise, head_conv3x3):
        fn.launches = 0


def launched_each(fn):
    """Run fn(); fail unless K1, K2 and K3 each launched during it."""
    before = kernel_counts()
    out = fn()
    after = kernel_counts()
    missing = [k for k in after if after[k] <= before[k]]
    check(not missing, f"forward did not launch {missing}")
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


def run_segmenter(torch, size: int, ckpt: Path, n_requests: int = 3):
    """Segmenter at batch 1 (predict) and 8 (predict_batch), each mask held
    against the plain path's argmax. Returns {batch: (engine, inputs)}."""
    import numpy as np

    from cabinet_tpu_torch.cli.infer import Segmenter, load_state_dict
    from cabinet_tpu_torch.models.cabinet import CABiNet
    from cabinet_tpu_torch.models.fused import make_fused_tail_apply

    plain_model = CABiNet(8, "large", attention="plain")
    plain_model.load_state_dict(load_state_dict(ckpt, plain_model), strict=True)
    plain = make_fused_tail_apply(plain_model, DEVICE, torch.bfloat16, kernels=False)
    rng = np.random.default_rng(5)
    rgbs = [rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
            for _ in range(8)]
    engines = {}
    for batch in (1, 8):
        seg = Segmenter(str(ckpt), "uavid", mode="large", imgsz=size,
                        batch=batch, device=DEVICE)

        def answer():
            """The requests, each launching K1-K3, and the wall ms per image
            (host clock; the masks come back to the host, which syncs)."""
            t0 = time.perf_counter()
            if batch == 1:
                out = [launched_each(lambda: seg.predict(r)) for r in rgbs[:n_requests]]
            else:
                out = launched_each(lambda: seg.predict_batch(rgbs))
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
                    > 2 * BOUND_FORWARD * float(logits.abs().max())).cpu().numpy()
            same = mask == logits.argmax(-1).cpu().numpy()
            agree.append(float(same.mean()))
            sure_agree.append(float(same[sure].mean()))
        say("main", part="segmenter", batch=batch, requests=len(masks),
            wall_ms_per_img_first_calls=wall_ms, wall_ms_per_img_warm=warm_ms,
            argmax_agreement=agree,
            agreement_beyond_bound=sure_agree)
        check(min(sure_agree) == 1.0 and min(agree) >= 0.99,
              f"segmenter batch {batch}: agreement {agree}, "
              f"beyond the bound {sure_agree}")
        engines[batch] = (seg, torch.stack([seg._preprocess(r) for r in rgbs[:batch]]))
    return engines


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
    ptxas = []
    for src in _build.SOURCES:
        log = _build.BUILD_DIR / f"{src}.log"
        if log.exists():
            ptxas += [f"{src}: {ln.strip()}" for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln]
    say("build", seconds=round(seconds, 2), sources=list(_build.SOURCES))
    for ln in ptxas:
        print("  " + ln)

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    k1 = [check_attention(torch, peaks, B, gen=gen) for B in (1, 8)]
    tails = [check_tail(torch, peaks, S, n, B, gen)
             for S, n, B in ((128, 5, 1), (128, 8, 1), (90, 12, 1), (128, 8, 8))]

    reset_counts()
    run_fixture(torch, 1024)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "uavid_large_seeded.pth"
        seeded_uavid_checkpoint(torch, ckpt)
        engines = run_segmenter(torch, 1024, ckpt)
    launches = kernel_counts()
    check(all(n > 0 for n in launches.values()), f"launches {launches}")
    ms = {b: time_ms(lambda: seg._forward(x), iters=10) / b
          for b, (seg, x) in engines.items()}
    say("main", launches=launches, forward_ms_per_img_batch1=ms[1],
        forward_ms_per_img_batch8=ms[8])
    del engines

    run_attention_forward(torch, 1024)

    main_k2, main_k3 = tails[1]  # B=1, S=128, 8 classes: Segmenter on uavid
    rows = [
        ("attention", "csrc/attention.cu",
         "cabinet_tpu/ops/attention.py:26", k1[0], k1),
        ("ffm_pointwise", "csrc/decoder_tail.cu",
         "cabinet_tpu/ops/decoder_tail.py:94", main_k2, [t[0] for t in tails]),
        ("head_conv3x3", "csrc/decoder_tail.cu",
         "cabinet_tpu/ops/decoder_tail.py:110", main_k3, [t[1] for t in tails]),
    ]
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": f"cabinet_tpu_torch/{src}",
         "replaces": rep, "launches": launches[n],
         "max_abs_err": max(r["max_abs_err"] for r in every),
         "ms": main["ms"], "plain_ms": main["plain_ms"],
         "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
         "library_ms": main["library_ms"], "shape": main["shape"]}
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
