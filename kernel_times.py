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

With `--requests`, it times the request path instead of the kernels:
`Segmenter.predict` (batch 1, bf16, CABiNet-Large at 1024^2 from seeded
weights) and `Segmenter.predict_batch` (batch 8, 8 frames a call), on
uint8 frames of 1920x1080, 3840x2160 and 1024x1024 (noise from a seed), one
JSON line per call and size with `ms_per_img`: the median of 5 calls on the
host's clock (a call returns masks on the host), after 2 untimed calls.

With `--serve`, it times the checkpoint server of a checkout that has
one (`cli/serve.py`) as `chip_smoke.py` phase 11 loads it: bf16 Large at
1024^2, max_batch 8, 8 solo requests and then 32 clients x 4 requests of
1920x1080 noise PNGs from another process; one JSON line with the
server's stats, the clients' rate and latencies and the worker's step
(host clock) under load. The masks are not checked here (phase 11 does).

With `--loader`, it times train main's input on each loader as
`chip_smoke.py` phase 12 runs it (raw UAVid 3840x2160 Paeth frames through
`cli.convert`; CABiNet-Large, bf16, batch 4, crop 1024, 8 workers), but
over 20 optimizer steps: the 8 converted train frames are linked 5 times
over (40 records, 10 steps an epoch, 2 epochs). For the host recipe and
the device canvas, it runs thread, grain, thread, grain, each train main
in a fresh process (`python -m cabinet_tpu_torch.cli.train` as a user runs
it: the process loader starts its forkserver and workers in the loop), and
prints one JSON line per run: the loop's s per optimizer step and
loader-wait share over all steps, each epoch's wait for its first batch,
and the steady state, the steps after an epoch's first batch and before
its last (host clock). The batches are not checked here (phase 12 does).

With `--class-counts`, it times `cli/train_yolo.py`'s class counts over
the train set of `chip_smoke.py` phase 14's train main (phase 12's raw
UAVid tree through `cli.convert`; yolo26n-sem's mosaic-wrapped set at
imgsz 1024, epoch 0), four ways, each after the process loader's servers
are stopped: `get_class_pixel_counts` in this thread (the JAX package's
way), the thread loader with the config's 8 workers, and
`class_pixel_counts` with runtime.loader=thread and =grain (8 worker
processes, their start-up included). One JSON line per way, host clock,
with whether its counts equal the first way's.
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


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_requests(torch, label: str, smi: str) -> int:
    """`--requests`: the request path's ms per image (see the module's
    docstring)."""
    import tempfile
    import time

    import numpy as np

    from cabinet_tpu_torch.cli.infer import Segmenter

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "uavid_large_seeded.pth"
        chip_smoke.seeded_uavid_checkpoint(torch, ckpt)
        segs = {b: Segmenter(str(ckpt), "uavid", imgsz=1024, dtype_name="bfloat16",
                             batch=b, device=chip_smoke.DEVICE) for b in (1, 8)}
    rng = np.random.default_rng(0)
    for hw in ((1080, 1920), (2160, 3840), (1024, 1024)):
        frames = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(8)]
        for name, fn, n in (
                ("predict", lambda: [segs[1].predict(f) for f in frames], 8),
                ("predict_batch", lambda: segs[8].predict_batch(frames), 8)):
            ms = []
            for k in range(7):
                t0 = time.perf_counter()
                fn()
                if k >= 2:
                    ms.append((time.perf_counter() - t0) * 1e3 / n)
            print(json.dumps({"label": label, "card": smi, "name": name,
                              "shape": f"{hw[1]}x{hw[0]}",
                              "ms_per_img": statistics.median(ms)}), flush=True)
    return 0


def time_server(torch, label: str, smi: str) -> int:
    """`--serve`: the checkpoint server's rate and latencies (see the
    module's docstring)."""
    import tempfile
    import time

    import numpy as np

    from cabinet_tpu_torch.cli.serve import _Engine
    from cabinet_tpu_torch.data.decode import encode_png

    cs = chip_smoke
    frames = cs.serve_frames(np, cs.SERVE_FRAMES, cs.SERVE_H, cs.SERVE_W, seed=71)
    bodies = [encode_png(f) for f in frames]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "uavid_large_seeded.pth"
        cs.seeded_uavid_checkpoint(torch, ckpt)
        engine = _Engine(None, str(ckpt), "uavid", "large", cs.SERVE_SIZE, "bfloat16",
                         max_batch=cs.SERVE_MAX_BATCH, deadline_ms=cs.SERVE_DEADLINE_MS,
                         queue_depth=cs.SERVE_QUEUE, device=cs.DEVICE)
    step, worker_ms = engine.batcher.infer_batch, []

    def timed(xs, regime):
        t0 = time.perf_counter()
        out = step(xs, regime)
        worker_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    engine.batcher.infer_batch = timed
    with cs.Serving(engine) as url:
        solo = [cs.post_raw(url, bodies[i])[2] for i in range(8)]
        worker_ms.clear()
        engine.batcher.reset_stats()
        jobs = [[(c * cs.SERVE_PER_CLIENT + k) % len(bodies) for k in range(cs.SERVE_PER_CLIENT)]
                for c in range(cs.SERVE_CLIENTS)]
        answers, wall = cs.concurrent_requests(url, bodies, jobs)
        stats = engine.stats()
    client_ms = [ms for *_, ms in answers]
    print(json.dumps({
        "label": label, "card": smi, "name": "serve",
        "shape": f"{cs.SERVE_W}x{cs.SERVE_H} {cs.SERVE_CLIENTS}x{cs.SERVE_PER_CLIENT}",
        "statuses": sorted({s for _, s, _, _ in answers}), "server": stats,
        "client_requests_per_s": len(answers) / wall,
        "client_latency_ms_p50": cs.percentile(client_ms, 0.5),
        "client_latency_ms_p99": cs.percentile(client_ms, 0.99),
        "solo_ms": solo, "worker_step_ms_p50": cs.percentile(worker_ms, 0.5),
        "worker_step_ms_max": max(worker_ms)}), flush=True)
    return 0


LOADER_COPIES, LOADER_EPOCHS, LOADER_RUNS = 5, 2, 2


def link_train_copies(dst: Path, copies: int) -> int:
    """Each converted train frame and mask linked `copies - 1` more times
    under new names (c<k>_<name>); returns the train records now there."""
    for sub in ("images", "masks"):
        d = dst / sub / "train"
        for f in sorted(d.iterdir()):
            for k in range(1, copies):
                (d / f"c{k}_{f.name}").symlink_to(f.resolve())
    return len(list((dst / "images" / "train").iterdir()))


def loader_child(out: Path, argv) -> int:
    """One train main in this process, its train loader clocked; writes its
    timing and the loader's (asked, got) stamps by pass to `out`."""
    from cabinet_tpu_torch.cli.train import main as train_main

    with chip_smoke.BatchClock() as clock:
        res, main_s, _ = chip_smoke.run_cli(train_main, argv, "train", 1)
    out.write_text(json.dumps({"main_seconds": main_s, "timing": res["timing"],
                               "passes": clock.passes}))
    return 0


def steady(passes):
    """(s per step, wait share, steps) over the steps after each pass's
    first batch and before its last: the loop's time from one batch's
    request to the next's."""
    loop = wait = 0.0
    n = 0
    for stamps in passes:
        for (asked, got), (nxt, _) in zip(stamps[1:-1], stamps[2:]):
            loop += nxt - asked
            wait += got - asked
            n += 1
    return loop / n, wait / loop, n


def time_loaders(torch, label: str, smi: str, root: Path) -> int:
    """`--loader`: train main's loop on each loader over 20 steps (see the
    module's docstring)."""
    import tempfile
    import time

    import numpy as np

    from cabinet_tpu_torch.cli.convert import main as convert_main

    cs = chip_smoke
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        src, dst = tmp / "uavid_raw", tmp / "uavid"
        cs.write_uavid_raw(np, src, cs.UAVID_H, cs.UAVID_W)
        cs.run_cli(convert_main, ["uavid", "--src", str(src), "--dst", str(dst),
                                  "--workers", "8"], "convert", 1)
        records = link_train_copies(dst, LOADER_COPIES)
        for recipe in cs.DATA_RECIPES:
            for k, loader in enumerate(("thread", "grain") * LOADER_RUNS):
                out, exp = tmp / f"{recipe}_{k}.json", tmp / f"exp_{recipe}_{k}"
                argv = cs.data_train_argv(dst, recipe, loader, LOADER_EPOCHS) + [
                    f"training_config.experiments_path={exp}", "--device", cs.DEVICE]
                t0 = time.perf_counter()
                subprocess.run([sys.executable, str(Path(__file__).resolve()), "--root",
                                str(root), "--loader-child", str(out), "--", *argv],
                               check=True, timeout=900)
                process_s = time.perf_counter() - t0
                got = json.loads(out.read_text())
                t = got["timing"]
                loop, share, n = steady(got["passes"])
                print(json.dumps({
                    "label": label, "card": smi, "name": "loader", "recipe": recipe,
                    "loader": loader, "run": k, "records": records,
                    "optimizer_steps": t["optimizer_steps"], "process_seconds": process_s,
                    "main_seconds": got["main_seconds"],
                    "loop_seconds_per_optimizer_step": t["train_seconds"] / t["optimizer_steps"],
                    "loader_wait_share": t["loader_wait_seconds"] / t["train_seconds"],
                    "epoch_first_batch_wait_seconds": cs.first_waits(got["passes"]),
                    "steady_seconds_per_step": loop, "steady_loader_wait_share": share,
                    "steady_steps": n}), flush=True)
    return 0


def time_class_counts(label: str, smi: str) -> int:
    """`--class-counts`: train_yolo's class counts four ways (see the
    module's docstring)."""
    import tempfile
    import time

    import numpy as np

    from cabinet_tpu_torch.cli import common
    from cabinet_tpu_torch.cli.convert import main as convert_main
    from cabinet_tpu_torch.cli.train_yolo import class_pixel_counts, mosaic_train_set
    from cabinet_tpu_torch.data.class_weights import get_class_pixel_counts
    from cabinet_tpu_torch.data.loader import DataLoader

    cs = chip_smoke
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        src, dst = tmp / "uavid_raw", tmp / "uavid"
        cs.write_uavid_raw(np, src, cs.UAVID_H, cs.UAVID_W)
        cs.run_cli(convert_main, ["uavid", "--src", str(src), "--dst", str(dst),
                                  "--workers", "8"], "convert", 1)
        argv = [a for a in cs.yolo_train_argv(dst, tmp / "exp", 2) if "runtime.loader" not in a]
        cfg, _ = common.parse_cli(argv, "train_yolo", "class counts")
        grain, _ = common.parse_cli(["+runtime.loader=grain", *argv], "train_yolo",
                                    "class counts")
        nc, ignore = cfg.dataset.num_classes, cfg.dataset.ignore_idx
        batch, workers = int(cfg.training_config.batch_size), int(cfg.training_config.num_workers)

        def threads(ds):
            counts = np.zeros(nc, np.int64)
            for _, labels in DataLoader(ds, batch, num_workers=workers):
                valid = labels[labels != ignore]
                counts += np.bincount(valid.astype(np.int64), minlength=nc)[:nc]
            return counts

        ways = (("get_class_pixel_counts", lambda ds: get_class_pixel_counts(ds, nc, ignore)),
                ("thread_loader_8_threads", threads),
                ("class_pixel_counts_thread",
                 lambda ds: class_pixel_counts(cfg, ds, nc, ignore, batch, workers)),
                ("class_pixel_counts_grain",
                 lambda ds: class_pixel_counts(grain, ds, nc, ignore, batch, workers)))
        first = None
        for way, count in ways:
            cs.cold_forkserver()
            ds = mosaic_train_set(cfg)
            t0 = time.perf_counter()
            counts = count(ds)
            seconds = time.perf_counter() - t0
            first = counts if first is None else first
            equal = bool(np.array_equal(counts, first))
            print(json.dumps({"label": label, "card": smi, "name": "class_counts", "way": way,
                              "samples": len(ds), "seconds": seconds,
                              "equal_to_first": equal}), flush=True)
            if not equal:
                return 1
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent)
    ap.add_argument("--label", default="")
    ap.add_argument("--splits", action="store_true",
                    help="also sweep K1's split count")
    ap.add_argument("--requests", action="store_true",
                    help="time Segmenter.predict/predict_batch instead")
    ap.add_argument("--serve", action="store_true",
                    help="time the checkpoint server instead")
    ap.add_argument("--loader", action="store_true",
                    help="time train main's loop on each loader instead")
    ap.add_argument("--class-counts", action="store_true",
                    help="time train_yolo's class counts instead")
    ap.add_argument("--loader-child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("overrides", nargs="*", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if args.loader_child:  # one run of --loader, on the device its overrides name
        sys.path.insert(0, str(args.root.resolve()))
        return loader_child(args.loader_child, args.overrides)

    if not torch.cuda.is_available():
        print("kernel_times: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    if args.requests:
        return time_requests(torch, args.label, card())
    if args.serve:
        return time_server(torch, args.label, card())
    if args.loader:
        return time_loaders(torch, args.label, card(), args.root.resolve())
    if args.class_counts:
        return time_class_counts(args.label, card())
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

    smi = card()
    for name, shape, fn in cases:
        ms = [chip_smoke.time_ms(fn) for _ in range(REPEATS)]
        dms = [chip_smoke.graph_ms(fn) for _ in range(REPEATS)]
        print(json.dumps({"label": args.label, "card": smi, "name": name,
                          "shape": shape, "ms": statistics.median(ms),
                          "device_ms": statistics.median(dms)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
