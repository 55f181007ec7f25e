"""One train step of every parallel strategy across N ranks at tiny shapes
(counterpart of the JAX package's `__graft_entry__.py:dryrun_multichip`).

    python -m cabinet_tpu_torch.cli.dryrun_multichip --ranks 2
    python -m cabinet_tpu_torch.cli.dryrun_multichip --ranks 2 --device cpu

It starts its own N rank processes, as JAX provisions its own devices:
each joins one process group (gloo on the CPU; on CUDA, NCCL when every
rank has its own card, else gloo with ranks sharing cards) and runs every
strategy in turn on JAX's shapes (the truncated small CABiNet, 5 classes,
64x64, a global batch of N):
  - data parallelism with accum_steps=2;
  - device augmentation (`cli/train.py:DeviceAugment`) with the exact warp
    and with the shared warp, each feeding a train step;
  - tile-sharded eval of an 80x72 frame, its confusion matrix summing to
    every pixel;
  - tensor parallelism on an (N/2, 2) mesh at tp_min_features 48, and its
    model-sharded eval's matrix bit-equal to the replicated model's;
  - spatial partitioning at batch 1, the rows striped over N ranks;
  - the 2-stage pipeline, plain and with device augmentation;
  - the pipeline with its stages cut over model groups of 2 (PP x TP);
  - YOLO-sem's 3-stage pipeline.
Each rank runs every stage of a pipeline (the port's intra-stage data
parallelism), so N=2 runs every strategy (JAX needs 8 devices for PP x
TP and 6 for 3 stages); TP and PP x TP need an even N. Rank 0 prints one
line a strategy and a last `dryrun_multichip OK` line; any non-finite
loss, wrong matrix or failed rank exits non-zero. The ranks compute in f32
with TF32 off. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

CFGS = [[3, 1, 16, 0, 0, 1], [3, 4, 24, 0, 0, 2], [5, 3, 40, 1, 0, 2], [5, 6, 96, 1, 1, 2]]
NC, H, W = 5, 64, 64
OPT = dict(lr0=1e-2, max_iter=100, warmup_steps=10)
AUG = {"degrees": 10.0, "translate": 0.05, "scale": 0.3, "fliplr": 0.5, "flipud": 0.2,
       "mixup": 0.1}
EVAL_H, EVAL_W = 80, 72
TIMEOUT_S = 600


class _AugSource:
    """What `DeviceAugment` reads of a dataset: the canvas recipe's
    attributes (JAX's dry run's augmentation, the aerial chain)."""
    geometric, photometric, RECIPE = "device", "device", "aerial"
    aug = AUG
    MEAN, STD = (0.48, 0.5, 0.46), (0.22, 0.21, 0.23)


def _strategies(torch, device) -> List[Dict[str, Any]]:
    """Every strategy on this rank; a list of {"name", "loss" | "hist_sum",
    "ok", "seconds"}."""
    from cabinet_tpu_torch.cli.train import DeviceAugment
    from cabinet_tpu_torch.core import mesh
    from cabinet_tpu_torch.core.config import Config
    from cabinet_tpu_torch.eval.evaluator import MscEval
    from cabinet_tpu_torch.models import tensor_parallel as tp
    from cabinet_tpu_torch.models.cabinet import CABiNet
    from cabinet_tpu_torch.models.spatial_parallel import spatial_parallel
    from cabinet_tpu_torch.models.yolosem import YOLOSem
    from cabinet_tpu_torch.train import pipeline as pp
    from cabinet_tpu_torch.train import trainer as T
    from cabinet_tpu_torch.train.optimizer import GroupedSGD

    rank, n = mesh.world()
    B = n  # the fused steps' global batch; a pipeline's 2 microbatches take 2B
    rng = np.random.default_rng(0)
    images = rng.normal(size=(2 * B, H, W, 3)).astype(np.float32)
    labels = rng.integers(0, NC, (2 * B, H, W))
    canvas = rng.integers(0, 256, (2 * B, 2 * H, 2 * W, 3)).astype(np.uint8)
    lbl_canvas = rng.integers(0, NC, (2 * B, 2 * H, 2 * W)).astype(np.uint8)
    hw = np.tile(np.asarray([[H + 7, W + 3]], np.int32), (2 * B, 1))
    frame = rng.normal(size=(1, EVAL_H, EVAL_W, 3)).astype(np.float32)
    frame_lbl = rng.integers(0, NC, (1, EVAL_H, EVAL_W)).astype(np.int64)
    torch.manual_seed(0)
    start = CABiNet(NC, mode="small", cfgs=CFGS).state_dict()
    n_min = B * H * W // 16
    out: List[Dict[str, Any]] = []

    def mine(a, m, j=0):  # this data rank's rows of global batch j (the loader's shard)
        return a[j * B:(j + 1) * B][m.data_rank::m.n_data]

    def model_on(m, min_features=48):
        model = CABiNet(NC, mode="small", cfgs=CFGS)
        model.load_state_dict(start)
        return tp.tensor_parallel(model.to(device), m, min_features)

    def fused(model, accum=1):
        opt = GroupedSGD(model, max_grad_norm=1.0, **OPT)
        return (T.create_train_state(model, opt),
                T.make_train_step(n_min=n_min, accum_steps=accum))

    def put(*arrays):
        return [torch.as_tensor(a).to(device) for a in arrays]

    def augment(warp, m):
        cfg = Config({"runtime": {"device_geometric": warp, "seed": 0},
                      "dataset": {"ignore_idx": 255}})
        return DeviceAugment(cfg, _AugSource, device, (H, W), shard=(m.data_rank, m.n_data))

    def hist(model, m):
        model.eval()

        def fwd(_, x):
            with torch.no_grad():
                return tuple(t.permute(0, 2, 3, 1) for t in model(x.permute(0, 3, 1, 2)))
        tile = (m.data_rank, m.n_data) if m.n_data > 1 else None
        with mesh.using(m):
            return MscEval(fwd, NC, scales=(1.0,), cropsize=32, device=device,
                           tile_mesh=tile).hist_batch(None, frame, frame_lbl)

    def run(name: str, fn: Callable[[], Dict[str, Any]]) -> None:
        t0 = time.perf_counter()
        rec = fn()
        if "loss" in rec:
            rec["loss"] = float(rec["loss"])
            rec["ok"] = rec.get("ok", True) and math.isfinite(rec["loss"])
        out.append({"name": name, "seconds": time.perf_counter() - t0, **rec})

    dp = mesh.make_mesh(n, 1)
    mesh.set_mesh(dp)
    state, step = fused(model_on(dp), accum=2)

    def dp_step():
        nonlocal state
        state, loss = step(state, *put(mine(images, dp), mine(labels, dp)))
        return {"loss": loss}

    def aug_step(warp):
        def go():
            nonlocal state
            x, y = augment(warp, dp)((mine(canvas, dp), mine(lbl_canvas, dp), mine(hw, dp)),
                                     state.step, state.micro_step)
            state, loss = step(state, x, y)
            return {"loss": loss}
        return go

    def tile_eval():
        h = hist(state.model, dp)
        return {"hist_sum": int(h.sum()), "ok": int(h.sum()) == EVAL_H * EVAL_W}

    run("dp_accum2", dp_step)
    run("device_aug_exact", aug_step("true"))
    run("device_aug_shared", aug_step("shared"))
    run("tile_sharded_eval", tile_eval)

    even = n % 2 == 0
    if even:
        tpm = mesh.make_mesh(n // 2, 2)
        mesh.set_mesh(tpm)

        def tp_step():
            st, stp = fused(model_on(tpm))
            st, loss = stp(st, *put(mine(images, tpm), mine(labels, tpm)))
            whole = model_on(mesh.Mesh(tpm.n_data, 1, tpm.data_rank, tpm.data_group))
            whole.load_state_dict(tp.gather_state(st.ema.state_dict(), st.model))
            ema = model_on(tpm)
            ema.load_state_dict(st.ema.state_dict())
            h_tp, h_whole = hist(ema, tpm), hist(whole, tpm)
            split = sum(d is not None for d in tp.state_dims(st.model).values())
            return {"loss": loss, "split_leaves": split, "hist_sum": int(h_tp.sum()),
                    "ok": bool(split > 0 and np.array_equal(h_tp, h_whole)
                               and int(h_tp.sum()) == EVAL_H * EVAL_W)}
        run("tensor_parallel", tp_step)

    mesh.set_mesh(dp)
    sp_h = 16 * n * -(-H // (16 * n))  # the rows a multiple of n x the model's stride

    def sp_step():
        model = spatial_parallel(model_on(dp), dp)
        st, stp = fused(model)
        x = rng.normal(size=(1, sp_h, W, 3)).astype(np.float32)
        y = rng.integers(0, NC, (1, sp_h, W))
        st, loss = stp(st, *put(x, y))
        return {"loss": loss, "rows": sp_h // n}
    run("spatial_parallel", sp_step)

    def pipeline(model, m, aug=None, **kw):
        pipe = pp.CabinetPipeline(model, lambda s: GroupedSGD(s, **OPT), n_min=n_min,
                                  num_microbatches=2, max_grad_norm=1.0, aug_fn=aug, **kw)
        loop = pp.PipelineTrainLoop(pipe, pipe.init_state(model.state_dict()))
        losses = []
        for j in range(2):
            batch = ((mine(canvas, m, j), mine(lbl_canvas, m, j), mine(hw, m, j))
                     if aug is not None else put(mine(images, m, j), mine(labels, m, j)))
            losses.append(loop.feed(*batch))
        return {"loss": [v for v in losses if v is not None][-1]}

    run("pipeline_2_stages", lambda: pipeline(model_on(dp), dp, devices=[device] * 2))
    run("pipeline_device_aug", lambda: pipeline(model_on(dp), dp, augment("true", dp),
                                                devices=[device] * 2))
    if even:
        mesh.set_mesh(tpm)
        run("pipeline_x_tensor_parallel", lambda: pipeline(model_on(tpm), tpm,
                                                           devices=[device] * 2))
        mesh.set_mesh(dp)

    def yolo():
        torch.manual_seed(0)
        model = YOLOSem(NC, "n").to(device)
        return pipeline(model, dp, devices=[device] * 3, stage_keys=pp.YOLOSEM_STAGE_KEYS_3,
                        stage_methods=pp.YOLOSEM_STAGE_METHODS_3, loss_type="ce",
                        aux_weight=0.4)
    run("yolosem_3_stages", yolo)
    return out


def rank_main(device: str, backend: str, folder: Path) -> int:
    """One rank: join the group, run every strategy, write the records."""
    import torch

    from cabinet_tpu_torch.core import mesh

    torch.set_num_threads(1)
    # f32 throughout, TF32 off: the model-sharded eval's matrix is held to the
    # replicated model's bit for bit, and cuDNN's TF32 convs round apart
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.setup(device, backend, timeout_s=120)
    try:
        recs = _strategies(torch, dev)
        with open(folder / f"rank{mesh.world()[0]}.json", "w") as f:
            json.dump(recs, f)
    finally:
        mesh.teardown()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Start `--ranks` rank processes, wait for them, print one line a
    strategy; returns 0 when every rank ran every strategy to a finite
    loss and the eval matrices held, else 1."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    # a rank process's own: the records' folder and the group's backend
    ap.add_argument("--rank-of", dest="rank_of", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--backend", default="gloo", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_of is not None:
        return rank_main(args.device, args.backend, Path(args.rank_of))
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("dryrun_multichip: no CUDA device (use --device cpu)", file=sys.stderr)
            return 2
        cards = torch.cuda.device_count()
    backend = "nccl" if args.device == "cuda" and args.ranks <= cards else "gloo"
    root = str(Path(__file__).resolve().parents[2])
    port, procs = _free_port(), []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for r in range(args.ranks):
                env = {**os.environ, "RANK": str(r), "WORLD_SIZE": str(args.ranks),
                       "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(args.ranks),
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                       "OMP_NUM_THREADS": "1",
                       "PYTHONPATH": os.pathsep.join([root, os.environ.get("PYTHONPATH", "")])}
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "cabinet_tpu_torch.cli.dryrun_multichip",
                     "--device", args.device, "--backend", backend, "--rank-of", tmp],
                    env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        for r in failed:
            print(f"dryrun_multichip: rank {r} exited {procs[r].returncode}:\n"
                  f"{logs[r][-3000:]}", file=sys.stderr)
        recs = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                for r in range(args.ranks) if r not in failed]
    if failed:
        return 1
    ok = True
    for i, rec in enumerate(recs[0]):
        every = [rs[i] for rs in recs]
        good = all(r["ok"] for r in every)
        ok = ok and good
        fields = {k: v for k, v in rec.items() if k not in ("name", "ok", "seconds")}
        print(f"dryrun_multichip {rec['name']}: {'ok' if good else 'FAILED'} "
              f"{json.dumps(fields)} {max(r['seconds'] for r in every):.2f}s", flush=True)
    print(f"dryrun_multichip {'OK' if ok else 'FAILED'}: ranks={args.ranks} "
          f"device={args.device} backend={backend} strategies={len(recs[0])} "
          f"seconds={time.perf_counter() - t0:.1f}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
