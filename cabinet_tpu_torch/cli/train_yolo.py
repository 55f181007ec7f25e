"""YOLO-sem training and validation on the GPU (counterpart of
`cabinet_tpu.cli.train_yolo`; reference src/scripts/train_yolo.py:191-295).

The reference wraps the external ultralytics package; here the in-repo
YOLOSem family (models/yolosem.py) trains under the same recipe: nbs
gradient accumulation (accum = max(round(nbs / batch), 1)), one-cycle cosine
LR with linear warmup, cls_pw class weights counted over the mosaic-wrapped
train set at epoch 0, mosaic / mixup / copy-paste (data/mosaic.py) with
close_mosaic, the CE loss on both heads (aux weight 0.4), EMA `best` /
`last` / `final` checkpoints (`.pth`, `train/checkpoint.py`; `last` is the
full state that `training_config.resume=true` continues from) and patience
early stopping. Val mode prints mIoU / pixel accuracy / per-class IoU and a
paste-ready metrics.json snippet (reference train_yolo.py:243-285).

Usage (CUDA unless --device cpu):
    python -m cabinet_tpu_torch.cli.train_yolo dataset=uavid
    python -m cabinet_tpu_torch.cli.train_yolo --config-name train_yolo_vdd \\
        'yolo/model@model=yolo26s-sem'
    python -m cabinet_tpu_torch.cli.train_yolo mode=val weights=exp/final.pth split=test

`+runtime.device_augs=true`: the base dataset ships geometric-only [0, 1]
crops, the host mosaic composes them (its own mixup off, the mean as its
pad value) and the aerial photometric chain plus the mixup and the
normalisation run on the device (`cli/train.py:DeviceAugment`, its draws
keyed on (runtime.seed + 11, epoch, batch)). `+runtime.loader=grain` reads
the train split on worker processes (`data/grain_loader.py`).
`runtime.device_geometric` raises ConfigurationError, as in the JAX
package.

`+runtime.pipeline=2|3` trains pipeline-parallel (`train/pipeline.py`):
trunk | neck and heads, or the trunk cut at P3 for 3 stages (the split the
deep variants want); one loader batch is one microbatch of the nbs
window, the device chain runs on stage 0's device with the fused path's
draws, `last.pth` keeps one tree a stage and `best`/`final` the merged
EMA weights. `YoloEval` scores the merged EMA weights.

Under torchrun each rank trains on its share of the global batch
`training_config.batch_size`, as `cli/train.py` does (data parallelism,
`core/mesh.py`; with the pipeline, each rank runs every stage on its
card); rank 0 alone writes the checkpoints. `YoloEval` resizes whole
frames (no tiles), so each rank scores its share of the val frames.
`runtime.mesh_data` sizes the data axis as in `cli/train.py` (0 or the
rank count: every rank trains); `runtime.model_axis > 1` raises, since
tensor parallelism covers CABiNet only (JAX's YOLO main never reads the
key).
"""

from __future__ import annotations

import json
import math
import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from cabinet_tpu_torch.cli import common
from cabinet_tpu_torch.core import mesh
from cabinet_tpu_torch.core.config import Config
from cabinet_tpu_torch.core.device import resolve_device
from cabinet_tpu_torch.core.logging import setup_logger

SUPPORTED_MODELS = {f"yolo26{v}-sem" for v in "nsmlx"}


def _build_model(cfg: Config):
    from cabinet_tpu_torch.models.yolosem import build_yolosem

    name = cfg.model.model_name
    if name not in SUPPORTED_MODELS:
        print(f"[WARN] model '{name}' is not in the supported list "
              f"{sorted(SUPPORTED_MODELS)}; trying anyway.")
    return build_yolosem(cfg.dataset.num_classes, name)


def nearest_indices(n_in: int, n_out: int) -> torch.Tensor:
    """The source index of each of `n_out` outputs of a nearest resize from
    `n_in`, sampled at half-pixel centres as `jax.image.resize(...,
    "nearest")` samples: torch's "nearest-exact" on the CPU, so every
    device gathers the same pixels."""
    src = torch.arange(n_in, dtype=torch.float32)[None, None]
    return F.interpolate(src, size=n_out, mode="nearest-exact")[0, 0].long()


class YoloEval:
    """Resize-to-imgsz eval (ultralytics' semantic protocol): the
    normalised images cast to the compute dtype, bilinearly resized to
    (imgsz, imgsz), the forward, the argmax, the predictions resized back
    to the native size by nearest sampling, and the confusion matrix on the
    device. `model` is held as a copy on `device` in the compute dtype;
    `evaluate(variables, loader)` loads `variables` (a state dict, e.g. the
    EMA weights) into it first, unless None; inside a process group of
    several ranks (each scoring its share of the frames) the confusion
    matrix is summed over the ranks."""

    def __init__(self, model: torch.nn.Module, n_classes: int, imgsz: int,
                 ignore_label: int, dtype: torch.dtype, device: torch.device):
        import copy

        self.net = copy.deepcopy(model).to(device=device, dtype=dtype).eval()
        self.n_classes = n_classes
        self.imgsz = imgsz
        self.ignore_label = ignore_label
        self.dtype = dtype
        self.device = device
        self._indices: Dict[tuple, torch.Tensor] = {}

    def _nearest(self, n_in: int, n_out: int) -> torch.Tensor:
        key = (n_in, n_out)
        if key not in self._indices:
            self._indices[key] = nearest_indices(n_in, n_out).to(self.device)
        return self._indices[key]

    @torch.no_grad()
    def hist(self, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """The (C, C) confusion matrix of one batch: images (B, H, W, 3)
        normalised, labels (B, H, W), both on the device."""
        from cabinet_tpu_torch.eval.metrics import confusion_matrix
        from cabinet_tpu_torch.models.cab import resize_bilinear

        x = images.to(self.dtype).permute(0, 3, 1, 2)
        H, W = x.shape[2:]
        size = (self.imgsz, self.imgsz)
        if (H, W) != size:
            x = resize_bilinear(x, size)
        logits, _ = self.net(x)
        preds = torch.argmax(logits, dim=1)
        if (H, W) != size:
            preds = preds.index_select(1, self._nearest(self.imgsz, H))
            preds = preds.index_select(2, self._nearest(self.imgsz, W))
        return confusion_matrix(preds, labels, self.n_classes, self.ignore_label)

    def evaluate(self, variables: Optional[Dict[str, torch.Tensor]], dataloader
                 ) -> Dict[str, Any]:
        from cabinet_tpu_torch.eval.metrics import metrics_from_hist

        if variables is not None:
            self.net.load_state_dict(variables, strict=True)
        hist = torch.zeros((self.n_classes, self.n_classes), dtype=torch.int64,
                           device=self.device)
        for images, labels in dataloader:
            hist += self.hist(torch.from_numpy(images).to(self.device, non_blocking=True),
                              torch.from_numpy(labels).to(self.device, non_blocking=True))
        hist = hist.cpu()
        if mesh.is_distributed():  # each rank scored its share of the frames
            hist = mesh.all_reduce_(mesh.host_tensor(hist.numpy(), torch.int64),
                                    tag="eval").cpu()
        return metrics_from_hist(hist.numpy().astype(np.float64))


def mosaic_train_set(cfg: Config):
    """The train split at imgsz crops, wrapped in the `MosaicSegDataset` that
    `train` reads. With runtime.device_augs the device chain owns the mixup
    (the host mosaic's would square its rate), so the host's is 0, and the
    host pads the raw [0, 1] crops with the mean."""
    from cabinet_tpu_torch.data.mosaic import MosaicSegDataset

    imgsz = int(cfg.training_config.imgsz)
    cfg.dataset.cropsize = [imgsz, imgsz]  # YOLO trains at imgsz crops
    (base,) = common.build_datasets(cfg, ["train"])
    device_augs = getattr(base, "photometric", "host") == "device"
    aug = cfg.get("augmentation")
    return MosaicSegDataset(
        base, mosaic=float(aug.get("mosaic", 0.8)),
        mixup=0.0 if device_augs else float(aug.get("mixup", 0.1)),
        copy_paste=float(aug.get("copy_paste", 0.15)), ignore_label=cfg.dataset.ignore_idx,
        seed=cfg.runtime.seed,
        pad_value=np.asarray(base.MEAN, np.float32) if device_augs else 0.0)


class _Samples:
    """`dataset` read at `indices` only, its `set_epoch` passed through; it
    pickles, so worker processes can hold it."""

    def __init__(self, dataset: Any, indices: np.ndarray):
        self.dataset, self.indices = dataset, indices

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.dataset[int(self.indices[i])]

    def set_epoch(self, epoch: int) -> None:
        self.dataset.set_epoch(epoch)


def class_pixel_counts(cfg: Config, dataset: Any, n_classes: int, ignore_label: int,
                       batch_size: int, num_workers: int, max_samples: int = 200
                       ) -> np.ndarray:
    """`data/class_weights.py:get_class_pixel_counts` of `dataset` at its
    epoch 0: the same evenly spaced samples, read through a loader of
    `runtime.loader`'s kind, on `num_workers` worker processes (grain) or
    in the caller (threads read these mosaic samples slower than the caller
    alone does: PERF.md §5)."""
    n = len(dataset)
    take = min(n, max_samples)
    idxs = np.linspace(0, n - 1, take).astype(int) if take > 1 else np.zeros(1, int)
    if str(cfg.select("runtime.loader", "thread")).lower() != "grain":
        num_workers = 0
    loader = common.make_loader(cfg, _Samples(dataset, idxs), batch_size,
                                num_workers=num_workers, seed=cfg.runtime.seed)
    loader.set_epoch(0)
    counts = np.zeros(n_classes, dtype=np.int64)
    try:
        for _, labels in loader:
            valid = labels[labels != ignore_label]
            counts += np.bincount(valid.astype(np.int64), minlength=n_classes)[:n_classes]
    finally:
        loader.close()
    return counts


def train(cfg: Config, device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """Train YOLO-sem on one device (one rank of several under torchrun);
    returns {"best_miou", "losses" (each
    epoch's last micro-batch loss), "timing"} (the training loops' seconds,
    the part of them spent waiting on the train loader, the micro-steps and
    optimizer steps this call took, the evaluations' seconds and the class
    counts' seconds, and the calls and host seconds of this rank's
    collectives by kind)."""
    from cabinet_tpu_torch.cli.train import (
        DeviceAugment,
        epoch_batches,
        join_ranks,
        pipeline_stages,
        spatial_axis,
        train_mesh,
    )
    from cabinet_tpu_torch.core.exceptions import ConfigurationError
    from cabinet_tpu_torch.data.class_weights import compute_class_weights
    from cabinet_tpu_torch.data.loader import DataLoader
    from cabinet_tpu_torch.train.checkpoint import CheckpointManager
    from cabinet_tpu_torch.train.early_stopping import EarlyStopping
    from cabinet_tpu_torch.train.optimizer import build_sgd, warmup_cosine_schedule
    from cabinet_tpu_torch.train.trainer import (
        TrainLoop,
        create_train_state,
        make_train_step,
    )

    if bool(cfg.select("runtime.device_geometric", False)):
        raise ConfigurationError(
            "runtime.device_geometric is not supported by the YOLO trainer "
            "(mosaic/copy-paste compose decoded crops on the host); use "
            "runtime.device_augs for the photometric chain")
    if int(cfg.select("runtime.model_axis", 1) or 1) > 1:
        raise ConfigurationError(
            "runtime.model_axis > 1: tensor parallelism (models/tensor_parallel.py) "
            "shards CABiNet only; the JAX package's YOLO main never reads the key "
            "and trains data-parallel")
    if spatial_axis(cfg):
        raise ConfigurationError(
            "runtime.spatial_axis: spatial partitioning (models/spatial_parallel.py) "
            "stripes CABiNet only; the JAX package's YOLO main never reads the key "
            "and trains data-parallel")
    pp_stages = pipeline_stages(cfg, "yolosem")
    device = join_ranks(cfg, device)
    train_mesh(cfg, pp_stages, "yolosem")  # runtime.mesh_data must tile the ranks
    rank, ranks = mesh.world()
    shard = (rank, ranks) if ranks > 1 else None
    primary = rank == 0
    tc, vc = cfg.training_config, cfg.validation_config
    logger = setup_logger("cabinet_tpu_torch.train_yolo", tc.experiments_path)
    common.seed_everything(cfg.runtime.seed)

    imgsz = int(tc.imgsz)
    ds_train = mosaic_train_set(cfg)
    base = ds_train.base
    (ds_val,) = common.build_datasets(cfg, ["val"])
    common.guard_val_batch(cfg, ds_val, vc.batch_size)
    device_augs = getattr(base, "photometric", "host") == "device"
    aug = cfg.get("augmentation")
    close_mosaic = int(aug.get("close_mosaic", 0))
    dl_train = common.make_loader(cfg, ds_train, mesh.local_batch_size(tc.batch_size),
                                  shuffle=True, drop_last=True, num_workers=tc.num_workers,
                                  seed=cfg.runtime.seed, shard=shard)
    dl_val = DataLoader(ds_val, vc.batch_size, num_workers=vc.num_workers, shard=shard)

    n_classes, ignore = cfg.dataset.num_classes, cfg.dataset.ignore_idx
    dtype = common.compute_dtype_of(cfg)
    model = _build_model(cfg).to(device)
    mesh.broadcast_module_(model)

    class_weights, tc0 = None, time.perf_counter()
    if float(tc.get("cls_pw", 0)) > 0:
        counts = class_pixel_counts(cfg, ds_train, n_classes, ignore, int(tc.batch_size),
                                    int(tc.num_workers))
        class_weights = compute_class_weights(counts, float(tc.cls_pw))
        logger.info(f"Class weights: {np.round(class_weights, 3).tolist()}")
    class_count_seconds = time.perf_counter() - tc0

    batches = epoch_batches(dl_train)
    accum = max(round(int(tc.nbs) / int(tc.batch_size)), 1)
    total_steps = math.ceil(int(tc.epochs) * batches / accum)
    warmup_steps = math.ceil(float(tc.warmup_epochs) * batches / accum)
    schedule = warmup_cosine_schedule(float(tc.lr0), float(tc.lrf), total_steps, warmup_steps)
    sgd = dict(momentum=float(tc.optimizer_momentum), wd=float(tc.optimizer_weight_decay))
    devices = [device]
    if pp_stages:  # trunk | neck+heads, or the trunk cut at P3 (3 stages)
        from cabinet_tpu_torch.train import pipeline as pp

        devices = pp.make_pipeline_devices(pp_stages, device)
    # the loop passes (epoch, batch) as the draw key, on the first device
    augment = (DeviceAugment(cfg, base, devices[0], (imgsz, imgsz),
                             seed=int(cfg.runtime.seed) + 11,
                             aug={**base.aug, "mixup": float(aug.get("mixup", 0.1))},
                             shard=shard)
               if device_augs else None)
    if pp_stages:
        keys, methods = ((pp.YOLOSEM_STAGE_KEYS, pp.YOLOSEM_STAGE_METHODS) if pp_stages == 2
                         else (pp.YOLOSEM_STAGE_KEYS_3, pp.YOLOSEM_STAGE_METHODS_3))
        pipe = pp.CabinetPipeline(
            model, lambda stage: build_sgd(stage, schedule, max_grad_norm=None, **sgd),
            n_min=1, num_microbatches=accum, devices=devices, ignore_label=ignore,
            class_weights=class_weights, aux_weight=0.4, loss_type="ce",
            compute_dtype=dtype, max_grad_norm=float(tc.max_grad_norm),
            ema_decay=float(tc.ema_decay), ema_tau=float(tc.ema_tau), stage_keys=keys,
            stage_methods=methods, aug_fn=augment)
        loop = pp.PipelineTrainLoop(pipe, pipe.init_state(model.state_dict()))
    else:
        loop = TrainLoop(
            create_train_state(
                model, build_sgd(model, schedule, max_grad_norm=float(tc.max_grad_norm),
                                 **sgd),
                ema_decay=float(tc.ema_decay), ema_tau=float(tc.ema_tau)),
            make_train_step(n_min=1, loss_type="ce", aux_weight=0.4, ignore_label=ignore,
                            class_weights=class_weights, accum_steps=accum,
                            compute_dtype=dtype),
            device, augment)

    evaluator = YoloEval(model, n_classes, imgsz, ignore, dtype, device)
    ckpt = CheckpointManager(Path(tc.experiments_path))
    stopper = EarlyStopping(int(tc.patience))
    best_miou, start_epoch = 0.0, 0
    if tc.resume:
        restored = ckpt.restore_full("last", loop.state)
        if restored:
            start_epoch = restored["epoch"] + 1
            best_miou = restored["best_miou"]
            stopper.load_state_dict({"best_fitness": restored["early_stop_best_fitness"],
                                     "best_epoch": restored["early_stop_best_epoch"]})
            logger.info(f"Resumed from epoch {restored['epoch']} (step {loop.step})")
    logger.info(f"{len(devices)} stage(s) on {devices}; accum={accum} "
                f"total_steps={total_steps} warmup_steps={warmup_steps}")

    timing = {"train_seconds": 0.0, "loader_wait_seconds": 0.0, "micro_steps": 0,
              "optimizer_steps": 0, "eval_seconds": 0.0,
              "class_count_seconds": class_count_seconds}
    step0, losses, mosaic_on = loop.step, [], True
    comm0 = {k: dict(v) for k, v in mesh.COMM.items()}
    try:
        for epoch in range(start_epoch, int(tc.epochs)):
            t0 = time.time()
            if mosaic_on and close_mosaic and epoch >= int(tc.epochs) - close_mosaic:
                ds_train.set_mosaic(False)
                mosaic_on = False
                dl_train.close()  # worker processes hold a copy of the dataset
            dl_train.set_epoch(epoch)
            last_loss = None
            tl = time.perf_counter()
            it, i = iter(dl_train), 0
            while True:
                if i >= batches:  # a longer shard's extra batch
                    it.close()
                    break
                tw = time.perf_counter()
                batch = next(it, None)
                timing["loader_wait_seconds"] += time.perf_counter() - tw
                if batch is None:
                    break
                loss = loop.feed(*batch, draw=(epoch, i))
                last_loss = last_loss if loss is None else loss
                i += 1
            timing["micro_steps"] += i
            loss = loop.flush()
            last_loss = last_loss if loss is None else loss
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            timing["train_seconds"] += time.perf_counter() - tl

            te = time.perf_counter()
            ema_vars = loop.weights(ema=True, device=device)
            res = evaluator.evaluate(ema_vars, dl_val)
            timing["eval_seconds"] += time.perf_counter() - te
            fitness = res["mIoU"]
            losses.append(float("nan") if last_loss is None else float(last_loss))
            logger.info(f"epoch {epoch}: loss {losses[-1]:.4f} mIoU {fitness:.4f} "
                        f"acc {res['accuracy']:.4f} ({time.time() - t0:.1f}s)")
            if fitness > best_miou:
                best_miou = fitness
                if primary:
                    ckpt.save_variables("best", ema_vars)
            should_stop = bool(mesh.broadcast_(mesh.host_tensor(
                int(stopper(epoch, fitness)), torch.int64)))  # rank 0's verdict
            if primary:
                ckpt.save_full("last", loop.state, epoch, best_miou, 0.0, stopper.state_dict())
            if should_stop:
                logger.info(f"Early stopping at epoch {epoch}")
                break
    finally:  # the workers start in the loop (runtime.loader=grain)
        dl_train.close()

    if primary:
        ckpt.save_variables("final", loop.weights(ema=True))
    timing["optimizer_steps"] = loop.step - step0
    timing["collectives"] = mesh.comm_since(comm0)
    return {"best_miou": best_miou, "losses": losses, "timing": timing}


def _weights_path(weights: Union[str, Path]) -> Path:
    """`weights` as given, or with `.pth` added (`exp/final` names the
    `exp/final.pth` that `train` writes, as the JAX CLI names its orbax
    directory)."""
    path = Path(weights)
    if not path.exists() and path.with_name(path.name + ".pth").exists():
        return path.with_name(path.name + ".pth")
    return path


def validate(cfg: Config, device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """Score `weights` (default <experiments_path>/best) on `split` and print
    the metrics and the metrics.json snippet."""
    from cabinet_tpu_torch.cli.infer import load_state_dict
    from cabinet_tpu_torch.data.loader import DataLoader

    device = resolve_device(device)
    tc, vc = cfg.training_config, cfg.validation_config
    split = cfg.get("split", "val")
    (dataset,) = common.build_datasets(cfg, [split])
    dl = DataLoader(dataset, vc.batch_size, num_workers=vc.num_workers)

    model = _build_model(cfg)
    weights = _weights_path(cfg.get("weights") or Path(tc.experiments_path) / "best")
    model.load_state_dict(load_state_dict(weights, model), strict=True)
    evaluator = YoloEval(model, cfg.dataset.num_classes, int(tc.imgsz),
                         cfg.dataset.ignore_idx, common.compute_dtype_of(cfg), device)
    res = evaluator.evaluate(None, dl)

    print(f"mIoU: {res['mIoU']:.4f}  pixel-acc: {res['accuracy']:.4f}")
    for k, v in res["iou_per_class"].items():
        print(f"  {k}: {v:.4f}")
    # Paste-ready metrics.json snippet (reference train_yolo.py:275-285).
    snippet = {
        "model": cfg.model.model_name,
        "dataset": cfg.dataset.name,
        "split": split,
        "mIoU": round(res["mIoU"] * 100, 2),
        "pixel_accuracy": round(res["accuracy"] * 100, 2),
        "per_class_iou": {k: round(v * 100, 2) for k, v in res["iou_per_class"].items()},
    }
    print("\nmetrics.json snippet:\n" + json.dumps(snippet, indent=2), flush=True)
    return res


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """`mode=val` validates; otherwise trains and prints one JSON line
    {"best_miou", "losses"}. Returns the result."""
    cfg, args = common.parse_cli(argv, "train_yolo", "Train/eval YOLO-sem on the GPU")
    if cfg.get("mode", "train") == "val":
        return validate(cfg, device=args.device)
    try:
        res = train(cfg, device=args.device)
    finally:
        mesh.teardown()
    if mesh.env_world()[0] == 0:
        print(json.dumps({"best_miou": res["best_miou"], "losses": res["losses"]}),
              flush=True)
    return res


if __name__ == "__main__":
    main()
