"""CABiNet training on the GPU (counterpart of `cabinet_tpu.cli.train`;
reference src/scripts/train.py:203-607).

Usage (CUDA unless --device cpu):
    python -m cabinet_tpu_torch.cli.train dataset=cityscapes \\
        dataset.dataset_path=DIR training_config.epochs=2
    python -m cabinet_tpu_torch.cli.train dataset=uavid validation_config.batch_size=1

The loop: the train split through the host recipe -> class weights -> train
steps (OHEM on both heads, 1/accum scaling, clipping of the summed
gradients, grouped SGD with warmup+poly, EMA) -> at each epoch's end the
flush of a trailing window, the val loss on the raw weights, a
single-scale mIoU on the EMA weights, `metrics.jsonl` and the checkpoints
(`checkpoint_last.pth` every epoch, `<name>_best.pth` on a better mIoU) ->
early stop on patience -> the final EMA weights `<name>.pth` and
`config.yaml` -> the multi-scale eval of the EMA weights.
`training_config.resume=true` continues from `checkpoint_last.pth`
exactly. A KeyboardInterrupt saves before the final eval (reference
train.py:569-580).

With `runtime.use_pallas=true` the val loss and the evaluations run the
attention kernel K1 (bf16 or f32 by `runtime.compute_dtype`, under
no_grad); the train steps never do (the kernel has no backward, and the
step runs the CAB's einsum attention). Each evaluation runs the model's
forward (no fused tail) on a copy of the EMA weights, cast to the compute
dtype: the f32 master weights are never cast.

Device augmentation (`DeviceAugment`): with `runtime.device_augs=true` the
train loader ships the host recipe's geometric crops raw, and the
photometric chain (and the aerial mixup) runs on the training device; with
`runtime.device_geometric=true|shared` the loader ships u8 canvases and the
warp runs there too (`shared`: one rotation and scale a batch). The chain
is the dataset's `RECIPE`'s, aerial or street. `runtime.reduced_decode` and
`runtime.decode_cache` act on the canvas path. `runtime.remat=true|N`
rematerialises backbone blocks in the backward.

Not ported, each raising with the ROADMAP item it waits for:
`runtime.pipeline`, `runtime.model_axis > 1`, `runtime.spatial_axis`,
multi-process training (Queue 1 item 7), `runtime.loader=grain` and
`--legacy-config` (item 8).
"""

from __future__ import annotations

import json
import math
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from cabinet_tpu_torch.cli import common
from cabinet_tpu_torch.core.config import Config, save_config, to_yaml
from cabinet_tpu_torch.core.device import resolve_device
from cabinet_tpu_torch.core.exceptions import ConfigurationError
from cabinet_tpu_torch.core.logging import is_primary_process, setup_logger


def refuse_unported(cfg: Config) -> None:
    """Raise for the settings whose code is not ported, naming the ROADMAP
    item each waits for."""
    checks = [
        (int(cfg.select("runtime.pipeline", 0) or 0) > 0,
         "runtime.pipeline (pipeline parallelism)", "Queue 1 item 7"),
        (int(cfg.select("runtime.model_axis", 1) or 1) > 1,
         "runtime.model_axis > 1 (tensor parallelism)", "Queue 1 item 7"),
        (bool(cfg.select("runtime.spatial_axis", False)),
         "runtime.spatial_axis (spatial partitioning)", "Queue 1 item 7"),
        (int(os.environ.get("WORLD_SIZE", "1")) > 1
         or (torch.distributed.is_available() and torch.distributed.is_initialized()
             and torch.distributed.get_world_size() > 1),
         "multi-process training", "Queue 1 item 7"),
    ]
    for on, what, item in checks:
        if on:
            raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class DeviceAugment:
    """The train recipe's device side for `ds_train`'s batches: the warp
    (`runtime.device_geometric`) and the photometric chain of its `RECIPE`,
    then the normalisation, on `device`.

    The draws for a batch come from `(runtime.seed + 1, step, micro_step)`:
    every per-sample parameter from a numpy Generator on the host, the
    noise from a torch Generator on `device`. So a resume redraws what the
    uninterrupted run drew, no draw waits on the device, and two
    micro-batches of one accumulation window draw apart (the JAX package
    keys on the step alone)."""

    def __init__(self, cfg: Config, ds_train: Any, device: torch.device,
                 crop_hw: Tuple[int, int]):
        self.geometric = getattr(ds_train, "geometric", "host") == "device"
        self.shared = str(cfg.select("runtime.device_geometric", False)).lower() == "shared"
        self.street = getattr(ds_train, "RECIPE", "aerial") == "street"
        self.aug = dict(ds_train.aug)
        self.mean, self.std = ds_train.MEAN, ds_train.STD
        self.crop_hw = crop_hw
        self.ignore_label = int(cfg.dataset.ignore_idx)
        self.seed = int(cfg.runtime.seed) + 1
        self.device = device
        self.noise = torch.Generator(device=device)

    def draws(self, step: int, micro_step: int) -> np.random.Generator:
        """The host Generator of a batch; seeds the noise Generator too."""
        key = [self.seed, int(step), int(micro_step)]
        self.noise.manual_seed(int(np.random.SeedSequence(key).generate_state(1)[0]))
        return np.random.default_rng(key)

    def __call__(self, batch, step: int, micro_step: int):
        """(normalised images (B, Hc, Wc, 3) f32, labels int64) on the
        device, from a loader batch: (canvas u8, label canvas u8, (h, w)) or
        (raw images, labels)."""
        from cabinet_tpu_torch.ops import geometric as G
        from cabinet_tpu_torch.ops import photometric as P

        rng = self.draws(step, micro_step)
        staged = [torch.from_numpy(a).to(self.device, non_blocking=True) for a in batch[:2]]
        if self.geometric:
            images, labels = G.geometric_pipeline(*staged, batch[2], rng, self.aug,
                                                  self.crop_hw, self.ignore_label,
                                                  shared_linear=self.shared)
        else:
            images, labels = staged
        B, H, W = images.shape[:3]
        if self.street:
            params, chain = (P.sample_street_photometric(rng, B, H, W),
                             P.street_photometric_pipeline)
        else:
            params, chain = P.sample_photometric(rng, B, H, W, self.aug), P.photometric_pipeline
        z = torch.randn(images.shape, generator=self.noise, device=self.device)
        return chain(images, labels, P.params_to_device(params, self.device), z,
                     self.mean, self.std)


class _DeviceClock:
    """Seconds of device work between start() and stop(): CUDA events on a
    CUDA device (summed in seconds(), after the caller's synchronize), the
    host clock on the CPU, whose ops are synchronous."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.events: List[Any] = []
        self.total = 0.0

    def start(self) -> Any:
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def stop(self, started: Any) -> None:
        if not self.cuda:
            self.total += time.perf_counter() - started
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((started, ev))

    def seconds(self) -> float:
        self.total += sum(a.elapsed_time(b) for a, b in self.events) / 1e3
        self.events = []
        return self.total


def _metrics_line(path: Path, record: Dict[str, Any]) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def train_and_evaluate(cfg: Config, device: Union[str, torch.device] = "cuda"
                       ) -> Dict[str, Any]:
    """Train `cfg` on one device and return {"best_miou", "final" (the
    final multi-scale eval's result), "timing"}. `timing` holds the
    training loops' seconds, the part of them spent waiting on the train
    loader and the seconds of device augmentation in them, the micro-steps
    and optimizer steps this call took, and the seconds of the val losses
    and evaluations."""
    from cabinet_tpu_torch.cli.evaluate import make_eval_forward
    from cabinet_tpu_torch.core.constants import OHEM_DIVISOR
    from cabinet_tpu_torch.data.class_weights import (
        compute_class_weights,
        get_class_pixel_counts,
    )
    from cabinet_tpu_torch.data.loader import DataLoader
    from cabinet_tpu_torch.eval.evaluator import MscEval
    from cabinet_tpu_torch.train.checkpoint import CheckpointManager
    from cabinet_tpu_torch.train.early_stopping import EarlyStopping
    from cabinet_tpu_torch.train.optimizer import GroupedSGD
    from cabinet_tpu_torch.train.trainer import (
        create_train_state,
        make_eval_loss_step,
        make_flush_step,
        make_train_step,
    )

    if (bool(cfg.select("runtime.device_geometric", False))
            and bool(cfg.select("runtime.spatial_axis", False))):
        raise ConfigurationError(
            "runtime.device_geometric shards the batch; it cannot combine "
            "with runtime.spatial_axis (the warp gathers across the full "
            "image height). Use the host pipeline for spatial partitioning.")
    refuse_unported(cfg)
    device = resolve_device(device)
    tc, vc = cfg.training_config, cfg.validation_config
    logger = setup_logger("cabinet_tpu_torch.train", tc.experiments_path)
    common.seed_everything(cfg.runtime.seed)

    # ---- datasets ------------------------------------------------------
    ds_train, ds_val = common.build_datasets(cfg, ["train", "val"])
    common.guard_val_batch(cfg, ds_val, vc.batch_size)
    dl_train = common.make_loader(cfg, ds_train, tc.batch_size, shuffle=True,
                                  drop_last=True, num_workers=tc.num_workers,
                                  seed=cfg.runtime.seed)
    dl_val = DataLoader(ds_val, vc.batch_size, num_workers=vc.num_workers)

    # ---- model ----------------------------------------------------------
    n_classes = cfg.dataset.num_classes
    dtype = common.compute_dtype_of(cfg)
    use_pallas = bool(cfg.select("runtime.use_pallas", False))
    crop_h, crop_w = (int(c) for c in cfg.dataset.cropsize)
    model = common.build_model(cfg, n_classes)

    bb_name = cfg.model.get("pretrained_weights")
    if bb_name:
        bb_path = Path(common.REPO_ROOT, "pretrained_backbones", bb_name)
        if bb_path.is_file():
            common.load_pretrained_backbone(model, bb_path)
            logger.info(f"Loaded pretrained backbone from {bb_path}")
        else:
            logger.info(f"No pretrained backbone at {bb_path}; random init.")
    if tc.get("pretrained_ckpt_path"):
        keys = common.warm_start(model, tc.pretrained_ckpt_path)
        logger.info(f"Warm-started {len(keys)} tensors from {tc.pretrained_ckpt_path}")
    model.to(device)

    # ---- class weights ---------------------------------------------------
    class_weights = None
    if float(tc.get("cls_pw", 0)) > 0:
        counts = get_class_pixel_counts(ds_train, n_classes, cfg.dataset.ignore_idx)
        class_weights = compute_class_weights(counts, float(tc.cls_pw))
        logger.info(f"Class weights: {np.round(class_weights, 3).tolist()}")

    # ---- optimizer / state ----------------------------------------------
    batches_per_epoch = len(dl_train)
    accum = int(tc.accum_steps)
    max_iter = tc.get("max_iterations") or math.ceil(tc.epochs * batches_per_epoch / accum)
    optimizer = GroupedSGD(
        model, lr0=float(tc.optimizer_lr_start), max_iter=int(max_iter),
        momentum=float(tc.optimizer_momentum), wd=float(tc.optimizer_weight_decay),
        power=float(tc.optimizer_power), warmup_steps=int(tc.warmup_steps),
        warmup_start_lr=float(tc.warmup_start_lr),
        max_grad_norm=float(tc.max_grad_norm) if tc.get("max_grad_norm") else None)
    state = create_train_state(model, optimizer, ema_decay=float(tc.ema_decay),
                               ema_tau=float(tc.ema_tau))
    n_min = tc.batch_size * crop_h * crop_w // OHEM_DIVISOR
    train_step = make_train_step(n_min=n_min, thresh=0.7,
                                 ignore_label=cfg.dataset.ignore_idx,
                                 class_weights=class_weights, accum_steps=accum,
                                 compute_dtype=dtype)
    flush_step = make_flush_step()
    eval_loss_step = make_eval_loss_step(
        model, n_min=vc.batch_size * crop_h * crop_w // OHEM_DIVISOR, thresh=0.7,
        ignore_label=cfg.dataset.ignore_idx, class_weights=class_weights,
        compute_dtype=dtype)

    stopper = EarlyStopping(int(tc.patience))
    ckpt = CheckpointManager(Path(tc.experiments_path))
    start_epoch, best_miou, best_loss = 0, 0.0, float("inf")
    if tc.resume:
        restored = ckpt.restore_full("checkpoint_last", state)
        if restored:
            start_epoch = restored["epoch"] + 1
            best_miou = restored["best_miou"]
            best_loss = restored["best_loss"]
            stopper.load_state_dict({"best_fitness": restored["early_stop_best_fitness"],
                                     "best_epoch": restored["early_stop_best_epoch"]})
            logger.info(f"Resumed from epoch {restored['epoch']} (step {state.step})")
    logger.info(f"Device {device}; max_iter={max_iter}; n_min={n_min}; accum={accum}")

    # ---- evaluation on a copy of the EMA weights --------------------------
    eval_model = common.build_model(cfg, n_classes)
    crop = max(crop_h, crop_w)

    def ema_forward():
        eval_model.load_state_dict(state.ema_variables, strict=True)
        return make_eval_forward(eval_model, crop, device, dtype, use_pallas=use_pallas,
                                 fused_tail="false")

    def evaluator(scales, flip, pad_to):
        return MscEval(ema_forward(), n_classes, ignore_label=cfg.dataset.ignore_idx,
                       scales=tuple(scales), flip=flip, cropsize=crop,
                       compute_dtype=dtype, pad_to=pad_to,
                       tile_batch=common.eval_tile_batch(cfg),
                       acc_dtype=common.eval_acc_dtype(cfg), device=device)

    def to_device(images, labels):
        return (torch.from_numpy(images).to(device, non_blocking=True),
                torch.from_numpy(labels).to(device, non_blocking=True))

    augment = (DeviceAugment(cfg, ds_train, device, (crop_h, crop_w))
               if getattr(ds_train, "photometric", "host") == "device" else None)
    aug_clock = _DeviceClock(device)

    # metrics.jsonl: resumed runs append to the same file, so every run opens
    # with a marker line and tags its epoch lines with its id.
    write_metrics = is_primary_process()
    run_id = time.strftime("%Y%m%d-%H%M%S")
    metrics_path = Path(tc.experiments_path) / "metrics.jsonl"
    if write_metrics:
        _metrics_line(metrics_path, {"run_start": run_id, "start_epoch": start_epoch})

    timing = {"train_seconds": 0.0, "loader_wait_seconds": 0.0,
              "device_aug_seconds": 0.0, "micro_steps": 0, "optimizer_steps": 0,
              "eval_seconds": 0.0}
    step0 = state.step
    results: Dict[str, Any] = {"best_miou": best_miou}
    try:
        for epoch in range(start_epoch, int(tc.epochs)):
            t0 = time.time()
            dl_train.set_epoch(epoch)
            losses = []
            tl = time.perf_counter()
            batches, i = iter(dl_train), 0
            while True:
                tw = time.perf_counter()
                batch = next(batches, None)
                timing["loader_wait_seconds"] += time.perf_counter() - tw
                if batch is None:
                    break
                if augment is None:
                    images, labels = to_device(*batch)
                else:
                    started = aug_clock.start()
                    images, labels = augment(batch, state.step, state.micro_step)
                    aug_clock.stop(started)
                state, last_loss = train_step(state, images, labels)
                i += 1
                if i % int(tc.log_iter) == 0:
                    losses.append(float(last_loss))
                    logger.info(f"epoch {epoch} it {i}/{batches_per_epoch} "
                                f"loss {losses[-1]:.4f}")
            timing["micro_steps"] += i
            state = flush_step(state)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            timing["train_seconds"] += time.perf_counter() - tl
            timing["device_aug_seconds"] = aug_clock.seconds()

            te = time.perf_counter()
            val_losses = [float(eval_loss_step(*to_device(im, lb))) for im, lb in dl_val]
            val_loss = float(np.mean(val_losses)) if val_losses else float("nan")
            best_loss = min(best_loss, val_loss)

            fitness = None
            if (epoch + 1) % int(vc.eval_every_n_epochs) == 0:
                res = evaluator((1.0,), False, common.eval_pad_to(cfg)).evaluate(None, dl_val)
                fitness = res["mIoU"]
                logger.info(f"epoch {epoch}: val_loss {val_loss:.4f} mIoU {fitness:.4f} "
                            f"({time.time() - t0:.1f}s)")
                if fitness > best_miou:
                    best_miou = fitness
                    ckpt.save_variables(f"{tc.model_save_name}_best", state.ema_variables)
            timing["eval_seconds"] += time.perf_counter() - te

            if write_metrics:
                _metrics_line(metrics_path, {
                    "run": run_id, "epoch": epoch,
                    "train_loss": float(np.mean(losses)) if losses else None,
                    "val_loss": None if np.isnan(val_loss) else val_loss,
                    "mIoU": fitness, "step": int(state.step),
                    "seconds": round(time.time() - t0, 2)})

            should_stop = stopper(epoch, fitness)
            ckpt.save_full("checkpoint_last", state, epoch, best_miou, best_loss,
                           stopper.state_dict())
            if should_stop:
                logger.info(f"Early stopping at epoch {epoch} (best "
                            f"{stopper.best_fitness:.4f} @ {stopper.best_epoch})")
                break
    except KeyboardInterrupt:  # graceful final save (reference :569-580)
        logger.info("Interrupted: saving final state.")

    ckpt.save_variables(tc.model_save_name, state.ema_variables)
    save_config(cfg, Path(tc.experiments_path) / "config.yaml")

    te = time.perf_counter()
    final = evaluator(vc.eval_scales, bool(vc.flip),
                      cfg.select("validation_config.eval_pad_to", None)
                      ).evaluate(None, dl_val, progress=True)
    timing["final_eval_seconds"] = time.perf_counter() - te
    timing["optimizer_steps"] = state.step - step0
    logger.info(f"Final multi-scale mIoU: {final['mIoU']:.4f} acc {final['accuracy']:.4f}")
    results.update(best_miou=best_miou, final=final, timing=timing)
    return results


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Print the composed config, train, and print the final metrics as
    one JSON line {"best_miou", "mIoU", "accuracy"}; returns the result of
    `train_and_evaluate`."""
    cfg, args = common.parse_cli(argv, "train", "Train CABiNet on the GPU")
    print("Composed config:")
    print(to_yaml(cfg), flush=True)
    res = train_and_evaluate(cfg, device=args.device)
    print(json.dumps({"best_miou": res["best_miou"], "mIoU": res["final"]["mIoU"],
                      "accuracy": res["final"]["accuracy"]}), flush=True)
    return res


if __name__ == "__main__":
    main()
