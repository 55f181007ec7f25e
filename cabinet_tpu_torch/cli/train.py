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

`runtime.loader=grain` reads the train split on worker processes
(`data/grain_loader.py`), which stop when training ends.
`--legacy-config legacy/train_citys.json` runs a pre-Hydra JSON config
(`core/legacy_config.py`).

Data parallelism across processes: started by torchrun, e.g.
    python -m torch.distributed.run --nproc_per_node 4 \
        -m cabinet_tpu_torch.cli.train dataset=cityscapes ...
each rank joins the process group (`core/mesh.py`; `+runtime.dist_backend=
auto|nccl|gloo`, `+runtime.dist_timeout_s`) on its own card.
`training_config.batch_size` is the global batch: each of R ranks loads
B/R images (R must divide B), every R-th sample of the epoch's order from
its rank on, so that the ranks' batches together are the 1-rank run's
global batch; OHEM's n_min is sized from B. The step is the global batch's
(`train/trainer.py`), `DeviceAugment` draws the global batch's parameters
and each rank takes its samples'. Each rank scores a disjoint share of
the val frames; the confusion matrices and the val losses are summed
over the ranks. Rank 0 alone writes the logs, `metrics.jsonl`, the
checkpoints and the config; every rank reads a resume; the early-stopping
verdict is rank 0's.

Tile-sharded eval: with R > 1 ranks on the data axis and
`runtime.tile_parallel_eval=true` (the default) the per-epoch and final
evaluations share each image's tiles over the data ranks
(`eval/evaluator.py`, `cli/common.py:eval_tile_mesh`): every rank scores
every frame and holds the same confusion matrix. With
`runtime.tile_parallel_eval=false` each data rank scores its share of the
frames and the matrices are summed.

Tensor parallelism (`runtime.model_axis=M > 1`, JAX's model axis): the
ranks form JAX's (data, model) grid, rank = d * M + m (`core/mesh.py:
make_mesh`); the data axis is `runtime.mesh_data`, or by default JAX's
`auto_data_axis(batch, R / M)`, and it must hold every rank: a value with
data x M != R raises a ConfigurationError naming the key (JAX leaves
devices idle instead). The model's wide layers are cut to each rank's
slice of their channels under JAX's rule (`runtime.tp_min_features`,
`models/tensor_parallel.py`); the batch, BatchNorm, the losses, the
loaders and the evaluations' shares span the data axis; the val loss and
the evaluations run the sharded model. The checkpoints and `.pth` files
hold the whole tensors, as a one-rank run writes them, and a resume cuts
them to any layout.

Pipeline parallelism (`runtime.pipeline=2`, `train/pipeline.py`): the
backbone and the decoder are two stages, stage i on cuda:(i mod the card
count) (sharing a card where there are fewer); one loader batch is one
microbatch and `accum_steps` microbatches are one optimizer step, the
update the fused trainer's. Device augmentation runs on stage 0's device,
its draws keyed as the fused trainer's. The val loss and the evaluations
run on the stages' weights merged device to device; the checkpoint keeps
one tree a stage (`train/checkpoint.py:save_pipeline_full`), and the
`_best` and final `.pth` hold the merged EMA weights. Under torchrun each
rank runs the whole pipeline on its card over its share of every
microbatch (`runtime.pipeline_dp`: the rank count / `runtime.pipeline_tp`;
JAX refuses the pipeline across processes). `runtime.pipeline_tp=T > 1`
cuts each stage's channels over model groups of T ranks;
`runtime.eval_model_axis=E > 1` runs the evaluations on a (R / E, E) mesh
of their own, the merged weights cut for it.

Spatial partitioning (`runtime.spatial_axis=true`, JAX's
`core/mesh.py:spatial_sharding`): image rows, not the batch, are split
over the data axis, which is `runtime.mesh_data` or by default every rank
/ `runtime.model_axis`, whatever the batch. Every rank loads the same
global batch with the same augmentation draws (`DeviceAugment`'s
photometric chain runs on the whole batch), and the step takes its stripe
of every image's rows (`models/spatial_parallel.py`, with the model axis
too when `runtime.model_axis` > 1); the val loss and the evaluations run
whole frames, shared over the data axis as under data parallelism. The
crop height must be a multiple of the data axis times the model's total
stride (32 for MobileNetV3-Large; a ConfigurationError names both: GSPMD
pads uneven shards, the port does not); `runtime.device_geometric` and
`runtime.pipeline` refuse it, as in JAX.
"""

from __future__ import annotations

import json
import math
import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from cabinet_tpu_torch.cli import common
from cabinet_tpu_torch.core.config import Config, save_config, to_yaml
from cabinet_tpu_torch.core.device import resolve_device
from cabinet_tpu_torch.core.exceptions import ConfigurationError
from cabinet_tpu_torch.core.logging import is_primary_process, setup_logger
from cabinet_tpu_torch.utils.profiler import DeviceClock


def spatial_axis(cfg: Config) -> bool:
    """`runtime.spatial_axis`: image rows striped over the data axis."""
    return bool(cfg.select("runtime.spatial_axis", False))


def pipeline_stages(cfg: Config, family: str = "cabinet") -> int:
    """`runtime.pipeline`'s stage count (0: no pipeline) after the JAX
    package's refusals (ConfigurationError): CABiNet takes 2 stages,
    YOLO-sem 2 or 3; CABiNet's pipeline takes no model or spatial axis;
    `runtime.pipeline_dp` must divide the batch. The port's intra-stage
    parallelism is one process a rank, so `runtime.pipeline_tp` (CABiNet's
    per-stage model axis) and `runtime.eval_model_axis` must divide the
    rank count, and a `pipeline_dp` other than the rank count /
    `pipeline_tp` raises too."""
    from cabinet_tpu_torch.core import mesh

    n = int(cfg.select("runtime.pipeline", 0) or 0)
    if not n:
        return 0
    if family == "cabinet":
        if n != 2:
            raise ConfigurationError(
                f"runtime.pipeline={n}: CABiNet pins at 2 stages (backbone | decode "
                "— stage_keys partition top-level modules and its backbone is the "
                "single 'mobile' module). The engine itself is N-stage: deep trunks "
                "use e.g. YOLOSEM_STAGE_KEYS_3 (train/pipeline.py), "
                "equivalence-tested at 3 stages.")
        if int(cfg.select("runtime.model_axis", 1) or 1) > 1 or bool(
                cfg.select("runtime.spatial_axis", False)):
            raise ConfigurationError(
                "runtime.pipeline cannot combine with runtime.model_axis or "
                "runtime.spatial_axis: pipeline stages own disjoint sub-meshes (use "
                "runtime.pipeline_dp for intra-stage DP).")
        ranks = mesh.env_world()[1]
        for key in ("runtime.pipeline_tp", "runtime.eval_model_axis"):
            axis = int(cfg.select(key, 1) or 1)
            if axis < 1 or ranks % axis:
                raise ConfigurationError(
                    f"{key}={axis} must divide the rank count ({ranks}): each of its "
                    f"model groups is {axis} processes, one a rank")
    elif n not in (2, 3):
        raise ConfigurationError(
            f"runtime.pipeline={n}: YOLO-sem ships 2-stage (trunk | neck+heads) and "
            "3-stage (trunk front | trunk back | neck+heads) splits")
    pp_dp = int(cfg.select("runtime.pipeline_dp", 0) or 0)
    if pp_dp:
        batch = int(cfg.training_config.batch_size)
        if batch % pp_dp:
            raise ConfigurationError(
                f"runtime.pipeline_dp={pp_dp} must divide the per-microbatch "
                f"batch_size ({batch})")
        ranks = mesh.env_world()[1]
        pp_tp = int(cfg.select("runtime.pipeline_tp", 1) or 1) if family == "cabinet" else 1
        if pp_dp * pp_tp != ranks:
            raise ConfigurationError(
                f"runtime.pipeline_dp={pp_dp}: a pipeline stage's data parallelism "
                f"is one process a rank here, and {ranks} rank(s) run "
                f"(runtime.pipeline_tp={pp_tp}); start {pp_dp * pp_tp} under "
                f"torchrun, or leave runtime.pipeline_dp at 0")
    return n


def join_ranks(cfg: Config, device: Union[str, torch.device]) -> torch.device:
    """This rank's device, the process group joined when torchrun started
    several (`core/mesh.py:setup`, `runtime.dist_backend`,
    `runtime.dist_timeout_s`)."""
    from cabinet_tpu_torch.core import mesh

    mesh.set_mesh(None)  # a main before this one in the process may have set its own
    return mesh.setup(resolve_device(device),
                      str(cfg.select("runtime.dist_backend", "auto")),
                      float(cfg.select("runtime.dist_timeout_s", mesh.DEFAULT_TIMEOUT_S)))


def mesh_axes(cfg: Config, ranks: int, pp_stages: int = 0,
              family: str = "cabinet") -> Tuple[int, int]:
    """(n_data, n_model) of the train mesh over `ranks` processes, as JAX
    sizes its mesh (`cabinet_tpu/cli/train.py:258-279`): n_model is
    `runtime.model_axis` (CABiNet; 1 for YOLO-sem, whose JAX main never
    reads the key) or under the pipeline `runtime.pipeline_tp`; n_data is
    `runtime.mesh_data`, 0 for `auto_data_axis(batch, ranks / n_model)`
    (the pipeline: ranks / pipeline_tp; with `runtime.spatial_axis`, which
    stripes rows and not the batch, ranks / n_model whatever the batch, as
    JAX's `cli/train.py:262-268`). Raises a ConfigurationError naming the
    key unless the grid holds every rank, and unless n_data divides the
    global batch `training_config.batch_size` (rows under the spatial
    axis: `spatial_stride_check`)."""
    from cabinet_tpu_torch.core import mesh

    batch = int(cfg.training_config.batch_size)
    if pp_stages:
        n_model = int(cfg.select("runtime.pipeline_tp", 1) or 1) if family == "cabinet" else 1
        return ranks // n_model, n_model
    n_model = int(cfg.select("runtime.model_axis", 1) or 1) if family == "cabinet" else 1
    if n_model < 1 or ranks % n_model:
        raise ConfigurationError(f"runtime.model_axis={n_model} must divide the rank "
                                 f"count ({ranks})")
    key = int(cfg.select("runtime.mesh_data", 0) or 0)
    spatial = family == "cabinet" and spatial_axis(cfg)
    n_data = key or (ranks // n_model if spatial
                     else mesh.auto_data_axis(batch, ranks // n_model))
    if n_data * n_model != ranks:
        why = ("" if key else f" (0: the largest divisor of the batch {batch} that fits "
               f"{ranks // n_model} ranks)")
        raise ConfigurationError(
            f"runtime.mesh_data={key}: a data axis of {n_data}{why} x model axis "
            f"{n_model} does not hold the {ranks} ranks; each rank is a process and "
            f"cannot sit idle: set runtime.mesh_data to {ranks // n_model} or 0, or "
            f"start {n_data * n_model} ranks")
    if batch % n_data and not spatial:
        raise ConfigurationError(f"runtime.mesh_data={key}: the data axis {n_data} does "
                                 f"not divide training_config.batch_size={batch}")
    return n_data, n_model


def spatial_stride_check(cfg: Config, model: Any, n_data: int) -> None:
    """Raise a ConfigurationError unless the crop height is a multiple of
    the data axis times the model's total stride (`models/spatial_parallel.
    py:stripe_multiple`): every stripe must start on a multiple of every
    conv's stride (JAX's GSPMD pads uneven shards instead)."""
    from cabinet_tpu_torch.models.spatial_parallel import stripe_multiple

    crop_h = int(cfg.dataset.cropsize[0])
    stride = stripe_multiple(model)
    if crop_h % (n_data * stride):
        raise ConfigurationError(
            f"runtime.spatial_axis: the crop height {crop_h} (dataset.cropsize) is not a "
            f"multiple of the data axis {n_data} x the model's total stride {stride} = "
            f"{n_data * stride}: each of the {n_data} stripes must start on every conv's "
            f"stride")


def train_mesh(cfg: Config, pp_stages: int = 0, family: str = "cabinet") -> Any:
    """The train mesh of this process group (`mesh_axes`), made the current
    one (`core/mesh.py:set_mesh`)."""
    from cabinet_tpu_torch.core import mesh

    m = mesh.make_mesh(*mesh_axes(cfg, mesh.world()[1], pp_stages, family))
    mesh.set_mesh(m)
    return m


def epoch_batches(loader: Any) -> int:
    """Batches an epoch takes: the fewest any rank's loader gives, so that
    every rank steps as often (a shard may hold one sample more)."""
    from cabinet_tpu_torch.core import mesh

    return int(mesh.all_reduce_(mesh.host_tensor(len(loader), torch.int64), op="min"))


class DeviceAugment:
    """The train recipe's device side for `ds_train`'s batches: the warp
    (`runtime.device_geometric`) and the photometric chain of its `RECIPE`,
    then the normalisation, on `device`.

    The draws for a batch come from `(seed, step, micro_step)`, `seed`
    `runtime.seed + 1` unless given (the YOLO trainer gives its own, and
    its chain's `aug`):
    every per-sample parameter from a numpy Generator on the host, the
    noise from a torch Generator on `device`. So a resume redraws what the
    uninterrupted run drew, no draw waits on the device, and two
    micro-batches of one accumulation window draw apart (the JAX package
    keys on the step alone).

    With `shard=(rank, R)` (data parallelism; the loader's interleaved
    shard, so this rank's sample i sits at position rank + R*i of the
    global batch) the draws are the global batch's and this rank takes its
    positions', and mixup's partner (the sample before) comes from the
    rank that holds it: the ranks' batches together are, bit for bit, the
    global batch of a 1-rank run."""

    def __init__(self, cfg: Config, ds_train: Any, device: torch.device,
                 crop_hw: Tuple[int, int], seed: Optional[int] = None,
                 aug: Optional[Dict[str, Any]] = None,
                 shard: Optional[Tuple[int, int]] = None):
        self.geometric = getattr(ds_train, "geometric", "host") == "device"
        self.shared = str(cfg.select("runtime.device_geometric", False)).lower() == "shared"
        self.street = getattr(ds_train, "RECIPE", "aerial") == "street"
        self.aug = dict(ds_train.aug if aug is None else aug)
        self.mean, self.std = ds_train.MEAN, ds_train.STD
        self.crop_hw = crop_hw
        self.ignore_label = int(cfg.dataset.ignore_idx)
        self.seed = int(cfg.runtime.seed) + 1 if seed is None else int(seed)
        self.device = device
        self.noise = torch.Generator(device=device)
        self.rank, self.ranks = shard if shard is not None else (0, 1)

    def draws(self, step: int, micro_step: int) -> np.random.Generator:
        """The host Generator of a batch; seeds the noise Generator too."""
        key = [self.seed, int(step), int(micro_step)]
        self.noise.manual_seed(int(np.random.SeedSequence(key).generate_state(1)[0]))
        return np.random.default_rng(key)

    def __call__(self, batch, step: int, micro_step: int):
        """(normalised images (B, Hc, Wc, 3) f32, labels int64) on the
        device, from a loader batch: (canvas u8, label canvas u8, (h, w)) or
        (raw images, labels). The draws are the global batch's, in the
        1-rank order, and this rank takes its positions'."""
        from cabinet_tpu_torch.ops import geometric as G
        from cabinet_tpu_torch.ops import photometric as P

        rng = self.draws(step, micro_step)
        staged = [torch.from_numpy(a).to(self.device, non_blocking=True) for a in batch[:2]]
        mine = slice(self.rank, None, self.ranks)
        if self.geometric:
            images, labels = G.geometric_pipeline(*staged, batch[2], rng, self.aug,
                                                  self.crop_hw, self.ignore_label,
                                                  shared_linear=self.shared,
                                                  shard=(self.rank, self.ranks))
        else:
            images, labels = staged
        b, H, W, C = images.shape
        B = b * self.ranks
        z = torch.randn((B, H, W, C), generator=self.noise, device=self.device)[mine]
        if self.street:
            params = P.sample_street_photometric(rng, B, H, W)
            return P.street_photometric_pipeline(
                images, labels, P.params_to_device(P.take_rows(params, mine), self.device),
                z, self.mean, self.std)
        params = P.sample_photometric(rng, B, H, W, self.aug)
        blend = np.flatnonzero(params["mixup"]["apply"])
        partners = (None if self.ranks == 1
                    else lambda x, lb: self._partners(x, lb, blend, B))
        return P.photometric_pipeline(
            images, labels, P.params_to_device(P.take_rows(params, mine), self.device), z,
            self.mean, self.std, partners=partners)

    def _partners(self, x: torch.Tensor, labels: torch.Tensor, blend: np.ndarray, B: int):
        """Mixup's partners of this rank's samples: for every global
        position p that blends, the sample at p - 1 (mod B), sent by the
        rank that holds it through one all-reduce of a buffer that only
        that rank fills; other rows keep this rank's own (not read)."""
        from cabinet_tpu_torch.core import mesh

        if blend.size == 0:
            return x, labels
        r, R = self.rank, self.ranks
        img_buf = x.new_zeros((blend.size,) + tuple(x.shape[1:]))
        lbl_buf = labels.new_zeros((blend.size,) + tuple(labels.shape[1:]))
        for j, p in enumerate(blend):
            q = (int(p) - 1) % B
            if q % R == r:
                img_buf[j], lbl_buf[j] = x[q // R], labels[q // R]
        mesh.all_reduce_(img_buf, tag="mixup", group=mesh.data_group())
        mesh.all_reduce_(lbl_buf, tag="mixup", group=mesh.data_group())
        img, lbl = x.clone(), labels.clone()
        for j, p in enumerate(blend):
            if int(p) % R == r:
                img[int(p) // R], lbl[int(p) // R] = img_buf[j], lbl_buf[j]
        return img, lbl


def _metrics_line(path: Path, record: Dict[str, Any]) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def train_and_evaluate(cfg: Config, device: Union[str, torch.device] = "cuda"
                       ) -> Dict[str, Any]:
    """Train `cfg` on one device (one rank of several under torchrun, on
    the (data, model) mesh of `train_mesh`; with `runtime.pipeline=2`, its
    stages on their devices) and return
    {"best_miou", "final" (the final multi-scale eval's result),
    "timing"}. `timing` holds the training loops' seconds, the part of them
    spent waiting on the train loader and the seconds of device
    augmentation in them, the micro-steps and optimizer steps this call
    took, the seconds of the val losses and evaluations, and the calls and
    host seconds of this rank's collectives by kind (`collectives`)."""
    from cabinet_tpu_torch.cli.evaluate import make_eval_forward
    from cabinet_tpu_torch.core import mesh
    from cabinet_tpu_torch.core.constants import OHEM_DIVISOR
    from cabinet_tpu_torch.data.class_weights import (
        compute_class_weights,
        get_class_pixel_counts,
    )
    from cabinet_tpu_torch.data.loader import DataLoader
    from cabinet_tpu_torch.eval.evaluator import MscEval
    from cabinet_tpu_torch.models.spatial_parallel import spatial_parallel
    from cabinet_tpu_torch.models.tensor_parallel import reshard_state, tensor_parallel
    from cabinet_tpu_torch.train.checkpoint import CheckpointManager
    from cabinet_tpu_torch.train.early_stopping import EarlyStopping
    from cabinet_tpu_torch.train.optimizer import GroupedSGD
    from cabinet_tpu_torch.train.trainer import (
        TrainLoop,
        batch_to,
        create_train_state,
        make_eval_loss_step,
        make_train_step,
    )

    if (bool(cfg.select("runtime.device_geometric", False))
            and bool(cfg.select("runtime.spatial_axis", False))):
        raise ConfigurationError(
            "runtime.device_geometric shards the batch; it cannot combine "
            "with runtime.spatial_axis (the warp gathers across the full "
            "image height). Use the host pipeline for spatial partitioning.")
    pp_stages = pipeline_stages(cfg, "cabinet")
    spatial = spatial_axis(cfg)
    device = join_ranks(cfg, device)
    rank, ranks = mesh.world()
    train_m = train_mesh(cfg, pp_stages)  # the data x model grid of the ranks
    shard = (train_m.data_rank, train_m.n_data) if train_m.n_data > 1 else None
    # the spatial axis stripes rows: every rank loads the whole global batch
    train_shard = None if spatial else shard
    tp_min = int(cfg.select("runtime.tp_min_features", 256))
    # the evaluations' mesh: the train mesh, or under the pipeline JAX's
    # global eval mesh, its model axis runtime.eval_model_axis
    eval_m = train_m
    if pp_stages:
        e = int(cfg.select("runtime.eval_model_axis", 1) or 1)
        eval_m = mesh.make_mesh(ranks // e, e)
    tc, vc = cfg.training_config, cfg.validation_config
    logger = setup_logger("cabinet_tpu_torch.train", tc.experiments_path)
    common.seed_everything(cfg.runtime.seed)

    # ---- datasets ------------------------------------------------------
    ds_train, ds_val = common.build_datasets(cfg, ["train", "val"])
    common.guard_val_batch(cfg, ds_val, vc.batch_size)
    dl_train = common.make_loader(cfg, ds_train, int(tc.batch_size) if spatial
                                  else mesh.local_batch_size(tc.batch_size),
                                  shuffle=True, drop_last=True,
                                  num_workers=tc.num_workers, seed=cfg.runtime.seed,
                                  shard=train_shard)
    dl_val = DataLoader(ds_val, vc.batch_size, num_workers=vc.num_workers, shard=shard)
    # tile-sharded eval: every rank scores every frame, its tiles shared over
    # the eval mesh's data axis; else each data rank scores its frames
    with mesh.using(eval_m):
        tile_mesh = common.eval_tile_mesh(cfg)
    eval_shard = None if tile_mesh or eval_m.n_data == 1 else (eval_m.data_rank, eval_m.n_data)
    dl_eval = (dl_val if eval_shard == shard
               else DataLoader(ds_val, vc.batch_size, num_workers=vc.num_workers,
                               shard=eval_shard))

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
    mesh.broadcast_module_(model)
    tensor_parallel(model, train_m, tp_min)  # this rank's slices of the wide layers
    if spatial:  # and its stripe of the rows
        spatial_stride_check(cfg, model, train_m.n_data)
        spatial_parallel(model, train_m)

    # ---- class weights ---------------------------------------------------
    class_weights = None
    if float(tc.get("cls_pw", 0)) > 0:
        counts = get_class_pixel_counts(ds_train, n_classes, cfg.dataset.ignore_idx)
        class_weights = compute_class_weights(counts, float(tc.cls_pw))
        logger.info(f"Class weights: {np.round(class_weights, 3).tolist()}")

    # ---- optimizer / state ----------------------------------------------
    batches_per_epoch = epoch_batches(dl_train)
    accum = int(tc.accum_steps)
    max_iter = tc.get("max_iterations") or math.ceil(tc.epochs * batches_per_epoch / accum)
    opt_kwargs = dict(
        lr0=float(tc.optimizer_lr_start), max_iter=int(max_iter),
        momentum=float(tc.optimizer_momentum), wd=float(tc.optimizer_weight_decay),
        power=float(tc.optimizer_power), warmup_steps=int(tc.warmup_steps),
        warmup_start_lr=float(tc.warmup_start_lr))
    max_gn = float(tc.max_grad_norm) if tc.get("max_grad_norm") else None
    n_min = tc.batch_size * crop_h * crop_w // OHEM_DIVISOR
    # the train loop: the fused step, or with runtime.pipeline=2 backbone |
    # decode stages (train/pipeline.py), one loader batch a microbatch and
    # accum_steps microbatches an optimizer step
    devices = [device]
    if pp_stages:
        from cabinet_tpu_torch.train.pipeline import (
            CabinetPipeline,
            PipelineTrainLoop,
            make_pipeline_devices,
        )

        devices = make_pipeline_devices(pp_stages, device)
    aug_fn, aug_clock = None, DeviceClock(device)
    if getattr(ds_train, "photometric", "host") == "device":  # on the first device
        augment = DeviceAugment(cfg, ds_train, devices[0], (crop_h, crop_w), shard=train_shard)

        def aug_fn(raw, step, micro_step):
            started = aug_clock.start()
            out = augment(raw, step, micro_step)
            aug_clock.stop(started)
            return out

    if pp_stages:
        pipe = CabinetPipeline(
            model, lambda stage: GroupedSGD(stage, max_grad_norm=None, **opt_kwargs),
            n_min=n_min, num_microbatches=accum, devices=devices, thresh=0.7,
            ignore_label=cfg.dataset.ignore_idx, class_weights=class_weights,
            compute_dtype=dtype, max_grad_norm=max_gn, ema_decay=float(tc.ema_decay),
            ema_tau=float(tc.ema_tau), aug_fn=aug_fn)
        loop = PipelineTrainLoop(pipe, pipe.init_state(model.state_dict()))
    else:
        loop = TrainLoop(
            create_train_state(model, GroupedSGD(model, max_grad_norm=max_gn, **opt_kwargs),
                               ema_decay=float(tc.ema_decay), ema_tau=float(tc.ema_tau)),
            make_train_step(n_min=n_min, thresh=0.7, ignore_label=cfg.dataset.ignore_idx,
                            class_weights=class_weights, accum_steps=accum,
                            compute_dtype=dtype),
            device, aug_fn)
    eval_loss_step = make_eval_loss_step(
        model, n_min=vc.batch_size * crop_h * crop_w // OHEM_DIVISOR, thresh=0.7,
        ignore_label=cfg.dataset.ignore_idx, class_weights=class_weights,
        compute_dtype=dtype)

    stopper = EarlyStopping(int(tc.patience))
    ckpt = CheckpointManager(Path(tc.experiments_path))
    start_epoch, best_miou, best_loss = 0, 0.0, float("inf")
    if tc.resume:
        restored = ckpt.restore_full("checkpoint_last", loop.state)
        if restored:
            start_epoch = restored["epoch"] + 1
            best_miou = restored["best_miou"]
            best_loss = restored["best_loss"]
            stopper.load_state_dict({"best_fitness": restored["early_stop_best_fitness"],
                                     "best_epoch": restored["early_stop_best_epoch"]})
            logger.info(f"Resumed from epoch {restored['epoch']} (step {loop.step})")
    logger.info(f"{len(devices)} stage(s) on {devices}; rank {rank} of {ranks}; "
                f"mesh {train_m.shape} (eval {eval_m.shape}); "
                f"max_iter={max_iter}; n_min={n_min}; accum={accum}; "
                f"tile-sharded eval {tile_mesh is not None}")

    # ---- evaluation on a copy of the EMA weights (merged device to device
    # under the pipeline; cut for the eval mesh) -----------------------------
    eval_model = tensor_parallel(common.build_model(cfg, n_classes), eval_m, tp_min)
    crop = max(crop_h, crop_w)

    def ema_forward():
        eval_model.load_state_dict(reshard_state(loop.weights(ema=True, device=device),
                                                 model, eval_model), strict=True)
        return make_eval_forward(eval_model, crop, device, dtype, use_pallas=use_pallas,
                                 fused_tail="false")

    def evaluate(scales, flip, pad_to, progress=False):
        forward = ema_forward()
        with mesh.using(eval_m):
            return MscEval(forward, n_classes, ignore_label=cfg.dataset.ignore_idx,
                           scales=tuple(scales), flip=flip, cropsize=crop,
                           compute_dtype=dtype, pad_to=pad_to,
                           tile_batch=common.eval_tile_batch(cfg),
                           acc_dtype=common.eval_acc_dtype(cfg), device=device,
                           tile_mesh=tile_mesh).evaluate(None, dl_eval, progress=progress)

    # metrics.jsonl: resumed runs append to the same file, so every run opens
    # with a marker line and tags its epoch lines with its id.
    write_metrics = primary = is_primary_process()
    run_id = time.strftime("%Y%m%d-%H%M%S")
    metrics_path = Path(tc.experiments_path) / "metrics.jsonl"
    if write_metrics:
        _metrics_line(metrics_path, {"run_start": run_id, "start_epoch": start_epoch})

    timing = {"train_seconds": 0.0, "loader_wait_seconds": 0.0,
              "device_aug_seconds": 0.0, "micro_steps": 0, "optimizer_steps": 0,
              "eval_seconds": 0.0}
    step0 = loop.step
    comm0 = {k: dict(v) for k, v in mesh.COMM.items()}
    results: Dict[str, Any] = {"best_miou": best_miou}
    try:
        for epoch in range(start_epoch, int(tc.epochs)):
            t0 = time.time()
            dl_train.set_epoch(epoch)
            losses = []
            last_loss = None
            tl = time.perf_counter()
            batches, i = iter(dl_train), 0
            while True:
                if i >= batches_per_epoch:  # a longer shard's extra batch
                    batches.close()
                    break
                tw = time.perf_counter()
                batch = next(batches, None)
                timing["loader_wait_seconds"] += time.perf_counter() - tw
                if batch is None:
                    break
                # the micro-step's loss, or under the pipeline a window's mean
                # loss every accum_steps batches and None between
                loss = loop.feed(*batch)
                last_loss = last_loss if loss is None else loss
                i += 1
                if i % int(tc.log_iter) == 0 and last_loss is not None:
                    losses.append(float(last_loss))
                    logger.info(f"epoch {epoch} it {i}/{batches_per_epoch} "
                                f"loss {losses[-1]:.4f}")
                    last_loss = None  # a loss is logged once
            timing["micro_steps"] += i
            loop.flush()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            timing["train_seconds"] += time.perf_counter() - tl
            timing["device_aug_seconds"] = aug_clock.seconds()

            te = time.perf_counter()
            # the raw weights (the stages' merged device to device; the fused
            # state's are the model's own)
            model.load_state_dict(loop.weights(device=device), strict=True)
            val_losses = [float(eval_loss_step(*batch_to(b, device))) for b in dl_val]
            total, count = mesh.all_reduce_(mesh.host_tensor(
                [sum(val_losses), len(val_losses)], torch.float64),
                group=mesh.data_group()).tolist()
            val_loss = float(total / count) if count else float("nan")
            best_loss = min(best_loss, val_loss)

            fitness = None
            if (epoch + 1) % int(vc.eval_every_n_epochs) == 0:
                res = evaluate((1.0,), False, common.eval_pad_to(cfg))
                # rank 0's mIoU decides, so that every rank takes the branch
                # below, with its gather, together: a rank whose cuDNN picked
                # another algorithm may round a near tie the other way
                fitness = float(mesh.broadcast_(mesh.host_tensor(res["mIoU"], torch.float64),
                                                tag="broadcast"))
                logger.info(f"epoch {epoch}: val_loss {val_loss:.4f} mIoU {fitness:.4f} "
                            f"({time.time() - t0:.1f}s)")
                if fitness > best_miou:  # every rank: a gather of the slices
                    best_miou = fitness
                    ckpt.save_variables(f"{tc.model_save_name}_best",
                                        loop.full_weights(ema=True))
            timing["eval_seconds"] += time.perf_counter() - te

            if write_metrics:
                _metrics_line(metrics_path, {
                    "run": run_id, "epoch": epoch,
                    "train_loss": float(np.mean(losses)) if losses else None,
                    "val_loss": None if np.isnan(val_loss) else val_loss,
                    "mIoU": fitness, "step": loop.step,
                    "seconds": round(time.time() - t0, 2)})

            should_stop = bool(mesh.broadcast_(mesh.host_tensor(
                int(stopper(epoch, fitness)), torch.int64)))  # rank 0's verdict
            ckpt.save_full("checkpoint_last", loop.state, epoch, best_miou, best_loss,
                           stopper.state_dict())  # rank 0 writes
            if should_stop:
                logger.info(f"Early stopping at epoch {epoch} (best "
                            f"{stopper.best_fitness:.4f} @ {stopper.best_epoch})")
                break
    except KeyboardInterrupt:  # graceful final save (reference :569-580)
        logger.info("Interrupted: saving final state.")
    finally:  # the workers start in the loop (runtime.loader=grain)
        dl_train.close()

    ckpt.save_variables(tc.model_save_name, loop.full_weights(ema=True))  # rank 0 writes
    if primary:
        save_config(cfg, Path(tc.experiments_path) / "config.yaml")

    te = time.perf_counter()
    final = evaluate(vc.eval_scales, bool(vc.flip),
                     cfg.select("validation_config.eval_pad_to", None), progress=primary)
    timing["final_eval_seconds"] = time.perf_counter() - te
    timing["optimizer_steps"] = loop.step - step0
    timing["collectives"] = mesh.comm_since(comm0)
    logger.info(f"Final multi-scale mIoU: {final['mIoU']:.4f} acc {final['accuracy']:.4f}")
    results.update(best_miou=best_miou, final=final, timing=timing)
    return results


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Print the composed config, train, and print the final metrics as
    one JSON line {"best_miou", "mIoU", "accuracy"}; returns the result of
    `train_and_evaluate`."""
    from cabinet_tpu_torch.core import mesh

    cfg, args = common.parse_cli(argv, "train", "Train CABiNet on the GPU")
    primary = mesh.env_world()[0] == 0
    if primary:
        print("Composed config:")
        print(to_yaml(cfg), flush=True)
    try:
        res = train_and_evaluate(cfg, device=args.device)
    finally:
        mesh.teardown()
    if primary:
        print(json.dumps({"best_miou": res["best_miou"], "mIoU": res["final"]["mIoU"],
                          "accuracy": res["final"]["accuracy"]}), flush=True)
    return res


if __name__ == "__main__":
    main()
