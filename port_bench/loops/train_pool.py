"""The port's fused training step fed from a pool of decoded batches in
host memory, with no loader thread or process in the window.

Set-up writes the seed's frames and labels as a Cityscapes-layout train
split under the run's temporary directory, builds the port's own train
set in device mode (`runtime.device_augs`, `runtime.device_geometric`)
and decodes every frame once into its u8 canvas triple, stacked into
batches as the loader would hand them. `train/trainer.py:TrainLoop.feed`
then runs on those batches in turn with `cli/train.py:DeviceAugment` as
its `aug_fn`, on `make_train_step` and `GroupedSGD` built as
`cli/train.py:train_and_evaluate` builds them. The loop starts at the
configuration's `start_step`.

Traffic parameters: `batch`, `pool` (frames, a multiple of the batch),
`frame_hw`, `checked_steps` (the first steps, run in set-up through the
same loop, that the reference follows), `trace_seconds`.

Judged, against the reference's own float32 run of the same steps on the
same canvases and draws: each checked step's loss (`loss_gap`, the
largest relative gap); the first gradient as the optimizer got it (its
momentum after one step, less the weight decay it added), the
parameters' change over the checked steps and the EMA's change, each as
the median over the leaves of the gap between the program's and the
reference's norm of a leaf, against the larger of the reference's norm of
that leaf and of the median leaf (`loops/base.py:leaf_gaps`), over the
leaves whose first reference gradient is above a thousandth of the
median leaf's, divided by the same median for the reference's run under
bf16 autocast (`*_gap_ratio`: a sound bf16 program reads about 1); and
the leaves that the reference moved and the program left where they were,
under a hundredth of the reference's change (`unmoved_leaves`, exact); and
the first checked step's train-mode logits, caught where the program's
forward returned them, on rows of the batch drawn from the seed: their
relative RMS error against the reference's, divided by the one the
reference makes under bf16 autocast (`logit_err_ratio`), the number that
a lower precision moves most where the gradients average it away. The
worst leaves go to standard error: their gap is the round-off of sums
over millions of pixels that cancel (PERF.md).
"""

from __future__ import annotations

import concurrent.futures
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench import work
from port_bench.loops.base import (
    Context,
    Counters,
    check,
    leaf_gaps,
    lowp_forward,
    reference_precision,
    sample,
)

LOGIT_ROWS = 8  # rows of the first checked step whose logits are compared
from port_bench.frames import (
    block_labels,
    city_raw_labels,
    city_trainids,
    smooth_frames,
    write_city_split,
)
from port_bench.reference import augment as ref_aug
from port_bench.reference import train as ref_train
from port_bench.reference.model import CABiNet, set_fp8
from port_bench.weights import make_state_dict


class _Pool:
    """The decoded canvases, as a dataset to the port's class counter."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _overrides(cfg: Dict, tr: Dict, root, seed: int) -> List[str]:
    t, crop = cfg["train"], int(cfg["crop"])
    return [f"dataset={cfg['dataset']}", f"dataset.dataset_path={root}",
            f"dataset.cropsize=[{crop},{crop}]", f"dataset.ignore_idx={cfg['ignore']}",
            f"runtime.seed={seed}", f"runtime.compute_dtype={t['compute_dtype']}",
            f"runtime.device_augs={str(t['device_augs']).lower()}",
            f"runtime.device_geometric={str(t['device_geometric']).lower()}",
            f"runtime.remat={str(t['remat']).lower()}", "runtime.use_pallas=false",
            f"training_config.batch_size={int(tr['batch'])}",
            f"training_config.accum_steps={t['accum_steps']}",
            f"training_config.optimizer_lr_start={t['lr0']}",
            f"training_config.optimizer_momentum={t['momentum']}",
            f"training_config.optimizer_weight_decay={t['weight_decay']}",
            f"training_config.optimizer_power={t['power']}",
            f"training_config.warmup_steps={t['warmup_steps']}",
            f"training_config.warmup_start_lr={t['warmup_start_lr']}",
            f"training_config.max_iterations={t['max_iterations']}",
            f"training_config.max_grad_norm={t['max_grad_norm']}",
            f"training_config.ema_decay={t['ema_decay']}",
            f"training_config.ema_tau={t['ema_tau']}",
            f"training_config.cls_pw={t['cls_pw']}"]


def _describe(got: Dict, ref: Dict, ref16: Dict, moved: List[str], change) -> None:
    """The leaves behind the compared numbers, on standard error: the worst
    leaves of the program (`grad:`, `change:`) and of the reference under
    bf16 autocast (`grad16:`, `change16:`), each against the float32
    reference."""
    import sys

    print(f"losses {got['losses']} reference {ref['losses']}; "
          f"{len(moved)} leaves compared", file=sys.stderr)
    for who, run in (("", got), ("16", ref16)):
        for what, a, b in (("grad", run["grads1"], ref["grads1"]),
                           ("change", change(run["params3"]), change(ref["params3"]))):
            gaps = leaf_gaps(a, b, moved)
            top = sorted(gaps.items(), key=lambda kv: -kv[1])[:4]
            print(f"{what}{who}: worst leaf gap "
                  + ", ".join(f"{n} {v:.4g} (|got| {float(a[n].norm()):.4g} "
                              f"|ref| {float(b[n].norm()):.4g})" for n, v in top),
                  file=sys.stderr)


def _catch_logits(model, rows: List[int], into: Dict) -> object:
    """A forward hook that keeps, once, the rows `rows` of the model's
    final logits on the host (rows past the batch are left out)."""

    def hook(module, args, out):
        if "logits1" not in into:
            final = out[0].detach()
            into["logits1"] = final[[r for r in rows if r < final.shape[0]]].to("cpu")

    return model.register_forward_hook(hook)


def _logit_err(got: Optional[torch.Tensor], ref: torch.Tensor, dev) -> float:
    """Relative RMS error of `got` against `ref` (both on the host), a row
    at a time on `dev` in float64; inf where the rows do not match."""
    if got is None or got.shape != ref.shape:
        return float("inf")
    num = den = 0.0
    for a, b in zip(got, ref):
        a, b = a.to(dev, torch.float64), b.to(dev, torch.float64)
        num += float((a - b).square().sum())
        den += float(b.square().sum())
    return (num / max(den, 1e-300)) ** 0.5


class Loop:
    def __init__(self, ctx: Context):
        from cabinet_tpu_torch.cli import common
        from cabinet_tpu_torch.cli.train import DeviceAugment
        from cabinet_tpu_torch.core.config import compose
        from cabinet_tpu_torch.data.class_weights import (
            compute_class_weights,
            get_class_pixel_counts,
        )
        from cabinet_tpu_torch.train.optimizer import GroupedSGD
        from cabinet_tpu_torch.train.trainer import (
            TrainLoop,
            create_train_state,
            make_train_step,
        )

        cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
        t = cfg["train"]
        self.ctx, self.t = ctx, t
        self.B, self.crop = int(tr["batch"]), int(cfg["crop"])
        self.n_classes, self.ignore = int(cfg["num_classes"]), int(cfg["ignore"])
        P = int(tr["pool"])
        h, w = tr["frame_hw"]
        self.images = smooth_frames(ctx.seed, P, h, w, dev)
        self.raw = city_raw_labels(block_labels(ctx.seed, P, h, w, self.n_classes, dev))
        root = ctx.tmp / "cityscapes"
        write_city_split(root, self.images, self.raw)

        pcfg = compose(common.CONFIG_DIR, "train", _overrides(cfg, tr, root, ctx.seed))
        ds = common.build_datasets(pcfg, ["train"])[0]
        if getattr(ds, "geometric", "host") != "device":
            raise RuntimeError("the train set is not in device mode")
        with concurrent.futures.ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
            items = list(pool.map(ds.__getitem__, range(len(ds))))
        cw = compute_class_weights(get_class_pixel_counts(_Pool(items), self.n_classes,
                                                          self.ignore), float(t["cls_pw"]))
        self.batches = [tuple(np.stack([it[j] for it in items[i:i + self.B]]) for j in range(3))
                        for i in range(0, P - self.B + 1, self.B)]
        del items

        self.weights = make_state_dict(self.n_classes, ctx.seed, dev,
                                       calib_hw=min(512, self.crop))
        model = common.build_model(pcfg, self.n_classes)
        model.load_state_dict(self.weights)
        model.to(dev)
        tc = pcfg.training_config
        opt = GroupedSGD(model, lr0=float(tc.optimizer_lr_start),
                         max_iter=int(tc.max_iterations), momentum=float(tc.optimizer_momentum),
                         wd=float(tc.optimizer_weight_decay), power=float(tc.optimizer_power),
                         warmup_steps=int(tc.warmup_steps),
                         warmup_start_lr=float(tc.warmup_start_lr),
                         max_grad_norm=float(tc.max_grad_norm))
        state = create_train_state(model, opt, ema_decay=float(tc.ema_decay),
                                   ema_tau=float(tc.ema_tau))
        state.step = int(t["start_step"])
        self.n_min = self.B * self.crop * self.crop // int(t["ohem_divisor"])
        step = make_train_step(n_min=self.n_min, thresh=float(t["ohem_thresh"]),
                               ignore_label=self.ignore, class_weights=cw,
                               accum_steps=int(tc.accum_steps),
                               compute_dtype=common.compute_dtype_of(pcfg))
        augment = DeviceAugment(pcfg, ds, dev, (self.crop, self.crop))
        self.cuda = dev.type == "cuda"
        self.aug_events: List = []

        def aug_fn(raw, step_, micro_step):
            if not self.cuda:
                return augment(raw, step_, micro_step)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = augment(raw, step_, micro_step)
            b.record()
            self.aug_events.append((a, b))
            return out

        self.loop = TrainLoop(state, step, dev, aug_fn)  # DeviceAugment draws from seed + 1
        self.counters = Counters()
        self.steps = 0
        # the checked steps: the window's own call and feed, from the seed
        self.losses = []
        self.rows = sample(ctx.seed, list(range(self.B)), LOGIT_ROWS, 4)
        self.caught: Dict = {}
        hook = _catch_logits(model, self.rows, self.caught)
        for k in range(int(tr["checked_steps"])):
            self.losses.append(self._feed())
            if k == 0:
                hook.remove()
                self.grads1 = self._first_grads(model, opt)
        self.params3 = {n: p.detach().clone() for n, p in model.named_parameters()}
        self.ema3 = {n: state.ema.shadow[n].clone() for n in self.params3}
        self.losses = [float(v) for v in self.losses]
        self.steps = 0
        self.aug_events.clear()
        self.checked = int(tr["checked_steps"])

    def _feed(self) -> torch.Tensor:
        loss = self.loop.feed(*self.batches[self.steps % len(self.batches)])
        self.steps += 1
        return loss

    def _first_grads(self, model, opt) -> Dict[str, torch.Tensor]:
        """The gradient the optimizer got on the first step: its momentum
        buffer after that step less the weight decay it added."""
        wd = {id(p): g["weight_decay"] for g in opt.sgd.param_groups for p in g["params"]}
        out = {}
        for n, p in model.named_parameters():
            buf = opt.sgd.state.get(p, {}).get("momentum_buffer")
            out[n] = (torch.zeros_like(p) if buf is None  # no update reached it
                      else buf - wd[id(p)] * self.weights[n])
        return out

    def run_until(self, deadline: float) -> None:
        while time.perf_counter() < deadline:
            self._feed()

    @property
    def attempted(self) -> int:
        return self.steps * self.B

    def e2e(self, window_s: float) -> Dict[str, float]:
        self.counters.units_per_s = self.steps * self.B / window_s
        return {"train_images_per_s": self.counters.units_per_s}

    def layer_counters(self) -> Counters:
        c = self.counters
        c.model_flops_per_unit = 3.0 * work.forward_flops(self.n_classes, 1, self.crop, self.crop)
        c.aug_ms = [a.elapsed_time(b) for a, b in self.aug_events]
        return c

    def release(self) -> None:
        self.loop = None

    # ---------------------------------------------------------- judging
    def _reference_run(self, lowp: Optional[str] = None) -> Dict:
        dev = self.ctx.device
        cfg = self.ctx.config
        model = CABiNet(self.n_classes)
        model.load_state_dict(self.weights)
        model.to(dev)
        set_fp8(model, lowp == "fp8")
        model.set_remat(True)
        S = max(2 * self.crop, *self.images.shape[1:3])
        trainids = city_trainids(self.raw, self.ignore)
        weights = ref_train.class_weights(torch.from_numpy(trainids).to(dev), self.n_classes,
                                          self.ignore, float(self.t["cls_pw"])).to(dev)
        trainer = ref_train.Trainer(model, self.t, int(self.t["start_step"]))
        P, (h, w) = len(self.images), self.images.shape[1:3]
        losses = []
        caught: Dict = {}
        hook = _catch_logits(model, self.rows, caught)
        for k in range(self.checked):
            rows = [(k * self.B + i) % P for i in range(self.B)]
            canvas = torch.zeros((self.B, S, S, 3), dtype=torch.uint8, device=dev)
            labels = torch.full((self.B, S, S), self.ignore, dtype=torch.uint8, device=dev)
            canvas[:, :h, :w] = torch.from_numpy(self.images[rows]).to(dev)
            labels[:, :h, :w] = torch.from_numpy(trainids[rows]).to(dev)
            hw = np.tile(np.array([[h, w]], np.int32), (self.B, 1))
            images, lbl = ref_aug.augment(canvas, labels, hw, self.ctx.seed + 1,
                                          int(self.t["start_step"]) + k, 0,
                                          (self.crop, self.crop), self.ignore,
                                          cfg["mean"], cfg["std"])
            del canvas, labels
            with lowp_forward(lowp, dev):
                losses.append(trainer.step(images, lbl, self.n_min, weights, self.ignore))
            hook.remove()
        names = [n for n, _ in model.named_parameters()]
        return {"losses": losses, "logits1": caught.get("logits1"),
                "grads1": trainer.first_grads,
                "params3": ref_train.weights_now(model),
                "ema3": {n: trainer.ema[n] for n in names}}

    def _judge(self, got: Dict, ref: Dict, ref16: Dict) -> Dict:
        import sys

        lim = self.ctx.limits
        moved = ref_train.names_moved(ref["grads1"])
        p0 = self.weights

        def change(d):
            return {n: d[n].float() - p0[n] for n in moved}

        def median_gap(a, b):
            return float(np.median(list(leaf_gaps(a, b, moved).values())))

        loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                       for a, b in zip(got["losses"], ref["losses"]))
        _describe(got, ref, ref16, moved, change)
        mine, theirs = change(got["params3"]), change(ref["params3"])
        unmoved = sum(float(mine[n].norm()) < 1e-2 * float(theirs[n].norm()) for n in moved)
        out = {"loss_gap": check(loss_gap, lim["loss_gap"]),
               "unmoved_leaves": check(unmoved, lim["unmoved_leaves"])}
        dev = self.ctx.device
        err = _logit_err(got["logits1"], ref["logits1"], dev)
        base = _logit_err(ref16["logits1"], ref["logits1"], dev)
        print(f"first step's logits: error {err!r}, the bf16 reference's {base!r}",
              file=sys.stderr)
        out["logit_err_ratio"] = check(err / max(base, 1e-300), lim["logit_err_ratio"])
        for name, a, b, c in (
                ("grad_gap_ratio", got["grads1"], ref["grads1"], ref16["grads1"]),
                ("change_gap_ratio", change(got["params3"]), change(ref["params3"]),
                 change(ref16["params3"])),
                ("ema_gap_ratio", change(got["ema3"]), change(ref["ema3"]),
                 change(ref16["ema3"]))):
            gap, base = median_gap(a, b), median_gap(c, b)
            print(f"{name}: median leaf gap {gap!r}, the bf16 reference's {base!r}",
                  file=sys.stderr)
            out[name] = check(gap / max(base, 1e-300), lim[name])
        return out

    def check(self) -> Dict:
        reference_precision()
        got = {"losses": self.losses, "logits1": self.caught.get("logits1"),
               "grads1": self.grads1, "params3": self.params3, "ema3": self.ema3}
        return self._judge(got, self._reference_run(), self._reference_run("bf16"))

    def control(self, lowp: str = "fp8") -> Dict:
        reference_precision()
        return self._judge(self._reference_run(lowp), self._reference_run(),
                           self._reference_run("bf16"))
