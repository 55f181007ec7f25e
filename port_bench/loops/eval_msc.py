"""The port's multi-scale sliding-window evaluation,
`eval/evaluator.py:MscEval.evaluate`, over an in-memory set of frames and
labels cycled for as long as the window lasts, built as
`cli/evaluate.py:evaluate_checkpoint` builds it: `configs/evaluate.yaml`
composed by `core/config.py:compose` with the configuration's `eval`
overrides and the mix's batch, scales and flip, the model, forward, tile
batch and accumulation dtype from the port's own `cli/common.py` and
`cli/evaluate.py:make_eval_forward`.

Traffic parameters: `frames` (distinct frames), `frame_hw`, `val_batch`,
`scales`, `flip`, `warmup_batches`, `trace_seconds`, and `weights_seed`
where the weights are to be the same for every run's seed: the
evaluation's rate moves with the weights by some 6% (PERF.md), so its
cell draws them from a fixed seed, and its runs' seeds draw the frames
and the batches' order.

Judged after the window, on a batch drawn from the seed before it: the
summed multi-scale probability map that the window's last scoring of that
batch argmaxed, caught where `MscEval` computed it, against the
reference's own float32 protocol over the same frames: the relative RMS
error, divided by the one the reference makes under bf16 autocast
(`prob_err_ratio`); the predictions against the argmax of that map
(`pred_mismatch`, the share of pixels, exact); and the confusion matrix
the window summed against the one its last predictions of every batch
give, counted as often as each batch was scored (`hist_gap`, the share of
pixels placed otherwise, exact). The widest and the mean gap by which the
predicted class's reference probability lies below the reference's best
go to standard error.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from port_bench import work
from port_bench.loops.base import (
    Context,
    Counters,
    check,
    lowp_forward,
    reference_precision,
    rel_err,
    sample,
)
from port_bench.frames import block_labels, normalised, smooth_frames
from port_bench.reference.model import CABiNet, set_fp8
from port_bench.weights import make_state_dict

STRIDE_RATE = 5 / 6.0  # the reference protocol's tile stride, of the crop


def tile_starts(full: int, crop: int, stride: int) -> List[int]:
    n = -(-max(full - crop, 0) // stride) + 1
    return [min(stride * i, full - crop) for i in range(n)]


def tiles_per_frame(h: int, w: int, crop: int, scales) -> int:
    stride = int(crop * STRIDE_RATE)
    n = 0
    for s in scales:
        sh, sw = max(int(h * s), crop), max(int(w * s), crop)
        n += len(tile_starts(sh, crop, stride)) * len(tile_starts(sw, crop, stride))
    return n


def reference_probs(model, image: torch.Tensor, n_classes: int, crop: int, scales,
                    flip: bool, chunk: int = 8, lowp: Optional[str] = None) -> torch.Tensor:
    """(B,H,W,3) f32 -> (B,H,W,C) the sum over the scales of each scale's
    overlap-averaged softmax, resized back: the protocol in float32."""
    B, H, W, _ = image.shape
    stride = int(crop * STRIDE_RATE)
    total = torch.zeros((B, n_classes, H, W), device=image.device)
    x = image.permute(0, 3, 1, 2)
    for s in scales:
        sh, sw = int(H * s), int(W * s)
        xs = F.interpolate(x, size=(sh, sw), mode="bilinear", align_corners=False)
        fh, fw = max(sh, crop), max(sw, crop)
        top, left = (fh - sh) // 2, (fw - sw) // 2
        xs = F.pad(xs, (left, fw - sw - left, top, fh - sh - top))
        prob = torch.zeros((B, n_classes, fh, fw), device=image.device)
        count = torch.zeros((fh, fw), device=image.device)
        tiles = [(y, x0) for y in tile_starts(fh, crop, stride)
                 for x0 in tile_starts(fw, crop, stride)]
        for i in range(0, len(tiles), chunk):
            part = tiles[i:i + chunk]
            chips = torch.cat([xs[:, :, y:y + crop, x0:x0 + crop] for y, x0 in part])
            with torch.no_grad(), lowp_forward(lowp, chips.device):
                p = torch.softmax(model(chips)[0].float(), 1)
                if flip:
                    p = 0.5 * (p + torch.softmax(model(chips.flip(3))[0].float(), 1).flip(3))
            for j, (y, x0) in enumerate(part):
                prob[:, :, y:y + crop, x0:x0 + crop] += p[j * B:(j + 1) * B]
                count[y:y + crop, x0:x0 + crop] += 1.0
        prob = (prob / count)[:, :, top:top + sh, left:left + sw]
        total += F.interpolate(prob, size=(H, W), mode="bilinear", align_corners=False)
    return total.permute(0, 2, 3, 1)


def _overrides(cfg: Dict, tr: Dict) -> List[str]:
    crop = int(cfg["crop"])
    return [f"dataset={cfg['dataset']}", f"dataset.cropsize=[{crop},{crop}]",
            f"dataset.ignore_idx={cfg['ignore']}",
            f"validation_config.batch_size={int(tr['val_batch'])}",
            f"validation_config.eval_scales=[{','.join(str(s) for s in tr['scales'])}]",
            f"validation_config.flip={str(bool(tr['flip'])).lower()}",
            *cfg["eval"]["overrides"]]


class Loop:
    def __init__(self, ctx: Context):
        from cabinet_tpu_torch.cli import common
        from cabinet_tpu_torch.cli.evaluate import make_eval_forward
        from cabinet_tpu_torch.core.config import compose
        from cabinet_tpu_torch.eval.evaluator import MscEval

        cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
        pcfg = compose(common.CONFIG_DIR, "evaluate", _overrides(cfg, tr))
        vc = pcfg.validation_config
        self.ctx = ctx
        self.n_classes, self.ignore, self.crop = (int(pcfg.dataset.num_classes),
                                                  int(pcfg.dataset.ignore_idx),
                                                  max(pcfg.dataset.cropsize))
        self.scales, self.flip = tuple(vc.eval_scales), bool(vc.flip)
        n, B = int(tr["frames"]), int(vc.batch_size)
        h, w = tr["frame_hw"]
        u8 = smooth_frames(ctx.seed, n, h, w, dev)
        labels = block_labels(ctx.seed, n, h, w, self.n_classes, dev).astype(np.int64)
        labels[:, :h // 16] = self.ignore
        self.images = [normalised(u8[i:i + B], cfg["mean"], cfg["std"]) for i in range(0, n, B)]
        self.labels = [labels[i:i + B] for i in range(0, n, B)]
        del u8
        self.weights = make_state_dict(self.n_classes, int(tr.get("weights_seed", ctx.seed)), dev,
                                       calib_hw=min(512, self.crop))
        model = common.build_model(pcfg, self.n_classes)
        model.load_state_dict(self.weights, strict=True)
        dtype = common.compute_dtype_of(pcfg)
        fused_tail = str(pcfg.select("runtime.fused_tail", "auto")).lower()
        forward = make_eval_forward(model, self.crop, dev, dtype,
                                    use_pallas=bool(pcfg.select("runtime.use_pallas", False)),
                                    fused_tail=fused_tail if fused_tail in ("auto", "true")
                                    else "false")
        self.tile_batch = common.eval_tile_batch(pcfg)
        outer = self

        class Recording(MscEval):
            """MscEval keeping each batch's last predictions, in the order
            the batches were scored."""

            def _probs(self, variables, images):
                p = super()._probs(variables, images)
                if outer.order[outer.scored] == outer.judged:
                    outer.caught = p.detach().clone()
                return p

            def _run(self, variables, images, labels):
                preds, hist = super()._run(variables, images, labels)
                outer.preds[outer.order[outer.scored]] = preds.to(torch.uint8)
                outer.scored += 1
                return preds, hist

        self.msc = Recording(forward, self.n_classes, ignore_label=self.ignore,
                             scales=self.scales, flip=self.flip, cropsize=self.crop,
                             compute_dtype=dtype,
                             pad_to=pcfg.select("validation_config.eval_pad_to", None),
                             tile_batch=self.tile_batch,
                             acc_dtype=common.eval_acc_dtype(pcfg), device=dev)
        self.preds: Dict[int, torch.Tensor] = {}
        self.judged = sample(ctx.seed, list(range(len(self.images))), 1, 2)[0]
        # the batches' order, from the seed
        self.cycle = np.random.default_rng([int(ctx.seed), 3]).permutation(len(self.images))
        self.caught = None
        self.hist = np.zeros((self.n_classes, self.n_classes), np.int64)
        self.counts = np.zeros(len(self.images), np.int64)
        self.order: List[int] = []
        self.scored = 0
        self.counters = Counters()
        self.frames = 0
        self._evaluate(time.perf_counter() + 1e9, int(tr["warmup_batches"]))
        self.hist[:] = 0
        self.counts[:] = 0
        self.frames = 0
        self.counters = Counters()

    def _batches(self, deadline: float, limit: int):
        k = 0
        while time.perf_counter() < deadline and k < limit:
            i = int(self.cycle[len(self.order) % len(self.images)])
            self.order.append(i)
            k += 1
            yield self.images[i], self.labels[i]

    def _evaluate(self, deadline: float, limit: int = 1 << 62) -> None:
        start = len(self.order)
        res = self.msc.evaluate(None, self._batches(deadline, limit))
        self.hist += np.asarray(res["confusion_matrix"], np.int64)
        for i in self.order[start:]:
            self.counts[i] += 1
        t = res["timing"]
        self.frames += int(t["frames"])
        self.counters.loop_s += float(t["seconds"])
        self.counters.loader_wait_s += float(t["loader_wait_seconds"])

    def run_until(self, deadline: float) -> None:
        self._evaluate(deadline)

    @property
    def attempted(self) -> int:
        return self.frames

    def e2e(self, window_s: float) -> Dict[str, float]:
        self.counters.units_per_s = self.frames / window_s
        return {"eval_frames_per_s": self.counters.units_per_s}

    def layer_counters(self) -> Counters:
        c = self.counters
        h, w = self.ctx.traffic["frame_hw"]
        tiles = tiles_per_frame(h, w, self.crop, self.scales) * (2 if self.flip else 1)
        c.model_flops_per_unit = tiles * work.forward_flops(self.n_classes, 1, self.crop,
                                                            self.crop)
        # a forward's images, on average over a batch's folds of tiles
        B = int(self.ctx.traffic["val_batch"])
        group = max(self.tile_batch // B, 1)
        per_frame = tiles_per_frame(h, w, self.crop, self.scales)
        folds = -(-per_frame // group)
        imgs = per_frame * B * (2 if self.flip else 1) / folds
        S = self.crop // 8
        c.kernel_work = {
            "K1": work.k1_attention(1, (self.crop // 32) ** 2, 128, 128).scaled(imgs),
            "K2": work.k2_ffm_pointwise(S * S, -(-S * S // 64)).scaled(imgs),
            "K3": work.k3_head(S * S, 1, self.n_classes).scaled(imgs),
        }
        return c

    def release(self) -> None:
        self.msc = None

    # ---------------------------------------------------------- judging
    def _reference(self, lowp: Optional[str] = None):
        ref = CABiNet(self.n_classes)
        ref.load_state_dict(self.weights)
        set_fp8(ref, lowp == "fp8")
        return ref.to(self.ctx.device).eval()

    def _probs(self, ref, i: int, lowp: Optional[str] = None) -> torch.Tensor:
        x = torch.from_numpy(self.images[i]).to(self.ctx.device)
        return reference_probs(ref, x, self.n_classes, self.crop, self.scales, self.flip,
                               lowp=lowp)

    def _judge(self, probs: torch.Tensor, preds: torch.Tensor) -> Dict:
        """`probs` (B,H,W,C) and `preds` (B,H,W) of the judged batch."""
        import sys

        lim = self.ctx.limits
        if probs is None or preds is None or probs.shape[0] != preds.shape[0]:
            return {"prob_err_ratio": check(math.inf, lim["prob_err_ratio"]),
                    "pred_mismatch": check(math.inf, lim["pred_mismatch"])}
        ref = self._probs(self._reference(), self.judged)
        base = rel_err(self._probs(self._reference("bf16"), self.judged, "bf16"), ref)
        got = probs.to(ref.device).float()
        p = preds.to(ref.device).long()
        err = rel_err(got, ref)
        mismatch = float((p != got.argmax(-1)).double().mean())
        chosen = ref.gather(-1, p.clamp(max=self.n_classes - 1)[..., None])[..., 0]
        g = ref.amax(-1) - chosen
        print(f"probability error {err!r}, the bf16 reference's {base!r}; predicted-class "
              f"probability gap: widest {float(g.max())!r}, mean {float(g.double().mean())!r}",
              file=sys.stderr)
        return {"prob_err_ratio": check(err / max(base, 1e-300), lim["prob_err_ratio"]),
                "pred_mismatch": check(mismatch, lim["pred_mismatch"])}

    def _hist_gap(self) -> float:
        """The share of the window's pixels that its confusion matrix places
        otherwise than its batches' last predictions do."""
        dev = self.ctx.device
        want = torch.zeros((self.n_classes, self.n_classes), dtype=torch.int64, device=dev)
        for i, n in enumerate(self.counts):
            if n == 0:
                continue
            if i not in self.preds:
                return float("inf")
            lbl = torch.from_numpy(self.labels[i]).to(dev)
            valid = lbl != self.ignore
            idx = (self.preds[i].long().clamp(max=self.n_classes - 1) * self.n_classes
                   + lbl.clamp(max=self.n_classes - 1))[valid]
            want += int(n) * torch.bincount(idx, minlength=self.n_classes ** 2).view(
                self.n_classes, self.n_classes)
        want = want.cpu().numpy()
        return float(np.abs(want - self.hist).sum() / 2 / max(want.sum(), 1))

    def check(self) -> Dict:
        reference_precision()
        out = self._judge(self.caught, self.preds.get(self.judged))
        out["hist_gap"] = check(self._hist_gap(), self.ctx.limits["hist_gap"])
        return out

    def control(self, lowp: str = "fp8") -> Dict:
        reference_precision()
        probs = self._probs(self._reference(lowp), self.judged, lowp)
        return self._judge(probs, probs.argmax(-1))
