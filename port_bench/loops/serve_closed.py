"""One caller in a closed loop drives the port's request path,
`cli/infer.py:Segmenter.step` (`BatchStep.__call__`), with micro-batches
of distinct frames cycled from a pool held in host memory.

Traffic parameters: `batch` (frames a call, the engine's batch),
`frame_hw` (each frame's size), `pool` (distinct frames made from the
seed), `warmup_batches`, `check_frames` (frames whose last answer is
judged after the window), `trace_seconds`.

Judged after the window, on a sample of frames drawn from the seed before
it: the forward's logits for those frames, caught where the window's own
forward returned them, against the reference's float32 logits of the same
frames (its own resize and normalisation). Their relative RMS error is
divided by the error that bf16 arithmetic itself makes there, the
reference under bf16 autocast (`logit_err_ratio`): a sound bf16 program
reads about 1, one computing a step lower several. The class IDs the
window served are held to the argmax of those logits (`class_mismatch`,
the share of pixels, exact). The widest gap by which a served class's
reference logit lies below the reference's best goes to standard error.
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
    sample,
)
from port_bench.frames import smooth_frames
from port_bench.reference.model import CABiNet, set_fp8
from port_bench.weights import make_state_dict


def resize_like_pil(x: torch.Tensor, size) -> torch.Tensor:
    """uint8 (B,3,H,W) -> uint8 at `size`, as PIL's BILINEAR resizes a
    uint8 image: the width, then the height, each pass anti-aliased on a
    downscale and rounded half up to a level."""
    t = x.float()
    H, W = t.shape[2:]
    if W != size[1]:
        t = torch.floor(F.interpolate(t, size=(H, size[1]), mode="bilinear",
                                      align_corners=False, antialias=True) + 0.5).clamp(0, 255)
    if H != size[0]:
        t = torch.floor(F.interpolate(t, size=tuple(size), mode="bilinear",
                                      align_corners=False, antialias=True) + 0.5).clamp(0, 255)
    return t.to(torch.uint8)


class Loop:
    def __init__(self, ctx: Context):
        from cabinet_tpu_torch.cli.infer import Segmenter

        cfg, tr = ctx.config, ctx.traffic
        self.ctx = ctx
        self.batch = int(tr["batch"])
        self.imgsz = int(cfg["imgsz"])
        self.n_classes = int(cfg["num_classes"])
        sd = make_state_dict(self.n_classes, ctx.seed, ctx.device, calib_hw=min(512, self.imgsz))
        self.weights = {k: v.cpu() for k, v in sd.items()}  # the reference's copy
        del sd
        ckpt = ctx.tmp / "weights.pth"
        torch.save(self.weights, ckpt)
        self.seg = Segmenter(str(ckpt), cfg["dataset"], cfg["mode"], self.imgsz,
                             cfg["dtype"], batch=self.batch,
                             kernel_attn=bool(cfg["kernel_attn"]), device=ctx.device)
        ckpt.unlink()
        h, w = tr["frame_hw"]
        if list(cfg.get("frame_hw", [h, w])) != [h, w]:
            raise ValueError(f"the mix's frames are {h}x{w}, the configuration's "
                             f"{cfg['frame_hw'][0]}x{cfg['frame_hw'][1]}")
        self.pool = list(smooth_frames(ctx.seed, int(tr["pool"]), h, w, ctx.device))
        self.judged = sample(ctx.seed, list(range(len(self.pool))),
                             int(tr["check_frames"]), 1)
        self.caught: Dict[int, torch.Tensor] = {}
        self._ids: List[int] = []
        forward_logits = self.seg._logits

        def logits(x):  # the window's forward, its judged rows kept
            out = forward_logits(x)
            for row, k in enumerate(self._ids[:out.shape[0]]):
                if k in self.judged:
                    self.caught[k] = out[row].detach().clone()
            return out

        self.seg._logits = logits
        self.served: Dict[int, np.ndarray] = {}
        self.frames = self.calls = 0
        self.counters = Counters()
        for _ in range(int(tr["warmup_batches"])):
            self._call()
        self.frames = self.calls = 0
        self.served.clear()

    def _call(self) -> float:
        P = len(self.pool)
        ids = self._ids = [(self.calls * self.batch + j) % P for j in range(self.batch)]
        t0 = time.perf_counter()
        out = self.seg.step([self.pool[k] for k in ids], self.batch)
        dt = time.perf_counter() - t0
        for j, k in enumerate(ids):
            self.served[k] = out[j]
        self.calls += 1
        self.frames += len(ids)
        return dt

    def run_until(self, deadline: float) -> None:
        while time.perf_counter() < deadline:
            self.counters.batch_s.append(self._call())

    @property
    def attempted(self) -> int:
        return self.frames

    def e2e(self, window_s: float) -> Dict[str, float]:
        self.counters.units_per_s = self.frames / window_s
        return {"frames_per_s": self.counters.units_per_s}

    def layer_counters(self) -> Counters:
        c, B, S = self.counters, self.batch, self.imgsz
        c.model_flops_per_unit = work.forward_flops(self.n_classes, 1, S, S)
        P = B * (S // 8) ** 2
        c.kernel_work = {
            "K1": work.k1_attention(B, (S // 32) ** 2, 128, 128),
            "K2": work.k2_ffm_pointwise(P, B * -(-(S // 8) ** 2 // 64)),
            "K3": work.k3_head(P, B, self.n_classes),
            "K4": work.k4_stem_block0(B, S, S),
        }
        return c

    def release(self) -> None:
        self.seg = None

    # ---------------------------------------------------------- judging
    def _reference(self, lowp: Optional[str] = None) -> torch.nn.Module:
        ref = CABiNet(self.n_classes)
        ref.load_state_dict(self.weights)
        set_fp8(ref, lowp == "fp8")
        return ref.to(self.ctx.device).eval()

    def _logits(self, ref, ids: List[int], lowp: Optional[str] = None) -> torch.Tensor:
        cfg, S = self.ctx.config, self.imgsz
        x = torch.from_numpy(np.stack([self.pool[k] for k in ids])).to(self.ctx.device)
        x = resize_like_pil(x.permute(0, 3, 1, 2), (S, S))
        mean = torch.tensor(cfg["mean"], device=x.device).view(1, 3, 1, 1)
        std = torch.tensor(cfg["std"], device=x.device).view(1, 3, 1, 1)
        with torch.no_grad(), lowp_forward(lowp, x.device):
            return ref((x.float() / 255.0 - mean) / std)[0].float()

    def _judge(self, logits: Dict[int, torch.Tensor], answers: Dict[int, torch.Tensor]
               ) -> Dict:
        """`logits[k]` (S,S,C) and `answers[k]` (S,S) of each judged frame."""
        import sys

        lim = self.ctx.limits
        if any(k not in logits or k not in answers for k in self.judged):
            return {"logit_err_ratio": check(math.inf, lim["logit_err_ratio"]),
                    "class_mismatch": check(math.inf, lim["class_mismatch"])}
        ref, ref16 = self._reference(), self._reference("bf16")
        err2 = err16 = ref2 = 0.0
        mismatched = n = 0
        gap = 0.0
        for i in range(0, len(self.judged), 4):
            chunk = self.judged[i:i + 4]
            r = self._logits(ref, chunk).permute(0, 2, 3, 1).double()
            r16 = self._logits(ref16, chunk, "bf16").permute(0, 2, 3, 1).double()
            got = torch.stack([logits[k] for k in chunk]).to(r.device).double()
            served = torch.stack([answers[k] for k in chunk]).to(r.device).long()
            err2 += float((got - r).square().sum())
            err16 += float((r16 - r).square().sum())
            ref2 += float(r.square().sum())
            mismatched += int((served != got.argmax(-1)).sum())
            n += served.numel()
            chosen = r.gather(-1, served.clamp(0, self.n_classes - 1)[..., None])[..., 0]
            gap = max(gap, float((r.amax(-1) - chosen).max()))
        rms = (ref2 / max(n * self.n_classes, 1)) ** 0.5
        err, base = (err2 / max(ref2, 1e-300)) ** 0.5, (err16 / max(ref2, 1e-300)) ** 0.5
        print(f"logit error {err!r}, the bf16 reference's {base!r}; widest served-class "
              f"logit gap {gap / max(rms, 1e-30)!r} of the reference logits' RMS",
              file=sys.stderr)
        return {"logit_err_ratio": check(err / max(base, 1e-300), lim["logit_err_ratio"]),
                "class_mismatch": check(mismatched / max(n, 1), lim["class_mismatch"])}

    def check(self) -> Dict:
        reference_precision()
        return self._judge(self.caught, {k: torch.from_numpy(np.asarray(self.served[k]))
                                         for k in self.judged if k in self.served})

    def control(self, lowp: str = "fp8") -> Dict:
        """The reference in a lower precision in the program's place, judged
        alike."""
        reference_precision()
        model = self._reference(lowp)
        logits = {}
        for i in range(0, len(self.judged), 4):
            chunk = self.judged[i:i + 4]
            logits.update(zip(chunk, self._logits(model, chunk, lowp).permute(0, 2, 3, 1)))
        return self._judge(logits, {k: v.argmax(-1) for k, v in logits.items()})
