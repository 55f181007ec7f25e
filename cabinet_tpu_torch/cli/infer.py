"""Inference CLI for CABiNet checkpoints on the GPU (counterpart of
`cabinet_tpu.cli.infer`).

Routes by path type/extension:
  - image (.png/.jpg/...): writes <stem>_mask.png + <stem>_overlay.png (PNG
    read and written by the port's own codec, other formats read by PIL)
  - folder: every image inside
  - video (.mp4/.avi/...): writes <stem>_mask.mp4 + <stem>_overlay.mp4,
    batch-1 at the fixed resolution, or chunks of frames with --batch N
    (N >= 8 adds the stem+block_0 kernel, as the JAX engine does)
  - --showcase: a 2x2 mosaic video of up to 4 clips

Usage:
    python -m cabinet_tpu_torch.cli.infer --checkpoint ck.pth --dataset uavid \
        --source img.png [--out-dir out] [--alpha 0.5] [--imgsz 1024]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from cabinet_tpu_torch.core.device import resolve_device
from cabinet_tpu_torch.core.exceptions import ModelLoadError
from cabinet_tpu_torch.data.datasets import DATASET_REGISTRY
from cabinet_tpu_torch.models.cabinet import CABiNet
from cabinet_tpu_torch.utils.profiler import count, span

IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}
VIDEO_EXTS = {".mp4", ".avi", ".mov", ".mkv"}


def load_state_dict(checkpoint: Union[str, Path], model: torch.nn.Module
                    ) -> Dict[str, torch.Tensor]:
    """Weights for `model` (a CABiNet or a YOLOSem) from a `.pth` (a state
    dict, a reference training checkpoint with `model_state`/`ema_state`,
    or a full training checkpoint of the port's trainer) or a JAX variables
    `.npz` (nested or flat keys, through `utils.convert`);
    `train.checkpoint.load_any_checkpoint` reads them."""
    from cabinet_tpu_torch.train.checkpoint import load_any_checkpoint

    try:
        blob = load_any_checkpoint(checkpoint, model)
    except ModelLoadError as e:
        raise ValueError(str(e)) from None
    sd = {k: v for k, v in blob.items() if not k.startswith("mobile.classifier")}
    # BN step counters are bookkeeping, not weights; a state dict written
    # from JAX variables has none.
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd.setdefault(k, v)
    return sd


def choose_route(mode: str, device_type: str, dtype: torch.dtype, batch: int,
                 imgsz: int, n_classes: int) -> str:
    """The forward `Segmenter` runs, by the rule of
    `cabinet_tpu.cli.infer.Segmenter` with "the backend is a TPU" read as
    "the device is CUDA":

      - "fused_tail_early": Large, bf16, a supported /8 grid, batch >= 8 and
        a supported early stage: K4, then the fused tail (K2, K3);
      - "fused_tail": the same below batch 8 or without K4's support;
      - "fused_early": otherwise, at batch >= 8 with K4's support: K4 in
        front of the model's own forward (`make_fused_apply`);
      - "model": the model's forward.

    The CAB attention is the model's choice on every route."""
    from cabinet_tpu_torch.models.fused import fused_early_supported
    from cabinet_tpu_torch.ops.decoder_tail import fused_tail_supported

    if mode != "large" or device_type != "cuda":
        return "model"
    s8 = imgsz // 8
    early = batch >= 8 and fused_early_supported((1, imgsz, imgsz, 3))
    if fused_tail_supported(s8, s8, n_classes) and dtype == torch.bfloat16:
        return "fused_tail_early" if early else "fused_tail"
    return "fused_early" if early else "model"


def _resize_like_pil(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Resize (B,3,H,W) uint8 levels (a float tensor holding them is cast)
    as PIL's BILINEAR resizes a uint8 image: the width first and then the
    height, a triangle filter widened by the scale on a downscale
    (anti-aliased), each pass rounded to uint8. On the CPU, torch's
    anti-aliased bilinear on uint8, which follows those two passes with
    fixed-point weights of its own; on CUDA, which takes no uint8 there,
    each pass in f32, rounded half up. Within one level of PIL on every
    pixel either way. Returns uint8."""
    x = x.to(torch.uint8)
    if tuple(x.shape[2:]) == tuple(size):
        return x
    if x.device.type == "cpu":
        return F.interpolate(x, size=tuple(size), mode="bilinear",
                             align_corners=False, antialias=True)

    def one_pass(t, hw):
        t = F.interpolate(t, size=hw, mode="bilinear", align_corners=False,
                          antialias=True)
        return torch.floor(t + 0.5).clamp_(0.0, 255.0)

    H, W = x.shape[2:]
    t = x.float()
    if W != size[1]:
        t = one_pass(t, (H, size[1]))
    if H != size[0]:
        t = one_pass(t, tuple(size))
    return t.to(torch.uint8)


def resize_frame(rgb: torch.Tensor, imgsz: int) -> torch.Tensor:
    """An RGB uint8 (H,W,3) frame at the engine's fixed resolution, uint8
    (imgsz, imgsz, 3) on the frame's device, by `_resize_like_pil`'s
    rule."""
    if tuple(rgb.shape[:2]) == (imgsz, imgsz):
        return rgb
    return _resize_like_pil(rgb.permute(2, 0, 1)[None],
                            (imgsz, imgsz))[0].permute(1, 2, 0)


def check_frame(rgb: np.ndarray) -> np.ndarray:
    """`rgb` as a C-contiguous array; raises unless it is an RGB uint8
    (H, W, 3) frame."""
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3 \
            or 0 in rgb.shape:
        raise ValueError(f"expected an RGB uint8 (H, W, 3) frame, got "
                         f"{rgb.shape} {rgb.dtype}")
    return np.ascontiguousarray(rgb)


class BatchStep:
    """The request path: n RGB uint8 (H,W,3) frames, of any sizes -> uint8
    class IDs (n, size, size) at the fixed resolution, through `forward`
    (uint8 (rows, size, size, 3) on `device` -> class IDs (rows, size,
    size)).

    One copy of the n frames' bytes to the device (through a pinned
    staging buffer on CUDA, grown as needed and reused from call to call),
    each frame resized there by `resize_frame`, padding with zero rows up
    to `rows`, the forward, a cast to uint8 and one copy of the n real rows
    back, which waits for the device. The counterpart of the JAX server's
    `_pad_to_regime` and of the JAX engine's host resize. Not for
    concurrent callers: the staging buffer is shared."""

    def __init__(self, forward: Callable[[torch.Tensor], torch.Tensor],
                 device: torch.device, size: int):
        self.forward = forward
        self.device = torch.device(device)
        self.size = int(size)
        self._staging: Optional[torch.Tensor] = None
        self._copied: Optional[torch.cuda.Event] = None

    def upload(self, frames: Sequence[np.ndarray]) -> list:
        """The frames as uint8 (H,W,3) tensors on the device, from one
        copy. Spans: `serve.stage` (host: the checks, the wait for the last
        copy out of the staging buffer, the frames copied into it) and
        `serve.upload` (the copy to the device)."""
        cuda = self.device.type == "cuda"
        with span("serve.stage"):
            frames = [check_frame(f) for f in frames]
            if cuda:
                total = sum(f.size for f in frames)
                if self._copied is not None:  # the last copy out of the staging buffer
                    self._copied.synchronize()
                st = self._staging
                if st is None or st.numel() < total:
                    st = self._staging = torch.empty(total, dtype=torch.uint8,
                                                     pin_memory=True)
                ends = np.cumsum([0] + [f.size for f in frames])
                for f, a, b in zip(frames, ends, ends[1:]):
                    st[a:b].copy_(torch.from_numpy(f).view(-1))
        with span("serve.upload", device=self.device):
            if not cuda:
                return [torch.from_numpy(f).to(self.device) for f in frames]
            flat = st[:total].to(self.device, non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record()
        return [flat[a:b].view(f.shape)
                for f, a, b in zip(frames, ends, ends[1:])]

    @torch.no_grad()
    def __call__(self, frames: Sequence[np.ndarray], rows: int = 0) -> np.ndarray:
        """Spans: `serve.call` over `upload`'s two, `serve.resize` (the
        resizes and the zero rows), `serve.forward` (normalising, the
        logits, the argmax) and `serve.download` (the cast, the copy back);
        counter `serve.frames`."""
        n, s = len(frames), self.size
        rows = max(rows, n)
        with span("serve.call"):
            count("serve.frames", n)
            frames = self.upload(frames)
            with span("serve.resize", device=self.device):
                x = torch.empty((rows, s, s, 3), dtype=torch.uint8, device=self.device)
                for i, f in enumerate(frames):
                    x[i] = resize_frame(f, s)
                x[n:].zero_()
            with span("serve.forward", device=self.device):
                out = self.forward(x)[:n]
            with span("serve.download", device=self.device):
                return out.to(torch.uint8).cpu().numpy()


class Segmenter:
    """Fixed-resolution CABiNet inference engine on one device.

    Runs on CUDA unless `device="cpu"`; raises when CUDA is asked for and
    there is none. `choose_route` picks the forward by the JAX engine's
    rule: Large in bf16 with a supported /8 grid runs the fused tail
    (kernels K2, K3), and at batch >= 8 also the stem+block_0 kernel K4; in
    another dtype (float32) batch >= 8 runs K4 in front of the model's
    forward; everything else, and every CPU run, runs the model's forward.
    With `kernel_attn` the CAB attention is kernel K1 in bf16 or float32
    (its plain version for CPU tensors); without it, the einsum path. The
    chosen route is `self.route`.

    A batch of requests is one `BatchStep` (`self.step`): the frames'
    bytes go to the device in one copy; there a frame of another size than
    `imgsz` is resized to uint8 as PIL's BILINEAR resizes it in the JAX
    engine (`resize_frame`: anti-aliased on a downscale, within one level
    of PIL per pixel), the batch is normalised in f32 and runs the forward
    and the argmax, and the class IDs come back as uint8 in one copy.
    Masks go back to the input size with "nearest-exact", PIL NEAREST's
    pixel-centre rule (the two can pick neighbouring pixels only where a
    centre falls exactly on a pixel boundary, which float rounding decides
    in each).
    """

    def __init__(self, checkpoint: str, dataset: str, mode: str = "large",
                 imgsz: int = 1024, dtype_name: str = "bfloat16",
                 batch: int = 1, kernel_attn: bool = True,
                 device: Union[str, torch.device] = "cuda"):
        from cabinet_tpu_torch.models import fused

        self.device = resolve_device(device)
        self.dtype = {"bfloat16": torch.bfloat16,
                      "float32": torch.float32}[dtype_name]
        stats = DATASET_REGISTRY[dataset]
        self.n_classes = stats.NUM_CLASSES
        self.mean = torch.tensor(stats.MEAN, device=self.device)
        self.std = torch.tensor(stats.STD, device=self.device)
        self.imgsz = imgsz
        self.batch = max(1, int(batch))
        self.model = CABiNet(self.n_classes, mode=mode,
                             attention="kernel" if kernel_attn else "einsum")
        self.model.load_state_dict(load_state_dict(checkpoint, self.model),
                                   strict=True)

        self.route = choose_route(mode, self.device.type, self.dtype,
                                  self.batch, imgsz, self.n_classes)
        if self.route == "model":
            self.model.to(device=self.device, dtype=self.dtype).eval()
            self._logits = lambda x: self.model(
                x.permute(0, 3, 1, 2))[0].permute(0, 2, 3, 1)
        else:
            if self.route == "fused_early":
                forward = fused.make_fused_apply(self.model, self.device,
                                                 self.dtype)
            else:
                forward = fused.make_fused_tail_apply(
                    self.model, self.device, self.dtype,
                    use_early=self.route == "fused_tail_early")
            self._logits = lambda x: forward(x)[0]
        self.step = BatchStep(lambda x: self._forward(self._normalise(x)),
                              self.device, imgsz)

    @torch.no_grad()
    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B,imgsz,imgsz,3) normalised f32 -> (B,imgsz,imgsz) class IDs."""
        return torch.argmax(self._logits(x.to(self.dtype)), dim=-1)

    def _normalise(self, x: torch.Tensor) -> torch.Tensor:
        """uint8 (..., 3) -> f32 (x / 255 - mean) / std."""
        return (x.float() / 255.0 - self.mean) / self.std

    def _preprocess(self, rgb: np.ndarray) -> torch.Tensor:
        """One frame as the forward sees it in `self.step`: (imgsz, imgsz,
        3) normalised f32 on the device."""
        return self._normalise(resize_frame(self.step.upload([rgb])[0],
                                            self.imgsz))

    @staticmethod
    def _postprocess(pred: torch.Tensor, hw: Tuple[int, int]) -> np.ndarray:
        """(h, w) class IDs -> (H, W) uint8 at `hw` by "nearest-exact"."""
        pred = pred.to(torch.uint8)
        if tuple(hw) != tuple(pred.shape):
            pred = F.interpolate(pred[None, None], size=tuple(hw),
                                 mode="nearest-exact")[0, 0]
        return pred.cpu().numpy()

    def predict(self, rgb: np.ndarray) -> np.ndarray:
        """RGB uint8 (H,W,3) -> class-ID mask (H,W) uint8, through the fixed
        resolution and back."""
        pred = self.step([rgb], 1)[0]
        return self._postprocess(torch.from_numpy(pred), rgb.shape[:2])

    def predict_batch(self, rgbs) -> list:
        """List of RGB uint8 frames -> list of uint8 class-ID masks, in one
        device step padded with zero rows up to the engine batch."""
        preds = self.step(rgbs, self.batch)
        return [self._postprocess(torch.from_numpy(p), r.shape[:2])
                for p, r in zip(preds, rgbs)]


def _overlay(rgb: np.ndarray, mask_rgb: np.ndarray, alpha: float) -> np.ndarray:
    return ((1 - alpha) * rgb + alpha * mask_rgb).astype(np.uint8)


def infer_image(seg: Segmenter, classes, path: Path, out_dir: Path,
                alpha: float) -> None:
    """<stem>_mask.png and <stem>_overlay.png of one image. PNG is read by
    the port's own reader; other formats (JPEG) by PIL, as the JAX CLI
    reads them, which raises `DatasetError` where PIL cannot be imported."""
    from cabinet_tpu_torch.data.decode import open_rgb, save_png
    from cabinet_tpu_torch.data.palettes import colorize_mask

    rgb = open_rgb(path)
    mask_rgb = colorize_mask(seg.predict(rgb), classes)
    out_dir.mkdir(parents=True, exist_ok=True)
    save_png(out_dir / f"{path.stem}_mask.png", mask_rgb)
    save_png(out_dir / f"{path.stem}_overlay.png", _overlay(rgb, mask_rgb, alpha))


def infer_video(seg: Segmenter, classes, path: Path, out_dir: Path,
                alpha: float) -> None:
    import cv2

    from cabinet_tpu_torch.data.palettes import colorize_mask

    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise FileNotFoundError(f"Cannot open video: {path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 25
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    out_dir.mkdir(parents=True, exist_ok=True)
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    mask_w = cv2.VideoWriter(str(out_dir / f"{path.stem}_mask.mp4"), fourcc,
                             fps, (w, h))
    over_w = cv2.VideoWriter(str(out_dir / f"{path.stem}_overlay.mp4"), fourcc,
                             fps, (w, h))
    n = 0

    def flush(chunk):
        nonlocal n
        if not chunk:
            return
        preds = (seg.predict_batch(chunk) if seg.batch > 1
                 else [seg.predict(chunk[0])])
        for rgb, pred in zip(chunk, preds):
            mask_rgb = colorize_mask(pred, classes)
            mask_w.write(cv2.cvtColor(mask_rgb, cv2.COLOR_RGB2BGR))
            over_w.write(cv2.cvtColor(_overlay(rgb, mask_rgb, alpha),
                                      cv2.COLOR_RGB2BGR))
            n += 1

    try:
        chunk = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            chunk.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            if len(chunk) == seg.batch:
                flush(chunk)
                chunk = []
        flush(chunk)
    finally:
        cap.release()
        mask_w.release()
        over_w.release()
    print(f"[INFO] {path.name}: {n} frames")


def infer_showcase(seg: Segmenter, classes, paths, out_dir: Path,
                   alpha: float, tile_size: Tuple[int, int] = (640, 360)
                   ) -> None:
    """2x2 showcase mosaic of up to 4 clips with a per-clip temporal
    raw -> mask reveal ramp (reference infer_yolo.py:288-374): each tile
    starts as raw footage and blends toward the segmentation overlay over
    the clip, with staggered ramp offsets so tiles reveal one by one."""
    import cv2

    from cabinet_tpu_torch.data.palettes import colorize_mask

    paths = list(paths)[:4]
    caps = [cv2.VideoCapture(str(p)) for p in paths]
    try:
        if not caps or not all(c.isOpened() for c in caps):
            raise FileNotFoundError(f"Cannot open showcase clips: {paths}")
        fps = caps[0].get(cv2.CAP_PROP_FPS) or 25
        n_frames = min(int(c.get(cv2.CAP_PROP_FRAME_COUNT)) or 1 for c in caps)
        tw, th = tile_size
        out_dir.mkdir(parents=True, exist_ok=True)
        writer = cv2.VideoWriter(str(out_dir / "showcase.mp4"),
                                 cv2.VideoWriter_fourcc(*"mp4v"), fps,
                                 (2 * tw, 2 * th))
        try:
            for f in range(n_frames):
                mosaic = np.zeros((2 * th, 2 * tw, 3), np.uint8)
                for i, cap in enumerate(caps):
                    ok, frame = cap.read()
                    if not ok:
                        continue
                    rgb = cv2.cvtColor(cv2.resize(frame, (tw, th)),
                                       cv2.COLOR_BGR2RGB)
                    mask_rgb = colorize_mask(seg.predict(rgb), classes)
                    t = f / max(n_frames - 1, 1)
                    ramp = np.clip((t - i * 0.2) / 0.4, 0.0, 1.0)
                    blended = ((1 - ramp * alpha) * rgb
                               + ramp * alpha * mask_rgb).astype(np.uint8)
                    r, c = divmod(i, 2)
                    mosaic[r * th:(r + 1) * th, c * tw:(c + 1) * tw] = blended
                writer.write(cv2.cvtColor(mosaic, cv2.COLOR_RGB2BGR))
        finally:
            writer.release()
    finally:
        for c in caps:
            c.release()
    print(f"[INFO] showcase: {n_frames} frames, {len(caps)} clips")


def main(argv: Optional[Sequence[str]] = None) -> None:
    from cabinet_tpu_torch.data.palettes import PALETTES

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True,
                   help="reference .pth state dict or JAX variables .npz")
    p.add_argument("--dataset", required=True, choices=sorted(PALETTES))
    p.add_argument("--source", required=True, type=Path)
    p.add_argument("--mode", default="large", choices=["large", "small"])
    p.add_argument("--imgsz", type=int, default=1024)
    p.add_argument("--out-dir", type=Path, default=Path("inference_out"))
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--batch", type=int, default=1,
                   help="frames per forward for video throughput")
    p.add_argument("--showcase", action="store_true",
                   help="build a 2x2 mosaic showcase video from the first 4 "
                        "clips in --source (a directory of videos)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    p.add_argument("--no-kernel-attn", action="store_true",
                   help="run the CAB attention on the einsum path instead of "
                        "the attention kernel")
    args = p.parse_args(argv)

    classes = PALETTES[args.dataset]
    seg = Segmenter(args.checkpoint, args.dataset, args.mode, args.imgsz,
                    args.dtype, batch=args.batch,
                    kernel_attn=not args.no_kernel_attn, device=args.device)
    src = args.source
    if args.showcase:
        clips = ([f for f in sorted(src.iterdir())
                  if f.suffix.lower() in VIDEO_EXTS] if src.is_dir() else [src])
        infer_showcase(seg, classes, clips, args.out_dir, args.alpha)
    elif src.is_dir():
        for f in sorted(src.iterdir()):
            if f.suffix.lower() in IMAGE_EXTS:
                infer_image(seg, classes, f, args.out_dir, args.alpha)
    elif src.suffix.lower() in IMAGE_EXTS:
        infer_image(seg, classes, src, args.out_dir, args.alpha)
    elif src.suffix.lower() in VIDEO_EXTS:
        infer_video(seg, classes, src, args.out_dir, args.alpha)
    else:
        raise ValueError(f"Unsupported source: {src}")
    print(f"[DONE] Output: {args.out_dir}")


if __name__ == "__main__":
    main()
