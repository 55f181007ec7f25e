"""Multi-scale sliding-window evaluator (counterpart of
`cabinet_tpu.eval.evaluator.MscEval`), on one device or with each image's
tiles shared by the ranks of a process group (`tile_mesh`).

Protocol, as the reference engine (src/scripts/evaluate.py:32-251) and the
JAX package run it:
  - per scale: bilinear resize to (int(H*s), int(W*s)) (`resize_bilinear`,
    2-tap, never anti-aliased), centred zero pad up to the crop, tiles of
    the crop with stride int(crop * 5/6), edge tiles snapped back so every
    tile is a whole crop;
  - the tiles of all scales folded into forwards of `tile_batch` images
    (doubled under flip TTA: the flipped tiles ride in the same batch);
  - softmax in `acc_dtype`, overlap-add and normalisation by the count of
    covering tiles, unpad, resize back to native, sum of the scales in f32,
    argmax, confusion matrix.
The overlap-add accumulates in place and divides once; the JAX package's
write-once assembly (`_assemble_scale`) adds the same tiles in the same
order and divides by the same counts, so the two agree to the bit.

Tile-sharded eval (`tile_mesh=(rank, R)`, R > 1; JAX's
`_sliding_probs_tile_sharded` with the data axis as the ranks): scale by
scale, the padded tile grid is split into R contiguous blocks of
`group * k` tiles, `group = min(max(tile_batch // B, 1), ceil(T / R))`
tiles a forward (the grid padded to a multiple of R * group with tiles of
weight 0, which add nothing and are not run). Each rank accumulates its
tiles' probabilities (in `acc_dtype`) and counts; both are summed over
the ranks in f32, as JAX's psum, in one all-reduce (tag
`tile_all_reduce`), then divided and cropped, so that every rank holds
the same map, argmax and confusion matrix. Every rank scores every frame,
and the matrix is not summed over the ranks.

The ranks that share tiles or frames are the data group of the current
mesh (`core/mesh.py:current`; R its size): on a mesh with a model axis,
the ranks of one model group run a tensor-parallel model over the same
tiles (JAX's model-sharded eval, `cabinet_tpu/eval/evaluator.py:106-111`),
and nothing is summed twice.

Spans (`utils/profiler.py`, recorded while `torch.profiler` runs): the
root `eval.batch`, one loader batch of `evaluate`, over `eval.wait` (the
wait for the staged batch), `eval.resize` (a scale's input resize and
pad), `eval.forward` (a fold's forward, flip and softmax),
`eval.accumulate` (a fold's overlap-add; a finished scale's division,
crop, resize back and sum) and `eval.score` (argmax, confusion matrix,
its download); `eval.stage` on the staging thread. Counter:
`eval.frames`.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from cabinet_tpu_torch.core import mesh
from cabinet_tpu_torch.core.constants import DEFAULT_IGNORE_LABEL, EVAL_STRIDE_RATE
from cabinet_tpu_torch.core.device import resolve_device
from cabinet_tpu_torch.eval.metrics import confusion_matrix, metrics_from_hist
from cabinet_tpu_torch.models.cab import resize_bilinear
from cabinet_tpu_torch.utils.profiler import count, span

# (variables, images (B,H,W,3)) -> (logits (B,H,W,C), aux); `variables` is
# passed through untouched (a model, weights, or None).
ApplyFn = Callable[[Any, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]

TILE_BATCH = 16  # tiles folded into one model forward


def _tile_starts(full: int, crop: int, stride: int) -> np.ndarray:
    n = math.ceil(max(full - crop, 0) / stride) + 1
    return np.array([min(stride * i, full - crop) for i in range(n)], np.int32)


def tile_grid(full_h: int, full_w: int, crop: int,
              stride_rate: float = EVAL_STRIDE_RATE) -> np.ndarray:
    """(T, 2) array of (y, x) tile origins (reference crop_eval:124-138)."""
    stride = int(crop * stride_rate)
    ys = _tile_starts(full_h, crop, stride)
    xs = _tile_starts(full_w, crop, stride)
    return np.array([(y, x) for y in ys for x in xs], np.int32).reshape(-1, 2)


def _resize_nhwc(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    return resize_bilinear(x.permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)


def _chip_probs(apply_fn: ApplyFn, variables: Any, chip: torch.Tensor,
                flip: bool, prob_dtype: torch.dtype) -> torch.Tensor:
    """Softmax probabilities (in `prob_dtype`) of one fold of tiles; with
    flip TTA the flipped tiles go through the same forward and the two
    probabilities are averaged."""
    if flip:
        both = torch.cat([chip, chip.flip(2)], dim=0)
        logits = apply_fn(variables, both)[0].to(prob_dtype)
        n = chip.shape[0]
        prob = torch.softmax(logits[:n], dim=-1)
        prob_f = torch.softmax(logits[n:].flip(2), dim=-1)
        return (prob + prob_f) * 0.5
    return torch.softmax(apply_fn(variables, chip)[0].to(prob_dtype), dim=-1)


def _summed_probs(apply_fn: ApplyFn, n_classes: int, crop: int, flip: bool,
                  scales: Sequence[float], variables: Any, image: torch.Tensor,
                  tile_batch: int, acc_dtype: torch.dtype) -> torch.Tensor:
    """(B,H,W,C) f32 sum over the scales of the overlap-normalised
    probability maps, resized back to native."""
    B, H, W, _ = image.shape
    group = max(tile_batch // B, 1)
    stride = int(crop * EVAL_STRIDE_RATE)

    per_scale = []  # (sh, sw, full_h, full_w, hst, wst, scaled, ys, xs)
    for s in scales:
        sh, sw = int(H * s), int(W * s)
        full_h, full_w = max(sh, crop), max(sw, crop)
        hst, wst = (full_h - sh) // 2, (full_w - sw) // 2
        with span("eval.resize", device=image.device):
            scaled = _resize_nhwc(image, (sh, sw))
            if (full_h, full_w) != (sh, sw):
                scaled = F.pad(scaled, (0, 0, wst, full_w - sw - wst,
                                        hst, full_h - sh - hst))
        ys = [int(v) for v in _tile_starts(full_h, crop, stride)]
        xs = [int(v) for v in _tile_starts(full_w, crop, stride)]
        per_scale.append((sh, sw, full_h, full_w, hst, wst, scaled, ys, xs))

    # grid order (y-major, x-major) within each scale, scales in order
    jobs = [(si, y, x) for si, ps in enumerate(per_scale)
            for y in ps[7] for x in ps[8]]
    last_job = {si: idx for idx, (si, _, _) in enumerate(jobs)}
    maps: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
    total = torch.zeros((B, H, W, n_classes), dtype=torch.float32,
                        device=image.device)

    for g0 in range(0, len(jobs), group):
        chunk = jobs[g0:g0 + group]
        with span("eval.forward", device=image.device):
            chips = torch.cat([per_scale[si][6][:, y:y + crop, x:x + crop, :]
                               for si, y, x in chunk], dim=0)
            cps = _chip_probs(apply_fn, variables, chips, flip, acc_dtype)
        with span("eval.accumulate", device=image.device):
            for i, (si, y, x) in enumerate(chunk):
                sh, sw, full_h, full_w, hst, wst, _, _, _ = per_scale[si]
                if si not in maps:
                    maps[si] = (torch.zeros((B, full_h, full_w, n_classes),
                                            dtype=acc_dtype, device=image.device),
                                torch.zeros((full_h, full_w), dtype=torch.float32,
                                            device=image.device))
                prob, cover = maps[si]
                prob[:, y:y + crop, x:x + crop] += cps[i * B:(i + 1) * B]
                cover[y:y + crop, x:x + crop] += 1.0
                if g0 + i == last_job[si]:
                    prob, cover = maps.pop(si)
                    p = prob / cover.to(acc_dtype)[None, :, :, None]
                    p = p[:, hst:hst + sh, wst:wst + sw]
                    total = total + _resize_nhwc(p, (H, W))
    return total


def _sliding_probs_tile_sharded(apply_fn: ApplyFn, n_classes: int, crop: int,
                                flip: bool, tile_mesh: Tuple[int, int], variables: Any,
                                image: torch.Tensor, tile_batch: int = TILE_BATCH,
                                acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One scale's (B,H,W,C) overlap-normalised probabilities of `image`
    (already at that scale), its tiles shared by the ranks `tile_mesh =
    (rank, R)`: this rank forwards its contiguous block of the padded grid
    and the maps are summed over the ranks in f32."""
    rank, n = tile_mesh
    B, H, W, _ = image.shape
    full_h, full_w = max(H, crop), max(W, crop)
    hst, wst = (full_h - H) // 2, (full_w - W) // 2
    if (full_h, full_w) != (H, W):
        with span("eval.resize", device=image.device):
            image = F.pad(image, (0, 0, wst, full_w - W - wst, hst, full_h - H - hst))
    grid = tile_grid(full_h, full_w, crop)
    # the fold is capped at a rank's tile count: a bigger one adds only pad
    group = min(max(tile_batch // B, 1), -(-len(grid) // n))
    block = -(-len(grid) // (n * group)) * group  # t_pad / n
    mine = [int(t) for t in range(rank * block, (rank + 1) * block) if t < len(grid)]
    prob = torch.zeros((B, full_h, full_w, n_classes), dtype=acc_dtype, device=image.device)
    cover = torch.zeros((full_h, full_w), dtype=torch.float32, device=image.device)
    for g0 in range(0, len(mine), group):
        tiles = [tuple(int(v) for v in grid[t]) for t in mine[g0:g0 + group]]
        with span("eval.forward", device=image.device):
            chips = torch.cat([image[:, y:y + crop, x:x + crop, :] for y, x in tiles], dim=0)
            cps = _chip_probs(apply_fn, variables, chips, flip, acc_dtype)
        with span("eval.accumulate", device=image.device):
            for i, (y, x) in enumerate(tiles):
                prob[:, y:y + crop, x:x + crop] += cps[i * B:(i + 1) * B]
                cover[y:y + crop, x:x + crop] += 1.0
    with span("eval.accumulate", device=image.device):
        both = torch.cat([prob.float().reshape(-1), cover.reshape(-1)])
        mesh.all_reduce_(both, tag="tile_all_reduce", group=mesh.data_group())
        prob = both[:prob.numel()].view(prob.shape).to(acc_dtype)
        cover = both[prob.numel():].view(cover.shape)
        prob = prob / cover.clamp_min(1.0).to(acc_dtype)[None, :, :, None]
        return prob[:, hst:hst + H, wst:wst + W]


def _scale_probs(apply_fn: ApplyFn, n_classes: int, crop: int, flip: bool, scale: float,
                 variables: Any, image: torch.Tensor, tile_mesh: Tuple[int, int],
                 tile_batch: int = TILE_BATCH,
                 acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One scale's probability map at the native resolution, in `acc_dtype`,
    tile-sharded over the ranks of `tile_mesh`."""
    B, H, W, _ = image.shape
    with span("eval.resize", device=image.device):
        scaled = _resize_nhwc(image, (int(H * scale), int(W * scale)))
    prob = _sliding_probs_tile_sharded(apply_fn, n_classes, crop, flip, tile_mesh,
                                       variables, scaled, tile_batch, acc_dtype)
    with span("eval.accumulate", device=image.device):
        return _resize_nhwc(prob, (H, W))


class MscEval:
    """Multi-scale sliding-window evaluation engine.

    Arguments mirror the JAX engine's; `tile_mesh` is the rank group
    `(rank, R)` that shares each image's tiles (`cli/common.py:
    eval_tile_mesh`), or None for one device. `apply_fn`
    is `(variables, images) -> (logits, aux)` on NHWC tensors, e.g. from
    `cli.evaluate.make_eval_forward`. `acc_dtype=None` follows
    `compute_dtype` (bf16 compute accumulates the probability maps in
    bf16, f32 in f32). `pad_to` right/bottom-pads near-bucket resolutions
    to one canvas with ignore-filled labels, as in the JAX engine. Runs on
    CUDA unless `device="cpu"`.
    """

    def __init__(
        self,
        apply_fn: ApplyFn,
        n_classes: int,
        ignore_label: int = DEFAULT_IGNORE_LABEL,
        scales: Sequence[float] = (1.0,),
        flip: bool = False,
        cropsize: int = 1024,
        compute_dtype: torch.dtype = torch.float32,
        pad_to: Any = None,
        tile_batch: int = TILE_BATCH,
        acc_dtype: torch.dtype = None,
        device: Union[str, torch.device] = "cuda",
        tile_mesh: Any = None,
    ) -> None:
        self.apply_fn = apply_fn
        self.n_classes = n_classes
        self.ignore_label = ignore_label
        self.scales = tuple(scales)
        self.flip = flip
        self.cropsize = cropsize
        self.compute_dtype = compute_dtype
        self.tile_batch = int(tile_batch)
        self.acc_dtype = (torch.bfloat16 if (acc_dtype is None
                                             and compute_dtype == torch.bfloat16)
                          else (acc_dtype or torch.float32))
        self.pad_to = None if pad_to is None else (int(pad_to[0]), int(pad_to[1]))
        self.device = resolve_device(device)
        self.tile_mesh = None if tile_mesh is None else (int(tile_mesh[0]), int(tile_mesh[1]))

    def _pad_to_bucket(self, images: np.ndarray, labels: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
        H, W = images.shape[1], images.shape[2]
        if self.pad_to is None or (H, W) == self.pad_to:
            return images, labels, (H, W)
        bh, bw = self.pad_to
        if H > bh or W > bw:
            raise ValueError(
                f"image {(H, W)} exceeds eval pad_to bucket {self.pad_to}")
        if H * 2 < bh or W * 2 < bw:
            # far below the bucket: evaluate natively, as the JAX engine does
            return images, labels, (H, W)
        images = np.pad(np.asarray(images),
                        ((0, 0), (0, bh - H), (0, bw - W), (0, 0)))
        labels = np.pad(np.asarray(labels), ((0, 0), (0, bh - H), (0, bw - W)),
                        constant_values=self.ignore_label)
        return images, labels, (H, W)

    def _to_device(self, images) -> torch.Tensor:
        """The images on the device in the compute dtype (the bf16 cast
        rounds to nearest even, as the JAX engine's host cast does)."""
        if not torch.is_tensor(images):
            images = torch.from_numpy(np.ascontiguousarray(images, np.float32))
        return images.to(self.device).to(self.compute_dtype)

    @torch.no_grad()
    def _probs(self, variables: Any, images: torch.Tensor) -> torch.Tensor:
        if self.tile_mesh is None:
            return _summed_probs(self.apply_fn, self.n_classes, self.cropsize,
                                 self.flip, self.scales, variables, images,
                                 self.tile_batch, self.acc_dtype)
        total = torch.zeros(images.shape[:3] + (self.n_classes,), dtype=torch.float32,
                            device=images.device)
        for s in self.scales:
            total = total + _scale_probs(self.apply_fn, self.n_classes, self.cropsize,
                                         self.flip, s, variables, images, self.tile_mesh,
                                         self.tile_batch, self.acc_dtype)
        return total

    def _run(self, variables: Any, images, labels
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        probs = self._probs(variables, self._to_device(images))
        with span("eval.score", device=self.device):
            preds = torch.argmax(probs, dim=-1)
            labels = torch.as_tensor(labels, device=self.device)
            return preds, confusion_matrix(preds, labels, self.n_classes,
                                           self.ignore_label)

    def prob_batch(self, variables: Any, images: np.ndarray) -> np.ndarray:
        """Summed multi-scale probability map (B,H,W,C) f32: exactly the
        tensor the protocol argmaxes."""
        return self._probs(variables, self._to_device(images)).cpu().numpy()

    def evaluate_batch(self, variables: Any, images: np.ndarray,
                       labels: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(predictions (B,H,W) int64, confusion matrix (C,C) int64)."""
        images, labels, (H0, W0) = self._pad_to_bucket(images, labels)
        preds, hist = self._run(variables, images, labels)
        return preds.cpu().numpy()[:, :H0, :W0], hist.cpu().numpy()

    def hist_batch(self, variables: Any, images: np.ndarray,
                   labels: np.ndarray) -> np.ndarray:
        """The confusion matrix only; the predictions stay on the device."""
        images, labels, _ = self._pad_to_bucket(images, labels)
        return self._run(variables, images, labels)[1].cpu().numpy()

    def _stage(self, images: np.ndarray, labels: np.ndarray, stream):
        """A batch padded to the bucket and copied to the device, on `stream`
        where there is one; the event marks when the copy is done."""
        images, labels, _ = self._pad_to_bucket(images, labels)
        if stream is None:
            return self._to_device(images), torch.as_tensor(np.asarray(labels)), None
        with torch.cuda.stream(stream):
            images_d = self._to_device(images)
            labels_d = torch.as_tensor(np.asarray(labels), device=self.device)
            done = torch.cuda.Event()
            done.record(stream)
        return images_d, labels_d, done

    def evaluate(self, variables_or_model: Any,
                 dataloader: Iterable[Tuple[np.ndarray, np.ndarray]],
                 progress: bool = False) -> Dict[str, Any]:
        """Metrics over every (images, labels) batch of the loader, with the
        next batch staged while this one runs, as the JAX engine does.

        A worker thread pulls batches from the loader, pads them to the
        bucket and copies them to the device (on CUDA on a side stream, the
        consumer's stream waiting on its event), one batch ahead behind a
        queue of 2. A stop event keeps the worker from blocking on a full
        queue after the consumer failed; the worker's exceptions reach the
        consumer. The confusion matrix is the sum of what `hist_batch` gives
        batch by batch, each copied back as it is done, and, inside a process
        group of several ranks each scoring its share of the frames, summed
        over the ranks (not with `tile_mesh`: every rank scored every
        frame, its tiles shared), over the data group. `progress` prints a
        plain line now and then. The result's `timing` holds the loop's
        seconds, the seconds the consumer waited on the worker (in all, and
        before each batch and the end), and the frame count."""
        n_total = len(dataloader) if hasattr(dataloader, "__len__") else None
        stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                  else None)
        q: queue.Queue = queue.Queue(maxsize=2)
        done = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def stage():
            it = None
            try:
                it = iter(dataloader)
                for images, labels in it:
                    with span("eval.stage"):
                        staged = self._stage(images, labels, stream)
                    if stop.is_set() or not put(staged):
                        return
            except BaseException as e:  # handed to the consumer, which raises it
                put(e)
                return
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()  # a generator loader shuts its own pool down here
            put(done)

        hist = np.zeros((self.n_classes, self.n_classes), np.int64)
        frames = batches = 0
        waits = []
        t0 = time.perf_counter()
        worker = threading.Thread(target=stage, daemon=True, name="MscEval-stage")
        worker.start()
        try:
            while True:
                with span("eval.batch"):
                    with span("eval.wait"):
                        tw = time.perf_counter()
                        item = q.get()
                        waits.append(time.perf_counter() - tw)
                    if item is done:
                        break
                    if isinstance(item, BaseException):
                        raise item
                    images_d, labels_d, ready = item
                    if ready is not None:
                        current = torch.cuda.current_stream(self.device)
                        current.wait_event(ready)
                        # the side stream allocated them; this stream reads them
                        images_d.record_stream(current)
                        labels_d.record_stream(current)
                    # blocks on the device, while the worker stages the next batch
                    batch_hist = self._run(variables_or_model, images_d, labels_d)[1]
                    with span("eval.score", device=self.device):
                        hist += batch_hist.cpu().numpy()
                    count("eval.frames", images_d.shape[0])
                frames += int(images_d.shape[0])
                batches += 1
                if progress and (batches == n_total or batches % 10 == 0):
                    print(f"Evaluating: {batches}/{n_total or '?'} batches, "
                          f"{frames} frames, {time.perf_counter() - t0:.1f} s",
                          flush=True)
        finally:
            stop.set()
            while worker.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                worker.join(timeout=0.1)
        if mesh.data_world()[1] > 1 and self.tile_mesh is None:  # a share of the frames
            hist = mesh.all_reduce_(mesh.host_tensor(hist, torch.int64), tag="eval",
                                    group=mesh.data_group()).cpu().numpy()
        result = metrics_from_hist(hist)
        result["timing"] = {"seconds": time.perf_counter() - t0,
                            "loader_wait_seconds": sum(waits),
                            "loader_wait_seconds_per_batch": waits, "frames": frames}
        return result

    __call__ = evaluate
