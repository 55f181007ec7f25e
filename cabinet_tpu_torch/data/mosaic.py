"""Multi-image augmentations of the YOLO-sem training recipe: mosaic,
mixup, copy-paste (copy of `cabinet_tpu.data.mosaic`, which the port keeps
line for line, so a sample is bit-equal to the JAX package's on the same
base dataset).

The reference delegates these to ultralytics (configs/train_yolo.yaml:85-110:
mosaic .8, mixup .1/.15, copy_paste .15, close_mosaic 15). The wrapper
serves any base dataset of (image HWC float, label HW int) samples:

  - mosaic4: four samples on a 2x shared canvas around a jittered centre,
    then a random crop back to the base crop size,
  - mixup: Beta(32,32) blend, hard label from the dominant image; drawn
    whether or not mosaic is on,
  - copy_paste (semantic form): the pixels of a random subset of a
    partner sample's classes pasted onto the current one,
  - close_mosaic: `set_mosaic(False)` for the last N epochs
    (cli/train_yolo.py drives it).

Every draw of sample `idx` comes from `default_rng([seed + 7, epoch, idx])`.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np


class MosaicSegDataset:
    """Wraps a train dataset with mosaic/mixup/copy-paste."""

    def __init__(self, base: Any, mosaic: float = 0.8, mixup: float = 0.1,
                 copy_paste: float = 0.15, ignore_label: int = 255,
                 seed: int = 0, pad_value: Any = 0.0):
        """pad_value fills uncovered mosaic-canvas pixels. The default 0.0
        is correct for NORMALIZED inputs (zero = the dataset mean color);
        with raw [0,1] inputs (runtime.device_augs — normalization happens
        later on device) pass the dataset MEAN so the padding stays the
        mean color instead of silently becoming pure black (~-2 sigma
        after device normalization)."""
        self.base = base
        self.mosaic_p = float(mosaic)
        self.mixup_p = float(mixup)
        self.copy_paste_p = float(copy_paste)
        self.ignore_label = ignore_label
        self.seed = seed
        self.pad_value = np.asarray(pad_value, np.float32)
        self.epoch = 0
        self._mosaic_enabled = True

    def __len__(self) -> int:
        return len(self.base)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)
        if hasattr(self.base, "set_epoch"):
            self.base.set_epoch(epoch)

    def set_mosaic(self, enabled: bool) -> None:
        """close_mosaic support: disable multi-image augs for final epochs."""
        self._mosaic_enabled = enabled

    # ------------------------------------------------------------------
    def _mosaic4(self, idx: int, rng: np.random.Generator
                 ) -> Tuple[np.ndarray, np.ndarray]:
        h, w = self.base[idx][0].shape[:2]
        canvas_i = np.zeros((2 * h, 2 * w, 3), np.float32)
        canvas_i[:] = self.pad_value
        canvas_l = np.full((2 * h, 2 * w), self.ignore_label, np.int64)
        # jittered center in the middle half of the canvas
        cy = int(rng.integers(h // 2, h + h // 2 + 1))
        cx = int(rng.integers(w // 2, w + w // 2 + 1))
        idxs = [idx] + [int(rng.integers(0, len(self.base))) for _ in range(3)]
        regions = [  # (y0, y1, x0, x1) per quadrant
            (0, cy, 0, cx), (0, cy, cx, 2 * w),
            (cy, 2 * h, 0, cx), (cy, 2 * h, cx, 2 * w),
        ]
        for (y0, y1, x0, x1), i in zip(regions, idxs):
            img, lbl = self.base[i]
            ih, iw = img.shape[:2]
            th, tw = y1 - y0, x1 - x0
            sy = int(rng.integers(0, max(ih - th, 0) + 1)) if ih > th else 0
            sx = int(rng.integers(0, max(iw - tw, 0) + 1)) if iw > tw else 0
            ch, cw = min(th, ih), min(tw, iw)
            canvas_i[y0:y0 + ch, x0:x0 + cw] = img[sy:sy + ch, sx:sx + cw]
            canvas_l[y0:y0 + ch, x0:x0 + cw] = lbl[sy:sy + ch, sx:sx + cw]
        # random h x w crop back out of the canvas
        oy = int(rng.integers(0, h + 1))
        ox = int(rng.integers(0, w + 1))
        return (canvas_i[oy:oy + h, ox:ox + w],
                canvas_l[oy:oy + h, ox:ox + w])

    def _copy_paste(self, img: np.ndarray, lbl: np.ndarray,
                    rng: np.random.Generator
                    ) -> Tuple[np.ndarray, np.ndarray]:
        j = int(rng.integers(0, len(self.base)))
        img2, lbl2 = self.base[j]
        if img2.shape != img.shape:
            return img, lbl
        classes = np.unique(lbl2)
        classes = classes[(classes != self.ignore_label)]
        if classes.size == 0:
            return img, lbl
        k = int(rng.integers(1, classes.size + 1))
        chosen = rng.choice(classes, size=k, replace=False)
        mask = np.isin(lbl2, chosen)
        img = np.where(mask[..., None], img2, img)
        lbl = np.where(mask, lbl2, lbl)
        return img, lbl

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng([self.seed + 7, self.epoch, idx])
        if self._mosaic_enabled and rng.random() < self.mosaic_p:
            img, lbl = self._mosaic4(idx, rng)
        else:
            img, lbl = self.base[idx]
            img, lbl = np.asarray(img), np.asarray(lbl)

        if self._mosaic_enabled and rng.random() < self.copy_paste_p:
            img, lbl = self._copy_paste(img, lbl, rng)

        if rng.random() < self.mixup_p:
            j = int(rng.integers(0, len(self.base)))
            img2, lbl2 = self.base[j]
            if img2.shape == img.shape:
                r = float(rng.beta(32.0, 32.0))
                img = img * r + img2 * (1.0 - r)
                lbl = lbl if r >= 0.5 else lbl2
        return img.astype(np.float32), lbl.astype(np.int64)
